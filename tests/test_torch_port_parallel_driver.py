"""The port's Stage-I driver (`drivers/train.py::training()`) under 2 gloo
ranks on the CPU, on the 64 px scene of tests/test_torch_port_driver.py:
`--view_batch 4` spread over the ranks, and `--gauss_shard 2` (2 depth
slabs, every rank rendering the 4 views), each against the one-process
`--view_batch 4` run, across two densify events (iterations 8 and 12).

Tolerances: the two ranks bit-equal (an all-gathered checksum of the
parameters and the parameters themselves) through both events; against
the one-process run the driver test's: loss at every sync within 1e-4
relative up to the first densify event, densify info and counts equal at
every event, final parameters within 1e-3 in relative L2; rank 0 alone
writes the checkpoint.
"""

import os

import numpy as np
import pytest
import torch

from tests.test_torch_port_driver import _argv, _run, scene_dir  # noqa: F401
from tests.torch_port_ranks import Ranks

ITERATIONS = 12
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "mask")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variant_argv(scene, out, extra):
    return _argv(scene, out, ITERATIONS, ("--view_batch", "4", *extra))


@pytest.fixture(scope="module")
def runs(scene_dir, tmp_path_factory):  # noqa: F811
    tmp = str(tmp_path_factory.mktemp("parallel_driver"))
    variants = {"view": (), "slab": ("--gauss_shard", "2")}
    ranks = Ranks(2, ["train_driver"], {"driver_runs": {
        name: _variant_argv(scene_dir, os.path.join(tmp, name), extra)
        for name, extra in variants.items()}}, tmp)
    with pytest.MonkeyPatch.context() as mp:
        rec, _, model = _run("torch", _variant_argv(scene_dir, os.path.join(tmp, "one"),
                                                    ()), mp)
    one = dict(rows=rec.rows, count=model.count,
               params={k: getattr(model.params, k)[:model.count].numpy() for k in FIELDS})
    return dict(ranks=ranks.wait(), one=one, tmp=tmp)


@pytest.mark.parametrize("variant", ["view", "slab"])
def test_ranks_bit_equal(runs, variant):
    r0, r1 = (runs["ranks"][r]["train_driver"][variant] for r in (0, 1))
    assert r0["checksums"][0] == r0["checksums"][1] == r1["checksums"][0]
    assert r0["count"] == r1["count"]
    for name in FIELDS:
        np.testing.assert_array_equal(r0["params"][name], r1["params"][name], name)
    assert [r[0] for r in r0["rows"]] == [r[0] for r in r1["rows"]]
    assert [r[2] for r in r0["rows"]] == [r[2] for r in r1["rows"]]


@pytest.mark.parametrize("variant", ["view", "slab"])
def test_against_the_one_process_run(runs, variant):
    one = runs["one"]
    got = runs["ranks"][0]["train_driver"][variant]
    assert [r[0] for r in got["rows"]] == [r[0] for r in one["rows"]]
    events = [r[0] for r in one["rows"] if r[2]]
    assert events == [8, 12]
    for (it, lo, do, co), (_, lg, dg, cg) in zip(one["rows"], got["rows"]):
        assert dg == do and cg == co, (variant, it)
        if lo is not None and it <= events[0]:
            assert abs(lg - lo) <= 1e-4 * abs(lo), (variant, it, lg, lo)
    assert got["count"] == one["count"] > 54
    for name in FIELDS:
        a, b = one["params"][name], got["params"][name]
        if a.size:
            assert np.linalg.norm(b - a) <= 1e-3 * np.linalg.norm(a), (variant, name)
    ply = os.path.join(runs["tmp"], variant, "point_cloud", f"iteration_{ITERATIONS}",
                       "point_cloud.ply")
    assert os.path.exists(ply)
