"""Port parity, the multi-process practicals: `parallel/multihost.py` of
hairgs_tpu_torch against hairgs_tpu/parallel/multihost.py on the CPU.

Camera ownership against JAX's over a table of (cameras, processes); the
sharded checkpoint in JAX's file layout: a checkpoint that JAX writes from
its 8 virtual CPU devices (tests/conftest.py) loads in the port, rows
reassembled into each rank's half; the port's own 2-rank round trip (gloo
ranks of tests/torch_port_ranks.py, spawned once for the module) is
bit-equal, writes JAX's keys, and JAX reads it back; the schema-drift
guards raise on a missing leaf and warn on an orphaned one. All
comparisons are exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tests.torch_port_ranks import Ranks

N_ROWS = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays():
    rng = np.random.default_rng(0)
    return dict(endpoints=rng.normal(size=(N_ROWS, 3)).astype(np.float32),
                width=rng.normal(size=(N_ROWS, 1)).astype(np.float32))


def _jax_state(arrays, n_devices=None):
    mesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("gauss",))
    shard, repl = NamedSharding(mesh, P("gauss")), NamedSharding(mesh, P())
    return {
        "params": {k: jax.device_put(jnp.asarray(v), shard) for k, v in arrays.items()},
        "step_count": jax.device_put(jnp.asarray([11.0]), repl),
        "host_value": np.asarray([1.0, 2.0]),
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """JAX writes a checkpoint; 2 gloo ranks load it and write their own."""
    from hairgs_tpu.parallel.multihost import save_sharded_state

    tmp = str(tmp_path_factory.mktemp("multihost"))
    arrays = _arrays()
    jax_ckpt = os.path.join(tmp, "jax_ckpt")
    save_sharded_state(jax_ckpt, _jax_state(arrays), step=7)
    run = Ranks(2, ["checkpoint", "view_counts"],
                {"checkpoint": arrays, "jax_checkpoint": jax_ckpt}, tmp)
    return dict(results=run.wait(), arrays=arrays, dir=tmp)


@pytest.mark.parametrize(("n", "procs"), [(19, 8), (24, 8), (5, 2), (3, 4), (1, 1)])
def test_host_camera_indices_match_jax(n, procs):
    from hairgs_tpu.parallel.multihost import host_camera_indices as jidx
    from hairgs_tpu_torch.parallel.multihost import host_camera_indices

    owned = [host_camera_indices(n, p, procs) for p in range(procs)]
    assert owned == [jidx(n, p, procs) for p in range(procs)]
    assert sorted(i for sub in owned for i in sub) == list(range(n))
    assert host_camera_indices(n) == list(range(n))  # no process group: rank 0 of 1


def test_jax_checkpoint_loads_in_the_port(ranks):
    for rank, res in ranks["results"].items():
        got = res["checkpoint"]["from_jax"]
        lo = rank * N_ROWS // 2
        for key in ("endpoints", "width"):
            np.testing.assert_array_equal(got[key],
                                          ranks["arrays"][key][lo:lo + N_ROWS // 2])
        np.testing.assert_array_equal(got["step_count"], [11.0])
        np.testing.assert_array_equal(got["host_value"], [1.0, 2.0])
        assert res["checkpoint"]["jax_step"] == 7


def test_port_round_trip_is_bit_equal(ranks):
    for rank, res in ranks["results"].items():
        got = res["checkpoint"]["loaded"]
        lo = rank * N_ROWS // 2
        for key in ("endpoints", "width"):
            np.testing.assert_array_equal(got[key],
                                          ranks["arrays"][key][lo:lo + N_ROWS // 2])
        np.testing.assert_array_equal(got["step_count"], [11.0])
        assert res["checkpoint"]["step"] == 42
        assert res["checkpoint"]["files"] == ["manifest.json", "shard_0.npz",
                                              "shard_1.npz"]
    half = N_ROWS // 2
    assert ranks["results"][0]["checkpoint"]["my_file"] == sorted([
        "['host_value']__R", "['params']/['endpoints']__0_0",
        "['params']/['width']__0_0", "['step_count']__R"])
    assert ranks["results"][1]["checkpoint"]["my_file"] == sorted([
        f"['params']/['endpoints']__{half}_0", f"['params']/['width']__{half}_0"])


def test_jax_reads_the_port_checkpoint(ranks):
    """The port's 2-rank files in JAX's layout: JAX loads them into a
    2-device gauss sharding (the same block boundaries)."""
    from hairgs_tpu.parallel.multihost import load_sharded_state as jload

    template = jax.tree.map(
        lambda x: (jax.device_put(jnp.zeros_like(x), x.sharding)
                   if hasattr(x, "sharding") else np.zeros_like(x)),
        _jax_state(ranks["arrays"], n_devices=2))
    loaded, step = jload(os.path.join(ranks["dir"], "port_ckpt"), template)
    assert step == 42
    for k, v in ranks["arrays"].items():
        np.testing.assert_array_equal(np.asarray(loaded["params"][k]), v)
    np.testing.assert_array_equal(np.asarray(loaded["step_count"]), [11.0])
    np.testing.assert_array_equal(loaded["host_value"], [1.0, 2.0])


def test_schema_drift_guards(ranks, tmp_path):
    from hairgs_tpu_torch.parallel.multihost import (
        RowShard,
        load_sharded_state,
        save_sharded_state,
    )

    state = {"a": torch.arange(4.0), "b": RowShard((4, 1), 0, torch.ones(4, 1))}
    save_sharded_state(str(tmp_path), state, step=1)
    with pytest.raises(KeyError, match="schema drift"):
        load_sharded_state(str(tmp_path), {**state, "c": torch.zeros(2)})
    with pytest.warns(UserWarning, match=r"\['b'\]"):
        loaded, _ = load_sharded_state(str(tmp_path), {"a": torch.zeros(4)})
    np.testing.assert_array_equal(loaded["a"].numpy(), np.arange(4.0))
    with pytest.raises(KeyError, match="not all in the checkpoint"):
        load_sharded_state(str(tmp_path), {"a": torch.zeros(4),
                                           "b": RowShard((4, 1), 2, torch.zeros(4, 1))})


def test_global_view_batch_checks_the_shards(ranks):
    for res in ranks["results"].values():
        assert res["view_counts"] == {"even": [2, 2], "uneven_raises": True}
