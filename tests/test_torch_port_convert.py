"""Port parity, the output converter: hairgs_tpu_torch.drivers.convert_output
against scripts/convert_output.py on the hair PLY of
tests/test_convert_output.py. The PLY files each writes are equal byte for
byte (faces, edges, the default output path); the hue ramp is equal."""

import os
import runpy
import shutil
import sys

import numpy as np
import pytest

from tests.test_convert_output import SCRIPT, hair_ply  # noqa: F401


def _run_jax(argv):
    old = sys.argv
    sys.argv = ["convert_output.py"] + argv
    try:
        runpy.run_path(SCRIPT, run_name="__main__")
    finally:
        sys.argv = old


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("mode", [[], ["--edges"]])
def test_plys_equal_byte_for_byte(hair_ply, tmp_path, mode):  # noqa: F811
    from hairgs_tpu_torch.drivers.convert_output import main

    _run_jax(["-i", hair_ply, "-t", "gs", "-o", str(tmp_path / "jax.ply"), *mode])
    out = main(["-i", hair_ply, "-t", "gs", "-o", str(tmp_path / "port.ply"),
                "--device", "cpu", *mode])
    assert out == str(tmp_path / "port.ply")
    assert _bytes(tmp_path / "port.ply") == _bytes(tmp_path / "jax.ply")


def test_default_output_path(hair_ply, tmp_path):  # noqa: F811
    from hairgs_tpu_torch.drivers.convert_output import main

    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
        shutil.copy(hair_ply, tmp_path / side / "point_cloud.ply")
    _run_jax(["-i", str(tmp_path / "jax" / "point_cloud.ply")])
    out = main(["-i", str(tmp_path / "port" / "point_cloud.ply"), "--device", "cpu"])
    assert out == str(tmp_path / "port" / "strands.ply")
    assert _bytes(out) == _bytes(tmp_path / "jax" / "strands.ply")
    with pytest.raises(ValueError, match="not supported"):
        main(["-i", out, "-t", "bogus"])


def test_strand_hue_colors_match_jax():
    sys.path.insert(0, os.path.dirname(SCRIPT))
    from convert_output import strand_hue_colors as jax_colors

    from hairgs_tpu_torch.drivers.convert_output import strand_hue_colors

    sid = np.random.default_rng(0).integers(0, 37, 500)
    np.testing.assert_array_equal(strand_hue_colors(sid), jax_colors(sid))
