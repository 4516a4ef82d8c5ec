"""Port parity, precision probe: the plain versions of
hairgs_tpu_torch/probes/precision_probe.py on the CPU, against float64 and
jnp at Precision.HIGHEST on the inputs of scripts/mosaic_precision_probe.py,
and its TF32 rounding against a bit-level numpy reference of
`cvt.rna.tf32.f32`. The gates are those chip_smoke.py phase 10 holds the
kernel to: fp32 product rel-vs-f64 < 1e-5, TF32 product < 2e-3 and above
the fp32 one, exp and log1p < 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _tf32_reference(a):
    """cvt.rna.tf32.f32 on the bits: keep the top 19 bits; when the 13
    dropped bits are at least half (0x1000) step the magnitude up by one
    TF32 quantum (ties away from zero); NaN passes through."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    keep = bits & 0xFFFFE000
    up = (bits & 0x1FFF) >= 0x1000
    out = np.where(up, keep + 0x2000, keep).astype(np.uint32).view(np.float32)
    return np.where(np.isnan(a), a, out)


def test_probe_inputs_are_the_scripts_draws():
    from hairgs_tpu_torch.probes.precision_probe import probe_inputs

    A, B, x, al = probe_inputs()
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(A, rng.uniform(-0.05, 0.0, (256, 128)).astype(np.float32))
    np.testing.assert_array_equal(B, (rng.uniform(0, 1, (128, 128)) < 0.5).astype(np.float32))
    np.testing.assert_array_equal(x, rng.uniform(-9.0, 0.0, (8, 128)).astype(np.float32))
    np.testing.assert_array_equal(al, rng.uniform(0.0, 0.99, (8, 128)).astype(np.float32))


def test_plain_probe_matches_f64_and_jnp_highest():
    from hairgs_tpu_torch.probes import precision_probe as pp

    k_out, l_out, truth, lines = pp.run_probe("cpu")
    hi, tf32, e, l1p = k_out
    g_dot, g_exp, g_l1p = truth
    assert pp.rel(hi, g_dot) < 1e-5
    assert pp.rel(hi, g_dot) < pp.rel(tf32, g_dot) < 2e-3
    assert pp.rel(e, g_exp) < 1e-6
    assert pp.rel(l1p, g_l1p) < 1e-6
    A, B, x, al = pp.probe_inputs()
    j_hi = np.asarray(jnp.dot(jnp.asarray(A), jnp.asarray(B),
                              precision=jax.lax.Precision.HIGHEST))
    np.testing.assert_allclose(hi, j_hi, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(e, np.asarray(jnp.exp(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(l1p, np.asarray(jnp.log1p(jnp.asarray(-al))),
                               rtol=1e-6, atol=1e-9)
    # the TF32 product is the fp32 product of the rounded operands
    np.testing.assert_array_equal(
        tf32, _tf32_reference(A) @ _tf32_reference(B).astype(np.float32))
    assert len(lines) == 4 and lines[0].startswith("dot rel-vs-f64: kernel HIGHEST=")


def _f32(bits):
    return np.array([bits], np.uint32).view(np.float32)[0]


@pytest.mark.parametrize("value,expect", [
    # 1 + 2^-11 is a tie between 1 and 1 + 2^-10: away from zero
    pytest.param(_f32(0x3F801000), _f32(0x3F802000), id="tie_up"),
    pytest.param(_f32(0xBF801000), _f32(0xBF802000), id="tie_negative"),
    pytest.param(_f32(0x3F800FFF), _f32(0x3F800000), id="below_tie"),
    pytest.param(_f32(0x3F801001), _f32(0x3F802000), id="above_tie"),
    # the largest finite float rounds past the largest TF32 value to inf
    pytest.param(_f32(0x7F7FFFFF), np.float32(np.inf), id="max_finite"),
    pytest.param(_f32(0x7F7FE000), _f32(0x7F7FE000), id="max_tf32"),
    # subnormals keep the same 13-bit quantum (2^-136)
    pytest.param(_f32(0x00000001), np.float32(0.0), id="min_subnormal"),
    pytest.param(_f32(0x00001000), _f32(0x00002000), id="subnormal_tie"),
    pytest.param(_f32(0x007FF000), _f32(0x00800000), id="subnormal_to_normal"),
    pytest.param(np.float32(np.inf), np.float32(np.inf), id="inf"),
    pytest.param(np.float32(-np.inf), np.float32(-np.inf), id="neg_inf"),
    pytest.param(np.float32(np.nan), np.float32(np.nan), id="nan"),
    pytest.param(_f32(0x7F800001), np.float32(np.nan), id="signalling_nan"),
])
def test_round_to_tf32_matches_cvt_rna(value, expect):
    from hairgs_tpu_torch.probes.precision_probe import round_to_tf32

    got = round_to_tf32(torch.tensor([value]))[0].numpy()
    ref = _tf32_reference(np.array([value]))[0]
    if np.isnan(expect):
        assert np.isnan(got) and np.isnan(ref)
    else:
        assert got.tobytes() == ref.tobytes() == np.float32(expect).tobytes()


def test_round_to_tf32_matches_reference_on_random_bits():
    from hairgs_tpu_torch.probes.precision_probe import round_to_tf32

    bits = np.random.default_rng(1).integers(0, 2**32, 200_000, dtype=np.uint64)
    a = bits.astype(np.uint32).view(np.float32)
    got = round_to_tf32(torch.from_numpy(a.copy())).numpy()
    ref = _tf32_reference(a)
    same = (got.view(np.uint32) == ref.view(np.uint32)) | (np.isnan(got) & np.isnan(ref))
    assert same.all()


def test_probe_kernel_wrapper_takes_only_cuda_tensors():
    """On a CPU tensor `probe` runs the plain version; the kernel's wrapper
    refuses anything but CUDA tensors and counts no launch when it raises."""
    from hairgs_tpu_torch.probes import precision_probe as pp

    t = [torch.tensor(a) for a in pp.probe_inputs()]
    before = dict(pp.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pp.probe_cuda(*t)
    assert pp.launches == before
    with pytest.raises(ValueError):
        pp.probe(*(x.to("meta") for x in t))
    for a, b in zip(pp.probe(*t), pp.probe_plain(*t)):
        assert torch.equal(a, b)
