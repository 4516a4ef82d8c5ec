"""`correct` at a size the CPU holds, with the cells' committed limits: a
sound run passes; runs with the timed path broken underneath (the optimiser
step returning its state unchanged; half of the image left out of the
losses, the mean taken over the rest) fail; the control, the reference in
TF32 in the program's place, fails. The harness's look for a chip is
skipped: these runs take `device="cpu"` and the plain compositor."""

import time

import pytest
import torch

from benchmark import check, harness


def run(spec):
    result, rows, correct = harness.run(spec, 2**31 + 5, 0.5, False, time.perf_counter(),
                                        device="cpu")
    return correct, {n: v for n, v, _ in rows}, result["check"]["followed"]


FIRST_STEP = ("loss_first", "grad", "grad_median", "grad_median_kept")
CELLS = pytest.mark.parametrize("workload", ["usc1k_stage1", "usc1k_stage3_merges"])
ALL_CELLS = pytest.mark.parametrize(
    "workload", ["usc1k_stage1", "usc1k_stage3_merges", "nersemble2x_stage1"])


@CELLS
def test_sound_run_is_correct(workload, tiny_spec):
    correct, numbers, _ = run(tiny_spec(workload))
    assert correct, numbers


def test_sound_first_step_within_limits(tiny_spec):
    """The first step's numbers of the other configuration. (Its later
    steps drift more at this size than at the cell's: a few hundred
    Gaussians, each of whose argmax axis flips moves the loss.)"""
    spec = tiny_spec("nersemble2x_stage1")
    _, numbers, _ = run(spec)
    assert numbers["view_match"] >= 0.95
    for k in FIRST_STEP:
        if k in spec.limits:
            assert numbers[k] <= spec.limits[k], (k, numbers)


@CELLS
def test_state_left_unchanged_fails(workload, monkeypatch, tiny_spec):
    from hairgs_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "adam_step",
                        lambda params, grads, state, lr, out=None: (params, state))
    correct, numbers, _ = run(tiny_spec(workload))
    assert not correct and numbers["change"] == pytest.approx(1.0)


@ALL_CELLS
def test_half_of_the_pixels_left_out_fails(workload, monkeypatch, tiny_spec):
    from hairgs_tpu_torch.train import trainer

    def top_half(fn):
        def loss(channels, camera, opt_cfg):
            h = channels.shape[0] // 2
            cut = camera._replace(**{k: getattr(camera, k)[:h] for k in
                                     ("image", "mask", "orientation", "confidence")})
            return fn(channels[:h], cut, opt_cfg)
        return loss

    monkeypatch.setattr(trainer, "_photometric_loss", top_half(trainer._photometric_loss))
    monkeypatch.setattr(trainer, "_auxiliary_loss", top_half(trainer._auxiliary_loss))
    correct, numbers, _ = run(tiny_spec(workload))
    assert not correct, numbers


@ALL_CELLS
def test_tf32_control_fails(workload, tiny_spec):
    spec = tiny_spec(workload)
    _, numbers, fol = run(spec)
    assert numbers["view_match"] >= 0.95
    cap, graph = harness.start(spec.config, spec.traffic, 2**31 + 5, torch.device("cpu"))
    args, _ = harness.port_args(["-s", "", *spec.config["flags"], *spec.traffic["flags"]])
    opt, rt = harness.opt_values(args), harness.rt_values(args)
    inputs = check.reference_inputs(cap, opt, "cpu", graph)
    base = check.follow(cap, opt, rt, "cpu", order=fol.order, inputs=inputs).readout
    low = check.follow(cap, opt, rt, "cpu", order=fol.order, inputs=inputs,
                       precision="tf32").readout
    kept = ~(fol.truncated | fol.capped)
    ok, rows = check.judge(check.compare(low, base, kept=kept)[0], spec.limits)
    assert not ok, rows
