"""The frozen bound and operation counts, held to hand counts."""

import math

import numpy as np
import torch

from benchmark import counts


def test_table_sizes_and_bounds_by_hand():
    c = torch.tensor([3, 0, 130])
    assert counts.table_sizes(c, 128) == (3, 133, 3)
    gates = (1000, 10)
    fwd_bytes = 4 * (133 * 6 + 2 * 3 + 3 * 256 * 8 + 3 * 256) + 4 * 133 * 7
    fwd_ops = 1000 * 16 + 10 * (19 - 7 + 7)
    ms, what = counts.fwd_bound_ms(c, 128, 7, gates)
    assert what == "bytes"
    assert math.isclose(ms, max(fwd_bytes / 3.35e12, fwd_ops / 67e12) * 1e3)
    bwd_bytes = (4 * (133 * 6 + 2 * 3 + 3 * 256 + 3 * 256 * (2 + 14) + 133 * 8)
                 + 2 * 4 * 133 * 7)
    ms, _ = counts.bwd_bound_ms(c, 128, 7, gates)
    assert math.isclose(ms, bwd_bytes / 3.35e12 * 1e3)
    assert counts.bwd_ops(gates) == 17000
    assert counts.bwd_ops(gates, stats=False) == 16960
    ms, what = counts.bound_ms(0, 67e9)
    assert what == "operations" and math.isclose(ms, 1.0)


def test_gate_counts_by_hand():
    # one Gaussian at (8, 8) of tile 0: conic diag(1/4), opacity 0.5
    geo = torch.zeros((8, 2))
    geo[:, 0] = torch.tensor([8.0, 8.0, 0.25, 0.0, 0.25, 0.5, 0.0, 0.0])
    n_all, n_pass = counts.gate_counts(geo, torch.tensor([0]), torch.tensor([1]), 1)
    hand = 0
    for py in range(16):
        for px in range(16):
            power = -0.5 * 0.25 * ((8 - px) ** 2 + (8 - py) ** 2)
            alpha = min(0.5 * np.exp(np.float32(power)), 0.99)
            hand += power <= 0 and alpha >= 1 / 255
    assert n_all == 256 and n_pass == hand and 0 < hand < 256


def test_step_ops_by_hand():
    per_pixel = (3 * (5 * 2 * 11 * 2 + 20) + 80) * 3
    per_splat = 300 * 3 + 8
    assert counts.step_ops(0, 1, 0, 0) == per_pixel
    assert counts.step_ops(0, 0, 1, 0) == per_splat
    assert counts.step_ops(0, 0, 0, 1) == 12
    assert counts.step_ops(5, 2, 3, 45) == 5 + 2 * per_pixel + 3 * per_splat + 12 * 45
