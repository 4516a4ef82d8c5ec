"""Shared fixtures of the benchmark's own tests (run them with
`python -m pytest benchmark/tests -q`; the repository's `pytest tests/`
does not collect them). Tests that need a CUDA device take the `card`
fixture, which skips them where there is none."""

import copy
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_spec():
    return make_tiny_spec


def make_tiny_spec(workload="usc1k_stage1"):
    """The cell at a size the CPU holds: 150 strands x 12 points (a
    Stage-III start of 200 pieces of 2 two-step segments), 4 views at 96 x 96,
    the paged path's plain versions, a 5-iteration warm-up."""
    from benchmark import harness

    spec = harness.load_cell(ROOT, workload)
    cfg = copy.deepcopy(spec.config)
    cap = cfg["capture"]
    cap["hair"].update(strands=150, points_per_strand=12, segment_m=0.01)
    if cap["cameras"]["layout"] == "ring":
        cap["cameras"].update(count=4, width=96, height=96, focal_px=64.0)
    else:
        cap["cameras"].update(width=96, height=128, focal_px=260.0, azimuth_deg=[-30, 30],
                              elevation_deg=[0, 15])
        cap["head"]["render_points"] = 20000
        cap["init_points"]["count"] = 1000
        cap["samples_per_segment"] = 3
    if cap["init_points"]["from"] == "hair_vertices":
        cap["init_points"]["stride"] = 2
    if "merged_graph" in cfg:
        cfg["merged_graph"].update(pieces=200, segments_per_piece=2, segment_points=2,
                                   gap_points=0, jitter_m=0.002)
    cfg["flags"] = ["--use_pallas", "true", "--composite_chunk", "32",
                    "--max_pairs_per_tile", "256", "--capacity_round", "256",
                    "--pair_capacity_round", "4096"]
    traffic = dict(spec.traffic, warmup_iterations=5, profile_max_iterations=3)
    return spec._replace(config=cfg, traffic=traffic)
