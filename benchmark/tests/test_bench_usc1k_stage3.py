"""The cell usc1k_stage3 as BENCHMARK.json declares it: its configuration,
traffic and limits files exist and load, its limits name only numbers that
`check.compare` gives (`change` among them), and it is in the lists of
`stage3_it_s` and of every `.stage3` per-layer metric."""

import json
import os

import torch

from benchmark import check, harness
from benchmark.reference.stage1 import Readout

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "usc1k_stage3"


def _manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _compared_numbers():
    """The names of the numbers `check.compare` gives, kept splats and all."""
    one = torch.ones(4, 3)
    read = Readout(losses=[1.0, 1.0], grads={"a": one, "b": 2 * one},
                   changes={"a": one, "b": one}, grad_accum=torch.ones(4))
    numbers, _ = check.compare(read, read, kept=torch.ones(4, dtype=torch.bool))
    return set(numbers)


def test_the_cell_resolves_to_its_files():
    manifest = _manifest()
    cell = next(w for w in manifest["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "usc_hairsalon_1k_fitted", "stage3_full_from_fitted", 1)
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    assert conf["file"] == "benchmark/configs/usc_hairsalon_1k_fitted.json"
    assert conf["reduced"] == []
    spec = harness.load_cell(ROOT, CELL)
    assert spec.config["name"] == conf["name"] and spec.config["reduced"] == []
    assert spec.config["source"] == conf["source"]
    assert spec.traffic["start"] == "fitted_graph"
    assert spec.traffic["rate_metric"] == "stage3_it_s"
    assert os.path.exists(os.path.join(ROOT, spec.config["fitted_start"]["file"]))


def test_the_limits_name_compared_numbers():
    with open(os.path.join(ROOT, "benchmark", "limits", f"{CELL}.json")) as fh:
        limits = json.load(fh)
    assert "change" in limits and len(limits) >= 3
    assert set(limits) <= _compared_numbers()
    assert all(isinstance(v, float) and v > 0 for v in limits.values())


def test_every_stage3_metric_lists_the_cell():
    manifest = _manifest()
    rate = next(m for m in manifest["end_to_end"] if m["name"] == "stage3_it_s")
    assert CELL in rate["workloads"]
    stage3 = [m for m in manifest["per_layer"] if m["name"].endswith(".stage3")]
    assert len(stage3) == 14
    for m in stage3:
        assert CELL in m["workloads"], m["name"]
        assert m["moves"] == "stage3_it_s"
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"))
    densify = next(m for m in stage3 if m["name"] == "densify_strategies_share.stage3")
    assert densify == {"name": "densify_strategies_share.stage3", "unit": "%",
                       "better": "lower", "source": "program_span",
                       "layer": "driver loop and topology events", "moves": "stage3_it_s",
                       "workloads": [CELL]}
