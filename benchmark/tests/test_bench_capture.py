"""The capture generator: seeded, at the configuration's shapes, equal for
equal seeds, and written in the layout the program's loader reads."""

import numpy as np
import pytest
import torch

from benchmark import capture


@pytest.mark.parametrize("workload", ["usc1k_stage1", "nersemble2x_stage1"])
def test_capture_shapes_and_seeding(workload, tiny_spec):
    cfg = tiny_spec(workload).config
    cam = cfg["capture"]["cameras"]
    a = capture.make(cfg, 2**31 + 11, torch.device("cpu"))
    b = capture.make(cfg, 2**31 + 11, torch.device("cpu"))
    c = capture.make(cfg, 2**31 + 12, torch.device("cpu"))
    n_views = cam.get("count") or len(cam["azimuth_deg"]) * len(cam["elevation_deg"])
    assert len(a["cameras"]) == len(a["views"]) == n_views
    for rgb, mask, orient, conf in a["views"]:
        assert rgb.shape == (cam["height"], cam["width"], 3) and rgb.dtype == np.uint8
        assert mask.shape == orient.shape == conf.shape == (cam["height"], cam["width"])
        assert set(np.unique(mask)) <= {0, 255} and mask.any()
    init = cfg["capture"]["init_points"]
    hair = cfg["capture"]["hair"]
    want = (-(-hair["strands"] * hair["points_per_strand"] // init["stride"])
            if init["from"] == "hair_vertices" else init["count"])
    assert a["points"].shape == (want, 3) and a["colours"].shape == (want, 3)
    assert np.array_equal(a["points"], b["points"])
    assert all(np.array_equal(x, y) for v, w in zip(a["views"], b["views"]) for x, y in zip(v, w))
    assert not np.array_equal(a["points"], c["points"])


def test_written_scene_reads_back(tmp_path, tiny_spec):
    from hairgs_tpu_torch.io.dataset import load_camera, read_colmap_scene_info

    cfg = tiny_spec().config
    cap = capture.make(cfg, 7, torch.device("cpu"))
    capture.write(cap, str(tmp_path))
    info = read_colmap_scene_info(str(tmp_path))
    assert np.array_equal(info.points, cap["points"])
    assert np.array_equal(np.round(info.colors * 255).astype(np.uint8), cap["colours"])
    assert [c.image_name for c in info.cameras] == sorted(c["name"] for c in cap["cameras"])
    by_name = {c["name"]: v for c, v in zip(cap["cameras"], cap["views"])}
    cam = load_camera(info.cameras[0], device="cpu")
    rgb, mask, orient, _ = by_name[info.cameras[0].image_name]
    assert torch.equal(cam.image, torch.tensor(rgb, dtype=torch.float32) / 255.0)
    assert torch.equal(cam.mask, torch.tensor(mask > 127, dtype=torch.float32))
    assert cam.orientation.shape == orient.shape


def test_qvec_round_trip():
    rng = np.random.default_rng(0)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    q = q if q[0] >= 0 else -q
    assert np.allclose(capture.rotmat2qvec(capture.qvec2rotmat(q)), q, atol=1e-12)


def test_merged_graph_shapes_and_seeding(tiny_spec):
    spec = tiny_spec("usc1k_stage3_merges")
    cfg = spec.config
    mg = cfg["merged_graph"]
    cap = capture.make(cfg, 2**31 + 11, torch.device("cpu"))
    a = capture.merged_graph(mg, cap, 2**31 + 11, torch.device("cpu"))
    b = capture.merged_graph(mg, cap, 2**31 + 11, torch.device("cpu"))
    c = capture.merged_graph(mg, cap, 2**31 + 12, torch.device("cpu"))
    n_str = cfg["capture"]["hair"]["strands"]
    pieces = mg["pieces"]
    segs = pieces * mg["segments_per_piece"]
    assert a["endpoints"].shape == (pieces * (mg["segments_per_piece"] + 1), 3)
    assert a["endpoint_pairs"].shape == (segs, 2)
    assert a["features_dc"].shape == (segs, 1, 3)
    assert all(a[k].shape == (segs, 1) for k in ("opacity", "mask", "width"))
    assert a["ref_strand_root"].shape == (n_str, 3)
    deg = np.bincount(a["endpoint_pairs"].ravel())
    assert deg.max() == 2 and (deg == 1).sum() == 2 * pieces  # paths of the pieces
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["endpoints"], c["endpoints"])
    # the capture's own draws are those of a Stage-I cell: unchanged by the graph
    first = capture.make(tiny_spec("usc1k_stage1").config, 2**31 + 11, torch.device("cpu"))
    assert np.array_equal(first["points"], cap["points"])


def test_hair_checkpoint_loads_as_the_graph(tmp_path, tiny_spec):
    """The written checkpoint loads through the program's reader into a
    strand graph whose walk finds one strand per piece."""
    from hairgs_tpu_torch.io.ply import load_hair_ply
    from hairgs_tpu_torch.models.hair import HairModel

    spec = tiny_spec("usc1k_stage3_merges")
    mg = spec.config["merged_graph"]
    cap = capture.make(spec.config, 3, torch.device("cpu"))
    graph = capture.merged_graph(mg, cap, 3, torch.device("cpu"))
    path = str(tmp_path / "point_cloud.ply")
    capture.write_hair_ply(path, graph)
    arrays, root_idx, ref_root = load_hair_ply(path, 0)
    assert np.array_equal(arrays["endpoints"], graph["endpoints"])
    assert np.array_equal(arrays["endpoint_pairs"], graph["endpoint_pairs"])
    for k in ("features_dc", "opacity", "mask", "width"):
        assert np.array_equal(arrays[k], graph[k]), k
    assert np.array_equal(root_idx, graph["strand_root_idx"])
    assert np.array_equal(ref_root, graph["ref_strand_root"])
    model = HairModel(device="cpu")
    model.load_ply(path)
    assert len(model.strands_info.list_strands) == mg["pieces"]


def test_merged_graph_at_the_configuration_lies_on_seen_hair():
    """At the configuration's own size: every segment is shorter than the
    program's split length (the foreground's bounding-box diagonal over
    num_points_strand, models/hair.py training_setup), so densification
    splits none for its length alone, and the pieces lie on GT steps that
    some view shows."""
    import json
    import os

    from hairgs_tpu_torch.config import OptimizationConfig

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with open(os.path.join(root, "benchmark", "configs", "usc_hairsalon_1k.json")) as fh:
        cfg = json.load(fh)
    cap = capture.make(cfg, 2**31 + 17, torch.device("cpu"))
    g = capture.merged_graph(cfg["merged_graph"], cap, 2**31 + 17, torch.device("cpu"))
    ep, pairs = g["endpoints"], g["endpoint_pairs"]
    assert pairs.shape[0] == cfg["sizes"]["merged_graph"]["segments"]
    assert ep.shape[0] == cfg["sizes"]["merged_graph"]["endpoints"]
    split = np.linalg.norm(ep.max(0) - ep.min(0)) / OptimizationConfig().num_points_strand
    lengths = np.linalg.norm(ep[pairs[:, 0]] - ep[pairs[:, 1]], axis=1)
    assert lengths.max() < split
    assert abs(np.median(lengths) - cfg["assumed"]["merged_graph_segment_m"]) < 5e-4
    seen = cap["visible"].numpy()
    steps = g["gt_index"][:, :1] + np.arange(g["gt_index"][0, -1] - g["gt_index"][0, 0])
    on_seen = seen[g["gt_strand"][:, None], steps].mean()
    assert seen.mean() < 0.5 and on_seen > 0.9, (seen.mean(), on_seen)
