"""A cell, a configuration, a traffic mix and a per-layer metric added as
new files are found by name, and BENCHMARK.json is what the files say."""

from __future__ import annotations

import json
import shutil

from benchmark import harness, manifest


def _copy(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def test_benchmark_json_is_built_from_the_files():
    assert (manifest.ROOT / "BENCHMARK.json").read_text() == manifest.text()


def test_new_files_add_a_cell_config_and_metric(tmp_path):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "ucf_final_sd14.json").read_text())
    cfg.update(name="another_model", why="a second configuration")
    (root / "configs" / "another_model.json").write_text(json.dumps(cfg))
    (root / "traffic" / "batch2_closed.json").write_text(json.dumps(
        {"arrival": "closed", "clips_per_request": 2, "context_frames": 5,
         "frame_size": 64, "pred_frames": 4, "check_requests": 1,
         "trace_units": 2}))
    (root / "workloads" / "another_b2.json").write_text(json.dumps(
        {"config": "another_model", "traffic": "batch2_closed",
         "driver": "predict_closed", "chips": 1, "why": "two clips",
         "limits": {"encode_rel": 1, "rollout_rel": 1, "frames_rel": 1}}))
    (root / "metrics" / "frames_done.frames.py").write_text(
        'BETTER = "higher"\nUNIT, SOURCE = "frames", "program_counter"\n'
        'LAYER = "whole request or step"\n'
        'MOVES, WORKLOADS = "frames_per_s", ["another_b2"]\n\n\n'
        'def read(run):\n    return run.counters.get("frames")\n')
    built = manifest.build(root)
    assert "another_b2" in [c["name"] for c in built["workloads"]]
    assert "another_model" in [c["name"] for c in built["configs"]]
    metric = next(m for m in built["per_layer"]
                  if m["name"] == "frames_done.frames")
    assert metric["workloads"] == ["another_b2"]
    run = harness.load_run("another_b2", 1, 1.0, True, 0.0, root=root)
    assert run.config["name"] == "another_model"
    assert run.traffic["clips_per_request"] == 2
    assert [m.name for m in harness.layers_of("another_b2", root)] == [
        "frames_done.frames"]
    assert harness.driver("predict_closed", root).run
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_a_new_cell_reports_existing_metrics_from_its_own_file(tmp_path):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "traffic" / "train_b12_stream.json").write_text(json.dumps(
        {"clips_per_step": 12, "clip_frames": 10, "frame_size": 128,
         "pool": 16, "trace_units": 12}))
    (root / "workloads" / "train_b12.json").write_text(json.dumps(
        {"config": "ucf_final_train", "traffic": "train_b12_stream",
         "driver": "train", "chips": 1, "why": "twelve clips a step",
         "limits": {"update_norm_gap": 0.5},
         "reports": ["train_clips_per_s", "mfu.train"]}))
    built = manifest.build(root)
    e2e = {m["name"]: m for m in built["end_to_end"]}
    layers = {m["name"]: m for m in built["per_layer"]}
    assert e2e["train_clips_per_s"]["workloads"] == ["train_b6", "train_b12"]
    assert layers["mfu.train"]["workloads"] == ["train_b6", "train_b12"]
    assert "train_b12" not in layers["optimizer_ms.train"]["workloads"]
    assert harness.e2e_of("train_b12", root) == ["setup_s",
                                                 "train_clips_per_s"]
    assert [m.name for m in harness.layers_of("train_b12", root)] == [
        "mfu.train"]
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_every_cell_names_files_that_exist():
    layers = harness.per_layer()
    e2e = harness.end_to_end()
    for name, cell in harness.cells().items():
        run = harness.load_run(name, 1, 1.0, False, 0.0)
        assert (harness.HERE / "drivers" / f"{cell['driver']}.py").exists()
        reported = harness.e2e_of(name)
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.layers_of(name)
        for m in harness.layers_of(name):
            assert m.moves in reported, (name, m.name)
        assert run.chips in (1, 4)
    for m in layers.values():
        assert m.moves in e2e
