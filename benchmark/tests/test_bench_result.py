"""The result line's shape, and the check of loaded modules by whole
top-level names."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

from benchmark import harness
from benchmark.trace import Trace


def _run(traced):
    run = harness.load_run("sd14_refine_b8", 5, 1.0, traced, 0.0)
    run.setup_s, run.attempted = 12.5, 3
    run.e2e["frames_per_s"] = 22.0
    run.memory_peak_bytes = 123
    run.check("encode_rel", 0.01, 0.05)
    run.check("failed_requests", 0, 0)
    return run


def test_untraced_line_holds_the_end_to_end_metrics():
    out = harness.result(_run(False), "NVIDIA H100 80GB HBM3")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True
    assert out["metrics"] == {"frames_per_s": {"value": 22.0,
                                               "unit": "frames/s"},
                              "setup_s": {"value": 12.5, "unit": "s"}}
    assert out["device"] == {"platform": "gpu",
                             "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                             "memory_peak_bytes": 123}
    assert out["checks"]["encode_rel"] == {"value": 0.01, "limit": 0.05}
    json.dumps(out)


def test_traced_line_holds_per_layer_metrics_and_breakdown():
    run = _run(True)
    run.trace = Trace([(f"k{i}", 10 * i, 10 * i + 5) for i in range(30)],
                      [], (0, 400), 2)
    out = harness.result(run, "card")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert "device_idle.frames" in out["metrics"]
    assert "frames_per_s" not in out["metrics"]
    assert out["device"]["busy_s"] == 150e-6
    assert out["device"]["window_s"] == 400e-6
    assert len(out["breakdown"]["device_ops"]) <= 10
    assert len(out["breakdown"]["idle_gaps"]) == 10


def test_a_number_over_its_limit_or_unset_fails_the_run():
    run = _run(False)
    run.check("rollout_rel", 0.2, 0.1)
    assert not run.correct
    run = _run(False)
    run.check("rollout_rel", 0.2, None)
    assert not run.correct


def test_top_level_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["sd_video_gen_tpu_torch", "sd_video_gen_tpu_torch.ops", "numpy",
         "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(
        ["sd_video_gen_tpu.models.unet", "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "sd_video_gen_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in (
                "sd_video_gen_tpu_torch", *harness.FORBIDDEN), (path, name)


def test_no_source_of_the_benchmark_imports_jax_or_its_package():
    for path in harness.HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def _bench(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "sd14_refine_b8", "--seed", "3", "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_without_a_card_it_fails_and_prints_no_result():
    out = _bench(harness.HERE.parent)
    assert out.returncode == 3
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_files_alone_print_no_result(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.HERE.parent / "BENCHMARK.json", tmp_path)
    out = _bench(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
