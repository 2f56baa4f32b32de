"""The port's training-CLI tool (``sd_video_gen_tpu_torch/tools/
bench_cli_train.py``) against the JAX tool (``tools/bench_cli_train.py``).

Tolerances: none. The config parses to the JAX tool's fields; the cache and
trainer command lines equal the JAX tool's but for the module and the
port-only ``--device``; one fixed metrics JSONL gives the same printed rates
through both tools' mains. The real trainer child runs a tiny config on the
CPU from a Moving-MNIST-layout cache.
"""

import importlib
import json
import os
import subprocess
import sys

import pytest

from sd_video_gen_tpu_torch.config import load_config, write_config
from sd_video_gen_tpu_torch.tools import bench_cli_train as CT
from sd_video_gen_tpu_torch.tools import counted as C

TINY = dict(CT.CONFIG, FRAME_SIZE=16, DIM_MODEL=[32], NUM_HEADS=[2],
            NUM_ENCODER_LAYERS=[1], NUM_DECODER_LAYERS=[1])
ROWS = [{"event": "init"},
        {"epoch": 1, "step_ms_mean": 812.25, "step_ms_p95": 6123.5,
         "train_loss": 4.8312},
        {"epoch": 2, "step_ms_mean": 61.125, "step_ms_p95": 70.0,
         "train_loss": 3.9},
        {"epoch": 3, "step_ms_mean": 58.5, "step_ms_p95": 66.0,
         "train_loss": 3.4},
        {"epoch": 4, "step_ms_mean": 63.875, "step_ms_p95": 71.0,
         "train_loss": 2.98765}]


@pytest.fixture(scope="module")
def jax_tool():
    return importlib.import_module("tools.bench_cli_train")


@pytest.mark.parametrize("epochs", [2, 4])
def test_config_parses_to_the_jax_tools(tmp_path, jax_tool, epochs):
    a = tmp_path / "jax"
    a.mkdir()
    (a / "cli_flag128.yml").write_text(jax_tool.CONFIG_YML.format(
        epochs=epochs))
    paths = CT.prepare(str(tmp_path / "port"), epochs, "mnist", TINY)
    port = load_config(CT.CONFIG_NAME, paths["cfg_dir"])
    assert port.epochs == epochs and port.frame_size == 16
    os.makedirs(tmp_path / "full")
    write_config(str(tmp_path / "full" / "cli_flag128.yml"),
                 dict(CT.CONFIG, EPOCHS=[epochs]))
    assert load_config(CT.CONFIG_NAME, str(tmp_path / "full")) == \
        load_config(jax_tool.CONFIG_NAME, str(a))


def _fake_run(seen, workdir):
    def run(cmd, **kw):
        seen.append((cmd, kw["cwd"]))
        out = ""
        if "--native_cache" in cmd:         # the trainer: its metrics log
            os.makedirs(os.path.join(workdir, "logs"), exist_ok=True)
            with open(os.path.join(workdir, "logs", "cli_flag128_0.jsonl"),
                      "w") as f:
                f.writelines(json.dumps(r) + "\n" for r in ROWS)
            if cmd[2] == C.__name__:
                out = C.PREFIX + json.dumps({"launches": {}}) + "\n"
        return subprocess.CompletedProcess(cmd, 0, out, "")
    return run


def _strip(cmd):
    assert cmd[0] == sys.executable and cmd[1] == "-m"
    rest = list(cmd[3:])
    if "--device" in rest:
        i = rest.index("--device")
        del rest[i:i + 2]
    return cmd[2], rest


@pytest.mark.parametrize("precision", ["bf16_full", "f32"])
def test_argv_and_reduction_are_the_jax_tools(tmp_path, monkeypatch, capsys,
                                              jax_tool, precision):
    """Both mains over the same workdir (the data already there), their
    children faked: the same command lines and printed rates."""
    w = str(tmp_path)
    os.makedirs(os.path.join(w, "ball", "test"))
    seen = []
    monkeypatch.setattr(jax_tool.subprocess, "run", _fake_run(seen, w))
    monkeypatch.setattr(CT.subprocess, "run", _fake_run(seen, w))
    monkeypatch.setattr(sys, "argv", ["bench_cli_train.py", "--workdir", w,
                                      "--precision", precision])
    jax_tool.main()
    theirs = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert CT.main(["--workdir", w, "--precision", precision,
                    "--device", "cpu"]) == 0
    mine = json.loads(capsys.readouterr().out.splitlines()[-1])
    (jcache, jc1), (jtrain, jc2), (cache, c1), (train, c2) = seen
    assert jc1 == c1 == CT.REPO and jc2 == c2 == w
    assert _strip(cache) == (CT.LOADER, jcache[3:])
    assert jcache[2] == "sd_video_gen_tpu.data.native_loader"
    assert _strip(train) == (CT.TRAINER, jtrain[3:])
    assert jtrain[2] == "trainers.trainer" and train[-2:] == ["--device",
                                                              "cpu"]
    assert set(theirs) <= set(mine)
    assert {k: mine[k] for k in theirs if k not in ("note", "wall_s")} == \
        {k: v for k, v in theirs.items() if k not in ("note", "wall_s")}
    assert mine["steady_steps_per_s"] == round(1e3 / 61.166666666666664, 2)


def test_counted_trainer_argv(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(CT.subprocess, "run", _fake_run(seen, str(tmp_path)))
    paths = CT.prepare(str(tmp_path), 2, "mnist", TINY)
    run = CT.run_trainer(str(tmp_path), paths, "bf16_full", 60,
                         counted=True)
    (cmd, _), = seen
    assert cmd[2:4] == [C.__name__, CT.TRAINER]
    assert run["launches"] == {"launches": {}}
    assert [r["epoch"] for r in run["rows"]] == [1, 2, 3, 4]


def test_real_trainer_run_on_the_cpu(tmp_path):
    w = str(tmp_path)
    paths = CT.prepare(w, 2, "mnist", TINY)
    CT.build_cache(paths)
    assert os.path.isfile(os.path.join(paths["cache"], "test.bin"))
    run = CT.run_trainer(w, paths, "bf16_full", 300, device="cpu",
                         counted=True)
    s = CT.summarize(run["rows"], "bf16_full", run["wall_s"])
    assert len(run["rows"]) == 2 and len(s["warm_epoch_step_ms"]) == 1
    assert s["steady_steps_per_s"] > 0 and s["compile_epoch_p95_ms"] > 0
    assert all(x == x for x in s["train_loss_first_last"])   # finite
    assert run["launches"]["launches"] == {"flash_attention": 0,
                                           "groupnorm_silu": 0}
    assert os.path.isdir(os.path.join(paths["checkpoints"],
                                      "cli_flag128_0_test"))


def test_flags_and_defaults_are_the_jax_tools(monkeypatch, jax_tool):
    from test_torch_bench_cli_serving import parser_of
    theirs = parser_of(jax_tool.main, monkeypatch)
    mine = parser_of(CT.main, monkeypatch, [])
    assert mine.pop("--dataset") == "ball" and mine.pop("--device") is None
    assert os.path.basename(mine.pop("--workdir")) == os.path.basename(
        theirs.pop("--workdir"))
    assert mine == theirs
