"""The port's serving-CLI tool (``sd_video_gen_tpu_torch/tools/
bench_cli_serving.py``) against the JAX tool (``tools/bench_cli_serving.py``),
and the launch-counting runner (``tools/counted.py``).

Tolerances: none. The config parses to the JAX tool's fields; the child's
command lines equal the JAX tool's but for the module and the port-only
flags (``--device``); one fixed ``--timing`` payload gives the same printed
rates through both tools' reductions; the runner's counts equal an
in-process count of the same CLI call. The real children run at a tiny
config on the CPU with ``--codec pixel`` and no refiner (an extra argv),
which keeps them to seconds.
"""

import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

from sd_video_gen_tpu_torch.config import load_config, write_config
from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.predict import predict as P
from sd_video_gen_tpu_torch.tools import bench_cli_serving as CS
from sd_video_gen_tpu_torch.tools import counted as C

TINY = dict(CS.CONFIG, FRAME_SIZE=16, DIM_MODEL=[32], NUM_HEADS=[2],
            NUM_ENCODER_LAYERS=[1], NUM_DECODER_LAYERS=[1])
PIXEL = ["--codec", "pixel", "--denoise", "False"]
TIMING = {"stage_s": {"data": 0.5, "dispatch": 1.0, "decode": 20.0,
                      "io": 0.0}, "total_s": 37.125, "clips": 64,
          "pred_frames_per_clip": 4, "batches": 8, "first_sync_s": 11.75,
          "note": "fixed"}


@pytest.fixture(scope="module")
def jax_tool():
    return importlib.import_module("tools.bench_cli_serving")


def _paths(tmp_path):
    """The same files named in each tool's paths dict."""
    d = {k: str(tmp_path / k) for k in ("ball", "cfg_dir", "ckpt_dir")}
    return d, {"dataset": "ball", "folder": d["ball"],
               "cfg_dir": d["cfg_dir"], "ckpt_dir": d["ckpt_dir"]}


def _strip(cmd):
    """The command line after the interpreter and the module(s), without
    the port-only ``--device`` flag."""
    assert cmd[0] == sys.executable and cmd[1] == "-m"
    rest = cmd[3:]
    if cmd[2] == C.__name__:
        assert rest[0] == CS.PREDICT
        rest = rest[1:]
    out, skip = [], False
    for x in rest:
        if skip:
            skip = False
        elif x == "--device":
            skip = True
        else:
            out.append(x)
    return cmd[2], out


def test_config_parses_to_the_jax_tools(tmp_path, jax_tool):
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir(), b.mkdir()
    (a / "cli_flagship.yml").write_text(jax_tool.CONFIG_YML)
    write_config(str(b / "cli_flagship.yml"), CS.CONFIG)
    assert CS.CONFIG_NAME == jax_tool.CONFIG_NAME
    assert load_config(CS.CONFIG_NAME, str(b)) == \
        load_config(jax_tool.CONFIG_NAME, str(a))


@pytest.mark.parametrize("sampler,steps", [("ddim", None), ("dpmpp", 5)])
@pytest.mark.parametrize("counted", [False, True])
def test_batch_argv_is_the_jax_tools(tmp_path, monkeypatch, jax_tool,
                                     sampler, steps, counted):
    jax_paths, paths = _paths(tmp_path)
    seen = []

    def fake_run(cmd, **kw):
        seen.append((cmd, kw["cwd"]))
        out = json.dumps(TIMING) + "\n"
        if cmd[2] == C.__name__:
            out += C.PREFIX + json.dumps({"launches": {}}) + "\n"
        return subprocess.CompletedProcess(cmd, 0, out, "")

    monkeypatch.setattr(jax_tool.subprocess, "run", fake_run)
    monkeypatch.setattr(CS.subprocess, "run", fake_run)
    want = jax_tool.run_cli(jax_paths, 64, 8, 4, False, 60, sampler, steps)
    got = CS.run_cli(paths, 64, 8, 4, False, 60, sampler, steps,
                     device="cuda", counted=counted)
    (jcmd, jcwd), (cmd, cwd) = seen
    assert jcmd[2] == "prediction.predict" and jcwd == cwd == CS.REPO
    module, rest = _strip(cmd)
    assert module == (C.__name__ if counted else CS.PREDICT)
    assert rest == jcmd[3:]
    assert cmd[-2:] == ["--device", "cuda"]
    assert {k: v for k, v in got.items() if k not in ("wall_s", "launches")} \
        == {k: v for k, v in want.items() if k != "wall_s"}
    assert ("launches" in got) == counted


@pytest.mark.parametrize("steps", [None, 5])
def test_serve_argv_is_the_jax_tools(tmp_path, monkeypatch, jax_tool, steps):
    jax_paths, paths = _paths(tmp_path)
    os.makedirs(paths["cfg_dir"])
    write_config(os.path.join(paths["cfg_dir"], "cli_flagship.yml"),
                 CS.CONFIG)
    seen = []

    class Stop(Exception):
        pass

    def fake_popen(cmd, **kw):
        seen.append((cmd, kw["cwd"]))
        raise Stop

    monkeypatch.setattr(jax_tool.subprocess, "Popen", fake_popen)
    monkeypatch.setattr(CS.subprocess, "Popen", fake_popen)
    for fn, p in ((jax_tool.run_serve_bench, jax_paths),
                  (CS.run_serve_bench, paths)):
        with pytest.raises(Stop):
            fn(p, 8, 4, 6, 60, "dpmpp", steps)
    (jcmd, jcwd), (cmd, cwd) = seen
    assert jcwd == cwd == CS.REPO
    assert _strip(cmd) == (CS.PREDICT, jcmd[3:])


@pytest.mark.parametrize("argv", [[], ["--sampler", "dpmpp",
                                       "--solver_steps", "5"],
                                  ["--streams", "16", "--n_batches", "4"]])
def test_batch_reduction_is_the_jax_tools(tmp_path, monkeypatch, capsys,
                                          jax_tool, argv):
    """One fixed --timing payload through both tools' mains: the same
    printed rates and fields."""
    jax_paths, paths = _paths(tmp_path)
    flags = dict(zip(argv[::2], argv[1::2]))
    streams = int(flags.get("--streams", 8))
    batches = int(flags.get("--n_batches", 8))
    timing = dict(TIMING, clips=streams * batches)
    monkeypatch.setattr(jax_tool, "prepare", lambda w, n: jax_paths)
    monkeypatch.setattr(jax_tool, "run_cli",
                        lambda *a, **k: dict(timing, wall_s=40.0))
    monkeypatch.setattr(sys, "argv", ["bench_cli_serving.py",
                                      "--workdir", str(tmp_path)] + argv)
    jax_tool.main()
    theirs = json.loads(capsys.readouterr().out.splitlines()[-1])
    monkeypatch.setattr(CS, "prepare", lambda *a, **k: paths)
    monkeypatch.setattr(CS, "run_cli",
                        lambda *a, **k: dict(timing, wall_s=40.0))
    assert CS.main(["--workdir", str(tmp_path), "--device", "cpu"]
                   + argv) == 0
    mine = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(theirs) <= set(mine)
    assert {k: mine[k] for k in theirs if k != "note"} == \
        {k: v for k, v in theirs.items() if k != "note"}
    assert mine["card"] is None


@pytest.fixture(scope="module")
def tiny_serving(tmp_path_factory):
    """The tiny config's clips (Moving-MNIST layout) and checkpoint."""
    w = str(tmp_path_factory.mktemp("serving"))
    return CS.prepare(w, 6, "mnist", "cpu", config=TINY)


def test_prepare_writes_what_the_cli_reads(tiny_serving):
    cfg = load_config(CS.CONFIG_NAME, tiny_serving["cfg_dir"])
    assert cfg.frame_size == 16 and cfg.dim_model == 32
    assert CS.count_test_clips("mnist", tiny_serving["folder"], cfg) == 6
    assert os.path.isfile(os.path.join(
        tiny_serving["ckpt_dir"], "cli_flagship_0_test", "state.pt"))


def test_real_batch_run_on_the_cpu(tiny_serving):
    t = CS.run_cli(tiny_serving, 6, 2, 4, False, 120, device="cpu",
                   extra_argv=PIXEL, counted=True)
    assert t["clips"] == 6 and t["batches"] == 3
    assert 0 < t["first_sync_s"] <= t["total_s"] < t["wall_s"]
    assert t["launches"]["launches"] == {"flash_attention": 0,
                                         "groupnorm_silu": 0}


def test_real_serve_run_on_the_cpu(tiny_serving):
    r = CS.run_serve_bench(tiny_serving, 2, 4, 3, 120, device="cpu",
                           extra_argv=PIXEL, counted=True)
    assert r["n_requests"] == 3 and len(r["request_latencies_s"]) == 3
    assert r["ttff_warm_server_s"] == r["request_latencies_s"][0]
    assert r["steady_fps"] > 0 and r["server_ready_wall_s"] > 0
    assert r["launches"]["launches"] == {"flash_attention": 0,
                                         "groupnorm_silu": 0}
    assert not os.path.exists(os.path.join(tiny_serving["cfg_dir"], "..",
                                           "serve.sock"))


def test_counted_runner_equals_in_process_count(tiny_serving):
    """The runner's counts of a predict run with the VAE codec (its encode
    and decode call both dispatchers) equal the dispatcher calls counted in
    this process around the same call, with every dispatch sent to the
    plain version; no launch on the CPU."""
    argv = ["--dataset", "mnist", "--folder", tiny_serving["folder"],
            "--config", CS.CONFIG_NAME, "--config_dir",
            tiny_serving["cfg_dir"], "--checkpoint_dir",
            tiny_serving["ckpt_dir"], "--codec", "vae", "--pred_frames", "1",
            "--batch_clips", "2", "--max_clips", "2", "--device", "cpu"]
    proc = subprocess.run([sys.executable, "-m", C.__name__, CS.PREDICT]
                          + argv, cwd=CS.REPO, env=CS.child_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    counts = C.parse(proc.stdout.splitlines())
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(2)
        with _kernels.force_reference(), _kernels.record_calls() as rec:
            P.main(argv)
    finally:
        torch.set_num_threads(threads)
    want = {}
    for (name, _), n in rec.calls.items():
        want[name] = want.get(name, 0) + n
    assert counts["calls"] == want
    assert want["groupnorm_silu"] > 0 and want["flash_attention"] > 0
    assert counts["launches"] == {"flash_attention": 0, "groupnorm_silu": 0}
    assert counts["bodies"] == {"flash_attention": {}, "groupnorm_silu": {}}


def test_counted_runner_passes_the_exit_code(tmp_path, monkeypatch,
                                           capsys):
    """``main``'s int is the exit code, after the COUNTED line; a child
    without the line is an error."""
    (tmp_path / "fake_cli.py").write_text(
        "def main(argv):\n    print('ran', argv)\n    return 3\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    assert C.main(["fake_cli", "--x", "1"]) == 3
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "ran ['--x', '1']"
    assert C.parse(lines) == {
        "launches": {"flash_attention": 0, "groupnorm_silu": 0},
        "bodies": {"flash_attention": {}, "groupnorm_silu": {}},
        "calls": {}}
    with pytest.raises(RuntimeError, match="COUNTED"):
        C.parse(["no such line"])


class _Parsed(Exception):
    pass


def parser_of(main, monkeypatch, argv=None):
    """The parser ``main`` builds: (option, default) of every flag, taken
    as it parses."""
    import argparse
    seen = {}

    def capture(self, args=None, namespace=None):
        seen.update({a.option_strings[0] if a.option_strings else a.dest:
                     a.default for a in self._actions
                     if a.dest != "help"})
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        main() if argv is None else main(argv)
    return seen


def test_flags_and_defaults_are_the_jax_tools(monkeypatch, jax_tool):
    """Every flag of the JAX tool with its default (the workdir under the
    temporary directory), and the port's own --dataset and --device."""
    theirs = parser_of(jax_tool.main, monkeypatch)
    mine = parser_of(CS.main, monkeypatch, [])
    assert mine.pop("--dataset") == "ball" and mine.pop("--device") is None
    assert os.path.basename(mine.pop("--workdir")) == os.path.basename(
        theirs.pop("--workdir"))
    assert mine == theirs
