"""Each cell driven end to end on the CPU at tiny widths (``tiny.py``):
sound runs come out correct, and each fault the cell can have, planted
in the program underneath the timed path, comes out not correct. The
run's harness is driven as it is on the card, without its look for one.

The tiny runs take the configuration in float32, where the port and the
reference agree to rounding, so the tiny limits sit far from both."""

from __future__ import annotations

import subprocess
import sys

import pytest

from benchmark import control, harness
from benchmark.tests import tiny

SERVING = ("sd14_refine_b8", "sd14_refine_b1_serve")
LIMITS = {"encode_rel": 1e-3, "rollout_rel": 1e-3, "frames_rel": 2e-3,
          "loss1_rel": 1e-4, "loss_rel_3_steps": 1e-4,
          "grad1_gap_clip_leaves": 1e-4,
          "update_norm_gap": 1e-2}


def _run(cell, seconds=0.5):
    if cell == "train_b6_four_ranks":
        return tiny.four_ranks(_run("train_b6", seconds))
    r = tiny.run(cell, seconds=seconds, limits={
        k: LIMITS[k] for k in harness.load_run(cell, 0, 0, False, 0)
        .cell["limits"]})
    r.config["precision"] = "f32"
    return r


@pytest.mark.parametrize("cell", [*SERVING, "train_b6",
                                  "train_b6_four_ranks"])
def test_a_sound_run_is_correct(cell):
    r = tiny.drive(_run(cell))
    assert r.correct, r.checks
    assert r.attempted >= 1 and r.failed == 0
    assert r.setup_s > 0
    (name,) = [n for n in harness.e2e_of(r.name) if n != "setup_s"]
    assert r.e2e[name] > 0


@pytest.mark.parametrize("cell", SERVING)
def test_a_latent_altered_where_it_is_produced_fails(cell, monkeypatch):
    from sd_video_gen_tpu_torch.ops import rollout
    produce = rollout._predict_next
    monkeypatch.setattr(rollout, "_predict_next",
                        lambda *a: produce(*a) + 0.05)
    r = tiny.drive(_run(cell))
    assert not r.correct
    assert r.checks["rollout_rel"][0] > LIMITS["rollout_rel"]


@pytest.mark.parametrize("cell", SERVING)
def test_a_frame_altered_where_it_is_produced_fails(cell, monkeypatch):
    from sd_video_gen_tpu_torch.diffusion import vae_codec
    decode = vae_codec.VAECodec.decode_latents

    def altered(self, latents):
        out = decode(self, latents).clone()
        out[:, :4] = 255 - out[:, :4]
        return out
    monkeypatch.setattr(vae_codec.VAECodec, "decode_latents", altered)
    r = tiny.drive(_run(cell))
    assert not r.correct


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    from sd_video_gen_tpu_torch.train import optim
    monkeypatch.setattr(optim.Adam, "update", lambda *a, **k: None)
    r = tiny.drive(_run("train_b6"))
    assert not r.correct
    assert r.checks["update_norm_gap"][0] == pytest.approx(1.0)


def test_a_step_on_half_the_batch_fails(monkeypatch):
    from sd_video_gen_tpu_torch.train import trainer
    forward = trainer._predictions_and_targets

    def half(model, latents, *a, **k):
        return forward(model, latents[: latents.shape[0] // 2], *a, **k)
    monkeypatch.setattr(trainer, "_predictions_and_targets", half)
    r = tiny.drive(_run("train_b6"))
    assert not r.correct
    assert (r.checks["grad1_gap_clip_leaves"][0]
            > LIMITS["grad1_gap_clip_leaves"])


def test_the_exchange_between_chips_left_out_fails(monkeypatch):
    from benchmark.tests import faults
    r = _run("train_b6_four_ranks")
    faults.plant("no_exchange", monkeypatch.setattr)
    driver = harness.driver("train")
    monkeypatch.setattr(driver, "WORKER", faults.worker("no_exchange"))
    driver.run(r)
    assert not r.correct
    assert (r.checks["grad1_gap_clip_leaves"][0]
            > LIMITS["grad1_gap_clip_leaves"])


def test_a_rank_that_holds_jax_gives_no_result(monkeypatch):
    r = _run("train_b6_four_ranks")
    driver = harness.driver("train")
    monkeypatch.setattr(driver, "WORKER", [sys.executable, "-c", (
        "import sys, types\n"
        "sys.modules['jax'] = types.ModuleType('jax')\n"
        "from benchmark.drivers import train\n"
        "sys.exit(train.main(sys.argv[1:]))\n")])
    with pytest.raises(RuntimeError, match=r"a rank failed: \[4, 4, 4\]"):
        driver.run(r)


@pytest.mark.parametrize("cell,fault", [("sd14_refine_b8", "fp8"),
                                        ("train_b6", "fp8"),
                                        ("train_b6", "half_batch")])
def test_the_control_fails_a_number(cell, fault):
    r = _run(cell)
    got = control.readings(r, fault)
    assert any(got[k] > lim for k, lim in r.cell["limits"].items()), got


def test_a_run_loads_neither_jax_nor_its_package():
    code = ("import sys, torch; torch.set_num_threads(2)\n"
            "from benchmark.tests import tiny\n"
            "from benchmark import harness\n"
            "r = tiny.drive(tiny.run('sd14_refine_b8'))\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.HERE.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_and_port_agree_in_float32():
    r = tiny.drive(_run("sd14_refine_b8"))
    assert r.checks["encode_rel"][0] < 1e-5
    assert r.checks["rollout_rel"][0] < 1e-5


@pytest.mark.parametrize("cell", [*SERVING, "train_b6"])
def test_a_traced_run_reads_its_trace_after_the_window(cell, monkeypatch):
    """Reading the profiler's events takes tens of seconds on the card;
    inside the window it could leave no request after the traced ones."""
    import time

    import torch

    from benchmark.drivers import predict_closed
    from benchmark.trace import Trace
    read_at = []

    class Stopped:
        def __init__(self, units):
            self.units = units

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def trace(self):
            read_at.append(time.perf_counter())
            return Trace([("k", 0, 1)], [], (0, 2), self.units)

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    r = _run(cell, seconds=3.0)
    r.traced = True
    r.traffic = dict(r.traffic, trace_units=1)
    driver = harness.driver(r.cell["driver"])
    for module in (predict_closed, driver):
        monkeypatch.setattr(module, "Tracer", Stopped, raising=False)
    driver.run(r)
    assert r.trace is not None and r.trace.units == 1
    assert len(read_at) == 1
    assert read_at[0] >= r.t_start + r.setup_s + r.seconds
