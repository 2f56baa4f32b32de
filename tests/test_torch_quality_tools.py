"""The port's quality tools (``sd_video_gen_tpu_torch/tools``:
``quality_modes``, ``dpmpp_quality_gate``, ``synthetic_checkpoint``) against
the JAX package's (``tools/quality_modes.py``, ``tools/dpmpp_quality_gate.py``,
``tools/synthetic_checkpoint.py``) on the CPU.

Tolerances: the UCF tree, the split lists, the config, the gate reports and
the synthetic weights are equal exactly. ``drift`` at tiny widths against
the same sequence of JAX ``i2i_scan`` calls and VAE decodes (bridged weights,
JAX's latents and handoff noise): every relative-L2 key within 1e-3
absolute, each pixel drift within 0.05 of a uint8 level (measured: 1.0e-7
and 5.7e-6; 264 UNet calls in f32 on both sides, summed in other orders).
"""

import filecmp
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sd_video_gen_tpu.config import load_config as jload_config
from sd_video_gen_tpu.diffusion.schedulers import DDIMSchedule as JDDIM
from sd_video_gen_tpu_torch.config import load_config
from sd_video_gen_tpu_torch.diffusion.schedulers import DDIMSchedule
from sd_video_gen_tpu_torch.tools import dpmpp_quality_gate as G
from sd_video_gen_tpu_torch.tools import quality_modes as Q
from sd_video_gen_tpu_torch.tools import synthetic_checkpoint as S
from tools import dpmpp_quality_gate as JG
from tools import quality_modes as JQ
from tools import synthetic_checkpoint as JS
from torch_port_common import nchw, sd_pair

DRIFT_ATOL, PIXEL_DRIFT_ATOL = 1e-3, 0.05
TINY = dict(DIM_MODEL=[32], NUM_HEADS=[2], NUM_ENCODER_LAYERS=[1],
            NUM_DECODER_LAYERS=[1])


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads gain little and,
    with several test workers on one host, only contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_make_ucf_tree_writes_the_jax_tools_bytes(tmp_path):
    pytest.importorskip("cv2")
    want = JQ.make_ucf_tree(str(tmp_path / "jax"))
    got = Q.make_ucf_tree(str(tmp_path / "port"))
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want]
    files = _tree(tmp_path / "jax")
    assert files == _tree(tmp_path / "port") and len(files) == 18
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax", tmp_path / "port", files, shallow=False)
    assert (mismatch, errors) == ([], [])


def test_ball_config_is_the_jax_tools(tmp_path):
    """The port's config file, read by the port, is the Config the JAX
    package reads from the JAX tool's YAML."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "q5.yml").write_text(JQ.BALL_CFG.format(epochs=7))
    Q.write_config(str(tmp_path / "q5.yml"), dict(Q.BALL_CFG, EPOCHS=[7]))
    want = vars(jload_config("q5", str(tmp_path / "jax")))
    assert vars(load_config("q5", str(tmp_path))) == want
    assert want["epochs"] == 7 and want["dim_model"] == 1024


def test_parse_result_reads_the_last_result_line(tmp_path):
    log = tmp_path / "run.log"
    log.write_text("[7 clips] FVD so far: 3.000\n"
                   "FVD (streaming, 7 clips): 4.250  pred MSE: 0.01000\n"
                   "FVD (batch, 14 clips): 12.125  pred MSE: 3.5e-02\n")
    assert Q.parse_result(str(log)) == JQ.parse_result(str(log)) \
        == (14, 12.125, 0.035)


def _arms(dpmpp5, dpmpp4):
    """Phase A's arms: DDIM-10 at FVD 10, MSE 0.1; each dpmpp arm given as
    (FVD, MSE)."""
    arm = lambda fvd, mse: {"clips": 6, "fvd": fvd, "mse": mse}
    return {"none": arm(6.0, 0.03), "ddim10": arm(10.0, 0.1),
            "dpmpp5": arm(*dpmpp5), "dpmpp4": arm(*dpmpp4)}


def _reports(tmp_path, monkeypatch, argv, arms=None, drift=None):
    """Both tools' ``main`` on the same inputs: (exit code, dpmpp_gate.json)
    of each, Phase B replaced by ``drift``."""
    out = []
    for name, main, extra in (("jax", JG.main, []),
                              ("port", G.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        if arms is not None:
            (d / "dpmpp_gate_arms.json").write_text(json.dumps(arms))
        for mod in (JG, G):
            monkeypatch.setattr(mod, "run_drift", lambda *a: dict(drift))
        rc = main(["--scratch", str(d), *argv, *extra])
        out.append((rc, json.loads((d / "dpmpp_gate.json").read_text())))
    return out


@pytest.mark.parametrize("dpmpp5,dpmpp4,passed", [
    ((11.49, 0.1149), (9.0, 0.09), True),
    ((11.51, 0.1), (9.0, 0.09), False),
    ((10.0, 0.1151), (9.0, 0.09), False),
    ((4.4, 0.037), (11.51, 0.1), False),
    ((4.4, 0.037), (4.5, 0.038), True)],
    ids=["both-14.9%-worse", "fvd-15.1%-worse", "mse-15.1%-worse",
         "dpmpp4-fvd-15.1%-worse", "better-than-ddim10"])
def test_fvd_gate_gives_the_jax_tools_report(tmp_path, monkeypatch, dpmpp5,
                                             dpmpp4, passed):
    arms = _arms(dpmpp5, dpmpp4)
    jax_side, port = _reports(tmp_path, monkeypatch,
                              ["--skip_fvd", "--skip_drift"], arms=arms)
    assert port == jax_side and port[0] == (0 if passed else 1)
    assert port[1]["pass"] is passed
    assert G.fvd_gate(arms, 0.15)[1] is passed


def _drift(ratio5, ratio4):
    d = {"err_ddim10_vs_truth": 0.3, "err_ddim10_vs_ddim_fine": 0.04,
         "family_gap_ddim_fine_vs_truth": 0.33}
    for k, r in ((5, ratio5), (4, ratio4)):
        d.update({f"err_dpmpp{k}_vs_truth": 0.3 * r,
                  f"err_dpmpp{k}_vs_ddim_fine": 0.41,
                  f"drift_dpmpp{k}_vs_ddim10": 0.39,
                  f"pixel_drift_dpmpp{k}_u8": 23.6})
    return d


@pytest.mark.parametrize("ratio5,ratio4,passed", [
    (1.19, 0.1, True), (1.21, 0.1, False), (0.1, 1.21, False),
    (0.09, 0.09, True)])
def test_drift_gate_gives_the_jax_tools_report(tmp_path, monkeypatch, ratio5,
                                               ratio4, passed):
    drift = _drift(ratio5, ratio4)
    jax_side, port = _reports(tmp_path, monkeypatch, ["--skip_fvd"],
                              drift=drift)
    assert port == jax_side and port[0] == (0 if passed else 1)
    assert G.drift_gate(drift) is passed


def test_handoff_timesteps_agree():
    """DDIM-1000's index 819 and DDIM-50's index 40 are one timestep, 180,
    in both packages: Phase B's two truths start from the same noise
    level."""
    t = {int(s(n).timesteps[i]) for s in (DDIMSchedule, JDDIM)
         for n, i in ((1000, 819), (50, 40))}
    assert t == {180}


def test_drift_matches_the_jax_tools_computation():
    """``drift`` at tiny widths (8x8 latents, B = 2) against the JAX tool's
    Phase B program on the same bridged weights, latents and noise."""
    jpipe, pipe = sd_pair(16)
    B, H = 2, 8
    lat = jnp.asarray(np.random.default_rng(0).standard_normal((B, H, H, 4))
                      * 0.5, jnp.float32)
    noise = jax.random.normal(jax.random.PRNGKey(0), lat.shape, lat.dtype)
    emb = jnp.concatenate([jnp.repeat(jpipe.uncond_embeddings(1)[:1], B, 0)]
                          * 2, 0)

    scan = jax.jit(lambda params, sampler, k, start, n_steps: jpipe.i2i_scan(
        params, lat, emb, guidance_scale=0.0, start_step=start,
        num_inference_steps=n_steps, noise_rng=jax.random.PRNGKey(0),
        sampler=sampler, solver_steps=k), static_argnums=(1, 2, 3, 4))

    def run_j(params, sampler, k=None, start=40, n_steps=50):
        return np.asarray(scan(params, sampler, k, start, n_steps))

    dec = jax.jit(lambda p, z: jpipe.vae.model.apply(
        p, z, method=type(jpipe.vae.model).decode))
    l2 = lambda a: float(np.sqrt((np.asarray(a, np.float64) ** 2).sum()))
    up, vp = jpipe.unet_params, jpipe.vae.params
    truth, ddim10 = run_j(up, "dpmpp", 64), run_j(up, "ddim")
    ddim_fine = run_j(up, "ddim", None, 819, 1000)
    want = {"err_ddim10_vs_truth": l2(ddim10 - truth) / l2(truth),
            "err_ddim10_vs_ddim_fine": l2(ddim10 - ddim_fine) / l2(ddim_fine),
            "family_gap_ddim_fine_vs_truth": l2(ddim_fine - truth) / l2(truth)}
    img_ddim = np.asarray(dec(vp, jnp.asarray(ddim10)))
    for k in (5, 4):
        d = run_j(up, "dpmpp", k)
        want[f"err_dpmpp{k}_vs_truth"] = l2(d - truth) / l2(truth)
        want[f"err_dpmpp{k}_vs_ddim_fine"] = l2(d - ddim_fine) / l2(ddim_fine)
        want[f"drift_dpmpp{k}_vs_ddim10"] = l2(d - ddim10) / l2(ddim10)
        want[f"pixel_drift_dpmpp{k}_u8"] = float(
            np.abs(np.asarray(dec(vp, jnp.asarray(d))) - img_ddim).mean()
            * 127.5)
    got = G.drift(pipe, nchw(lat), nchw(noise))
    assert list(got) == list(want)
    for key, v in want.items():
        tol = PIXEL_DRIFT_ATOL if key.startswith("pixel") else DRIFT_ATOL
        assert abs(got[key] - v) <= tol, (key, got[key], v)
    # the gate is decided, not a tie at this size
    assert got["err_dpmpp5_vs_truth"] < got["err_ddim10_vs_truth"] / 2


def test_drift_inputs_are_seeded():
    lat, noise = G.drift_inputs(2, "cpu", latent_hw=4)
    want = np.random.default_rng(0).standard_normal((2, 4, 4, 4)) * 0.5
    np.testing.assert_array_equal(lat.numpy(), want.astype(np.float32))
    torch.testing.assert_close(
        noise, torch.randn((2, 4, 4, 4),
                           generator=torch.Generator().manual_seed(0)),
        rtol=0, atol=0)


def _checkpoint(scratch, mode):
    return torch.load(os.path.join(scratch, mode, "checkpoints", "q5_0_test",
                                   "state.pt"), weights_only=True)["params"]


def test_quality_modes_end_to_end_on_the_ball_tree(tmp_path, monkeypatch,
                                                   capsys):
    """The JAX tool's protocol at tiny widths: ball tree, UCF tree, each
    mode trained and both arms scored, the table, the JSON (merged with an
    earlier run's), the exit code by the gate."""
    pytest.importorskip("cv2")
    for k, v in TINY.items():
        monkeypatch.setitem(Q.BALL_CFG, k, v)
    (tmp_path / "quality_modes.json").write_text('{"diff": {"pass": true}}')
    rc = Q.main(["--device", "cpu", "--modes", "ar,future,text", "--epochs",
                 "1", "--max_clips", "2", "--batch_clips", "2", "--scratch",
                 str(tmp_path)])
    res = json.loads((tmp_path / "quality_modes.json").read_text())
    assert list(res) == ["diff", "ar", "future", "text"]
    for mode in ("ar", "future", "text"):
        e = res[mode]
        assert e["pass"] is Q.gate(e)
        for arm in ("trained", "naive"):
            assert e[arm]["clips"] == 2 and np.isfinite(e[arm]["fvd"])
    assert rc == (0 if all(res[m]["pass"] for m in ("ar", "future", "text"))
                  else 1)
    out = capsys.readouterr().out
    assert "| mode | FVD trained | FVD naive |" in out
    assert out.count("| ar |") == out.count("| text |") == 1
    # the identity arm does not depend on the mode's training
    assert res["ar"]["naive"] == res["future"]["naive"]
    # future trains the same model with its k-step queries added, on the
    # k-step split (clips of 5 + 5 frames), so its weights are its own
    ar, fut = _checkpoint(tmp_path, "ar"), _checkpoint(tmp_path, "future")
    assert set(fut) - set(ar) == {"learned_tgt"} and set(ar) <= set(fut)
    assert all(ar[k].shape == fut[k].shape for k in ar)


def test_quality_modes_without_cv2(tmp_path, monkeypatch):
    """Where cv2 is missing, ``--dataset mnist`` runs the frame modes on
    the Moving-MNIST-layout stand-in, and ``text`` or ``--dataset ball``
    raises, naming cv2, before anything is trained."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    for k, v in TINY.items():
        monkeypatch.setitem(Q.BALL_CFG, k, v)
    argv = ["--device", "cpu", "--epochs", "1", "--max_clips", "2",
            "--batch_clips", "2", "--scratch", str(tmp_path)]
    for bad in (["--dataset", "mnist", "--modes", "ar,text"],
                ["--dataset", "ball", "--modes", "ar"]):
        with pytest.raises(RuntimeError, match="cv2"):
            Q.main(argv + bad)
    assert not os.path.exists(tmp_path / "ar")
    Q.main(argv + ["--dataset", "mnist", "--modes", "ar"])
    res = json.loads((tmp_path / "quality_modes.json").read_text())
    assert res["ar"]["trained"]["clips"] == 2
    disks = np.load(tmp_path / "mnist.npy")
    assert disks.shape == (30, 30, 64, 64) and disks.dtype == np.uint8
    assert (disks.reshape(30, 30, -1).max(-1) >= 100).all()  # a disk a frame


def test_synthetic_vae_is_the_jax_tools_bit_for_bit():
    want = JS.vae_state_dict("modern", np.float16, 0)
    got = S.vae_state_dict("modern", np.float16, 0)
    assert list(got) == list(want) and len(got) == 248
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


@pytest.mark.parametrize("dtype,seed", [(np.float16, 1), (np.float32, 3)])
def test_synthetic_unet_is_the_jax_tools_bit_for_bit(monkeypatch, dtype,
                                                     seed):
    """Every array at reduced widths (the width constants patched in both
    modules, the same code drawing them), and every name and shape at full
    width."""
    full = {k: v.shape for k, v in S.unet_state_dict().items()}
    assert full == {k: v.shape for k, v in JS.unet_state_dict().items()}
    assert sum(int(np.prod(s)) for s in full.values()) == \
        JS.PARAM_COUNTS["unet"]
    for mod in (S, JS):
        monkeypatch.setattr(mod, "UNET_BLOCK_OUT", (8, 16, 32, 32))
        monkeypatch.setattr(mod, "CROSS_DIM", 12)
        monkeypatch.setattr(mod, "TIME_DIM", 16)
    want = JS.unet_state_dict(dtype, seed)
    got = S.unet_state_dict(dtype, seed)
    assert list(got) == list(want) and len(got) == 686
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_synthetic_vae_names_both_vintages():
    for vintage in ("0.2.3", "modern"):
        got = {k: v.shape for k, v in S.vae_state_dict(vintage).items()}
        assert got == {k: v.shape
                       for k, v in JS.vae_state_dict(vintage).items()}
    with pytest.raises(ValueError):
        S.vae_state_dict("0.3")
