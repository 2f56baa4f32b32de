"""Video-level quality gate for the DPM-Solver++ refiner tail
(``tools/dpmpp_quality_gate.py`` beside the JAX package, on the port).

Two phases, both in this process:

Phase A, self-consistent FVD: the FVD CLI (``evaluation.predict_fvd``) on
the ``ar`` model that ``tools/quality_modes`` trained under the same
``--scratch``, one protocol for every arm (random-init I3D, seeded SD
weights, the native-grid refiner):

    none     no refinement (context)
    ddim10   --denoise, DDIM from step 40 of 50: the parity tail
    dpmpp5   --denoise, DPM-Solver++(2M) in 5 UNet calls over that interval
    dpmpp4   the same in 4

  One-sided gate: each dpmpp arm's FVD and MSE are at most (1 + --fvd_tol)
  times DDIM-10's. A higher-order solver may beat the tail it replaces.

Phase B, drift at the pipeline's real shapes: the SD UNet and VAE in f32
at 512px (B x 4 x 64 x 64 latents, seeded weights), from one set of
latents and ONE handoff noise shared by every arm: the relative L2 of
dpmpp-5 / -4 against (a) a dpmpp-64 fine-step truth over the same
interval, (b) a DDIM-181 fine-step truth on the 1000-step grid (index 819
hands off at the same timestep, 180, as index 40 of 50: the parity tail's
own continuum, x0 clipping included), (c) DDIM-10 itself; and the pixel
drift from DDIM-10 after the VAE decode, in uint8 levels. Gate: each dpmpp
arm sits no further than 1.2x DDIM-10's distance from the dpmpp-64 truth.
The weights are random: the drift measures solver agreement on the real
compute graph, not perceptual quality.

``--dataset`` and ``--device`` are those of ``tools/quality_modes`` (a
machine without ``cv2`` runs ``--dataset mnist``).

    python -m sd_video_gen_tpu_torch.tools.dpmpp_quality_gate
        [--scratch DIR] [--fvd_tol 0.15] [--drift_batch 8] [--skip_fvd]
        [--skip_drift] [--dataset ball|mnist] [--device cpu]

Prints markdown and the drift keys, writes ``<scratch>/dpmpp_gate.json``
(Phase A's arms are cached in ``<scratch>/dpmpp_gate_arms.json`` and
reused under ``--skip_fvd``) and exits 1 if a gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

import numpy as np
import torch

from sd_video_gen_tpu_torch.config import strict_f32
from sd_video_gen_tpu_torch.models import default_device
from sd_video_gen_tpu_torch.tools import quality_modes

# Phase A: (arm, extra predict_fvd flags).
ARMS = [("none", []),
        ("ddim10", ["--denoise", "True", "--denoise_start_step", "40"]),
        ("dpmpp5", ["--denoise", "True", "--denoise_start_step", "40",
                    "--denoise_sampler", "dpmpp",
                    "--denoise_solver_steps", "5"]),
        ("dpmpp4", ["--denoise", "True", "--denoise_start_step", "40",
                    "--denoise_sampler", "dpmpp",
                    "--denoise_solver_steps", "4"])]
DPMPP_STEPS = (5, 4)
# Phase A's clips and clips a batch (the JAX tool's).
FVD_CLIPS, FVD_BATCH = 14, 7
# Phase B: the drift gate's factor, and the latent grid of 512px frames.
DRIFT_FACTOR = 1.2
DRIFT_LATENT_HW = 64


def run_fvd_arms(scratch: str, dataset: str, device=None) -> dict:
    """Phase A: every arm of ``ARMS`` through ``predict_fvd.main`` in the
    ``ar`` mode's directory; ``{arm: {"clips", "fvd", "mse"}}``."""
    from sd_video_gen_tpu_torch.evaluation import predict_fvd
    wd = os.path.join(scratch, "ar")
    if not os.path.isdir(os.path.join(wd, "checkpoints")):
        raise SystemExit(
            f"no trained ar model under {wd}: run tools/quality_modes "
            f"--modes ar first (this gate reuses its artifacts)")
    common = quality_modes.frames_flags(scratch, dataset) + [
        "--config", quality_modes.CONFIG, "--config_dir", "configs",
        "--train_mode", "ar", "--debug", "True", "--seed", "0",
        "--pred_frames", "4", "--max_clips", str(FVD_CLIPS),
        "--batch_clips", str(FVD_BATCH)]
    if device:
        common += ["--device", device]
    results = {}
    for name, extra in ARMS:
        log = os.path.join(wd, f"gate_{name}.log")
        open(log, "w").close()
        (fvd, mse), _ = quality_modes._in(wd, log, predict_fvd.main,
                                          common + extra)
        n, _, _ = quality_modes.parse_result(log)
        results[name] = {"clips": n, "fvd": fvd, "mse": mse}
        print(f"[{name}] FVD {fvd:.3f}  MSE {mse:.5f} ({n} clips)",
              flush=True)
    return results


def fvd_gate(fvd: dict, fvd_tol: float) -> tuple[dict, bool]:
    """Phase A's gate over the arms: ``({"gate_dpmpp5": ..., ...}, all
    passed)``. Signed and one-sided: only an arm WORSE than DDIM-10 by more
    than ``fvd_tol`` on FVD or MSE fails."""
    ref, out, ok = fvd["ddim10"], {}, True
    for k in DPMPP_STEPS:
        arm = fvd[f"dpmpp{k}"]
        d_fvd = (arm["fvd"] - ref["fvd"]) / ref["fvd"]
        d_mse = (arm["mse"] - ref["mse"]) / ref["mse"]
        passed = d_fvd <= fvd_tol and d_mse <= fvd_tol
        out[f"gate_dpmpp{k}"] = {"rel_fvd_gap": round(d_fvd, 4),
                                 "rel_mse_gap": round(d_mse, 4),
                                 "pass": passed}
        ok &= passed
    return out, ok


def drift_gate(drift: dict) -> bool:
    """Phase B's gate: each dpmpp tail at least nearly as close to the
    fine-step limit as the DDIM-10 tail it replaces."""
    return all(drift[f"err_dpmpp{k}_vs_truth"]
               <= drift["err_ddim10_vs_truth"] * DRIFT_FACTOR
               for k in DPMPP_STEPS)


def drift_pipeline(device):
    """The f32 SD pipeline of Phase B: SD-v1.4 widths, the seeded weights
    of the predict CLI (``predict.sd_modules`` without weight files)."""
    from sd_video_gen_tpu_torch.diffusion.sd import SDPipeline
    from sd_video_gen_tpu_torch.predict.predict import sd_modules
    files = types.SimpleNamespace(vae_weights=None, unet_weights=None,
                                  clip_weights=None)
    return SDPipeline(*sd_modules(files, device, torch.float32))


def drift_inputs(batch: int, device, latent_hw: int = DRIFT_LATENT_HW):
    """Phase B's latents, ``default_rng(0).standard_normal((batch, 4, hw,
    hw)) * 0.5``, and its one handoff noise, from a ``torch.Generator``
    seeded 0 on ``device``."""
    lat = np.random.default_rng(0).standard_normal(
        (batch, 4, latent_hw, latent_hw)) * 0.5
    g = torch.Generator(device=device).manual_seed(0)
    noise = torch.randn((batch, 4, latent_hw, latent_hw), generator=g,
                        device=device)
    return torch.as_tensor(lat, dtype=torch.float32, device=device), noise


def _l2(x) -> float:
    return float(np.sqrt((x.double().cpu().numpy() ** 2).sum()))


@torch.inference_mode()
def drift(pipe, latents, noise) -> dict:
    """Phase B's keys for one batch of ``latents`` (B, 4, h, w) and the
    handoff ``noise`` every arm shares: guidance 0, the empty-prompt
    embedding; the truths ``dpmpp`` in 64 UNet calls and DDIM over the
    1000-step grid from index 819; DDIM-10, dpmpp-5 and dpmpp-4 from index
    40 of 50; the pixel drift through the VAE decode of the raw latents, in
    uint8 levels (127.5 per unit of the decoder's [-1, 1] range)."""
    B = latents.shape[0]
    emb = pipe.uncond_embeddings(1)[:1].expand(2 * B, -1, -1)

    def run(sampler, k=None, start=40, n_steps=50):
        return pipe.i2i_scan(latents, emb, start, n_steps, noise=noise,
                             sampler=sampler, solver_steps=k)

    truth = run("dpmpp", 64)
    ddim10 = run("ddim")
    ddim_fine = run("ddim", None, 819, 1000)
    rel = lambda a, b: _l2(a - b) / _l2(b)
    out = {"err_ddim10_vs_truth": rel(ddim10, truth),
           "err_ddim10_vs_ddim_fine": rel(ddim10, ddim_fine),
           "family_gap_ddim_fine_vs_truth": rel(ddim_fine, truth)}
    img_ddim = pipe.vae.decode(ddim10).float()
    for k in DPMPP_STEPS:
        d = run("dpmpp", k)
        out[f"err_dpmpp{k}_vs_truth"] = rel(d, truth)
        out[f"err_dpmpp{k}_vs_ddim_fine"] = rel(d, ddim_fine)
        out[f"drift_dpmpp{k}_vs_ddim10"] = rel(d, ddim10)
        img = pipe.vae.decode(d).float()
        out[f"pixel_drift_dpmpp{k}_u8"] = float(
            (img - img_ddim).abs().double().mean()) * 127.5
    return out


def run_drift(batch: int, device) -> dict:
    """Phase B at 512px: ``drift`` of the f32 pipeline on ``batch`` clips."""
    pipe = drift_pipeline(device)
    return drift(pipe, *drift_inputs(batch, pipe.device))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scratch",
                    default=quality_modes.build_parser().get_default(
                        "scratch"),
                    help="tools/quality_modes' scratch dir to reuse")
    ap.add_argument("--fvd_tol", type=float, default=0.15,
                    help="max relative FVD/MSE gap dpmpp vs ddim")
    ap.add_argument("--drift_batch", type=int, default=8)
    ap.add_argument("--skip_fvd", action="store_true")
    ap.add_argument("--skip_drift", action="store_true")
    ap.add_argument("--dataset", default="ball", choices=("ball", "mnist"),
                    help="the data tools/quality_modes trained on")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def main(argv=None) -> int:
    strict_f32()
    args = build_parser().parse_args(argv)
    arms_cache = os.path.join(args.scratch, "dpmpp_gate_arms.json")
    report, ok, fvd = {}, True, None
    if not args.skip_fvd:
        fvd = run_fvd_arms(args.scratch, args.dataset, args.device)
        with open(arms_cache, "w") as f:
            json.dump(fvd, f, indent=1)
    elif os.path.exists(arms_cache):
        with open(arms_cache) as f:
            fvd = json.load(f)
        print(f"reusing Phase A arms from {arms_cache}")
    if fvd is not None:
        report["fvd_arms"] = fvd
        gates, ok = fvd_gate(fvd, args.fvd_tol)
        report.update(gates)
        print("\n| arm | FVD | pred MSE | rel FVD gap vs ddim10 (signed) |")
        print("|---|---|---|---|")
        for name, e in fvd.items():
            gap = ("—" if name in ("none", "ddim10") else
                   f"{report[f'gate_{name}']['rel_fvd_gap']:+.3f}")
            print(f"| {name} | {e['fvd']:.3f} | {e['mse']:.5f} | {gap} |")

    if not args.skip_drift:
        d = run_drift(args.drift_batch, default_device(args.device))
        report["drift_512px"] = {k: round(v, 5) for k, v in d.items()}
        ok &= drift_gate(d)
        print("\ndrift @512px (random-init weights, f32):")
        for k, v in d.items():
            print(f"  {k}: {v:.5f}")

    report["pass"] = ok
    os.makedirs(args.scratch, exist_ok=True)   # a drift-only run needs no
    # trained artifacts, so the scratch dir may not exist yet
    out = os.path.join(args.scratch, "dpmpp_gate.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"\nwrote {out}  pass={ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
