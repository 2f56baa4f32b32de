"""Tensor-parallel cases of the port, run by the worker processes of
``tests/test_torch_tensor_parallel.py`` in gloo groups of 2 and 4 on the CPU.
Imports torch and the port only: every input, whole weight and initial
state comes from the files the test writes under ``ROOT`` before it starts
the workers (``ref.pt``, the training data of ``tests/torch_dp_case.py``).

Worker: ``python -m tests.torch_tp_case RANK WORLD PORT ROOT OUT_DIR`` (from
the repository root). It joins the group with ``multihost.initialize``,
runs every case of ``CASES[WORLD]`` and writes its results to
``OUT_DIR/rank<RANK>.pt``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import os
import sys

import numpy as np
import torch

from tests import torch_dp_case as DP

# the JAX package's sharding-test widths (tests/test_diffusion_sharding.py)
UNET = dict(block_out_channels=(32, 64), layers_per_block=1,
            attention_heads=4, cross_attention_dim=32, norm_num_groups=8)
VAE = dict(block_out_channels=(32, 64), layers_per_block=1,
           norm_num_groups=8)
# the refiner's (tests/torch_port_common.py's TINY_*), and the predict CLI's
# SD modules at four levels so that the 512px refine keeps SD's 64x64 grid
TINY_VAE = dict(block_out_channels=(8, 16), layers_per_block=1,
                norm_num_groups=2)
TINY_UNET = dict(block_out_channels=(8, 16), layers_per_block=1,
                 attention_heads=2, cross_attention_dim=16, norm_num_groups=2)
TINY_CLIP = dict(vocab_size=49408, hidden_size=16, num_layers=1, num_heads=2,
                 intermediate_size=32, max_length=8)
CLI_VAE = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
               norm_num_groups=2)
CLI_UNET = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                attention_heads=2, cross_attention_dim=16, norm_num_groups=2)
REFINE = dict(frame_size=32, start_step=3, steps=4, hi_res=32)
RING_TOKENS = 8          # RING_MIN_TOKENS lowered, as the JAX test does
TRAIN_STEPS = DP.EPOCHS * 2
CASES = {2: ("forward:data=1,model=2", "attention:data=1,model=2",
             "refiner:data=1,model=2", "cli", "train:data=1,model=2",
             "dropout:data=1,model=2", "checkpoint:data=1,model=2"),
         4: ("forward:data=1,model=4", "forward:data=2,model=2",
             "attention:data=1,model=4", "train:data=2,model=2")}


def ref_path(root: str) -> str:
    return os.path.join(root, "ref.pt")


def init_checkpoint(root: str) -> str:
    """The one-process checkpoint of the training cases' initial state."""
    return os.path.join(root, "ck_init", "dp_0_test")


@contextlib.contextmanager
def tiny_sd():
    """The predict CLI's SD modules (``predict.sd_modules``) at the widths
    of ``CLI_VAE`` / ``CLI_UNET`` / ``TINY_CLIP`` instead of SD-v1.4's."""
    from sd_video_gen_tpu_torch.models import clip_text, unet, vae
    saved = (vae.VAEConfig, unet.UNetConfig, clip_text.CLIPTextConfig)
    vae.VAEConfig = functools.partial(saved[0], **CLI_VAE)
    unet.UNetConfig = functools.partial(saved[1], **CLI_UNET)
    clip_text.CLIPTextConfig = functools.partial(saved[2], **TINY_CLIP)
    try:
        yield
    finally:
        vae.VAEConfig, unet.UNetConfig, clip_text.CLIPTextConfig = saved


class StubI3D(torch.nn.Module):
    """A seeded stand-in for I3D: the clip's mean colour through one
    Linear to 400 logits (the CLI's statistics, not I3D, are under
    test)."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(5)
        self.w = torch.randn(3, 400, generator=g, dtype=torch.float64)

    def forward(self, x):                # (B, 3, T, 224, 224)
        return (x.double().mean(dim=(2, 3, 4)) @ self.w).float()


def stub_i3d(weights_path=None, device=None):
    return StubI3D()


def predict_argv(root: str, *extra) -> list:
    return ["--dataset", "ball", "--folder", root, "--config", "dp",
            "--config_dir", root, "--checkpoint_dir",
            os.path.dirname(init_checkpoint(root)), "--device", "cpu",
            *extra]


CLI_RUNS = {
    "predict_data2": ("--mesh", "data=2", "--pred_frames", "2",
                      "--max_clips", "6", "--batch_clips", "3",
                      "--save_output", "True"),
    "predict_tp_denoise": ("--mesh", "data=1,model=2", "--codec", "vae",
                           "--denoise", "True", "--denoise_precision", "f32",
                           "--denoise_start_step", "48",
                           "--pred_frames", "1", "--max_clips", "2",
                           "--batch_clips", "2", "--save_output", "True"),
    "fvd_data2": ("--mesh", "data=2", "--pred_frames", "4", "--max_clips",
                  "8", "--batch_clips", "2"),
    "fvd_trim": ("--mesh", "data=2", "--pred_frames", "4", "--max_clips",
                 "8", "--batch_clips", "3"),
}
MNIST = "mnist.npy"      # the FVD runs' clips: 9 frames long


def make_mnist(root: str) -> None:
    """A seeded Moving-MNIST-layout (T, N, 16, 16) ``.npy`` for the FVD
    runs."""
    rng = np.random.default_rng(9)
    np.save(os.path.join(root, MNIST),
            rng.integers(0, 256, (10, 20, 16, 16)).astype(np.uint8))


def run_cli(root: str, name: str, mesh: bool = True):
    """One CLI run of ``CLI_RUNS`` in the current directory (``mesh=False``:
    the same run in one process); returns the predicted latents of this
    rank's rows, the lines it printed and, for the FVD runs, FVD, MSE and
    the FeatureStats of every batch."""
    from sd_video_gen_tpu_torch.evaluation import predict_fvd as PPF
    from sd_video_gen_tpu_torch.predict import predict as P
    argv = list(CLI_RUNS[name])
    if not mesh:
        del argv[:2]
    if name.startswith("fvd"):
        argv += ["--dataset", "mnist", "--folder", os.path.join(root, MNIST)]
    latents, stats = [], []
    real_make, real_load, real_stats = (P.make_predict_fn, PPF.load_i3d,
                                        PPF.make_sharded_features)

    def make(*a, **kw):
        fn = real_make(*a, **kw)

        def run(*b, **kwb):
            out = fn(*b, **kwb)
            latents.append(out[1].clone())
            return out
        return run

    def sharded(features, layout):
        fn = real_stats(features, layout)

        def run(v):
            st = fn(v)
            stats.append(st)
            return st
        return run
    P.make_predict_fn, PPF.load_i3d = make, stub_i3d
    PPF.make_sharded_features = sharded
    printed = io.StringIO()
    try:
        with tiny_sd(), contextlib.redirect_stdout(printed):
            if name.startswith("fvd"):
                fvd, mse = PPF.main(predict_argv(root, *argv))
                return {"latents": latents, "fvd": fvd, "mse": mse,
                        "stats": [dataclasses.astuple(s)[1:] for s in stats],
                        "lines": printed.getvalue().splitlines()}
            P.main(predict_argv(root, *argv))
            return {"latents": latents,
                    "lines": printed.getvalue().splitlines()}
    finally:
        P.make_predict_fn, PPF.load_i3d = real_make, real_load
        PPF.make_sharded_features = real_stats


def _forward(ref: dict, layout) -> dict:
    """The UNet forward and the VAE encode / decode of ``ref`` on this data
    rank's rows, with this rank's shards."""
    from sd_video_gen_tpu_torch.models import shard_module
    from sd_video_gen_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from sd_video_gen_tpu_torch.ops import attention as A
    out = {}
    unet = UNet2DCondition(UNetConfig(**UNET))
    unet.load_state_dict(ref["unet"])
    unet = shard_module(unet.to(memory_format=torch.channels_last),
                        layout.shard)
    lo, hi = layout.rows(len(ref["z"]))
    with torch.no_grad():
        out["unet"] = unet(ref["z"][lo:hi], ref["t"][lo:hi],
                           ref["ctx"][lo:hi])
    vae = AutoencoderKL(VAEConfig(**VAE))
    vae.load_state_dict(ref["vae"])
    vae = shard_module(vae.to(memory_format=torch.channels_last),
                       layout.shard)
    for tokens in (A.RING_MIN_TOKENS, RING_TOKENS):
        A.RING_MIN_TOKENS = tokens
        for n in (layout.model, layout.model - 1):     # batch split; not
            A.TP_ROUTES.clear()
            x = ref["x"][:n]
            with torch.no_grad():
                mean, _ = vae.encode(x)
                dec = vae.decode(ref["x_latent"][:n])
            out["vae", tokens, n] = (mean, dec, dict(A.TP_ROUTES))
    A.RING_MIN_TOKENS = 256
    return out


def _attention(ref: dict, layout) -> dict:
    """``sharded_attention`` on this rank's feature slice of ``ref``'s
    q, k, v, by each route, gathered whole."""
    from sd_video_gen_tpu_torch.ops import attention as A
    from sd_video_gen_tpu_torch.parallel.constrain import gather_features
    shard, out = layout.shard, {}
    q, k, v = ref["attn"]
    c = q.shape[-1] // shard.size
    cut = lambda a: a[..., shard.rank * c:(shard.rank + 1) * c].contiguous()
    for how, n, tokens in (("batch", shard.size, 256), ("ring", 1, RING_TOKENS),
                           ("gather", 1, 256)):
        A.RING_MIN_TOKENS = tokens
        A.TP_ROUTES.clear()
        spied = []
        real = A._ring_attention

        def spy(*a):
            spied.append(tuple(a[0].shape))
            return real(*a)
        A._ring_attention = spy
        try:
            o = A.sharded_attention(cut(q[:n]), cut(k[:n]), cut(v[:n]),
                                    q.shape[-1] ** -0.5, shard)
        finally:
            A._ring_attention = real
        out[how] = (gather_features(o, shard), dict(A.TP_ROUTES), spied)
    A.RING_MIN_TOKENS = 256
    return out


def _refiner(ref: dict, layout):
    """The 32px round-trip refiner over the tiny SD modules split over the
    model group, with the JAX refiner's noise."""
    from sd_video_gen_tpu_torch.diffusion.refine import make_denoise_refiner
    from sd_video_gen_tpu_torch.diffusion.sd import SDPipeline
    from sd_video_gen_tpu_torch.models import shard_module
    from sd_video_gen_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                         CLIPTextEncoder)
    from sd_video_gen_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    mods = []
    for cls, cfg, sd in ((AutoencoderKL, VAEConfig(**TINY_VAE), "r_vae"),
                         (UNet2DCondition, UNetConfig(**TINY_UNET), "r_unet"),
                         (CLIPTextEncoder, CLIPTextConfig(**TINY_CLIP),
                          "r_clip")):
        m = cls(cfg)
        m.load_state_dict(ref[sd])
        m = m.to(memory_format=torch.channels_last).eval()
        mods.append(shard_module(m, layout.shard) if cls is not
                    CLIPTextEncoder else m)
    refine = make_denoise_refiner(
        SDPipeline(*mods), REFINE["frame_size"], REFINE["start_step"],
        REFINE["steps"], hi_res=REFINE["hi_res"],
        noise_fn=lambda step, shape: ref["r_noise"][step])
    with torch.no_grad():
        return refine(ref["r_flat"], 0)


def _trainer(root: str, workdir: str, mesh: str | None, dropout=0.0,
             state=None):
    from sd_video_gen_tpu_torch.config import load_config
    from sd_video_gen_tpu_torch.train.trainer import Trainer
    cfg = load_config("dp", root).replace(dropout_p=dropout)
    trainer = Trainer(cfg, argparse.Namespace(mesh=mesh, device="cpu"),
                      mode="ar", codec_kind="pixel", use_wandb=False,
                      checkpoint_dir=os.path.join(workdir, "ck"),
                      log_dir=os.path.join(workdir, "logs"))
    trainer.init_state(seed=0)
    trainer.resume(state or init_checkpoint(root))
    return trainer


def run_train(root: str, workdir: str, mesh: str | None, dropout=0.0) -> dict:
    """``DP.EPOCHS`` epochs of the ar pipeline case from the JAX initial
    state (restored from its one-process checkpoint), this rank's rows of
    every batch; the epochs' components, the whole final state (gathered),
    the smallest |mu| of every element, and this rank's own parameters."""
    trainer = _trainer(root, workdir, mesh, dropout)
    floor, step_fn = {}, trainer._step_fn

    def step(*args):
        state, comps = step_fn(*args)
        DP.lower_floor(floor, trainer.full_state()["mu"])
        return state, comps
    trainer._step_fn = step
    lay = trainer.layout
    shard = (lay.data_rank, lay.data) if lay.data > 1 else None
    train = DP.loader(root, "pipeline", "ar", "train", shard)
    val = DP.loader(root, "pipeline", "ar", "test", shard)
    out = {"train": [], "val": [], "mu_floor": floor}
    for _ in range(DP.EPOCHS):
        out["train"].append(trainer.train_loop(train))
        out["val"].append(trainer.validation_loop(val))
    whole = trainer.full_state()
    out.update({tree: {k: v.clone() for k, v in whole[tree].items()}
                for tree in ("params", "mu", "nu")})
    out["step"] = whole["step"]
    out["local"] = {k: v.detach().clone()
                    for k, v in trainer.state.params.items()}
    out["placements"] = trainer.placements
    out["trainer"] = trainer
    return out


def main(argv):
    rank, world, port = (int(a) for a in argv[:3])
    root, out_dir = argv[3:5]
    torch.set_num_threads(1)
    from sd_video_gen_tpu_torch.parallel import multihost
    from sd_video_gen_tpu_torch.parallel.mesh import make_layout
    multihost.initialize(f"127.0.0.1:{port}", world, rank, "cpu")
    ref = torch.load(ref_path(root), weights_only=False)
    work = os.path.join(out_dir, f"rank{rank}")
    os.makedirs(work)
    res = {}
    for case in CASES[world]:
        kind, _, mesh = case.partition(":")
        if kind == "cli":
            for name in CLI_RUNS:
                d = os.path.join(work, name)
                os.makedirs(d)
                with contextlib.chdir(d):
                    res[name] = run_cli(root, name)
            continue
        layout = make_layout(mesh)
        if kind == "forward":
            res[case] = _forward(ref, layout)
        elif kind == "attention":
            res[case] = _attention(ref, layout)
        elif kind == "refiner":
            res[case] = _refiner(ref, layout)
        elif kind in ("train", "dropout"):
            out = run_train(root, os.path.join(work, kind), mesh,
                            0.1 if kind == "dropout" else 0.0)
            out.pop("trainer")
            res[case] = out
        elif kind == "checkpoint":
            # train, save (every rank gathers, rank 0 writes) ...
            out = run_train(root, os.path.join(work, kind), mesh)
            path = out.pop("trainer").save("test")
            res[case] = {"path": path, "saved": out}
            # ... and restore the one-process checkpoint under the mesh
            back = _trainer(root, os.path.join(work, "restore"), mesh)
            res[case]["restored"] = back.full_state()
            res[case]["restored_local"] = {
                k: v.detach().clone() for k, v in back.state.params.items()}
    res["group"] = (multihost.process_index(), multihost.process_count(),
                    torch.distributed.get_backend())
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
