"""In-training FVD in the port's trainer (``Trainer.fvd_validation``,
``fit(fvd_every=...)``, ``--fvd_every``, ``--vae_weights``) against the JAX
package's ``Trainer.fvd_validation`` on bridged parameters (dropout 0) and
the same batches of 5-frame clips, which both tile to I3D's 9 frames.

The feature extractor is a stub with I3D's call signature on both sides
(mean over time and space, then one dense layer to 400 logits, the same
weights): the I3D itself is held against the JAX package in
``test_torch_i3d.py``, and a 224px I3D per protocol would dominate this
file's time. One CLI test runs the real (seeded) I3D.

Tolerance: FVD within 1e-3 relative (decoded frames are uint8: a
prediction on a rounding boundary may take the other level on one side).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sd_video_gen_tpu.config import Config as JConfig
from sd_video_gen_tpu.parallel import make_mesh
from sd_video_gen_tpu.train.trainer import Trainer as JTrainer
from sd_video_gen_tpu_torch.config import Config
from sd_video_gen_tpu_torch.data import (BatchLoader, BouncingBallDataset,
                                         generate_bouncing_ball_tree)
from sd_video_gen_tpu_torch.diffusion.weights import load_jax_params
from sd_video_gen_tpu_torch.train import trainer as T

FVD_RTOL = 1e-3
CFG = dict(config_name="fvdtiny", lr=1e-3, batch_size=2, epochs=1,
           frames_per_clip=5, frames_to_predict=2, frame_size=32,
           dim_model=32, num_heads=4, num_encoder_layers=1,
           num_decoder_layers=1, dropout_p=0.0, use_contrastive=False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads gain nothing and,
    with several test workers on one host, only contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StubI3D(torch.nn.Module):
    """(B, 3, T, H, W) -> (B, 400): mean over time and space, dense."""

    def __init__(self, kernel, bias):
        super().__init__()
        self.proj = torch.nn.Linear(3, 400)
        with torch.no_grad():
            self.proj.weight.copy_(torch.from_numpy(np.array(kernel).T))
            self.proj.bias.copy_(torch.from_numpy(np.array(bias)))

    def forward(self, x):
        return self.proj(x.mean(dim=(2, 3, 4)))


def _jax_stub():
    import flax.linen as nn

    class JStub(nn.Module):
        @nn.compact
        def __call__(self, videos):
            return nn.Dense(400)(videos.mean(axis=(1, 2, 3)))

    m = JStub()
    p = m.init(jax.random.PRNGKey(3), jnp.zeros((1, 9, 224, 224, 3)))
    d = p["params"]["Dense_0"]
    return m, p, StubI3D(d["kernel"], d["bias"])


@pytest.fixture
def tree(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return generate_bouncing_ball_tree(str(tmp_path / "d"), 2, 2, 10, 32,
                                       seed=0)


def _batches(root, n=2):
    ds = BouncingBallDataset(5, 1, root, "test")
    return list(BatchLoader(ds, 2, shuffle=False))[:n]


def _pair(tmp_path, mode="ar"):
    """The JAX trainer and the port's on the same parameters."""
    batches = _batches(str(tmp_path / "d"))
    jt = JTrainer(JConfig(**CFG), mode=mode,
                  mesh=make_mesh("data=1,model=1", devices=jax.devices()[:1]),
                  checkpoint_dir=str(tmp_path / "jck"), use_wandb=False,
                  num_classes=16)
    jt.init_state(batches[0][1], 0, jt._texts(batches[0][0]))
    pt = T.Trainer(Config(**CFG), mode=mode, device="cpu", use_wandb=False,
                   checkpoint_dir=str(tmp_path / "pck"), num_classes=16)
    pt.init_state(seed=5)
    load_jax_params(pt.model, "transformer",
                    jax.tree.map(np.asarray, jt.state.params))
    return jt, pt, batches


@pytest.mark.parametrize("mode,protocol", [("ar", "last_k"),
                                           ("ar", "reference"),
                                           ("diff", "reference")])
def test_fvd_validation_matches_jax(tree, tmp_path, mode, protocol):
    jt, pt, batches = _pair(tmp_path, mode)
    jstub, jp, stub = _jax_stub()
    want = jt.fvd_validation(batches, jstub, jp, protocol=protocol)
    got = pt.fvd_validation(batches, stub, protocol=protocol)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=FVD_RTOL)
    assert pt.model.training    # the train mode it had is restored


def test_text_mode_feeds_the_text_embeddings(tree, tmp_path):
    """The hook conditions a text model on its batch's classes."""
    pt = T.Trainer(Config(**CFG), mode="text", device="cpu",
                   use_wandb=False, checkpoint_dir=str(tmp_path / "ck"),
                   num_classes=16)
    pt.init_state(seed=0)
    stub = _jax_stub()[2]
    batches = [([i % 16 for i in range(len(f))], f)
               for _, f in _batches(str(tmp_path / "d"))]
    scores = {p: pt.fvd_validation(batches, stub, protocol=p)
              for p in ("last_k", "reference")}
    assert all(np.isfinite(v) for v in scores.values())
    assert scores["last_k"] != scores["reference"]
    with pytest.raises(ValueError, match="unknown fvd protocol"):
        pt.fvd_validation(batches, stub, protocol="other")


def test_fit_reports_an_fvd_score_on_the_gated_epochs(tree, tmp_path):
    pt = T.Trainer(Config(**CFG), device="cpu", use_wandb=False,
                   checkpoint_dir=str(tmp_path / "ck"))
    loader = BatchLoader(BouncingBallDataset(5, 1, tree, "train"), 2, seed=1)
    val = BatchLoader(BouncingBallDataset(5, 1, tree, "test"), 2, seed=1)
    stub = _jax_stub()[2]
    hist = pt.fit(loader, val, epochs=1, fvd_every=1, fvd_i3d=stub)
    assert np.isfinite(hist[0]["FVD score"])
    # epochs 1 and 4 of fvd_every=3 (the reference's epoch % n == 1 gate)
    hist = pt.fit(loader, val, epochs=4, fvd_every=3, fvd_i3d=stub)
    assert ["FVD score" in h for h in hist] == [True, False, False, True]


def test_latent_batches_are_refused(tree, tmp_path):
    pt = T.Trainer(Config(**CFG), device="cpu", use_wandb=False,
                   checkpoint_dir=str(tmp_path / "ck"))
    pt.init_state(seed=0)
    latents = np.zeros((2, 6, 64), np.float32)
    with pytest.raises(ValueError, match="--latent_cache cannot be combined"):
        pt.fvd_validation([([0, 1], latents)], _jax_stub()[2])


YAML = """LR: [0.001]
BATCH_SIZE: [2]
EPOCHS: [1]
EPOCH_RATIO: [0.2]
FRAMES_PER_CLIP: [3]
FRAMES_TO_PREDICT: [2]
FRAME_SIZE: 32
DIM_MODEL: [32]
NUM_HEADS: [4]
NUM_ENCODER_LAYERS: [1]
NUM_DECODER_LAYERS: [1]
DROPOUT_P: [0.0]
USE_CONTRASTIVE: [False]
"""


def test_the_cli_runs_fvd_every_and_vae_weights(tree, tmp_path):
    """``--codec vae --vae_weights`` (a full-size SD VAE file, fp16 on disk)
    and ``--fvd_every 1`` with the seeded I3D at 224px, on the CPU."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from synthetic_checkpoint import vae_state_dict
    sd = vae_state_dict("modern", np.float16, seed=0)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "vae.pt")
    (tmp_path / "cfgs").mkdir()
    (tmp_path / "cfgs" / "tiny.yml").write_text(YAML)
    argv = ["--dataset", "ball", "--folder", tree, "--config", "tiny",
            "--config_dir", str(tmp_path / "cfgs"), "--debug", "True",
            "--device", "cpu", "--codec", "vae", "--vae_weights",
            str(tmp_path / "vae.pt"), "--fvd_every", "1",
            "--fvd_protocol", "reference"]
    with pytest.warns(UserWarning, match="random init"):
        T.main(argv)
    with open(tmp_path / "logs" / "tiny_0.jsonl") as f:
        recs = [json.loads(line) for line in f]
    epoch = [r for r in recs if "epoch" in r][0]
    assert np.isfinite(epoch["FVD score"]) and np.isfinite(
        epoch["train_loss"])
    # the codec holds the file's weights
    tr = T.Trainer(Config(frame_size=32), device="cpu", use_wandb=False,
                   codec_kind="vae", checkpoint_dir=str(tmp_path / "ck2"),
                   vae=T_build_vae(str(tmp_path / "vae.pt")))
    w = tr.codec.model.decoder.mid_block.attentions[0].query.weight
    assert torch.equal(w, torch.from_numpy(
        sd["decoder.mid_block.attentions.0.to_q.weight"]).float())


def T_build_vae(path):
    from sd_video_gen_tpu_torch.diffusion.weights import build_from_file
    from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    return build_from_file(AutoencoderKL, VAEConfig(), "vae", path, "cpu")
