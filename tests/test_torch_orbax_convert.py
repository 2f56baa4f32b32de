"""``tools/convert_orbax_to_torch.py``: a JAX train state saved with Orbax
(one Adam step taken, so the moments and the step are not trivial),
converted, and restored by the port's trainer, gives the same state, the
same forward and the same next step as the JAX state. Both format versions:
a stamped v2 directory, and a v1 one (no stamp, no final stack norms),
which the JAX package's ``restore_checkpoint`` migrates.

Tolerances, f32 on both sides: the restored state equals the bridged JAX
state bit for bit; the forward rtol 1e-5 / atol 1e-6 (the port's f32
transformer bound); after the next step, the loss components rtol 1e-5, the
moments rel L2 1e-4 and every parameter within 2 lr of JAX's (an Adam step
moves each by at most about lr, the sign of a near-zero gradient may
differ: ``tests/test_torch_multiprocess.py``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from sd_video_gen_tpu.codecs import PixelCodec as JPixelCodec
from sd_video_gen_tpu.config import Config as JConfig
from sd_video_gen_tpu.models import (FrameTransformer as JFrameTransformer,
                                     FrameTransformerConfig as JFTConfig)
from sd_video_gen_tpu.ops import LossWeights as JLossWeights
from sd_video_gen_tpu.ops.masks import causal_mask as jcausal_mask
from sd_video_gen_tpu.train import checkpoint as jckpt
from sd_video_gen_tpu.train.trainer import make_train_step as jmake_train_step
from sd_video_gen_tpu_torch.config import Config
from sd_video_gen_tpu_torch.diffusion.weights import train_state_from_jax
from sd_video_gen_tpu_torch.ops.masks import causal_mask
from sd_video_gen_tpu_torch.train.trainer import Trainer
from tools import convert_orbax_to_torch as CV

CFG = dict(config_name="tiny", lr=1e-3, batch_size=2, frames_per_clip=5,
           frames_to_predict=2, frame_size=16, dim_model=32, num_heads=4,
           num_encoder_layers=1, num_decoder_layers=1, dropout_p=0.0,
           use_mse=True, use_gdl=True, use_contrastive=False)


def _frames(seed):
    return np.random.default_rng(seed).integers(
        0, 255, (2, 7, 16, 16, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX state after one step, and the JAX package's next step."""
    cfg = JConfig(**CFG)
    model = JFrameTransformer(JFTConfig.from_config(cfg))
    init_fn, step_fn = jmake_train_step(model, JPixelCodec(16),
                                        JLossWeights.from_config(cfg), cfg)
    step_fn = jax.jit(step_fn)
    state = jax.jit(init_fn)(jax.random.PRNGKey(0), jnp.asarray(_frames(0)))
    state, _ = step_fn(state, jnp.asarray(_frames(1)), jax.random.PRNGKey(1))
    nxt, comps = step_fn(state, jnp.asarray(_frames(2)),
                         jax.random.PRNGKey(2))
    return cfg, model, jax.device_get(state), jax.device_get(nxt), \
        {k: float(v) for k, v in comps.items()}


@pytest.mark.parametrize("version", [2, 1])
def test_converted_state_gives_the_same_forward_and_next_step(
        jax_run, tmp_path, version):
    cfg, model, state, nxt, comps = jax_run
    src = str(tmp_path / "jax_ck")
    if version == 2:
        jckpt.save_checkpoint(src, state)
    else:
        with ocp.StandardCheckpointer() as c:     # the v1 on-disk format
            c.save(src, state.replace(params=jckpt._strip(state.params),
                                      opt_state=jckpt._strip(
                                          state.opt_state)), force=True)
    assert jckpt.read_format_version(src) == version
    dst = str(tmp_path / "port" / "tiny_0_test")
    if version == 1:
        with pytest.warns(UserWarning, match="format v1"):
            CV.convert(src, dst, cfg)
        # what the migration restores: identity norms, fresh moments
        state = jckpt.restore_checkpoint(src, jckpt.abstract_like(state))
    else:
        CV.convert(src, dst, cfg)
    trainer = Trainer(Config(**CFG), mode="ar", codec_kind="pixel",
                      device="cpu", use_wandb=False,
                      checkpoint_dir=str(tmp_path / "port"),
                      log_dir=str(tmp_path / "logs"))
    trainer.init_state(seed=5)
    trainer.resume("tiny_0_test")
    got = trainer.state.state_dict()
    want = train_state_from_jax(state.params, state.opt_state,
                                int(state.step))
    assert got["step"] == want["step"] == 1
    for tree in ("params", "mu", "nu"):
        assert set(got[tree]) == set(want[tree])
        for k, v in want[tree].items():
            assert torch.equal(got[tree][k], v), (tree, k)
    # the forward
    lat = np.random.default_rng(3).standard_normal((2, 6, 16)) \
        .astype(np.float32)
    jout = model.apply(state.params, jnp.asarray(lat), jnp.asarray(lat[:, :-1]),
                       tgt_mask=jcausal_mask(5))
    trainer.model.eval()
    with torch.no_grad():
        pout = trainer.model(torch.from_numpy(lat),
                             torch.from_numpy(lat[:, :-1]),
                             tgt_mask=causal_mask(5))
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    if version == 1:
        return          # the next step of the migrated state is not nxt's
    # the next step
    trainer.state, pcomps = trainer._step_fn(trainer.state, _frames(2), 0)
    for k, v in comps.items():
        np.testing.assert_allclose(float(pcomps[k]), v, rtol=1e-5)
    after = train_state_from_jax(nxt.params, nxt.opt_state, int(nxt.step))
    got = trainer.state.state_dict()
    assert got["step"] == after["step"] == 2
    for tree in ("mu", "nu"):
        for k, w in after[tree].items():
            assert torch.linalg.vector_norm(got[tree][k] - w) <= \
                1e-4 * torch.linalg.vector_norm(w) + 1e-12, (tree, k)
    for k, w in after["params"].items():
        assert (got["params"][k] - w).abs().max() <= 2 * CFG["lr"], k


def test_the_cli_reads_the_config_and_writes_the_port_directory(
        jax_run, tmp_path, capsys):
    cfg, _, state, _, _ = jax_run
    (tmp_path / "cfg").mkdir()
    (tmp_path / "cfg" / "tiny.yml").write_text(
        "FRAMES_PER_CLIP: [5]\nFRAMES_TO_PREDICT: [2]\nFRAME_SIZE: 16\n"
        "DIM_MODEL: [32]\nNUM_HEADS: [4]\nNUM_ENCODER_LAYERS: [1]\n"
        "NUM_DECODER_LAYERS: [1]\n")
    src, dst = str(tmp_path / "jax_ck"), str(tmp_path / "port_ck")
    jckpt.save_checkpoint(src, state)
    CV.main(["--src", src, "--dst", dst, "--config", "tiny",
             "--config_dir", str(tmp_path / "cfg")])
    assert "format v2, step 1" in capsys.readouterr().out
    assert sorted(os.listdir(dst)) == ["sdvg_format.json", "state.pt"]
