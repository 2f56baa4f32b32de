"""Tensor parallelism of the port against the JAX package on the CPU: the
port in gloo groups of 2 and 4 processes (``tests/torch_tp_case.py``, the
workers started once for the module, both groups at once), the JAX package
on the 8 forced CPU devices of ``tests/conftest.py`` with its own sharding
rules (``diffusion_param_shardings``, ``param_shardings``), its
head-sharded attention and its ring attention, at the widths of its own
sharding tests. Weights are bridged from JAX; inputs are numpy draws.

  (a) every parameter's placement (output features, input features or
      replicated) against JAX's PartitionSpec at model sizes 2 and 4,
      divisibility fallbacks included; biases and the GroupNorm after a
      split conv follow their layer (JAX stores them whole);
  (b) the UNet forward and the VAE encode and decode against JAX's sharded
      and unsharded forwards: f32, rel L2 1e-4 (the port's f32 forward
      bound);
  (c) the VAE's single-head attention takes the batch split where the
      batch divides the axis and the ring (RING_MIN_TOKENS lowered to 8, as
      JAX's test lowers it) where it does not, both seen to engage, both
      against JAX's ``_ring_attention`` and the plain attention: rel L2
      1e-5 (f32 attention, summation order only);
  (d) the tensor-parallel 32px round-trip refiner against the JAX
      package's (``test_denoise_refiner_tensor_parallel_matches``), its
      noise passed in: atol 1e-3 (JAX's own bound for the 4-step round
      trip);
  (e) ``predict.main --mesh`` (data=2, and data=1,model=2 with the 512px
      refiner over SD modules at small widths) and ``predict_fvd.main
      --mesh data=2`` (a seeded stand-in for I3D) against the same CLI in
      one process: predicted latents rel L2 1e-5, written frames within
      one level on at most 1% of pixels (uint8 round trips), the
      ``FeatureStats`` rtol 1e-12 (f64), FVD and MSE rtol 1e-9;
  (f) data=1,model=2 and data=2,model=2 training against the JAX trainer
      on the whole batch, from the same initial state, dropout 0: loss
      components rtol 1e-5, moments rel L2 1e-4, parameters within the
      training tests' bounds (``tests/test_torch_multiprocess.py``);
  (g) with dropout on, the replicated parameters are bit-equal across the
      model ranks;
  (h) a tensor-parallel checkpoint restores in one process, and a
      one-process checkpoint restores under the mesh, bit for bit.
"""
import argparse
import functools
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tests import torch_dp_case as DP
from tests import torch_tp_case as C
from torch_port_common import (TINY_CLIP, TINY_UNET, TINY_VAE, clip_pair,
                               np_tree, random_params, unet_pair, vae_pair)

from sd_video_gen_tpu.config import load_config as jload_config
from sd_video_gen_tpu.diffusion.refine import (make_denoise_refiner as
                                               jmake_refiner)
from sd_video_gen_tpu.diffusion.sd import SDPipeline as JSDPipeline
from sd_video_gen_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from sd_video_gen_tpu.models.transformer import (
    FrameTransformer as JFrameTransformer, FrameTransformerConfig as JFTConfig)
from sd_video_gen_tpu.models.unet import (UNet2DCondition as JUNet,
                                          UNetConfig as JUNetConfig)
from sd_video_gen_tpu.models.vae import (AutoencoderKL as JVAE,
                                         VAEConfig as JVAEConfig)
from sd_video_gen_tpu.ops import attention as JA
from sd_video_gen_tpu.parallel import (diffusion_param_shardings, make_mesh,
                                       param_shardings)
from sd_video_gen_tpu.train.trainer import Trainer as JTrainer
from sd_video_gen_tpu_torch.diffusion.weights import (bridge_state_dict,
                                                      train_state_from_jax)
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from sd_video_gen_tpu_torch.parallel import sharding
from sd_video_gen_tpu_torch.parallel.mesh import (Layout, ModelShard,
                                                  parse_mesh_spec)
from sd_video_gen_tpu_torch.train import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4


def rel(a, b) -> float:
    a, b = (torch.as_tensor(np.asarray(x, np.float64)) for x in (a, b))
    return float((a - b).norm() / b.norm())


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x).transpose(0, 3, 1, 2))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.float().permute(0, 2, 3, 1).numpy()


# -- (a) placements ------------------------------------------------------------

_FT = dict(latent_dim=16, dim_model=32, num_heads=4, num_encoder_layers=1,
           num_decoder_layers=2, dim_feedforward=48)
# widths where the divisibility fallback bites at size 4 (10 channels)
_FALLBACK_UNET = dict(block_out_channels=(8, 10), layers_per_block=1,
                      attention_heads=2, cross_attention_dim=16,
                      norm_num_groups=2)
_FALLBACK_VAE = dict(block_out_channels=(8, 10), layers_per_block=1,
                     norm_num_groups=2)


@functools.lru_cache(maxsize=None)
def _jax_shapes_of(kind, items):
    return _jax_shapes(kind, dict(items))


def _jax_shapes(kind, kw):
    if kind == "unet":
        m = JUNet(JUNetConfig(**kw))
        args = (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                jnp.zeros((1, 2, kw["cross_attention_dim"])))
    elif kind == "vae":
        m = JVAE(JVAEConfig(**kw))
        args = (jnp.zeros((1, 16, 16, 3)),)
    else:
        m = JFrameTransformer(JFTConfig(dropout_p=0.0, **kw))
        x = jnp.zeros((1, 3, kw["latent_dim"]))
        args = (x, x)
    return jax.eval_shape(m.init, jax.random.PRNGKey(0), *args)


def _jax_codes(kind, kw, size):
    """JAX's PartitionSpec of every kernel, through the bridge's name map:
    0 replicated, 1 output features, 2 input features."""
    shapes = _jax_shapes_of(kind, tuple(sorted(kw.items())))
    mesh = make_mesh(f"data={8 // size},model={size}")
    rules = (param_shardings(mesh, shapes) if kind == "transformer"
             else diffusion_param_shardings(mesh, shapes))

    def code(s, leaf):
        spec = tuple(s.spec) + (None,) * (leaf.ndim - len(s.spec))
        if "model" not in spec:
            c = 0
        else:
            c = 1 if spec.index("model") == leaf.ndim - 1 else 2
        return np.full(leaf.shape, c, np.int8)
    tree = jax.tree.map(code, rules, shapes)
    out = {}
    for k, v in bridge_state_dict(kind, tree).items():
        assert (v == v.flat[0]).all(), k      # fused parts agree
        out[k] = int(v.flat[0])
    return out


def _port_code(p) -> int:
    return 0 if p is None else 1 + p.dim


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("kind,kw", [
    ("unet", C.UNET), ("vae", C.VAE), ("transformer", _FT),
    ("unet", _FALLBACK_UNET), ("vae", _FALLBACK_VAE)],
    ids=["unet", "vae", "transformer", "unet_fallback", "vae_fallback"])
def test_placements_match_jax_partition_specs(kind, kw, size):
    """(a) Every kernel's placement is JAX's; a bias follows its layer's
    column split and is whole on a row split; a resnet's ``norm2`` follows
    its ``conv1``. The fallback widths have 10-channel layers, which stay
    whole at size 4 and split at size 2."""
    want = _jax_codes(kind, kw, size)
    cls, cfg = {"unet": (UNet2DCondition, UNetConfig),
                "vae": (AutoencoderKL, VAEConfig),
                "transformer": (FrameTransformer,
                                FrameTransformerConfig)}[kind]
    with torch.device("meta"):
        whole = cls(cfg(**kw)).state_dict()
    where = sharding.placements(kind, whole, size)
    assert set(where) == set(want)
    kernels = [k for k, v in whole.items() if v.dim() >= 2]
    for k in kernels:
        assert _port_code(where[k]) == want[k], k
    split = {k: where[k] for k in kernels if where[k] is not None}
    assert any(p.dim == 0 for p in split.values())
    assert any(p.dim == 1 for p in split.values())
    for k, v in whole.items():
        if v.dim() >= 2:
            continue
        layer = k.rsplit(".", 1)[0]
        owner = (layer.replace("norm2", "conv1") + ".weight"
                 if layer.endswith("norm2") and ".resnets." in layer
                 else k.replace("_bias", "_weight").replace(".bias",
                                                            ".weight"))
        if owner not in where:            # LayerNorm / GroupNorm: whole
            assert where[k] is None, k
            continue
        follows = where[owner] if (where[owner] is not None and
                                   where[owner].dim == 0) else None
        assert where[k] == follows, k
    if kw in (_FALLBACK_UNET, _FALLBACK_VAE):
        ruled = [k for k in kernels if any(re.search(pattern, k) for
                                           pattern, _ in sharding.RULES[kind])]
        assert any(where[k] is None for k in ruled) == (size == 4)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("kind", ["unet", "vae", "transformer"])
def test_sharded_modules_hold_their_slices(kind, size):
    """(a) A module built with a shard holds exactly ``shard_tensor``'s
    slice of every whole parameter, on every rank, and the slices put back
    together are the whole (``unshard_tensor``)."""
    cls, cfg, kw = {"unet": (UNet2DCondition, UNetConfig, C.UNET),
                    "vae": (AutoencoderKL, VAEConfig, C.VAE),
                    "transformer": (FrameTransformer, FrameTransformerConfig,
                                    _FT)}[kind]
    torch.manual_seed(0)
    whole = cls(cfg(**kw))
    sd = whole.state_dict()
    where = sharding.placements(kind, sd, size)
    parts = []
    for r in range(size):
        part = cls(cfg(**kw), shard=ModelShard(None, size, r))
        local = sharding.shard_state_dict(sd, where, r, size)
        part.load_state_dict(local, strict=True)     # shapes agree
        parts.append(local)
    for k, v in sd.items():
        assert torch.equal(sharding.unshard_tensor([p[k] for p in parts],
                                                   where[k]), v), k


def test_a_head_or_group_cut_across_ranks_raises():
    """Where a split would cut a head or a GroupNorm group (GSPMD would
    reshard; the port's per-rank modules cannot), building raises."""
    with pytest.raises(ValueError, match="attention of width 8: a model "
                       "axis of 4 does not divide its 2 heads"):
        UNet2DCondition(UNetConfig(**{**TINY_UNET, "norm_num_groups": 4}),
                        shard=ModelShard(None, 4, 0))
    with pytest.raises(ValueError, match="does not divide its 2 groups"):
        AutoencoderKL(VAEConfig(**TINY_VAE), shard=ModelShard(None, 4, 0))
    with pytest.raises(ValueError, match="does not divide its 3 heads"):
        FrameTransformer(FrameTransformerConfig(
            **{**_FT, "num_heads": 3, "dim_model": 36}),
            shard=ModelShard(None, 2, 0))


def test_layout_orders_ranks_as_the_jax_mesh():
    """Rank r is data rank r // model and model rank r % model (the JAX
    mesh's reshape of its device list); rows split contiguously, a ragged
    batch's first ranks one row more."""
    assert parse_mesh_spec("data=2,model=2", 4) == {"data": 2, "model": 2}
    devs = np.arange(8).reshape(2, 4)
    for r in range(8):
        lay = Layout(2, 4, r // 4, r % 4)
        assert devs[lay.data_rank, lay.model_rank] == r
    rows = [Layout(3, 1, d, 0).rows(7) for d in range(3)]
    assert rows == [(0, 3), (3, 5), (5, 7)]
    assert [Layout(2, 1, d, 0).rows(1) for d in range(2)] == [(0, 1), (1, 1)]


# -- the runs ----------------------------------------------------------------

def _jax_trainer(root, workdir):
    trainer = JTrainer(jload_config("dp", root), mode="ar",
                       codec_kind="pixel",
                       mesh=make_mesh("data=1,model=1", jax.devices()[:1]),
                       use_wandb=False,
                       checkpoint_dir=os.path.join(workdir, "jck"))
    trainer.logger.quiet = True
    trainer.init_state(np.zeros((DP.BATCH, 5, 16, 16, 3), np.uint8), seed=0)
    return trainer


def _bridged(state) -> dict:
    return train_state_from_jax(jax.device_get(state.params),
                                jax.device_get(state.opt_state),
                                int(state.step))


def _jax_train(trainer, root):
    """The ar pipeline case through the JAX trainer on the whole batch."""
    floor, step_fn = {}, trainer._step_fn

    def step(*args):
        state, comps = step_fn(*args)
        DP.lower_floor(floor, _bridged(state)["mu"])
        return state, comps
    trainer._step_fn = step
    out = {"train": [], "val": [], "mu_floor": floor}
    train = DP.loader(root, "pipeline", "ar", "train")
    val = DP.loader(root, "pipeline", "ar", "test")
    for _ in range(DP.EPOCHS):
        out["train"].append(trainer.train_loop(train, jax.random.PRNGKey(0)))
        out["val"].append(trainer.validation_loop(val))
    out.update(_bridged(trainer.state))
    return out


def _inputs(root) -> dict:
    """Every input and whole weight the workers read (``ref.pt``), and the
    JAX side's own copies."""
    rng = np.random.default_rng(0)
    jax_side = {}
    ref = {}
    for kind, kw, seed in (("unet", C.UNET, 1), ("vae", C.VAE, 2)):
        if kind == "unet":
            jm = JUNet(JUNetConfig(**kw))
            params = random_params(jm, seed, jnp.zeros((1, 8, 8, 4)),
                                   jnp.zeros((1,), jnp.int32),
                                   jnp.zeros((1, 2, 32)))
        else:
            jm = JVAE(JVAEConfig(**kw))
            params = random_params(jm, seed, jnp.zeros((1, 16, 16, 3)))
        jax_side[kind] = (jm, params)
        ref[kind] = {k: torch.from_numpy(np.array(v)) for k, v in
                     bridge_state_dict(kind, np_tree(params)).items()}
    z = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    ts = np.array([1, 3, 5, 7], np.int32)
    ctx = rng.standard_normal((4, 2, 32)).astype(np.float32)
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    xl = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    jax_side["inputs"] = (z, ts, ctx, x, xl)
    ref.update(z=nchw(z), t=torch.from_numpy(ts.astype(np.int64)),
               ctx=torch.from_numpy(ctx), x=nchw(x), x_latent=nchw(xl))
    qkv = rng.standard_normal((3, 4, 64, 16)).astype(np.float32)
    jax_side["attn"] = qkv
    ref["attn"] = tuple(torch.from_numpy(a) for a in qkv)
    # the refiner: the tiny SD modules of the port's other tests
    _, vparams, pvae = vae_pair(seed=20)
    _, uparams, punet = unet_pair(seed=21)
    _, cparams, pclip = clip_pair(seed=22)
    ref.update(r_vae=pvae.state_dict(), r_unet=punet.state_dict(),
               r_clip=pclip.state_dict())
    L = 4 * (C.REFINE["frame_size"] // 2) ** 2
    flat = rng.standard_normal((2, L)).astype(np.float32)
    h = C.REFINE["hi_res"] // 2
    key = jax.random.fold_in(jax.random.PRNGKey(C.REFINE["start_step"]), 0)
    ref["r_flat"] = torch.from_numpy(flat)
    ref["r_noise"] = {0: torch.from_numpy(np.array(
        jax.random.normal(key, (2, h, h, 4), jnp.float32)))}
    jax_side["refiner"] = (vparams, uparams, cparams, flat)
    return ref, jax_side


def _jax_refs(jax_side) -> dict:
    """JAX's unsharded and sharded forwards, ring attention and refiner:
    every program traced here in turn (the TP attention context and the
    ring's token bound are trace-time state), then compiled on threads at
    once (XLA's compiler releases the GIL), then run."""
    import concurrent.futures
    progs = {}

    def add(key, fn, *args):
        progs[key] = (jax.jit(fn).lower(*args), args)

    (ujm, up), (vjm, vp) = jax_side["unet"], jax_side["vae"]
    z, ts, ctx, x, xl = (jnp.asarray(a) for a in jax_side["inputs"])
    add("unet", ujm.apply, up, z, ts, ctx)
    for spec in ("data=1,model=2", "data=2,model=2"):
        mesh = make_mesh(spec, jax.devices()[:4 if "data=2" in spec else 2])
        sh = jax.device_put(up, diffusion_param_shardings(mesh, up))
        with JA.head_sharded_attention(mesh):
            add(("unet", spec), ujm.apply, sh,
                jax.device_put(z, NamedSharding(mesh, P("data"))), ts, ctx)
    enc = lambda p, x: vjm.apply(p, x, method=JVAE.encode)[0]
    dec = lambda p, z: vjm.apply(p, z, method=JVAE.decode)
    # every batch size the ports' runs take is a slice of these (the VAE
    # treats each sample alone)
    add("vae_enc", enc, vp, x)
    add("vae_dec", dec, vp, xl)
    # the JAX package's sharded VAE, its single head on the ring
    mesh = make_mesh("data=1,model=2", jax.devices()[:2])
    sh = jax.device_put(vp, diffusion_param_shardings(mesh, vp))
    saved = JA.RING_MIN_TOKENS
    JA.RING_MIN_TOKENS = C.RING_TOKENS
    try:
        with JA.head_sharded_attention(mesh):
            add("ring_enc", lambda p, x: enc(p, x), sh, x[:1])
            add("ring_dec", lambda p, z: dec(p, z), sh, xl[:1])
    finally:
        JA.RING_MIN_TOKENS = saved
    q, k, v = (jnp.asarray(a) for a in jax_side["attn"])
    scale = q.shape[-1] ** -0.5
    for size in (2, 4):
        mesh = make_mesh(f"data=1,model={size}", jax.devices()[:size])
        add(("ring", size), lambda q, k, v, mesh=mesh: JA._ring_attention(
            q, k, v, scale, mesh, "model"), q[:1], k[:1], v[:1])
    add("plain", lambda q, k, v: JA.reference_attention(q, k, v, scale),
        q, k, v)
    # the TP refiner composition of the JAX package's own test
    vparams, uparams, cparams, flat = jax_side["refiner"]
    pipe = JSDPipeline(frame_size=C.REFINE["hi_res"], vae_params=vparams,
                       unet_params=uparams, clip_params=cparams,
                       vae_cfg=JVAEConfig(**TINY_VAE),
                       unet_cfg=JUNetConfig(**TINY_UNET),
                       clip_cfg=JCLIPConfig(**TINY_CLIP))
    cfg = argparse.Namespace(frame_size=C.REFINE["frame_size"])
    apply, rp = jmake_refiner(cfg, C.REFINE["start_step"], pipeline=pipe,
                              num_inference_steps=C.REFINE["steps"],
                              hi_res=C.REFINE["hi_res"])
    flat = jnp.asarray(flat)
    add("refiner", apply, rp, flat)
    mesh = make_mesh("data=1,model=2", jax.devices()[:2])
    rp_s = jax.device_put(rp, diffusion_param_shardings(mesh, rp))
    with JA.head_sharded_attention(mesh):
        add("refiner_tp", lambda p, f: apply(p, f), rp_s, flat)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        compiled = dict(zip(progs, pool.map(lambda lw: lw.compile(),
                                            (lw for lw, _ in
                                             progs.values()))))
    out = {key: np.asarray(compiled[key](*args))
           for key, (_, args) in progs.items()}
    for n in (1, 2, 3, 4):
        out["vae", n] = (out["vae_enc"][:n], out["vae_dec"][:n])
    out["vae_ring"] = (out.pop("ring_enc"), out.pop("ring_dec"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, the JAX initial training state as a one-process
    checkpoint, and the workers of both groups; here meanwhile, the JAX
    references, the JAX trainer's run and the one-process CLI runs."""
    root = str(tmp_path_factory.mktemp("tp_data"))
    out = str(tmp_path_factory.mktemp("tp_out"))
    DP.make_data(root)
    C.make_mnist(root)
    jtrainer = _jax_trainer(root, out)
    ckpt.save_checkpoint(C.init_checkpoint(root), _bridged(jtrainer.state))
    ref, jax_side = _inputs(root)
    torch.save(ref, C.ref_path(root))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for world in (2, 4):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        os.makedirs(os.path.join(out, str(world)))
        procs[world] = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_tp_case", str(r), str(world),
             str(port), root, os.path.join(out, str(world))], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
    mp = pytest.MonkeyPatch()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    logs = {}
    try:
        mp.chdir(out)
        jref = _jax_refs(jax_side)
        jtrain = _jax_train(jtrainer, root)
        single = {}
        for name in (n for n in C.CLI_RUNS if n != "fvd_trim"):
            d = os.path.join(out, "single", name)
            os.makedirs(d)
            mp.chdir(d)
            single[name] = C.run_cli(root, name, mesh=False)
        for world, ps in procs.items():
            logs[world] = [p.communicate(timeout=300)[0] for p in ps]
    finally:
        torch.set_num_threads(n)
        mp.undo()
        for ps in procs.values():
            for p in ps:
                p.kill()
    for world, ps in procs.items():
        for p, log in zip(ps, logs[world]):
            assert p.returncode == 0, log[-4000:]
    ranks = {w: [torch.load(os.path.join(out, str(w), f"rank{r}.pt"),
                            weights_only=False) for r in range(w)]
             for w in (2, 4)}
    return dict(root=root, out=out, jref=jref, jtrain=jtrain, single=single,
                ranks=ranks)


# -- (b) (c) forwards and attention ---------------------------------------------

@pytest.mark.parametrize("world,spec", [(2, "data=1,model=2"),
                                        (4, "data=1,model=4"),
                                        (4, "data=2,model=2")])
def test_unet_forward_matches_jax(runs, world, spec):
    """(b) Each data rank's rows of the UNet forward against JAX's
    unsharded forward and, where JAX runs that mesh, its sharded one."""
    want = runs["jref"]["unet"]
    data, model = (int(a.split("=")[1]) for a in spec.split(","))
    for r, res in enumerate(runs["ranks"][world]):
        lo, hi = Layout(data, model, r // model, r % model).rows(4)
        got = nhwc(res[f"forward:{spec}"]["unet"])
        assert rel(got, want[lo:hi]) <= 1e-4
        if ("unet", spec) in runs["jref"]:
            assert rel(got, runs["jref"]["unet", spec][lo:hi]) <= 1e-4


@pytest.mark.parametrize("world", [2, 4])
def test_vae_encode_decode_matches_jax(runs, world):
    """(b) The VAE's encode and decode by every route, against JAX's
    unsharded forward; the size-2 ring against JAX's sharded ring too."""
    jref = runs["jref"]
    for res in runs["ranks"][world]:
        out = res[f"forward:data=1,model={world}"]
        for key, (mean, dec, _) in ((k, v) for k, v in out.items()
                                    if k[0] == "vae"):
            n = key[2]
            assert rel(nhwc(mean), jref["vae", n][0]) <= 1e-4
            assert rel(nhwc(dec), jref["vae", n][1]) <= 1e-4
            if world == 2 and key[1:] == (C.RING_TOKENS, 1):
                assert rel(nhwc(mean), jref["vae_ring"][0]) <= 1e-4
                assert rel(nhwc(dec), jref["vae_ring"][1]) <= 1e-4


@pytest.mark.parametrize("world", [2, 4])
def test_ring_and_batch_split_engage_and_match_jax(runs, world):
    """(c) The VAE's mid-block attention (one per encode and per decode)
    takes the batch split where the batch divides the axis, the ring where
    it does not and each rank has at least RING_MIN_TOKENS tokens, else
    the gathered features; the attention op by each route against JAX's
    ring and the plain attention."""
    jref = runs["jref"]
    for res in runs["ranks"][world]:
        out = res[f"forward:data=1,model={world}"]
        routes = {k[1:]: v[2] for k, v in out.items() if k[0] == "vae"}
        assert routes[256, world] == {"batch": 2}
        assert routes[256, world - 1] == {"gather": 2}
        assert routes[C.RING_TOKENS, world] == {"batch": 2}
        assert routes[C.RING_TOKENS, world - 1] == {"ring": 2}
        att = res[f"attention:data=1,model={world}"]
        for how, n in (("batch", world), ("ring", 1), ("gather", 1)):
            got, seen, spied = att[how]
            assert seen == {how: 1}
            assert spied == ([(1, 64 // world, 16)] if how == "ring" else [])
            assert rel(got, jref["plain"][:n]) <= 1e-5
        assert rel(att["ring"][0], jref["ring", world]) <= 1e-5


def test_tp_refiner_matches_jax(runs):
    """(d) The TP refiner on both ranks against the JAX package's refiner,
    the same noise: within 1e-3 of its unsharded result; and against its
    TP composition within 1e-3 plus that composition's own distance from
    its unsharded result on these inputs (a frame value on a uint8
    rounding boundary that GSPMD's summation order tips over moves the
    re-encoded latent by about 1e-3)."""
    jref = runs["jref"]
    own = np.abs(jref["refiner_tp"] - jref["refiner"]).max()
    for res in runs["ranks"][2]:
        got = res["refiner:data=1,model=2"].numpy()
        np.testing.assert_allclose(got, jref["refiner"], atol=1e-3)
        np.testing.assert_allclose(got, jref["refiner_tp"], atol=1e-3 + own)


# -- (e) the CLIs ---------------------------------------------------------------

def _frames(d) -> dict:
    import cv2
    root = os.path.join(d, "outputs")
    return {f"{c}/{f}": cv2.imread(os.path.join(root, c, f))
            for c in sorted(os.listdir(root))
            for f in sorted(os.listdir(os.path.join(root, c)))}


@pytest.mark.parametrize("name", ["predict_data2", "predict_tp_denoise"])
def test_predict_mesh_matches_one_process(runs, name):
    """(e) ``predict.main --mesh``: every rank's predicted latents are its
    rows of the one-process run's; rank 0 alone writes, every clip, the
    frames the one-process run writes."""
    one = runs["single"][name]["latents"]
    ranks = runs["ranks"][2]
    data = 2 if name == "predict_data2" else 1
    batches = [b.shape[0] for b in one]
    for r, res in enumerate(ranks):
        got = res[name]["latents"]
        lay = Layout(data, 2 // data, r // (2 // data), r % (2 // data))
        want = [b[slice(*lay.rows(len(b)))] for b in one]
        want = [w for w in want if len(w)]
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            assert rel(g, w) <= 1e-5
    single = _frames(os.path.join(runs["out"], "single", name))
    mesh = _frames(os.path.join(runs["out"], "2", "rank0", name))
    assert not os.path.exists(os.path.join(runs["out"], "2", "rank1", name,
                                           "outputs"))
    assert sorted(mesh) == sorted(single) and len(single) > sum(batches)
    for k, v in single.items():
        diff = np.abs(mesh[k].astype(int) - v.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, k


def test_fvd_mesh_matches_one_process(runs):
    """(e) ``predict_fvd.main --mesh data=2``: the FeatureStats of every
    batch (summed over the data axis) are the one-process run's, and so
    are FVD and MSE, on both ranks."""
    one = runs["single"]["fvd_data2"]
    for res in runs["ranks"][2]:
        got = res["fvd_data2"]
        assert len(got["stats"]) == len(one["stats"]) >= 2
        for g, w in zip(got["stats"], one["stats"]):
            for a, b in zip(g, w):
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
        np.testing.assert_allclose(got["fvd"], one["fvd"], rtol=1e-9)
        np.testing.assert_allclose(got["mse"], one["mse"], rtol=1e-9)


def test_fvd_mesh_trims_a_ragged_tail(runs):
    """(e) Under the mesh a batch of 3 clips on 2 data ranks is trimmed to
    2, with the JAX CLI's message, and a batch of 1 is skipped."""
    r0, r1 = (r["fvd_trim"] for r in runs["ranks"][2])
    assert "[mesh] trimming ragged tail batch 3 -> 2 (data axis 2)" in \
        r0["lines"]
    assert "[mesh] trimming ragged tail batch 1 -> 0 (data axis 2)" in \
        r0["lines"]
    assert r0["lines"][-1].startswith("FVD (streaming, 2 clips)")
    assert r1["lines"] == [] and r0["fvd"] == r1["fvd"]


# -- (f) (g) (h) training ---------------------------------------------------------

def _check_losses(got, want):
    for key in ("_train", "_val"):
        names = sorted(k for k in want[key[1:]][0] if k.endswith(key))
        assert names and names == sorted(k for k in got[key[1:]][0]
                                         if k.endswith(key))
        g = np.array([[m[k] for k in names] for m in got[key[1:]]])
        w = np.array([[m[k] for k in names] for m in want[key[1:]]])
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)


def _check_state(got, want, steps):
    for tree in ("mu", "nu"):
        for k, w in want[tree].items():
            assert torch.linalg.vector_norm(got[tree][k] - w) <= \
                1e-4 * torch.linalg.vector_norm(w) + 1e-12, (tree, k)
    for k, w in want["params"].items():
        diff = (got["params"][k] - w).abs()
        assert diff.max() <= 2 * LR * steps * 1.001, k
        settled = (want["mu_floor"][k] > 1e-5) & (got["mu_floor"][k] > 1e-5)
        if settled.any():
            assert diff[settled].max() <= 0.05 * LR * steps, k


@pytest.mark.parametrize("world,spec", [(2, "data=1,model=2"),
                                        (4, "data=2,model=2")])
def test_train_steps_match_jax_on_the_whole_batch(runs, world, spec):
    """(f) Every rank's epoch losses and gathered final state against the
    JAX trainer's on the whole global batch, from the same state."""
    want = runs["jtrain"]
    assert want["step"] == C.TRAIN_STEPS
    for res in runs["ranks"][world]:
        got = res[f"train:{spec}"]
        assert got["step"] == want["step"]
        _check_losses(got, want)
        _check_state(got, want, want["step"])


def test_dropout_keeps_replicated_parameters_equal_across_model_ranks(runs):
    """(g) With dropout on, the two model ranks end with bit-equal
    replicated parameters (the residual stream's masks are the same on
    both) and the run moved them."""
    a, b = (r["dropout:data=1,model=2"] for r in runs["ranks"][2])
    where = a["placements"]
    whole = [k for k, p in where.items() if p is None]
    assert whole and all(torch.equal(a["local"][k], b["local"][k])
                         for k in whole)
    split = [k for k, p in where.items() if p is not None]
    assert split and not any(torch.equal(a["local"][k], b["local"][k])
                             for k in split)
    drop0 = runs["ranks"][2][0]["train:data=1,model=2"]
    assert not torch.equal(a["params"]["out.weight"],
                           drop0["params"]["out.weight"])


def test_checkpoints_cross_between_the_mesh_and_one_process(runs, tmp_path):
    """(h) The mesh's checkpoint (gathered, rank 0 writes) is its whole
    state and restores in one process bit for bit; the one-process initial
    checkpoint restored under the mesh is that state, and each rank holds
    its slice of it."""
    from sd_video_gen_tpu_torch.config import load_config
    from sd_video_gen_tpu_torch.train.trainer import Trainer
    r0, r1 = (r["checkpoint:data=1,model=2"] for r in runs["ranks"][2])
    saved = torch.load(os.path.join(r0["path"], "state.pt"),
                       weights_only=True)
    assert saved["step"] == r0["saved"]["step"] == C.TRAIN_STEPS
    for tree in ("params", "mu", "nu"):
        for k, v in r0["saved"][tree].items():
            assert torch.equal(saved[tree][k], v), (tree, k)
    trainer = Trainer(load_config("dp", runs["root"]), mode="ar",
                      codec_kind="pixel", device="cpu", use_wandb=False,
                      checkpoint_dir=str(tmp_path), log_dir=str(tmp_path))
    trainer.init_state(seed=1)
    trainer.resume(r0["path"])
    got = trainer.state.state_dict()
    assert got["step"] == C.TRAIN_STEPS
    assert all(torch.equal(got[t][k], saved[t][k])
               for t in ("params", "mu", "nu") for k in saved[t])
    init = torch.load(os.path.join(C.init_checkpoint(runs["root"]),
                                   "state.pt"), weights_only=True)
    where = r0["saved"]["placements"]
    for rank, res in enumerate((r0, r1)):
        back = res["restored"]
        assert back["step"] == init["step"]
        assert all(torch.equal(back[t][k], init[t][k])
                   for t in ("params", "mu", "nu") for k in init[t])
        for k, v in res["restored_local"].items():
            assert torch.equal(v, sharding.shard_tensor(
                init["params"][k], where[k], rank, 2)), k


def test_workers_joined_gloo_groups(runs):
    for world in (2, 4):
        assert [r["group"] for r in runs["ranks"][world]] == [
            (r, world, "gloo") for r in range(world)]
