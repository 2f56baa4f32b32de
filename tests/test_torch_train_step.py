"""The port's train / eval step, Adam and dropout against the JAX package on
the CPU: the same bridged state and the same uint8 batch through one JAX
step (optax Adam) and one port step (``train/optim.py``), dropout off (the
two frameworks' draws cannot be matched).

Tolerances, f32 (summation order only): loss components rtol 1e-5; ``mu`` and
``nu`` per tensor rel L2 1e-4. The gradient is read from ``mu`` after the
first step from zero moments: ``g = mu / (1 - b1)``. Parameters: Adam's first
updates are ``lr * g / (|g| + eps)``, so where ``|g|`` is at the rounding
noise (the attention key biases, whose gradient is zero in exact arithmetic)
a 1e-10 difference between the frameworks flips the update's sign: every
element is held to ``2 * lr`` per step, the bound of such a flip, and every
element whose first moment has stayed above 1e-5 at every step so far (the
update ``mu_hat / (sqrt(nu_hat) + eps)`` is then far from both the noise and
``eps``) to ``0.05 * lr`` per step.

bf16 and bf16_full (mode 'ar'): the two sides round at the same places but
XLA keeps excess precision inside fused bf16 arithmetic and sums in other
orders. Loss components rtol 5e-3; the gradient over all parameters rel L2
5e-2 (JAX's own bf16 gradient is 3.6e-2 to 4.0e-2 from its f32 gradient on
this model, measured; the port's is held to the same distance from the
port's f32 gradient); parameters ``2 * lr`` per step plus two bf16 ulps (2^-6 relative) per step
where the parameters are bf16. State dtypes are optax's: with bf16 parameters and
``mu_dtype=bf16`` both moments are bf16, else both are f32.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from sd_video_gen_tpu.codecs import PixelCodec as JPixelCodec
from sd_video_gen_tpu.config import Config as JConfig
from sd_video_gen_tpu.diffusion.vae_codec import VAECodec as JVAECodec
from sd_video_gen_tpu.models.transformer import (
    FrameTransformer as JFrameTransformer,
    FrameTransformerConfig as JFTConfig)
from sd_video_gen_tpu.models.vae import VAEConfig as JVAEConfig
from sd_video_gen_tpu.ops import LossWeights as JLossWeights
from sd_video_gen_tpu.ops.masks import causal_mask as jcausal_mask
from sd_video_gen_tpu.train.trainer import (TrainState as JTrainState,
                                            encode_or_passthrough as jencode,
                                            make_eval_step as jmake_eval,
                                            make_train_step as jmake_train)
from sd_video_gen_tpu_torch.codecs import PixelCodec
from sd_video_gen_tpu_torch.config import Config
from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
from sd_video_gen_tpu_torch.diffusion.weights import (bridge_state_dict,
                                                      train_state_from_jax)
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models import transformer as ptransformer
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.ops.losses import LossWeights
from sd_video_gen_tpu_torch.train.optim import Adam
from sd_video_gen_tpu_torch.train.trainer import (dropout_seed,
                                                  encode_or_passthrough,
                                                  make_eval_step,
                                                  make_train_step)
from torch_port_common import (TINY_VAE, np_tree, random_params, vae_pair)

LR, B1 = 1e-3, 0.9
K, CONTEXT, FRAME, LATENT, TEXT_DIM = 2, 3, 32, 64, 8
MODES = ("ar", "diff", "future", "learned_tgt", "text")
FT = dict(dim_model=32, num_heads=4, num_encoder_layers=1,
          num_decoder_layers=2, dim_feedforward=48, frames_to_predict=K,
          text_embed_dim=TEXT_DIM)
CFG = dict(lr=LR, batch_size=2, frames_per_clip=CONTEXT, frames_to_predict=K,
           frame_size=FRAME, dim_model=32, num_heads=4, num_encoder_layers=1,
           num_decoder_layers=2, dropout_p=0.0, use_mse=True, use_gdl=True,
           use_contrastive=True)
JDTYPES = {"f32": (jnp.float32, jnp.float32),
           "bf16": (jnp.bfloat16, jnp.float32),
           "bf16_full": (jnp.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads gain nothing and,
    with several test workers on one host, only contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model_mode(mode):
    return mode if mode in ("future", "learned_tgt", "text") else "ar"


def _frames(mode, size=FRAME, seed=0):
    n = CONTEXT + (K if mode in ("future", "learned_tgt") else 0)
    return np.random.default_rng(seed).integers(
        0, 256, (2, n, size, size, 3), dtype=np.uint8)


def _text(mode):
    if mode != "text":
        return None
    return np.random.default_rng(1).standard_normal(
        (2, TEXT_DIM)).astype(np.float32)


def _f32_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


class Pair:
    """One JAX step (compiled once, shared by the cases of this mode and
    precision) and the port's, over the same seeded parameters."""

    def __init__(self, mode, precision="f32", codec="pixel", dropout_p=0.0,
                 latent_dim=LATENT, frame=FRAME):
        self.mode, self.precision = mode, precision
        dtype, param_dtype = JDTYPES[precision]
        ft = dict(FT, latent_dim=latent_dim, mode=_model_mode(mode))
        self.jmodel = JFrameTransformer(JFTConfig(
            dropout_p=0.0, dtype=dtype, param_dtype=param_dtype, **ft))
        x = jnp.zeros((1, 3, latent_dim))
        masked = mode not in ("future", "learned_tgt")
        text = jnp.zeros((1, TEXT_DIM)) if mode == "text" else None
        self.params0 = np_tree(random_params(
            self.jmodel, 1, x, x, tgt_mask=jcausal_mask(3) if masked else None,
            text_embeds=text))
        self.param_dtype = param_dtype
        full = precision == "bf16_full"
        self.tx = optax.adam(LR, mu_dtype=jnp.bfloat16 if full else None)
        self.jcfg, self.cfg = JConfig(**CFG), Config(**CFG)
        if codec == "pixel":
            self.jcodec, self.codec = JPixelCodec(frame), PixelCodec(frame,
                                                                     "cpu")
        else:
            _, vparams, pvae = vae_pair(seed=3)
            self.jcodec = JVAECodec(frame, params=vparams,
                                    cfg=JVAEConfig(**TINY_VAE))
            self.codec = VAECodec(frame, pvae)
        _, self.jstep = jmake_train(self.jmodel, self.jcodec,
                                    JLossWeights.from_config(self.jcfg),
                                    self.jcfg, mode, tx=self.tx)
        self.pcfg = FrameTransformerConfig(
            dropout_p=dropout_p,
            compute_dtype=torch.bfloat16 if precision == "bf16" else None,
            **ft)
        self.mu_dtype = torch.bfloat16 if full else None

    def jax_state(self):
        # fresh arrays every time: the JAX step donates its state
        params = jax.tree.map(
            lambda a: jnp.array(a, dtype=self.param_dtype), self.params0)
        return JTrainState.create(apply_fn=self.jmodel.apply, params=params,
                                  tx=self.tx)

    def port(self, jstate=None):
        """(model, state, step_fn) of the port, its state bridged from
        ``jstate`` (default: the initial JAX state)."""
        jstate = jstate or self.jax_state()
        model = build(
            FrameTransformer, self.pcfg, "cpu",
            torch.bfloat16 if self.precision == "bf16_full"
            else torch.float32, trainable=True)
        init_fn, step_fn = make_train_step(
            model, self.codec, LossWeights.from_config(self.cfg), self.cfg,
            self.mode, mu_dtype=self.mu_dtype)
        state = init_fn()
        state.load_state_dict(train_state_from_jax(
            jstate.params, jstate.opt_state, int(jstate.step)))
        return model, state, step_fn

    def jax_step(self, jstate, frames, text):
        jstate, comps = self.jstep(
            jstate, jnp.asarray(frames), jax.random.PRNGKey(0),
            None if text is None else jnp.asarray(text))
        return jstate, {k: float(v) for k, v in comps.items()}


@functools.lru_cache(maxsize=None)
def pair(mode, precision="f32", codec="pixel"):
    if codec == "vae":
        return Pair(mode, precision, "vae", latent_dim=64, frame=8)
    return Pair(mode, precision)


def _bridged(jstate):
    adam = jstate.opt_state[0]
    return {name: bridge_state_dict("transformer", _f32_tree(tree))
            for name, tree in (("params", jstate.params), ("mu", adam.mu),
                               ("nu", adam.nu))}


def _port_trees(state):
    return {"params": state.params, "mu": state.opt_state["mu"],
            "nu": state.opt_state["nu"]}


def _np(t):
    return t.detach().float().numpy()


def _check_f32_state(jstate, state, steps, mu_floor):
    """``mu_floor``: the smallest |mu| of every element over the steps so
    far, by name (updated here)."""
    want, got = _bridged(jstate), _port_trees(state)
    assert int(jstate.step) == state.step == steps
    for tree in ("mu", "nu"):
        for k, w in want[tree].items():
            g = _np(got[tree][k])
            assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w) + 1e-12, \
                (tree, k)
    for k, w in want["params"].items():
        diff = np.abs(_np(got["params"][k]) - w)
        assert diff.max() <= 2.0 * LR * steps * 1.001, k
        mu_floor[k] = np.minimum(mu_floor.get(k, np.inf),
                                 np.abs(want["mu"][k]))
        settled = mu_floor[k] > 1e-5
        if settled.any():
            assert diff[settled].max() <= 0.05 * LR * steps, k


@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_jax_f32(mode):
    p = pair(mode)
    frames, text = _frames(mode), _text(mode)
    jstate = p.jax_state()
    _, state, step_fn = p.port(jstate)
    mu_floor = {}
    for step in (1, 2, 3):
        jstate, jcomps = p.jax_step(jstate, frames, text)
        state, comps = step_fn(state, frames, 0, text)
        assert set(comps) == set(jcomps) == {"mse", "gdl", "contrastive",
                                             "total"}
        for k, v in jcomps.items():
            assert comps[k].dtype == torch.float32 and comps[k].dim() == 0
            np.testing.assert_allclose(float(comps[k]), v, rtol=1e-5)
        _check_f32_state(jstate, state, step, mu_floor)
    assert all(t.dtype == torch.float32
               for tree in _port_trees(state).values() for t in tree.values())


@pytest.mark.parametrize("mode", MODES)
def test_gradients_match_jax_f32(mode):
    """The gradient of the first step, read from ``mu = (1 - b1) * g`` on the
    JAX side and taken by autograd directly on the port's: per tensor rel
    L2 1e-4. A parameter the forward does not use ('future' mode's
    ``learned_tgt``) has no gradient in the port and a zero one in JAX."""
    p = pair(mode)
    frames, text = _frames(mode), _text(mode)
    jstate, _ = p.jax_step(p.jax_state(), frames, text)
    want = {k: v / (1 - B1) for k, v in _bridged(jstate)["mu"].items()}
    model, state, _ = p.port()
    from sd_video_gen_tpu_torch.ops.losses import composite_loss
    from sd_video_gen_tpu_torch.train.trainer import _predictions_and_targets
    lat = encode_or_passthrough(p.codec, frames,
                                mode not in ("future", "learned_tgt"))
    pred, target = _predictions_and_targets(
        model, lat, K, mode, None, None if text is None else torch.tensor(text))
    total, _ = composite_loss(pred, target, LossWeights.from_config(p.cfg))
    names = list(state.params)
    grads = torch.autograd.grad(total, [state.params[n] for n in names],
                                allow_unused=True)
    unused = [n for n, g in zip(names, grads) if g is None]
    assert unused == (["learned_tgt"] if mode == "future" else [])
    for n, g in zip(names, grads):
        if g is None:
            assert not want[n].any()
            continue
        assert np.linalg.norm(_np(g) - want[n]) <= \
            1e-4 * np.linalg.norm(want[n]) + 1e-12, n


@pytest.mark.parametrize("mode", ["ar", "future"])
def test_eval_step_matches_jax(mode):
    p = pair(mode)
    frames, text = _frames(mode, seed=5), _text(mode)
    jeval = jmake_eval(p.jmodel, p.jcodec, JLossWeights.from_config(p.jcfg),
                       p.jcfg, mode)
    want = jeval(p.jax_state().params, jnp.asarray(frames))
    model, state, _ = p.port()
    eval_fn = make_eval_step(model, p.codec, LossWeights.from_config(p.cfg),
                             p.cfg, mode)
    got = eval_fn(frames, text)
    assert not model.training and set(got) == set(want)
    for k, v in want.items():
        assert not got[k].requires_grad
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5)


@pytest.mark.parametrize("precision", ["bf16", "bf16_full"])
def test_train_step_matches_jax_in_bf16(precision):
    p = pair("ar", precision)
    frames = _frames("ar")
    jstate = p.jax_state()
    _, state, step_fn = p.port(jstate)
    want_dtype = (torch.bfloat16 if precision == "bf16_full"
                  else torch.float32)
    jdtype = JDTYPES[precision][1]
    # the port's f32 gradient from the same (rounded) parameters
    f32_state = pair("ar").port(jstate)[1:]
    for step in (1, 2, 3):
        jstate, jcomps = p.jax_step(jstate, frames, None)
        state, comps = step_fn(state, frames, 0)
        for k, v in jcomps.items():
            assert comps[k].dtype == torch.float32
            np.testing.assert_allclose(float(comps[k]), v, rtol=5e-3)
        adam = jstate.opt_state[0]
        assert all(a.dtype == jdtype for tree in (jstate.params, adam.mu,
                                                  adam.nu)
                   for a in jax.tree.leaves(tree))
        assert all(t.dtype == want_dtype
                   for tree in _port_trees(state).values()
                   for t in tree.values())
        want, got = _bridged(jstate), _port_trees(state)
        if step == 1:
            f32_state[1](f32_state[0], frames, 0)
            keys = sorted(want["mu"])
            cat = lambda tree: np.concatenate(
                [np.asarray(_np(tree[k]) if torch.is_tensor(tree[k])
                            else tree[k]).ravel() for k in keys])
            g, jg = cat(got["mu"]), cat(want["mu"])
            g32 = cat(f32_state[0].opt_state["mu"])
            rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel(g, jg) <= 5e-2 and rel(g, g32) <= 5e-2
        for k, w in want["params"].items():
            diff = np.abs(_np(got["params"][k]) - w)
            ulp = (2.0 ** -6 * np.abs(w) * step if precision == "bf16_full"
                   else 0.0)
            # bf16 parameters: lr itself rounds to bf16 (1.0014e-3)
            assert (diff <= 2.0 * LR * step * 1.01 + ulp).all(), k


def test_latents_pass_through_with_only_the_sos():
    """A (B, T, L) f32 batch (a latent cache's) skips the codec: the JAX
    function's result on the same array, and a port step on the codec's
    latents equals the step on the frames bit for bit."""
    p = pair("ar")
    frames = _frames("ar")
    lat = p.codec.encode_frames(torch.from_numpy(frames)).numpy()
    for use_sos in (True, False):
        want = jencode(p.jcodec, jnp.asarray(lat), use_sos)
        got = encode_or_passthrough(p.codec, lat, use_sos)
        assert got.dtype == torch.float32 and not got.requires_grad
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    out = []
    for batch in (frames, lat):
        _, state, step_fn = p.port()
        state, comps = step_fn(state, batch, 0)
        out.append((comps, state))
    for k in out[0][0]:
        assert torch.equal(out[0][0][k], out[1][0][k])
    for k, v in out[0][1].params.items():
        assert torch.equal(v, out[1][1].params[k])


def test_vae_codec_step_matches_jax_and_the_codec_gets_no_gradient():
    p = pair("ar", codec="vae")
    frames = _frames("ar", size=8)
    vae = p.codec.model
    assert not any(q.requires_grad for q in vae.parameters())
    jstate = p.jax_state()
    _, state, step_fn = p.port(jstate)
    # even a codec left trainable by mistake stays out of the graph
    vae.requires_grad_(True)
    mu_floor = {}
    try:
        for step in (1, 2):
            jstate, jcomps = p.jax_step(jstate, frames, None)
            state, comps = step_fn(state, frames, 0)
            for k, v in jcomps.items():
                np.testing.assert_allclose(float(comps[k]), v, rtol=1e-5)
            _check_f32_state(jstate, state, step, mu_floor)
        assert all(q.grad is None for q in vae.parameters())
        lat = encode_or_passthrough(p.codec, frames, True)
        assert not lat.requires_grad and lat.grad_fn is None
    finally:
        vae.requires_grad_(False)


def test_train_state_from_jax_round_trip():
    """Parameters, both moments and the step of a JAX state after one step
    arrive under the port's names in the port's layouts (fused ``in_proj``
    rows included), bf16 leaves staying bf16; a port step from there equals
    a port step from the same state loaded tensor by tensor."""
    p = pair("ar")
    jstate, _ = p.jax_step(p.jax_state(), _frames("ar"), None)
    sd = train_state_from_jax(jstate.params, jstate.opt_state, jstate.step)
    assert sd["step"] == 1 and set(sd) == {"step", "params", "mu", "nu"}
    want = _bridged(jstate)
    model, state, step_fn = p.port(jstate)
    assert set(sd["params"]) == set(state.params)
    for tree in ("params", "mu", "nu"):
        for k, w in want[tree].items():
            np.testing.assert_array_equal(sd[tree][k].numpy(), w)
    D = 32
    fused = sd["mu"]["transformer.decoder.layers.0.multihead_attn."
                     "in_proj_weight"]
    cross = _f32_tree(jstate.opt_state[0].mu)["params"]["dec_0"]["cross_attn"]
    for i, name in enumerate("qkv"):
        np.testing.assert_array_equal(fused[i * D:(i + 1) * D].numpy(),
                                      cross[name]["kernel"].T)
    assert state.step == 1
    for tree, live in _port_trees(state).items():
        for k, v in live.items():
            assert torch.equal(v.detach(), sd[tree][k])
    full = pair("ar", "bf16_full")
    jfull, _ = full.jax_step(full.jax_state(), _frames("ar"), None)
    sdb = train_state_from_jax(jfull.params, jfull.opt_state, jfull.step)
    assert all(v.dtype == torch.bfloat16 for tree in ("params", "mu", "nu")
               for v in sdb[tree].values())
    with pytest.raises(ValueError, match="no Adam state"):
        train_state_from_jax(jstate.params, (), 0)


@pytest.mark.parametrize("dtype,mu_dtype", [
    (torch.float32, None), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
def test_adam_follows_optax(dtype, mu_dtype):
    """Three updates of one tensor against optax.adam on the same gradients,
    with optax's state dtypes. f32: 1e-6 of the terms of each sum. Where a
    moment or the parameter is bf16: two bf16 ulps (2^-6; one at a binade's
    lower edge) of the terms of its
    sum (``(1 - b) * g^n + b * moment``; ``p + update``): the two sides round
    the same sums, XLA with excess precision inside the fused update."""
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((64, 8)).astype(np.float32)
    grads = [rng.standard_normal((64, 8)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    lr, b1, b2 = 1e-2, 0.9, 0.999
    tx = optax.adam(lr, mu_dtype=jd.get(mu_dtype))
    jp = {"w": jnp.asarray(p0, jd[dtype])}
    jstate = tx.init(jp)
    opt = Adam(lr, mu_dtype=mu_dtype)
    params = {"w": torch.tensor(p0).to(dtype)}
    state = opt.init(params)
    assert state["mu"]["w"].dtype == (mu_dtype or dtype)
    assert state["nu"]["w"].dtype == dtype
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    eps_of = lambda dt: 2.0 ** -6 if dt == torch.bfloat16 else 1e-6
    for count, g in enumerate(grads, start=1):
        g = _np(torch.tensor(g).to(dtype))          # as both sides see it
        prev = {k: np.abs(f32(v["w"])) for k, v in
                (("p", jp), ("mu", jstate[0].mu), ("nu", jstate[0].nu))}
        updates, jstate = tx.update({"w": jnp.asarray(g, jd[dtype])}, jstate,
                                    jp)
        jp = optax.apply_updates(jp, updates)
        opt.update(params, {"w": torch.tensor(g).to(dtype)}, state, count)
        assert jstate[0].mu["w"].dtype == jd[mu_dtype or dtype]
        assert jstate[0].nu["w"].dtype == jd[dtype]
        terms = {"p": prev["p"] + lr,
                 "mu": (1 - b1) * np.abs(g) + b1 * prev["mu"],
                 "nu": (1 - b2) * g * g + b2 * prev["nu"]}
        for name, got, want, dt in (
                ("p", params["w"], jp["w"], dtype),
                ("mu", state["mu"]["w"], jstate[0].mu["w"],
                 mu_dtype or dtype),
                ("nu", state["nu"]["w"], jstate[0].nu["w"], dtype)):
            diff = np.abs(_np(got) - f32(want))
            bound = eps_of(dt) * terms[name]
            if name == "p" and (mu_dtype or dtype) == torch.bfloat16:
                bound = bound + 2.0 ** -6 * lr   # the bf16 moment's ulps
            assert (diff <= bound).all(), (count, name, diff.max())
    before = params["w"].clone()
    opt.update(params, {"w": None}, state, 4)      # no gradient: untouched
    assert torch.equal(params["w"], before)


# -- dropout ------------------------------------------------------------------

def _dropout_model(p, seed=0):
    cfg = FrameTransformerConfig(latent_dim=LATENT, dropout_p=p, mode="ar",
                                 **FT)
    return build(FrameTransformer, cfg, "cpu", seed=seed, trainable=True)


def test_eval_forward_is_bit_equal_to_the_module_without_dropout():
    with_drop, without = _dropout_model(0.1), _dropout_model(0.0)
    without.load_state_dict(with_drop.state_dict())
    x = torch.randn(2, 4, LATENT, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = with_drop.eval()(x, x[:, :-1])
        b = without.eval()(x, x[:, :-1])
        # dropout_p = 0 in train mode draws nothing and needs no generator
        c = without.train()(x, x[:, :-1])
    assert torch.equal(a, b) and torch.equal(a, c)


def test_dropout_zero_share_and_scaling():
    ctx = ptransformer._Ctx(torch.float32, 0.25,
                            torch.Generator().manual_seed(0))
    x = torch.full((400, 500), 3.0)
    y = ctx.drop(x)
    zero = (y == 0).float().mean().item()
    assert abs(zero - 0.25) < 0.005
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 3.0 / 0.75))
    off = ptransformer._Ctx(torch.float32, 0.25, None)
    assert off.drop(x) is x


def test_dropout_sits_in_the_jax_models_places(monkeypatch):
    """One draw per place of the JAX model (its lines 125, 141, 157-161,
    171-177, 201, 251-252): the two embedded inputs; per encoder layer the
    attention weights, the attention branch, the ReLU output, the FFN
    branch; per decoder layer both attentions' weights and branches, the
    ReLU output, the FFN branch."""
    model = _dropout_model(0.1)
    seen = []
    real = ptransformer._Ctx.drop
    monkeypatch.setattr(ptransformer._Ctx, "drop",
                        lambda self, x: (seen.append(tuple(x.shape)),
                                         real(self, x))[1])
    B, S, T, D, H, FF = 2, 4, 3, 32, 4, 48
    x = torch.randn(B, S, LATENT)
    model(x, x[:, :T], generator=torch.Generator().manual_seed(0))
    enc = [(B, H, S, S), (B, S, D), (B, S, FF), (B, S, D)]
    dec = [(B, H, T, T), (B, T, D), (B, H, T, S), (B, T, D), (B, T, FF),
           (B, T, D)]
    assert seen == [(B, S, D), (B, T, D)] + enc + dec + dec
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        model(x, x[:, :T])
    model.eval()
    seen.clear()
    model(x, x[:, :T])
    assert seen and all(s for s in seen)   # eval: drop() is handed None


def test_dropout_draws_follow_seed_and_step():
    """The same (seed, step number) gives the same draws whatever came
    before; another step or another seed gives others."""
    p = Pair("ar", dropout_p=0.5)
    frames = _frames("ar")

    def losses(seed, start_step, n=2):
        _, state, step_fn = p.port()
        state.step = start_step
        return [float(step_fn(state, frames, seed)[1]["total"])
                for _ in range(n)]

    a, b = losses(0, 0), losses(0, 0)
    assert a == b
    assert losses(0, 1, 1)[0] != a[0] and losses(1, 0, 1)[0] != a[0]
    assert dropout_seed(0, 1) != dropout_seed(1, 0)
    assert all(0 <= dropout_seed(s, t) < 2 ** 63
               for s in (0, 1, 2 ** 40) for t in (0, 7, 10 ** 9))


# -- the launchers' grad guard (its logic; the launchers themselves need a
# card: tests/test_torch_kernels.py) -----------------------------------------

def test_refuse_grad_raises_only_where_autograd_would_pass_through():
    x = torch.zeros(2, requires_grad=True)
    y = torch.zeros(2)
    with pytest.raises(RuntimeError, match="flash_attention.*no backward"):
        _kernels.refuse_grad("flash_attention", y, x, y)
    with pytest.raises(RuntimeError, match="groupnorm_silu"):
        _kernels.refuse_grad("groupnorm_silu", y, None, x)
    _kernels.refuse_grad("flash_attention", y, y, None)
    with torch.no_grad():
        _kernels.refuse_grad("flash_attention", x, x, x)
    with torch.inference_mode():
        _kernels.refuse_grad("flash_attention", x, x, x)
