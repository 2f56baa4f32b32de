"""The training and evaluation side's compiled programs (``utils/jit.py``:
``step_impl``, ``eval_impl``, ``fvd_batch``, I3D ``features``, the latent
cache's ``encode``) on the CPU, through the stand-in for CUDA graphs
(``ReplayGraphs``, ``tests/torch_port_common.py``): its capture runs the
program and then puts back what a real capture leaves alone (the donated
state, the registered generators), its replay runs the program again.

Compiled against eager (``utils/jit.disable_jit``) in the port: equal bit
for bit (the same function on the same inputs), dropout on, in every mode
and precision; one graph serves every step; N calls are N steps.

Against the JAX package, dropout off: the compiled step within the
tolerances of ``tests/test_torch_train_step.py`` (f32: loss components
rtol 1e-5, moments rel L2 1e-4 per tensor, parameters ``2 * lr`` a step and
``0.05 * lr`` where the first moment has stayed above 1e-5; bf16 and
bf16_full: loss components rtol 5e-3 at equal parameters in every mode and
at every step, along the two runs' own paths ``BF16_PATH_RTOL`` a mode,
parameters ``2 * lr`` a step plus two bf16 ulps a step where they are
bf16).

The card's side (one compiled step with the kernels in its graph against
eager) is ``tests/test_torch_jit_cuda.py``.
"""

import socket
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_train_step as TS
from sd_video_gen_tpu_torch import bench as B
from sd_video_gen_tpu_torch.codecs import PixelCodec
from sd_video_gen_tpu_torch.config import Config
from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
from sd_video_gen_tpu_torch.evaluation import fvd as FVD
from sd_video_gen_tpu_torch.models import build
from sd_video_gen_tpu_torch.models.transformer import (FrameTransformer,
                                                       FrameTransformerConfig)
from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from sd_video_gen_tpu_torch.ops.losses import LossWeights
from sd_video_gen_tpu_torch.parallel import multihost
from sd_video_gen_tpu_torch.parallel.mesh import Layout
from sd_video_gen_tpu_torch.train import trainer as T
from sd_video_gen_tpu_torch.utils import jit as J
from sd_video_gen_tpu_torch.utils.preprocess import build_latent_cache
from test_torch_bench import TINY
from torch_port_common import TINY_VAE, ReplayGraphs

K, CONTEXT, FRAME, TEXT_DIM = 2, 3, 16, 8
MODES = ("ar", "future", "diff", "learned_tgt", "text")
PRECISIONS = ("f32", "bf16", "bf16_full")
FT = dict(dim_model=32, num_heads=4, num_encoder_layers=1,
          num_decoder_layers=2, dim_feedforward=48, frames_to_predict=K,
          text_embed_dim=TEXT_DIM, latent_dim=4 * (FRAME // 8) ** 2)
# bf16 loss components along each framework's own 3-step path, a mode:
# 1.5x the largest of bf16 and bf16_full, measured (eager, which the
# compiled step equals bit for bit): ar 3.35e-3, future 5.05e-3, diff
# 6.38e-3, text 5.32e-3, learned_tgt 3.69e-3. The cause is rounding both
# frameworks share, not the port: at equal parameters (a port step from
# JAX's state) every mode reads under 3.6e-3 at every step, held to the
# 5e-3 of test_torch_train_step.py below; the paths part because Adam's
# first updates are lr * sign(g) where |g| is bf16 rounding noise: after
# step 1, 264-1083 parameters sit over lr / 2 apart, with a median |g|
# 35-350x below the model's, and JAX's own bf16 step against its f32 one
# parts 335-5290 parameters so, its components then 1.8e-3 to 1.75e-2 from
# its f32 ones.
BF16_PATH_RTOL = {"ar": 5e-3, "future": 7.6e-3, "diff": 9.6e-3,
                  "text": 8e-3, "learned_tgt": 5.6e-3}
CFG = dict(lr=1e-3, batch_size=2, frames_per_clip=CONTEXT,
           frames_to_predict=K, frame_size=FRAME, dim_model=32, num_heads=4,
           num_encoder_layers=1, num_decoder_layers=2, dropout_p=0.2,
           use_mse=True, use_gdl=True, use_contrastive=True)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def graphs(monkeypatch):
    stand_in = ReplayGraphs()
    monkeypatch.setattr(J, "BACKEND", stand_in)
    return stand_in


def _frames(mode, seed=0, batch=2, frame=FRAME):
    n = CONTEXT + (K if mode in ("future", "learned_tgt") else 0)
    return np.random.default_rng(seed).integers(
        0, 256, (batch, n, frame, frame, 3), dtype=np.uint8)


def _text(mode, seed=1):
    if mode != "text":
        return None
    return np.random.default_rng(seed).standard_normal(
        (2, TEXT_DIM)).astype(np.float32)


def _step(mode, precision="f32", dropout_p=0.2):
    """(model, state, step_fn) of a small port model from a fixed seed."""
    model_mode = mode if mode in ("future", "learned_tgt", "text") else "ar"
    mc = FrameTransformerConfig(
        dropout_p=dropout_p, mode=model_mode,
        compute_dtype=torch.bfloat16 if precision == "bf16" else None, **FT)
    full = precision == "bf16_full"
    model = build(FrameTransformer, mc, "cpu",
                  torch.bfloat16 if full else torch.float32, seed=7,
                  trainable=True)
    cfg = Config(**dict(CFG, dropout_p=dropout_p))
    init_fn, step_fn = T.make_train_step(
        model, PixelCodec(FRAME, "cpu"), LossWeights.from_config(cfg), cfg,
        mode, mu_dtype=torch.bfloat16 if full else None)
    return model, init_fn(), step_fn


def _trees(state):
    return {"params": {k: v.detach() for k, v in state.params.items()},
            "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}


def _identities(state) -> list:
    """The state's tensors themselves (the graph's memory), in order."""
    return [id(v) for tree in (state.params, state.opt_state["mu"],
                               state.opt_state["nu"]) for v in tree.values()]


def _assert_same_state(a, b):
    assert a.step == b.step
    ta, tb = _trees(a), _trees(b)
    for tree in ("params", "mu", "nu"):
        for k, v in ta[tree].items():
            assert torch.equal(v, tb[tree][k]), (tree, k)


def _run(step_fn, state, mode, steps=3, seed=0):
    return [step_fn(state, _frames(mode, seed=s), seed, _text(mode, seed=s))[1]
            for s in range(steps)]


# -- the step ----------------------------------------------------------------

@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mode", MODES)
def test_compiled_steps_equal_eager_steps(graphs, mode, precision):
    """3 steps with dropout on, each on another batch: parameters, both
    moments, the step number and the loss components equal eager's bit for
    bit; one graph served them, captured once."""
    _, cs, compiled = _step(mode, precision)
    _, es, eager = _step(mode, precision)
    got = _run(compiled, cs, mode)
    with J.disable_jit():
        want = _run(eager, es, mode)
    assert compiled.impl.n_graphs == 1 and graphs.captures == 1
    assert cs.step == es.step == 3
    _assert_same_state(cs, es)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"mse", "gdl", "contrastive", "total"}
        for k in w:
            assert g[k].dtype == torch.float32 and torch.equal(g[k], w[k])


def test_the_compile_takes_no_extra_step(graphs):
    """The warm-up's step is undone (state and generator) and the first
    call replays the graph: after it the state is one eager step's, and its
    loss that step's. The stand-in's capture leaves the state and the
    generator as a real capture does."""
    _, cs, compiled = _step("ar")
    _, es, eager = _step("ar")
    a = compiled(cs, _frames("ar"), 0)[1]
    with J.disable_jit():
        b = eager(es, _frames("ar"), 0)[1]
    assert graphs.captures == 1 and compiled.impl.n_graphs == 1
    _assert_same_state(cs, es)
    assert all(torch.equal(a[k], b[k]) for k in b)
    (entry,) = compiled.impl._graphs.values()
    assert entry.graph.replays == 1 and J.COMPILES[-1]["name"] == "step_impl"


def test_one_graph_whatever_the_seed_and_step(graphs):
    """The seed and the step number are host state (the generator, the
    bias corrections), not keys: other seeds and steps replay one graph,
    and still draw what eager draws for them."""
    _, cs, compiled = _step("ar")
    _, es, eager = _step("ar")
    seeds = (0, 5, 5, 1 << 40)
    got = [compiled(cs, _frames("ar"), s)[1]["total"] for s in seeds]
    with J.disable_jit():
        want = [eager(es, _frames("ar"), s)[1]["total"] for s in seeds]
    assert compiled.impl.n_graphs == 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert len({float(w) for w in want}) == len(seeds)   # dropout differs


def test_another_batch_shape_is_another_graph(graphs):
    _, state, step_fn = _step("ar")
    step_fn(state, _frames("ar"), 0)
    step_fn(state, _frames("ar", batch=1), 0)
    step_fn(state, _frames("ar"), 0)
    assert step_fn.impl.n_graphs == 2 and state.step == 3


def test_a_restore_between_steps_is_seen_by_the_next_replay(graphs):
    """``load_state_dict`` copies into the graph's own tensors: the replay
    after it continues from the restored state exactly as eager does, and
    no tensor of the state is replaced."""
    _, cs, compiled = _step("diff")
    _, es, eager = _step("diff")
    with J.disable_jit():
        eager(es, _frames("diff"), 0)
        saved = {t: ({k: v.clone() for k, v in d.items()}
                     if isinstance(d, dict) else d)
                 for t, d in es.state_dict().items()}
        want = eager(es, _frames("diff", seed=9), 0)[1]
    ids = _identities(cs)
    _run(compiled, cs, "diff", steps=3)
    cs.load_state_dict(saved)
    got = compiled(cs, _frames("diff", seed=9), 0)[1]
    assert compiled.impl.n_graphs == 1
    assert ids == _identities(cs)
    _assert_same_state(cs, es)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_the_benchmarks_reset_keeps_the_graphs_tensors(graphs):
    """``Workload.reset`` (``TrainState.load_state_dict`` from the start
    state) copies in place: every request replays the one graph from the
    same state, and the losses repeat bit for bit."""
    wl = B.scenario_train(sizes=TINY, device="cpu")
    trainer = wl.keep["trainer"]
    assert wl.program is trainer._step_fn.impl
    ids = _identities(trainer.state)
    replies = []
    for _ in range(3):
        wl.reset()
        replies.append(wl.request())
    assert wl.program.n_graphs == 1 and graphs.captures == 1
    assert ids == _identities(trainer.state)
    assert replies[0].checksum == replies[1].checksum == replies[2].checksum
    with J.disable_jit():
        wl.reset()
        eager = wl.request()
    assert eager.checksum == replies[0].checksum


# -- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mode", MODES)
def test_the_compiled_step_matches_jax(graphs, mode, precision):
    """3 compiled steps against 3 JAX steps. In bf16 the loss components
    are held two ways each step: a port step from JAX's state (equal
    parameters, the forward's rounding alone) to the 5e-3 that
    ``test_torch_train_step.py`` measured, and the compiled step along
    the port's own path to ``BF16_PATH_RTOL`` (the paths part by rounding
    both frameworks share: see its comment)."""
    p = TS.pair(mode, precision)
    frames, text = TS._frames(mode), TS._text(mode)
    jstate = p.jax_state()
    _, state, step_fn = p.port(jstate)
    mu_floor = {}
    for step in (1, 2, 3):
        if precision != "f32":
            _, at_jax, step_at_jax = p.port(jstate)
            with J.disable_jit():
                equal = step_at_jax(at_jax, frames, 0, text)[1]
        jstate, jcomps = p.jax_step(jstate, frames, text)
        state, comps = step_fn(state, frames, 0, text)
        for k, v in jcomps.items():
            if precision == "f32":
                np.testing.assert_allclose(float(comps[k]), v, rtol=1e-5)
                continue
            np.testing.assert_allclose(float(equal[k]), v, rtol=5e-3)
            np.testing.assert_allclose(float(comps[k]), v,
                                       rtol=BF16_PATH_RTOL[mode])
        if precision == "f32":
            TS._check_f32_state(jstate, state, step, mu_floor)
            continue
        want, got = TS._bridged(jstate), TS._port_trees(state)
        for k, w in want["params"].items():
            diff = np.abs(TS._np(got["params"][k]) - w)
            ulp = (2.0 ** -6 * np.abs(w) * step if precision == "bf16_full"
                   else 0.0)
            assert (diff <= 2.0 * TS.LR * step * 1.01 + ulp).all(), k
    assert step_fn.impl.n_graphs == 1


# -- eval, FVD, I3D, the latent cache ----------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_compiled_eval_equals_eager(graphs, mode):
    model, _, _ = _step(mode)
    cfg = Config(**CFG)
    fn = T.make_eval_step(model, PixelCodec(FRAME, "cpu"),
                          LossWeights.from_config(cfg), cfg, mode)
    got = [fn(_frames(mode, seed=s), _text(mode, seed=s)) for s in (0, 1)]
    with J.disable_jit():
        want = [fn(_frames(mode, seed=s), _text(mode, seed=s))
                for s in (0, 1)]
    assert fn.impl.n_graphs == 1 and not model.training
    for g, w in zip(got, want):
        assert all(torch.equal(g[k], w[k]) for k in w)
    assert not torch.equal(got[0]["total"], got[1]["total"])


class StubI3D(torch.nn.Module):
    """(B, 3, T, H, W) -> (B, 400): mean over time and space, dense."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(3, 400)
        with torch.no_grad():
            g = torch.Generator().manual_seed(3)
            self.proj.weight.copy_(torch.randn(400, 3, generator=g))
            self.proj.bias.copy_(torch.randn(400, generator=g))

    def forward(self, x):
        return self.proj(x.mean(dim=(2, 3, 4)))


def _fvd_trainer(tmp_path, mode):
    tr = T.Trainer(Config(**dict(CFG, frames_per_clip=4)), mode=mode,
                   device="cpu", use_wandb=False, num_classes=4,
                   checkpoint_dir=str(tmp_path / "ck"),
                   log_dir=str(tmp_path / "logs"))
    tr.init_state(seed=2)
    return tr


@pytest.mark.parametrize("mode,protocol", [
    ("ar", "last_k"), ("ar", "reference"), ("diff", "reference"),
    ("future", "last_k"), ("text", "reference")])
def test_compiled_fvd_validation_equals_eager(graphs, tmp_path, mode,
                                              protocol):
    """``Trainer.fvd_validation``'s batch as one program per protocol: the
    FVD value identical to eager's; two batches, one graph; the train mode
    it had is back after it."""
    tr = _fvd_trainer(tmp_path, mode)
    n = 4 + (K if mode in ("future", "learned_tgt") else 0)
    loader = [([1, 2], np.random.default_rng(s).integers(
        0, 256, (2, n, FRAME, FRAME, 3), dtype=np.uint8)) for s in (0, 1)]
    stub = StubI3D()
    got = tr.fvd_validation(loader, stub, protocol=protocol)
    with J.disable_jit():
        want = tr.fvd_validation(loader, stub, protocol=protocol)
    assert np.isfinite(got) and got == want
    assert tr._fvd_batch.n_graphs == 1 and tr.model.training


def test_compiled_i3d_features_equal_eager(graphs):
    """``get_fvd_logits``: one program per chunk shape (the ragged last
    chunk is the second), logits equal eager's."""
    v = np.random.default_rng(6).integers(0, 256, (5, 9, 16, 16, 3),
                                          dtype=np.uint8)
    stub = StubI3D()
    FVD.jitted_features.cache_clear()
    got = FVD.get_fvd_logits(stub, v, batch_size=2)
    with J.disable_jit():
        want = FVD.get_fvd_logits(stub, v, batch_size=2)
    assert torch.equal(got, want) and got.shape == (5, 400)
    assert FVD.jitted_features(stub).n_graphs == 2
    FVD.jitted_features.cache_clear()


def test_compiled_latent_cache_equals_eager(graphs, tmp_path):
    """``build_latent_cache``'s encode as one program per batch shape: the
    cached latents equal eager's bit for bit."""
    vae = build(AutoencoderKL, VAEConfig(**TINY_VAE), "cpu", seed=0)
    codec = VAECodec(8, vae)
    clips = np.random.default_rng(8).integers(0, 256, (5, 3, 8, 8, 3),
                                              dtype=np.uint8)
    dataset = [(i, clips[i]) for i in range(5)]
    a = np.load(build_latent_cache(dataset, codec, str(tmp_path / "c"),
                                   "train", batch=2))
    with J.disable_jit():
        b = np.load(build_latent_cache(dataset, codec, str(tmp_path / "e"),
                                       "train", batch=2))
    assert a.shape == (5, 3, codec.latent_dim) and a.tobytes() == b.tobytes()


# -- a gloo group stays eager, by the backend's rule -------------------------

class CardRule(J.CudaGraphs):
    """The card's backend with its own group rule (``captures_over``), made
    to take CPU tensors: a call it would capture reaches ``warmup``, which
    fails the test; a call the rule makes eager never does."""

    def applies(self, tensors):
        return True

    def warmup(self, device, call):
        raise AssertionError("a program over a gloo group reached a compile")

    capture = warmup


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def gloo_group():
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_a_process_groups_step_refuses_to_compile(monkeypatch, gloo_group):
    """The card's backend captures over NCCL, not over gloo: a step built
    ``compiled`` over a gloo data group or model axis runs eagerly by that
    rule, decided before any compile (no caught failure), says so once
    and still all-reduces its gradients; the stand-in captures over
    any group."""
    monkeypatch.setattr(J, "BACKEND", CardRule())
    monkeypatch.setattr(J.dist, "get_backend", lambda g=None: (
        "nccl" if g == "an nccl group" else dist.Backend.GLOO))
    assert J.BACKEND.captures_over("an nccl group")
    assert not J.BACKEND.captures_over(gloo_group)
    assert not J.compilable([None, gloo_group]) and J.compilable([None])
    assert ReplayGraphs().captures_over(gloo_group)
    model, _, _ = _step("ar")
    cfg = Config(**CFG)
    for layout in (Layout(1, 1, 0, 0, data_group=gloo_group),
                   Layout(1, 1, 0, 0, model_group=gloo_group)):
        init_fn, step_fn = T.make_train_step(
            model, PixelCodec(FRAME, "cpu"), LossWeights.from_config(cfg),
            cfg, layout=layout)
        assert isinstance(step_fn.impl, J.jit)
        state, before = init_fn(), J.RULED_EAGER["step_impl"]
        grads = multihost.COLLECTIVES["grads"]
        with pytest.warns(UserWarning, match="runs eagerly.*gloo") as said:
            for _ in range(2):
                step_fn(state, _frames("ar"), 0)
        assert len(said) == 1 and state.step == 2
        assert step_fn.impl.n_graphs == 0
        assert J.RULED_EAGER["step_impl"] == before + 2
        assert multihost.COLLECTIVES["grads"] == grads + (
            2 if layout.data_group is not None else 0)


def test_a_trainer_in_a_process_group_is_eager_by_decision(
        monkeypatch, tmp_path, gloo_group):
    """A gloo group of one process under the card's backend: the Trainer's
    programs are jits over its groups, and each call of the step runs
    eagerly by the rule (no graph, not a failed capture), the gradients
    still all-reduced. Under the stand-in, which captures over gloo, the
    same Trainer's step compiles."""
    for backend, ck in ((CardRule(), "ck"), (ReplayGraphs(), "ck2")):
        monkeypatch.setattr(J, "BACKEND", backend)
        tr = T.Trainer(Config(**CFG), device="cpu", use_wandb=False,
                       checkpoint_dir=str(tmp_path / ck),
                       log_dir=str(tmp_path / "logs"))
        assert tr.layout.data_group is not None
        tr.init_state(seed=0)
        assert isinstance(tr._step_fn.impl, J.jit)
        assert isinstance(tr._fvd_batch, J.jit)
        grads, ruled = (multihost.COLLECTIVES["grads"],
                        J.RULED_EAGER["step_impl"])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tr._step_fn(tr.state, _frames("ar"), 0)
        assert multihost.COLLECTIVES["grads"] == grads + 1
        assert tr.state.step == 1
        eager = isinstance(backend, CardRule)
        assert tr._step_fn.impl.n_graphs == (0 if eager else 1)
        assert J.RULED_EAGER["step_impl"] == ruled + eager


class PoolGraphs(ReplayGraphs):
    """The stand-in, its pools counted."""

    def __init__(self):
        super().__init__()
        self.pools = []

    def new_pool(self, device):
        self.pools.append(object())
        return self.pools[-1]

    def capture(self, device, pool, call, *rest):
        self.used = getattr(self, "used", []) + [pool]
        return super().capture(device, pool, call, *rest)


def test_a_trainers_programs_share_one_pool(monkeypatch, tmp_path):
    """The step, eval and FVD batch run one after another: their graphs go
    into one memory pool."""
    stand_in = PoolGraphs()
    monkeypatch.setattr(J, "BACKEND", stand_in)
    tr = _fvd_trainer(tmp_path, "ar")
    n = 4
    frames = np.random.default_rng(0).integers(
        0, 256, (2, n, FRAME, FRAME, 3), dtype=np.uint8)
    tr.train_loop([([1, 2], frames)])
    tr.validation_loop([([1, 2], frames)])
    tr.fvd_validation([([1, 2], frames)], StubI3D())
    assert len(stand_in.pools) == 1 and stand_in.captures == 3
    assert all(p is stand_in.pools[0] for p in stand_in.used)
