"""The port's compiled programs (``sd_video_gen_tpu_torch/utils/jit.py``)
and the serving entry points built on them, on the CPU.

A CUDA graph cannot be captured here, so ``jit``'s backend is replaced by a
stand-in (``ReplayGraphs``, ``tests/torch_port_common.py``) whose graph replays the captured function: its
capture runs the function once on the static inputs (as a capture records
it), its replay runs it again and writes the result into the captured
outputs in place (as a replay rewrites the graph's memory), with the
package's launch counters left as they were (a replay runs no Python). The
compiled path then runs on CPU tensors exactly as it would on the card:
keys, static buffers, output copies, launch accounting, nesting and the
eager rules.

Against the JAX package: ``jit_rollout`` and ``jit_cached_rollout`` at tiny
widths on bridged weights (f32 on both sides, other summation orders: rtol
1e-4 / atol 1e-5, the rollout tests' bound). Compiled against eager in the
port: equal bit for bit (the same function on the same inputs).

The card's side (a real capture of a host sync, and a compiled predictor
against eager) is ``tests/test_torch_jit_cuda.py``, which imports torch
only.
"""

import contextlib
import gc

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sd_video_gen_tpu.ops.cached_rollout import (
    jit_cached_rollout as jjit_cached_rollout)
from sd_video_gen_tpu.ops.rollout import jit_rollout as jjit_rollout
from sd_video_gen_tpu_torch.codecs import PixelCodec
from sd_video_gen_tpu_torch.diffusion.refine import (default_noise,
                                                     make_denoise_refiner)
from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.ops import attention as A
from sd_video_gen_tpu_torch.ops import cached_rollout as CR
from sd_video_gen_tpu_torch.ops import groupnorm as GN
from sd_video_gen_tpu_torch.ops.cached_rollout import jit_cached_rollout
from sd_video_gen_tpu_torch.ops.rollout import jit_rollout
from sd_video_gen_tpu_torch.predict.predict import (make_decode_fn,
                                                    make_predict_fn)
from sd_video_gen_tpu_torch.tools.bench_harness import launch_window
from sd_video_gen_tpu_torch.utils import jit as J
from torch_port_common import (ReplayGraphs, sd_pair, t,
                               transformer_pair)

L, PRED = 16, 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads gain nothing and,
    with several test workers on one host, only contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def graphs(monkeypatch):
    stand_in = ReplayGraphs()
    monkeypatch.setattr(J, "BACKEND", stand_in)
    return stand_in


def _counting(fn):
    calls = []

    def run(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)
    return run, calls


# -- the cache ---------------------------------------------------------------

def test_one_graph_per_key_and_static_arguments_are_keys(graphs):
    fn, calls = _counting(lambda x, scale, n=2: x * scale + n)
    f = J.jit(fn, static_argnames=("n",))
    x = torch.arange(6.0)
    assert torch.equal(f(x, 2.0), x * 2 + 2)
    assert torch.equal(f(x + 1, 2.0), (x + 1) * 2 + 2)
    assert f.n_graphs == 1 and graphs.captures == 1
    # compile = warm-up + capture, then one replay a call
    assert len(calls) == 4
    f(x, 3.0)                              # another number: another graph
    f(x, 2.0, n=5)                         # a static keyword
    f(x, 2.0, 5)                           # the same static, by position
    f(x.reshape(2, 3), 2.0)                # another shape
    f(x.reshape(3, 2).t(), 2.0)            # another stride
    f(x.double(), 2.0)                     # another dtype
    assert f.n_graphs == 7
    assert [c["name"] for c in J.COMPILES[-6:]] == [f.name] * 6


def test_objects_are_keyed_by_identity_and_read_in_place(graphs):
    f = J.jit(lambda tree, x: x * tree["w"])
    tree = {"w": torch.tensor(2.0)}
    x = torch.ones(3)
    assert torch.equal(f(tree, x), torch.full((3,), 2.0))
    tree["w"].fill_(3.0)                   # an in-place update is seen
    assert torch.equal(f(tree, x), torch.full((3,), 3.0))
    f({"w": torch.tensor(5.0)}, x)         # another object: another graph
    assert f.n_graphs == 2


def test_disable_jit_and_the_dispatch_contexts_run_eagerly(graphs):
    fn, calls = _counting(lambda x: x + 1)
    f = J.jit(fn)
    x = torch.zeros(2)
    for ctx in (J.disable_jit(), _kernels.force_reference(),
                _kernels.record_calls()):
        with ctx:
            assert f.eager()
            assert torch.equal(f(x), x + 1)
    assert f.n_graphs == 0 and len(calls) == 3 and graphs.captures == 0
    f(x)
    assert f.n_graphs == 1 and not f.eager()


def test_the_cpu_runs_the_function_as_it_is():
    fn, calls = _counting(lambda x: x * 2)
    f = J.jit(fn)
    assert torch.equal(f(torch.ones(2)), torch.full((2,), 2.0))
    assert f.n_graphs == 0 and len(calls) == 1
    assert f(3) == 6                       # no tensor at all: eager too


def test_outputs_are_copies_a_held_result_survives_the_next_call(graphs):
    f = J.jit(lambda x: {"y": x * 2, "n": 7, "s": (x.sum(),)})
    a = f(torch.ones(4))
    held = a["y"].clone()
    b = f(torch.full((4,), 5.0))
    assert torch.equal(a["y"], held) and torch.equal(b["y"],
                                                     torch.full((4,), 10.0))
    assert a["n"] == 7 and a["s"][0].item() == 4.0
    entry = next(iter(f._graphs.values()))
    assert a["y"].data_ptr() != entry.out["y"].data_ptr()
    assert b["y"].data_ptr() != a["y"].data_ptr()


def test_inputs_are_copied_into_static_buffers(graphs):
    seen = []
    f = J.jit(lambda x: seen.append(x.data_ptr()) or x + 0)
    x = torch.ones(3)
    f(x)
    f(x)
    entry = next(iter(f._graphs.values()))
    buf = entry.inputs[0].data_ptr()
    assert x.data_ptr() not in seen and set(seen) == {buf}


def test_launch_counts_are_added_once_per_replay(graphs):
    def fn(x):
        _kernels.record("flash_attention", ())
        _kernels.count_launch("flash_attention")
        A.ROUTE_LAUNCHES["wgmma"] += 1
        for _ in range(3):
            _kernels.record("groupnorm_silu", ())
            _kernels.count_launch("groupnorm_silu")
            GN.ROUTE_LAUNCHES["nhwc"] += 1
        return x + 1

    f = J.jit(fn)
    with launch_window() as window:
        for _ in range(4):
            f(torch.zeros(2))
    assert window.launches == {"flash_attention": 4, "groupnorm_silu": 12,
                               "adam": 0}
    assert window.calls == {"flash_attention": 4, "groupnorm_silu": 12}
    assert window.bodies == {"wgmma": 4} and window.gn_bodies == {"nhwc": 12}
    # the compile's launches are kept with it, not counted as a request's
    rec = J.COMPILES[-1]
    assert rec["warmup_launches"] == rec["graph_launches"] == {
        "flash_attention": 1, "groupnorm_silu": 3}
    with J.disable_jit(), launch_window() as eager:
        f(torch.zeros(2))
    assert eager.launches == {"flash_attention": 1, "groupnorm_silu": 3,
                              "adam": 0}


def test_a_nested_jit_joins_the_outer_program(graphs):
    inner_fn, inner_calls = _counting(lambda x: x * 3)
    inner = J.jit(inner_fn)
    outer = J.jit(lambda x: inner(x) + 1)
    assert torch.equal(outer(torch.ones(2)), torch.full((2,), 4.0))
    assert inner.n_graphs == 0 and outer.n_graphs == 1
    assert len(inner_calls) == 3           # warm-up, capture, replay


class _RefuseItem(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.item.default,
                    torch.ops.aten._local_scalar_dense.default):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return func(*args, **(kwargs or {}))


class RefusingGraphs(ReplayGraphs):
    """A capture that refuses a host sync, as the card's does."""

    def capture(self, device, pool, call, *rest):
        with _RefuseItem():
            return super().capture(device, pool, call, *rest)


def test_a_failed_capture_raises_naming_the_op(monkeypatch):
    monkeypatch.setattr(J, "BACKEND", RefusingGraphs())

    def fn(x):
        _kernels.count_launch("flash_attention")
        return x * x.sum().item()

    f = J.jit(fn, name="item")
    with launch_window() as window:
        with pytest.raises(RuntimeError,
                           match=r"jit\(item\).*after TensorBase\.item"):
            f(torch.ones(2))
    assert f.n_graphs == 0 and window.launches["flash_attention"] == 0


class _FakeCUDAGraph:
    """``torch.cuda.CUDAGraph`` as far as ``CudaGraphs.capture`` uses it."""

    def __init__(self, keep_graph=False):
        pass

    def register_generator_state(self, gen):
        pass


def test_no_collection_runs_inside_a_capture(monkeypatch):
    """The card's capture holds off Python's cyclic collector (a collection
    there could free another graph, which ends the capture) and turns it
    back on after, also when the captured call raises. The CUDA graph API
    is stubbed: the rest of ``CudaGraphs.capture`` runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeCUDAGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    seen = []
    _, out = J.CudaGraphs().capture("cuda", None,
                                    lambda: seen.append(gc.isenabled()) or 7)
    assert out == 7 and seen == [False] and gc.isenabled()

    def fails():
        raise RuntimeError("capture")
    with pytest.raises(RuntimeError, match="capture"):
        J.CudaGraphs().capture("cuda", None, fails)
    assert gc.isenabled()


def test_an_input_that_requires_grad_is_refused(graphs):
    f = J.jit(lambda x: x * 2)
    with pytest.raises(ValueError, match="requires grad"):
        f(torch.ones(2, requires_grad=True))


# -- the rollouts against the JAX package's jitted ones ----------------------

@pytest.fixture(scope="module")
def pair():
    return transformer_pair(L, seed=60)


def _context(seed, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, 6, L)).astype(np.float32)


@pytest.mark.parametrize("compiled", [False, True])
def test_jit_rollout_matches_jax(pair, compiled, monkeypatch):
    if compiled:
        monkeypatch.setattr(J, "BACKEND", ReplayGraphs())
    jm, params, pm = pair
    ctx = _context(61)
    want = jjit_rollout(jm.apply, PRED, window=5)(params, jnp.asarray(ctx))
    f = jit_rollout(pm, PRED, window=5)
    with torch.no_grad():
        got = f(t(ctx))
        again = f(t(_context(62)))
    assert f.n_graphs == int(compiled)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    want2 = jjit_rollout(jm.apply, PRED, window=5)(params,
                                                   jnp.asarray(_context(62)))
    np.testing.assert_allclose(again.numpy(), np.asarray(want2), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("compiled", [False, True])
def test_jit_cached_rollout_matches_jax(pair, compiled, monkeypatch):
    if compiled:
        monkeypatch.setattr(J, "BACKEND", ReplayGraphs())
    jm, params, pm = pair
    ctx = _context(63, batch=3)
    want = jjit_cached_rollout(jm.cfg, PRED)(params, jnp.asarray(ctx))
    f = jit_cached_rollout(pm.cfg, PRED)
    with torch.no_grad():
        got = f(pm, t(ctx))
        f(pm, t(ctx))
    assert f.n_graphs == int(compiled)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_the_cached_rollout_builds_its_positional_table_once(pair,
                                                             monkeypatch):
    _, _, pm = pair
    built = []
    real = CR.sinusoidal_positions
    monkeypatch.setattr(CR, "sinusoidal_positions",
                        lambda *a: built.append(a) or real(*a))
    CR.positions.cache_clear()
    with torch.no_grad():
        a = CR.cached_rollout(pm.cfg, pm, t(_context(64)), PRED)
        b = CR.cached_rollout(pm.cfg, pm, t(_context(64)), PRED)
    assert built == [(pm.cfg.max_len, pm.cfg.model_width)]
    assert torch.equal(a, b)
    CR.positions.cache_clear()


# -- the serving entry points ------------------------------------------------

@pytest.fixture(scope="module")
def sd():
    return sd_pair(16)[1]


def _frames(seed, batch=2, size=16):
    return np.random.default_rng(seed).integers(
        0, 256, (batch, 5, size, size, 3), dtype=np.uint8)


def test_the_refiner_draws_each_steps_noise_once(sd, graphs):
    drawn = []

    def noise(step, shape):
        drawn.append((step, tuple(shape)))
        g = torch.Generator().manual_seed(100 + step)
        return torch.randn(shape, generator=g)

    refine = make_denoise_refiner(sd, 16, 48, 50, hi_res=None,
                                  noise_fn=noise)
    fresh = make_denoise_refiner(sd, 16, 48, 50, hi_res=None,
                                 noise_fn=noise)
    lat = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 4 * 8 * 8)).astype(np.float32))
    with torch.no_grad():
        first = [refine(lat, step) for step in range(3)]
        second = [refine(lat, step) for step in range(3)]
    assert drawn == [(s, (2, 8, 8, 4)) for s in range(3)]
    with torch.no_grad():
        other = [fresh(lat, step) for step in range(3)]
    for a, b, c in zip(first, second, other):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_the_default_noise_is_drawn_once_and_stays_the_draw():
    draw = default_noise(40, "cpu")
    a = draw(1, (2, 8, 8, 4))
    assert draw(1, (2, 8, 8, 4)) is a
    g = torch.Generator().manual_seed((40 << 16) | 1)
    assert torch.equal(a, torch.randn((2, 8, 8, 4), generator=g))


@pytest.mark.parametrize("mode,rollout,int8,codec", [
    ("ar", "full", False, "vae"), ("ar", "cached", False, "pixel"),
    ("diff", "full", True, "pixel"), ("future", "full", False, "pixel")])
def test_a_compiled_predict_equals_eager(sd, graphs, mode, rollout, int8,
                                         codec):
    model_mode = "future" if mode == "future" else "ar"
    _, _, pm = transformer_pair(
        4 * 8 * 8 if codec == "vae" else 16, seed=65, mode=model_mode,
        **({"frames_to_predict": 3} if mode == "future" else {}))
    cdc = VAECodec(16, sd.vae) if codec == "vae" else PixelCodec(16, "cpu")
    refiner = (make_denoise_refiner(sd, 16, 48, 50, hi_res=None)
               if codec == "vae" else None)
    kw = dict(window=5, mode=mode, refiner=refiner, rollout=rollout,
              int8=int8, future_horizon=3 if mode == "future" else None)
    compiled = make_predict_fn(pm, cdc, PRED, **kw)
    a = compiled(_frames(66))
    held = [x.clone() for x in a]
    b = compiled(_frames(67))
    assert compiled.impl.n_graphs == 1
    with J.disable_jit():
        eager = [make_predict_fn(pm, cdc, PRED, **kw)(_frames(s))
                 for s in (66, 67)]
    for x, y, h in zip(a, eager[0], held):
        assert torch.equal(x, y) and torch.equal(x, h)
    for x, y in zip(b, eager[1]):
        assert torch.equal(x, y)
    compiled(_frames(68, batch=1))              # a ragged batch: its own
    assert compiled.impl.n_graphs == 2
    decode = make_decode_fn(cdc)
    flat = a[1].reshape(-1, a[1].shape[-1])
    assert torch.equal(decode(flat), cdc.decode_latents(flat))
    assert decode.n_graphs == 1


def test_the_sd_programs_are_one_per_sampler_steps_and_guidance(sd, graphs):
    emb = torch.cat([sd.uncond_embeddings(1)[:1], sd.uncond_embeddings(1)[:1]
                     * 1.5])
    lat = torch.from_numpy(np.random.default_rng(69).standard_normal(
        (1, 4, 8, 8)).astype(np.float32))
    runs = [dict(sampler="lms", num_inference_steps=3, guidance_scale=7.5),
            dict(sampler="lms", num_inference_steps=3, guidance_scale=7.5),
            dict(sampler="lms", num_inference_steps=4, guidance_scale=7.5),
            dict(sampler="lms", num_inference_steps=3, guidance_scale=0.0),
            dict(sampler="dpmpp", num_inference_steps=3, guidance_scale=7.5)]
    outs = [sd.denoise_img_latents(emb, 32, 32, latents=lat, **r)
            for r in runs]
    assert sd._lms.n_graphs == 3 and sd._dpm_full.n_graphs == 1
    with J.disable_jit():
        for r, out in zip(runs, outs):
            assert torch.equal(
                out, sd.denoise_img_latents(emb, 32, 32, latents=lat, **r))
    img = np.random.default_rng(70).integers(0, 256, (1, 16, 16, 3),
                                             dtype=np.uint8)
    g = lambda: torch.Generator().manual_seed(3)
    a = sd.img_to_img([""], img, 16, 16, 10, 7.5, start_step=7,
                      generator=g())
    with J.disable_jit():
        b = sd.img_to_img([""], img, 16, 16, 10, 7.5, start_step=7,
                          generator=g())
    assert torch.equal(a, b) and a.dtype == torch.uint8
    assert all(p.n_graphs == 1 for p in (sd._i2i, sd._encode, sd._decode))
    assert sd._clip_apply.n_graphs == 1
