"""The port's training losses against the JAX package's on the CPU: the same
seeded arrays through ``sd_video_gen_tpu/ops/losses.py`` and
``sd_video_gen_tpu_torch/ops/losses.py``.

Tolerance: values 1e-6 relative (f32 reductions in another order);
gradients with respect to ``pred`` against ``jax.grad`` of the JAX function,
1e-5 relative to the gradient's largest element. Equal values with wrong
gradients is the failure to look for in BiPatchNCE: its off-diagonal scores
stop the gradient through the second operand, its diagonal does not.
"""

import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sd_video_gen_tpu.config import load_config as jload_config
from sd_video_gen_tpu.ops import losses as JL
from sd_video_gen_tpu_torch.ops import losses as PL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(seed=0, shape=(2, 3, 64)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _check(jfn, pfn, pred, target, value_rtol=1e-6, grad_rtol=1e-5):
    want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(pred),
                                              jnp.asarray(target))
    p = torch.tensor(pred, requires_grad=True)
    got = pfn(p, torch.tensor(target))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=value_rtol)
    (grad,) = torch.autograd.grad(got, p)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=0,
                               atol=grad_rtol * np.abs(want_grad).max())
    return grad


@pytest.mark.parametrize("name,kw", [
    ("mse_loss", {}), ("l1_loss", {}),
    ("gradient_difference_loss", {"alpha": 1.0}),
    ("gradient_difference_loss", {"alpha": 2.0}),
    ("bipatch_nce_loss", {"temperature": 0.07}),
    ("bipatch_nce_loss", {"temperature": 0.5})])
def test_loss_value_and_gradient_match_jax(name, kw):
    pred, target = _pair()
    _check(lambda a, b: getattr(JL, name)(a, b, **kw),
           lambda a, b: getattr(PL, name)(a, b, **kw), pred, target)


def test_gdl_is_normalised_by_the_flattened_element_count():
    pred, target = _pair(1, (1, 1, 16))            # one 4 x 2 x 2 latent
    x, y = (torch.tensor(a).reshape(4, 2, 2) for a in (pred, target))
    dv = ((x[:, 1:] - x[:, :-1]).abs() - (y[:, 1:] - y[:, :-1]).abs()).abs()
    dh = ((x[..., 1:] - x[..., :-1]).abs()
          - (y[..., 1:] - y[..., :-1]).abs()).abs()
    want = (dv.sum() + dh.sum()) / 16               # not / (8 + 8)
    got = PL.gradient_difference_loss(torch.tensor(pred), torch.tensor(target))
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)


def test_bipatch_nce_stops_the_gradient_on_negative_pairs_only():
    """The gradient with respect to ``target`` as well: it flows through the
    diagonal (positive pairs) and, as first operand, through everything; a
    version that detached the whole second operand, or none of it, has the
    same value and another gradient."""
    pred, target = _pair(2)
    for argnum in (0, 1):
        want = jax.grad(JL.bipatch_nce_loss, argnums=argnum)(
            jnp.asarray(pred), jnp.asarray(target))
        p = torch.tensor(pred, requires_grad=True)
        g = torch.tensor(target, requires_grad=True)
        loss = PL.bipatch_nce_loss(p, g)
        grad = torch.autograd.grad(loss, (p, g))[argnum]
        want = np.asarray(want)
        np.testing.assert_allclose(grad.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())

    def naive(a, b, detach):           # no stop-gradient, or all of b
        def one(x, y):
            y = y.detach() if detach else y
            s = torch.einsum("mpc,mqc->mpq", x, y) / 0.07
            return (torch.logsumexp(s, -1)
                    - torch.diagonal(s, dim1=-2, dim2=-1)).mean()
        sp = lambda t: t.reshape(6, 4, 16).transpose(1, 2)
        return 0.5 * (one(sp(b), sp(a)) + one(sp(a), sp(b)))

    p = torch.tensor(pred, requires_grad=True)
    (right,) = torch.autograd.grad(
        PL.bipatch_nce_loss(p, torch.tensor(target)), p)
    for detach in (False, True):
        loss = naive(p, torch.tensor(target), detach)
        np.testing.assert_allclose(
            loss.item(), PL.bipatch_nce_loss(p, torch.tensor(target)).item(),
            rtol=1e-6)
        (wrong,) = torch.autograd.grad(loss, p)
        assert (wrong - right).abs().max() > 1e-3 * right.abs().max()


def _config_loss_mixes():
    """Every loss combination the repository's configs use."""
    mixes = {}
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "*.yml"))):
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cfg = jload_config(os.path.basename(path)[:-4],
                               os.path.join(REPO, "configs"))
        w = JL.LossWeights.from_config(cfg)
        mixes[tuple(sorted(vars(w).items()))] = cfg
    return list(mixes.values())


MIXES = _config_loss_mixes()


@pytest.mark.parametrize("i", range(len(MIXES)))
def test_composite_loss_matches_jax_for_every_mix_in_configs(i):
    cfg = MIXES[i]
    jw, pw = JL.LossWeights.from_config(cfg), PL.LossWeights.from_config(cfg)
    assert vars(jw) == vars(pw)
    pred, target = _pair(3 + i)
    jtotal, jcomps = JL.composite_loss(jnp.asarray(pred), jnp.asarray(target),
                                       jw)
    _check(lambda a, b: JL.composite_loss(a, b, jw)[0],
           lambda a, b: PL.composite_loss(a, b, pw)[0], pred, target)
    total, comps = PL.composite_loss(torch.tensor(pred), torch.tensor(target),
                                     pw)
    assert list(comps) == list(jcomps) and comps["total"] is total
    for k, v in jcomps.items():
        np.testing.assert_allclose(comps[k].item(), float(v), rtol=1e-6)


def test_the_configs_use_more_than_one_loss_mix():
    assert len(MIXES) >= 3
    assert any(m.use_l1 for m in MIXES)
    assert any(m.use_contrastive for m in MIXES)


@pytest.mark.parametrize("name", ["mse_loss", "l1_loss",
                                  "gradient_difference_loss",
                                  "bipatch_nce_loss"])
def test_bf16_inputs_give_f32_results(name):
    """Inputs are upcast before any arithmetic: a bf16 input gives exactly
    the f32 result of its upcast values."""
    pred, target = _pair(4)
    pb, tb = torch.tensor(pred).bfloat16(), torch.tensor(target).bfloat16()
    got = getattr(PL, name)(pb, tb)
    assert got.dtype == torch.float32
    assert torch.equal(got, getattr(PL, name)(pb.float(), tb.float()))
    total, comps = PL.composite_loss(pb, tb, PL.LossWeights())
    assert total.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in comps.values())
