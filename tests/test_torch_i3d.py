"""The port's I3D (``sd_video_gen_tpu_torch/models/i3d.py``) against the JAX
package's (``sd_video_gen_tpu/models/i3d.py``) on the same weights, bridged
through ``weights.i3d_state_dict``, and the same inputs.

Tolerances: f32 on both sides, so only summation order differs: a unit or a
module within 2e-5 relative to its output's scale; the full 224px graph (57
convolutions deep) within 2e-4 of the logits' scale. The full graph is
compiled once for the file (one input shape, (2, 9, 224, 224, 3)).
"""

import functools
import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sd_video_gen_tpu.models import i3d as J
from sd_video_gen_tpu_torch.diffusion.weights import i3d_state_dict
from sd_video_gen_tpu_torch.evaluation.predict_fvd import load_i3d
from sd_video_gen_tpu_torch.models import i3d as P

UNIT_RTOL = 2e-5
FULL_RTOL = 2e-4
SHAPE = (2, 9, 224, 224, 3)


def ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 4, 1, 2, 3)))


def ndhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 4, 1).numpy()


def close(ours, ref, rtol):
    ref = np.asarray(ref)
    err = np.abs(ours - ref).max()
    assert err <= rtol * np.abs(ref).max(), (err, np.abs(ref).max())


def _random_tree(module, seed, *args):
    """Seeded numpy weights for a flax module: BN variances in [0.5, 1.5],
    everything else N(0, 0.2^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "bn_var":
            return jnp.asarray(1.0 + 0.5 * np.tanh(x))
        return jnp.asarray(0.2 * x)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _bridged(params, module, name="u"):
    """``module`` loaded, strictly, with a single unit's or module's flax
    tree through the bridge (which names it ``name``)."""
    sd = i3d_state_dict({name: params["params"]})
    module.load_state_dict({k.split(".", 1)[1]: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
    return module.eval()


@pytest.mark.parametrize("kernel,stride,size", [
    ((1, 1, 1), (1, 1, 1), (4, 6, 6)),
    ((3, 3, 3), (1, 1, 1), (5, 7, 7)),
    ((3, 3, 3), (2, 2, 2), (5, 9, 8)),
    ((3, 3, 3), (2, 2, 2), (6, 8, 8)),
    ((7, 7, 7), (2, 2, 2), (9, 15, 15)),
    ((7, 7, 7), (2, 2, 2), (8, 16, 14)),
    ((1, 3, 3), (1, 2, 2), (3, 7, 10))])
def test_unit3d_matches_jax(kernel, stride, size):
    """'SAME' padding (the extra element at the end), conv, frozen BN and
    ReLU, at odd and even sizes and both strides."""
    cfg = J.I3DConfig()
    x = np.random.default_rng(1).standard_normal((2, *size, 3)) \
        .astype(np.float32)
    ju = J.Unit3D(cfg, 5, kernel, stride)
    params = _random_tree(ju, 7, jnp.asarray(x))
    ref = jax.jit(ju.apply)(params, jnp.asarray(x))
    pu = _bridged(params, P.Unit3D(3, 5, kernel, stride))
    with torch.no_grad():
        out = pu(ncdhw(x))
    assert out.shape[2:] == tuple(-(-n // s) for n, s in zip(size, stride))
    close(ndhwc(out), ref, UNIT_RTOL)


def test_unit3d_logits_with_bias_and_no_bn_matches_jax():
    cfg = J.I3DConfig()
    x = np.random.default_rng(2).standard_normal((2, 2, 1, 1, 16)) \
        .astype(np.float32)
    ju = J.Unit3D(cfg, 10, use_bn=False, use_bias=True, relu=False)
    params = _random_tree(ju, 3, jnp.asarray(x))
    pu = _bridged(params, P.Unit3D(16, 10, use_bn=False, use_bias=True,
                                   relu=False))
    assert pu.bn is None and pu.conv3d.bias is not None
    with torch.no_grad():
        out = pu(ncdhw(x))
    close(ndhwc(out), jax.jit(ju.apply)(params, jnp.asarray(x)), UNIT_RTOL)


def test_unit3d_matches_the_i3d_golden():
    """The framework-neutral golden: a stride-2 3x3x3 conv with 'SAME'
    padding and a bias (tests/fixtures/i3d_golden.npz)."""
    fx = np.load("tests/fixtures/i3d_golden.npz")
    u = P.Unit3D(2, 4, (3, 3, 3), (2, 2, 2), use_bn=False, use_bias=True,
                 relu=False)
    u.conv3d.weight.data = torch.from_numpy(fx["sd/weight"])
    u.conv3d.bias.data = torch.from_numpy(fx["sd/bias"])
    with torch.no_grad():
        out = u(ncdhw(fx["in/x"])).numpy()
    np.testing.assert_allclose(out, fx["out/y"], rtol=1e-4, atol=1e-5)


def test_frozen_batchnorm_is_the_affine_of_the_running_statistics():
    """BatchNorm3d in eval(): (x - mean) / sqrt(var + 1e-5) * w + b, the
    JAX unit's frozen BN, whatever batch it is given."""
    rng = np.random.default_rng(4)
    u = P.Unit3D(3, 4, relu=False)
    u.conv3d.weight.data = torch.eye(4, 3)[:, :, None, None, None]
    mean, var, w, b = (torch.from_numpy(rng.standard_normal(4)
                                        .astype(np.float32)) for _ in range(4))
    var = var.abs() + 0.1
    u.bn.running_mean.copy_(mean)
    u.bn.running_var.copy_(var)
    u.bn.weight.data, u.bn.bias.data = w, b
    u.eval()
    x = torch.from_numpy(rng.standard_normal((2, 3, 2, 2, 2))
                         .astype(np.float32))
    with torch.no_grad():
        out = u(x)
    y = torch.cat([x, torch.zeros_like(x[:, :1])], 1)
    want = ((y - mean[:, None, None, None]) / torch.sqrt(
        var[:, None, None, None] + 1e-5) * w[:, None, None, None]
        + b[:, None, None, None])
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    assert u.bn.eps == 1e-5


@pytest.mark.parametrize("kernel,stride,size", [
    ((1, 3, 3), (1, 2, 2), (5, 9, 9)),
    ((1, 3, 3), (1, 2, 2), (4, 8, 8)),
    ((3, 3, 3), (1, 1, 1), (3, 5, 6)),
    ((3, 3, 3), (2, 2, 2), (5, 7, 8)),
    ((2, 2, 2), (2, 2, 2), (3, 7, 7))])
def test_max_pool_same_matches_jax(kernel, stride, size):
    """-inf padding, the extra element at the end; inputs all below zero,
    where a zero pad would win."""
    x = -np.abs(np.random.default_rng(5).standard_normal((2, *size, 3))) \
        .astype(np.float32) - 1.0
    ref = J._max_pool_same(jnp.asarray(x), kernel, stride)
    out = P.max_pool_same(ncdhw(x), kernel, stride)
    np.testing.assert_array_equal(ndhwc(out), np.asarray(ref))


def test_inception_module_at_narrow_widths_matches_jax():
    cfg = J.I3DConfig()
    widths = (3, 2, 4, 2, 3, 5)
    x = np.random.default_rng(6).standard_normal((2, 3, 5, 5, 6)) \
        .astype(np.float32)
    jm = J.InceptionModule(cfg, widths)
    params = _random_tree(jm, 8, jnp.asarray(x))
    pm = _bridged(params, P.InceptionModule(6, widths), "Mixed_m")
    with torch.no_grad():
        out = pm(ncdhw(x))
    assert out.shape[1] == pm.out_channels == 3 + 4 + 3 + 5
    close(ndhwc(out), jax.jit(jm.apply)(params, jnp.asarray(x)), UNIT_RTOL)


@functools.lru_cache(maxsize=1)
def _full():
    """The JAX graph on ``load_i3d(None)``'s params and the port's on the
    same weights: (port module, inputs, JAX features, JAX logits)."""
    from sd_video_gen_tpu.evaluation.predict_fvd import load_i3d as jload
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm, params = jload(None)
    x = np.random.default_rng(9).uniform(-1, 1, SHAPE).astype(np.float32)
    feats, logits = jax.jit(lambda p, v: (jm.apply(p, v, return_features=True),
                                          jm.apply(p, v)))(params,
                                                           jnp.asarray(x))
    pm = P.InceptionI3d()
    pm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                        i3d_state_dict(jax.tree.map(np.asarray,
                                                    params)).items()},
                       strict=True)
    return pm.eval(), x, np.asarray(feats), np.asarray(logits)


def test_inception_i3d_logits_and_features_match_jax():
    pm, x, feats, logits = _full()
    with torch.no_grad():
        out = pm(ncdhw(x))
        f = pm(ncdhw(x), return_features=True)
    assert out.shape == (2, 400) and f.shape == (2, 1024, 1, 1, 1)
    assert np.isfinite(out.numpy()).all()
    close(out.numpy(), logits, FULL_RTOL)
    close(ndhwc(f), feats, FULL_RTOL)


def test_a_pytorch_i3d_state_dict_loads_strictly():
    """The reference layout, buffers included, loads with no renaming; a
    missing or an extra key raises."""
    ref = P.InceptionI3d()
    sd = ref.state_dict()
    assert {"Conv3d_1a_7x7.conv3d.weight", "Mixed_3b.b1b.bn.running_var",
            "logits.conv3d.bias", "Mixed_5c.b3b.bn.num_batches_tracked"} \
        <= set(sd)
    assert not any(k.startswith("logits.bn") for k in sd)
    P.convert_i3d(P.InceptionI3d(), sd)
    # saved before BatchNorm counted batches: still loads
    P.convert_i3d(P.InceptionI3d(), {k: v for k, v in sd.items()
                                     if "num_batches" not in k})
    missing = dict(sd)
    del missing["Mixed_4c.b2b.conv3d.weight"]
    with pytest.raises(RuntimeError, match="Missing key"):
        P.convert_i3d(P.InceptionI3d(), missing)
    extra = dict(sd, **{"Mixed_4c.b2c.conv3d.weight": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        P.convert_i3d(P.InceptionI3d(), extra)


@pytest.mark.parametrize("T", [2, 5, 8])
def test_clips_under_nine_frames_never_give_a_number(T):
    """The JAX graph returns NaN below 9 frames (tests/test_fvd.py); the
    port raises and names the minimum."""
    pm = _full()[0]
    with pytest.raises(ValueError, match="at least 9 frames"):
        pm(torch.zeros(1, 3, T, 224, 224))
    with pytest.raises(ValueError, match="193"):
        pm(torch.zeros(1, 3, 9, 64, 64))


def test_load_i3d_without_weights_draws_seeded_on_the_host(tmp_path):
    with pytest.warns(UserWarning, match="random init"):
        a = load_i3d(None, "cpu")
    with pytest.warns(UserWarning):
        b = load_i3d(None, "cpu")
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not a.training and not any(p.requires_grad
                                      for p in a.parameters())
    assert torch.equal(sa["Mixed_3b.b0.bn.running_var"], torch.ones(64))
    assert torch.equal(sa["Mixed_3b.b0.bn.weight"], torch.ones(64))
    w = sa["Mixed_4f.b1b.conv3d.weight"]
    assert abs(w.std().item() - 0.05) < 1e-3 and abs(w.mean()) < 1e-3
    path = tmp_path / "i3d.pt"
    torch.save(sa, path)
    c = load_i3d(str(path), "cpu")
    assert all(torch.equal(c.state_dict()[k], sa[k]) for k in sa)
