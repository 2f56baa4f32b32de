"""Adam with the arithmetic and state dtypes of ``optax.adam(lr, b1=0.9,
b2=0.999, eps=1e-8, mu_dtype=...)``, which the JAX trainer uses.

    mu  = (1 - b1) * g + b1 * mu
    nu  = (1 - b2) * g * g + b2 * nu
    u   = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
    p   = p + (-lr) * u

``torch.optim.Adam`` computes the same mathematics in another order (a lerp
for ``mu``, ``sqrt(nu) / sqrt(1 - b2^t)``, the step size folded into one
``addcdiv``), which shows in bf16; so this is a plain function on tensors.

On the card the update is one hand-written kernel
(``csrc/adam.cu``, ``sdvg_adam_multi_tensor_apply_kernel``): one launch per
``(dtype, mu_dtype)`` group reads p, g, mu and nu once and writes p, mu and
nu once (14 bytes a bf16 parameter). Its plain version, the arithmetic it
reproduces bit for bit, is ten ``torch._foreach_*`` passes
(``_foreach_update``: 14 tensor reads and 10 writes of each element, and
two temporaries), which the CPU runs, and the card under
``_kernels.force_reference()``. ``Adam.update`` is the dispatcher, as
``ops/attention.attention`` is K1's: it counts its calls in
``_kernels.CALLS`` and the kernel's launches in ``_kernels.LAUNCHES``
under ``KERNEL``.

Dtypes as optax has them: ``nu`` has the parameter's dtype, ``mu`` has
``mu_dtype`` or the parameter's; with bf16 parameters both moments and the
update are bf16. Every scalar (``b1``, ``1 - b1``, the bias corrections,
``lr``) is rounded to the tensors' dtype before it is used, as JAX's weakly
typed Python scalars are: in bf16 ``b2 = 0.999`` is 1.0.

The state is ``{"mu": {name: tensor}, "nu": {name: tensor}}`` under the
parameters' names, so that it bridges from a JAX ``opt_state``
(``diffusion/weights.train_state_from_jax``); the step count lives with the
train state.

The bias corrections ``1 - b^t`` change every step, so they are not Python
numbers inside the update (a CUDA graph would freeze them): the host
computes them as optax does (f32, then rounded to each group's dtype) and
fills one pair of 0-d tensors on the parameters' device per ``(dtype,
mu_dtype)`` group (``set_count``), which ``update`` divides by. Eager and
compiled steps run this one arithmetic.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from sd_video_gen_tpu_torch.ops import _kernels

KERNEL = "adam"    # the kernel's name in _kernels.LAUNCHES and CALLS
# (parameters' dtype, mu's dtype) -> the kernel's codes of the two
_PAIR_CODES = {(torch.float32, torch.float32): (0, 0),
               (torch.bfloat16, torch.bfloat16): (1, 1),
               (torch.float32, torch.bfloat16): (0, 1)}


def _rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` as the nearest value of ``dtype``, back as a Python float."""
    return torch.tensor(float(x), dtype=torch.float32).to(dtype).item()


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, mu_dtype: torch.dtype | None = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu_dtype = mu_dtype
        # (dtype, mu_dtype) -> (1 - b1^t, 1 - b2^t) as 0-d tensors of dtype
        self.bias_corrections: dict = {}

    def init(self, params: dict) -> dict:
        """Zero moments for ``params`` (name -> tensor)."""
        return {"mu": {k: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                       for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def set_count(self, params: dict, state: dict, count: int) -> None:
        """Fill the bias corrections of step number ``count`` (from 1) into
        the device tensors ``update`` reads: the host part of a step."""
        # 1 - decay^count in f32, as optax computes it before the cast
        bc = [float(np.float32(1) - np.power(np.float32(b), np.float32(count)))
              for b in (self.b1, self.b2)]
        for name, p in params.items():
            key = (p.dtype, state["mu"][name].dtype)
            if key not in self.bias_corrections:
                self.bias_corrections[key] = tuple(
                    torch.zeros((), dtype=p.dtype, device=p.device)
                    for _ in bc)
        for (dtype, _), pair in self.bias_corrections.items():
            for t, v in zip(pair, bc):
                t.fill_(_rounded(v, dtype))

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict,
               count: int | None = None) -> None:
        """One Adam update in place, with the bias corrections of step
        number ``count`` (from 1), or, without it, those the last
        ``set_count`` filled in (the compiled step's way: no host scalar
        changes inside it). A parameter without a gradient (one the forward
        does not use) keeps its value and its zero moments, as a zero
        gradient would leave them."""
        if count is not None:
            self.set_count(params, state, count)
        groups = collections.defaultdict(list)
        for name, g in grads.items():
            if g is not None:
                groups[(g.dtype, state["mu"][name].dtype)].append(name)
        for (dtype, mu_dtype), names in groups.items():
            p = [params[n] for n in names]
            g = [grads[n] for n in names]
            mu = [state["mu"][n] for n in names]
            nu = [state["nu"][n] for n in names]
            bc1, bc2 = self.bias_corrections[(dtype, mu_dtype)]
            _kernels.record(KERNEL, (tuple(tuple(t.shape) for t in p),
                                     dtype, mu_dtype))
            device = p[0].device
            if device.type == "cpu" or _kernels.forced():
                self._foreach_update(p, g, mu, nu, bc1, bc2)
            elif device.type == "cuda":
                multi_tensor_adam(p, g, mu, nu, bc1, bc2, self.scalars(
                    dtype, mu_dtype))
            else:
                raise ValueError(f"Adam: no path for device {device}")

    def scalars(self, dtype: torch.dtype, mu_dtype: torch.dtype) -> tuple:
        """The update's scalars as a group's passes use them: ``b1`` in
        mu's dtype; ``1 - b1``, ``b2``, ``1 - b2``, ``eps`` and ``-lr`` in
        the parameters'."""
        r = lambda x: _rounded(x, dtype)
        return (_rounded(self.b1, mu_dtype), r(1 - self.b1), r(self.b2),
                r(1 - self.b2), r(self.eps), r(-self.lr))

    def _foreach_update(self, p, g, mu_state, nu, bc1, bc2) -> None:
        """The plain version: one group's update in ten ``torch._foreach_*``
        passes (and a cast to the gradients' dtype and a copy back where
        mu's dtype is not theirs)."""
        dtype, mu_dtype = g[0].dtype, mu_state[0].dtype
        b1_mu, a1, b2, a2, eps, neg_lr = self.scalars(dtype, mu_dtype)
        # optax forms b1 * mu in mu's own dtype, promotes the sum with
        # (1 - b1) * g to the gradient's dtype, and casts mu back to
        # mu_dtype only after the update is formed
        torch._foreach_mul_(mu_state, b1_mu)
        mu = (mu_state if mu_dtype == dtype
              else [m.to(dtype) for m in mu_state])
        torch._foreach_add_(mu, g, alpha=a1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=a2)
        update = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(p, update, alpha=neg_lr)
        if mu is not mu_state:
            torch._foreach_copy_(mu_state, mu)


def launch_plan(numels, vector: int, max_tensors: int) -> list:
    """The kernel's launches over tensors of ``numels`` elements: a list of
    ``(entries, units)``, each launch at most ``max_tensors`` tensors in
    order, ``entries`` their ``(index, start)``: the tensor's index in
    ``numels`` and its first unit of ``vector`` elements in the launch's
    index space (the prefix sum of ``ceil(numel / vector)`` over the
    tensors before it in the launch), ``units`` the launch's total. Tensors
    without elements are left out."""
    if vector < 1 or max_tensors < 1:
        raise ValueError(f"launch_plan: vector {vector}, max_tensors "
                         f"{max_tensors}")
    plan, entries, units = [], [], 0
    for i, n in enumerate(numels):
        if n == 0:
            continue
        if len(entries) == max_tensors:
            plan.append((entries, units))
            entries, units = [], 0
        entries.append((i, units))
        units += -(-n // vector)
    if entries:
        plan.append((entries, units))
    return plan


def multi_tensor_adam(params, grads, mus, nus, bc1, bc2, scalars) -> None:
    """Launch the kernel on one group, in place: lists of contiguous CUDA
    tensors on one device, each 16-byte aligned, ``params``, ``grads`` and
    ``nus`` of one dtype and ``mus`` of mu's (float32 / float32,
    bfloat16 / bfloat16 or float32 / bfloat16), each quadruple of one
    shape; ``bc1``, ``bc2`` 0-d tensors of the parameters' dtype on that
    device holding ``1 - b1^t``, ``1 - b2^t``; ``scalars`` as
    ``Adam.scalars`` gives them. One launch per ``sdvg_adam_max_tensors()``
    tensors; raises on anything the kernel does not take."""
    if not (len(params) == len(grads) == len(mus) == len(nus)) or not params:
        raise ValueError("adam: needs equally long, non-empty lists")
    dtype, mu_dtype = params[0].dtype, mus[0].dtype
    codes = _PAIR_CODES.get((dtype, mu_dtype))
    if codes is None:
        raise ValueError(f"adam: parameters {dtype} with mu {mu_dtype}; the "
                         f"kernel takes {sorted(map(str, _PAIR_CODES))}")
    device = params[0].device
    if device.type != "cuda":
        raise ValueError(f"adam: tensors on {device}, the kernel needs CUDA")
    for bc in (bc1, bc2):
        if bc.device != device or bc.dtype != dtype or bc.dim() != 0:
            raise ValueError(f"adam: a bias correction {bc.dtype} of shape "
                             f"{tuple(bc.shape)} on {bc.device}; needs a 0-d "
                             f"{dtype} tensor on {device}")
    table = []
    for quad in zip(params, grads, mus, nus):
        for t, want in zip(quad, (dtype, dtype, mu_dtype, dtype)):
            if t.device != device or t.dtype != want:
                raise ValueError(f"adam: a {t.dtype} tensor on {t.device} in "
                                 f"a group of {want} on {device}")
            if not t.is_contiguous():
                raise ValueError("adam: tensors must be contiguous")
            if t.data_ptr() % 16:
                raise ValueError("adam: tensors must be 16-byte aligned")
        if not all(t.shape == quad[0].shape for t in quad):
            raise ValueError(f"adam: shapes {[tuple(t.shape) for t in quad]}")
        table.append([t.data_ptr() for t in quad])
    lib = _kernels.library()
    plan = launch_plan([p.numel() for p in params], 16 // dtype.itemsize,
                       lib.sdvg_adam_max_tensors())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for entries, units in plan:
            rows = (ctypes.c_longlong * (6 * len(entries)))(*[
                x for i, start in entries
                for x in (*table[i], params[i].numel(), start)])
            err = lib.sdvg_adam(rows, len(entries), units, *codes, *scalars,
                                bc1.data_ptr(), bc2.data_ptr(), stream)
            _kernels.check(err, "adam")
            _kernels.count_launch(KERNEL)
