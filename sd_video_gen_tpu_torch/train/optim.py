"""Adam with the arithmetic and state dtypes of ``optax.adam(lr, b1=0.9,
b2=0.999, eps=1e-8, mu_dtype=...)``, which the JAX trainer uses.

    mu  = (1 - b1) * g + b1 * mu
    nu  = (1 - b2) * g * g + b2 * nu
    u   = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
    p   = p + (-lr) * u

``torch.optim.Adam`` computes the same mathematics in another order (a lerp
for ``mu``, ``sqrt(nu) / sqrt(1 - b2^t)``, the step size folded into one
``addcdiv``), which shows in bf16; so this is a plain function on tensors,
run with ``torch._foreach_*`` (a handful of launches for all parameters of
one dtype, no host synchronisation).

Dtypes as optax has them: ``nu`` has the parameter's dtype, ``mu`` has
``mu_dtype`` or the parameter's; with bf16 parameters both moments and the
update are bf16. Every scalar (``b1``, ``1 - b1``, the bias corrections,
``lr``) is rounded to the tensors' dtype before it is used, as JAX's weakly
typed Python scalars are: in bf16 ``b2 = 0.999`` is 0.998046875.

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

import numpy as np
import torch


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
            nu = [state["nu"][n] for n in names]
            mu_state = [state["mu"][n] for n in names]
            r = lambda x: _rounded(x, dtype)
            # optax forms b1 * mu in mu's own dtype, promotes the sum with
            # (1 - b1) * g to the gradient's dtype, and casts mu back to
            # mu_dtype only after the update is formed
            torch._foreach_mul_(mu_state, _rounded(self.b1, mu_dtype))
            mu = (mu_state if mu_dtype == dtype
                  else [m.to(dtype) for m in mu_state])
            torch._foreach_add_(mu, g, alpha=r(1 - self.b1))
            torch._foreach_mul_(nu, r(self.b2))
            torch._foreach_addcmul_(nu, g, g, value=r(1 - self.b2))
            bc1, bc2 = self.bias_corrections[(dtype, mu_dtype)]
            update = torch._foreach_div(mu, bc1)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, r(self.eps))
            torch._foreach_div_(update, denom)
            torch._foreach_add_(p, update, alpha=r(-self.lr))
            if mu is not mu_state:
                torch._foreach_copy_(mu_state, mu)
