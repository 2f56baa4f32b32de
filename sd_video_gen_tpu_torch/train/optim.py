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

    def init(self, params: dict) -> dict:
        """Zero moments for ``params`` (name -> tensor)."""
        return {"mu": {k: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                       for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict,
               count: int) -> None:
        """One Adam update in place; ``count`` is the step's number, from 1.
        A parameter without a gradient (one the forward does not use) keeps
        its value and its zero moments, as a zero gradient would leave them."""
        # 1 - decay^count in f32, as optax computes it before the cast
        bc1, bc2 = (float(np.float32(1) - np.power(np.float32(b),
                                                   np.float32(count)))
                    for b in (self.b1, self.b2))
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
            update = torch._foreach_div(mu, r(bc1))
            denom = torch._foreach_div(nu, r(bc2))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, r(self.eps))
            torch._foreach_div_(update, denom)
            torch._foreach_add_(p, update, alpha=r(-self.lr))
            if mu is not mu_state:
                torch._foreach_copy_(mu_state, mu)
