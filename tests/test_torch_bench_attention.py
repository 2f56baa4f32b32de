"""The port's attention tool (``sd_video_gen_tpu_torch/tools/
bench_attention.py``) against the JAX tool (``tools/bench_attention.py``).

Tolerances: the tool's output on the CPU (the dispatcher's plain version)
against JAX's ``reference_attention`` on the same numpy inputs, |diff| <=
1e-5 in float32 (summation order over 64 keys) and <= 2e-2 in bfloat16
(p and the output rounded to bf16 on both sides, in another order). Shapes,
repeats and printed keys: equal.
"""

import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_video_gen_tpu.ops.attention import reference_attention
from sd_video_gen_tpu_torch.tools import bench_attention as BA

SMALL = (2, 64, 8)
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jax_tool():
    return importlib.import_module("tools.bench_attention")


def test_shapes_and_repeats_are_the_jax_tools(jax_tool):
    assert BA.SHAPES == jax_tool.SHAPES
    assert BA.REPEATS == jax_tool.REPEATS
    assert [BA.dtype_name(d) for d in BA.DTYPES] == ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_path_equals_jax_reference_attention(dtype):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(SMALL).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    mine = BA.IMPLS["flash"](tq, tk, tv).float().numpy()
    theirs = np.asarray(reference_attention(jq, jk, jv).astype(jnp.float32))
    assert np.abs(mine - theirs).max() <= ATOL[dtype]
    # the yardstick computes the same function
    sdpa = BA.IMPLS["sdpa"](tq, tk, tv).float().numpy()
    assert np.abs(sdpa - theirs).max() <= ATOL[dtype]


def test_run_prints_the_jax_tools_lines(capsys):
    lines = BA.run("cpu", shapes=[SMALL])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == lines
    parity = [x for x in lines if "parity_shape" in x]
    timing = [x for x in lines if "impl" in x]
    speedup = [x for x in lines if "flash_speedup" in x]
    assert len(parity) == len(speedup) == 2 and len(timing) == 6
    for x in parity:     # the JAX tool's keys, the port's limits
        assert {"parity_shape", "dtype", "max_abs_err", "ok"} <= set(x)
        assert x["ok"] and x["max_abs_err"] == 0.0 and x["route"] == "plain"
        assert x["atol"] == {"float32": 3e-5, "bfloat16": 2e-2}[x["dtype"]]
    assert {x["impl"] for x in timing} == {"flash", "einsum", "sdpa"}
    for x in timing:
        assert set(x) == {"impl", "shape", "dtype", "per_call_us"}
        assert x["per_call_us"] > 0 and x["shape"] == list(SMALL)
    for x in speedup:
        assert {"shape", "dtype", "flash_speedup"} <= set(x)


def test_refuses_the_card_where_there_is_none(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert BA.main([]) == 2
    assert "--device cpu" in capsys.readouterr().err
