"""Adam's dispatcher and the one-pass kernel's launch plan, on the CPU.

``Adam.update`` sends CPU tensors, and every device under
``_kernels.force_reference()``, to the foreach passes (the plain version)
and counts each group's call; the kernel's table and grid walk
(``launch_plan``, emulated here as ``csrc/adam.cu`` walks it) cover every
element of every tensor exactly once. The kernel itself runs on the card
only (``tests/test_torch_kernels.py``).
"""

import collections

import numpy as np
import pytest
import torch

from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.train import optim

SHAPES = {"a": (3, 5), "b": (8,), "c": (1,), "d": (4, 4, 2), "unused": (7,)}


def _case(dtype, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = {k: torch.randn(s, generator=gen).to(dtype).to(device)
              for k, s in SHAPES.items()}
    grads = {k: None if k == "unused" else
             torch.randn(s, generator=gen).to(dtype).to(device)
             for k, s in SHAPES.items()}
    return params, grads


@pytest.mark.parametrize("dtype,mu_dtype", [
    (torch.float32, None), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
def test_cpu_update_is_the_plain_version_and_launches_nothing(dtype,
                                                              mu_dtype):
    params, grads = _case(dtype)
    opt = optim.Adam(1e-2, mu_dtype=mu_dtype)
    p = {k: v.clone() for k, v in params.items()}
    state = opt.init(p)
    launches = _kernels.LAUNCHES[optim.KERNEL]
    with _kernels.record_calls() as rec:
        for count in (1, 2):
            opt.update(p, grads, state, count)
    assert _kernels.LAUNCHES[optim.KERNEL] == launches
    # one call a group and update; the unused parameter left out of it
    mu_dtype = mu_dtype or dtype
    shapes = tuple(s for k, s in SHAPES.items() if k != "unused")
    assert rec.calls == {(optim.KERNEL, (shapes, dtype, mu_dtype)): 2}

    # the same two updates through the foreach passes by hand
    ref = optim.Adam(1e-2, mu_dtype=mu_dtype)
    q = {k: v.clone() for k, v in params.items()}
    ref_state = ref.init(q)
    names = [k for k in SHAPES if k != "unused"]
    for count in (1, 2):
        ref.set_count(q, ref_state, count)
        ref._foreach_update([q[k] for k in names], [grads[k] for k in names],
                            [ref_state["mu"][k] for k in names],
                            [ref_state["nu"][k] for k in names],
                            *ref.bias_corrections[(dtype, mu_dtype)])
    for k in SHAPES:
        assert torch.equal(p[k], q[k])
        assert torch.equal(state["mu"][k], ref_state["mu"][k])
        assert torch.equal(state["nu"][k], ref_state["nu"][k])
    assert torch.equal(p["unused"], params["unused"])
    assert not state["mu"]["unused"].any() and not state["nu"]["unused"].any()


def test_force_reference_sends_any_device_to_the_plain_version(monkeypatch):
    """Off the CPU the dispatcher launches the kernel; under
    ``force_reference`` it runs the foreach passes instead (here on the
    meta device, which has no kernel: outside the context it raises)."""
    def no_kernel(*args):
        raise AssertionError("the kernel was called")
    monkeypatch.setattr(optim, "multi_tensor_adam", no_kernel)
    params, grads = _case(torch.float32, "meta")
    opt = optim.Adam(1e-3)
    state = opt.init(params)
    with pytest.raises(ValueError, match="no path for device meta"):
        opt.update(params, grads, state, 1)
    calls = _kernels.CALLS[optim.KERNEL]
    with _kernels.force_reference():
        opt.update(params, grads, state, 2)
    assert _kernels.CALLS[optim.KERNEL] == calls + 1


def test_groups_by_dtype_each_one_call():
    """Parameters of two dtypes make two groups: one dispatcher call (one
    launch on the card) each."""
    params = {"w": torch.zeros(4), "h": torch.zeros(6, dtype=torch.bfloat16)}
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    opt = optim.Adam(1e-3)
    with _kernels.record_calls() as rec:
        opt.update(params, grads, opt.init(params), 1)
    assert rec.calls == {
        (optim.KERNEL, (((4,),), torch.float32, torch.float32)): 1,
        (optim.KERNEL, (((6,),), torch.bfloat16, torch.bfloat16)): 1}


def _walk(plan, numels, vector, threads):
    """Elements each tensor receives when every launch of ``plan`` runs as
    the kernel walks it: ``threads`` threads in a grid stride over the
    launch's units, each finding its first tensor by binary search over the
    starts and then moving forward; a unit is ``vector`` elements, fewer at
    a tensor's ragged tail."""
    seen = [np.zeros(n, np.int64) for n in numels]
    for entries, units in plan:
        starts = [s for _, s in entries]
        for tid in range(threads):
            u = tid
            if u >= units:
                continue
            lo, hi = 0, len(entries) - 1
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if starts[mid] <= u:
                    lo = mid
                else:
                    hi = mid - 1
            i = lo
            while u < units:
                while i + 1 < len(entries) and starts[i + 1] <= u:
                    i += 1
                index, start = entries[i]
                e = (u - start) * vector
                left = numels[index] - e
                assert left > 0
                seen[index][e:e + min(left, vector)] += 1
                u += threads
    return seen


@pytest.mark.parametrize("vector", [4, 8])
@pytest.mark.parametrize("max_tensors", [1, 3, 600])
@pytest.mark.parametrize("threads", [1, 5, 64])
def test_launch_plan_covers_every_element_once(vector, max_tensors, threads):
    rng = np.random.default_rng(vector * 1000 + max_tensors + threads)
    numels = [1, 0, 13, 8, 7, 4096 + 3, 0, 2, 33 * 7, 64] + list(
        rng.integers(0, 300, 12))
    plan = optim.launch_plan(numels, vector, max_tensors)
    indices = [i for entries, _ in plan for i, _ in entries]
    assert indices == [i for i, n in enumerate(numels) if n]  # in order
    for entries, units in plan:
        assert 1 <= len(entries) <= max_tensors
        counts = [-(-numels[i] // vector) for i, _ in entries]
        assert [s for _, s in entries] == list(np.cumsum([0] + counts[:-1]))
        assert units == sum(counts)
    # only the last launch may hold fewer than the most
    assert all(len(e) == max_tensors for e, _ in plan[:-1])
    for n, got in zip(numels, _walk(plan, numels, vector, threads)):
        assert len(got) == n and (got == 1).all()


def test_launch_plan_splits_only_above_the_limit():
    numels = [10] * 600
    assert len(optim.launch_plan(numels, 8, 600)) == 1
    plan = optim.launch_plan(numels + [10], 8, 600)
    assert [len(e) for e, _ in plan] == [600, 1]
    assert plan[1] == ([(600, 0)], 2)
    assert optim.launch_plan([0, 0], 8, 600) == []
    with pytest.raises(ValueError):
        optim.launch_plan([1], 0, 600)


@pytest.mark.parametrize("bad", ["device", "pair", "lengths"])
def test_launcher_refuses_before_it_launches(bad):
    """The wrapper's checks raise on the CPU, before the library is asked
    for (no nvcc here)."""
    p = torch.zeros(16)
    bc = torch.ones(())
    args = dict(params=[p], grads=[p], mus=[p], nus=[p], bc1=bc, bc2=bc)
    if bad == "pair":
        args.update(params=[p.half()], grads=[p.half()], mus=[p.half()],
                    nus=[p.half()])
        match = "kernel takes"
    elif bad == "lengths":
        args.update(grads=[])
        match = "equally long"
    else:
        match = "needs CUDA"
    scalars = optim.Adam(1e-3).scalars(torch.float32, torch.float32)
    with pytest.raises(ValueError, match=match):
        optim.multi_tensor_adam(*args.values(), scalars)


def test_scalars_are_rounded_per_group():
    opt = optim.Adam(1e-5)
    b1_mu, a1, b2, a2, eps, neg_lr = opt.scalars(torch.float32,
                                                 torch.bfloat16)
    assert b1_mu == 0.8984375                       # b1 in bf16
    assert b2 == float(np.float32(0.999))
    assert neg_lr == float(np.float32(-1e-5))
    full = opt.scalars(torch.bfloat16, torch.bfloat16)
    assert full[2] == 1.0                           # b2 in bf16
    assert collections.Counter(type(x) for x in full) == {float: 6}
