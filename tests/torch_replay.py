"""The CPU's stand-in for CUDA graphs under ``utils/jit.py``
(``ReplayGraphs``), shared by the CPU tests of compiled programs and their
worker processes. Imports torch and the port only.
"""

import collections

import torch
from torch.utils import _pytree as pytree

from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.utils import jit as J


class ReplayGraphs(J.CudaGraphs):
    """The CPU's stand-in for ``torch.cuda.CUDAGraph`` under ``utils/jit.py``
    (``jit.BACKEND``): its capture runs the function once on the static
    inputs (as a capture records it), its replay runs it again and writes
    the result into the captured outputs in place (as a replay rewrites the
    graph's memory), with the package's launch counters left as they were
    (a replay runs no Python).

    A real capture runs nothing: the tensors a program updates in place
    (``donated``) keep their values and the registered generators their
    state. So this capture puts both back after its run. A replay draws
    from each generator's state at that time, as the card's replay does.

    It captures over any process group (gloo on the CPU), as the card's
    backend does over NCCL: a sharded program's compiled path runs here,
    its collectives run again at each replay, and every rank of the group
    replays, so they meet."""

    def __init__(self):
        self.captures = 0

    def applies(self, tensors):
        return True

    def captures_over(self, group):
        return True

    def new_pool(self, device):
        return None

    def warmup(self, device, call):
        call()

    def release_generators(self, device, generators=()):
        pass

    def capture(self, device, pool, call, generators=(), donated=()):
        self.captures += 1
        with torch.no_grad():
            kept = [t.clone() for t in donated]
        states = [g.get_state() for g in generators]
        out = call()
        with torch.no_grad():
            for t, k in zip(donated, kept):
                t.copy_(k)
        for g, s in zip(generators, states):
            g.set_state(s)
        return _Replay(call, out), out


class _Replay:
    def __init__(self, call, out):
        self.call, self.out = call, out
        self.replays = 0

    def replay(self):
        self.replays += 1
        before = [collections.Counter(c) for c in _kernels.counters()]
        with J._nested():                  # what it runs is the graph's
            new = self.call()
        for c, b in zip(_kernels.counters(), before):
            c.clear()
            c.update(b)
        with torch.no_grad():
            for old, fresh in zip(pytree.tree_leaves(self.out),
                                  pytree.tree_leaves(new)):
                if isinstance(old, torch.Tensor):
                    old.copy_(fresh)
