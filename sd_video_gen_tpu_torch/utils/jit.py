"""One compiled program per input signature: the port's counterpart of
``jax.jit`` and ``jax.disable_jit``.

``jit(fn, static_argnames=...)`` returns a callable that runs ``fn`` as a
captured CUDA graph when its tensors are on the card, one graph per key, as
``jax.jit`` keeps one executable per shape. The key holds, for each
positional and keyword argument:

  - a tensor: its shape, dtype, device and strides (an *input*: its values
    change from call to call);
  - a name in ``static_argnames``, or any other hashable value (a number, a
    string, None): the value itself, baked into the graph;
  - anything else (a module, a parameter tree): its identity. The graph
    reads that object's tensors where they lay at capture, so an in-place
    update (``load_state_dict``) is seen by later replays and a tensor put
    in another's place is not.

A key's first call is its compile: a static buffer is made for each input
(the argument's strides, outside the graphs' memory), ``fn`` runs once
eagerly on those buffers on a side stream (the warm-up: cuBLAS and cuDNN
handles, ``nhwc_plan``'s cache, the flash kernel's TMA encoder, the
refiner's noise draws), and then it is captured into a ``CUDAGraph``. Every
graph of one ``jit`` shares one memory pool. Each call copies its inputs
into the buffers, replays the graph (between two CUDA events:
``replay_ms``) and returns a copy of every tensor of the output (JAX
returns fresh arrays: without the copies, a result the caller holds would
be overwritten by the next replay). The whole call runs under
``torch.inference_mode``: the programs are forward only, and an input that
requires grad with grad mode on raises.

A capture that fails raises, naming the last torch function it reached
(an ``.item()`` or a host-to-device copy from pageable memory cannot be
captured: a host sync ends a capture); it never falls back to eager.

Eager (``fn`` as it is) instead of a graph:

  - inside ``disable_jit()`` (the comparisons of compiled against eager);
  - inside ``_kernels.force_reference`` or ``_kernels.record_calls``: both
    act on the dispatchers, which a replay does not run;
  - inside another ``jit``'s compile (nested: its ops join the outer graph,
    as an inner ``jax.jit`` is inlined into the outer trace);
  - where no argument is a CUDA tensor (the CPU: what the caller asked for).

Launch accounting: ``_kernels.LAUNCHES``, ``_kernels.CALLS`` and both
dispatchers' launches by body are host counters, which a replay would not
move. The counts a capture saw are taken out of the counters and kept with
its graph, and each replay adds them once, so a replayed request counts
what the same request counts eagerly. The warm-up's launches are the
compile's, not a request's: they are taken out too and kept in
``COMPILES`` with the compile's seconds.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import inspect
import threading
import time

import torch
from torch.utils import _pytree as pytree
from torch.overrides import TorchFunctionMode

from sd_video_gen_tpu_torch.ops import _kernels

# One record per compile: the jit's name, the key's tensor shapes, seconds
# of warm-up and capture, and the warm-up's and the graph's launches.
COMPILES: list = []
_DISABLED: list = []
_LOCAL = threading.local()


class disable_jit:
    """Context manager: every ``jit`` in this process runs eagerly inside."""

    def __enter__(self):
        _DISABLED.append(True)
        return self

    def __exit__(self, *exc):
        _DISABLED.pop()
        return False


def _compiling() -> bool:
    return getattr(_LOCAL, "depth", 0) > 0


@contextlib.contextmanager
def _nested():
    _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
    try:
        yield
    finally:
        _LOCAL.depth -= 1


class _LastOp(TorchFunctionMode):
    """Notes the last torch function called under it (``Tensor.item``,
    ``conv2d``, ...): the op a failed capture names."""

    def __init__(self):
        super().__init__()
        self.op = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.op = func
        return func(*args, **(kwargs or {}))

    def name(self) -> str:
        if self.op is None:
            return "(no torch function yet)"
        return getattr(self.op, "__qualname__", None) or repr(self.op)


class CudaGraphs:
    """How ``jit`` warms up, captures and replays on the card. The CPU
    tests put a stand-in in its place (``BACKEND``). With ``debug`` set, a
    new graph keeps its ``cudaGraph_t`` for ``CUDAGraph.debug_dump``."""

    debug = False

    def applies(self, tensors) -> bool:
        return any(t.is_cuda for t in tensors)

    def new_pool(self, device):
        with torch.cuda.device(device):
            return torch.cuda.graph_pool_handle()

    def warmup(self, device, call):
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                call()
            torch.cuda.current_stream().wait_stream(side)

    def release_generators(self, device):
        """After a failed capture: a capture enrols the device's default
        generator, and an ended capture that failed leaves it enrolled (its
        next draw outside a capture raises). A fresh state of the same seed
        and offset frees it."""
        if device.type == "cuda":
            index = (device.index if device.index is not None
                     else torch.cuda.current_device())
            gen = torch.cuda.default_generators[index]
            gen.graphsafe_set_state(gen.clone_state())

    def capture(self, device, pool, call):
        """``(graph, output)`` of ``call`` captured on ``device``."""
        graph = torch.cuda.CUDAGraph(keep_graph=self.debug)
        if self.debug:
            graph.enable_debug_mode()
        with torch.cuda.device(device):
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                out = call()
            if self.debug:
                graph.instantiate()
        return graph, out


BACKEND = CudaGraphs()


def _snapshot() -> list:
    return [collections.Counter(c) for c in _kernels.counters()]


def _since(before: list) -> list:
    return [c - b for c, b in zip(_kernels.counters(), before)]


def _take_out(counts: list) -> None:
    with _kernels._LOCK:
        for c, d in zip(_kernels.counters(), counts):
            c.subtract(d)
            for k in [k for k, n in c.items() if n == 0]:
                del c[k]


def _add(counts: list) -> None:
    with _kernels._LOCK:
        for c, d in zip(_kernels.counters(), counts):
            c.update(d)


class _Graph:
    __slots__ = ("graph", "inputs", "out", "counts", "keep")

    def __init__(self, graph, inputs, out, counts, keep):
        self.graph, self.inputs, self.out = graph, inputs, out
        self.counts, self.keep = counts, keep


class jit:
    """``fn`` compiled per key (module docstring)."""

    def __init__(self, fn, static_argnames=(), name: str | None = None):
        self.fn = fn
        self._events = None     # CUDA events around the last replay
        self.name = name or getattr(fn, "__qualname__", repr(fn))
        self.static_argnames = frozenset((static_argnames,)
                                         if isinstance(static_argnames, str)
                                         else static_argnames)
        try:
            params = list(inspect.signature(fn).parameters.values())
        except (TypeError, ValueError):
            params = []
        self._positions = {p.name: i for i, p in enumerate(params)
                           if p.kind in (p.POSITIONAL_ONLY,
                                         p.POSITIONAL_OR_KEYWORD)}
        self._graphs: dict = {}
        self._pool = None
        functools.update_wrapper(self, fn, updated=())

    @property
    def n_graphs(self) -> int:
        """Graphs held: one per key seen."""
        return len(self._graphs)

    def replay_ms(self) -> float | None:
        """Device milliseconds of the last replay on the card, from CUDA
        events recorded around it (None before one); waits for it to
        end."""
        if self._events is None:
            return None
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1])

    def graphs(self) -> list:
        """The graphs held, in the order their keys were first seen."""
        return [g.graph for g in self._graphs.values()]

    def eager(self) -> bool:
        """True where a call now runs ``fn`` as it is (module docstring)."""
        return bool(_DISABLED or _compiling() or _kernels.forced()
                    or _kernels.recording())

    def __call__(self, *args, **kwargs):
        if self.eager():
            return self.fn(*args, **kwargs)
        slots = [(i, a) for i, a in enumerate(args)] + sorted(kwargs.items())
        tensors = [a for _, a in self._inputs(slots)]
        if not tensors or not BACKEND.applies(tensors):
            return self.fn(*args, **kwargs)
        key = tuple(self._key_of(where, a) for where, a in slots)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._compile(key, args, kwargs)
        with torch.inference_mode():
            for buf, (where, a) in zip(entry.inputs, self._inputs(slots)):
                buf.copy_(a)
            timed = entry.inputs[0].is_cuda
            if timed:
                self._events = [torch.cuda.Event(enable_timing=True)
                                for _ in range(2)]
                self._events[0].record()
            entry.graph.replay()
            if timed:
                self._events[1].record()
            _add(entry.counts)
            return pytree.tree_map(
                lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                entry.out)

    def _static(self, where) -> bool:
        name = where if isinstance(where, str) else next(
            (n for n, i in self._positions.items() if i == where), None)
        return name in self.static_argnames

    def _key_of(self, where, a):
        if isinstance(a, torch.Tensor) and not self._static(where):
            if torch.is_grad_enabled() and a.requires_grad:
                raise ValueError(f"jit({self.name}): argument {where} "
                                 f"requires grad; a compiled program is "
                                 f"forward only")
            return (where, "tensor", tuple(a.shape), a.dtype, a.device,
                    a.stride())
        try:
            hash(a)
        except TypeError:
            return (where, "id", id(a))
        return (where, "value", type(a), a)

    def _inputs(self, slots):
        return [(w, a) for w, a in slots
                if isinstance(a, torch.Tensor) and not self._static(w)]

    def _compile(self, key, args, kwargs) -> _Graph:
        slots = [(i, a) for i, a in enumerate(args)] + sorted(kwargs.items())
        inputs = self._inputs(slots)
        devices = {a.device for _, a in inputs}
        if len(devices) != 1:
            raise ValueError(f"jit({self.name}): inputs on "
                             f"{sorted(map(str, devices))}: move every "
                             f"input to one device before the call (a copy "
                             f"from the host cannot be captured)")
        (device,) = devices
        t0 = time.perf_counter()
        with torch.inference_mode():
            bufs = [torch.empty_like(a).copy_(a) for _, a in inputs]
        static = dict(zip((w for w, _ in inputs), bufs))
        call_args = [static.get(i, a) for i, a in enumerate(args)]
        call_kwargs = {k: static.get(k, a) for k, a in kwargs.items()}

        def call():
            with torch.inference_mode():
                return self.fn(*call_args, **call_kwargs)

        before = _snapshot()
        with _nested():
            BACKEND.warmup(device, call)
        warm_counts = _since(before)
        t1 = time.perf_counter()
        if self._pool is None:
            self._pool = BACKEND.new_pool(device)
        mid = _snapshot()
        last = _LastOp()

        def traced():
            with last:
                return call()
        try:
            with _nested():
                graph, out = BACKEND.capture(device, self._pool, traced)
        except Exception as e:
            _take_out(_since(before))
            BACKEND.release_generators(device)
            raise RuntimeError(f"jit({self.name}): the capture failed after "
                               f"{last.name()}: {type(e).__name__}: {e}") \
                from e
        counts = _since(mid)
        _take_out(counts)
        _take_out(warm_counts)
        entry = _Graph(graph, bufs, out, counts,
                       keep=[a for (_, a), k in zip(slots, key)
                             if k[1] == "id"])
        self._graphs[key] = entry
        COMPILES.append(dict(
            name=self.name, shapes=[list(b.shape) for b in bufs],
            warmup_s=t1 - t0, capture_s=time.perf_counter() - t1,
            warmup_launches=dict(warm_counts[0]),
            graph_launches=dict(counts[0])))
        return entry
