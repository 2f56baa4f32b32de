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
graph of one ``jit`` shares one memory pool (``share_pool``: several jits'
graphs too). Each call copies its inputs
into the buffers, replays the graph (between two CUDA events:
``replay_ms``) and returns a copy of every tensor of the output (JAX
returns fresh arrays: without the copies, a result the caller holds would
be overwritten by the next replay). The whole call runs under
``torch.inference_mode``: the programs are forward only, and an input that
requires grad with grad mode on raises.

A program that trains, ``jit(step, donate_argnums=0, generators=(g,),
grad=True)``, is the counterpart of ``jax.jit(step, donate_argnums=(0,))``:

  - ``grad``: ``fn`` runs with grad mode on (``torch.autograd.grad``
    inside it), not under ``inference_mode``, and its static buffers are
    ordinary tensors;
  - ``donate_argnums``: those arguments are trees of tensors that ``fn``
    updates in place (the parameters and Adam's moments). They are keyed
    by the identity of each tensor, and read and written where they lie,
    never copied into a static buffer: a ``load_state_dict`` that copies
    into them is seen by the next replay (a tensor put in another's place
    is another key). The compile's warm-up takes a step, so it is undone:
    the donated tensors and the generators go back to what they held
    before it, and the first call replays the new graph as every later one
    does. N calls take N steps, all of them the graph's (cuDNN may give up,
    inside a capture, an algorithm the warm-up ran, and keep the one it
    captured for the later eager calls too);
  - ``generators``: the ``torch.Generator`` s ``fn`` draws from (dropout).
    Each capture registers them (``CUDAGraph.register_generator_state``),
    so a replay draws from each one's state at replay time (a
    ``manual_seed`` on the host before the call) and advances it as far as
    the eager call would: the same draws, bit for bit.

A host scalar that changes from call to call (a step number, a seed, Adam's
bias corrections) must not be an argument: a hashable argument is part of
the key, one graph per value, and it is baked into that graph. It goes into
a generator's state or into a device tensor that the host fills before the
call.

Each call is the host span ``jit.<name>`` (``utils/profiling.span``):
the eager run, or the input copies, the replay and the output clones.

A capture that fails raises, naming the last torch function it reached
(an ``.item()`` or a host-to-device copy from pageable memory cannot be
captured: a host sync ends a capture); it never falls back to eager.

A sharded program, ``jit(fn, groups=(g, ...))``, is the counterpart of a
``jax.jit`` over a mesh: ``fn`` calls collectives over those process
groups (the gradient all-reduce, the model axis's all-reduces, all-to-alls,
all-gathers and ring exchanges, ``parallel/``), and they go into its graph.
Whether a group's collectives can be captured is the backend's decision
(``CudaGraphs.captures_over``): NCCL's run as kernels on the card and can;
gloo's run on the host (and the ring's exchange stages through host
memory), so a key over a gloo group runs ``fn`` eagerly, by that rule,
decided before any capture and said once a ``jit`` (``RULED_EAGER`` counts
such calls by name). Every rank of a group must call its programs with the
same keys in the same order: a rank's compile warms up eagerly (which
creates the group's NCCL communicators and the ring's peer connections,
outside any capture) while the others warm up too, and their replays then
meet as their eager calls would.

Eager (``fn`` as it is) instead of a graph:

  - inside ``disable_jit()`` (the comparisons of compiled against eager);
  - inside ``_kernels.force_reference`` or ``_kernels.record_calls``: both
    act on the dispatchers, which a replay does not run;
  - inside another ``jit``'s compile (nested: its ops join the outer graph,
    as an inner ``jax.jit`` is inlined into the outer trace);
  - where no argument is a CUDA tensor (the CPU: what the caller asked for);
  - over a process group the backend cannot capture over (gloo).

Launch accounting: ``_kernels.LAUNCHES``, ``_kernels.CALLS``, both
dispatchers' launches by body, ``multihost.COLLECTIVES`` and
``attention.TP_ROUTES`` are host counters (``_kernels.counters``), which a
replay would not move. The counts a capture saw are taken out of the
counters and kept with its graph, and each replay adds them once, so a
replayed request or step counts what the same one counts eagerly. The
warm-up's launches are the compile's, not a request's: they are taken out
too and kept in ``COMPILES`` with the compile's seconds.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import inspect
import threading
import time
import warnings

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.overrides import TorchFunctionMode

from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.utils import profiling

# One record per compile: the jit's name, the key's tensor shapes, seconds
# of warm-up and capture, the warm-up's and the graph's launches, and the
# graph's all-reduces and sharded-attention routes (a sharded program's).
COMPILES: list = []
# Calls run eagerly because a group of the program's is one the backend
# cannot capture over, by jit name.
RULED_EAGER: collections.Counter = collections.Counter()
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

    def captures_over(self, group) -> bool:
        """Whether collectives over the process group ``group`` can go into
        a graph: NCCL's launch kernels on the card's stream; gloo's compute
        and synchronise on the host, which a capture cannot hold."""
        return dist.get_backend(group) == "nccl"

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

    def release_generators(self, device, generators=()):
        """After a failed capture: a capture enrols the device's default
        generator and the registered ones, and an ended capture that failed
        leaves them enrolled (a next draw outside a capture raises). A
        fresh state of the same seed and offset frees each."""
        if device.type == "cuda":
            index = (device.index if device.index is not None
                     else torch.cuda.current_device())
            for gen in (torch.cuda.default_generators[index], *generators):
                gen.graphsafe_set_state(gen.clone_state())

    def capture(self, device, pool, call, generators=(), donated=()):
        """``(graph, output)`` of ``call`` captured on ``device``, with
        ``generators`` registered. A capture runs nothing, so the
        ``donated`` tensors (those ``call`` updates in place) keep their
        values. Python's cyclic collector is held off while it lasts: an
        object that owns another graph (an ``SDPipeline`` and its jits form
        a cycle) freed by a collection inside the capture destroys that
        graph, which a capturing stream does not permit, and the capture
        fails; the collector frees it after."""
        graph = torch.cuda.CUDAGraph(keep_graph=self.debug)
        for gen in generators:
            graph.register_generator_state(gen)
        if self.debug:
            graph.enable_debug_mode()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(device):
                with torch.cuda.graph(graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    out = call()
                if self.debug:
                    graph.instantiate()
        finally:
            if collecting:
                gc.enable()
        return graph, out


BACKEND = CudaGraphs()


def compilable(groups=()) -> bool:
    """Whether a program whose collectives run over ``groups`` (None
    entries: no group) can be captured by ``BACKEND``: a caller's decision
    made the way ``jit`` makes it."""
    return all(BACKEND.captures_over(g) for g in groups if g is not None)


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
    __slots__ = ("graph", "device", "inputs", "out", "counts", "keep")

    def __init__(self, graph, device, inputs, out, counts, keep):
        self.graph, self.device, self.inputs, self.out = (graph, device,
                                                          inputs, out)
        self.counts, self.keep = counts, keep


class jit:
    """``fn`` compiled per key (module docstring)."""

    def __init__(self, fn, static_argnames=(), name: str | None = None,
                 donate_argnums=(), generators=(), grad: bool = False,
                 groups=()):
        self.fn = fn
        self.groups = tuple(g for g in groups if g is not None)
        self._said = False      # the eager-by-rule notice, once
        self.donate = frozenset((donate_argnums,)
                                if isinstance(donate_argnums, int)
                                else donate_argnums)
        self.generators = tuple(generators)
        self.grad = grad
        self._events = None     # CUDA events around the last replay
        self.name = name or getattr(fn, "__qualname__", repr(fn))
        self._span = f"jit.{self.name}"
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
        self._pool_of = self    # the jit whose memory pool this one's use
        functools.update_wrapper(self, fn, updated=())

    def share_pool(self, other: "jit") -> "jit":
        """Capture this jit's graphs into ``other``'s memory pool: programs
        that run one after another on one stream (a trainer's step, eval
        and FVD batch) then hold one pool between them. Each call clones
        its outputs before the next replay can reuse that memory."""
        self._pool_of = other._pool_of
        return self

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
        with profiling.span(self._span):
            return self._call(args, kwargs)

    def _call(self, args, kwargs):
        if self.eager():
            return self.fn(*args, **kwargs)
        slots = [(i, a) for i, a in enumerate(args)] + sorted(kwargs.items())
        tensors = ([a for _, a in self._inputs(slots)]
                   + self._donated_leaves(slots))
        if not tensors or not BACKEND.applies(tensors):
            return self.fn(*args, **kwargs)
        if not compilable(self.groups):
            return self._ruled_eager(args, kwargs)
        key = tuple(self._key_of(where, a) for where, a in slots)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._compile(key, args, kwargs)
        with self._mode():
            for buf, (where, a) in zip(entry.inputs, self._inputs(slots)):
                buf.copy_(a)
            timed = entry.device.type == "cuda"
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

    def _ruled_eager(self, args, kwargs):
        """``fn`` as it is: a group of its collectives is one the backend
        cannot capture over (module docstring)."""
        RULED_EAGER[self.name] += 1
        if not self._said:
            self._said = True
            backends = sorted({str(dist.get_backend(g)) for g in self.groups
                               if not BACKEND.captures_over(g)})
            warnings.warn(f"jit({self.name}): runs eagerly: its collectives "
                          f"run over a {'/'.join(backends)} process group, "
                          f"which a CUDA graph cannot hold", stacklevel=4)
        return self.fn(*args, **kwargs)

    def _mode(self):
        """What a call's copies and replay run under: no autograd."""
        return torch.no_grad() if self.grad else torch.inference_mode()

    def _static(self, where) -> bool:
        name = where if isinstance(where, str) else next(
            (n for n, i in self._positions.items() if i == where), None)
        return name in self.static_argnames

    def _donated(self, where) -> bool:
        return (where if isinstance(where, int)
                else self._positions.get(where)) in self.donate

    def _donated_leaves(self, slots) -> list:
        return [t for w, a in slots if self._donated(w)
                for t in pytree.tree_leaves(a) if isinstance(t, torch.Tensor)]

    def _key_of(self, where, a):
        if self._donated(where):
            return (where, "donated", tuple(
                id(t) for t in pytree.tree_leaves(a)
                if isinstance(t, torch.Tensor)))
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
                if isinstance(a, torch.Tensor) and not self._static(w)
                and not self._donated(w)]

    def _compile(self, key, args, kwargs) -> _Graph:
        slots = [(i, a) for i, a in enumerate(args)] + sorted(kwargs.items())
        inputs = self._inputs(slots)
        donated = self._donated_leaves(slots)
        devices = {a.device for _, a in inputs} | {t.device for t in donated}
        if len(devices) != 1:
            raise ValueError(f"jit({self.name}): inputs on "
                             f"{sorted(map(str, devices))}: move every "
                             f"input to one device before the call (a copy "
                             f"from the host cannot be captured)")
        (device,) = devices
        t0 = time.perf_counter()
        with self._mode():
            bufs = [torch.empty_like(a).copy_(a) for _, a in inputs]
        static = dict(zip((w for w, _ in inputs), bufs))
        call_args = [static.get(i, a) for i, a in enumerate(args)]
        call_kwargs = {k: static.get(k, a) for k, a in kwargs.items()}

        def call():
            with (torch.enable_grad() if self.grad
                  else torch.inference_mode()):
                return self.fn(*call_args, **call_kwargs)

        with torch.no_grad():
            kept = [t.clone() for t in donated]
        states = [g.get_state() for g in self.generators]
        before = _snapshot()
        with _nested():
            BACKEND.warmup(device, call)
        warm_counts = _since(before)
        with torch.no_grad():       # undo the warm-up's step
            for t, k in zip(donated, kept):
                t.copy_(k)
        del kept
        for g, st in zip(self.generators, states):
            g.set_state(st)
        t1 = time.perf_counter()
        owner = self._pool_of
        if owner._pool is None:
            owner._pool = BACKEND.new_pool(device)
        mid = _snapshot()
        last = _LastOp()

        def traced():
            with last:
                return call()
        try:
            with _nested():
                graph, out = BACKEND.capture(device, owner._pool, traced,
                                             self.generators, donated)
        except Exception as e:
            _take_out(_since(before))
            BACKEND.release_generators(device, self.generators)
            raise RuntimeError(f"jit({self.name}): the capture failed after "
                               f"{last.name()}: {type(e).__name__}: {e}") \
                from e
        counts = _since(mid)
        _take_out(counts)
        _take_out(warm_counts)
        entry = _Graph(graph, device, bufs, out, counts,
                       keep=[a for (_, a), k in zip(slots, key)
                             if k[1] == "id"] + donated)
        self._graphs[key] = entry
        COMPILES.append(dict(
            name=self.name, shapes=[list(b.shape) for b in bufs],
            warmup_s=t1 - t0, capture_s=time.perf_counter() - t1,
            warmup_launches=dict(warm_counts[0]),
            graph_launches=dict(counts[0]),
            graph_collectives=dict(counts[4]), graph_routes=dict(counts[5])))
        return entry
