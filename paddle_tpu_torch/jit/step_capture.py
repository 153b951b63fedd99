"""Whole-step capture: a training step (forward, backward, clip, optimizer
update) as ONE CUDA graph, replayed.

Counterpart of ``paddle_tpu/jit/step_capture.py``: ``jit_step`` (:930),
``CapturedStep``, ``CaptureAbort``, ``capture_counters`` and the frozen
``FALLBACK_REASONS`` (:119, string for string). The reference traces the
step into one donated XLA executable; here the step the user wrote runs
eagerly once more under ``torch.cuda.graph`` and the graph is replayed.

Lifecycle per key (the args' shapes, dtypes and devices, their static
leaves, the state's structure, the flags):

1. **probe** -- the step runs eagerly, instrumented: ``Optimizer.step``
   and ``LRScheduler.step`` report themselves (``optimizer._PROBE``,
   ``lr._PROBE``), tensor hooks, ``create_graph`` and functional
   ``grad()`` are watched, and each argument's version counter tells
   whether the step mutated it;
2. **warm-up** -- the next call runs the step over static input buffers
   under the capture context (``optimizer._CAPTURE``), on a side stream,
   so every ``_build.load`` and each kernel's one-time
   ``cudaFuncSetAttribute`` happen before the capture; the fused
   optimizer's launches record the size of each chunk table they use.
   This run is the call's step: its outputs are returned;
3. **capture** -- the same body runs once more inside a CUDA graph capture
   (:func:`capture_graph`, which the serving engine shares; nothing
   executes); the host state it moved (step counts, schedulers, launch
   counters) is rolled back;
4. **replay** -- each later call copies its args into the static buffers,
   refreshes the lr scalars on the host's stream (outside the graph),
   replays, re-applies the recorded host effects (optimizer step-count
   deltas, no-arg scheduler advances, launch counts) and returns
   **clones** of the static outputs, which the next replay overwrites.

What the graph needs from the code it runs, and what the port does:

- the lr and the step scalar: the optimizer reads them from persistent
  device scalars. The lr is refilled before each replay from the host
  scheduler; the step is a device counter the graph advances itself (by
  ``1 - found`` under the anomaly sentinel or a GradScaler), refilled
  from the host count only when that count moved otherwise;
- no host sync: the sentinel's and the GradScaler's skip stay on the
  device, and ``Optimizer.consume_anomaly()`` reconciles the host step
  count, as the reference's cumulative-skip channel does;
- the grads: a step that clears what it steps (it starts and ends with
  every grad None, as ``TrainStep`` without accumulation and ``Model.fit``
  do) gets them from the graph's pool, as the eager step gets them from
  the cache, and nothing holds them between replays. Any other step (a
  micro step of an accumulation window) keeps them in storage made before
  the warm-up, which ``clear_grad()`` under capture zeroes in place, so
  the backward accumulates into the same addresses every replay;
- the fused optimizer's chunk tables hold grad addresses: each launch in
  the capture takes a table allocated before it (outside the pool, whose
  memory earlier nodes reuse), whose rows are written after the capture
  ends from the addresses the capture used; the graph owns its tables,
  so no rebuild of a bucket's table by a later eager step frees them,
  and an upload while a capture is active raises;
- state updated in place (parameters, moments, BatchNorm statistics, the
  GradScaler's scale) replays correctly; a step that REBINDS a tensor
  attribute, or reads its batch from a closure instead of its arguments,
  replays the capture's tensors (the reference's closure contract);
- autograd graphs must not outlive the step: a grad accumulator carries
  the CUDA stream it was made on, and one kept alive from eager work on
  the legacy stream (a loss a module stores) ties the captured backward
  to that stream ("trace failed"). The probe, the warm-up and the capture
  run on one side stream, so the step's own nodes agree;
- dropout's generator: every graph registers the port's generator for
  the card (``nn.initializer.default_generator``: the ``dropout``,
  attention-dropout and ``gumbel_softmax`` ops draw from it when no
  layer's generator is passed); pass others as ``jit_step(fn,
  generators=...)`` (``TrainStep`` and ``hapi.Model`` pass their
  network's ``Dropout`` generators; a CPU generator among them is not
  registered).
  An unregistered one fails the capture ("trace failed").

Unfusable steps fall back to the eager path with a frozen reason:
tensor hooks, ``create_graph``, functional ``grad()``, an input that
requires grad, a scheduler stepped with an epoch or metric, an in-place
mutation of an argument, and any error during the warm-up's capture
checks or the capture itself ("trace failed", the CUDA error as detail:
a host sync such as ``.item()``, a data-dependent shape); running out
of device memory raises as it would eagerly. Shape changes
re-probe; a never-repeating stream trips the miss-streak breaker; the
entry cache is bounded (``_ENTRIES_MAX``). "statically screened" stays in
the frozen set and is never raised: the source screen is ROADMAP A9.
``strict=True`` (``jit.TrainStep``) raises on any fallback instead.

**On the CPU** there is no graph. A step whose state and arguments are
CPU tensors runs the same lifecycle with a stand-in for the replay: the
host state is snapshotted, the captured body re-runs over the same
static buffers under the capture context, the host state is restored,
and the recorded host effects are re-applied. Everything but the graph
itself runs in the CPU tests; a CUDA tensor never takes this path.
"""

from __future__ import annotations

import contextlib
import functools
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import flags
from ..core.tensor import paddle_call
from ..ops.kernels import _build
from ..nn.initializer import default_generator
from ..ops.kernels import fused_optimizer as fok
from ..optimizer import lr as lr_mod
from ..optimizer import optimizer as optimizer_mod

__all__ = ["jit_step", "CapturedStep", "CaptureAbort", "capture_counters",
           "FALLBACK_REASONS"]

# structure-cache bounds: each entry holds a whole-step graph and its
# pool, so the FIFO is small; the breaker stops a never-repeating stream
# of shapes from paying the probe every call
_ENTRIES_MAX = 8
_MISS_STREAK_MAX = 8
_PROBE_EVERY = 16

_PRIMED = object()

capture_counters = {"probes": 0, "captures": 0, "replays": 0,
                    "fallbacks": 0, "bypass": 0, "invalidations": 0,
                    "static_screened": 0}

# Frozen fallback-reason taxonomy, equal to the reference's string for
# string. Parameterized reasons carry the varying part in `detail`.
FALLBACK_REASONS = frozenset({
    "FLAGS_step_capture disabled",
    "unhashable static argument",
    "input argument requires grad (grads must land on the caller's "
    "tensor)",
    "LR scheduler stepped with an explicit epoch/metric argument",
    "step mutates an input argument in place",
    "ZeRO state sharding active on the optimizer",
    "optimizer.step() on an optimizer not seen during the discovery run",
    "learning rate changed mid-step (scheduler stepped before "
    "optimizer.step)",
    "step mutates a tensor outside the captured state set (stale "
    "discovery)",
    "tape has tensor hooks or structurally-unkeyed nodes "
    "(sot/to_static segments)",
    "backward(create_graph=True) inside a captured step",
    "functional grad() capture inside a captured step",
    "trace failed",
    "replay failed",
    "statically screened",
})

_HOOKS = "tape has tensor hooks or structurally-unkeyed nodes " \
         "(sot/to_static segments)"
_UNSEEN = "optimizer.step() on an optimizer not seen during the discovery run"

# True while a probe, warm-up, capture or stand-in replay runs: a
# jit_step called inside another one runs inline
_ACTIVE = False

# each parameter's grad storage under capture is kept on the parameter
# as this attribute, shared by every captured step that trains it
# (TrainStep's micro-step and update graphs)
_GRAD_ATTR = "_capture_grad"
# set on a parameter whose capture grad storage a captured step zeroed
_CLEAN_ATTR = "_capture_grad_clean"


def _static_grad(p) -> Optional[torch.Tensor]:
    return getattr(p, _GRAD_ATTR, None)


class CaptureAbort(Exception):
    """The step cannot be captured faithfully; ``reason`` is a
    ``FALLBACK_REASONS`` member, ``detail`` its parameterization."""

    def __init__(self, reason: str, detail: Optional[str] = None):
        super().__init__(reason if detail is None else f"{reason}: {detail}")
        self.reason = reason
        self.detail = detail


def _abort_in(exc: BaseException) -> Optional[CaptureAbort]:
    """The CaptureAbort an exception is, or was raised while handling."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        if isinstance(exc, CaptureAbort):
            return exc
        seen.add(id(exc))
        exc = exc.__context__ or exc.__cause__
    return None


# -- counters a replay re-applies ---------------------------------------------

_FUSED_ADDITIVE = ("updates", "fallbacks")


def _counter_state():
    return ([c.count for c in _build.COUNTERS],
            {k: optimizer_mod.fused_counters[k] for k in _FUSED_ADDITIVE})


def _counter_delta(before):
    now = _counter_state()
    return ([b - a for a, b in zip(before[0], now[0])],
            {k: now[1][k] - before[1][k] for k in _FUSED_ADDITIVE})


def _counter_restore(state) -> None:
    for c, n in zip(_build.COUNTERS, state[0]):
        c.count = n
    optimizer_mod.fused_counters.update(state[1])


def _counter_add(delta) -> None:
    for c, n in zip(_build.COUNTERS, delta[0]):
        c.count += n
    for k, n in delta[1].items():
        optimizer_mod.fused_counters[k] += n


_POOL_CALLS = ("_cuda_endAllocateToPool", "_cuda_releasePool")


def _abandon_capture(pool) -> None:
    """Clean up after a capture that ended in an error. Its end raised
    before it told the caching allocator the capture was over, so the
    allocator would keep a capture "underway" (and, while one is, never
    return its cache to the card on an out-of-memory retry): end the
    graph's pool routing and release the pool. Torch has no public call
    for this; a build without the two private ones raises here rather
    than leave the allocator routing to a dead pool."""
    missing = [n for n in _POOL_CALLS if not hasattr(torch._C, n)]
    if missing:
        raise RuntimeError(
            f"step capture: this torch build lacks torch._C."
            f"{' and torch._C.'.join(missing)}, so a failed capture cannot "
            f"release its memory pool")
    end, release = (getattr(torch._C, n) for n in _POOL_CALLS)
    dev = torch.cuda.current_device()
    try:
        end(dev, pool)
    except RuntimeError as e:
        # the capture's end got as far as ending the routing itself
        if "not currently recording" not in str(e):
            raise
    release(dev, pool)
    _reset_generator()


def _reset_generator() -> None:
    """A failed capture leaves the default CUDA generator marked as
    captured (its epilogue never ran), so every later random draw would
    raise: one trivial capture runs the prologue and epilogue again."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        torch.zeros(1, device="cuda").add_(1)
    del g


# -- one captured graph: shared by CapturedStep and the serving engine ---------

@contextlib.contextmanager
def on_stream(stream: Optional["torch.cuda.Stream"]):
    """Run the block on ``stream`` (None: where it is), ordered after the
    current stream's work and before its later work: a capture's warm-up
    runs where the capture will, so every kernel library loads and sets
    its attributes before the capture."""
    if stream is None:
        yield
        return
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        yield
    cur.wait_stream(stream)


def _uncounted(body: Callable, tables=()):
    """``body()`` with the launch counters rolled back after it and its
    chunk tables deferred, as a capture would (the CPU's stand-in for a
    replay: the replay adds the capture's recorded launches)."""
    cnt = _counter_state()
    try:
        with fok.deferred_tables(tables) as made:
            out = body()
        fok.fill_tables(made)
    finally:
        _counter_restore(cnt)
    return out


class Graph:
    """One captured step: the CUDA graph (None on the CPU, where a replay
    re-runs the body), its static outputs, the launch counts a replay
    adds, the fused optimizer's chunk tables the graph reads (owned here,
    so no rebuild of a bucket's table frees them; ``spec`` their rows and
    devices), the capture's seconds and the bytes its pool reserved."""

    __slots__ = ("graph", "out", "delta", "spec", "tables", "capture_s",
                 "pool_bytes")

    def __init__(self, graph, out, delta, spec=(), tables=(),
                 capture_s=0.0, pool_bytes=0):
        self.graph = graph
        self.out = out
        self.delta = delta
        self.spec = list(spec)
        self.tables = list(tables)
        self.capture_s = capture_s
        self.pool_bytes = pool_bytes

    def replay(self, stand_in: Callable):
        """Replay (on the CPU: ``stand_in()``, its launches uncounted) and
        add the recorded launches; the static outputs, or the stand-in's."""
        if self.graph is not None:
            self.graph.replay()
            out = self.out
        else:
            out = _uncounted(stand_in, self.spec)
        _counter_add(self.delta)
        return out


def capture_graph(body: Callable, stream: "torch.cuda.Stream",
                  generators: Sequence[torch.Generator] = (),
                  tables=()) -> Graph:
    """Capture ``body()`` on ``stream`` into one CUDA graph over a pool of
    its own; nothing runs. The launch counters' advance is
    recorded and rolled back. ``tables``: the ``(rows, device)`` of each
    chunk table the body's optimizer launches take, as its warm-up
    recorded them; they are allocated before the capture (never in the
    pool: earlier nodes of the graph reuse its memory, so rows written
    there outside the graph would not survive a replay) and filled after
    it ends. An error in the body or the capture's end is cleaned up
    (:func:`_abandon_capture`) and raised as ``CaptureAbort("trace
    failed", <the error>)`` (a ``CaptureAbort`` raised inside as itself);
    running out of device memory raises as it would eagerly."""
    with torch.cuda.device(stream.device), \
            fok.deferred_tables(tables) as made:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        g = torch.cuda.CUDAGraph()
        # the port's generator for the card: the ops' own draws
        # (``dropout``, attention dropout, ``gumbel_softmax``) without a
        # layer's generator
        port_gen = default_generator(stream.device)
        for gen in [port_gen] + [x for x in generators if x is not port_gen]:
            if gen.device.type == "cuda":
                g.register_generator_state(gen)
        # the pool's id is known even if the capture fails (a failed graph
        # cannot say it): the clean-up needs it
        pool = torch.cuda.graph_pool_handle()
        cnt = _counter_state()
        t0 = time.perf_counter()
        err: Optional[BaseException] = None
        ended = False
        out = None
        try:
            with torch.cuda.stream(stream):
                # capture_begin/_end by hand (torch.cuda.graph's context):
                # whether the end succeeded decides the clean-up
                g.capture_begin(pool, capture_error_mode="thread_local")
                try:
                    out = _detached(body())
                except Exception as e:
                    err = e
                try:
                    g.capture_end()
                    ended = True
                except Exception as e:
                    err = err or e
        finally:
            delta = _counter_delta(cnt)
            _counter_restore(cnt)
        if err is not None:
            out = None
            if not ended:
                _abandon_capture(pool)
            if isinstance(err, torch.cuda.OutOfMemoryError):
                raise err       # the card's memory, not the step's form
            abort = _abort_in(err)
            if abort is not None:
                raise abort from None
            raise CaptureAbort("trace failed",
                               f"{type(err).__name__}: {err}") from err
        torch.cuda.synchronize()
        pool_bytes = torch.cuda.memory_reserved() - reserved0
    return Graph(g, out, delta, tables, fok.fill_tables(made),
                 time.perf_counter() - t0, pool_bytes)


# -- discovery ----------------------------------------------------------------

class _Probe:
    """Discovery-run instrumentation sink."""

    def __init__(self):
        self.opts: List = []
        self._opt_ids: set = set()
        self.opt_step0: Dict[int, int] = {}
        self.sched_epoch0: Dict[int, int] = {}
        self.sched_arg = False
        self.hooked = False
        self.create_graph = False
        self.functional_grad = False

    def saw_optimizer(self, opt) -> None:
        if id(opt) not in self._opt_ids:
            self._opt_ids.add(id(opt))
            self.opts.append(opt)
            # the replayed advance is the probe's measured DELTA: a step()
            # with no grads early-outs without advancing
            self.opt_step0[id(opt)] = opt._step_count
            sched = opt._lr
            if isinstance(sched, lr_mod.LRScheduler):
                self.sched_epoch0.setdefault(id(sched), sched.last_epoch)

    def saw_scheduler_step(self, sched, arg) -> None:
        self.sched_epoch0.setdefault(id(sched), sched.last_epoch)
        if arg is not None:
            self.sched_arg = True


@contextlib.contextmanager
def _probing(probe: _Probe):
    """Install the probe: the optimizer and scheduler hooks, and watches
    on tensor hooks, ``create_graph`` and functional ``grad()``. The
    watches are module-level functions that read the active probe from a
    global, never closures over it: torch caches some of its functions
    the first time it lists them (``torch.overrides``' lru cache), and a
    closure cached there would keep the probe, and every optimizer it
    saw, alive for good."""
    global _WATCHED
    saved = (torch.Tensor.register_hook,
             torch.Tensor.register_post_accumulate_grad_hook,
             torch.autograd.backward, torch.autograd.grad)
    outer = _WATCHED
    _WATCHED = (probe, saved)
    optimizer_mod._PROBE = lr_mod._PROBE = probe
    torch.Tensor.register_hook = _watched_register_hook
    torch.Tensor.register_post_accumulate_grad_hook = _watched_post_hook
    torch.autograd.backward = _watched_backward
    torch.autograd.grad = _watched_grad
    try:
        yield probe
    finally:
        optimizer_mod._PROBE = lr_mod._PROBE = None
        _WATCHED = outer
        (torch.Tensor.register_hook,
         torch.Tensor.register_post_accumulate_grad_hook,
         torch.autograd.backward, torch.autograd.grad) = saved


# (the probe, the functions it replaced) while a probe runs; a watch
# called outside one (kept by a cache) calls torch's own function
_WATCHED: Optional[Tuple[_Probe, tuple]] = None
_TORCH_OWN = (torch.Tensor.register_hook,
              torch.Tensor.register_post_accumulate_grad_hook,
              torch.autograd.backward, torch.autograd.grad)


def _watch(flag: str, seen: bool = True):
    """The functions the active probe replaced (its ``flag`` set when
    ``seen``)."""
    if _WATCHED is None:
        return _TORCH_OWN
    probe, saved = _WATCHED
    if seen:
        setattr(probe, flag, True)
    return saved


def _watched_register_hook(self, hook):
    return _watch("hooked")[0](self, hook)


def _watched_post_hook(self, hook):
    return _watch("hooked")[1](self, hook)


def _watched_backward(tensors, grad_tensors=None, retain_graph=None,
                      create_graph=False, *a, **kw):
    return _watch("create_graph", bool(create_graph))[2](
        tensors, grad_tensors, retain_graph, create_graph, *a, **kw)


def _watched_grad(*a, **kw):
    return _watch("functional_grad")[3](*a, **kw)


def _param_device(opt) -> torch.device:
    return opt._parameter_list[0].device


class _Discovery:
    """What a probe run learned about the step's persistent state."""

    def __init__(self, probe: _Probe, arg_mutated: bool, extra=()):
        self.reason: Optional[str] = None
        params, seen = [], set()
        for p in [q for o in probe.opts for q in o._parameter_list] + \
                list(extra):
            if p.requires_grad and id(p) not in seen:
                seen.add(id(p))
                params.append(p)
        if probe.sched_arg:
            self.reason = ("LR scheduler stepped with an explicit "
                           "epoch/metric argument")
        elif arg_mutated:
            self.reason = "step mutates an input argument in place"
        elif probe.create_graph:
            self.reason = "backward(create_graph=True) inside a captured step"
        elif probe.functional_grad:
            self.reason = "functional grad() capture inside a captured step"
        elif probe.hooked or any(getattr(p, "_backward_hooks", None) or
                                 getattr(p, "_post_accumulate_grad_hooks",
                                         None) for p in params):
            self.reason = _HOOKS
        self.opts = list(probe.opts)
        self.params = params
        # the step left every grad None (it clears what it steps)
        self.clears = False
        self.opt_steps = {id(o): o._step_count - probe.opt_step0[id(o)]
                          for o in probe.opts}
        self.sched_deltas: List[Tuple[Any, int]] = []
        for o in self.opts:
            sched = o._lr
            if isinstance(sched, lr_mod.LRScheduler):
                e0 = probe.sched_epoch0.get(id(sched), sched.last_epoch)
                delta = sched.last_epoch - e0
                if delta:
                    self.sched_deltas.append((weakref.ref(sched), delta))


def _sched_states(s, out) -> None:
    """``(scheduler, copy of its __dict__)`` for ``s`` and every scheduler
    it wraps (LinearWarmup's ``lr_after``)."""
    out.append((s, dict(s.__dict__)))
    for v in s.__dict__.values():
        if isinstance(v, lr_mod.LRScheduler):
            _sched_states(v, out)


class _HostSnapshot:
    """The host bookkeeping a run of the step body moves (optimizer step
    counts, scheduler state), restored after a capture or a stand-in
    replay, whose host side must not count."""

    def __init__(self, disc: _Discovery):
        self._opt = [(o, o._step_count) for o in disc.opts]
        self._sched: List = []
        for o in disc.opts:
            if isinstance(o._lr, lr_mod.LRScheduler):
                _sched_states(o._lr, self._sched)

    def restore(self) -> None:
        for o, c in self._opt:
            o._step_count = c
        for s, d in self._sched:
            s.__dict__.clear()
            s.__dict__.update(d)


# -- the capture context ------------------------------------------------------

class _CaptureCtx:
    """What ``Optimizer.step``, ``clear_grad`` and the GradScaler consult
    while a captured body runs (``optimizer._CAPTURE``)."""

    def __init__(self, disc: _Discovery):
        self.opt_ids = {id(o) for o in disc.opts}
        self.lr_host: Dict[int, float] = {id(o): float(o.get_lr())
                                          for o in disc.opts}
        self.cleared: set = set()

    def abort(self, reason: str, detail: Optional[str] = None):
        raise CaptureAbort(reason, detail)

    def lr(self, opt, dev) -> torch.Tensor:
        if id(opt) not in self.opt_ids:
            self.abort(_UNSEEN)
        if float(opt.get_lr()) != self.lr_host[id(opt)]:
            self.abort("learning rate changed mid-step (scheduler stepped "
                       "before optimizer.step)")
        return opt._live[("lr", str(dev))][1]

    def step(self, opt, dev) -> torch.Tensor:
        if id(opt) not in self.opt_ids:
            self.abort(_UNSEEN)
        return opt._live[("dev_step", str(dev))][1] + 1.0

    def advance(self, opt, dev, found) -> None:
        counter = opt._live[("dev_step", str(dev))][1]
        counter.add_(1.0 if found is None else 1.0 - found.float())

    def clear_grad(self, p) -> bool:
        g = _static_grad(p)
        if g is None or p.grad is not g:
            return False
        g.zero_()
        self.cleared.add(p)
        return True


@contextlib.contextmanager
def _installed(ctx: _CaptureCtx):
    global _ACTIVE
    optimizer_mod._CAPTURE = ctx
    _ACTIVE = True
    try:
        yield ctx
    finally:
        optimizer_mod._CAPTURE = None
        _ACTIVE = False


# -- arguments ----------------------------------------------------------------

def _flatten_args(args, kwargs):
    """``(signature, dynamic tensors, requires-grad flag, (spec, leaves,
    dynamic positions))``, or None when a static leaf is unhashable."""
    leaves, spec = pytree.tree_flatten((args, kwargs))
    dyn_pos, dyn, avals, statics = [], [], [], []
    grad_arg = False
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, np.ndarray):
            leaf = leaves[i] = torch.from_numpy(leaf)
        if isinstance(leaf, torch.Tensor):
            grad_arg |= leaf.requires_grad
            dyn_pos.append(i)
            dyn.append(leaf)
            avals.append((tuple(leaf.shape), leaf.dtype, str(leaf.device)))
        else:
            statics.append((i, leaf))
    statics_t = tuple(statics)
    try:
        hash(statics_t)
    except TypeError:
        return None
    sig = (str(spec), tuple(avals), statics_t)
    return sig, dyn, grad_arg, (spec, leaves, tuple(dyn_pos))


def _rebuild(rebuild, dyn):
    spec, leaves, dyn_pos = rebuild
    lv = list(leaves)
    for pos, t in zip(dyn_pos, dyn):
        lv[pos] = t
    return pytree.tree_unflatten(lv, spec)


def _detached(out):
    return pytree.tree_map(
        lambda x: x.detach() if isinstance(x, torch.Tensor) else x, out)


def _cloned(out):
    return pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, out)


class _Entry:
    """One captured step: its :class:`Graph` (no CUDA graph on the CPU),
    static buffers, and the host effects a replay re-applies.

    ``pool_grads``: the step starts and ends with every grad None (it
    clears what it steps), so the capture allocates the grads in the
    graph's pool, as an eager step allocates them, and nothing holds them
    between replays. Otherwise (a micro step, a step that keeps its
    grads) they live in capture grad storage made before the capture."""

    __slots__ = ("disc", "cuda", "graph", "static_in",
                 "rebuild", "warm_delta", "tables", "cleared", "ptrs",
                 "pool_grads",
                 "lr_stacks", "cols")

    def __init__(self, disc, rebuild, cuda: bool):
        self.disc = disc
        self.rebuild = rebuild
        self.cuda = cuda
        self.graph: Optional[Graph] = None
        self.static_in: List[torch.Tensor] = []
        self.warm_delta = None
        self.tables: List = []      # the warm-up's chunk tables' shapes
        self.cleared: set = set()
        self.ptrs: Tuple = ()
        self.pool_grads = False
        self.lr_stacks: Dict[int, torch.Tensor] = {}   # multi-step only
        self.cols: List[List[float]] = []


def _state_ptrs(entry: _Entry) -> Tuple:
    """Addresses of every tensor the graph reads or writes in place and
    does not own: a moved one (``model.to``, ``p.data = ...``)
    invalidates the graph. Its chunk tables, and the grads of a
    ``pool_grads`` step, are the graph's own."""
    disc = entry.disc
    out = [p.data_ptr() for p in disc.params]
    if not entry.pool_grads:
        out += [_static_grad(p).data_ptr() for p in disc.params
                if _static_grad(p) is not None]
    for o in disc.opts:
        out += [m.data_ptr() for m in o._masters if m is not None]
        out += [t.data_ptr() for s in o._states if s is not None
                for t in s.values()]
    return tuple(out)


# -- the public wrapper -------------------------------------------------------

class CapturedStep:
    """Result of :func:`jit_step`: a training-step function that, once its
    structure is stable, replays as one CUDA graph."""

    def __init__(self, fn: Callable, strict: bool = False,
                 generators: Sequence[torch.Generator] = (),
                 params: Sequence[torch.Tensor] = ()):
        self._fn = fn
        self._strict = strict
        # parameters whose grads the step accumulates without stepping
        # their optimizer (TrainStep's micro step): they get capture grad
        # storage too
        self._params = list(params)
        self._generators = tuple(generators)
        self._stream = None
        self._disc: Optional[_Discovery] = None
        self._entries: Dict[Any, Any] = {}
        self._streak = 0
        self._probe_tick = 0
        self._last_reason: Optional[str] = None
        functools.update_wrapper(self, fn, updated=())

    # -- fallbacks -----------------------------------------------------------
    def _fallback(self, reason: str, detail: Optional[str] = None) -> None:
        if reason not in FALLBACK_REASONS:
            raise ValueError(
                f"unregistered step_capture fallback reason {reason!r}: add "
                f"it to FALLBACK_REASONS")
        msg = reason if detail is None else f"{reason}: {detail}"
        if self._strict:
            raise RuntimeError(f"step capture failed: {msg}")
        capture_counters["fallbacks"] += 1
        self._last_reason = msg

    @property
    def last_fallback(self) -> Optional[str]:
        """The reason (and detail) of the most recent fallback."""
        return self._last_reason

    # -- key -----------------------------------------------------------------
    def _state_sig(self):
        d = self._disc
        st = tuple((tuple(p.shape), p.dtype, str(p.device), p.requires_grad)
                   for p in d.params)
        osig = []
        for o in d.opts:
            clip = o._grad_clip
            clip_sig = None if clip is None else (
                type(clip).__name__, getattr(clip, "clip_norm", None),
                getattr(clip, "min", None), getattr(clip, "max", None))
            osig.append((id(o), type(o).__name__, clip_sig,
                         isinstance(o._lr, lr_mod.LRScheduler),
                         o._multi_precision,
                         tuple(id(p) for p in o._parameter_list)))
        return st, tuple(osig)

    def _put_entry(self, key, value) -> None:
        if key not in self._entries and len(self._entries) >= _ENTRIES_MAX:
            self._entries.pop(next(iter(self._entries)))
        self._entries[key] = value

    # -- probe ---------------------------------------------------------------
    def _probe_and_prime(self, args, kwargs, arg_sig, dyn):
        global _ACTIVE
        capture_counters["probes"] += 1
        versions = [t._version for t in dyn]
        _ACTIVE = True
        try:
            with _probing(_Probe()) as probe, \
                    self._side_stream(any(t.is_cuda for t in dyn)):
                out = self._fn(*args, **kwargs)
        finally:
            _ACTIVE = False
        mutated = any(t._version != v for t, v in zip(dyn, versions))
        self._disc = _Discovery(probe, mutated, self._params)
        self._disc.clears = all(p.grad is None for p in self._disc.params)
        key = (flags.version, arg_sig, self._state_sig())
        if self._disc.reason is not None:
            self._put_entry(key, ("unfusable", self._disc.reason, None))
            self._fallback(self._disc.reason)
        elif key not in self._entries:
            self._put_entry(key, _PRIMED)
        return out

    @contextlib.contextmanager
    def _side_stream(self, cuda: bool):
        """Run on the capture's side stream (a CUDA step only). The probe,
        the warm-up and the capture all run there: autograd nodes a model
        keeps alive from one step to the next (a grad accumulator carries
        the stream it was made on) then never tie a captured backward to
        the legacy stream."""
        if not cuda:
            yield
            return
        with on_stream(self._capture_stream()):
            yield

    def _capture_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream

    # -- the body ------------------------------------------------------------
    def _cuda(self, d: _Discovery, dyn) -> bool:
        return any(p.is_cuda for p in d.params) or any(t.is_cuda
                                                       for t in dyn)

    def _attach_grads(self, d: _Discovery) -> None:
        """Give every trained parameter its capture grad storage, made
        before the warm-up so it outlives the graph and holding the
        current grad (an open accumulation window keeps its sum), else
        zeros. New storage is allocated after the cache goes back to the
        card, so no long-lived grad pins a segment that held a step's
        activations."""
        new = {id(p) for p in d.params
               if (g := _static_grad(p)) is None or g.shape != p.shape
               or g.device != p.device or g.dtype != p.dtype}
        if any(p.is_cuda for p in d.params if id(p) in new):
            torch.cuda.empty_cache()
        for p in d.params:
            g = _static_grad(p)
            if id(p) in new:
                g = torch.zeros_like(p) if p.grad is None else p.grad.clone()
                setattr(p, _GRAD_ATTR, g)
            elif p.grad is None:
                # None after a captured step cleared it: the storage is
                # zero already; None after an eager clear: stale sums
                if not getattr(p, _CLEAN_ATTR, False):
                    g.zero_()
            elif p.grad is not g:
                g.copy_(p.grad)
            setattr(p, _CLEAN_ATTR, False)
            p.grad = g

    def _prepare(self, d: _Discovery, attach: bool) -> None:
        """Before a warm-up, capture or replay, on the host's stream and
        outside any graph: the lr scalars refreshed, the device step
        counters refilled where the host count moved, grads attached
        (``attach``: the step keeps capture grad storage)."""
        for o in d.opts:
            dev = _param_device(o)
            o._live_scalar("lr", o.get_lr(), dev)
            o._dev_step(dev)
        if attach:
            self._attach_grads(d)

    def _synced(self, d: _Discovery, cleared) -> None:
        """After a run: the device step counters hold the host count, and
        grads the step cleared read as None, as after an eager step."""
        for o in d.opts:
            slot = o._live.get(("dev_step", str(_param_device(o))))
            if slot is not None:
                slot[0] = o._step_count
        for p in cleared:
            p.grad = None
            setattr(p, _CLEAN_ATTR, True)

    def _body(self, entry: _Entry, ctx: _CaptureCtx):
        """One run of the step over the static inputs."""
        args, kwargs = _rebuild(entry.rebuild, entry.static_in)
        return self._fn(*args, **kwargs)

    def _host_reps(self) -> int:
        return 1

    def _apply_host_effects(self, d: _Discovery, reps: int) -> None:
        for o in d.opts:
            o._step_count += reps * d.opt_steps.get(id(o), 0)
        for sref, delta in d.sched_deltas:
            s = sref()
            if s is not None:
                for _ in range(reps * delta):
                    s.step()

    # -- warm-up and capture ---------------------------------------------------
    def _warm_up(self, entry: _Entry):
        """The step, eagerly, over the static inputs under the capture
        context on the capture's stream. A step that starts with no grads
        and ended its probe with none runs as an eager one (``pool_grads``
        when it ends with none again); any other gets capture grad
        storage first."""
        d = entry.disc
        fresh = d.clears and all(p.grad is None for p in d.params)
        # a failed warm-up falls back to the eager step, which must see
        # the grads as they were (a strict step raises instead: no copy)
        backup = {} if self._strict else {
            id(p): p.grad.clone() for p in d.params if p.grad is not None}
        snap = _HostSnapshot(d)
        self._prepare(d, attach=not fresh)
        ctx = _CaptureCtx(d)
        cnt = _counter_state()
        try:
            with _installed(ctx), self._side_stream(entry.cuda), \
                    fok.recorded_tables() as tables:
                out = self._body(entry, ctx)
        except BaseException:
            snap.restore()
            if not self._strict:
                for p in d.params:
                    p.grad = backup.get(id(p))
            raise
        entry.warm_delta = _counter_delta(cnt)
        entry.tables = list(tables)
        entry.cleared = set(ctx.cleared)
        entry.pool_grads = fresh and all(p.grad is None for p in d.params)
        self._synced(d, ())
        return out

    def _capture(self, entry: _Entry) -> None:
        d = entry.disc
        snap = _HostSnapshot(d)
        self._prepare(d, attach=not entry.pool_grads)
        ctx = _CaptureCtx(d)
        try:
            with _installed(ctx):
                graph = capture_graph(lambda: self._body(entry, ctx),
                                      self._capture_stream(),
                                      self._generators, entry.tables)
        finally:
            snap.restore()
            self._synced(d, ())
        entry.cleared = set(ctx.cleared)
        entry.graph = graph

    def _attempt_capture(self, key, dyn, rebuild):
        d = self._disc
        entry = _Entry(d, rebuild, self._cuda(d, dyn))
        entry.static_in = [t.detach().clone() for t in dyn]
        self._setup_entry(entry)
        out = self._warm_up(entry)
        if entry.cuda:
            try:
                self._capture(entry)
            except CaptureAbort as e:
                e.warmed = out      # the warm-up was this call's step
                self._synced(d, entry.cleared)
                raise
        else:       # the CPU: the warm-up's launches stand for the graph's
            entry.graph = Graph(None, None, entry.warm_delta, entry.tables)
        entry.ptrs = _state_ptrs(entry)
        self._put_entry(key, entry)
        self._synced(d, entry.cleared)
        return out

    def _setup_entry(self, entry: _Entry) -> None:
        """Hook for multi-step capture: the lr stacks."""

    # -- replay --------------------------------------------------------------
    def _replay(self, entry: _Entry, dyn):
        d = entry.disc
        if _state_ptrs(entry) != entry.ptrs or (entry.pool_grads and any(
                p.grad is not None for p in d.params)):
            # moved state, or grads the graph would not add to (a
            # pool_grads step allocates its own): re-probe
            capture_counters["invalidations"] += 1
            self._entries.clear()
            self._disc = None
            return None
        for s, t in zip(entry.static_in, dyn):
            s.copy_(t)
        self._before_replay(entry)
        self._prepare(d, attach=not entry.pool_grads)
        out = _cloned(entry.graph.replay(lambda: self._stand_in(entry)))
        self._apply_host_effects(d, self._host_reps())
        self._after_replay(entry)
        self._synced(d, entry.cleared)
        capture_counters["replays"] += 1
        return out

    def _before_replay(self, entry: _Entry) -> None:
        """Hook for multi-step capture: fill the lr stacks."""

    def _after_replay(self, entry: _Entry) -> None:
        """Hook for multi-step capture."""

    def _stand_in(self, entry: _Entry):
        """The CPU's replay: the captured body re-run over the static
        buffers, its host side rolled back (a graph runs no Python)."""
        snap = _HostSnapshot(entry.disc)
        ctx = _CaptureCtx(entry.disc)
        try:
            with _installed(ctx):
                return _detached(self._body(entry, ctx))
        finally:
            snap.restore()

    # -- dispatch ------------------------------------------------------------
    def _eager(self, args, kwargs):
        return self._fn(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        return paddle_call(self._call, args, kwargs)

    def _call(self, *args, **kwargs):
        if not self._strict and not flags.get_flag("step_capture"):
            self._fallback("FLAGS_step_capture disabled")
            return self._eager(args, kwargs)
        if _ACTIVE:   # nested inside another capture: run inline
            return self._eager(args, kwargs)
        if self._streak >= _MISS_STREAK_MAX and not self._strict:
            self._probe_tick += 1
            if self._probe_tick % _PROBE_EVERY:
                capture_counters["bypass"] += 1
                return self._eager(args, kwargs)
        flat = _flatten_args(args, kwargs)
        if flat is None:
            self._fallback("unhashable static argument")
            return self._eager(args, kwargs)
        arg_sig, dyn, grad_arg, rebuild = flat
        if grad_arg:
            self._fallback("input argument requires grad (grads must land "
                           "on the caller's tensor)")
            return self._eager(args, kwargs)
        if self._disc is None:
            return self._probe(args, kwargs, arg_sig, dyn)
        key = (flags.version, arg_sig, self._state_sig())
        ent = self._entries.get(key)
        if ent is None:
            self._streak += 1
            return self._probe(args, kwargs, arg_sig, dyn)
        if ent is _PRIMED:
            try:
                out = self._attempt_capture(key, dyn, rebuild)
            except CaptureAbort as e:
                self._put_entry(key, ("unfusable", e.reason, e.detail))
                self._disc = None    # a stale discovery gets one re-probe
                warmed = getattr(e, "warmed", None)
                self._fallback(e.reason, e.detail)
                return self._eager(args, kwargs) if warmed is None \
                    else warmed
            capture_counters["captures"] += 1
            self._streak = 0
            return out
        if isinstance(ent, tuple):       # ("unfusable", reason, detail)
            self._fallback(ent[1], ent[2])
            return self._eager(args, kwargs)
        self._entries.pop(key)
        self._entries[key] = ent
        try:
            out = self._replay(ent, dyn)
        except CaptureAbort as e:
            self._entries.clear()
            self._disc = None
            self._fallback("replay failed", str(e))
            return self._eager(args, kwargs)
        if out is None:                  # invalidated: re-probe
            return self._probe(args, kwargs, arg_sig, dyn)
        self._streak = 0
        return out

    def _probe(self, args, kwargs, arg_sig, dyn):
        return self._probe_and_prime(args, kwargs, arg_sig, dyn)

    # -- introspection ---------------------------------------------------------
    def graphs(self) -> List[Dict[str, Any]]:
        """Each captured entry's capture seconds and pool bytes (``cuda``
        False: the CPU stand-in, no graph)."""
        return [dict(capture_s=e.graph.capture_s,
                     pool_bytes=e.graph.pool_bytes, cuda=e.cuda)
                for e in self._entries.values()
                if isinstance(e, _Entry) and e.graph is not None]


def jit_step(function: Optional[Callable] = None, *, k_steps: int = 1,
             generators: Sequence[torch.Generator] = ()):
    """Wrap a training-step function for whole-step capture.

    ``step = paddle_tpu_torch.jit.jit_step(train_step)``: ``train_step``
    runs the usual eager code (forward, ``loss.backward()``,
    ``opt.step()``, ``opt.clear_grad()``); after one eager probe and one
    warm-up the whole step is one CUDA graph, replayed. Usable as a
    decorator. Gated by ``FLAGS_step_capture``; a step the capture cannot
    express runs eagerly, the reason in ``last_fallback`` and counted in
    ``capture_counters["fallbacks"]``.

    ``k_steps=K`` (K > 1) returns a ``MultiStepCapture``: each call takes
    a ``[K, ...]``-stacked block (``io.DataLoader.fill_ring`` builds
    them) and runs K whole steps in ONE graph, returning ``[K]``-stacked
    outputs. ``generators`` lists CUDA generators (besides the default
    one) that the step draws from."""
    if function is None:
        return functools.partial(jit_step, k_steps=k_steps,
                                 generators=generators)
    if int(k_steps) > 1:
        from .multi_step import MultiStepCapture
        return MultiStepCapture(function, int(k_steps),
                                generators=generators)
    return CapturedStep(function, generators=generators)
