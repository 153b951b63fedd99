"""The collective communication API, over ``torch.distributed``.

Counterpart of ``paddle_tpu/distributed/collective.py``. The reference is
single-controller: one process holds global arrays over a device mesh and
its collectives act on their shardings. The port is multi-controller, as
upstream Paddle is: one process per rank, each holding its own tensors,
and every call here is a real collective over a ``ProcessGroup`` that all
ranks of the group enter (ROADMAP.md §C records what that changes).

- ``init_parallel_env(backend=None, device=None, timeout_s=1800)``: the
  rendezvous over a ``native.TCPStore`` at ``MASTER_ADDR:MASTER_PORT``,
  hosted by the launcher (``PADDLE_STORE_HOSTED=1``) or else by rank 0; a
  lone process picks a free port. The backend defaults to **NCCL on
  ``cuda:{local_rank}``** (``PADDLE_DEVICES``, the launcher's
  ``--devices``, may name the card). A CPU run asks for ``backend="gloo"``
  (and ``--devices cpu`` or ``device="cpu"``), and so do ranks that share
  a card; if the NCCL default would put two ranks of this node on one
  card it raises, naming ``backend="gloo"``: it never switches backend.
  The device becomes ``set_device``'s, as Paddle's does.
- ``ReduceOp`` (``SUM``, ``MAX``, ``MIN``, ``PROD``, ``AVG``: a sum, then
  a division by the group's size, on both backends), ``Group`` (a
  ``ProcessGroup`` with its ``axis``, ``nranks`` and global ``ranks``),
  ``ParallelEnv``, ``get_rank`` / ``get_world_size`` (of a group too),
  ``new_group`` (every rank calls it, as torch requires), ``barrier``.
- ``all_reduce`` (in place, as Paddle's), ``all_gather`` (fills the list),
  ``broadcast``, ``reduce``, ``scatter`` (in place), ``all_to_all``
  (equal chunks), ``reduce_scatter`` (a list of per-rank contributions, or
  one whole tensor cut on dim 0), ``send`` / ``recv`` / ``isend`` /
  ``irecv``, ``P2POp`` and ``batch_isend_irecv``, with ``_Work`` handles;
  ``all_gather_object`` and ``scatter_object_list``. ``src`` and ``dst``
  are global ranks. A rank outside ``group`` returns at once.

Every call counts in ``distributed.collective_calls`` and runs inside a
watchdog task (``watchdog.comm_watchdog``, ``FLAGS_comm_timeout_s``); an
asynchronous call's task ends at its handle's ``wait()``. Over gloo the
task ends there, or as the call returns, since gloo blocks until the
peers came. NCCL returns once the work is queued on the card: its task
ends when the card passes a CUDA event recorded behind the work, which
the watchdog's scan polls (:func:`_settle`).

gloo runs a CUDA tensor through ``all_reduce``, ``broadcast`` and
``all_gather`` only. For every other call over gloo a CUDA tensor is
staged through host memory here, explicitly: copied to the CPU, sent,
copied back, with its bytes counted in ``distributed.host_staged_bytes``.
"""

from __future__ import annotations

import datetime
import functools
import os
import socket
from typing import Any, List, Optional

import torch
import torch.distributed as tdist

from .. import flags
from ..observability import metrics as _metrics
from . import env

_M_CALLS = _metrics.registry().counter(
    "distributed.collective_calls",
    "eager collective API calls (watchdog-bracketed)")
_M_STAGED = _metrics.registry().counter(
    "distributed.host_staged_bytes",
    "bytes of CUDA tensors staged through host memory for a gloo call "
    "that takes no CUDA tensor")

# the calls gloo runs on CUDA tensors itself; the rest are staged
_GLOO_CUDA = frozenset({"all_reduce", "broadcast", "all_gather"})


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {ReduceOp.SUM: tdist.ReduceOp.SUM,
             ReduceOp.AVG: tdist.ReduceOp.SUM,
             ReduceOp.MAX: tdist.ReduceOp.MAX,
             ReduceOp.MIN: tdist.ReduceOp.MIN,
             ReduceOp.PROD: tdist.ReduceOp.PRODUCT}


class Group:
    """A communication group: a ``ProcessGroup`` over the global ``ranks``,
    named by the topology axis it spans."""

    def __init__(self, axis: str, degree: int, ranks=None,
                 process_group=None):
        self.axis = axis
        self.nranks = degree
        self.ranks = list(ranks) if ranks is not None else list(range(degree))
        self.process_group = process_group

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def rank(self) -> int:
        """This process's index in the group, -1 outside it."""
        me = env.get_rank()
        return self.ranks.index(me) if me in self.ranks else -1

    def is_member(self) -> bool:
        return self.rank >= 0

    def get_group_rank(self, global_rank: int) -> int:
        return self.ranks.index(global_rank) if global_rank in self.ranks \
            else -1

    def __repr__(self):
        return (f"Group(axis={self.axis}, nranks={self.nranks}, "
                f"ranks={self.ranks})")


class _State:
    backend: Optional[str] = None
    device: Optional[torch.device] = None
    store = None
    world: Optional[Group] = None


_S = _State()


class ParallelEnv:
    @property
    def rank(self) -> int:
        return env.get_rank()

    @property
    def world_size(self) -> int:
        return env.get_world_size()

    @property
    def local_rank(self) -> int:
        return env.get_local_rank()

    @property
    def device(self) -> Optional[torch.device]:
        return _S.device

    @property
    def device_id(self) -> int:
        d = _S.device
        return d.index if d is not None and d.type == "cuda" else 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _listed_devices() -> Optional[List[str]]:
    raw = os.environ.get("PADDLE_DEVICES")
    return [d.strip() for d in raw.split(",")] if raw else None


def resolve_device(backend: str, device=None) -> torch.device:
    """This rank's device: ``device`` if given, else its entry of
    ``PADDLE_DEVICES`` (``cpu``, or card indices in local-rank order),
    else ``cuda:{local_rank}`` for NCCL and the CPU for gloo. Raises when
    NCCL would share a card between two ranks of this node."""
    local = env.get_local_rank()
    listed = _listed_devices()
    if device is not None:
        dev = torch.device(device)
    elif listed is not None:
        pick = listed[0] if listed == ["cpu"] else listed[local]
        dev = torch.device("cpu" if pick == "cpu" else f"cuda:{int(pick)}")
    else:
        dev = torch.device(f"cuda:{local}" if backend == "nccl" else "cpu")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"backend='nccl' needs a CUDA device, got {dev}:"
                             " pass backend='gloo' for a CPU run")
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        shared = (listed is not None and listed != ["cpu"]
                  and len(set(listed)) < len(listed))
        if dev.index is None or dev.index >= n or shared:
            raise ValueError(
                f"backend='nccl' would put two ranks of this node on one "
                f"card (local rank {local}, device {dev}, devices "
                f"{listed or list(range(n))}): NCCL refuses that; pass "
                f"backend='gloo' for ranks that share a card")
    return dev


def init_parallel_env(backend: Optional[str] = None, device=None,
                      timeout_s: float = 1800.0) -> ParallelEnv:
    """Join the job: rendezvous over its store (the launcher's, else rank
    0's), then one default process group over every rank. Idempotent.
    See the module docstring for the backend and the device."""
    if tdist.is_initialized():
        return ParallelEnv()
    from ..native.tcp_store import TCPStore
    backend = (backend or "nccl").lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    dev = resolve_device(backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    from ..core.device import set_device
    set_device(dev)             # layers built the Paddle way go there
    rank, world = env.get_rank(), env.get_world_size()
    if world > 1 and "MASTER_PORT" not in os.environ:
        raise RuntimeError(
            f"init_parallel_env: world size {world} but no MASTER_ADDR / "
            f"MASTER_PORT: start the ranks with `python -m "
            f"paddle_tpu_torch.distributed.launch`")
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = int(os.environ.get("MASTER_PORT") or _free_port())
    hosted = os.environ.get("PADDLE_STORE_HOSTED") == "1"   # the launcher's
    store = TCPStore(addr, port, is_master=(rank == 0 and not hosted),
                     world_size=world, timeout=timeout_s)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    tdist.init_process_group(
        backend, store=store.torch_store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    _S.backend, _S.device, _S.store = backend, dev, store
    _S.world = Group("world", world, list(range(world)), tdist.group.WORLD)
    from .watchdog import comm_watchdog
    comm_watchdog().attach_store(store, rank)
    return ParallelEnv()


def is_initialized() -> bool:
    return tdist.is_initialized()


def get_backend() -> Optional[str]:
    return _S.backend


def get_store():
    """The job's ``native.TCPStore`` (after ``init_parallel_env``)."""
    return _S.store


def destroy_process_group() -> None:
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _S.backend = _S.device = _S.store = _S.world = None


def _group(group) -> Group:
    if group is None:
        if _S.world is None:
            raise RuntimeError("call distributed.init_parallel_env() first")
        return _S.world
    if not isinstance(group, Group):
        raise TypeError(f"group must be a distributed.Group, got "
                        f"{type(group).__name__}")
    if group.process_group is None:
        raise RuntimeError(f"{group!r} has no process group: it was made "
                           f"before init_parallel_env()")
    return group


def get_rank(group=None) -> int:
    """The global rank, or this rank's index in ``group`` (-1 outside)."""
    return env.get_rank() if group is None else group.rank


def get_world_size(group=None) -> int:
    return env.get_world_size() if group is None else group.nranks


def new_group(ranks=None, backend=None, axis: str = "dp",
              timeout_s: Optional[float] = None) -> Group:
    """A group over the global ``ranks`` (default: every rank). Every
    rank of the job calls it, in the same order, members or not."""
    ranks = sorted(ranks) if ranks else list(range(get_world_size()))
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    pg = tdist.new_group(ranks=ranks, backend=backend, **kw)
    return Group(axis, len(ranks), ranks, pg)


class _Work:
    """The handle of a call: ``wait()`` finishes it (a staged receive is
    copied back to its CUDA tensor there) and ends its watchdog task."""

    def __init__(self, work=None, task=None, after=None):
        self._work, self._task, self._after = work, task, after
        self._done = work is None

    def is_completed(self) -> bool:
        return self._done or self._work.is_completed()

    def wait(self) -> None:
        if not self._done:
            self._work.wait()
            self._done = True
        if self._after is not None:
            after, self._after = self._after, None
            after()
        if self._task is not None:
            _settle(self._task)
            self._task = None


def _start(name: str):
    from .watchdog import comm_watchdog
    _M_CALLS.inc()
    return comm_watchdog().start_task(
        f"eager:{name}", timeout_s=float(flags.get_flag("comm_timeout_s")),
        rank=env.get_rank())


def _settle(task) -> None:
    """End ``task`` once its call is done: now over gloo (and with no
    backend), else when the card passes an event recorded on the current
    stream, which a finished NCCL call has made wait for its work."""
    if _S.backend == "nccl":
        ev = torch.cuda.Event()
        ev.record()
        task._mgr.finish_when(task, ev.query)
    else:
        task._mgr.finish_task(task)


def _watched(fn):
    """Count the call and bracket it with a watchdog task."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        task = _start(fn.__name__)
        try:
            out = fn(*args, **kwargs)
        except BaseException:
            task._mgr.finish_task(task)
            raise
        _settle(task)
        return out
    return wrapper


def _stage_needed(name: str, tensors) -> bool:
    return _S.backend == "gloo" and name not in _GLOO_CUDA and any(
        t is not None and t.is_cuda for t in tensors)


def _host(t: torch.Tensor) -> torch.Tensor:
    _M_STAGED.inc(t.numel() * t.element_size())
    return t.detach().cpu()


def _back(dst: torch.Tensor, src: torch.Tensor) -> None:
    _M_STAGED.inc(src.numel() * src.element_size())
    dst.copy_(src)


def _finish(tensor, op, g: Group):
    if op == ReduceOp.AVG:
        if tensor.is_floating_point():
            tensor.div_(g.nranks)
        else:
            tensor.floor_divide_(g.nranks)
    return tensor


@_watched
def barrier(group=None) -> None:
    g = _group(group)
    if g.is_member():
        tdist.barrier(group=g.process_group)


@_watched
def all_reduce(tensor: torch.Tensor, op: str = ReduceOp.SUM, group=None,
               sync_op: bool = True):
    """Reduce ``tensor`` over the group, in place on every rank."""
    g = _group(group)
    if not g.is_member():
        return tensor
    tdist.all_reduce(tensor, op=_TORCH_OP[op], group=g.process_group)
    return _finish(tensor, op, g)


def all_reduce_async(tensor: torch.Tensor, op: str = ReduceOp.SUM,
                     group=None) -> _Work:
    """``all_reduce`` that returns at once: the result is in ``tensor``
    after the handle's ``wait()``, which also ends the watchdog task."""
    g = _group(group)
    if not g.is_member():
        return _Work()
    task = _start("all_reduce")
    work = tdist.all_reduce(tensor, op=_TORCH_OP[op], group=g.process_group,
                            async_op=True)
    return _Work(work, task, lambda: _finish(tensor, op, g))


@_watched
def all_gather(tensor_list: List, tensor: torch.Tensor, group=None,
               sync_op: bool = True):
    """Every rank's ``tensor``, in group order: an empty ``tensor_list``
    is extended, a full one is written into."""
    g = _group(group)
    if not g.is_member():
        return tensor_list
    out = [torch.empty_like(tensor) for _ in range(g.nranks)]
    tdist.all_gather(out, tensor.contiguous(), group=g.process_group)
    if tensor_list:
        for dst, src in zip(tensor_list, out):
            dst.copy_(src)
    else:
        tensor_list.extend(out)
    return tensor_list


@_watched
def broadcast(tensor: torch.Tensor, src: int = 0, group=None,
              sync_op: bool = True):
    g = _group(group)
    if g.is_member():
        tdist.broadcast(tensor, src=src, group=g.process_group)
    return tensor


@_watched
def reduce(tensor: torch.Tensor, dst: int = 0, op: str = ReduceOp.SUM,
           group=None, sync_op: bool = True):
    """The reduction lands in ``tensor`` on ``dst``; the other ranks'
    ``tensor`` is left as it is."""
    g = _group(group)
    if not g.is_member():
        return tensor
    work = tensor
    if _stage_needed("reduce", [tensor]):
        work = _host(tensor)
    keep = None if env.get_rank() == dst else work.clone()
    tdist.reduce(work, dst=dst, op=_TORCH_OP[op], group=g.process_group)
    if keep is not None:
        work.copy_(keep)
    elif op == ReduceOp.AVG:
        _finish(work, op, g)
    if work is not tensor:
        _back(tensor, work)
    return tensor


@_watched
def scatter(tensor: torch.Tensor, tensor_list=None, src: int = 0,
            group=None, sync_op: bool = True):
    """Rank ``src``'s ``tensor_list[i]`` into group rank i's ``tensor``."""
    g = _group(group)
    if not g.is_member():
        return tensor
    mine = env.get_rank() == src
    stage = _stage_needed("scatter", [tensor] + list(tensor_list or []))
    out = _host(tensor) if stage else tensor
    parts = None
    if mine:
        parts = [(_host(t) if stage else t).contiguous() for t in tensor_list]
    tdist.scatter(out, parts, src=src, group=g.process_group)
    if stage:
        _back(tensor, out)
    return tensor


@_watched
def all_to_all(out_tensor_list: List, in_tensor_list: List, group=None,
               sync_op: bool = True):
    """Group rank j's ``in_tensor_list[i]`` into rank i's
    ``out_tensor_list[j]``; the chunks share one shape."""
    g = _group(group)
    if not g.is_member():
        return out_tensor_list
    if len(in_tensor_list) != g.nranks:
        raise ValueError(f"all_to_all: {len(in_tensor_list)} tensors for a "
                         f"group of {g.nranks}")
    x = torch.stack([t.contiguous() for t in in_tensor_list])
    stage = _stage_needed("all_to_all", [x])
    src = _host(x) if stage else x
    out = torch.empty_like(src)
    tdist.all_to_all_single(out, src, group=g.process_group)
    if stage:
        dev = torch.empty_like(x)
        _back(dev, out)
        out = dev
    parts = list(out.unbind(0))
    if out_tensor_list:
        for dst, part in zip(out_tensor_list, parts):
            dst.copy_(part)
    else:
        out_tensor_list.extend(p.clone() for p in parts)
    return out_tensor_list


@_watched
def reduce_scatter(tensor: torch.Tensor, tensor_or_tensor_list,
                   op: str = ReduceOp.SUM, group=None, sync_op: bool = True):
    """Two forms: a list of ``nranks`` per-rank contributions (group rank
    i gets the reduction over ranks of everyone's ``list[i]``), or one
    tensor whose dim 0 is cut in ``nranks`` equal chunks (rank i gets the
    reduction of chunk i). The result lands in ``tensor``."""
    g = _group(group)
    if not g.is_member():
        return tensor
    src = tensor_or_tensor_list
    if isinstance(src, (list, tuple)):
        if len(src) != g.nranks:
            raise ValueError(f"reduce_scatter: {len(src)} tensors for a "
                             f"group of {g.nranks}")
        full = torch.stack([t.contiguous() for t in src])
    else:
        if src.shape[0] % g.nranks:
            raise ValueError(f"reduce_scatter: dim 0 of {tuple(src.shape)} "
                             f"does not split over {g.nranks} ranks")
        full = src.reshape(g.nranks, src.shape[0] // g.nranks,
                           *src.shape[1:]).clone()
    tdist.all_reduce(full, op=_TORCH_OP[op], group=g.process_group)
    tensor.copy_(_finish(full[g.rank], op, g).reshape(tensor.shape))
    return tensor


# -- point to point -----------------------------------------------------------

def _p2p(name: str, tensor: torch.Tensor, peer: int, g: Group):
    """Start one send or receive: (torch work, the function that ends it)."""
    stage = _stage_needed(name, [tensor])
    buf = _host(tensor) if stage and name == "send" else (
        torch.empty(tensor.shape, dtype=tensor.dtype) if stage else tensor)
    fn = tdist.isend if name == "send" else tdist.irecv
    work = fn(buf.contiguous() if name == "send" else buf, peer,
              group=g.process_group)
    after = (lambda: _back(tensor, buf)) if stage and name == "recv" else None
    return work, after


def _p2p_call(name: str, tensor, peer: int, group, sync: bool):
    g = _group(group)
    if peer == env.get_rank():
        raise ValueError(f"{name}: the peer is this rank")
    task = _start(name)
    work, after = _p2p(name, tensor, peer, g)
    w = _Work(work, task, after)
    if sync:
        w.wait()
    return w


def send(tensor: torch.Tensor, dst: int = 0, group=None,
         sync_op: bool = True) -> _Work:
    return _p2p_call("send", tensor, dst, group, sync_op)


def recv(tensor: torch.Tensor, src: int = 0, group=None,
         sync_op: bool = True) -> _Work:
    return _p2p_call("recv", tensor, src, group, sync_op)


def isend(tensor: torch.Tensor, dst: int = 0, group=None) -> _Work:
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor: torch.Tensor, src: int = 0, group=None) -> _Work:
    return recv(tensor, src, group, sync_op=False)


def _kind(op) -> str:
    name = getattr(op, "__name__", str(op))
    if name in ("send", "isend"):
        return "send"
    if name in ("recv", "irecv"):
        return "recv"
    raise ValueError(f"batch_isend_irecv: unrecognized op {op!r}")


class P2POp:
    """One send or receive of a ``batch_isend_irecv`` (``op`` is
    ``isend``/``send`` or ``irecv``/``recv``; ``peer`` a global rank)."""

    def __init__(self, op, tensor, peer: int, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group
        _kind(op)


def batch_isend_irecv(p2p_op_list) -> List[_Work]:
    """Start every send and receive of the list at once; returns their
    handles (``wait()`` each)."""
    kinds = [_kind(p.op) for p in p2p_op_list]
    works = []
    for kind, p in zip(kinds, p2p_op_list):
        task = _start(f"batch_{kind}")
        work, after = _p2p(kind, p.tensor, p.peer, _group(p.group))
        works.append(_Work(work, task, after))
    return works


# -- object collectives -------------------------------------------------------

@_watched
def all_gather_object(object_list: List, obj: Any, group=None) -> List:
    """Every group rank's picklable ``obj``, in group order, appended to
    ``object_list``."""
    g = _group(group)
    if not g.is_member():
        return object_list
    out: List[Any] = [None] * g.nranks
    tdist.all_gather_object(out, obj, group=g.process_group)
    object_list.extend(out)
    return object_list


@_watched
def scatter_object_list(out_object_list: List, in_object_list=None,
                        src: int = 0, group=None) -> List:
    """Rank ``src``'s ``in_object_list[i]`` appended to group rank i's
    ``out_object_list``; the other ranks may pass None."""
    g = _group(group)
    if not g.is_member():
        return out_object_list
    mine = env.get_rank() == src
    if mine and (in_object_list is None or len(in_object_list) < g.nranks):
        raise ValueError(f"scatter_object_list: rank {src} must supply "
                         f"{g.nranks} objects")
    out: List[Any] = [None]
    tdist.scatter_object_list(out, list(in_object_list) if mine else None,
                              src=src, group=g.process_group)
    out_object_list.append(out[0])
    return out_object_list

