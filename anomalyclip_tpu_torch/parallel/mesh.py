"""Process groups and the collectives of data parallelism: the counterpart of
anomalyclip_tpu/parallel/mesh.py.

The JAX package runs one process over N local devices and shards the global
batch over a 1-D ``data`` mesh; XLA inserts the collectives. PyTorch's idiom is
one process per card, so the same semantics become N ranks of
``torch.distributed``: every rank holds the parameters, loads its block of each
half of the global batch, and the step computes what one process computes on
the whole batch (sync-BN over every rank's rows, the smoothness term across
rank boundaries, the gradients all-reduced in one bucket before AdamW).

- ``init_distributed`` joins a group from the standard environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or a given
  init method, once; a single process does not initialize.
- The backend is NCCL when every rank has a card of its own and gloo on the
  CPU. On the card gloo runs only when the caller names it, as ranks that
  share one card do; NCCL with more ranks than cards raises.
- Collectives on host arrays (flags, fp64 sums, gathers) run on the CPU under
  gloo and on the rank's card under NCCL, so that a gather never hands gloo a
  CUDA tensor.

Nothing here initializes anything when the module is imported.
"""

from __future__ import annotations

import datetime
import os
import sys
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# env: seconds a collective may wait for its peers before the group raises
TIMEOUT_ENV = "ANOMALYCLIP_DIST_TIMEOUT_S"

GLOO_ROUTE = (
    "ranks that share a card take the gloo route: "
    "parallel.mesh.init_distributed(backend='gloo')"
)


_STARTED = time.monotonic()


def log_stage(what: str) -> None:
    """One line on stderr naming the stage a rank has reached, on every rank
    of a group (the console logger speaks only on rank 0): where a run of
    ranks hangs or dies, the last such line of each rank says how far it got.
    Outside a group it says nothing unless ``RANK`` is set (a spawned rank
    before its rendezvous)."""
    if not distributed() and "RANK" not in os.environ:
        return
    me = rank() if distributed() else os.environ["RANK"]
    print(f"[rank {me}/{os.environ.get('WORLD_SIZE', '?')} +{time.monotonic() - _STARTED:.1f}s] {what}",
          file=sys.stderr, flush=True)


def distributed() -> bool:
    """Whether this process is in an initialized group (of any size, one
    included)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def local_rank() -> int:
    """``LOCAL_RANK`` (set by torchrun and by the port's spawn), else the rank."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def _timeout(timeout_s: Optional[float]) -> Optional[datetime.timedelta]:
    if timeout_s is None and os.environ.get(TIMEOUT_ENV):
        timeout_s = float(os.environ[TIMEOUT_ENV])
    return None if timeout_s is None else datetime.timedelta(seconds=float(timeout_s))


def init_distributed(
    backend: Optional[str] = None,
    device=None,
    *,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join a process group (JAX mesh.py:30-81) -> whether this process is in
    one. Idempotent: an initialized group is kept as it is.

    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK``; from the
    environment, a world of one does not initialize (an explicit
    ``world_size=1`` does: a one-rank group). ``init_method`` defaults to
    ``env://`` (``MASTER_ADDR`` and ``MASTER_PORT``); a launcher that
    rendezvouses otherwise (a ``file://`` path) joins before it calls an entry
    point, whose own call then keeps the group. ``backend`` defaults to NCCL when ``device`` (default:
    the card when torch sees one) is a card, gloo on the CPU. NCCL needs a card
    of its own for every rank of the host (``LOCAL_WORLD_SIZE``, else the
    world) and raises otherwise, naming the gloo route; it never switches
    backends by itself. ``timeout_s`` (default ``ANOMALYCLIP_DIST_TIMEOUT_S``,
    else torch's) bounds every collective's wait. A failed
    ``init_process_group`` raises."""
    if distributed():
        return True
    from_env = world_size is None
    world = int(os.environ.get("WORLD_SIZE", "1") or 1) if from_env else int(world_size)
    if from_env and world <= 1:
        return False
    me = int(os.environ.get("RANK", "0") or 0) if rank is None else int(rank)
    init_method = init_method or "env://"
    on_card = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    backend = backend or ("nccl" if on_card else "gloo")
    if backend == "nccl":
        if not on_card:
            raise RuntimeError("NCCL runs on cards: pass backend='gloo' for ranks on the CPU")
        cards = torch.cuda.device_count()
        host_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world) or world)
        mine = int(os.environ.get("LOCAL_RANK", me))
        if host_ranks > cards or mine >= cards:
            raise RuntimeError(
                f"NCCL needs a card of its own for every rank: {host_ranks} rank(s) on this host, "
                f"{cards} card(s), local rank {mine}; {GLOO_ROUTE}"
            )
        torch.cuda.set_device(mine)
    kwargs = {}
    timeout = _timeout(timeout_s)
    if timeout is not None:
        kwargs["timeout"] = timeout
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=me, **kwargs)
    return True


def rank_device(device=None) -> torch.device:
    """The device of this rank: the CPU when ``device`` is the CPU, a card
    named with its index as it is, else (``None`` or ``"cuda"``) ``cuda:
    LOCAL_RANK`` in a group and ``cuda`` outside one. A rank whose card is not
    there raises: it never moves to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or device.index is not None or not distributed():
        return device
    mine, cards = local_rank(), torch.cuda.device_count()
    if mine >= cards:
        raise RuntimeError(f"rank {rank()}: its card cuda:{mine} is not there ({cards} visible); {GLOO_ROUTE}")
    return torch.device("cuda", mine)


def usable_data_devices(half_batch: int, devices: Optional[Sequence] = None) -> list:
    """The devices a data-parallel run uses (JAX mesh.py:84-107). Each half of
    the batch shards apart, so a count must divide ``half_batch``. Outside a
    group: the largest prefix of ``devices`` (default: every card, else the
    CPU) that divides it, the count a spawned run takes. In a joined group of
    more than one rank the group is the mesh, and a half-batch it does not
    divide raises."""
    if devices is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(cards)] or [torch.device("cpu")]
    devices = list(devices)
    if world_size() > 1:
        if half_batch % world_size():
            raise ValueError(
                f"multi-process run: per-half batch {half_batch} must divide evenly over "
                f"{world_size()} ranks; adjust data.batch_size"
            )
        return devices
    n = len(devices)
    while n > 1 and half_batch % n:
        n -= 1
    return devices[:n]


# ---------------------------------------------------------------------------
# collectives on host values: gloo on the CPU, NCCL on the rank's card
# ---------------------------------------------------------------------------


def comm_device() -> torch.device:
    """Where a host value goes for a collective: the card under NCCL, the CPU
    under gloo."""
    if distributed() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allreduce_host(values: np.ndarray, op, group=None) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(values)).to(comm_device())
    dist.all_reduce(t, op=op, group=group)
    return t.cpu().numpy()


def any_rank(flag: bool, group=None) -> bool:
    """True on every rank when ``flag`` is set on any rank of ``group``: the
    global stop decision (JAX module.py:781-794)."""
    if not distributed():
        return bool(flag)
    return bool(_allreduce_host(np.asarray([int(bool(flag))], np.int64), dist.ReduceOp.MAX, group)[0])


def every_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is set on every rank."""
    if not distributed():
        return bool(flag)
    return bool(_allreduce_host(np.asarray([int(bool(flag))], np.int64), dist.ReduceOp.MIN)[0])


def sum_f64(values) -> np.ndarray:
    """The sum over ranks of ``values`` in fp64 (the ncentroid's sum and count,
    JAX module.py:455-463)."""
    values = np.asarray(values, np.float64)
    if not distributed():
        return values
    return _allreduce_host(values, dist.ReduceOp.SUM)


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj``, on every rank."""
    if not distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, device=comm_device())
    return box[0]


def allgather_host(values: np.ndarray) -> np.ndarray:
    """(P, *shape): every rank's ``values``, which must have one shape and
    dtype on every rank, in rank order. The tensors are host tensors under
    gloo, so ranks that share one card gather through the CPU."""
    values = np.ascontiguousarray(values)
    if not distributed():
        return values[None]
    mine = torch.from_numpy(values).to(comm_device())
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return np.stack([p.cpu().numpy() for p in parts])


# ---------------------------------------------------------------------------
# collectives of the training step, on the tensors where they lie
# ---------------------------------------------------------------------------


def across_ranks(dp: Optional[Tuple[int, int]]) -> bool:
    """Whether ``dp=(rank, ranks)`` splits a batch over more than one rank. A
    batch on one rank (no ``dp``, or a one-rank group) is the whole batch, and
    the model computes on it as one process does, through the same graph."""
    return dp is not None and dp[1] > 1


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) whose backward is the all-reduce (sum) of the gradient,
    as ``torch.distributed.nn.functional.all_reduce``'s."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        return _SumOverRanks.apply(grad)


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The sum over every rank of ``t``, through a collective that carries the
    gradient: its backward sums the ranks' gradients, so that a rank's backward
    of a function of the global value reaches every rank's input as the global
    reduction's backward does (JAX selector.py:99-124 under a data mesh)."""
    return _SumOverRanks.apply(t)


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The mean over every rank of ``t`` (no gradient), on its device."""
    if not distributed():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t / dist.get_world_size()


def mean_gradients_(params: Sequence[torch.Tensor]) -> None:
    """Replace each parameter's gradient by its mean over the ranks, all of them
    in one bucket and one all-reduce (a missing gradient counts as zeros)."""
    if not distributed():
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset : offset + n].view_as(p).clone()
        offset += n


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Every rank's ``tensors`` set in place to rank ``src``'s, in one
    broadcast per tensor (the parameters start from rank 0's)."""
    if not distributed():
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src)
