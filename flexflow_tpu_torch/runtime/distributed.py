"""Multi-process bootstrap: one process per device over torch.distributed.

The PyTorch counterpart of flexflow_tpu/runtime/distributed.py. Where the
JAX package joins `jax.distributed` and sees every host's devices in one
process, the port runs ONE process per device (torchrun's model): each
process joins the default process group and owns one card (or, when the
caller asks for the CPU, one gloo rank). FFModel.compile then builds a
device mesh over the group (parallel/mesh.py) and the mesh executor
(parallel/executor.py MeshExecutor) runs the PCG as one SPMD program.

Env contract, the JAX package's first:
    FF_COORDINATOR_ADDRESS  host:port of process 0
    FF_NUM_PROCESSES        total processes
    FF_PROCESS_ID           this process's rank
and, where those are unset, torchrun's: MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK and LOCAL_RANK (the card this process drives; without
it, the rank modulo the visible cards).

The backend is "nccl" for a CUDA device and "gloo" for the CPU, with no
fallback from one to the other: a config that asks for a card on a
machine without one raises (config.resolve_device).
"""
from __future__ import annotations

import datetime
import gc
import logging
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger("flexflow_tpu_torch.runtime.distributed")

# the device this process joined the group with (None: not joined by us)
_device: Optional[torch.device] = None


def is_initialized() -> bool:
    """Whether the default process group is up, whether init_distributed
    or the launcher brought it up."""
    return dist.is_available() and dist.is_initialized()


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if os.environ.get(n, "") != "":
            return int(os.environ[n])
    return None


def _coordinator() -> Optional[str]:
    addr = os.environ.get("FF_COORDINATOR_ADDRESS")
    if addr:
        return addr
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None, retry_policy=None, *,
                     device: str = "cuda",
                     timeout_s: float = 300.0) -> Tuple[int, int, torch.device]:
    """Join (or start) the process group of one process per device.
    Returns (rank, world size, this process's device). Idempotent.

    `device` is "cuda" (a card: the NCCL backend; this process drives card
    `local_device_ids[0]`, else LOCAL_RANK, else the rank modulo the
    visible cards, and `torch.cuda.set_device` selects it) or "cpu" (the
    gloo backend). The connection to the coordinator is retried with
    exponential backoff (runtime/resilience.py; FF_INIT_MAX_ATTEMPTS /
    FF_INIT_BASE_DELAY_S), as the JAX package retries it: restarted
    workers race the coordinator coming back. `timeout_s` bounds every
    collective of the group, so a rank that never arrives fails its peers
    instead of hanging them."""
    from ..config import resolve_device
    from .resilience import RetryPolicy, retry

    global _device
    if is_initialized():
        return dist.get_rank(), dist.get_world_size(), current_device()
    addr = coordinator_address or _coordinator()
    world = num_processes if num_processes is not None else _env_int(
        "FF_NUM_PROCESSES", "WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int(
        "FF_PROCESS_ID", "RANK")
    if addr is None or world is None or rank is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the number of "
            "processes and this process's rank: pass them, or export "
            "FF_COORDINATOR_ADDRESS/FF_NUM_PROCESSES/FF_PROCESS_ID, or run "
            "under torchrun (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if local_device_ids is not None:
            index = int(list(local_device_ids)[0])
        else:
            local = _env_int("LOCAL_RANK")
            index = local if local is not None else \
                rank % torch.cuda.device_count()
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    policy = retry_policy or RetryPolicy(
        max_attempts=int(os.environ.get("FF_INIT_MAX_ATTEMPTS", "4")),
        base_delay_s=float(os.environ.get("FF_INIT_BASE_DELAY_S", "1.0")),
        max_delay_s=30.0,
        retry_on=(RuntimeError, OSError, ConnectionError, TimeoutError))
    retry(lambda: dist.init_process_group(
        backend, init_method=f"tcp://{addr}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s)),
        policy,
        on_retry=lambda attempt, e, d: logger.warning(
            "coordinator connect attempt %d failed (%s); retrying in %.1fs",
            attempt + 1, e, d))
    _device = dev
    logger.info("process group up: rank %d of %d on %s (%s)", rank, world,
                dev, backend)
    return rank, world, dev


def current_device() -> Optional[torch.device]:
    """The device of this process in the group: the one init_distributed
    joined with, else (a group the launcher brought up) the current card
    for NCCL and the CPU for gloo; None without a group."""
    if not is_initialized():
        return None
    if _device is not None:
        return _device
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shutdown() -> None:
    """Destroy the default process group. Safe to call repeatedly and
    when no group is up. Unreachable objects are collected first: a
    captured CUDA graph (an executor and its graphs form a reference
    cycle) that holds NCCL work keeps its communicator from being
    destroyed, and the destroy then waits forever."""
    global _device
    _device = None
    if is_initialized():
        gc.collect()
        if dist.get_backend() == "nccl":
            torch.cuda.synchronize()
        dist.barrier()
        dist.destroy_process_group()


def assert_same(value, message: str) -> None:
    """Raise on every rank unless every rank passed an equal `value` (a
    picklable signature), with one all-gather: a contract every process
    must keep (the same global batch, the same strategy) fails loudly
    instead of corrupting training or hanging a later collective. A
    no-op without a group."""
    if not is_initialized() or dist.get_world_size() == 1:
        return
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, value)
    if any(g != got[0] for g in got):
        differ = [r for r, g in enumerate(got) if g != got[0]]
        raise RuntimeError(f"{message} (ranks {differ} differ from rank 0)")


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_world_size() -> int:
    """Processes on this host: LOCAL_WORLD_SIZE (torchrun) when set, else
    the world size (one host), else 1."""
    n = _env_int("LOCAL_WORLD_SIZE")
    if n is not None:
        return n
    return process_count()


def broadcast_object(value, src: int = 0):
    """Rank `src`'s `value` (a picklable object) on every rank, with one
    broadcast; `value` itself without a group. What every rank must agree
    on that one rank decides (the serving batcher's admissions, the
    checkpoint a restore reads) goes through this."""
    if not is_initialized() or dist.get_world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def broadcast_optional(value, src: int = 0):
    """`broadcast_object` of rank `src`'s `value`, or None on every rank
    where `src`'s is None: one broadcast of an integer first, and the
    pickled object's only where there is one, so a loop that mostly has
    nothing to say (the serving batcher's iterations) pays one small
    broadcast a turn."""
    if not is_initialized() or dist.get_world_size() == 1:
        return value
    has = torch.tensor([int(value is not None)], dtype=torch.int64,
                       device=current_device())
    dist.broadcast(has, src=src)
    return broadcast_object(value, src) if has.item() else None


def any_rank(flag: bool) -> bool:
    """Whether `flag` is true on any rank (one all-reduce of a flag;
    `flag` itself without a group): a decision no rank may take alone (a
    preemption, a failed canary) is taken by all."""
    return any_ranks([flag])[0]


def any_ranks(flags) -> list:
    """`any_rank` of each of `flags`, with one all-reduce."""
    if not is_initialized() or dist.get_world_size() == 1:
        return [bool(f) for f in flags]
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int64,
                     device=current_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [bool(v) for v in t.tolist()]


def max_over_ranks(value: int) -> int:
    """The largest of the ranks' integers (one all-reduce); `value`
    itself without a group."""
    if not is_initialized() or dist.get_world_size() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=current_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def barrier() -> None:
    """Wait for every rank (a no-op without a group)."""
    if is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
