"""Multi-process (multi-GPU, multi-node) training: the process group, each
rank's share of a batch, host-object exchange, the gradient all-reduce and
the heartbeat watchdog.

Counterpart of ``daspeech_tpu/parallel/multihost.py`` on
``torch.distributed``:

- rendezvous: :func:`initialize_distributed` resolves the topology from the
  explicit arguments, then ``DASPEECH_*``, then torchrun's ``RANK`` /
  ``WORLD_SIZE`` / ``LOCAL_RANK`` (with ``MASTER_ADDR`` / ``MASTER_PORT``),
  then SLURM, and joins the default process group: NCCL for a CUDA run,
  gloo for a CPU run (never gloo on the card);
- per-process data: every rank iterates the same seeded batches and keeps
  its contiguous block of rows (:func:`process_batch_slice`); evaluation
  batches go round-robin (:func:`shard_batches`);
- the data-parallel step: inside :func:`data_parallel` the losses divide
  by counts summed over the group (:func:`global_sum`) and
  ``MaskedBatchNorm`` takes its statistics over the group, so that each
  rank's gradient is its share of the global batch's; the step then sums
  the gradients with :func:`all_reduce_grads_`. JAX's step sees the global
  batch in one jit; this reproduces its arithmetic, not only its
  expectation.

Single-process use needs none of this: every function degrades to local
behaviour when no process group is up, and :func:`global_sum` is the
identity outside :func:`data_parallel`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

ENV_COORDINATOR = "DASPEECH_COORDINATOR"
ENV_NUM_PROCESSES = "DASPEECH_NUM_PROCESSES"
ENV_PROCESS_ID = "DASPEECH_PROCESS_ID"

# collectives of the data-parallel step, counted where they are issued (the
# card smoke run reads them to show that the step really reduced)
COUNTS: Dict[str, int] = {"grad_all_reduce": 0, "bn_sync": 0,
                          "count_sum": 0}


@dataclasses.dataclass(frozen=True)
class Topology:
    """Where this process sits: its rank among ``world_size``, its card on
    the node (``local_rank``) and the rendezvous ``init_method``."""
    rank: int
    world_size: int
    local_rank: int
    init_method: str


def resolve_topology(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     env: Optional[Mapping[str, str]] = None
                     ) -> Optional[Topology]:
    """The topology of this process, or None for a plain single-process
    run. Per field: the explicit argument, then ``DASPEECH_*``; without a
    coordinator, torchrun's environment, then SLURM's (``SLURM_NTASKS`` >
    1; its rendezvous address from ``MASTER_ADDR`` / ``MASTER_PORT``). A
    partial spec raises: N independent single-process runs in its place
    would be a data-parallel correctness bug, not a convenience."""
    env = os.environ if env is None else env
    coordinator = coordinator or env.get(ENV_COORDINATOR)
    if num_processes is None and env.get(ENV_NUM_PROCESSES):
        num_processes = int(env[ENV_NUM_PROCESSES])
    if process_id is None and env.get(ENV_PROCESS_ID):
        process_id = int(env[ENV_PROCESS_ID])
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                "--coordinator requires --num-processes and --process-id "
                "(or their DASPEECH_* env vars)")
        local = int(env.get("LOCAL_RANK", 0))
        return Topology(process_id, num_processes, local,
                        f"tcp://{coordinator}")
    if num_processes is not None or process_id is not None:
        raise ValueError(
            "--num-processes/--process-id (or DASPEECH_NUM_PROCESSES/"
            "DASPEECH_PROCESS_ID) were given without --coordinator/"
            "DASPEECH_COORDINATOR: refusing to start a single-process run "
            "from a partial multi-process spec")
    if "RANK" in env and "WORLD_SIZE" in env:            # torchrun
        return Topology(int(env["RANK"]), int(env["WORLD_SIZE"]),
                        int(env.get("LOCAL_RANK", 0)), "env://")
    if env.get("SLURM_JOB_ID") and int(env.get("SLURM_NTASKS", "1") or 1) > 1:
        if not (env.get("MASTER_ADDR") and env.get("MASTER_PORT")):
            raise ValueError(
                "a multi-task SLURM job needs MASTER_ADDR and MASTER_PORT "
                "(or --coordinator) for its rendezvous")
        return Topology(int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]),
                        int(env.get("SLURM_LOCALID", 0)),
                        f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}")
    return None


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device_type: str = "cuda",
                           init_method: Optional[str] = None) -> bool:
    """Join the default process group (``distributed/utils.py:273-347``).
    NCCL when ``device_type`` is ``cuda`` (the process's card is then
    ``cuda:LOCAL_RANK``, made current), gloo on the CPU. ``init_method``
    replaces the resolved rendezvous (e.g. ``file://`` for tests). Returns
    True when a process group is up (already, or now), False for a plain
    single-process run. Safe to call twice."""
    if dist.is_initialized():
        return True
    topo = resolve_topology(coordinator, num_processes, process_id)
    if topo is None:
        return False
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA data-parallel run needs a CUDA "
                               "device on every rank")
        torch.cuda.set_device(topo.local_rank)
    dist.init_process_group(
        backend="nccl" if device_type == "cuda" else "gloo",
        init_method=init_method or topo.init_method, rank=topo.rank,
        world_size=topo.world_size)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0)) if dist.is_initialized() \
        else 0


def process_batch_slice(num_items: int,
                        index: Optional[int] = None,
                        count: Optional[int] = None) -> slice:
    """The rows of the global batch this process keeps: a contiguous block
    per rank (the reference's ``EpochBatchIterator`` shard-by-rank).
    ``num_items`` must divide evenly over the processes."""
    pc = process_count() if count is None else count
    pi = process_index() if index is None else index
    if num_items % pc:
        raise ValueError(
            f"global batch of {num_items} does not divide over {pc} "
            f"processes: pick --max-tokens / --max-sentences so that "
            f"every bucket's batch is a multiple of {pc}")
    per = num_items // pc
    return slice(pi * per, (pi + 1) * per)


def slice_batch(batch: Dict, sl: slice, batch_dim: int = 0) -> Dict:
    """``batch`` (nested dicts of arrays) cut to rows ``sl`` of axis
    ``batch_dim``; other leaves are kept."""
    idx = (slice(None),) * batch_dim + (sl,)
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = slice_batch(v, sl, batch_dim)
        elif hasattr(v, "shape") and len(v.shape) > batch_dim:
            out[k] = v[idx]
        else:
            out[k] = v
    return out


def shard_batches(batches, index: Optional[int] = None,
                  count: Optional[int] = None):
    """Round-robin an evaluation batch stream over processes: process
    ``i`` keeps batches ``i, i + pc, ...`` (``fairseq/trainer.py:
    1442-1481``); single-process it yields everything."""
    pc = process_count() if count is None else count
    pi = process_index() if index is None else index
    for i, b in enumerate(batches):
        if i % pc == pi:
            yield b


def all_gather_host_objects(obj) -> List:
    """One picklable host object from every process, in rank order, on
    all processes (``all_gather_list``, ``distributed/utils.py:526-667``).
    Single-process: ``[obj]``."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_host(value):
    """Process 0's host value on every process (``broadcast_object``);
    the value itself in single-process runs."""
    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# ------------------------------------------------------ the data-parallel step

_STEP_GROUP: List = [None]
_STATS_GROUP: List = [None]


@contextlib.contextmanager
def data_parallel(group):
    """Within this block the losses' counts and BatchNorm's statistics are
    reduced over ``group`` (a process group, or ``dist.group.WORLD``); with
    ``group`` None the block changes nothing."""
    prev = _STEP_GROUP[0]
    _STEP_GROUP[0] = group
    try:
        yield
    finally:
        _STEP_GROUP[0] = prev


@contextlib.contextmanager
def batch_norm_group(group):
    """Within this block BatchNorm's statistics are reduced over ``group``
    instead of the step's group: the ranks of the data and ``seq`` axes
    (``parallel.partition``), whose frames together are the global
    batch's."""
    prev = _STATS_GROUP[0]
    _STATS_GROUP[0] = group
    try:
        yield
    finally:
        _STATS_GROUP[0] = prev


def step_group():
    """The process group of the data-parallel step in progress, or None."""
    return _STEP_GROUP[0]


def stats_group():
    """The process group BatchNorm's statistics are reduced over: the
    :func:`batch_norm_group`'s, else the step's; None outside a step."""
    return _STATS_GROUP[0] if _STATS_GROUP[0] is not None \
        else _STEP_GROUP[0]


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the step's process group (a count: no gradient);
    ``x`` itself outside :func:`data_parallel`."""
    group = _STEP_GROUP[0]
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    COUNTS["count_sum"] += 1
    return y


def global_sum_autograd(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over BatchNorm's process group (:func:`stats_group`),
    differentiably: the backward sums the incoming gradients over the group
    (each rank's output feeds every rank's loss)."""
    from torch.distributed.nn.functional import all_reduce

    COUNTS["bn_sync"] += 1
    return all_reduce(x, group=stats_group())


def all_reduce_grads_(grads: List[torch.Tensor], group,
                      bucket_bytes: int = 25 * 2 ** 20) -> None:
    """Sum ``grads`` over ``group`` in place: the tensors are copied into
    flat buckets of about ``bucket_bytes`` (one dtype and device each),
    each bucket is all-reduced in one call, and the sums are copied back
    (the reference's bucketed ``LegacyDistributedDataParallel``
    all-reduce)."""
    buckets: List[List[torch.Tensor]] = []
    size = 0
    for g in grads:
        if (not buckets or size + g.numel() * g.element_size() > bucket_bytes
                or buckets[-1][0].dtype != g.dtype
                or buckets[-1][0].device != g.device):
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += g.numel() * g.element_size()
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        COUNTS["grad_all_reduce"] += 1
        off = 0
        for g in bucket:
            g.copy_(flat[off: off + g.numel()].view_as(g))
            off += g.numel()


# ------------------------------------------------------------------ watchdog

class HeartbeatWatchdog:
    """Kill the process when training makes no progress within ``timeout``
    seconds (the reference's ``DistributedTimeoutWrapper``,
    ``distributed_timeout_wrapper.py:17-97``): the train loop calls
    :meth:`ping` after each update. A wedged rank otherwise stalls every
    collective on every card without an error.

    ``timeout <= 0`` disables it. The timer arms at the first ping, so the
    kernels' first build does not trip it. ``on_timeout(pid, timeout)`` is
    injectable for tests; the default dumps every thread's stack to stderr
    and sends SIGINT to the process."""

    def __init__(self, timeout: float, on_timeout=None):
        self.timeout = timeout
        self._on_timeout = on_timeout or self._default_on_timeout
        self._beat = threading.Event()
        self._stopped = False
        self._thread = None
        if timeout and timeout > 0:
            self._thread = threading.Thread(
                target=self._watch, args=(os.getpid(),), daemon=True)
            self._thread.start()

    def ping(self):
        self._beat.set()

    def stop(self):
        self._stopped = True
        self._beat.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @staticmethod
    def _default_on_timeout(pid, timeout):
        import faulthandler
        import signal
        import sys

        print(f"[daspeech] heartbeat watchdog: no training progress in "
              f"{int(timeout)} s; dumping stacks and killing the process "
              f"(set --heartbeat-timeout -1 to disable)", file=sys.stderr,
              flush=True)
        faulthandler.dump_traceback(file=sys.stderr)
        os.kill(pid, signal.SIGINT)

    def _watch(self, pid):
        self._beat.wait()                 # arm on the first update only
        while True:
            if self._stopped:
                return
            self._beat.clear()
            alive = self._beat.wait(timeout=self.timeout)
            if self._stopped:
                return
            if not alive:
                self._on_timeout(pid, self.timeout)
                return
