"""Joining one training job across processes and cards: the port's side
of the gang-exec env contract (backends/task_codegen.py), in place of
the reference's `jax.distributed.initialize`
(skypilot_tpu/recipes/train_lm.py `_maybe_init_distributed`).

The contract is the reference's: `JAX_NUM_PROCESSES` processes, one a
host, this one `JAX_PROCESS_ID`, process 0 reachable at
`JAX_COORDINATOR_ADDRESS` (host:port). A count of 1 or less (or no env)
means no job to join. JAX drives every local chip from that one
process; torch wants one process a card, so a host with k cards runs k
workers (`launch`): worker i of process p is rank p * k + i of
`JAX_NUM_PROCESSES * k`. With k = 1 (`--cpu`, or one card) the process
is its own worker. A job of one host and k > 1 cards and no gang env
coordinates on a free localhost port.

`join` calls `init_process_group(backend, init_method='tcp://<addr>',
rank, world_size, timeout)`: NCCL on the card, gloo on the CPU, never
one for the other. A peer that does not arrive within the job's
timeout (`TIMEOUT_S`, 300 s: `jax.distributed.initialize`'s own
default) raises `JoinError` naming the coordinator; the same timeout
bounds every collective of the default group. Host-side
agreement (checkpoint barriers, the preemption flag, the checkpoint
cadence) runs on a second, gloo group (`control_group`) with a longer
timeout (`CONTROL_TIMEOUT_S`), so rank 0 may write a checkpoint while
the others wait, and reading a flag never waits for the card's queue.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import sys
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

from skypilot_tpu_torch.utils import net

NUM_PROCESSES_ENV = 'JAX_NUM_PROCESSES'
PROCESS_ID_ENV = 'JAX_PROCESS_ID'
COORDINATOR_ENV = 'JAX_COORDINATOR_ADDRESS'
#: Seconds a rank waits for the job to form, and for each collective of
#: the default group.
TIMEOUT_S = 300.0
#: Timeout of the host-side control group: a checkpoint write or read
#: on rank 0 while the others wait (torch's default for gloo).
CONTROL_TIMEOUT_S = 1800.0
#: Seconds the launcher lets the other workers finish after one failed
#: before it stops them.
GRACE_S = 30.0

_control = None


class JoinError(RuntimeError):
    """A rank could not join the job (a peer never arrived)."""


@dataclasses.dataclass(frozen=True)
class Job:
    """One worker's place in the job."""
    rank: int
    world: int
    local_rank: int
    process_id: int
    num_processes: int
    coordinator: str
    backend: str
    timeout_s: float = TIMEOUT_S

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def gang() -> Tuple[int, int, Optional[str]]:
    """(num_processes, process_id, coordinator) from the gang env;
    (1, 0, None) when there is no multi-process job."""
    num = int(os.environ.get(NUM_PROCESSES_ENV, '1') or 1)
    if num <= 1:
        return 1, 0, None
    return (num, int(os.environ[PROCESS_ID_ENV]),
            os.environ[COORDINATOR_ENV])


def jobs(cpu: bool, workers: int,
         timeout_s: Optional[float] = None) -> List[Job]:
    """The jobs of this host's `workers` workers under the gang env
    (`timeout_s` default: TIMEOUT_S)."""
    num, pid, coord = gang()
    if coord is None:
        coord = f'127.0.0.1:{net.free_port()}'
    return [Job(rank=pid * workers + i, world=num * workers, local_rank=i,
                process_id=pid, num_processes=num, coordinator=coord,
                backend='gloo' if cpu else 'nccl',
                timeout_s=timeout_s or TIMEOUT_S)
            for i in range(workers)]


def join(job: Job) -> None:
    """init_process_group for `job` (and the control group); raises
    JoinError naming the coordinator when the job does not form within
    the timeout."""
    global _control
    import torch
    import torch.distributed as dist
    limit = job.timeout_s
    timeout = datetime.timedelta(seconds=limit)
    if job.backend == 'nccl':
        torch.cuda.set_device(job.local_rank)
    try:
        dist.init_process_group(
            job.backend, init_method=f'tcp://{job.coordinator}',
            rank=job.rank, world_size=job.world, timeout=timeout)
        _control = dist.new_group(
            backend='gloo',
            timeout=datetime.timedelta(seconds=CONTROL_TIMEOUT_S))
    except Exception as e:  # pylint: disable=broad-except
        raise JoinError(
            f'rank {job.rank} of {job.world} could not join the job at '
            f'tcp://{job.coordinator} within {limit:g} s '
            f'({type(e).__name__}: {str(e).splitlines()[0] if str(e) else e})'
        ) from e


def leave() -> None:
    global _control
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _control = None


def control_group():
    """The gloo group for host-side agreement; created here (by every
    rank at the same point) when the job was formed elsewhere. None
    outside a job."""
    global _control
    import torch.distributed as dist
    if not dist.is_initialized():
        return None
    if _control is None:
        _control = dist.new_group(
            backend='gloo',
            timeout=datetime.timedelta(seconds=CONTROL_TIMEOUT_S))
    return _control


def rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def broadcast(obj: Any, src: int = 0) -> Any:
    """`obj` as rank `src` has it, on every rank (identity outside a
    job)."""
    import torch.distributed as dist
    group = control_group()
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is true on any rank."""
    import torch
    import torch.distributed as dist
    group = control_group()
    if group is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def _worker(target: Callable, args: Sequence[Any], job: Job) -> None:
    """A spawned worker: `target(job, *args)`; its SystemExit code is
    the worker's exit code."""
    target(job, *args)


def launch(target: Callable, args: Sequence[Any], jobs_: List[Job],
           deadline_s: Optional[float] = None) -> int:
    """Run `target(job, *args)` in one spawned process per job and wait
    for them; returns 0, or the exit code of the first worker to fail
    (the others get GRACE_S to end on their own, then are stopped), or
    124 when `deadline_s` passes first (every worker is stopped)."""
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=_worker, args=(target, tuple(args), job),
                         name=f'worker-{job.rank}') for job in jobs_]
    for p in procs:
        p.start()
    failed: Optional[int] = None
    start = time.monotonic()
    deadline = None if deadline_s is None else start + deadline_s
    try:
        while any(p.is_alive() for p in procs):
            for p in procs:
                if failed is None and p.exitcode not in (None, 0):
                    failed = p.exitcode
                    grace = time.monotonic() + GRACE_S
                    deadline = grace if deadline is None \
                        else min(deadline, grace)
            if deadline is not None and time.monotonic() > deadline:
                if failed is None:
                    failed = 124
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join()
    if failed is None:
        failed = next((p.exitcode for p in procs if p.exitcode), 0)
    if failed < 0:           # killed by a signal
        failed = 128 - failed
    sys.stdout.flush()
    return failed
