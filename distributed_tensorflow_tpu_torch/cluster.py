"""Cluster bootstrap: the reference's ClusterSpec and role demux.

The counterpart of ``distributed_tensorflow_tpu/cluster.py``'s
``ClusterSpec``, ``resolve_mode`` and ``maybe_initialize_distributed``.
The reference (``MNISTDist.py:94-107``) splits
``--ps_hosts``/``--worker_hosts`` into a two-job cluster and demuxes on
role: ps mode runs ``parallel/ps_emulation.py``'s roles at the addresses
``task_address`` names. In sync mode each worker is one process on one
device, and joins a ``torch.distributed`` process group whose store is
served by worker 0 (the role the chief's master service plays in the
reference).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.utils.faults import fault_point


@dataclass
class ClusterSpec:
    """Static job->hosts membership (tf.train.ClusterSpec parity)."""

    jobs: dict[str, list[str]] = field(default_factory=dict)

    @classmethod
    def from_flags(cls, FLAGS) -> "ClusterSpec":
        ps = [h for h in FLAGS.ps_hosts.split(",") if h]
        workers = [h for h in FLAGS.worker_hosts.split(",") if h]
        return cls({"ps": ps, "worker": workers})

    @property
    def ps_hosts(self) -> list[str]:
        return self.jobs.get("ps", [])

    @property
    def worker_hosts(self) -> list[str]:
        return self.jobs.get("worker", [])

    def task_address(self, job: str, index: int) -> str:
        hosts = self.jobs.get(job, [])
        if not 0 <= index < len(hosts):
            raise ValueError(
                f"task_index {index} out of range for job {job!r} with "
                f"{len(hosts)} hosts")
        return hosts[index]

    def num_tasks(self, job: str) -> int:
        return len(self.jobs.get(job, []))


def resolve_mode(FLAGS) -> str:
    """Demux --mode=auto: a reference-style role launch (--ps_hosts set)
    means ps mode; more than one worker means sync; otherwise local."""
    mode = FLAGS.mode
    if mode != "auto":
        return mode
    if FLAGS.ps_hosts:
        return "ps"
    if len([h for h in FLAGS.worker_hosts.split(",") if h]) > 1:
        return "sync"
    return "local"


def _initialize_with_retry(init_fn, *, retries: int, backoff_s: float,
                           what: str, sleep=None, cleanup_fn=None) -> None:
    """Bounded retry with linear backoff around a cluster join.

    A worker relaunched after a crash can reach the join while worker 0,
    which serves the store, is still coming back. Attempt k waits k x
    ``backoff_s`` (at most 30 s) after a failure; the last attempt
    re-raises, so a dead store still fails after a bounded wait.
    Misconfiguration (a bad address, API misuse) raises at once."""
    sleep = sleep or time.sleep
    for attempt in range(retries + 1):
        try:
            fault_point("init", attempt=attempt)
            init_fn()
            return
        except (TypeError, ValueError, KeyError, AttributeError,
                AssertionError):
            raise
        except Exception as e:  # noqa: BLE001 — connection-class errors
            if attempt >= retries:
                raise
            if cleanup_fn is not None:
                cleanup_fn()
            delay = min(backoff_s * (attempt + 1), 30.0)
            print(f"{what} failed (attempt {attempt + 1}/{retries + 1}: "
                  f"{type(e).__name__}: {e}); worker 0 may still be "
                  f"relaunching — retrying in {delay:.1f}s", flush=True)
            sleep(delay)


def backend_for(device) -> str:
    """NCCL between cards, gloo between CPU processes."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize_distributed(cluster: ClusterSpec, task_index: int,
                                 device, init_retries: int = 0,
                                 init_backoff_s: float = 2.0,
                                 init_timeout_s: float = 0.0) -> bool:
    """Sync mode: join the process group of ``--worker_hosts``, as rank
    ``task_index`` of ``len(worker_hosts)``, through the TCP store at
    ``worker_hosts[0]``; NCCL when ``device`` is a card, gloo on the CPU.
    One worker makes a group of one (the collectives still run).

    Returns True when this call made the group, False when one was
    already initialized (it must agree with the flags). ``init_retries``
    and ``init_backoff_s`` arm the crash-restart path
    (``_initialize_with_retry``); ``init_timeout_s`` > 0 caps each
    attempt's own wait for the store."""
    workers = cluster.worker_hosts
    if not workers:
        raise ValueError("sync mode needs --worker_hosts (host:port of each "
                         "worker; the first serves the store)")
    if not 0 <= task_index < len(workers):
        raise ValueError(f"--task_index={task_index} is not one of the "
                         f"{len(workers)} workers in --worker_hosts")
    device = torch.device(device)
    backend = backend_for(device)
    want = (task_index, len(workers), backend)
    if dist.is_initialized():
        have = (dist.get_rank(), dist.get_world_size(), dist.get_backend())
        if have != want:
            raise ValueError(f"a process group is already up as (rank, "
                             f"world, backend) {have}; the flags ask for "
                             f"{want}")
        return False
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    init_method = f"tcp://{workers[0]}"
    kwargs = dict(backend=backend, init_method=init_method, rank=task_index,
                  world_size=len(workers))
    if init_timeout_s > 0:
        kwargs["timeout"] = timedelta(seconds=init_timeout_s)

    def _cleanup():
        if dist.is_initialized():
            dist.destroy_process_group()

    _initialize_with_retry(
        lambda: dist.init_process_group(**kwargs),
        retries=max(0, int(init_retries)), backoff_s=float(init_backoff_s),
        what=f"torch.distributed.init_process_group({init_method}, rank "
             f"{task_index} of {len(workers)}, {backend})",
        cleanup_fn=_cleanup)
    return True
