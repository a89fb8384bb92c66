"""Cluster bootstrap: the reference's ClusterSpec and role demux.

The counterpart of ``distributed_tensorflow_tpu/cluster.py``'s
``ClusterSpec`` and ``resolve_mode``. The reference (``MNISTDist.py:94-107``)
splits ``--ps_hosts``/``--worker_hosts`` into a two-job cluster and demuxes
on role. Only the local mode is ported: ``require_ported`` raises for ps
mode and for sync mode over more than one worker.
"""

from __future__ import annotations

from dataclasses import dataclass, field


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


def require_ported(mode: str, cluster: ClusterSpec) -> None:
    """Raise for the modes the port does not run yet: ps, and sync over
    more than one worker. Sync over one worker is the local loop."""
    if mode == "ps":
        raise NotImplementedError(
            "ps mode (the asynchronous parameter-server topology) is not "
            "yet ported to distributed_tensorflow_tpu_torch")
    if mode == "sync" and cluster.num_tasks("worker") > 1:
        raise NotImplementedError(
            f"sync mode over {cluster.num_tasks('worker')} workers is not "
            f"yet ported to distributed_tensorflow_tpu_torch")
