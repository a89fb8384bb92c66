"""Distributed MNIST training on the port: the reference's entry point.

    python -m distributed_tensorflow_tpu_torch.mnist_dist [flags]

The counterpart of the repository's ``mnist_dist.py``, with the
reference's flag surface (``MNISTDist.py:13-31``) and role demux
(``:93-107``). Local mode trains one process on ``--device`` (``cuda`` by
default; without a card it exits non-zero, and ``--device cpu`` runs on
the CPU). Sync mode is synchronous data parallelism, one process per
device: each worker joins a ``torch.distributed`` group (NCCL on cards,
gloo on the CPU) through worker 0's address, trains on its share of the
batch, and the gradients are averaged every step. ps mode raises. f32
runs in full f32: TF32 is off for cuBLAS and cuDNN.

Examples:
  python -m distributed_tensorflow_tpu_torch.mnist_dist --optimizer adam \\
      --training_iter 1000 --pallas
  # sync DP on two cards of one host, one process each:
  python -m distributed_tensorflow_tpu_torch.mnist_dist --mode sync \\
      --worker_hosts localhost:2222,localhost:2223 --task_index 0 \\
      --device cuda:0 --device_data &
  python -m distributed_tensorflow_tpu_torch.mnist_dist --mode sync \\
      --worker_hosts localhost:2222,localhost:2223 --task_index 1 \\
      --device cuda:1 --device_data
  python -m distributed_tensorflow_tpu_torch.mnist_dist --device cpu \\
      --training_iter 3
"""

from __future__ import annotations

from distributed_tensorflow_tpu_torch import flags
from distributed_tensorflow_tpu_torch.cluster import (
    ClusterSpec,
    maybe_initialize_distributed,
    require_ported,
    resolve_mode,
)

FLAGS = flags.FLAGS


def main(_):
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.serving.engine import (
        resolve_device,
    )
    from distributed_tensorflow_tpu_torch.training.loop import (
        evaluate_only,
        train,
    )

    if FLAGS.eval_only:
        # restore-and-measure, no training, before the role demux
        evaluate_only(FLAGS)
        return 0
    mode = resolve_mode(FLAGS)
    cluster = ClusterSpec.from_flags(FLAGS)
    require_ported(mode, cluster)
    resolve_device(FLAGS.device)  # no card and no --device cpu: raise here
    joined = mode == "sync" and maybe_initialize_distributed(
        cluster, FLAGS.task_index, FLAGS.device,
        init_retries=FLAGS.init_retries, init_backoff_s=FLAGS.init_backoff_s,
        init_timeout_s=FLAGS.init_timeout_s)
    try:
        train(FLAGS, mode=mode)
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    flags.define_reference_flags()
    flags.run(main)
