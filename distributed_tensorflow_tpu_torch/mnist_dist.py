"""Distributed MNIST training on the port: the reference's entry point.

    python -m distributed_tensorflow_tpu_torch.mnist_dist [flags]

The counterpart of the repository's ``mnist_dist.py``, with the
reference's flag surface (``MNISTDist.py:13-31``) and role demux
(``:93-107``). Local mode trains one process on ``--device`` (``cuda`` by
default; without a card it exits non-zero, and ``--device cpu`` runs on
the CPU). Sync mode is synchronous data parallelism, one process per
device: each worker joins a ``torch.distributed`` group (NCCL on cards,
gloo on the CPU) through worker 0's address, trains on its share of the
batch, and the gradients are averaged every step. With ``--ps_hosts`` it
is the reference's asynchronous topology (``parallel/ps_emulation.py``):
``--job_name=ps`` serves a shard of the params from the host until a
shutdown message, ``--job_name=worker`` computes gradients on its
``--device`` and pushes them. f32 runs in full f32: TF32 is off for
cuBLAS and cuDNN.

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
  # the reference's ps topology: one ps, two workers on one card
  python -m distributed_tensorflow_tpu_torch.mnist_dist --job_name=ps \\
      --task_index=0 --ps_hosts=localhost:2222 \\
      --worker_hosts=localhost:2223,localhost:2224 &
  python -m distributed_tensorflow_tpu_torch.mnist_dist --job_name=worker \\
      --task_index=1 --ps_hosts=localhost:2222 \\
      --worker_hosts=localhost:2223,localhost:2224 --pallas &
  python -m distributed_tensorflow_tpu_torch.mnist_dist --job_name=worker \\
      --task_index=0 --ps_hosts=localhost:2222 \\
      --worker_hosts=localhost:2223,localhost:2224 --pallas
"""

from __future__ import annotations

import sys

from distributed_tensorflow_tpu_torch import flags
from distributed_tensorflow_tpu_torch.cluster import (
    ClusterSpec,
    maybe_initialize_distributed,
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
    if mode == "ps":
        if FLAGS.job_name not in ("ps", "worker"):
            print(f"--job_name must be 'ps' or 'worker' when --ps_hosts is "
                  f"set (got {FLAGS.job_name!r})", file=sys.stderr)
            return 2
        from distributed_tensorflow_tpu_torch.parallel import ps_emulation

        # fail every role here: a ps left in serve_forever would wait for
        # workers that died at startup
        err = ps_emulation.ps_unsupported_flag_error(FLAGS)
        if err is not None:
            print(err, file=sys.stderr)
            return 2
        if FLAGS.job_name == "ps":
            # reference: server.join(); the ps never touches the card
            ps_emulation.run_parameter_server(cluster, FLAGS)
            return 0
        return ps_emulation.run_worker(cluster, FLAGS)
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
