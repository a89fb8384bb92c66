"""Distributed MNIST training on the port: the reference's entry point.

    python -m distributed_tensorflow_tpu_torch.mnist_dist [flags]

The counterpart of the repository's ``mnist_dist.py``, with the
reference's flag surface (``MNISTDist.py:13-31``) and role demux
(``:93-107``). Only the local loop is ported: one process training on
``--device`` (``cuda`` by default; without a card it exits non-zero,
and ``--device cpu`` runs on the CPU). ps mode and sync mode over more
than one worker raise, and ``--mode auto`` never upgrades a local run to
sync. f32 runs in full f32: TF32 is off for cuBLAS and cuDNN.

Examples:
  python -m distributed_tensorflow_tpu_torch.mnist_dist --optimizer adam \\
      --training_iter 1000 --pallas
  python -m distributed_tensorflow_tpu_torch.mnist_dist --device cpu \\
      --training_iter 3
"""

from __future__ import annotations

from distributed_tensorflow_tpu_torch import flags
from distributed_tensorflow_tpu_torch.cluster import (
    ClusterSpec,
    require_ported,
    resolve_mode,
)

FLAGS = flags.FLAGS


def main(_):
    from distributed_tensorflow_tpu_torch.training.loop import (
        evaluate_only,
        train,
    )

    if FLAGS.eval_only:
        # restore-and-measure, no training, before the role demux
        evaluate_only(FLAGS)
        return 0
    mode = resolve_mode(FLAGS)
    require_ported(mode, ClusterSpec.from_flags(FLAGS))
    train(FLAGS, mode="local")
    return 0


if __name__ == "__main__":
    flags.define_reference_flags()
    flags.run(main)
