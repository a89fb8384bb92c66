"""PyTorch and CUDA port of ``distributed_tensorflow_tpu``, for an NVIDIA H100.

The JAX package beside this one is the reference: this package keeps its
module paths, public names, parameter layouts (HWIO conv kernels, NHWC
activations at public functions) and on-disk checkpoint format, so a
checkpoint written by either package restores in the other.

It imports ``torch`` and never ``jax`` or ``distributed_tensorflow_tpu``.
Entry points run on ``cuda`` unless the caller asks for the CPU, and raise
when no card is present instead of falling back.

Ported so far, for the reference ``deep_cnn``, the MLP and the CIFAR
ResNets: training from the reference's entry point (``python -m
distributed_tensorflow_tpu_torch.mnist_dist``), local or synchronous
data-parallel on ``torch.distributed`` (one process per GPU), fed from
the host or from a split resident on the device with each step replayed
from a CUDA graph (``--device_data``), or in the reference's own
asynchronous parameter-server topology (``--ps_hosts``,
``parallel/ps_emulation.py``); checkpoints in both of the JAX package's
formats and their inspect CLI; and serving (``python -m
distributed_tensorflow_tpu_torch.serving``). The ``wd1`` layer's fused
matmul + bias + ReLU is a hand-written CUDA kernel
(``ops/csrc/fused_dense_relu.cu``).
"""
