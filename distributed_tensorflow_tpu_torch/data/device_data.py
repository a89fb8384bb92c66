"""A split resident in device memory, for the device-resident train step.

The counterpart of ``distributed_tensorflow_tpu/data/device_data.py``
(``DeviceData``, the replicated branch of ``put_device_data``). The
reference uploads every batch from the client (the feed_dict at
``MNISTDist.py:179,188``). Here the whole train split (MNIST: 60,000 x
784 uint8, 47 MB; CIFAR-10: 50,000 x 3072 uint8, 154 MB; an LM split:
N x (S + 1) tokens) is copied to the device once, and each step gathers
its minibatch there (``training/device_step.py``), so no batch crosses
from the host while the model trains. Every data-parallel rank holds
the whole split, as every reference worker reads all of MNIST
(``MNISTDist.py:167``), and samples its own rows.

Batches are sampled uniformly with replacement: statistically the
shuffled-epoch walk of ``DataSet.next_batch``, but not its order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DeviceData(NamedTuple):
    """One split on the device: ``images`` uint8 [N, H*W*C] (784 for
    MNIST, 3072 for CIFAR-10; the model normalizes on the device, as for
    ``--raw_input`` batches), ``labels`` int32 class ids [N]. For a token
    split (``tokens``) ``images`` and ``labels`` are the ``[:, :-1]``
    and ``[:, 1:]`` views of one (N, S + 1) token table, inputs and
    next-token targets, in the table's storage type; ``batch`` widens the
    gathered rows to the int32 ids the host-fed batches carry."""

    images: torch.Tensor
    labels: torch.Tensor
    tokens: bool = False

    @property
    def num_examples(self) -> int:
        return self.labels.shape[0]

    def batch(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(inputs, targets) of the examples at ``idx``, gathered on the
        device."""
        x = self.images.index_select(0, idx)
        y = self.labels.index_select(0, idx)
        if self.tokens:
            return x.to(torch.int32), y.to(torch.int32)
        return x, y


def put_device_data(split, device: torch.device | str) -> DeviceData:
    """Copy a host split to ``device`` in the thin-wire format
    (``DataSet.next_batch_raw``'s: uint8 pixels, int32 ids). A token
    split (``LMDataSet``) stages its ``_tokens`` table once, uint8 as
    uint8; a uint16 table (vocabularies above 256) is staged as int32,
    since CUDA's ``index_select`` and most other ops do not take
    ``torch.uint16``, and int32 holds every id below 65536 and is what
    the gathered rows widen to anyway."""
    toks = getattr(split, "_tokens", None)
    if toks is not None:
        table = np.ascontiguousarray(toks)
        if table.dtype != np.uint8:
            table = table.astype(np.int32)
        table = torch.from_numpy(table).to(device)
        return DeviceData(table[:, :-1], table[:, 1:], tokens=True)
    images = torch.from_numpy(np.ascontiguousarray(split._raw_u8()))
    labels = torch.from_numpy(split.labels_int.astype(np.int32))
    return DeviceData(images.to(device), labels.to(device))
