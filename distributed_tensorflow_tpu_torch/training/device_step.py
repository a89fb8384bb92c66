"""Train steps over a device-resident split, replayed from a CUDA graph.

The counterpart of ``distributed_tensorflow_tpu/training/device_step.py``
(``_split_and_sample``, ``_sampled_step_body``, ``_scan_chunk``,
``make_device_train_step``, ``make_device_dp_train_step``,
``make_zero_device_train_step``). There the
step draws its minibatch inside the compiled program and ``lax.scan``
runs a chunk of steps per dispatch, so the host does one call per chunk.
Here one step is:

    draw ``batch`` indices uniformly over the split, gather the uint8
    images and int32 labels into the batch (the model normalizes them;
    for an LM split the rows of input and target tokens, widened to
    int32 ids), (augment the uint8 images), forward, backward (through
    the model's loss hook where it has one, so the LM's streamed head
    and MoE term run inside the step; a stateful model moves its
    batch-norm stats in place), (one ``all_reduce`` over the
    data-parallel ranks of the gradients, metrics and stats), clip, the
    optimizer's in-place update, ``step += 1``. The ZeRO step
    (``ZeroDeviceTrainStep``) replaces the all-reduce and the update with
    ``parallel.zero``'s reduce-scatter, sharded update and gather.

On a CUDA device the step is captured once into a ``torch.cuda.CUDAGraph``
after two warm-up runs on a side stream (cuDNN's and cuBLAS's handles,
the kernel library's first load and its shared-memory attribute, NCCL's
communicator), whose effect on the state is then undone. Every later
step is one replay: the host reseeds the step's generators and launches
the graph, and nothing else. A chunk of ``length`` steps is ``length``
replays with no readback. A capture that fails raises; nothing falls
back to eager steps. On the CPU the same body runs eagerly (the test
path), and ``graph=False`` runs it eagerly on a card, for comparison.

The draws are a function of (key, step, rank): before each step the
dropout generator is seeded with ``dropout_seed(key, step, rank)``, the
host-fed step's seed, the augmentation generator with
``augment_seed(key, step, rank)``, also the host-fed step's, and the
sampling generator with the dropout seed mixed with a salt. The
generators are registered with the graph, which copies their seeds to
the device at each replay, so a replay draws what an eager step with the
same seeds draws, and a resumed run draws what an uninterrupted one
would.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.ops import fused_dense
from distributed_tensorflow_tpu_torch.parallel import zero
from distributed_tensorflow_tpu_torch.parallel.data_parallel import (
    local_batch_size,
    pmean_grads_and_metrics,
)
from distributed_tensorflow_tpu_torch.training.train_state import (
    _mix,
    apply_gradients,
    augment_seed,
    compute_grads,
    dropout_seed,
    params_of,
)
from distributed_tensorflow_tpu_torch.utils.pytree import tree_leaves

_SAMPLE_SALT = 0x5EED  # parts the sampling stream from the dropout stream
WARMUP_STEPS = 2  # eager runs on a side stream before the capture


def sample_seed(rng, step: int, rank: int = 0) -> int:
    """The seed of one step's batch draw."""
    return _mix(dropout_seed(rng, step, rank), _SAMPLE_SALT)


class DeviceTrainStep:
    """``(state, step, length) -> (state, metrics)``: ``length`` train
    steps from global step ``step`` on batches of ``batch_size`` examples
    drawn from ``data`` (a ``DeviceData``) on its device.

    ``state.step`` must live on that device (the learning-rate schedule
    reads it inside the step). The state is updated in place, and a
    captured step replays on the tensors it was captured with, so every
    call takes the same ``state``. ``mesh`` (a ``DataMesh``) makes it the
    sync-DP step: ``batch_size`` is then this rank's share, the draws mix
    in the rank, and the gradients and metrics are averaged over the
    ranks. The metrics are the last step's training loss and accuracy
    (dropout on), left on the device. ``indices`` (a function of the
    global step returning the batch's indices) replaces the uniform draw
    in eager steps, so a test can feed known batches. ``augment_fn``
    ((images, generator) -> images) transforms each drawn batch."""

    def __init__(self, model, optimizer, data, batch_size: int, *,
                 keep_prob: float = 1.0, grad_transform=None, mesh=None,
                 graph: bool | None = None, indices=None, augment_fn=None):
        self.device = data.images.device
        if graph is None:
            graph = self.device.type == "cuda"
        if graph and self.device.type != "cuda":
            raise ValueError(f"a CUDA graph runs on a cuda device, not "
                             f"{self.device}")
        if graph and indices is not None:
            raise ValueError("injected indices feed eager steps only")
        self.model, self.optimizer, self.data = model, optimizer, data
        self.batch_size = batch_size
        self.keep_prob = keep_prob
        self.grad_transform = grad_transform
        self.mesh = mesh
        self.graph = graph
        self.indices = indices
        self.augment_fn = augment_fn
        self.rank = mesh.rank if mesh is not None else 0
        self.sampler = torch.Generator(device=self.device)
        self.dropper = (torch.Generator(device=self.device)
                        if keep_prob < 1 else None)
        self.augmenter = (torch.Generator(device=self.device)
                          if augment_fn is not None else None)
        self._graph = None
        self._state = None
        self._metrics = None
        self._recorded = None  # the kernel launches one replay runs

    def _seed(self, state, step: int) -> None:
        self.sampler.manual_seed(sample_seed(state.rng, step, self.rank))
        if self.dropper is not None:
            self.dropper.manual_seed(dropout_seed(state.rng, step, self.rank))
        if self.augmenter is not None:
            self.augmenter.manual_seed(augment_seed(state.rng, step,
                                                    self.rank))

    def _draw(self) -> torch.Tensor:
        return torch.randint(0, self.data.num_examples, (self.batch_size,),
                             generator=self.sampler, device=self.device)

    def sample(self, state, step: int) -> torch.Tensor:
        """The indices of the examples that global step ``step`` draws."""
        self._seed(state, step)
        return self._draw()

    def _body(self, state, step: int):
        """One step, in place on ``state``; returns the metrics."""
        if self.indices is not None:
            idx = self.indices(step).to(self.device)
        else:
            idx = self._draw()
        images, labels = self.data.batch(idx)
        if self.augment_fn is not None:
            images = self.augment_fn(images, self.augmenter)
        opt_state, metrics = self._update(state, (images, labels))
        if not all(a is b for a, b in zip(tree_leaves(opt_state),
                                          tree_leaves(state.opt_state))):
            raise TypeError("the device step needs an optimizer that "
                            "updates its slots in place")
        state.step.add_(1)
        return metrics

    def _update(self, state, batch):
        """The update half of a step on a drawn batch, in place: returns
        (opt_state, metrics)."""
        grads, metrics, model_state = compute_grads(
            self.model, state.params, batch, keep_prob=self.keep_prob,
            rng=self.dropper, model_state=state.model_state)
        if self.mesh is not None:
            grads, metrics = pmean_grads_and_metrics(grads, metrics,
                                                     self.mesh, model_state)
        opt_state = apply_gradients(self.optimizer, state, grads,
                                    self.grad_transform)
        return opt_state, metrics

    def _live_tensors(self, state) -> list:
        """The tensors a step writes: the state's."""
        return [t for t in tree_leaves(state) if isinstance(t, torch.Tensor)]

    def __call__(self, state, step: int, length: int = 1):
        if state.step.device != self.device:
            raise ValueError(f"state.step lives on {state.step.device}; the "
                             f"device step needs it on {self.device}")
        if self._state is not None and state is not self._state:
            raise ValueError("a device step runs on the state it started "
                             "with")
        self._state = state
        metrics = None
        for i in range(length):
            if not self.graph:
                self._seed(state, step + i)
                metrics = self._body(state, step + i)
                continue
            if self._graph is None:
                self._capture(state, step + i)
            self._seed(state, step + i)
            self._graph.replay()
            fused_dense.count_replay(self._recorded)
            metrics = self._metrics
        return state, metrics

    def _capture(self, state, step: int) -> None:
        """Warm up on a side stream, undo the warm-up's updates, then
        record one step into a CUDA graph."""
        leaves = self._live_tensors(state)
        with torch.no_grad():
            saved = [t.clone() for t in leaves]
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._seed(state, step)
                self._body(state, step)
        current.wait_stream(side)
        with torch.no_grad():
            for t, s in zip(leaves, saved):
                t.copy_(s)
        del saved
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        for gen in (self.sampler, self.dropper, self.augmenter):
            if gen is not None:
                graph.register_generator_state(gen)
        # thread_local: the backward runs on autograd's device thread, and
        # the process group's watchdog queries events on its own thread
        with fused_dense.recording() as recorded, \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._metrics = self._body(state, step)
        self._graph, self._recorded = graph, dict(recorded)


def make_device_train_step(model, optimizer, data, batch_size: int, *,
                           keep_prob: float = 1.0, grad_transform=None,
                           graph: bool | None = None, indices=None,
                           augment_fn=None):
    """Single-device step over ``data``: ``(state, step, length) ->
    (state, metrics)``; advances ``state.step`` by ``length``."""
    return DeviceTrainStep(model, optimizer, data, batch_size,
                           keep_prob=keep_prob, grad_transform=grad_transform,
                           graph=graph, indices=indices,
                           augment_fn=augment_fn)


def make_device_dp_train_step(model, optimizer, mesh, data, batch_size: int,
                              *, keep_prob: float = 1.0, grad_transform=None,
                              graph: bool | None = None, indices=None,
                              augment_fn=None):
    """Sync-DP step over ``mesh``: each rank draws ``batch_size //
    world_size`` examples from its copy of the split, and one
    ``all_reduce`` averages the gradients and metrics; the input side
    costs no collective."""
    return DeviceTrainStep(model, optimizer, data,
                           local_batch_size(batch_size, mesh),
                           keep_prob=keep_prob, grad_transform=grad_transform,
                           mesh=mesh, graph=graph, indices=indices,
                           augment_fn=augment_fn)


class ZeroDeviceTrainStep(DeviceTrainStep):
    """The ZeRO sync-DP device step (``--zero 1|3 --device_data``): the
    DP device step's sampling, verbatim, and ``parallel.zero``'s update
    (reduce-scatter, sharded update, gather) on a ``ZeroState``, captured
    into the same CUDA graph. At level 3 the module's parameters are the
    gathered-parameter buffer; they live outside the state and persist
    across replays, so under ``overlap`` the prefetched gather that ends
    one replay feeds the next."""

    def __init__(self, model, optimizer, mesh, level: int, data,
                 batch_size: int, *, keep_prob: float = 1.0,
                 grad_transform=None, graph: bool | None = None,
                 indices=None, augment_fn=None, overlap: bool = False,
                 bucket_mb: float = zero.DEFAULT_BUCKET_MB):
        super().__init__(model, optimizer, data, batch_size,
                         keep_prob=keep_prob, grad_transform=grad_transform,
                         mesh=mesh, graph=graph, indices=indices,
                         augment_fn=augment_fn)
        self._core = zero._zero_step_core(
            model, optimizer, mesh, level, keep_prob, grad_transform,
            overlap=overlap, bucket_bytes=int(bucket_mb * 2 ** 20))
        self._buffer = (tree_leaves(params_of(model))
                        if zero._check_level(level) >= 3 else [])

    def _update(self, state, batch):
        return self._core(state, batch, self.dropper)

    def _live_tensors(self, state) -> list:
        return super()._live_tensors(state) + self._buffer


def make_zero_device_train_step(model, optimizer, mesh, level: int, data,
                                batch_size: int, *, keep_prob: float = 1.0,
                                grad_transform=None,
                                graph: bool | None = None, indices=None,
                                augment_fn=None, overlap: bool = False,
                                bucket_mb: float = zero.DEFAULT_BUCKET_MB):
    """ZeRO sync-DP step over ``mesh`` on a ``ZeroState``
    (``parallel.zero.shard_state_zero``): each rank draws ``batch_size //
    world_size`` examples as the DP device step does; ``grad_transform``
    is ``zero_clip_transform`` for ``--clip_norm``."""
    return ZeroDeviceTrainStep(model, optimizer, mesh, level, data,
                               local_batch_size(batch_size, mesh),
                               keep_prob=keep_prob,
                               grad_transform=grad_transform, graph=graph,
                               indices=indices, augment_fn=augment_fn,
                               overlap=overlap, bucket_mb=bucket_mb)
