"""Nested-dict state <-> path-keyed flat dict, and JAX params <-> torch.

The counterpart of ``distributed_tensorflow_tpu/utils/pytree.py``
(``path_key``, ``flatten_pytree``, ``unflatten_pytree``), over nested
dicts, lists, tuples and NamedTuples (such as ``TrainState``) whose
leaves are torch tensors, numpy arrays or scalars. A NamedTuple's fields
are keyed by name, as JAX keys them. Keys are '/'-joined paths
("params/weights/wd1"), the same keys the JAX package writes, so
checkpoints cross between the packages.
bfloat16 leaves are stored as uint16 bit patterns under a tagged key,
because npz cannot hold bfloat16.

A tensor-parallel leaf (``parallel/tensor_parallel.py``) is one rank's
slice of a larger leaf, tagged with where it sits (``Shard``). Fetching
a tree that holds one (``flatten_pytree``, ``fetch_pytree``) is then a
collective over the leaf's model group, which every rank enters with the
same tree (``needs_collective_fetch`` tells them alike). ``run_bounded``
and ``agree_clean_exit`` are the exit protocol's bounded collectives.

``params_from_jax`` and ``params_to_numpy`` carry a JAX parameter tree
(``{"weights": {...}, "biases": {...}}`` of numpy arrays) into a torch
``state_dict`` and back. A stateful model's JAX variables
(``{"params": {...}, "state": {...}}``, the ResNet's batch-norm stats in
``state``) become its parameters plus its buffers; ``state_to_numpy``
brings the buffers back.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

_BF16_TAG = "__bf16__"


class Shard(NamedTuple):
    """Where a tensor-parallel leaf sits in its full leaf: the full shape,
    this rank's [start, stop) per dim, the split dim and its ways, whether
    this rank is the lowest of the slice's holders (the one that writes it
    into a sharded checkpoint), and the model group that gathers it."""

    global_shape: tuple
    index: tuple
    dim: int
    ways: int
    owner: bool
    group: object
    backend: str


def shard_of(leaf) -> Shard | None:
    """The leaf's ``Shard`` tag, or None for a leaf this rank holds
    whole."""
    return getattr(leaf, "_dtt_shard", None)


def locally_fetchable(leaf) -> bool:
    """True when this process holds ``leaf``'s full value."""
    return shard_of(leaf) is None


def path_key(path) -> str:
    return "/".join(str(p) for p in path)


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _leaves_with_path(tree, prefix=()):
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], prefix + (k,))
    elif _is_namedtuple(tree):
        for k in tree._fields:
            yield from _leaves_with_path(getattr(tree, k), prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in path-key order (dict keys sorted)."""
    return [leaf for _, leaf in _leaves_with_path(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest``, in ``tree_leaves`` order, rebuilt in ``tree``'s
    structure (dict keys sorted)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *vs) for vs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(template, leaves):
    """``leaves`` (in ``tree_leaves`` order) in ``template``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(
        np.uint16)


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> the float32 values they encode
    (exact: every bfloat16 is a float32)."""
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def needs_collective_fetch(tree) -> bool:
    """True when fetching ``tree`` to the host needs other ranks'
    cooperation (some leaf is a tensor-parallel shard). Every rank of a
    grid holds the same layout, so the answer is the same on all of them,
    which lets them agree on the collective path without talking
    first."""
    return any(not locally_fetchable(leaf) for leaf in tree_leaves(tree))


def _gather_shard(t: torch.Tensor, sh: Shard) -> torch.Tensor:
    """The full leaf on the host, gathered over the shard's model group
    (NCCL moves device tensors, gloo host ones)."""
    src = t.detach()
    if sh.backend != "nccl":
        src = src.cpu()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(sh.ways)]
    dist.all_gather(parts, src, group=sh.group)
    return torch.cat(parts, dim=sh.dim).cpu()


def _full(leaf):
    sh = shard_of(leaf)
    return leaf if sh is None else _gather_shard(leaf, sh)


def join_collective_fetch(tree) -> None:
    """Take part in a peer's ``fetch_pytree``/``flatten_pytree`` of the
    same tree without keeping the result: the gathers of the sharded
    leaves run, in the same order, and are dropped."""
    for leaf in tree_leaves(tree):
        if not locally_fetchable(leaf):
            _full(leaf)


def fetch_pytree(tree):
    """Tree of tensors -> the same tree of host ndarrays in the full
    layout. Collective whenever ``needs_collective_fetch(tree)``: every
    rank must call it with the same tree."""
    return tree_map(lambda leaf: _to_numpy(_full(leaf)), tree)


def run_bounded(fn, timeout_s: float, *, what: str,
                grace_factor: float = 4.0):
    """Run ``fn`` on a daemon thread with a LOUD two-stage time bound.

    The pattern both exit-path collectives share (the agreement gather
    and the final save's fetch): the calling thread blocks in join() and
    dispatches nothing concurrent, so a peer that never joins cannot hang
    this process forever. After ``timeout_s`` a progress line is printed
    and the wait extends by ``grace_factor`` x — a collective completes
    for ALL processes or none, so a merely-slow link finishes within the
    grace and every process proceeds together; only a hard-dead peer
    exhausts it, on every live process alike.

    Returns ``(done, result)``: ``done`` False means the bound expired
    and the thread was ABANDONED (still blocked; ``fn`` must tolerate
    completing late — see the cancel gate in the supervisor's final
    save). ``fn`` exceptions are returned, not raised: ``result`` is the
    exception instance and ``done`` is True."""
    import threading

    box: dict = {}

    def _run():
        try:
            box["result"] = fn()
        except Exception as e:  # noqa: BLE001 — reported to the caller
            box["error"] = e

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        print(f"{what} slow (>{timeout_s:.0f}s); waiting up to "
              f"{grace_factor * timeout_s:.0f}s more before dying loudly "
              f"(a collective completes for all processes or none)")
        t.join(grace_factor * timeout_s)
    if t.is_alive():
        return False, None
    if "error" in box:
        return True, box["error"]
    return True, box.get("result")


def agree_clean_exit(clean: bool, timeout_s: float = 60.0,
                     return_token: bool = False):
    """All-process agreement gate ahead of a final COLLECTIVE save.

    Every rank — cleanly exiting or unwinding an exception — joins one
    tiny ``all_gather`` of its clean flag over the whole group. Returns
    True only when EVERY rank reported clean (the collective save may
    proceed), False when any peer failed (all ranks skip symmetrically),
    and None when the agreement itself failed or timed out (a peer died
    hard and will never join; the caller must skip, letting the job die
    loudly instead of hanging in the save's collective).

    ``return_token=True`` returns ``(verdict, token)`` instead: the same
    gather carries a random 8-hex attempt token from rank 0 (the sharded
    checkpoint format's per-attempt nonce) — riding THIS bounded
    agreement keeps the sharded save itself collective-free. ``token``
    is None whenever the verdict is not True.

    Bounded via ``run_bounded`` (two-stage timeout + grace)."""
    import secrets

    mine = secrets.randbits(31)

    def _gather():
        from distributed_tensorflow_tpu_torch.utils.faults import (
            fault_point,
        )

        # injection seam for the exit protocol: mode=error makes the
        # agreement fail (verdict None -> save skipped symmetrically);
        # mode=delay simulates the slow peer run_bounded's grace covers
        fault_point("exit_agreement", clean=clean)
        row = torch.tensor([1 if clean else 0, mine], dtype=torch.int32)
        if not dist.is_initialized():
            return bool(clean), mine
        if dist.get_backend() == "nccl":
            row = row.cuda()
        rows = [torch.empty_like(row) for _ in range(dist.get_world_size())]
        dist.all_gather(rows, row)
        rows = torch.stack(rows).cpu()
        return bool((rows[:, 0] > 0).all()), int(rows[0, 1])

    done, result = run_bounded(_gather, timeout_s, what="exit agreement")
    if not done:
        verdict, token = None, None
    elif isinstance(result, Exception):
        print(f"exit agreement failed: {result}")
        verdict, token = None, None
    else:
        verdict, token = result
    if not verdict:
        token = None
    if return_token:
        return verdict, (format(token, "08x") if token is not None else None)
    return verdict


def flatten_pytree(tree) -> dict[str, np.ndarray]:
    """Nested state -> {path_key: np.ndarray}. numpy has no bfloat16, so a
    bfloat16 tensor leaf is stored as its uint16 bit pattern under
    ``__bf16__<key>`` (the JAX package's ``tag_bf16=True`` layout).

    Collective when ``needs_collective_fetch(tree)``: a tensor-parallel
    leaf is gathered to its full value over its model group, so every
    rank must call this together (the coordinated checkpoint,
    ``training/supervisor.py``)."""
    flat = {}
    for path, leaf in _leaves_with_path(tree):
        leaf = _full(leaf)
        key = path_key(path)
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            flat[_BF16_TAG + key] = _bf16_bits(leaf)
        else:
            flat[key] = _to_numpy(leaf)
    return flat


def unflatten_pytree(template, flat: dict[str, np.ndarray]):
    """{path_key: array} -> nested state with ``template``'s structure.

    Raises KeyError on a missing key and ValueError on a shape mismatch.
    Each leaf takes the template leaf's kind and
    dtype: a torch tensor for a tensor leaf (bfloat16 restored from its
    bits), a numpy array otherwise."""
    out = []
    for path, leaf in _leaves_with_path(template):
        key = path_key(path)
        if key in flat:
            arr, bits = np.asarray(flat[key]), False
        elif _BF16_TAG + key in flat:
            arr, bits = np.asarray(flat[_BF16_TAG + key]), True
        else:
            raise KeyError(f"missing array for {key!r}")
        want_shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"shape mismatch at {key!r}: got {arr.shape}, "
                             f"expected {want_shape}")
        if isinstance(leaf, torch.Tensor):
            if bits:
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            out.append(t.to(leaf.dtype))
        else:
            want = np.asarray(leaf).dtype
            if bits:
                arr = _bf16_bits_to_f32(arr)
            out.append(arr if arr.dtype == want else arr.astype(want))
    return tree_unflatten(template, out)


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """A JAX parameter tree of numpy arrays -> a torch ``state_dict``
    ("weights.wd1", ...) on the CPU, ready for ``load_state_dict``.
    Layouts are kept as they are (HWIO conv kernels, [in, out] dense). A
    stateful model's ``{"params", "state"}`` variables fill both its
    parameters and its buffers: the two trees share their paths'
    prefixes ("stem.bn.scale" beside "stem.bn.mean")."""
    if isinstance(tree, Mapping) and set(tree) == {"params", "state"}:
        return {**params_from_jax(tree["params"]),
                **params_from_jax(tree["state"])}
    return {".".join(str(p) for p in path): torch.from_numpy(
                np.array(_to_numpy(leaf)))
            for path, leaf in _leaves_with_path(tree)}


def tree_from_named(named, fn=lambda t: t) -> dict:
    """(dotted name, tensor) pairs, such as ``named_parameters()`` ->
    the nested tree ("weights.wd1" -> ``{"weights": {"wd1": ...}}``) of
    ``fn`` of each tensor. A node whose names are 0..n-1 (an
    ``nn.ModuleList``'s, "blocks.0.qkv") becomes a list, as the JAX
    tree holds it, so the path keys ("blocks/0/qkv") and the leaf order
    are the JAX package's."""
    tree: dict = {}
    for name, t in named:
        *parents, leaf = name.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = fn(t)
    return _lists_for_indices(tree)


def _lists_for_indices(node):
    if not isinstance(node, dict):
        return node
    node = {k: _lists_for_indices(v) for k, v in node.items()}
    if node and sorted(node) == sorted(str(i) for i in range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def _numpy_f32(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 comes back as float32 (exact)."""
    return _to_numpy(t.float() if t.dtype == torch.bfloat16 else t)


def params_to_numpy(params) -> dict:
    """A torch module's parameters (or a ``state_dict`` of parameters) ->
    the JAX parameter tree of numpy arrays. A module's buffers (the
    ResNet's running stats) stay out: ``state_to_numpy`` reads them."""
    named = (params.named_parameters()
             if isinstance(params, torch.nn.Module) else params.items())
    return tree_from_named(named, _numpy_f32)


def state_to_numpy(model: torch.nn.Module) -> dict:
    """A module's buffers -> the JAX ``state`` tree of numpy arrays
    (``{}`` for a model without state)."""
    return tree_from_named(model.named_buffers(), _numpy_f32)
