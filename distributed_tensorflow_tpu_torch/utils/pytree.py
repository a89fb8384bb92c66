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

``params_from_jax`` and ``params_to_numpy`` carry a JAX parameter tree
(``{"weights": {...}, "biases": {...}}`` of numpy arrays) into a torch
``state_dict`` and back. A stateful model's JAX variables
(``{"params": {...}, "state": {...}}``, the ResNet's batch-norm stats in
``state``) become its parameters plus its buffers; ``state_to_numpy``
brings the buffers back.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_BF16_TAG = "__bf16__"


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


def flatten_pytree(tree) -> dict[str, np.ndarray]:
    """Nested state -> {path_key: np.ndarray}. numpy has no bfloat16, so a
    bfloat16 tensor leaf is stored as its uint16 bit pattern under
    ``__bf16__<key>`` (the JAX package's ``tag_bf16=True`` layout)."""
    flat = {}
    for path, leaf in _leaves_with_path(tree):
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
