"""The port's sequence parallelism (``parallel/sequence_parallel.py``,
the ``seq_axis`` forms of ``models/transformer.py``) against the JAX
package's, on the CPU.

Gloo ranks, one process each, form 1x2, 2x2 and 1x4 grids. Each grid is
spawned once (a module fixture) and runs every case of its layout from
one JAX init: the pooled classifier (``MiniTransformer``, d 32, 2 heads,
2 blocks, 28 tokens of 28 pixels; sgd 0.1) and the LM (V 16, S 32, d
32, 2 heads, 2 blocks; adam 1e-3), 5 steps at a global batch of 8, then
with ``--accum_steps 2`` and ``--clip_norm``, and the LM with
``--ce_block``; after each, the SP eval step on one more batch. At 1x2
dropout runs too: the classifier's head gradients (post-pool, so
replicated) must be bitwise equal across a row, and the LM's per-token
masks must differ between its shards. The parent holds the results
against JAX's ``make_sp_train_step``/``make_sp_eval_step`` on the
matching slice of the tests' virtual devices and against the port's
one-process dense step.

Tolerances. Losses and eval metrics: rtol 1e-4 against JAX, 1e-5
against the port's dense step (the ring folds the key blocks in another
order than the dense softmax, and the grid sums the gradients in
another order). Params and optimizer slots: the same rtols, of each
entry plus the leaf's scale; at most 0.1% of a leaf's entries may miss
that, by at most 2 * steps * lr: adam moves on gradients that are
summation noise (``tests/test_torch_tensor_parallel.py``). The
replicated state must be bitwise equal on every rank.

The rank processes are spawned and import this module, so it imports
JAX only inside the tests that run in the parent."""

import os

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import cluster
from distributed_tensorflow_tpu_torch.data import synthetic_digits
from tests.test_torch_tensor_parallel import (
    _assert_state_close,
    _spawn,
    free_port,
)

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

GLOBAL_BATCH, STEPS = 8, 5
LR = {"cls": 0.1, "lm": 1e-3}
CLIP = {"cls": 0.5, "lm": 0.5}
CLS_KW = dict(d_model=32, num_heads=2, num_blocks=2)
LM_KW = dict(vocab_size=16, seq_len=32, d_model=32, num_heads=2,
             num_blocks=2)
CE_BLOCK = 8
LAYOUTS = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
# (model, accum_steps, clip, ce_block) per case
CASES = {
    "cls": ("cls", 1, False, None),
    "cls-accum-clip": ("cls", 2, True, None),
    "lm": ("lm", 1, False, None),
    "lm-accum-clip": ("lm", 2, True, None),
    "lm-ce": ("lm", 1, False, CE_BLOCK),
}
KEEP = 0.75  # the dropout cases' keep probability (1x2)


def _batches(kind: str):
    """STEPS training batches and one eval batch, numpy, global."""
    n = (STEPS + 1) * GLOBAL_BATCH
    if kind == "cls":
        x, y = synthetic_digits(n, seed=5)
        y = np.eye(10, dtype=np.float32)[y]
    else:
        toks = np.random.default_rng(11).integers(
            0, LM_KW["vocab_size"], (n, LM_KW["seq_len"] + 1))
        x, y = toks[:, :-1], toks[:, 1:]
    return [(x[i * GLOBAL_BATCH:(i + 1) * GLOBAL_BATCH],
             y[i * GLOBAL_BATCH:(i + 1) * GLOBAL_BATCH])
            for i in range(STEPS + 1)]


def _torch_batch(kind, b):
    x, y = b
    if kind == "lm":
        return (torch.from_numpy(x.astype(np.int64)),
                torch.from_numpy(y.astype(np.int64)))
    return torch.from_numpy(x), torch.from_numpy(y)


def _port_state(case: str, init_dir: str):
    """The port's dense model of ``case`` and its state, from the JAX
    init of the case's model family."""
    from distributed_tensorflow_tpu_torch.models import (
        MiniTransformer,
        TransformerLM,
    )
    from distributed_tensorflow_tpu_torch.training import train_state as tts

    kind, _, _, ce = CASES.get(case, (case, 1, False, None))
    model = (MiniTransformer(**CLS_KW) if kind == "cls"
             else TransformerLM(**LM_KW, ce_block=ce))
    opt = tts.sgd(LR[kind]) if kind == "cls" else tts.adam(LR[kind])
    state = tts.create_train_state(model, opt, seed=0)
    init = np.load(os.path.join(init_dir, f"{kind}_init.npz"))
    model.load_state_dict({k: torch.from_numpy(init[k]) for k in init})
    return model, opt, state


def _tile(mesh, sp_model, kind, b):
    """This rank's tile of a global numpy batch: its data row's slice,
    then its token block."""
    from distributed_tensorflow_tpu_torch.parallel import (
        reshape_for_sp,
        stage_batch_sp,
    )

    x, y = _torch_batch(kind, b)
    local = GLOBAL_BATCH // mesh.data
    rows = slice(mesh.data_index * local, (mesh.data_index + 1) * local)
    x, y = x[rows], y[rows]
    if kind == "cls":
        x = reshape_for_sp(sp_model, x)
    return stage_batch_sp(mesh, (x, y), per_token_targets=kind == "lm")


def _sp_rank(rank, world, port, layout, work):
    """One rank of a grid: every case of the layout, and at 1x2 the
    dropout cases."""
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.parallel import (
        MeshSpec,
        make_mesh,
        make_sp_eval_step,
        make_sp_train_step,
    )
    from distributed_tensorflow_tpu_torch.training import train_state as tts
    from distributed_tensorflow_tpu_torch.utils.pytree import flatten_pytree

    torch.set_num_threads(1)
    spec = cluster.ClusterSpec({"worker": [f"127.0.0.1:{port}"] * world})
    assert cluster.maybe_initialize_distributed(spec, rank, "cpu")
    data, model_ways = LAYOUTS[layout]
    mesh = make_mesh("cpu", MeshSpec(data=-1, model=model_ways))
    for case, (kind, accum, clip, _) in CASES.items():
        model, opt, state = _port_state(case, work)
        sp = model.twin(seq_axis="model")
        step = make_sp_train_step(
            sp, opt, mesh, keep_prob=1.0, accum_steps=accum,
            grad_transform=tts.clip_by_global_norm(CLIP[kind]) if clip
            else None)
        *train, held = _batches(kind)
        losses = []
        for b in train:
            state, m = step(state, _tile(mesh, sp, kind, b))
            losses.append(float(m["loss"]))
        ev = make_sp_eval_step(sp, mesh)(_tile(mesh, sp, kind, held))
        np.savez(os.path.join(work, f"{case}-r{rank}.npz"),
                 losses=np.asarray(losses),
                 eval_loss=float(ev["loss"]), eval_acc=float(ev["accuracy"]),
                 **{k: np.array(v) for k, v in flatten_pytree(state).items()})
    if layout == "1x2":
        _dropout_cases(rank, mesh, work)
    dist.destroy_process_group()


def _dropout_cases(rank, mesh, work):
    """keep_prob < 1: the classifier's pre-reduction head gradients and
    5 steps' losses, and the LM's dropout mask on this rank's tokens."""
    from distributed_tensorflow_tpu_torch.parallel import make_sp_train_step
    from distributed_tensorflow_tpu_torch.training import train_state as tts

    out = {}
    model, opt, state = _port_state("cls", work)
    sp = model.twin(seq_axis="model")
    step = make_sp_train_step(sp, opt, mesh, keep_prob=KEEP)
    *train, _ = _batches("cls")
    seed = tts.dropout_seed(state.rng, state.step, mesh.data_index)
    grads = tts.compute_grads(sp, state.params, _tile(mesh, sp, "cls",
                                                      train[0]),
                              keep_prob=KEEP, rng=seed, model_state=())[0]
    out["head_w"] = grads["head"]["w"].numpy()
    out["head_b"] = grads["head"]["b"].numpy()
    losses = []
    for b in train:
        state, m = step(state, _tile(mesh, sp, "cls", b))
        losses.append(float(m["loss"]))
    out["cls_losses"] = np.asarray(losses)
    model, _, _ = _port_state("lm", work)
    sp = model.twin(seq_axis="model")
    make_sp_train_step(sp, opt, mesh, keep_prob=0.5)  # hands sp its grid
    x, _ = _tile(mesh, sp, "lm", _batches("lm")[0])
    with torch.no_grad():
        h = sp.apply_hidden(x, keep_prob=0.5, generator=torch.Generator()
                            .manual_seed(seed), train=True)
    out["lm_mask"] = (h == 0).numpy()
    np.savez(os.path.join(work, f"dropout-r{rank}.npz"), **out)


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """layout -> the directory its grid wrote, each grid spawned once."""
    import jax

    from distributed_tensorflow_tpu.models.transformer import (
        MiniTransformer as JaxCls,
        TransformerLM as JaxLM,
    )
    from distributed_tensorflow_tpu.training import train_state as jts
    from distributed_tensorflow_tpu_torch.utils.pytree import params_from_jax

    inits = {}
    for kind, jm in (("cls", JaxCls(**CLS_KW)), ("lm", JaxLM(**LM_KW))):
        js = jts.create_train_state(jm, jts.sgd(0.1), seed=0)
        inits[kind] = {k: v.numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, js.params)).items()}
    cache = {}

    def get(layout):
        if layout not in cache:
            work = str(tmp_path_factory.mktemp(f"sp{layout}"))
            for kind, init in inits.items():
                np.savez(os.path.join(work, f"{kind}_init.npz"), **init)
            data, model = LAYOUTS[layout]
            _spawn(_sp_rank, data * model, free_port(), layout, work)
            cache[layout] = work
        return cache[layout]

    return get


_JAX_RUNS: dict = {}


def _jax_run(layout: str, case: str):
    """JAX's SP step on the layout's device slice: the losses, the eval
    metrics on the held batch and the state's flat dict."""
    key = (layout, case)
    if key in _JAX_RUNS:
        return _JAX_RUNS[key]
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.transformer import (
        MiniTransformer as JaxCls,
        TransformerLM as JaxLM,
    )
    from distributed_tensorflow_tpu.parallel import sequence_parallel as jsp
    from distributed_tensorflow_tpu.parallel.data_parallel import (
        replicate_state,
    )
    from distributed_tensorflow_tpu.parallel.mesh import (
        MODEL_AXIS,
        MeshSpec,
        make_mesh,
    )
    from distributed_tensorflow_tpu.training import train_state as jts
    from distributed_tensorflow_tpu.utils.pytree import flatten_pytree

    kind, accum, clip, ce = CASES[case]
    data, model_ways = LAYOUTS[layout]
    mesh = make_mesh(MeshSpec(data=data, model=model_ways),
                     devices=jax.devices()[:data * model_ways])
    if kind == "cls":
        jm = JaxCls(**CLS_KW, seq_axis=MODEL_AXIS)
        opt = jts.sgd(LR[kind])
    else:
        jm = JaxLM(**LM_KW, seq_axis=MODEL_AXIS, ce_block=ce)
        opt = jts.adam(LR[kind])
    lm = kind == "lm"
    state = replicate_state(mesh, jts.create_train_state(jm, opt, seed=0))
    step = jsp.make_sp_train_step(
        jm, opt, mesh, keep_prob=1.0, donate=False, per_token_targets=lm,
        grad_transform=jts.clip_by_global_norm(CLIP[kind]) if clip
        else None, accum_steps=accum)

    def stage(b):
        x, y = b
        if lm:
            x, y = x.astype(np.int32), y.astype(np.int32)
        else:
            x = jsp.reshape_for_sp(jm, x)
        return jsp.stage_batch_sp(mesh, (jnp.asarray(x), jnp.asarray(y)),
                                  per_token_targets=lm)

    *train, held = _batches(kind)
    losses = []
    for b in train:
        state, m = step(state, stage(b))
        losses.append(float(m["loss"]))
    ev = jsp.make_sp_eval_step(jm, mesh, per_token_targets=lm)(
        state.params, stage(held))
    _JAX_RUNS[key] = (np.asarray(losses), float(ev["loss"]),
                      float(ev["accuracy"]),
                      flatten_pytree(state, tag_bf16=True))
    return _JAX_RUNS[key]


_SINGLE_RUNS: dict = {}


def _single_run(case: str, init_dir: str):
    """The port's one-process dense step on the same init and batches."""
    if case in _SINGLE_RUNS:
        return _SINGLE_RUNS[case]
    from distributed_tensorflow_tpu_torch.training import train_state as tts
    from distributed_tensorflow_tpu_torch.utils.pytree import flatten_pytree

    kind, accum, clip, _ = CASES[case]
    model, opt, state = _port_state(case, init_dir)
    step = tts.make_train_step(
        model, opt, accum_steps=accum,
        grad_transform=tts.clip_by_global_norm(CLIP[kind]) if clip
        else None)
    *train, held = _batches(kind)
    losses, norms = [], []
    for b in train:
        batch = _torch_batch(kind, b)
        grads = tts.compute_grads(model, state.params, batch, keep_prob=1.0,
                                  rng=None, model_state=())[0]
        norms.append(float(sum(torch.sum(g * g) for g in
                               tts.tree_leaves(grads)) ** 0.5))
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    ev = tts.make_eval_step(model)(_torch_batch(kind, held))
    flat = {k: np.array(v) for k, v in flatten_pytree(state).items()}
    _SINGLE_RUNS[case] = (np.asarray(losses), float(ev["loss"]),
                          float(ev["accuracy"]), flat, norms)
    return _SINGLE_RUNS[case]


PARITY = [(lay, c) for lay in LAYOUTS for c in CASES]


@pytest.mark.parametrize("layout,case", PARITY,
                         ids=[f"{lay}-{c}" for lay, c in PARITY])
def test_sp_step_matches_jax_and_the_dense_step(grids, layout, case):
    work = grids(layout)
    got = dict(np.load(os.path.join(work, f"{case}-r0.npz")))
    jlosses, _, _, jflat = _jax_run(layout, case)
    slosses, _, _, sflat, norms = _single_run(case, work)
    kind, _, clip, _ = CASES[case]
    if clip:
        # the clip bites: the first step's norm is over the bar
        assert norms[0] > CLIP[kind], norms
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4)
    np.testing.assert_allclose(got["losses"], slosses, rtol=1e-5)
    _assert_state_close(got, jflat, rtol=1e-4)
    _assert_state_close(got, sflat, rtol=1e-5)
    assert int(got["step"]) == STEPS


@pytest.mark.parametrize("layout,case", PARITY,
                         ids=[f"{lay}-{c}" for lay, c in PARITY])
def test_sp_eval_step_matches_jax_and_the_dense_eval(grids, layout, case):
    """The SP eval step on the trained state: the global token mean (LM)
    or the replicated pooled metrics (classifier), over the data rows."""
    work = grids(layout)
    got = np.load(os.path.join(work, f"{case}-r0.npz"))
    _, jloss, jacc, _ = _jax_run(layout, case)
    _, sloss, sacc, _, _ = _single_run(case, work)
    np.testing.assert_allclose(float(got["eval_loss"]), jloss, rtol=1e-4)
    np.testing.assert_allclose(float(got["eval_loss"]), sloss, rtol=1e-5)
    np.testing.assert_allclose(float(got["eval_acc"]), jacc, rtol=1e-4)
    np.testing.assert_allclose(float(got["eval_acc"]), sacc, rtol=1e-5)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_replicated_state_stays_bitwise_equal_on_every_rank(grids, layout):
    """Every rank applies the same reduced gradients: the whole state,
    optimizer slots included, is the same bytes everywhere."""
    work = grids(layout)
    data, model = LAYOUTS[layout]
    for case in CASES:
        ranks = [dict(np.load(os.path.join(work, f"{case}-r{r}.npz")))
                 for r in range(data * model)]
        for other in ranks[1:]:
            assert sorted(other) == sorted(ranks[0])
            for k in ranks[0]:
                np.testing.assert_array_equal(other[k], ranks[0][k],
                                              err_msg=f"{case} {k}")


def test_classifier_dropout_mask_is_one_per_row(grids):
    """keep_prob 0.75 at 1x2: the post-pool mask is drawn from the data
    index's seed, so both ranks' head gradients, before any reduction,
    are the same bytes; dropout is on (the losses leave the keep_prob 1
    run) and the run stays finite."""
    work = grids("1x2")
    r0, r1 = (np.load(os.path.join(work, f"dropout-r{r}.npz"))
              for r in (0, 1))
    for k in ("head_w", "head_b"):
        np.testing.assert_array_equal(r0[k], r1[k])
    assert np.abs(r0["head_w"]).max() > 0
    np.testing.assert_array_equal(r0["cls_losses"], r1["cls_losses"])
    nodrop = np.load(os.path.join(work, "cls-r0.npz"))["losses"]
    assert np.all(np.isfinite(r0["cls_losses"]))
    assert np.abs(r0["cls_losses"] - nodrop).max() > 1e-3


def test_lm_dropout_masks_differ_between_shards(grids):
    """The LM's per-token mask folds in the model index: the two shards'
    masks of one seed differ, and each drops about half its entries."""
    work = grids("1x2")
    m0, m1 = (np.load(os.path.join(work, f"dropout-r{r}.npz"))["lm_mask"]
              for r in (0, 1))
    assert m0.shape == m1.shape
    assert (m0 != m1).mean() > 0.25
    for m in (m0, m1):
        assert 0.4 < m.mean() < 0.6


def test_dense_model_and_flavor_clashes_are_refused_as_in_jax():
    """A model without seq_axis is refused by both SP steps; the LM
    refuses seq_axis with attn_block, and moe_axis with seq_axis, with
    the JAX package's messages."""
    import jax

    from distributed_tensorflow_tpu.models.transformer import (
        MiniTransformer as JaxCls,
        TransformerLM as JaxLM,
    )
    from distributed_tensorflow_tpu.parallel import sequence_parallel as jsp
    from distributed_tensorflow_tpu.parallel.mesh import MeshSpec, make_mesh
    from distributed_tensorflow_tpu.training import train_state as jts
    from distributed_tensorflow_tpu_torch.models import (
        MiniTransformer,
        TransformerLM,
    )
    from distributed_tensorflow_tpu_torch.parallel import (
        make_sp_eval_step,
        make_sp_train_step,
    )
    from distributed_tensorflow_tpu_torch.training import train_state as tts

    mesh = make_mesh(MeshSpec(data=1, model=2), devices=jax.devices()[:2])
    with pytest.raises(ValueError) as want:
        jsp.make_sp_train_step(JaxCls(**CLS_KW), jts.sgd(0.1), mesh)
    for make in (lambda m: make_sp_train_step(m, tts.sgd(0.1), None),
                 lambda m: make_sp_eval_step(m, None)):
        for model in (MiniTransformer(**CLS_KW), TransformerLM(**LM_KW)):
            with pytest.raises(ValueError) as got:
                make(model)
            assert str(got.value) == str(want.value)
    for kw in ({"seq_axis": "model", "attn_block": 8},
               {"seq_axis": "model", "moe_experts": 2, "moe_axis": "model"}):
        with pytest.raises(ValueError) as want:
            JaxLM(**LM_KW, **kw)
        with pytest.raises(ValueError) as got:
            TransformerLM(**LM_KW, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError, match="make_sp_train_step"):
        MiniTransformer(**CLS_KW, seq_axis="model")(
            torch.zeros((1, 784)))
