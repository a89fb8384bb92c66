"""The port's model axis (``parallel/mesh.py``'s grid,
``parallel/tensor_parallel.py``) against the JAX package's, on the CPU.

Gloo ranks, one process each, form 1x2, 2x2 and 1x4 grids. Each grid is
spawned once (a module fixture) and runs every case of its layout: the
rank's place and subgroups; deep_cnn (batch 16) and the dense LM (V 32,
S 64, d 32, 4 heads, 2 blocks; dense and blockwise attention) for 5
adam steps from one JAX init, with and without ``--clip_norm``, with
dropout off, and at 1x2 with dropout on (the one-rank run's masks by
construction); then the sharded checkpoint each rank writes, and the
coordinated exit (the exit agreement, ``collective_fetch``,
``cancel_gate``). The parent holds the results against JAX's
``make_tp_train_step`` on the matching slice of the tests' virtual
devices and against the port's one-process step.

Tolerances. Losses vs JAX rtol 1e-4 (reordered float32 sums through
conv, matmul and softmax, compounded over 5 steps), vs the port's
one-process step rtol 1e-5 (the same ops; only the split matmuls' sums
are reordered). Gathered params and adam slots: rtol 1e-4 against both,
plus 1e-4 of the leaf's scale (a slot of a noise-sized gradient is
noise); at most 0.1% of a leaf's entries may miss that, by at most
2 * steps * lr: those adam moves on gradients that are summation noise
(their step is lr either way, ``tests/test_torch_train_state.py``).
The replicated leaves of the
ranks of one model group must be bitwise equal: a per-shard clip breaks
that at once.

The rank processes are spawned and import this module, so it imports
JAX only inside the tests that run in the parent."""

import contextlib
import io
import json
import multiprocessing
import os
import shutil
import socket

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import cluster
from distributed_tensorflow_tpu_torch.data import synthetic_digits

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

GLOBAL_BATCH, STEPS, LR = 16, 5, 1e-3
CLIP = {"cnn": 1.0, "lm": 0.2}
LM_KW = dict(vocab_size=32, seq_len=64, d_model=32, num_heads=4,
             num_blocks=2)
LM_BATCH, LM_BLOCK = 8, 16
JOIN_S = 300  # a rank that has not finished by then has hung
LAYOUTS = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
# (model, clip, keep_prob, attn_block) per case; dropout only at 1x2
CASES = {
    "cnn": ("cnn", False, 1.0, None),
    "cnn-clip": ("cnn", True, 1.0, None),
    "cnn-dropout": ("cnn", False, 0.75, None),
    "lm": ("lm", False, 1.0, None),
    "lm-block": ("lm", False, 1.0, LM_BLOCK),
    "lm-clip": ("lm", True, 1.0, None),
}
LAYOUT_CASES = {"1x2": tuple(CASES), "2x2": ("cnn", "cnn-clip"),
                "1x4": ("cnn", "cnn-clip", "lm", "lm-block", "lm-clip")}
ATTEMPT = "0a1b2c3d"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(target, world: int, *args):
    """Run ``target(rank, world, *args)`` in ``world`` spawned processes
    and wait for all; every rank must exit 0."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, world, *args))
             for rank in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=JOIN_S)
        assert not any(p.is_alive() for p in procs), "a rank hung"
        assert [p.exitcode for p in procs] == [0] * world
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


def _cnn_batches():
    x, y = synthetic_digits(STEPS * GLOBAL_BATCH, seed=5)
    yo = np.eye(10, dtype=np.float32)[y]
    return [(x[i * GLOBAL_BATCH:(i + 1) * GLOBAL_BATCH],
             yo[i * GLOBAL_BATCH:(i + 1) * GLOBAL_BATCH])
            for i in range(STEPS)]


def _lm_batches():
    toks = np.random.default_rng(11).integers(
        0, LM_KW["vocab_size"], (STEPS * LM_BATCH, LM_KW["seq_len"] + 1))
    return [(toks[i * LM_BATCH:(i + 1) * LM_BATCH, :-1],
             toks[i * LM_BATCH:(i + 1) * LM_BATCH, 1:])
            for i in range(STEPS)]


def _port_model(case: str):
    from distributed_tensorflow_tpu_torch.models import (
        DeepCNN,
        TransformerLM,
    )

    kind, _, _, block = CASES[case]
    if kind == "cnn":
        return DeepCNN()
    return TransformerLM(**LM_KW, attn_block=block)


def _port_state(case: str, init_dir: str):
    """A port model and its adam state from the JAX init of ``case``'s
    model family."""
    from distributed_tensorflow_tpu_torch.training import train_state as tts

    model, opt = _port_model(case), tts.adam(LR)
    state = tts.create_train_state(model, opt, seed=0)
    init = np.load(os.path.join(init_dir, f"{CASES[case][0]}_init.npz"))
    model.load_state_dict({k: torch.from_numpy(init[k]) for k in init})
    return model, opt, state


def _torch_batch(case, b):
    x, y = b
    if CASES[case][0] == "lm":
        return torch.from_numpy(x.astype(np.int64)), torch.from_numpy(
            y.astype(np.int64))
    return torch.from_numpy(x), torch.from_numpy(y)


def _batches(case):
    return _cnn_batches() if CASES[case][0] == "cnn" else _lm_batches()


def _tp_rank(rank, world, port, layout, work):
    """One rank of a grid: its place, every case of the layout, the
    sharded set of the last deep_cnn run and the coordinated exits."""
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.checkpoint import (
        save_checkpoint_sharded,
    )
    from distributed_tensorflow_tpu_torch.parallel import (
        MeshSpec,
        make_mesh,
        make_tp_train_step,
        shard_state_tp,
        tp_clip_transform,
    )
    from distributed_tensorflow_tpu_torch.utils.pytree import (
        _leaves_with_path,
        _to_numpy,
        flatten_pytree,
        path_key,
        shard_of,
    )

    torch.set_num_threads(1)
    spec = cluster.ClusterSpec({"worker": [f"127.0.0.1:{port}"] * world})
    assert cluster.maybe_initialize_distributed(spec, rank, "cpu")
    data, model_ways = LAYOUTS[layout]
    mesh = make_mesh("cpu", MeshSpec(data=-1, model=model_ways))

    def members(group):
        mine = torch.tensor([rank])
        out = [torch.empty_like(mine)
               for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, mine, group=group)
        return [int(t) for t in out]

    info = {"place": [mesh.data_index, mesh.model_index],
            "shape": [mesh.data, mesh.model],
            "model_group": members(mesh.model_group),
            "data_group": members(mesh.data_group)}

    local = GLOBAL_BATCH // data
    for case in LAYOUT_CASES[layout]:
        kind, clip, keep_prob, _ = CASES[case]
        model, opt, state = _port_state(case, work)
        state = shard_state_tp(state, mesh)
        if case == "cnn":
            # the shard the kernel reads: its own contiguous tensor
            wd1 = model.weights["wd1"]
            info["wd1"] = [list(wd1.shape), wd1.is_contiguous(),
                           wd1.untyped_storage().nbytes()
                           == wd1.numel() * wd1.element_size()]
        transform = (tp_clip_transform(CLIP[kind], state.params, mesh)
                     if clip else None)
        step_fn = make_tp_train_step(model, opt, mesh, keep_prob=keep_prob,
                                     grad_transform=transform)
        losses = []
        for b in _batches(case):
            x, y = _torch_batch(case, b)
            rows = slice(mesh.data_index * local,
                         (mesh.data_index + 1) * local)
            if kind == "cnn":
                x, y = x[rows], y[rows]
            state, m = step_fn(state, (x, y))
            losses.append(float(m["loss"]))
        flat = flatten_pytree(state)  # collective: the full layout
        mine = {path_key(p): np.array(_to_numpy(leaf)) for p, leaf in
                _leaves_with_path(state) if shard_of(leaf) is None}
        np.savez(os.path.join(work, f"local{rank}-{case}.npz"), **mine)
        if rank == 0:
            np.savez(os.path.join(work, f"full-{case}.npz"),
                     losses=np.asarray(losses), **flat)
        if case == "cnn-clip":
            # the sharded set of this state, every rank its file
            save_checkpoint_sharded(os.path.join(work, "sharded"), state,
                                    STEPS, attempt=ATTEMPT)
            if layout == "1x2":
                _coordinated_exits(rank, work, state)
    with open(os.path.join(work, f"info{rank}.json"), "w") as f:
        json.dump(info, f)
    dist.destroy_process_group()


def _coordinated_exits(rank, work, state):
    """``Supervisor.managed`` exits over a TP state, each in its own
    logdir: clean (the sharded set), ``exit_agreement:mode=error`` on
    every rank, ``collective_fetch:mode=error``, and with
    ``--sharded_checkpoint=false`` a clean exit (the chief's monolithic
    file) and ``cancel_gate:mode=error``. Writes what each printed and
    raised, and the files it left."""
    from distributed_tensorflow_tpu_torch.training.supervisor import (
        Supervisor,
    )
    from distributed_tensorflow_tpu_torch.utils import faults

    out = {}
    for name, spec, sharded in (
            ("clean", "", True),
            ("agreement", "exit_agreement:mode=error", True),
            ("fetch", "collective_fetch:mode=error", True),
            ("mono", "", False),
            ("gate", "cancel_gate:mode=error", False)):
        logdir = os.path.join(work, f"sv-{name}")
        faults.configure(spec or None)
        sv = Supervisor(is_chief=rank == 0, logdir=logdir,
                        save_model_secs=10 ** 6, sharded_spanning=sharded,
                        exit_agreement_timeout_s=20.0,
                        final_save_timeout_s=20.0)
        buf, raised = io.StringIO(), None
        try:
            with contextlib.redirect_stdout(buf):
                with sv.managed(state) as box:
                    box.update(state, STEPS)
        except RuntimeError as e:
            raised = str(e)
        faults.configure(None)
        out[name] = {"stdout": buf.getvalue(), "raised": raised,
                     "files": sorted(os.listdir(logdir))
                     if os.path.isdir(logdir) else []}
    with open(os.path.join(work, f"exits{rank}.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """layout -> the directory its grid wrote, each grid spawned once."""
    import jax

    from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN
    from distributed_tensorflow_tpu.models.transformer import (
        TransformerLM as JaxLM,
    )
    from distributed_tensorflow_tpu.training import train_state as jts
    from distributed_tensorflow_tpu_torch.utils.pytree import params_from_jax

    inits = {}
    for kind, jm in (("cnn", JaxDeepCNN()), ("lm", JaxLM(**LM_KW))):
        js = jts.create_train_state(jm, jts.adam(LR), seed=0)
        inits[kind] = {k: v.numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, js.params)).items()}
    cache = {}

    def get(layout):
        if layout not in cache:
            work = str(tmp_path_factory.mktemp(f"grid{layout}"))
            for kind, init in inits.items():
                np.savez(os.path.join(work, f"{kind}_init.npz"), **init)
            data, model = LAYOUTS[layout]
            _spawn(_tp_rank, data * model, free_port(), layout, work)
            cache[layout] = work
        return cache[layout]

    return get


_JAX_RUNS: dict = {}


def _jax_run(layout: str, case: str):
    """JAX's ``make_tp_train_step`` on the layout's device slice: the
    losses and the state's flat dict (gathered)."""
    key = (layout, case)
    if key in _JAX_RUNS:
        return _JAX_RUNS[key]
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN
    from distributed_tensorflow_tpu.models.transformer import (
        TransformerLM as JaxLM,
    )
    from distributed_tensorflow_tpu.parallel.mesh import MeshSpec, make_mesh
    from distributed_tensorflow_tpu.parallel import tensor_parallel as jtp
    from distributed_tensorflow_tpu.training import train_state as jts
    from distributed_tensorflow_tpu.utils.pytree import flatten_pytree

    kind, clip, keep_prob, block = CASES[case]
    assert keep_prob == 1.0  # JAX's threefry masks are not the port's
    data, model_ways = LAYOUTS[layout]
    mesh = make_mesh(MeshSpec(data=data, model=model_ways),
                     devices=jax.devices()[:data * model_ways])
    jm = JaxDeepCNN() if kind == "cnn" else JaxLM(**LM_KW, attn_block=block)
    opt = jts.adam(LR)
    state = jtp.shard_state_tp(jts.create_train_state(jm, opt, seed=0), mesh)
    step = jtp.make_tp_train_step(
        jm, opt, mesh, keep_prob=1.0, donate=False,
        grad_transform=jts.clip_by_global_norm(CLIP[kind]) if clip else None)
    losses = []
    for b in _batches(case):
        if kind == "lm":
            b = tuple(a.astype(np.int32) for a in b)
        state, m = step(state, jtp.stage_batch_tp(mesh, tuple(
            map(jnp.asarray, b))))
        losses.append(float(m["loss"]))
    _JAX_RUNS[key] = (np.asarray(losses), flatten_pytree(state,
                                                         tag_bf16=True))
    return _JAX_RUNS[key]


_SINGLE_RUNS: dict = {}


def _single_run(case: str, init_dir: str):
    """The port's one-process step on the same init and batches."""
    if case in _SINGLE_RUNS:
        return _SINGLE_RUNS[case]
    from distributed_tensorflow_tpu_torch.training import train_state as tts
    from distributed_tensorflow_tpu_torch.utils.pytree import flatten_pytree

    kind, clip, keep_prob, _ = CASES[case]
    model, opt, state = _port_state(case, init_dir)
    step = tts.make_train_step(
        model, opt, keep_prob=keep_prob,
        grad_transform=tts.clip_by_global_norm(CLIP[kind]) if clip else None)
    losses, norms = [], []
    for b in _batches(case):
        batch = _torch_batch(case, b)
        grads = tts.compute_grads(model, state.params, batch,
                                  keep_prob=1.0, rng=None,
                                  model_state=())[0]
        norms.append(float(sum(torch.sum(g * g) for g in
                               tts.tree_leaves(grads)) ** 0.5))
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    flat = {k: np.array(v) for k, v in flatten_pytree(state).items()}
    _SINGLE_RUNS[case] = (np.asarray(losses), flat, norms)
    return _SINGLE_RUNS[case]


def _assert_state_close(got: dict, want: dict, rtol: float):
    """Params and optimizer slots within ``rtol`` of each entry plus
    ``rtol`` of the leaf's scale (the slots of noise-sized gradients are
    noise themselves), but for adam's noise-gradient entries: at most
    0.1% of a leaf's entries may miss it, each by at most the adam bound
    2 * STEPS * LR."""
    keys = [k for k in want if k.startswith(("params/", "opt_state/"))]
    assert keys and all(k in got for k in keys)
    for k in keys:
        w = np.asarray(want[k], np.float64)
        d = np.abs(np.asarray(got[k], np.float64) - w)
        bad = d > rtol * (np.abs(w) + float(np.abs(w).max()))
        assert bad.mean() <= 1e-3 and d.max(initial=0) <= 2 * STEPS * LR, (
            f"{k}: {int(bad.sum())} of {bad.size} entries off, max "
            f"{d.max():.3e}")


PARITY = [(lay, c) for lay, cs in LAYOUT_CASES.items() for c in cs
          if CASES[c][2] == 1.0]


@pytest.mark.parametrize("layout,case", PARITY,
                         ids=[f"{lay}-{c}" for lay, c in PARITY])
def test_tp_trajectory_matches_jax_and_the_single_process_step(
        grids, layout, case):
    work = grids(layout)
    got = dict(np.load(os.path.join(work, f"full-{case}.npz")))
    jlosses, jflat = _jax_run(layout, case)
    slosses, sflat, norms = _single_run(case, work)
    if CASES[case][1]:
        # the clip bites: the first step's norm is over the bar
        assert norms[0] > CLIP[CASES[case][0]], norms
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4)
    np.testing.assert_allclose(got["losses"], slosses, rtol=1e-5)
    _assert_state_close(got, jflat, rtol=1e-4)
    _assert_state_close(got, sflat, rtol=1e-4)
    assert int(got["step"]) == STEPS


def test_tp_dropout_draws_the_single_process_masks(grids):
    """keep_prob 0.75 at 1x2: each rank keeps its columns of the full
    mask drawn from the one-rank run's seed, so the TP run is the
    one-process run, mask for mask."""
    work = grids("1x2")
    got = dict(np.load(os.path.join(work, "full-cnn-dropout.npz")))
    slosses, sflat, _ = _single_run("cnn-dropout", work)
    nodrop = np.load(os.path.join(work, "full-cnn.npz"))["losses"]
    assert np.abs(got["losses"] - nodrop).max() > 1e-3  # dropout is on
    np.testing.assert_allclose(got["losses"], slosses, rtol=1e-5)
    _assert_state_close(got, sflat, rtol=1e-4)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_grid_places_and_subgroups_match_jax_mesh(grids, layout):
    """Rank r sits where JAX's ``make_mesh(MeshSpec(model=m))`` puts
    device r of the slice; its model group is its mesh row and its data
    group its column, as the subgroups' own all_gather shows. Its wd1 is
    its own contiguous (3136, 1024/m) column shard."""
    import jax

    from distributed_tensorflow_tpu.parallel.mesh import MeshSpec, make_mesh

    work = grids(layout)
    data, model = LAYOUTS[layout]
    n = data * model
    devices = jax.devices()[:n]
    ids = np.vectorize(lambda d: devices.index(d))(
        make_mesh(MeshSpec(model=model), devices=devices).devices)
    assert ids.shape == (data, model)
    for r in range(n):
        info = json.load(open(os.path.join(work, f"info{r}.json")))
        (d,), (m,) = np.nonzero(ids == r)
        assert info["place"] == [d, m] and info["shape"] == [data, model]
        assert info["model_group"] == list(ids[d])
        assert info["data_group"] == list(ids[:, m])
        assert info["wd1"] == [[3136, 1024 // model], True, True]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_replicated_leaves_stay_bitwise_equal_over_each_model_group(
        grids, layout):
    """Every leaf a rank holds whole (convs, embeddings, layer norms, the
    head, adam's ``t``) is the same bytes on every rank of its model
    group, the clipped runs included: the clip's norm is the full
    model's on each rank."""
    work = grids(layout)
    data, model = LAYOUTS[layout]
    for case in LAYOUT_CASES[layout]:
        for row in range(data):
            ranks = [dict(np.load(os.path.join(
                work, f"local{row * model + i}-{case}.npz")))
                for i in range(model)]
            assert "params/weights/wd1" not in ranks[0]
            for other in ranks[1:]:
                assert sorted(other) == sorted(ranks[0])
                for k in ranks[0]:
                    np.testing.assert_array_equal(other[k], ranks[0][k],
                                                  err_msg=f"{case} {k}")


@pytest.mark.parametrize("layout", ["1x2", "2x2"])
def test_sharded_set_reads_bitwise_in_jax_and_dedupes(grids, layout):
    """Each rank's file of the sharded set: JAX's ``load_flat_sharded``
    and the port's reassemble the gathered state bit for bit, and the
    set's array bytes are the model's (the data axis's replicas are not
    written twice)."""
    from distributed_tensorflow_tpu.checkpoint import checkpoint as jckpt
    from distributed_tensorflow_tpu_torch.checkpoint import (
        checkpoint as tckpt,
    )

    work = grids(layout)
    data, model = LAYOUTS[layout]
    d = os.path.join(work, "sharded")
    names = sorted(os.listdir(d))
    assert names == sorted(
        [f"ckpt-{STEPS}.shard{p}-of-{data * model}.{ATTEMPT}.npz"
         for p in range(data * model)] + ["checkpoint"])
    want = {k: v for k, v in np.load(
        os.path.join(work, "full-cnn-clip.npz")).items() if k != "losses"}
    for flat in (jckpt.load_flat_sharded(d, STEPS),
                 tckpt.load_flat_sharded(d, STEPS)):
        assert sorted(flat) == sorted(want)
        for k in want:
            assert flat[k].dtype == want[k].dtype
            np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    stored = 0
    for name in names:
        if name.endswith(".npz"):
            with np.load(os.path.join(d, name)) as z:
                stored += sum(z[k].nbytes for k in z.files
                              if k != "__shardmeta__")
    assert stored == sum(v.nbytes for v in want.values())


def test_port_reads_a_set_jax_wrote(tmp_path):
    """JAX's own sharded save of a TP state (two devices, so wd1 and its
    slots stored as two column slices) restores into a port template."""
    import jax

    from distributed_tensorflow_tpu.checkpoint import checkpoint as jckpt
    from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN
    from distributed_tensorflow_tpu.parallel.mesh import MeshSpec, make_mesh
    from distributed_tensorflow_tpu.parallel import tensor_parallel as jtp
    from distributed_tensorflow_tpu.training import train_state as jts
    from distributed_tensorflow_tpu.utils.pytree import flatten_pytree
    from distributed_tensorflow_tpu_torch.checkpoint import (
        restore_with_fallback,
    )
    from distributed_tensorflow_tpu_torch.models import DeepCNN
    from distributed_tensorflow_tpu_torch.training import train_state as tts

    mesh = make_mesh(MeshSpec(data=1, model=2), devices=jax.devices()[:2])
    js = jtp.shard_state_tp(jts.create_train_state(
        JaxDeepCNN(), jts.adam(LR), seed=3), mesh)
    path = jckpt.save_checkpoint_sharded(str(tmp_path), js, 9)
    meta = json.loads(bytes(np.load(path)["__shardmeta__"]).decode())
    assert len(meta["leaves"]["params/weights/wd1"]["entries"]) == 2
    template = tts.create_train_state(DeepCNN(), tts.adam(LR))
    state, step, _ = restore_with_fallback(str(tmp_path), template)
    assert step == 9
    from distributed_tensorflow_tpu_torch.utils.pytree import (
        flatten_pytree as tflat,
    )

    got, want = tflat(state), flatten_pytree(js, tag_bf16=True)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_incomplete_or_mixed_set_falls_back_one_step(grids, tmp_path):
    """A set missing a shard, or mixing two attempts' files, is not
    restorable: the restore lands on the step before it."""
    from distributed_tensorflow_tpu_torch.checkpoint import (
        latest_checkpoint,
        restore_with_fallback,
        save_checkpoint,
    )
    from distributed_tensorflow_tpu_torch.models import DeepCNN
    from distributed_tensorflow_tpu_torch.training import train_state as tts

    src = os.path.join(grids("1x2"), "sharded")
    template = tts.create_train_state(DeepCNN(), tts.adam(LR))
    for how in ("missing", "mixed"):
        d = tmp_path / how
        shutil.copytree(src, d)
        save_checkpoint(str(d), template, STEPS - 1)
        assert latest_checkpoint(str(d))[1] == STEPS
        shard1 = d / f"ckpt-{STEPS}.shard1-of-2.{ATTEMPT}.npz"
        if how == "missing":
            shard1.unlink()
        else:
            shard1.rename(d / f"ckpt-{STEPS}.shard1-of-2.ffffffff.npz")
        _, step, rep = restore_with_fallback(str(d), template)
        assert step == STEPS - 1 and rep.fallback_depth == 0


def test_coordinated_exits_fire_the_fault_points_on_every_rank(grids):
    """``Supervisor.managed`` over a TP state on both ranks of 1x2: a
    clean exit writes the sharded set (each rank its file, rank 0 the
    index); ``exit_agreement:mode=error`` skips the save on every rank
    alike and raises on the clean exit; ``collective_fetch:mode=error``
    fails the save loudly; under ``--sharded_checkpoint=false`` the chief
    writes the gathered state monolithic, and ``cancel_gate:mode=error``
    fails that write after the gather (rank 1 joined it)."""
    from distributed_tensorflow_tpu_torch.checkpoint import load_flat

    work = grids("1x2")
    exits = [json.load(open(os.path.join(work, f"exits{r}.json")))
             for r in (0, 1)]
    files = sorted(os.listdir(os.path.join(work, "sv-clean")))
    assert files == ["checkpoint"] + [
        f"ckpt-{STEPS}.shard{p}-of-2.{files[1].split('.')[2]}.npz"
        for p in (0, 1)]
    for e in exits:
        assert e["clean"]["raised"] is None
        agreement = e["agreement"]
        assert agreement["files"] == []
        assert "exit agreement failed: injected fault at exit_agreement" \
            in agreement["stdout"]
        assert "never reached the exit agreement" in agreement["raised"]
        assert e["fetch"]["files"] == [] and e["fetch"]["raised"] is None
        assert "final checkpoint failed: injected fault at " \
            "collective_fetch" in e["fetch"]["stdout"]
    assert exits[0]["mono"]["files"] == ["checkpoint", f"ckpt-{STEPS}.npz"]
    saved = load_flat(os.path.join(work, "sv-mono", f"ckpt-{STEPS}.npz"))
    sharded_dir = os.path.join(work, "sv-clean")
    want = load_flat(os.path.join(sharded_dir, next(
        f for f in files if ".shard0" in f)))
    assert sorted(saved) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(saved[k], want[k], err_msg=k)
    assert exits[0]["gate"]["files"] == []
    assert "final checkpoint failed: injected fault at cancel_gate" in \
        exits[0]["gate"]["stdout"]
    assert exits[1]["gate"]["stdout"] == ""


# ------------------------------------------------------------ the tables


def _jax_and_port_params(name):
    import jax

    from distributed_tensorflow_tpu.models.registry import (
        get_model as jget,
    )
    from distributed_tensorflow_tpu_torch.models import get_model
    from distributed_tensorflow_tpu_torch.training.train_state import (
        params_of,
    )

    kw = {"lm": LM_KW}.get(name, {})
    jm, tm = jget(name, **kw), get_model(name, **kw)
    jparams = jm.init(jax.random.key(0))
    if set(jparams) == {"params", "state"}:
        jparams = jparams["params"]
    return jparams, params_of(tm.init(torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("name", ["deep_cnn", "mlp", "resnet20", "lm"])
def test_spec_tables_match_jax_entry_for_entry(name):
    import jax
    from jax.sharding import PartitionSpec as P

    from distributed_tensorflow_tpu.parallel import tensor_parallel as jtp
    from distributed_tensorflow_tpu_torch.parallel import (
        has_tp_specs,
        tensor_parallel,
    )
    from distributed_tensorflow_tpu_torch.utils.pytree import (
        _leaves_with_path,
        path_key,
    )

    jparams, params = _jax_and_port_params(name)
    jspecs = jtp.tp_param_specs(jparams)
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): str(tuple(s))
            for path, s in jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda x: isinstance(x, P))[0]}
    paths = [path_key(p) for p, _ in _leaves_with_path(params)]
    got = dict(zip(paths, map(str, tensor_parallel._param_spec_list(
        params))))
    assert got == want
    assert has_tp_specs(params) == jtp.has_tp_specs(jparams) == (
        name in ("deep_cnn", "lm"))


def test_divisibility_message_matches_jax_word_for_word():
    import jax

    from distributed_tensorflow_tpu.parallel.mesh import MeshSpec, make_mesh
    from distributed_tensorflow_tpu.parallel import tensor_parallel as jtp
    from distributed_tensorflow_tpu_torch.parallel import tensor_parallel

    class ThreeWays:
        shape = {"model": 3}

    for name in ("deep_cnn", "lm"):
        jparams, params = _jax_and_port_params(name)
        with pytest.raises(ValueError) as want:
            jtp._check_divisibility(
                jparams, jtp.tp_param_specs(jparams),
                make_mesh(MeshSpec(data=1, model=3),
                          devices=jax.devices()[:3]))
        with pytest.raises(ValueError) as got:
            tensor_parallel._check_divisibility(
                params, tensor_parallel.tp_param_specs(params), ThreeWays())
        assert str(got.value) == str(want.value)
