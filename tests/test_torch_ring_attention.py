"""The port's ring (``parallel/mesh.ring_shift``,
``ops/attention.ring_attention``) against the JAX package's
``ring_attention`` under ``shard_map`` and against the port's dense
attention, on the CPU.

Four gloo ranks, one process each, are spawned once (a module fixture).
They shift a tensor round model groups of 2 (a 2x2 grid), 4 (1x4) and 3
(a subgroup of the first three ranks), and run ring attention at P = 2
and 4 on numpy-seeded float32 q/k/v (B 2, S 16, H 2, Dh 8), causal and
not, forward and backward against a seeded cotangent. The parent
gathers the blocks and holds them against JAX's ring on a 2- and
4-device slice of the tests' virtual devices and against the port's
``multi_head_attention`` with autograd.

Tolerances: outputs rtol 1e-5, atol 1e-6; q/k/v gradients rtol 1e-5,
atol 1e-5 (the ring folds the blocks in another order than the dense
softmax; both sums are float32). The bytes each rank sent are
``sp_comm_rows``' forward and backward rows for one layer, exactly.

The rank processes are spawned and import this module, so it imports
JAX only inside the tests that run in the parent."""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_tensor_parallel import _spawn, free_port

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

SHAPE = (2, 16, 2, 8)  # (B, S, H, Dh)
WORLD = 4
WAYS = (2, 4)
CAUSAL = (False, True)
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs():
    """q, k, v and the cotangent of the output, float32, from a seed."""
    rng = np.random.default_rng(7)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


def _ring_rank(rank, world, port, work):
    """One rank: ring_shift on groups of 2, 4 and 3, then ring attention
    at P = 2 and 4, each writing what it saw."""
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch import cluster
    from distributed_tensorflow_tpu_torch.ops.attention import ring_attention
    from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh

    torch.set_num_threads(1)
    spec = cluster.ClusterSpec({"worker": [f"127.0.0.1:{port}"] * world})
    assert cluster.maybe_initialize_distributed(spec, rank, "cpu")
    meshes = {p: tmesh.make_mesh("cpu", tmesh.MeshSpec(model=p))
              for p in WAYS}
    # a model group of three: ranks 0-2 (new_group is collective)
    trio = dist.new_group([0, 1, 2])
    if rank < 3:
        meshes[3] = tmesh.GridMesh(
            rank=rank, world_size=world, device=torch.device("cpu"),
            backend="gloo", data=1, model=3, data_index=0, model_index=rank,
            model_group=trio, data_group=None)
    out = {"shift": {}}
    for p in sorted(meshes):
        mesh = meshes[p]
        tmesh.RING_BYTES = 0
        got = tmesh.ring_shift(torch.full((2, 3), float(rank)), mesh)
        out["shift"][str(p)] = {"got": got.tolist(),
                                "bytes": tmesh.RING_BYTES,
                                "model_index": mesh.model_index}
    q, k, v, g = (torch.from_numpy(a) for a in _inputs())
    for p in WAYS:
        mesh = meshes[p]
        block = SHAPE[1] // p
        cols = slice(mesh.model_index * block, (mesh.model_index + 1) * block)
        for causal in CAUSAL:
            ts = [t[:, cols].clone().requires_grad_() for t in (q, k, v)]
            tmesh.RING_BYTES = 0
            o = ring_attention(*ts, mesh, causal=causal)
            fwd = tmesh.RING_BYTES
            grads = torch.autograd.grad(o, ts, g[:, cols])
            np.savez(os.path.join(work, f"ring-p{p}-c{int(causal)}-r{rank}"
                                  ".npz"),
                     out=o.detach().numpy(),
                     **{f"d{n}": t.numpy() for n, t in zip("qkv", grads)},
                     fwd=fwd, bwd=tmesh.RING_BYTES - fwd,
                     block=mesh.model_index, row=mesh.data_index)
    with open(os.path.join(work, f"shift{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The directory the four ranks wrote."""
    work = str(tmp_path_factory.mktemp("ring"))
    _spawn(_ring_rank, WORLD, free_port(), work)
    return work


def _gathered(work, p, causal, row=0):
    """The output and gradients of the ranks of grid row ``row``,
    concatenated along the sequence in block order."""
    files = [np.load(os.path.join(
        work, f"ring-p{p}-c{int(causal)}-r{row * p + i}.npz"))
        for i in range(p)]
    assert [int(f["block"]) for f in files] == list(range(p))
    return {n: np.concatenate([f[n] for f in files], axis=1)
            for n in ("out", "dq", "dk", "dv")}, files


def _jax_ring(p, causal):
    """JAX's ring_attention under shard_map on ``p`` virtual devices:
    the output and the q/k/v gradients of each shard's local loss."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from distributed_tensorflow_tpu.ops.attention import ring_attention
    from distributed_tensorflow_tpu.parallel.mesh import (
        MODEL_AXIS,
        MeshSpec,
        make_mesh,
    )

    q, k, v, g = (jnp.asarray(a) for a in _inputs())
    mesh = make_mesh(MeshSpec(data=1, model=p), devices=jax.devices()[:p])
    spec = P(None, MODEL_AXIS)

    def local(qkv, g):
        def loss(qkv):
            return (ring_attention(*qkv, MODEL_AXIS, causal=causal)
                    * g).sum()
        return (ring_attention(*qkv, MODEL_AXIS, causal=causal),
                *jax.grad(loss)(qkv))

    out = jax.jit(jax.shard_map(local, mesh=mesh,
                                in_specs=((spec,) * 3, spec),
                                out_specs=(spec,) * 4,
                                check_vma=False))((q, k, v), g)
    return dict(zip(("out", "dq", "dk", "dv"),
                    (np.asarray(a) for a in out)))


def _dense(causal):
    """The port's dense attention over the whole sequence, with autograd."""
    from distributed_tensorflow_tpu_torch.ops.attention import (
        multi_head_attention,
    )

    q, k, v, g = (torch.from_numpy(a) for a in _inputs())
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    o = multi_head_attention(*ts, causal=causal)
    grads = torch.autograd.grad(o, ts, g)
    return dict(zip(("out", "dq", "dk", "dv"),
                    (t.detach().numpy() for t in (o, *grads))))


CASES = [(p, c) for p in WAYS for c in CAUSAL]


@pytest.mark.parametrize("p,causal", CASES,
                         ids=[f"p{p}-{'causal' if c else 'full'}"
                              for p, c in CASES])
def test_ring_matches_jax_ring_and_dense_attention(ranks, p, causal):
    got, _ = _gathered(ranks, p, causal)
    for want in (_jax_ring(p, causal), _dense(causal)):
        np.testing.assert_allclose(got["out"], want["out"], **OUT_TOL)
        for n in ("dq", "dk", "dv"):
            np.testing.assert_allclose(got[n], want[n], err_msg=n,
                                       **GRAD_TOL)


@pytest.mark.parametrize("p,causal", CASES,
                         ids=[f"p{p}-{'causal' if c else 'full'}"
                              for p, c in CASES])
def test_ring_bytes_are_sp_comm_rows(ranks, p, causal):
    """Each rank sent the forward's P - 1 hops of k and v and the
    backward's P hops of k, v, dk and dv: ``sp_comm_rows`` for one
    layer, to the byte. Every row of a grid computes the same."""
    from distributed_tensorflow_tpu_torch.parallel import sp_comm_rows

    got, files = _gathered(ranks, p, causal)
    block = SHAPE[0] * (SHAPE[1] // p) * SHAPE[2] * SHAPE[3] * 4
    fwd, bwd = (r["bytes"] for r in sp_comm_rows(block, p, 1))
    for f in files:
        assert (int(f["fwd"]), int(f["bwd"])) == (fwd, bwd)
    for row in range(1, WORLD // p):
        other, _ = _gathered(ranks, p, causal, row)
        for n in got:
            np.testing.assert_array_equal(other[n], got[n])


@pytest.mark.parametrize("p", [2, 3, 4])
def test_ring_shift_rotates_to_the_next_rank(ranks, p):
    """Model index i receives from (i - 1) % P of its own group, in
    world ranks (a 2x2 grid's rows, a 1x4 grid, a group of three), and
    counts the bytes it sent."""
    members = {2: [[0, 1], [2, 3]], 3: [[0, 1, 2]], 4: [[0, 1, 2, 3]]}[p]
    for row in members:
        for i, r in enumerate(row):
            seen = json.load(open(os.path.join(
                ranks, f"shift{r}.json")))["shift"][str(p)]
            assert seen["model_index"] == i
            assert seen["got"] == [[float(row[(i - 1) % p])] * 3] * 2
            assert seen["bytes"] == 2 * 3 * 4
    assert "3" not in json.load(open(os.path.join(
        ranks, "shift3.json")))["shift"]
