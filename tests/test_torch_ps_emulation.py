"""The port's asynchronous parameter-server topology against the JAX
package's: the wire frames byte for byte, the bf16 bits, the shard
placement, the ps-side optimizers bitwise, a ps of one package serving a
worker of the other, the worker's gradients, the mirror cycle, the flag
refusals and the entry point (CPU).

Tolerances: the worker's gradients are float32 sums that torch and XLA
order differently (rtol 1e-4); on the bf16 wire both round the same
float32 gradients to bf16, so they differ by one bf16 ulp where the
float32 values straddle a rounding boundary, bounded by 2e-2 of the
gradient's scale. The mirror against the JAX mirror compounds those
gradients over 5 cycles at a small rate (rtol 1e-4 of each parameter,
atol 1e-6). The port's mirror replays the ps's numpy arithmetic
operation for operation, so on one worker it lands the ps bitwise where
the full-pull cycle does."""

import os
import socket
import struct
import subprocess
import sys
import threading

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import get_model as jget_model
from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN
from distributed_tensorflow_tpu.parallel import ps_emulation as jps
from distributed_tensorflow_tpu.utils.pytree import flatten_pytree as jflat
from distributed_tensorflow_tpu_torch import flags as tflags
from distributed_tensorflow_tpu_torch.checkpoint import checkpoint as tckpt
from distributed_tensorflow_tpu_torch.cluster import ClusterSpec
from distributed_tensorflow_tpu_torch.models import get_model
from distributed_tensorflow_tpu_torch.parallel import ps_emulation as tps
from distributed_tensorflow_tpu_torch.utils.pytree import tree_leaves

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_mnist_idx(data_dir, n_train=512, n_test=128):
    """A small MNIST-format split of procedural digits in ``data_dir``
    (a process loads it in milliseconds; rendering the default 20,000
    synthetic digits takes seconds)."""
    from distributed_tensorflow_tpu_torch.data import synthetic_digits

    os.makedirs(data_dir, exist_ok=True)
    for stem, n, seed in (("train", n_train, 0), ("t10k", n_test, 1)):
        x, y = synthetic_digits(n, seed=seed)
        for kind, arr in (("images-idx3", np.round(x.reshape(n, 28, 28)
                                                   * 255)),
                          ("labels-idx1", y)):
            with open(os.path.join(data_dir, f"{stem}-{kind}-ubyte"),
                      "wb") as f:
                f.write(bytes([0, 0, 0x08, arr.ndim]))
                f.write(struct.pack(f">{arr.ndim}i", *arr.shape))
                f.write(arr.astype(np.uint8).tobytes())
    return data_dir


def _frames():
    rng = np.random.default_rng(0)
    return {
        "f32": {"op": "push_grads", "count_step": True, "worker": "ab",
                "seq": 3, "grads": {
                    "weights/wd1": rng.standard_normal((4, 3), np.float32),
                    "biases/out": rng.standard_normal(3, np.float32)}},
        "bf16": {"op": "push_grads", "encoding": "bf16", "grads": {
            "w": jps._bf16_encode(rng.standard_normal((2, 5), np.float32))}},
        "0d": {"op": "pull", "params": {"s": np.array(7.5, np.float32),
                                        "t": np.array(3, np.int32)}},
        "int": {"ok": True, "global_step": 12, "t": {"w": 4},
                "params": {"c": np.arange(6, dtype=np.int64).reshape(2, 3),
                           "d": np.arange(4, dtype=np.float64)}},
    }


@pytest.mark.parametrize("kind", ["f32", "bf16", "0d", "int"])
def test_frames_are_byte_equal_to_jax_both_ways(kind):
    msg = _frames()[kind]
    frame = tps._encode_msg(msg)
    assert frame == jps._encode_msg(msg)
    # a pickle stream starts with PROTO (0x80); the frame is u64 | JSON | raw
    assert frame[8:9] == b"{" and b"\x80\x04" not in frame[:64]
    for send, recv in ((jps._send_msg, tps._recv_msg),
                       (tps._send_msg, jps._recv_msg)):
        a, b = socket.socketpair()
        try:
            send(a, msg)
            got = recv(b)
        finally:
            a.close()
            b.close()
        assert sorted(got) == sorted(msg)
        for k, v in msg.items():
            if isinstance(v, dict) and all(isinstance(x, np.ndarray)
                                           for x in v.values()):
                for kk, arr in v.items():
                    assert got[k][kk].dtype == arr.dtype
                    assert got[k][kk].shape == arr.shape
                    np.testing.assert_array_equal(got[k][kk], arr)
            else:
                assert got[k] == v


def test_bf16_bits_equal_ml_dtypes():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                        3.3895314e38, -3.3895314e38, 1e-40, -1e-45,
                        1.0039062, 1.0117188, 65504.0], np.float32)
    for a in (bits.view(np.float32), special,
              rng.standard_normal((3, 7)).astype(np.float32),
              np.float32(1.00390625)):
        with np.errstate(invalid="ignore"):  # ml_dtypes' cast of a NaN
            want = np.asarray(a, np.float32).astype(
                ml_dtypes.bfloat16).view(np.uint16)
        got = tps._bf16_encode(a)
        assert got.dtype == np.uint16 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        finite = np.isfinite(np.asarray(a, np.float32))
        np.testing.assert_array_equal(
            tps._bf16_decode(got)[finite],
            want.view(ml_dtypes.bfloat16).astype(np.float32)[finite])


@pytest.mark.parametrize("num_ps", [1, 2, 3])
def test_assign_shards_equal(num_ps):
    keys = list(jflat(JaxDeepCNN().init(jax.random.PRNGKey(0))))
    assert tps.assign_shards(keys, num_ps) == jps.assign_shards(keys, num_ps)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("mirror", [True, False])
def test_comm_rows_equal_jax(wire, mirror):
    n = 4 * 3_274_634
    assert tps.ps_comm_rows(n, n, wire=wire, mirror=mirror) == \
        jps.ps_comm_rows(n, n, wire=wire, mirror=mirror)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_ps_optimizer_is_bitwise_equal_to_jax(name):
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((64, 33)).astype(np.float32)
    pt, pj = p0.copy(), p0.copy()
    ot, oj = tps._PsOptimizer(name, 1e-3), jps._PsOptimizer(name, 1e-3)
    assert tps._PsOptimizer.NAMES == jps._PsOptimizer.NAMES
    for _ in range(5):
        g = rng.standard_normal(p0.shape).astype(np.float32)
        ot.apply("w", pt, g)
        oj.apply("w", pj, g)
        np.testing.assert_array_equal(pt, pj)
    assert not np.array_equal(pt, p0)
    for n in tps.MirrorCycle.SLOT_NAMES[name]:
        np.testing.assert_array_equal(ot._slots["w"][n], oj._slots["w"][n])
    assert ot._t == oj._t


@pytest.fixture
def port_ps():
    servers = [tps.PSServer(i, "127.0.0.1:0") for i in range(2)]
    for s in servers:
        s.start_background()
    clients = []

    def client(**kw):
        c = tps.PSClient([s.address for s in servers], **kw)
        clients.append(c)
        return c

    yield servers, client
    for c in clients:
        c.close()
    for s in servers:
        s.close()


def test_init_pull_push_cycle_and_the_global_step(port_ps):
    servers, client = port_ps
    a, b = client(), client()
    assert a.call(0, {"op": "ping"})["initialized"] is False
    assert a.call(0, {"op": "pull"}) == {"ok": False, "uninitialized": True}
    flat = {"a": np.ones(4, np.float32), "b": np.full(3, 2.0, np.float32)}
    assignment = tps.assign_shards(list(flat), 2)
    a.init_params(flat, assignment, optimizer="sgd", learning_rate=0.5)
    b.wait_initialized(poll_s=0.01)
    got, step = a.pull_all()
    assert step == 0 and sorted(got) == ["a", "b"]
    grads = {"a": np.ones(4, np.float32), "b": np.ones(3, np.float32)}
    for i in range(3):  # two workers' pushes count on one shared step
        assert a.push_grads(grads, assignment) == 2 * i + 1
        assert b.push_grads(grads, assignment) == 2 * i + 2
    got, step = b.pull_all()
    assert step == 6 and a.get_step() == 6
    np.testing.assert_allclose(got["a"], 1.0 - 6 * 0.5)
    bits, _ = client(wire="bf16").pull_all()
    assert bits["b"].dtype == np.uint16
    np.testing.assert_array_equal(tps._bf16_decode(bits["b"]), got["b"])
    with pytest.raises(ValueError, match="rejected init"):
        a.init_params(flat, assignment, optimizer="rmsprop")


def test_concurrent_pushes_are_all_applied(port_ps):
    _, client = port_ps
    flat = {"w": np.zeros(64, np.float32)}
    assignment = tps.assign_shards(list(flat), 2)
    client().init_params(flat, assignment, optimizer="sgd",
                         learning_rate=1.0)
    n_threads, pushes, errors = 8, 10, []

    def worker():
        try:
            c = client()
            for _ in range(pushes):
                c.push_grads({"w": np.full(64, -1.0, np.float32)},
                             assignment)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    got, step = client().pull_all()
    assert step == n_threads * pushes
    np.testing.assert_array_equal(got["w"], n_threads * pushes)


def test_a_lost_reply_is_resent_and_deduped(port_ps):
    servers, client = port_ps
    c = client()
    flat = {"a": np.zeros(2, np.float32), "b": np.zeros(2, np.float32)}
    assignment = tps.assign_shards(list(flat), 2)
    c.init_params(flat, assignment, optimizer="sgd", learning_rate=1.0)
    servers[0].drop_reply_once.add("push_grads")
    step = c.push_grads({k: np.ones(2, np.float32) for k in flat},
                        assignment)
    got, _ = c.pull_all()
    assert step == 1  # the resend was recognized, not applied again
    np.testing.assert_array_equal(got["a"], -1.0)
    np.testing.assert_array_equal(got["b"], -1.0)
    c.debug_break_connections(1)
    assert c.push_grads({k: np.ones(2, np.float32) for k in flat},
                        assignment) == 2


def _jax_init_flat(seed=0):
    return {k: np.asarray(v) for k, v in
            jflat(JaxDeepCNN().init(jax.random.PRNGKey(seed))).items()}


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_cross_package_ps_lands_where_all_jax_does(server_pkg, wire):
    """A JAX ps serving the port's client, or the port's ps serving the
    JAX client: after init and 5 adam pushes of the same gradients the
    params equal the all-JAX run's bitwise."""
    flat = _jax_init_flat()
    rng = np.random.default_rng(3)
    grads = [{k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
              for k, v in flat.items()} for _ in range(5)]

    def run(server_cls, client_cls):
        servers = [server_cls(i, "127.0.0.1:0") for i in range(2)]
        for s in servers:
            s.start_background()
        client = client_cls([s.address for s in servers], wire=wire)
        try:
            assignment = tps.assign_shards(list(flat), 2)
            client.init_params(flat, assignment, optimizer="adam",
                               learning_rate=1e-3, num_workers=2)
            for g in grads:
                client.push_grads(g, assignment)
            got, step = client.pull_all()
            return {k: np.asarray(v).view(np.uint16)
                    if wire == "bf16" else np.asarray(v)
                    for k, v in got.items()}, step
        finally:
            client.close()
            for s in servers:
                s.close()

    want, wstep = run(jps.PSServer, jps.PSClient)
    mixed = ((jps.PSServer, tps.PSClient) if server_pkg == "jax"
             else (tps.PSServer, jps.PSClient))
    got, step = run(*mixed)
    assert step == wstep == 5 and sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _batch(n, seed):
    r = np.random.default_rng(seed)
    x = r.random((n, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[r.integers(0, 10, n)]
    return x, y


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_grad_fn_matches_jax_at_deep_cnn_width(wire):
    """``make_grad_fn`` of both packages at deep_cnn's full width, batch
    8, keep_prob 1, on the same params (bf16 wire: the same bf16 bits,
    widened on the device)."""
    flat = _jax_init_flat(seed=4)
    x, y = _batch(8, 4)
    jmodel = JaxDeepCNN()
    template = jmodel.init(jax.random.PRNGKey(0))
    jfn = jps.make_grad_fn(jmodel, 1.0, devices=jax.devices()[:1],
                           wire=wire)
    if wire == "bf16":
        wired = {k: jps._bf16_encode(v) for k, v in flat.items()}
        jparams = jps.unflatten_params(jps.bf16_template(template),
                                       {k: v.view(ml_dtypes.bfloat16)
                                        for k, v in wired.items()})
    else:
        wired = flat
        jparams = jps.unflatten_params(template, flat)
    jgrads, jm = jfn(jparams, (x, y), jax.random.PRNGKey(0))
    want = {k: np.asarray(v).astype(np.float32)
            for k, v in jflat(jgrads).items()}

    model = get_model("deep_cnn")
    params = tps.params_of(model)
    leaves, keys = tree_leaves(params), tps._leaf_keys(params)
    tps.upload_params(leaves, keys, wired)
    tfn = tps.make_grad_fn(model, 1.0, wire=wire)
    grads, tm = tfn((torch.from_numpy(x), torch.from_numpy(y)))
    assert all(g.dtype == (torch.bfloat16 if wire == "bf16"
                           else torch.float32) for g in grads)
    got = {k: h if h.dtype == np.float32 else tps._bf16_decode(h)
           for k, h in zip(keys, tps.grads_to_host(grads))}
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for k in want:
        if wire == "f32":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        else:
            scale = np.abs(want[k]).max()
            assert np.abs(got[k] - want[k]).max() <= 2e-2 * scale, k


def test_grad_fn_refuses_a_stateful_model():
    with pytest.raises(NotImplementedError, match="stateless models"):
        tps.make_grad_fn(get_model("resnet20"), 1.0)


def _mlp_flat():
    return {k: np.asarray(v) for k, v in jflat(jget_model(
        "mlp", hidden_units=32).init(jax.random.PRNGKey(5))).items()}


def _ps_pair(pkg, flat, optimizer, lr):
    server = pkg.PSServer(0, "127.0.0.1:0")
    server.start_background()
    client = pkg.PSClient([server.address])
    assignment = pkg.assign_shards(list(flat), 1)
    client.init_params(flat, assignment, optimizer=optimizer,
                       learning_rate=lr)
    return server, client, assignment


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam"])
def test_mirror_cycle_matches_full_pull_and_jax_mirror(optimizer):
    """5 mirror cycles of the port (params replayed on the device) land
    the ps bitwise where 5 port full-pull cycles do, and within rtol
    1e-4 of 5 JAX MirrorCycle cycles, from one init and one batch
    stream."""
    flat, lr, cycles = _mlp_flat(), 1e-3, 5
    batches = [_batch(8, 10 + i) for i in range(cycles)]

    def port_model():
        m = get_model("mlp", hidden_units=32)
        m.init(torch.Generator().manual_seed(0))
        return m

    results = {}
    # the port's mirror
    server, client, assignment = _ps_pair(tps, flat, optimizer, lr)
    try:
        model = port_model()
        cyc = tps.MirrorCycle(client, model, tps.make_grad_fn(model, 1.0),
                              assignment, learning_rate=lr,
                              resync_steps=10**6, optimizer=optimizer)
        assert cyc.maybe_sync()
        for x, y in batches:
            cyc.run_cycle((torch.from_numpy(x), torch.from_numpy(y)))
        cyc.drain()
        assert cyc.step == cyc.mirror_step == cycles
        results["mirror"], _ = client.pull_all()
        # the mirror's params are the ps's
        for k, p in zip(tps._leaf_keys(cyc.params), tree_leaves(cyc.params)):
            np.testing.assert_array_equal(p.detach().numpy(),
                                          results["mirror"][k], err_msg=k)
    finally:
        client.close()
        server.close()
    # the port's full-pull cycle
    server, client, assignment = _ps_pair(tps, flat, optimizer, lr)
    try:
        model = port_model()
        params = tps.params_of(model)
        leaves, keys = tree_leaves(params), tps._leaf_keys(params)
        fn = tps.make_grad_fn(model, 1.0)
        for x, y in batches:
            pulled, _ = client.pull_all()
            tps.upload_params(leaves, keys, pulled)
            grads, _ = fn((torch.from_numpy(x), torch.from_numpy(y)))
            client.push_grads(dict(zip(keys, tps.grads_to_host(grads))),
                              assignment)
        results["full"], step = client.pull_all()
        assert step == cycles
    finally:
        client.close()
        server.close()
    # the JAX mirror
    server, client, assignment = _ps_pair(jps, flat, optimizer, lr)
    try:
        jmodel = jget_model("mlp", hidden_units=32)
        template = jmodel.init(jax.random.PRNGKey(0))
        jcyc = jps.MirrorCycle(
            client, jps.make_grad_fn(jmodel, 1.0, devices=jax.devices()[:1]),
            template, assignment, learning_rate=lr, resync_steps=10**6,
            optimizer=optimizer)
        assert jcyc.maybe_sync()
        for b in batches:
            jcyc.run_cycle(b, jax.random.PRNGKey(0))
        jcyc.drain()
        results["jax"], _ = client.pull_all()
    finally:
        client.close()
        server.close()
    for k in flat:
        np.testing.assert_array_equal(results["mirror"][k],
                                      results["full"][k], err_msg=k)
        np.testing.assert_allclose(results["mirror"][k], results["jax"][k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
        assert not np.array_equal(results["mirror"][k], flat[k]), k


def test_mirror_resyncs_on_a_foreign_push_and_adopts_the_ps_slots():
    flat = _mlp_flat()
    server, client, assignment = _ps_pair(tps, flat, "adam", 0.01)
    rogue = tps.PSClient([server.address])
    try:
        model = get_model("mlp", hidden_units=32)
        model.init(torch.Generator().manual_seed(0))
        cyc = tps.MirrorCycle(client, model, tps.make_grad_fn(model, 1.0),
                              assignment, learning_rate=0.01,
                              resync_steps=10**6, optimizer="adam")
        assert cyc.maybe_sync()
        x, y = (torch.from_numpy(a) for a in _batch(8, 0))
        cyc.run_cycle((x, y))
        cyc.run_cycle((x, y))  # pushes cycle 1 -> step 1
        assert cyc.step == 1 and not cyc.needs_resync
        rogue.push_grads({k: np.full_like(v, 0.1) for k, v in flat.items()},
                         assignment)
        cyc.run_cycle((x, y))  # sees the step jump 1 -> 3
        assert cyc.step == 3 and cyc.needs_resync
        assert cyc.maybe_sync()  # drains (step 4), adopts params and slots
        assert cyc.mirror_step == cyc.step == 4 and cyc._t == [4] * 4
        pulled, _ = client.pull_all()
        for k, p in zip(tps._leaf_keys(cyc.params), tree_leaves(cyc.params)):
            np.testing.assert_array_equal(p.detach().numpy(), pulled[k])
        opt = server.optimizer
        for n in ("m", "v"):
            for k, s in zip(tps._leaf_keys(cyc.params), cyc._slots[n]):
                np.testing.assert_array_equal(s.numpy(), opt._slots[k][n])
    finally:
        rogue.close()
        client.close()
        server.close()


class _Flags:
    lr_schedule = "constant"
    warmup_steps = 0
    accum_steps = 1
    weight_decay = 0.0
    augment = False
    eval_step = 0
    ps_wire = "f32"
    seq_parallel = False


@pytest.mark.parametrize("flag, value", [
    (None, None), ("lr_schedule", "cosine"), ("warmup_steps", 5),
    ("accum_steps", 2), ("weight_decay", 1e-4), ("augment", True),
    ("eval_step", 10), ("ps_wire", "fp8"), ("seq_parallel", True)])
def test_unsupported_flag_messages_equal_jax(flag, value):
    F = type("F", (_Flags,), {} if flag is None else {flag: value})
    want = jps.ps_unsupported_flag_error(F)
    assert tps.ps_unsupported_flag_error(F) == want
    assert (want is None) == (flag is None)
    if flag is not None:
        with pytest.raises(ValueError, match="not supported|ps_wire"):
            tps.run_worker(None, F)


@pytest.fixture
def port_flags():
    tflags.define_reference_flags()
    tflags.FLAGS._reset()
    yield tflags.FLAGS
    tflags.FLAGS._reset()


def test_dispatch_refuses_in_every_role_and_a_worker_needs_a_card(
        port_flags, capsys, tmp_path):
    from distributed_tensorflow_tpu_torch import mnist_dist

    hosts = ["--ps_hosts=127.0.0.1:1", "--worker_hosts=127.0.0.1:2"]
    for role in ("ps", "worker"):
        port_flags._reset()
        port_flags._parse([*hosts, f"--job_name={role}", "--augment"])
        assert mnist_dist.main([]) == 2
        assert "--augment is not supported in ps mode" in \
            capsys.readouterr().err
    port_flags._reset()
    port_flags._parse(hosts)
    assert mnist_dist.main([]) == 2
    assert "--job_name must be 'ps' or 'worker'" in capsys.readouterr().err
    # no card here and no --device cpu: the worker raises, it never
    # falls back to the CPU
    port_flags._reset()
    port_flags._parse([*hosts, "--job_name=worker",
                       f"--logdir={tmp_path}"])
    with pytest.raises(RuntimeError, match="is_available"):
        tps.run_worker(ClusterSpec.from_flags(port_flags), port_flags)


def _run_worker_in_process(tmp_path, port_flags, tag, *extra):
    """run_worker against a port ps on a thread; the ps's final params."""
    server = tps.PSServer(0, "127.0.0.1:0")
    server.start_background()
    try:
        port_flags._reset()
        port_flags._parse([
            f"--ps_hosts={server.address}", "--worker_hosts=127.0.0.1:1",
            "--job_name=worker", "--task_index=0", "--training_iter=8",
            "--batch_size=16", "--display_step=4", "--model=mlp",
            "--hidden_units=32", "--device=cpu", "--keep_prob=1",
            f"--logdir={tmp_path}/logs-{tag}",
            f"--data_dir={write_mnist_idx(str(tmp_path / 'mnist'))}",
            "--learning_rate=0.01", "--save_model_secs=100000",
            "--test_eval=false", *extra])
        assert tps.run_worker(ClusterSpec.from_flags(port_flags),
                              port_flags) == 0
        return server.dispatch({"op": "pull"})
    finally:
        server.close()


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_run_worker_mirror_lands_where_the_full_pull_cycle_does(
        tmp_path, port_flags, optimizer, capsys):
    """run_worker's two loops on one worker, same seed and batches: the
    mirror (default) and the serial full-pull cycle leave the ps with the
    same params, bitwise, at the same step; a cadenced 2-step resync
    changes nothing."""
    opt = f"--optimizer={optimizer}"
    mirror = _run_worker_in_process(tmp_path, port_flags, "m", opt)
    full = _run_worker_in_process(tmp_path, port_flags, "f", opt,
                                  "--ps_mirror=false", "--ps_prefetch=false")
    resync = _run_worker_in_process(tmp_path, port_flags, "r", opt,
                                    "--ps_resync_steps=2")
    assert mirror["global_step"] == full["global_step"] == 8
    for k in full["params"]:
        np.testing.assert_array_equal(mirror["params"][k],
                                      full["params"][k], err_msg=k)
        np.testing.assert_array_equal(resync["params"][k],
                                      full["params"][k], err_msg=k)
    out = capsys.readouterr().out
    assert out.count("ps worker summary: ") == 3
    assert "job: worker/0 step:  4 mini_batch loss:  " in out


def test_entry_point_trains_one_ps_two_workers(tmp_path):
    """The reference's launch, one process per task on the CPU: about 20
    global steps, exactly one test eval (the chief's), and the chief's
    final checkpoint restores in the JAX package."""
    from distributed_tensorflow_tpu.checkpoint import checkpoint as jckpt

    data_dir = write_mnist_idx(str(tmp_path / "mnist"))
    logdir = str(tmp_path / "logs")
    ps = f"127.0.0.1:{free_port()}"
    common = ["--ps_hosts", ps, "--worker_hosts",
              "127.0.0.1:1,127.0.0.1:2", "--device", "cpu",
              "--training_iter", "20", "--batch_size", "16",
              "--display_step", "5", "--optimizer", "adam", "--logdir",
              logdir, "--data_dir", data_dir, "--save_model_secs", "1"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.mnist_dist",
         f"--job_name={job}", f"--task_index={i}", *common], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for job, i in (("ps", 0), ("worker", 1), ("worker", 0))]
    outs = {}
    try:
        for name, p in zip(("worker1", "worker0"), procs[1:]):
            outs[name] = p.communicate(timeout=JOIN_S)
            assert p.returncode == 0, outs[name]
        stop = tps.PSClient([ps])
        stop.shutdown_all()
        stop.close()
        outs["ps"] = procs[0].communicate(timeout=60)
        assert procs[0].returncode == 0, outs["ps"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    text = {k: v[0] for k, v in outs.items()}
    assert f"ps/0 serving at {ps}" in text["ps"]
    assert sum(t.count("test accuracy: ") for t in text.values()) == 1
    assert "test accuracy: " in text["worker0"]
    for w in ("worker0", "worker1"):
        assert "Optimization Finished!" in text[w].splitlines()
        assert text[w].count("ps worker summary: ") == 1
    # worker 1 may join after step 0; the chief starts there
    assert "job: worker/0 step:  0 mini_batch loss:  " in text["worker0"]
    path, step = tckpt.latest_checkpoint(logdir)
    assert step >= 20
    template = JaxDeepCNN().init(jax.random.PRNGKey(0))
    got, jstep, _ = jckpt.restore_params_with_fallback(logdir, template)
    assert jstep == step
    saved = tckpt.load_flat(path)
    for k, v in jflat(got).items():
        np.testing.assert_array_equal(np.asarray(v), saved[f"params/{k}"])
