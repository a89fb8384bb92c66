"""Asynchronous parameter-server topology: the reference's own.

The counterpart of ``distributed_tensorflow_tpu/parallel/ps_emulation.py``.
The reference (``MNISTDist.py:94-111,174-188``) places its variables
round-robin on ps tasks (``replica_device_setter``); each worker pulls
the params, computes gradients on its own minibatch and pushes them back,
where ``ApplyGradientDescent`` runs on the ps. Workers never wait for
each other (stale-gradient async SGD), and training ends on a shared
global step.

Here the ps tasks are host processes that hold their shard of the params
in numpy and apply the optimizer there (sgd, and momentum and adam with
their slots on the owning shard), as TF's ps kernels ran on a CPU; a ps
never touches CUDA. Each worker computes its gradients on its card
(``--device``), with ``wd1`` in the hand-written kernel under
``--pallas``. The transport is the JAX package's typed, length-prefixed
TCP frame (a JSON header and raw little-endian tensor bytes, no pickle),
byte for byte, so a ps of either package serves a worker of the other.

Worker 0, the chief, restores the newest checkpoint or initializes, and
pushes the params and the optimizer's name and rate to the ps tasks; the
others wait until every ps reports initialized. Ps task 0 holds the
global step and counts one step per applied push, so ``--training_iter``
bounds the steps of all workers together (``MNISTDist.py:173,188``).
With ``--ps_mirror`` (the default) a worker keeps the params on its card
and replays each push's ps-side update there (``MirrorCycle``) instead
of pulling the full set every cycle.
"""

from __future__ import annotations

import concurrent.futures
import errno
import json
import socket
import socketserver
import struct
import sys
import threading
import time
import uuid

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.checkpoint import (
    Checkpointer,
    background_save_from_flags,
    max_to_keep_from_flags,
)
from distributed_tensorflow_tpu_torch.training.train_state import (
    _OPTIMIZERS,
    compute_grads,
    evaluate,
    make_eval_step,
    params_of,
)
from distributed_tensorflow_tpu_torch.utils.metrics import MetricsLogger
from distributed_tensorflow_tpu_torch.utils.pytree import (
    _bf16_bits_to_f32,
    _leaves_with_path,
    flatten_pytree,
    params_to_numpy,
    path_key,
    tree_leaves,
    unflatten_pytree,
)
from distributed_tensorflow_tpu_torch.utils.telemetry import StepTimer

_LEN = struct.Struct(">Q")

# ---------------------------------------------------------------- protocol
#
# frame := u64 header_len | header_json | concatenated array bytes
#
# The header carries every JSON-safe field of the message dict plus, under
# "_arrays", the layout {field: {key: [dtype, shape]}} of each dict-of-
# ndarray field; array payloads follow in header order as raw C-order
# little-endian bytes. Deserialization allocates from the declared dtypes
# and shapes only: there is no object deserialization of any kind.

_MAX_FRAME = 1 << 33  # 8 GiB sanity bound per message


def _encode_msg(obj: dict) -> bytes:
    meta: dict = {}
    arrays: dict[str, dict[str, np.ndarray]] = {}
    layout: dict[str, dict[str, list]] = {}
    for field, value in obj.items():
        if isinstance(value, dict) and all(
            isinstance(v, np.ndarray) for v in value.values()
        ):
            # asarray, not ascontiguousarray: the latter promotes 0-d to 1-d
            # and would drop scalar shapes on the wire; tobytes() already
            # serializes any layout as C-order
            arrs = {k: np.asarray(v) for k, v in value.items()}
            arrays[field] = arrs
            layout[field] = {
                k: [a.dtype.str, list(a.shape)] for k, a in arrs.items()
            }
        else:
            meta[field] = value  # must be JSON-serializable by construction
    header = json.dumps({"meta": meta, "_arrays": layout}).encode()
    parts = [_LEN.pack(len(header)), header]
    for field in layout:
        for k in layout[field]:
            parts.append(arrays[field][k].tobytes())
    return b"".join(parts)


def _send_msg(sock: socket.socket, obj: dict) -> None:
    sock.sendall(_encode_msg(obj))


def _recv_msg(sock: socket.socket) -> dict:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > _MAX_FRAME:
        raise ConnectionError(f"oversized header ({n} bytes)")
    header = json.loads(_recv_exact(sock, n))
    msg = dict(header["meta"])
    for field, entries in header["_arrays"].items():
        out = {}
        for k, (dtype_str, shape) in entries.items():
            dt = np.dtype(dtype_str)
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            nbytes = dt.itemsize * count
            if nbytes > _MAX_FRAME:
                raise ConnectionError(f"oversized tensor {field}.{k}")
            # a fresh bytearray per tensor: the array owns it, writable
            buf = _recv_exact(sock, nbytes)
            out[k] = np.frombuffer(buf, dtype=dt).reshape(shape)
        msg[field] = out
    return msg


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Exactly ``n`` bytes, received into one buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed mid-message")
        got += k
    return buf


# bf16 on the wire travels as its uint16 bit pattern (numpy has no
# bfloat16), the convention of the checkpoint's bf16 tag


def _bf16_encode(a: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits (uint16): rounded to nearest even, an
    infinity kept, a NaN made the quiet NaN of its sign — the bits
    ``ml_dtypes`` gives, which the JAX package's wire uses."""
    a = np.asarray(a, dtype=np.float32)
    bits = a.view(np.uint32)
    out = ((bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1)))
           >> 16).astype(np.uint16)
    nan = np.isnan(a)
    if nan.any():
        quiet = np.where(bits >> 31, np.uint16(0xFFC0), np.uint16(0x7FC0))
        out = np.where(nan, quiet, out).astype(np.uint16)
    return out


def _bf16_decode(a: np.ndarray) -> np.ndarray:
    """bfloat16 bits (uint16) -> the float32 values they encode (exact)."""
    return _bf16_bits_to_f32(np.asarray(a))


def _maybe_bf16_bits(a: np.ndarray) -> np.ndarray:
    """An array for the bf16 wire: uint16 is already bf16 bits (grads
    narrowed on the card), anything else is encoded here."""
    a = np.asarray(a)
    return a if a.dtype == np.uint16 else _bf16_encode(a)


# ---------------------------------------------------------------- sharding


def assign_shards(keys: list[str], num_ps: int) -> dict[str, int]:
    """Round-robin leaves over ps tasks in sorted-key order — the
    replica_device_setter placement policy (MNISTDist.py:110-111)."""
    return {k: i % num_ps for i, k in enumerate(sorted(keys))}


# ---------------------------------------------------------------- server

class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        ps: PSServer = self.server.ps  # type: ignore[attr-defined]
        try:
            while True:
                msg = _recv_msg(self.request)
                resp = ps.dispatch(msg)
                op = msg.get("op")
                if op in ps.drop_reply_once:
                    # fault injection for tests: the op applied but its
                    # reply is lost; the client's resend must not apply
                    # twice
                    ps.drop_reply_once.discard(op)
                    self.request.close()
                    return
                _send_msg(self.request, resp)
        except (ConnectionError, EOFError):
            pass


class _ThreadedTCP(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class _PsOptimizer:
    """The optimizer applied on the owning ps shard, in numpy float32:
    the reference's ps-side ApplyGradientDescent (MNISTDist.py:149) and
    momentum and adam with their slots beside the shard. The same
    arithmetic, operation for operation, as the JAX package's, so the two
    are bitwise equal; ``MirrorCycle`` replays it on the card."""

    # advertise what both the training registry and this apply implement:
    # an optimizer in one but not the other is refused at init_shard
    _APPLY = ("sgd", "momentum", "adam")
    NAMES = tuple(sorted(set(_OPTIMIZERS) & set(_APPLY)))

    def __init__(self, name: str, lr: float):
        if name not in self.NAMES:
            raise ValueError(f"unknown optimizer {name!r}")
        self.name = name
        self.lr = float(lr)
        self._slots: dict[str, dict[str, np.ndarray]] = {}
        self._t: dict[str, int] = {}
        # two temporaries per key, reused: a fresh 13 MB array per
        # operation costs its page faults on every push
        self._scratch: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    def apply(self, key: str, param: np.ndarray, grad: np.ndarray) -> None:
        """``param`` updated in place by ``grad``: the JAX package's
        arithmetic (``param -= lr * g``; ``v = 0.9 v + g``; adam's
        ``m = 0.9 m + 0.1 g``, ``v = 0.999 v + (0.001 g) g``, ``param -=
        scale m / (sqrt(v) + 1e-8)``), each operation one float32
        rounding, written into scratch buffers."""
        g = np.asarray(grad, dtype=np.float32)
        t1, t2 = self._scratch.get(key) or self._scratch.setdefault(
            key, (np.empty_like(param), np.empty_like(param)))
        if self.name == "sgd":
            param -= np.multiply(g, self.lr, out=t1)
        elif self.name == "momentum":
            slots = self._slots.setdefault(key, {})
            v = slots.setdefault("v", np.zeros_like(param))
            v *= 0.9
            v += g
            param -= np.multiply(v, self.lr, out=t1)
        elif self.name == "adam":
            slots = self._slots.setdefault(key, {})
            m = slots.setdefault("m", np.zeros_like(param))
            v = slots.setdefault("v", np.zeros_like(param))
            t = self._t.get(key, 0) + 1
            self._t[key] = t
            m *= 0.9
            m += np.multiply(g, 0.1, out=t1)
            v *= 0.999
            np.multiply(g, 0.001, out=t1)
            v += np.multiply(t1, g, out=t1)
            np.sqrt(v, out=t1)
            t1 += 1e-8
            np.multiply(m, adam_scale(self.lr, t), out=t2)
            param -= np.divide(t2, t1, out=t2)
        else:  # unreachable through __init__'s NAMES gate
            raise ValueError(f"_PsOptimizer cannot apply {self.name!r}")


def adam_scale(lr: float, t: int) -> np.float32:
    """Adam's bias-corrected rate at apply count ``t``, in float32 end to
    end: ``lr * sqrt(1 - 0.999**t) / (1 - 0.9**t)``."""
    one = np.float32(1.0)
    tf_ = np.float32(t)
    return (np.float32(lr) * np.sqrt(one - np.float32(0.999) ** tf_)
            / (one - np.float32(0.9) ** tf_))


class PSServer:
    """One parameter-server task: owns a shard of the param leaves and
    (task 0 only) the shared global step, and applies the configured
    optimizer on each push."""

    def __init__(self, task_index: int, bind_address: str):
        self.task_index = task_index
        host, port = bind_address.rsplit(":", 1)
        self._lock = threading.Lock()
        self._applied_seq: dict[str, int] = {}  # push dedup per worker (LRU)
        self.dedup_cap = 1024  # raised by init_shard's num_workers
        self._evictions = 0
        self.drop_reply_once: set[str] = set()  # test fault injection
        self.params: dict[str, np.ndarray] = {}
        self.optimizer: _PsOptimizer | None = None
        self.initialized = False
        self.global_step = 0  # authoritative only on task 0
        self._shutdown = threading.Event()
        try:
            self._server = _ThreadedTCP((host, int(port)), _Handler)
        except OSError as e:
            if e.errno not in (errno.EADDRNOTAVAIL,):
                raise  # EADDRINUSE/EACCES etc. are real config errors
            # the advertised name is not locally assignable (NAT, bridge,
            # load balancer): serve on all interfaces at the advertised
            # port, as the reference's gRPC server does
            print(f"ps/{task_index}: {host} not locally assignable; "
                  f"binding 0.0.0.0:{port}")
            self._server = _ThreadedTCP(("0.0.0.0", int(port)), _Handler)
        self._server.ps = self  # type: ignore[attr-defined]

    @property
    def address(self) -> str:
        h, p = self._server.server_address[:2]
        return f"{h}:{p}"

    def dispatch(self, msg: dict):
        op = msg.get("op")
        with self._lock:
            if op == "ping":
                # carries readiness, so clients poll initialization
                # without transferring the shard
                return {"ok": True, "task": self.task_index,
                        "initialized": self.initialized}
            if op == "init_shard":
                try:
                    self.optimizer = _PsOptimizer(
                        msg.get("optimizer", "sgd"),
                        msg.get("learning_rate", 0.001),
                    )
                except ValueError as e:
                    return {"ok": False, "error": str(e)}
                self.params = {k: np.array(v, dtype=np.float32)
                               for k, v in msg["params"].items()}
                # the dedup capacity scales with the declared cluster, so
                # a live worker's entry is never evicted
                n_workers = msg.get("num_workers")
                if n_workers:
                    self.dedup_cap = max(self.dedup_cap, 4 * int(n_workers))
                self.initialized = True
                return {"ok": True}
            if op == "pull":
                if not self.initialized:
                    return {"ok": False, "uninitialized": True}
                # snapshot under the lock: the reply is serialized after
                # it is released, while pushes mutate these arrays
                if msg.get("encoding") == "bf16":
                    params = {k: _bf16_encode(v) for k, v in self.params.items()}
                else:
                    params = {k: v.copy() for k, v in self.params.items()}
                out = {"ok": True, "params": params,
                       "global_step": self.global_step}
                if msg.get("with_slots"):
                    # the optimizer's slots and per-key apply counts, for
                    # the mirror's momentum/adam replay: always f32 (the
                    # state the trajectory rides on), as flat
                    # "param::slot" keys (the frame holds flat dicts)
                    out["slots"] = {
                        f"{k}::{n}": a.copy()
                        for k, s in self.optimizer._slots.items()
                        for n, a in s.items()}
                    out["t"] = dict(self.optimizer._t)
                return out
            if op == "push_grads":
                if not self.initialized:
                    return {"ok": False, "uninitialized": True}
                # the per-worker sequence makes the push idempotent: a
                # client that lost the reply resends, and the duplicate
                # applies nothing. Keyed by the client's per-incarnation
                # id, so a restarted worker is never a duplicate.
                worker, seq = msg.get("worker"), msg.get("seq")
                if worker is not None and seq is not None:
                    if seq <= self._applied_seq.get(worker, -1):
                        # a dedup hit proves the worker alive: refresh its
                        # recency (guarded: a negative seq matches the -1
                        # default of a worker with no entry)
                        if worker in self._applied_seq:
                            self._applied_seq[worker] = (
                                self._applied_seq.pop(worker))
                        return {"ok": True, "global_step": self.global_step,
                                "duplicate": True}
                    # bound the table, evicting the least recently used
                    # incarnation (applies and dedup hits refresh it)
                    if (worker not in self._applied_seq
                            and len(self._applied_seq) >= self.dedup_cap):
                        victim = next(iter(self._applied_seq))
                        self._applied_seq.pop(victim)
                        # the first eviction and every 100th after: this
                        # runs under the server lock
                        self._evictions += 1
                        if self._evictions == 1 or self._evictions % 100 == 0:
                            print(f"ps/{self.task_index}: dedup table at "
                                  f"cap {self.dedup_cap}; evicted idle "
                                  f"incarnation {victim!r} "
                                  f"({self._evictions} evictions total)")
                grads = msg["grads"]
                if msg.get("encoding") == "bf16":
                    grads = {k: _bf16_decode(g) for k, g in grads.items()}
                for k, g in grads.items():
                    if k in self.params:
                        self.optimizer.apply(k, self.params[k], g)
                if msg.get("count_step", False):
                    self.global_step += 1
                if worker is not None and seq is not None:
                    # recorded only after the apply succeeded, so a failed
                    # apply's retry applies; pop first to refresh the LRU
                    self._applied_seq.pop(worker, None)
                    self._applied_seq[worker] = seq
                return {"ok": True, "global_step": self.global_step}
            if op == "get_step":
                return {"ok": True, "global_step": self.global_step}
            if op == "set_step":
                self.global_step = int(msg["global_step"])
                return {"ok": True}
            if op == "shutdown":
                self._shutdown.set()
                return {"ok": True}
            return {"ok": False, "error": f"unknown op {op!r}"}

    def serve_forever(self):
        """server.join() parity (MNISTDist.py:105-106): block until a
        shutdown message arrives (or the process is killed)."""
        self.start_background()
        self._shutdown.wait()
        self._server.shutdown()

    def start_background(self) -> threading.Thread:
        """Serve on a daemon thread."""
        self._serving = True
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return t

    def close(self):
        self._shutdown.set()
        # socketserver.shutdown() waits on an event only serve_forever
        # sets: only shut down a loop that is serving
        if getattr(self, "_serving", False):
            self._server.shutdown()
        self._server.server_close()


# ---------------------------------------------------------------- client

class PSClient:
    """A worker's connections to every ps task.

    Each ps task gets its own socket and lock per channel (pulls and
    control ops on one, pushes on the other), multi-ps pulls and pushes
    fan out on a thread pool, and ``pull_all_async`` runs a whole pull on
    a prefetch thread so the next cycle's pull overlaps the card's work.
    Those threads touch sockets and numpy only.

    ``wire='bf16'`` halves every tensor in flight: pulls arrive as bf16
    bits (uint16) and grad pushes leave as bf16 bits. The ps keeps its
    params in f32.
    """

    def __init__(self, addresses: list[str], connect_timeout: float = 60.0,
                 wire: str = "f32"):
        if wire not in ("f32", "bf16"):
            raise ValueError(f"wire must be 'f32' or 'bf16', got {wire!r}")
        self.addresses = addresses
        self.wire = wire
        self._socks: dict[tuple[int, str], socket.socket] = {}
        self._locks: dict[tuple[int, str], threading.Lock] = {}
        self._maps_lock = threading.Lock()
        self._timeout = connect_timeout
        # per-incarnation identity and a monotone sequence make pushes
        # idempotent on the ps (the dedup in PSServer.dispatch)
        self._client_id = uuid.uuid4().hex
        self._push_seq = 0
        self._fanout = (
            concurrent.futures.ThreadPoolExecutor(
                # 2x: a prefetched pull's N tasks must not take every
                # worker while the training thread's push fans out
                max_workers=2 * len(addresses),
                thread_name_prefix="ps-client-fanout")
            if len(addresses) > 1 else None)
        # a separate single slot for whole-pull prefetch: an aggregate
        # running inside the fan-out pool could exhaust its own workers
        self._prefetch = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ps-client-prefetch")

    def _chan_lock(self, key: tuple[int, str]) -> threading.Lock:
        with self._maps_lock:
            lock = self._locks.get(key)
            if lock is None:
                lock = self._locks[key] = threading.Lock()
            return lock

    def _sock(self, key: tuple[int, str]) -> socket.socket:
        # the caller holds the channel lock
        if self._socks.get(key) is None:
            i = key[0]
            host, port = self.addresses[i].rsplit(":", 1)
            deadline = time.time() + self._timeout
            while True:
                try:
                    s = socket.create_connection((host, int(port)), timeout=10)
                    s.settimeout(None)
                    self._socks[key] = s
                    break
                except OSError:
                    if time.time() > deadline:
                        raise ConnectionError(
                            f"cannot reach ps task {i} at {self.addresses[i]}"
                        ) from None
                    time.sleep(0.2)
        return self._socks[key]

    # ops safe to resend after a broken connection: reads, a ping, writes
    # whose repeat converges (init_shard, set_step) and push_grads, whose
    # resend the ps recognizes by its (worker, seq)
    _RETRY_OPS = frozenset(
        {"ping", "pull", "get_step", "set_step", "init_shard", "shutdown",
         "push_grads"})

    def call(self, i: int, msg: dict, attempts: int = 3) -> dict:
        """One request and reply to ps task ``i``. A transport failure is
        retried on a fresh connection for the ops safe to resend. Calls to
        different ps tasks proceed in parallel; calls on one channel
        serialize."""
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        key = (i, "push" if msg.get("op") == "push_grads" else "pull")
        for attempt in range(attempts):
            # the lock brackets one attempt: the backoff sleep must not
            # stall the other threads queued on this channel
            with self._chan_lock(key):
                # connecting is outside the retry: _sock has its own
                # deadline, and a failed connect sent nothing
                sock = self._sock(key)
                try:
                    _send_msg(sock, msg)
                    return _recv_msg(sock)
                except OSError:
                    self._drop(key)
                    if (msg.get("op") not in self._RETRY_OPS
                            or attempt == attempts - 1):
                        raise
            time.sleep(0.2 * (attempt + 1))

    def _map_tasks(self, fn):
        """``fn(i)`` for every ps task, concurrently when there are
        several."""
        idxs = range(len(self.addresses))
        if self._fanout is None:
            return [fn(i) for i in idxs]
        return list(self._fanout.map(fn, idxs))

    def _drop(self, key: tuple[int, str]):
        """Forget a broken connection so the next call reconnects."""
        s = self._socks.pop(key, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def debug_break_connections(self, i: int):
        """Testing hook: close every channel to ps task ``i`` in place, so
        the next call's send fails and takes the reconnect path."""
        with self._maps_lock:
            targets = [s for key, s in self._socks.items()
                       if key[0] == i and s is not None]
        for s in targets:
            try:
                s.close()
            except OSError:
                pass

    def wait_ready(self):
        for i in range(len(self.addresses)):
            self.call(i, {"op": "ping"})

    def init_params(self, flat: dict[str, np.ndarray], assignment: dict[str, int],
                    optimizer: str = "sgd", learning_rate: float = 0.001,
                    num_workers: int | None = None):
        for i in range(len(self.addresses)):
            shard = {k: v for k, v in flat.items() if assignment[k] == i}
            r = self.call(i, {"op": "init_shard", "params": shard,
                              "optimizer": optimizer,
                              "learning_rate": learning_rate,
                              "num_workers": num_workers})
            if not r.get("ok"):
                raise ValueError(f"ps {i} rejected init: {r.get('error')}")

    def wait_initialized(self, poll_s: float = 0.3):
        """Non-chief behavior: wait for the chief's init (MNISTDist.py:170)
        on every ps task, by the ping's readiness flag."""
        for i in range(len(self.addresses)):
            while not self.call(i, {"op": "ping"}).get("initialized"):
                time.sleep(poll_s)

    def pull_all(self, with_slots: bool = False):
        """One full parameter pull, all ps tasks in parallel: ``(flat,
        step)``. On the bf16 wire the arrays are bf16 bits (uint16).

        ``with_slots`` also returns the ps-side optimizer slots (always
        f32, flat ``"param::slot"`` keys) and per-key apply counts, as
        ``(flat, step, slots, t)``, for the mirror's momentum/adam
        resync."""
        msg = {"op": "pull"}
        if self.wire == "bf16":
            msg["encoding"] = "bf16"
        if with_slots:
            msg["with_slots"] = True
        rs = self._map_tasks(lambda i: (i, self.call(i, dict(msg))))
        flat: dict[str, np.ndarray] = {}
        slots: dict[str, np.ndarray] = {}
        t: dict[str, int] = {}
        step = 0
        for i, r in rs:
            if not r.get("ok"):
                raise RuntimeError(f"ps {i} not initialized")
            flat.update(r["params"])
            if with_slots:
                slots.update(r.get("slots", {}))
                t.update(r.get("t", {}))
            if i == 0:
                step = r["global_step"]
        if with_slots:
            return flat, step, slots, t
        return flat, step

    def pull_all_async(self):
        """Start a full pull on the prefetch thread and return its Future:
        the next cycle's pull in flight while the card computes."""
        return self._prefetch.submit(self.pull_all)

    def push_grads(self, flat_grads: dict[str, np.ndarray],
                   assignment: dict[str, int]) -> int:
        """Push each grad to its owning ps (which applies its optimizer),
        all ps tasks in parallel; ps 0 counts the global step and its
        reply's step is returned. Tagged (worker, seq), so a resend after
        a broken connection is deduped on the ps."""
        seq = self._push_seq
        self._push_seq += 1

        def push_one(i: int):
            shard = {k: v for k, v in flat_grads.items() if assignment[k] == i}
            msg = {"op": "push_grads", "grads": shard, "count_step": i == 0,
                   "worker": self._client_id, "seq": seq}
            if self.wire == "bf16":
                msg["encoding"] = "bf16"
                msg["grads"] = {k: _maybe_bf16_bits(v) for k, v in shard.items()}
            return i, self.call(i, msg)

        step = -1
        for i, r in self._map_tasks(push_one):
            if i == 0:
                step = r["global_step"]
        return step

    def get_step(self) -> int:
        return self.call(0, {"op": "get_step"})["global_step"]

    def shutdown_all(self):
        for i in range(len(self.addresses)):
            try:
                self.call(i, {"op": "shutdown"})
            except (ConnectionError, OSError):
                pass

    def close(self):
        self._prefetch.shutdown(wait=True)
        if self._fanout is not None:
            self._fanout.shutdown(wait=True)
        for s in self._socks.values():
            try:
                s.close()
            except OSError:
                pass
        self._socks = {}


# ---------------------------------------------------------------- roles

def run_parameter_server(cluster, FLAGS):
    """The ps role: bind the advertised address (not 0.0.0.0), serve
    params until a shutdown message (MNISTDist.py:105-106)."""
    addr = cluster.task_address("ps", FLAGS.task_index)
    server = PSServer(FLAGS.task_index, addr)
    print(f"ps/{FLAGS.task_index} serving at {addr}", flush=True)
    server.serve_forever()


# ---------------------------------------------------------------- compute

def _leaf_keys(params) -> list[str]:
    """The wire keys of a param tree, in its leaf order."""
    return [path_key(p) for p, _ in _leaves_with_path(params)]


@torch.no_grad()
def upload_params(leaves: list, keys: list[str],
                  flat: dict[str, np.ndarray]) -> None:
    """Copy pulled arrays into the parameter tensors ``leaves`` (wire keys
    ``keys``) where they live. bf16 bits cross to the card at half width
    and are widened there."""
    for p, k in zip(leaves, keys):
        a = flat[k]
        if not a.flags.writeable:  # torch.from_numpy wants a writable one
            a = a.copy()
        if a.dtype == np.uint16:
            t = torch.from_numpy(a.view(np.int16)).to(p.device).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(a).to(p.device)
        p.copy_(t.reshape(p.shape))


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy, without a copy; bf16 as its bits (uint16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def grads_to_host(grads: list[torch.Tensor]) -> list[np.ndarray]:
    """Each gradient as a host array; bf16 as its bits (uint16)."""
    return [_host_array(g.detach().cpu()) for g in grads]


def make_grad_fn(model, keep_prob: float, wire: str = "f32"):
    """``(batch, generator) -> (grads, metrics)``: the gradients of the
    loss at ``model``'s current parameters, on the device that holds
    them, in the parameter tree's leaf order; dropout draws from
    ``generator`` (None with ``keep_prob`` 1). ``wire='bf16'`` narrows
    the gradients to bf16 on the device before they leave it, half the
    download. Stateless models only."""
    if getattr(model, "stateful", False):
        raise NotImplementedError(
            "ps-emulation mode supports stateless models (the reference's "
            "deep CNN); stateful models (batch-norm ResNets) use sync mode"
        )
    params = params_of(model)

    def grad_fn(batch, generator=None):
        grads, metrics, _ = compute_grads(
            model, params, batch, keep_prob=keep_prob,
            rng=generator if keep_prob < 1 else None, model_state=())
        grads = tree_leaves(grads)
        if wire == "bf16":
            grads = [g.to(torch.bfloat16) for g in grads]
        return grads, metrics

    return grad_fn


def ps_unsupported_flag_error(FLAGS) -> str | None:
    """The first flag the ps topology refuses, as its message, or None.

    ``run_worker`` raises it and the ``mnist_dist`` dispatch prints it
    and exits 2 in every role, so no ps is left serving for workers that
    died at startup. The ps applies the fixed rate pushed at init
    (ApplyGradientDescent with a constant lr, MNISTDist.py:149); these
    features would otherwise silently not happen."""
    if (getattr(FLAGS, "lr_schedule", "constant") != "constant"
            or getattr(FLAGS, "warmup_steps", 0) > 0):
        return ("--lr_schedule/--warmup_steps are not supported in ps mode; "
                "the parameter server applies a fixed learning rate. Use "
                "sync/local mode for scheduled learning rates.")
    if getattr(FLAGS, "accum_steps", 1) > 1:
        return ("--accum_steps is not supported in ps mode (the reference's "
                "cycle pushes one batch's gradients per pull); use "
                "sync/local mode")
    if getattr(FLAGS, "weight_decay", 0.0) > 0:
        return ("--weight_decay is not supported in ps mode (the ps-side "
                "optimizer applies plain sgd/momentum/adam); use sync/local "
                "mode")
    if getattr(FLAGS, "augment", False):
        return ("--augment is not supported in ps mode (augmentation is "
                "compiled into the sync/local train step); use sync/local "
                "mode")
    if getattr(FLAGS, "eval_step", 0) > 0:
        return ("--eval_step is not supported in ps mode (workers display "
                "on the pulled snapshot via --display_step; full test evals "
                "run at exit with --test_eval); use sync/local mode")
    if getattr(FLAGS, "ps_wire", "f32") not in ("f32", "bf16"):
        return (f"--ps_wire must be 'f32' or 'bf16', got "
                f"{getattr(FLAGS, 'ps_wire')!r}")
    if getattr(FLAGS, "seq_parallel", False):
        return ("--seq_parallel is not supported in ps mode (sequence "
                "parallelism needs the sync mesh); use --mode=sync")
    return None


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt correctly rounded, as numpy's: torch's float32 sqrt on
    the CPU is not (it differs in the last bit for about 0.7% of inputs).
    A float64 sqrt rounded to float32 is, since 53 >= 2 * 24 + 2 makes
    the double rounding innocuous."""
    return x.double().sqrt_().float()


# the kinds of a worker cycle's time, the StepTimer keys of both loops
PS_TIMER_KEYS = ("pull", "upload", "grad", "download", "push")


class MirrorCycle:
    """The device-mirror cycle (``--ps_mirror``).

    The worker's params (and, for momentum and adam, the optimizer slots)
    stay on its card. Each cycle computes the gradients there, replays
    the ps-side update on the card, in place, with the ps's own float32
    arithmetic (adam's bias-corrected rate is computed on the host as the
    ps computes it), and pushes the gradients, so no cycle pulls or
    re-uploads the parameter set. Slot-carrying optimizers adopt the ps's
    slots at every resync.

    Pipeline: the gradients of cycle K are copied to pinned host buffers
    on a side stream behind an event, and pushed in cycle K+1, while the
    card computes K+1; the host waits only for that copy. Trajectory-
    exact for one worker: cycle K's gradients are computed on the same
    params either way, and the ps receives the same pushes one cycle
    later.

    ``step`` is the shared global step (the ps's, trailing the card by
    the pipeline); ``mirror_step`` counts the card's applies and labels
    the params in a checkpoint. The mirror resyncs from the ps every
    ``resync_steps`` and at once when a push's reply skips a step —
    another worker's push, which the mirror cannot replay — so several
    workers degrade to a pull per desynced cycle, the reference's
    staleness model."""

    SLOT_NAMES = {"sgd": (), "momentum": ("v",), "adam": ("m", "v")}

    def __init__(self, client, model, grad_fn, assignment,
                 learning_rate: float, resync_steps: int = 50,
                 training_iter: int | None = None, start_step: int = 0,
                 optimizer: str = "sgd", timer: StepTimer | None = None):
        if optimizer not in self.SLOT_NAMES:
            raise ValueError(f"--ps_mirror cannot replay {optimizer!r}; "
                             f"supported: {sorted(self.SLOT_NAMES)}")
        self._client = client
        self._grad_fn = grad_fn
        params = params_of(model)
        self.params = params
        self._leaves = tree_leaves(params)
        self._keys = _leaf_keys(params)
        self._assignment = assignment
        self._resync_steps = max(1, int(resync_steps))
        self._training_iter = training_iter
        self._opt_name = optimizer
        self._lr = float(learning_rate)
        self._slots = {n: [torch.zeros_like(p) for p in self._leaves]
                       for n in self.SLOT_NAMES[optimizer]}
        self._t = [0] * len(self._leaves)  # adam's per-leaf apply counts
        self._timer = timer or StepTimer(PS_TIMER_KEYS)
        device = self._leaves[0].device
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)
        self._host: list[list | None] = [None, None]  # two pinned sets
        self._flip = 0
        self._pending = None  # cycle K-1's staged gradients
        self.step = start_step
        self.mirror_step = start_step
        self._last_sync = start_step
        self.needs_resync = True

    def _exhausted(self) -> bool:
        return (self._training_iter is not None
                and self.step >= self._training_iter)

    def maybe_sync(self) -> bool:
        """Resync the mirror from the ps when desynced or the cadence
        elapsed; False once the shared step reached the budget (a
        trailing gradient then is dropped, as the reference's workers
        stop at the boundary, MNISTDist.py:173)."""
        if self.needs_resync or self.step - self._last_sync >= self._resync_steps:
            self.drain()
            if self._exhausted():
                return False
            t0 = time.perf_counter()
            names = self.SLOT_NAMES[self._opt_name]
            if names:
                flat, pull_step, slots_flat, t_flat = (
                    self._client.pull_all(with_slots=True))
            else:
                flat, pull_step = self._client.pull_all()
            t1 = time.perf_counter()
            upload_params(self._leaves, self._keys, flat)
            for n in names:
                # a key with no ps-side slot yet starts at zeros
                upload_params(self._slots[n], self._keys, {
                    k: slots_flat.get(f"{k}::{n}", np.zeros(p.shape,
                                                            np.float32))
                    for k, p in zip(self._keys, self._leaves)})
            if names:
                self._t = [int(t_flat.get(k, 0)) for k in self._keys]
            self._timer.add("pull", t1 - t0)
            self._timer.add("upload", time.perf_counter() - t1)
            self.step = self.mirror_step = self._last_sync = pull_step
            self.needs_resync = False
        return not self._exhausted()

    @torch.no_grad()
    def _apply(self, grads: list[torch.Tensor]) -> None:
        """``_PsOptimizer.apply`` on the card, in place: the same float32
        operations in the same order, one rounding each."""
        lr = self._lr
        for i, (p, g) in enumerate(zip(self._leaves, grads)):
            g = g.float()
            if self._opt_name == "sgd":
                p.sub_(g * lr)
            elif self._opt_name == "momentum":
                v = self._slots["v"][i]
                v.mul_(0.9)
                v.add_(g)
                p.sub_(v * lr)
            else:
                m, v = self._slots["m"][i], self._slots["v"][i]
                self._t[i] += 1
                m.mul_(0.9)
                m.add_(g * 0.1)
                v.mul_(0.999)
                v.add_(g * 0.001 * g)
                upd = m * float(adam_scale(lr, self._t[i]))
                p.sub_(upd.div_(_sqrt_rn(v).add_(1e-8)))

    def _stage(self, grads: list[torch.Tensor]):
        """Start cycle K's download: on a card, a copy into one of two
        pinned host sets on the side stream, after the gradients are
        ready, with an event behind it; the device tensors are kept until
        the copy is waited for, so their memory is not reused under it."""
        if self._stream is None:
            return grads_to_host(grads), None, None
        bufs = self._host[self._flip]
        if bufs is None:
            bufs = self._host[self._flip] = [
                torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                for g in grads]
        self._flip ^= 1
        ready = torch.cuda.Event()
        ready.record()
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            for b, g in zip(bufs, grads):
                b.copy_(g, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return bufs, done, grads

    def _push(self, staged) -> int:
        host, done, _ = staged
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
            host = [_host_array(b) for b in host]
        t1 = time.perf_counter()
        step = self._client.push_grads(dict(zip(self._keys, host)),
                                       self._assignment)
        self._timer.add("download", t1 - t0)
        self._timer.add("push", time.perf_counter() - t1)
        return step

    def run_cycle(self, batch, generator=None):
        """One pipelined cycle: compute this cycle's gradients at the
        mirror's params, stage their download, advance the mirror on the
        card, then push the previous cycle's gradients. Returns the
        device metrics of this cycle's step."""
        t0 = time.perf_counter()
        grads, metrics = self._grad_fn(batch, generator)
        staged = self._stage(grads)
        # optimistic advance: a desync discards it through the resync,
        # and the pushed grads are then stale, the reference's async
        # semantics
        self._apply(grads)
        self.mirror_step += 1
        self._timer.add("grad", time.perf_counter() - t0)
        if self._pending is not None:
            new_step = self._push(self._pending)
            self.needs_resync = new_step != self.step + 1
            self.step = new_step
        self._pending = staged
        return metrics

    def drain(self):
        """Push the trailing gradient, if the budget still allows it."""
        if self._pending is not None:
            staged, self._pending = self._pending, None
            if not self._exhausted():
                self.step = self._push(staged)
            elif staged[1] is not None:
                staged[1].synchronize()  # the copy ends before its source goes


class _WorkerRun:
    """What a worker's loop counts: cycles and display evals (each a
    forward pass), and over the window after the warm-up (the first
    cycle, then ``--profile_steps`` profiled cycles with
    ``--profile_dir``) the time split, wall time and global steps. The
    profiled window gives the device's busy share."""

    def __init__(self, timer: StepTimer, device, profile_dir: str = "",
                 profile_steps: int = 0):
        self.timer = timer
        self.device = device
        self.profile_dir = profile_dir
        self.warm = 1 + (profile_steps if profile_dir else 0)
        self.cycles = 0
        self.displays = 0
        self.busy_share = None
        self._profiler = None
        self._t0 = None
        self._step0 = 0
        self.seconds = 0.0
        self.steps = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def cycle_done(self, step: int) -> None:
        from distributed_tensorflow_tpu_torch.training.loop import (
            _start_profiler,
            _stop_profiler,
        )

        self.cycles += 1
        if self.cycles > self.warm:
            self.timer.steps()
            return
        if self.cycles == 1 and self.profile_dir:
            self._profiler = _start_profiler(self.device)
        if self.cycles == self.warm:
            if self._profiler is not None:
                self.busy_share = _stop_profiler(self._profiler, self.device,
                                                 self.profile_dir)
                self._profiler = None
            self._sync()
            self.timer.reset()
            self._t0, self._step0 = time.perf_counter(), step

    def finish(self, step: int) -> None:
        if self._profiler is not None:  # the run ended inside the window
            self._profiler.stop()
            self._profiler = None
        if self._t0 is not None:
            self._sync()
            self.seconds = time.perf_counter() - self._t0
            self.steps = step - self._step0


def _to_device(batch, device):
    return tuple(torch.from_numpy(a).to(device) for a in batch)


def _mirror_train_loop(client, FLAGS, train_data, model, grad_fn, eval_fn,
                       assignment, ckpt, logger, generator, step: int,
                       device, run: _WorkerRun) -> int:
    """--ps_mirror: drive MirrorCycle with the reference loop's display,
    checkpoint and termination semantics."""
    cyc = MirrorCycle(
        client, model, grad_fn, assignment,
        learning_rate=FLAGS.learning_rate,
        resync_steps=FLAGS.ps_resync_steps,
        training_iter=FLAGS.training_iter, start_step=step,
        optimizer=FLAGS.optimizer, timer=run.timer)
    while cyc.maybe_sync():
        t0 = time.perf_counter()
        batch = _to_device(train_data.next_batch(FLAGS.batch_size), device)
        run.timer.add("upload", time.perf_counter() - t0)
        if cyc.mirror_step % FLAGS.display_step == 0:
            m = eval_fn(batch)
            run.displays += 1
            logger.log_display(cyc.mirror_step, float(m["loss"]),
                               float(m["accuracy"]))
        cyc.run_cycle(batch, generator)
        run.cycle_done(cyc.step)
        # cadence-gated: the host fetch happens only when a save is due;
        # mirror_step is the step the card's params are at
        ckpt.maybe_save({"params": cyc.params, "step": cyc.mirror_step},
                        cyc.mirror_step)
    return cyc.step


def _full_pull_train_loop(client, FLAGS, train_data, model, grad_fn,
                          eval_fn, assignment, ckpt, logger, generator,
                          step: int, device, run: _WorkerRun) -> int:
    """--ps_mirror=false: each cycle consumes a pull, uploads it, computes
    the gradients and pushes them. With --ps_prefetch one pull is always
    in flight: the next one starts as soon as this cycle's gradients are
    dispatched, so it overlaps the card and the push (the pulled snapshot
    is one own push staler, the staleness class other workers' pushes
    already impose)."""
    params = params_of(model)
    leaves, keys = tree_leaves(params), _leaf_keys(params)
    prefetch = bool(FLAGS.ps_prefetch)
    timer = run.timer
    pull_f = client.pull_all_async() if prefetch else None
    last_display = -1
    try:
        while step < FLAGS.training_iter:
            t0 = time.perf_counter()
            flat, pull_step = (pull_f.result() if prefetch
                               else client.pull_all())
            t1 = time.perf_counter()
            step = pull_step
            upload_params(leaves, keys, flat)
            batch = _to_device(train_data.next_batch(FLAGS.batch_size),
                               device)
            t2 = time.perf_counter()
            if step % FLAGS.display_step == 0 and step != last_display:
                # the prefetched pull was issued before the push landed,
                # so a step can repeat: display each boundary once
                last_display = step
                m = eval_fn(batch)
                run.displays += 1
                logger.log_display(step, float(m["loss"]),
                                   float(m["accuracy"]))
            t3 = time.perf_counter()
            grads, _ = grad_fn(batch, generator)
            if prefetch:
                pull_f = client.pull_all_async()
            t4 = time.perf_counter()
            host = grads_to_host(grads)
            t5 = time.perf_counter()
            step = client.push_grads(dict(zip(keys, host)), assignment)
            t6 = time.perf_counter()
            for k, dt in (("pull", t1 - t0), ("upload", t2 - t1),
                          ("grad", t4 - t3), ("download", t5 - t4),
                          ("push", t6 - t5)):
                timer.add(k, dt)
            run.cycle_done(step)
            # the pulled snapshot, under the step it was pulled at
            ckpt.maybe_save({"params": params, "step": pull_step}, pull_step)
    finally:
        if pull_f is not None:
            # leave no pull in flight to race the chief's final pull:
            # cancel it if unstarted, else consume it
            if not pull_f.cancel():
                try:
                    pull_f.result()
                except Exception:  # noqa: BLE001 — the result is unused
                    pass
    return step


def run_worker(cluster, FLAGS) -> int:
    """The worker role: async stale-gradient SGD against the ps tasks —
    the reference's hot loop (MNISTDist.py:172-188) with the gradients
    computed on ``--device``. The chief restores or initializes the ps,
    and at the end pulls, saves and runs the test eval. Prints a
    ``ps worker summary:`` JSON line of its cycles, display evals,
    images/s, global steps/s, per-cycle time split and (with
    ``--profile_dir``) the device's busy share over ``--profile_steps``
    cycles before "Optimization Finished!"."""
    from distributed_tensorflow_tpu_torch.data import read_data_sets
    from distributed_tensorflow_tpu_torch.training.loop import (
        _full_f32_on,
        build_model_for,
    )

    err = ps_unsupported_flag_error(FLAGS)
    if err is not None:
        raise ValueError(err)
    device = _full_f32_on(FLAGS.device)
    ds = read_data_sets(FLAGS.data_dir, one_hot=True, dataset=FLAGS.dataset,
                        seed=FLAGS.seed + FLAGS.task_index)
    model = build_model_for(FLAGS, ds.meta)
    grad_fn = make_grad_fn(model, FLAGS.keep_prob, wire=FLAGS.ps_wire)
    is_chief = FLAGS.task_index == 0
    n_workers = cluster.num_tasks("worker")

    model.init(torch.Generator().manual_seed(FLAGS.seed))
    template = params_to_numpy(model)
    flat_template = flatten_pytree(template)
    model.to(device)
    leaves, keys = tree_leaves(params_of(model)), list(flat_template)
    assignment = assign_shards(keys, cluster.num_tasks("ps"))

    client = PSClient(cluster.ps_hosts, wire=FLAGS.ps_wire)
    ckpt = Checkpointer(FLAGS.logdir, is_chief=is_chief,
                        save_model_secs=FLAGS.save_model_secs,
                        max_to_keep=max_to_keep_from_flags(FLAGS),
                        background=background_save_from_flags(FLAGS))
    logger = MetricsLogger(FLAGS.logdir if is_chief else None,
                           job_name="worker", task_index=FLAGS.task_index)
    try:
        client.wait_ready()
        if is_chief:
            restored = ckpt.restore({"params": template, "step": 0})
            if restored is not None:
                blob, _ = restored
                client.init_params(flatten_pytree(blob["params"]), assignment,
                                   optimizer=FLAGS.optimizer,
                                   learning_rate=FLAGS.learning_rate,
                                   num_workers=n_workers)
                at = int(np.asarray(blob["step"]))
                client.call(0, {"op": "set_step", "global_step": at})
                print(f"worker/0 restored checkpoint at step {at}")
            else:
                client.init_params(flat_template, assignment,
                                   optimizer=FLAGS.optimizer,
                                   learning_rate=FLAGS.learning_rate,
                                   num_workers=n_workers)
        else:
            print(f"worker/{FLAGS.task_index}: connected to "
                  f"{len(cluster.ps_hosts)} ps task(s); waiting for the "
                  f"chief's initialization", flush=True)
            client.wait_initialized()

        eval_fn = make_eval_step(model)
        generator = torch.Generator(device=leaves[0].device).manual_seed(
            FLAGS.seed * 7919 + FLAGS.task_index)
        train_data = ds.train
        if FLAGS.shard_data:
            train_data = ds.train.shard(FLAGS.task_index, n_workers)
        run = _WorkerRun(StepTimer(PS_TIMER_KEYS), device,
                         FLAGS.profile_dir, FLAGS.profile_steps)
        loop = (_mirror_train_loop
                if FLAGS.ps_mirror and FLAGS.optimizer in MirrorCycle.SLOT_NAMES
                else _full_pull_train_loop)
        step = loop(client, FLAGS, train_data, model, grad_fn, eval_fn,
                    assignment, ckpt, logger, generator, client.get_step(),
                    device, run)
        run.finish(step)
        timed = max(0, run.cycles - run.warm)
        summary = {"task": FLAGS.task_index, "cycles": run.cycles,
                   "displays": run.displays, "timed_cycles": timed,
                   "seconds": run.seconds, "global_steps": run.steps,
                   "images_per_sec": (timed * FLAGS.batch_size / run.seconds
                                      if run.seconds else 0.0),
                   "global_steps_per_sec": (run.steps / run.seconds
                                            if run.seconds else 0.0),
                   "device_busy_share": run.busy_share,
                   **run.timer.scalars()}
        logger.scalars(step, summary)
        print("ps worker summary: " + json.dumps(summary), flush=True)

        if is_chief:
            flat, step = client.pull_all()
            flat = {k: _bf16_decode(v) if v.dtype == np.uint16 else v
                    for k, v in flat.items()}
            ckpt.save({"params": unflatten_pytree(template, flat),
                       "step": step}, step)
            if FLAGS.test_eval:
                upload_params(leaves, keys, flat)
                res = evaluate(model, ds.test)
                print("test accuracy: ", res["accuracy"], "test loss: ",
                      res["loss"])
    finally:
        # drain the writer even on an error (a pending cadenced save must
        # not die with the process), and stop the client's threads
        ckpt.close()
        client.close()
    print("Optimization Finished!")
    sys.stdout.flush()
    logger.close()
    return 0


def ps_comm_rows(param_bytes: int, grad_bytes: int, *,
                 wire: str = "f32", mirror: bool = True) -> list[dict]:
    """The wire bytes of one ps cycle per worker: a full pull moves |P|
    down and the push |G| up over TCP and the host<->card link, both
    halved by ``--ps_wire bf16``; ``--ps_mirror`` replaces the pull with
    the on-card replay, so pulls happen only at the resync cadence."""
    scale = 0.5 if wire == "bf16" else 1.0
    pull = int(param_bytes * scale)
    push = int(grad_bytes * scale)
    rows = [{
        "collective": "pull(params, ps->worker)", "axis": "host",
        "bytes": 0 if mirror else pull,
        "exposed_bytes": 0 if mirror else pull,
        "note": ("--ps_mirror replays updates on chip; full pulls only "
                 "at the --ps_resync_steps cadence" if mirror else
                 f"full parameter pull per cycle (|P|{' bf16' if scale < 1 else ''})"),
    }, {
        "collective": "push(grads, worker->ps)", "axis": "host",
        "bytes": push, "exposed_bytes": push,
        "note": f"gradient push per cycle (|G|"
                f"{' bf16' if scale < 1 else ''})",
    }]
    return rows
