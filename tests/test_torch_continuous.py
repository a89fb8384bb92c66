"""The port's continuous LM serving (``serving/kvpage.py``,
``serving/continuous.py``, ``decode.make_slot_pools``/``make_slot_step``)
against the JAX package's, on the CPU.

- the page allocator's ledger, step by step, and ``pages_needed`` equal
  JAX's on one operation sequence;
- the scheduler on the host double (numpy on both sides) gives JAX's
  tokens and ``snapshot()`` on one mixed workload;
- the slot step's logits against JAX ``make_slot_step(jit=False)`` on the
  same parameters, pools, page table, tokens and positions: f32 rtol
  1e-4 (atol 1e-6), bf16 within 2e-2 of the logits' scale; the written
  pool rows at the same tolerances, every other row bitwise untouched;
- greedy tokens of ``EngineSlotBackend`` equal the port's whole-batch
  ``generate`` and the JAX ``ContinuousBatcher`` on one checkpoint. The
  checkpoint's seed is chosen so that every generated position's top-2
  margin clears the f32 tolerance, and the test checks that first, so
  equality is owed at every position;
- every request's phases sum to its wall time under mid-batch admission,
  rejection, expiry and injected faults; the close, drain and die paths;
  drain-to-swap, with a hot reload of the engine mid-generation;
- ``/metrics``' ``hbm.kv_pages`` and ``continuous`` blocks and the
  ``/healthz`` KV floor; the flag validators' messages are JAX's.

The TransformerLM is V 32, S 64, d 32, 2 heads, 2 blocks."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu import flags as jflags
from distributed_tensorflow_tpu.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from distributed_tensorflow_tpu.models.transformer import (
    TransformerLM as JaxLM,
)
from distributed_tensorflow_tpu.serving import batcher as jbatcher
from distributed_tensorflow_tpu.serving import continuous as jcont
from distributed_tensorflow_tpu.serving import decode as jdec
from distributed_tensorflow_tpu.serving import kvpage as jkv
from distributed_tensorflow_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_tpu.training import create_train_state, sgd
from distributed_tensorflow_tpu_torch import flags
from distributed_tensorflow_tpu_torch.checkpoint import save_checkpoint
from distributed_tensorflow_tpu_torch.models import TransformerLM
from distributed_tensorflow_tpu_torch.serving import (
    ContinuousBatcher,
    EngineSlotBackend,
    HostSlotBackend,
    InferenceEngine,
    InferenceServer,
    InProcessClient,
    PageAllocator,
    RejectedError,
    pages_needed,
    reqtrace,
)
from distributed_tensorflow_tpu_torch.serving import batcher as tbatcher
from distributed_tensorflow_tpu_torch.serving import continuous as tcont
from distributed_tensorflow_tpu_torch.serving import decode as tdec
from distributed_tensorflow_tpu_torch.serving import kvpage as tkv
from distributed_tensorflow_tpu_torch.serving.continuous import (
    ContinuousScheduler,
)
from distributed_tensorflow_tpu_torch.utils import faults, telemetry
from distributed_tensorflow_tpu_torch.utils.pytree import (
    params_from_jax,
    params_to_numpy,
)

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

V, S, D, H, NB = 32, 64, 32, 2, 2
PAGE = 8
TOL = dict(rtol=1e-4, atol=1e-6)
BF16_SCALE_TOL = 2e-2
MARGIN_TOL = 1e-4  # near tie: the top-2 margin within this of the scale
CKPT_SEED = 0


@pytest.fixture(autouse=True)
def _clean():
    """The plane, the faults and the tracer are process-global."""
    faults.reset()
    prev = reqtrace.get_plane()
    yield
    faults.reset()
    reqtrace._PLANE = prev
    telemetry.configure(logdir=None, enabled=True)


@pytest.fixture
def plane():
    return reqtrace.configure(enabled=True, slo_p99_ms=60_000.0)


def _batcher(backend, **kw):
    cfg = dict(queue_depth=64, default_timeout_ms=30_000.0)
    cfg.update(kw)
    return ContinuousBatcher(backend, **cfg)


def _workload(seed, n, max_prompt=14, max_new=18):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, rng.integers(1, max_prompt)).astype(np.int32),
             int(rng.integers(1, max_new))) for _ in range(n)]


# ------------------------------------------------------ page allocator


def _ledger(mod):
    """One operation sequence on either package's allocator: every
    returned page, every refusal's message and every occupancy."""
    a = mod.PageAllocator(num_pages=6, page_size=PAGE)
    log = [a.can_admit(40), a.can_admit(49)]
    r1 = a.reserve(20)
    r2 = a.reserve(17)
    log.append(a.occupancy())
    for r in (r1, r1, r2, r1):
        log.append(a.alloc(r))
    try:
        a.alloc(r1)
    except RuntimeError as e:
        log.append(str(e))
    try:
        a.reserve(25)
    except RuntimeError as e:
        log.append(str(e))
    log.append(a.occupancy())
    a.release(r1)
    a.release(r1)
    log += [a.occupancy(), a.can_admit(30), a.can_admit(24)]
    r3 = a.reserve(24)
    log += [a.alloc(r3), a.alloc(r2), a.occupancy()]
    a.release(r2)
    a.release(r3)
    log.append(a.occupancy())
    return log


def test_allocator_ledger_and_pages_needed_match_jax():
    assert tkv.PageAllocator is PageAllocator
    assert _ledger(tkv) == _ledger(jkv)
    for n in (0, 1, 7, 8, 9, 64):
        assert pages_needed(n, PAGE) == jkv.pages_needed(n, PAGE)
    for args in ((-1, PAGE), (4, 0)):
        with pytest.raises(ValueError) as got:
            pages_needed(*args)
        with pytest.raises(ValueError) as want:
            jkv.pages_needed(*args)
        assert str(got.value) == str(want.value)


# ------------------------------------------- scheduler on the host double


def _drive_host(cont, bat, backend, reqs):
    """Run either package's scheduler synchronously (no threads), with
    FIFO admission between iterations as its batcher does. Returns the
    tokens in submission order and the final snapshot."""
    sched = cont.ContinuousScheduler(backend)
    queue = [bat._Request(payload=p, opts={"max_new_tokens": n},
                          group=None, future=bat.Future(), t_submit=0.0,
                          deadline=1e18)
             for p, n in reqs]
    order = list(queue)
    out = {}
    while True:
        while queue and sched._can_admit(queue[0]):
            sched._admit(queue.pop(0))
        if not sched._has_residents():
            break
        finished, _ = sched._iterate()
        for r, toks in finished:
            out[id(r)] = toks
    return [out[id(r)] for r in order], sched.snapshot()


def test_host_backend_scheduling_matches_jax():
    reqs = _workload(7, 12, max_prompt=20, max_new=24)
    got_toks, got = _drive_host(
        tcont, tbatcher, HostSlotBackend(n_slots=3, capacity=S,
                                         page_size=PAGE, num_pages=16), reqs)
    want_toks, want = _drive_host(
        jcont, jbatcher, jcont.HostSlotBackend(n_slots=3, capacity=S,
                                               page_size=PAGE, num_pages=16),
        reqs)
    assert got == want
    assert len(got_toks) == len(want_toks) == len(reqs)
    for g, w in zip(got_toks, want_toks):
        np.testing.assert_array_equal(g, w)
    assert got["page_ledger_ok"] and got["tokens_emitted"] == sum(
        n for _, n in reqs)
    assert got["kv_pages"]["pages_in_use"] == 0


# -------------------------------------------------------- the slot step


def _jax_params(dtype_name, seed=CKPT_SEED):
    cd = jnp.bfloat16 if dtype_name == "bf16" else None
    jm = JaxLM(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
               num_blocks=NB, compute_dtype=cd)
    return jm, create_train_state(jm, sgd(0.1), seed=seed).params


def _port_model(params, dtype_name):
    cd = torch.bfloat16 if dtype_name == "bf16" else None
    tm = TransformerLM(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
                       num_blocks=NB, compute_dtype=cd)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return tm.eval()


def _slot_inputs(seed):
    """Six slots: four live at mixed positions on distinct pages (the
    pages they would have mapped by then), two free (all-zero rows, t 0);
    pools of seeded noise, scratch page included."""
    rng = np.random.default_rng(seed)
    n_slots, per_slot, num_pages = 6, S // PAGE, 40
    t = np.array([0, 9, 0, 63, 30, 0], np.int32)
    live = [True, True, False, True, True, False]
    table = np.zeros((n_slots, per_slot), np.int32)
    free_pages = list(rng.permutation(np.arange(1, num_pages + 1)))
    for i in range(n_slots):
        if live[i]:
            for j in range(t[i] // PAGE + 1):
                table[i, j] = free_pages.pop()
    tok = rng.integers(0, V, n_slots).astype(np.int32)
    shape = (num_pages + 1, PAGE, H, D // H)
    pools = [(rng.standard_normal(shape).astype(np.float32) * 0.5,
              rng.standard_normal(shape).astype(np.float32) * 0.5)
             for _ in range(NB)]
    return table, tok, t, pools, live


def _scale_close(got, want, tol):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale, \
        (float(np.abs(got - want).max()), scale)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_slot_step_matches_jax(dtype_name):
    jm, params = _jax_params(dtype_name)
    tm = _port_model(params, dtype_name)
    table, tok, t, pools, live = _slot_inputs(seed=5)
    jdt = jnp.bfloat16 if dtype_name == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    jpools = tuple((jnp.asarray(k, jdt), jnp.asarray(v, jdt))
                   for k, v in pools)
    want, jnew = jdec.make_slot_step(jm, PAGE, jit=False)(
        params, jpools, jnp.asarray(table), jnp.asarray(tok),
        jnp.asarray(t))
    tpools = tuple((torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt))
                   for k, v in pools)
    before = [(k.clone(), v.clone()) for k, v in tpools]
    with torch.no_grad():
        got = tdec.make_slot_step(tm, PAGE)(
            tm, tpools, torch.from_numpy(table), torch.from_numpy(tok),
            torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == (6, V)
    want = np.asarray(want)
    rows = np.flatnonzero(live)
    if dtype_name == "f32":
        np.testing.assert_allclose(got.numpy()[rows], want[rows], **TOL)
    else:
        _scale_close(got.numpy()[rows], want[rows], BF16_SCALE_TOL)
    dest = table[rows, t[rows] // PAGE]
    off = t[rows] % PAGE
    written = np.zeros(pools[0][0].shape[:2], bool)
    written[dest, off] = True
    written[0, 0] = True  # the free slots' scratch writes
    for (gk, gv), (wk, wv), (bk, bv) in zip(tpools, jnew, before):
        for g, w, b in ((gk, wk, bk), (gv, wv, bv)):
            g = g.float().numpy()
            w = np.asarray(jnp.asarray(w, jnp.float32))
            np.testing.assert_array_equal(g[~written], b.float().numpy()[
                ~written])
            if dtype_name == "f32":
                np.testing.assert_allclose(g[dest, off], w[dest, off],
                                           **TOL)
            else:
                _scale_close(g[dest, off], w[dest, off], BF16_SCALE_TOL)
    pools_t = tdec.make_slot_pools(tm, PAGE, 40)
    assert len(pools_t) == NB and pools_t[0][0].shape == (41, PAGE, H,
                                                            D // H)
    assert pools_t[0][0].dtype == tdt and not pools_t[0][0].any()


def test_slot_step_refuses_a_page_that_does_not_tile():
    _, params = _jax_params("f32")
    with pytest.raises(ValueError, match="divide the cache capacity"):
        tdec.make_slot_step(_port_model(params, "f32"), 7)


# ------------------------------------- the engine backend against both


@pytest.fixture(scope="module")
def lm_ckpt(tmp_path_factory):
    """(logdir, JAX model, JAX params): a JAX checkpoint of the f32 LM."""
    d = str(tmp_path_factory.mktemp("torch-continuous"))
    jm, _ = _jax_params("f32")
    state = create_train_state(jm, sgd(0.1), seed=CKPT_SEED)
    jax_save_checkpoint(d, state, 10)
    return d, jm, state.params


def _port_engine(logdir, **kw):
    tm = TransformerLM(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
                       num_blocks=NB)
    return InferenceEngine(tm, logdir, device="cpu", max_batch=4, **kw)


def test_engine_backend_tokens_match_whole_batch_and_jax(lm_ckpt, plane):
    logdir, jm, _ = lm_ckpt
    eng = _port_engine(logdir)
    reqs = _workload(3, 8)
    refs = [eng.generate(p[None], n) for p, n in reqs]
    # the seed's margins clear the tolerance at every generated position,
    # so no position is a near tie and equality is owed everywhere
    for r in refs:
        top2 = np.sort(r["logits"][0], axis=-1)[:, -2:]
        scale = float(np.abs(r["logits"]).max())
        assert float((top2[:, 1] - top2[:, 0]).min()) > MARGIN_TOL * scale
    backend = EngineSlotBackend(eng, n_slots=3, page_size=PAGE)
    assert not backend.graph and backend.captures == 0
    b = _batcher(backend)
    try:
        futs = [b.submit(p, max_new_tokens=n) for p, n in reqs]
        got = [f.result(timeout=120) for f in futs]
    finally:
        b.close()
    jeng = JaxEngine(jm, logdir, max_batch=4)
    jb = jcont.ContinuousBatcher(
        jcont.EngineSlotBackend(jeng, n_slots=3, page_size=PAGE),
        queue_depth=64, default_timeout_ms=120_000.0)
    try:
        jfuts = [jb.submit(p, max_new_tokens=n) for p, n in reqs]
        want = [np.asarray(f.result(timeout=300)) for f in jfuts]
    finally:
        jb.close()
    for g, r, w in zip(got, refs, want):
        np.testing.assert_array_equal(g, r["tokens"][0])
        np.testing.assert_array_equal(g, w)
    snap = b.scheduler.snapshot()
    assert snap["page_ledger_ok"] and snap["kv_pages"]["pages_in_use"] == 0
    assert [s["disposition"] for s in plane.audit] == ["ok"] * len(reqs)
    for f, (_, n) in zip(futs, reqs):
        assert f.meta["decode_ticks"] == n


def test_return_logits_and_seeded_sampling(lm_ckpt):
    eng = _port_engine(lm_ckpt[0])
    b = _batcher(EngineSlotBackend(eng, n_slots=2, page_size=PAGE))
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    try:
        out = b.submit(prompt, max_new_tokens=6,
                       return_logits=True).result(timeout=60)
        seeded = [b.submit(prompt, max_new_tokens=6, temperature=1.0,
                           seed=s).result(timeout=60) for s in (9, 9, 10)]
    finally:
        b.close()
    ref = eng.generate(prompt[None], 6)
    np.testing.assert_array_equal(out["tokens"], ref["tokens"][0])
    np.testing.assert_allclose(out["logits"], ref["logits"][0], **TOL)
    np.testing.assert_array_equal(seeded[0], seeded[1])
    assert len(seeded[2]) == 11


# ------------------------------------------------ phases, exits, closing


def test_sum_phases_equals_wall_under_mid_batch_admission(plane):
    backend = HostSlotBackend(n_slots=2, capacity=S, page_size=PAGE,
                              step_cost=lambda: time.sleep(0.002))
    b = _batcher(backend)
    try:
        f_long = b.submit(np.array([1, 2, 3], np.int32), max_new_tokens=30)
        time.sleep(0.02)  # the long request is mid-decode...
        f_short = b.submit(np.array([4, 5], np.int32), max_new_tokens=3)
        assert len(f_long.result(timeout=30)) == 33
        assert len(f_short.result(timeout=30)) == 5
    finally:
        b.close()
    # the short request was admitted mid-batch and retired first
    assert f_short.meta["slot"] != f_long.meta["slot"]
    assert f_short.meta["iter_admit"] > f_long.meta["iter_admit"]
    assert f_short.meta["iter_retire"] < f_long.meta["iter_retire"]
    assert len(plane.audit) == 2
    for s in plane.audit:
        assert s["disposition"] == "ok"
        assert {"admit", "queue_wait", "prefill", "decode",
                "respond"} <= set(s["phases_ms"])
        assert sum(s["phases_ms"].values()) == pytest.approx(
            s["total_ms"], abs=0.05)
    assert f_long.meta["decode_ticks"] == 30


def test_rejection_expiry_fault_and_failure_timelines(plane):
    # two slots held by long generations and a queue of 1: the third
    # request queues and expires, the fourth is shed
    backend = HostSlotBackend(n_slots=2, capacity=S, page_size=PAGE,
                              step_cost=lambda: time.sleep(0.002))
    b = _batcher(backend, queue_depth=1)
    try:
        futs = []
        for _ in range(2):
            futs.append(b.submit(np.array([1, 2], np.int32),
                                 max_new_tokens=40))
            deadline = time.monotonic() + 5
            while (b.stats.as_dict()["queue_depth"]
                   and time.monotonic() < deadline):
                time.sleep(0.002)  # wait for the slot admission
        f_exp = b.submit(np.array([3], np.int32), max_new_tokens=2,
                         timeout_ms=20)
        with pytest.raises(RejectedError, match="queue full") as full:
            b.submit(np.array([4], np.int32), max_new_tokens=2,
                     request_id="req-shed")
        assert full.value.request_id == "req-shed"
        with pytest.raises(RejectedError, match="deadline"):
            f_exp.result(timeout=10)
        assert f_exp.meta["disposition"] == "expired"
        faults.configure("serve_admit:mode=error:times=1")
        with pytest.raises(RejectedError, match="admission fault"):
            b.submit(np.array([5], np.int32), max_new_tokens=2)
        for f in futs:
            f.result(timeout=30)
        # an injected iteration fault fails the residents and serving
        # goes on
        faults.configure("serve_batch:mode=error:times=1")
        f_fail = b.submit(np.array([6], np.int32), max_new_tokens=3)
        with pytest.raises(faults.InjectedFault):
            f_fail.result(timeout=10)
        assert f_fail.meta["disposition"] == "failed"
        assert len(b.submit(np.array([7], np.int32),
                            max_new_tokens=3).result(timeout=10)) == 4
        with pytest.raises(ValueError, match="exceeds"):
            b.submit(np.arange(60, dtype=np.int32) % V, max_new_tokens=10)
    finally:
        faults.reset()
        b.close()
    assert b.stats.as_dict()["rejected_fault"] == 1
    by = {}
    for s in plane.audit:
        by.setdefault(s["disposition"], []).append(s)
        assert sum(s["phases_ms"].values()) == pytest.approx(
            s["total_ms"], abs=0.05)
    assert set(by) == {"ok", "expired", "rejected_full", "rejected_fault",
                       "failed"}
    assert "queue_wait" in by["expired"][0]["phases_ms"]
    assert b.scheduler.snapshot()["kv_pages"]["pages_committed"] == 0


def test_close_drain_and_die_paths():
    backend = HostSlotBackend(n_slots=2, capacity=S, page_size=PAGE,
                              step_cost=lambda: time.sleep(0.002))
    b = _batcher(backend, queue_depth=8)
    futs = [b.submit(np.array([1, 2], np.int32), max_new_tokens=12)
            for _ in range(5)]
    b.close(drain=True)  # finishes the residents and the queue
    assert all(len(f.result(timeout=5)) == 14 for f in futs)
    assert b.closed
    with pytest.raises(RejectedError, match="closed"):
        b.submit(np.array([1], np.int32), max_new_tokens=2)

    b2 = _batcher(HostSlotBackend(n_slots=2, capacity=S, page_size=PAGE,
                                  step_cost=lambda: time.sleep(0.005)),
                  queue_depth=8)
    futs2 = [b2.submit(np.array([1, 2], np.int32), max_new_tokens=40)
             for _ in range(4)]
    deadline = time.monotonic() + 5
    while (b2.stats.as_dict()["queue_depth"] == 4
           and time.monotonic() < deadline):
        time.sleep(0.002)  # until the slots fill
    b2.close(drain=False)  # rejects the queue; residents still finish
    results = []
    for f in futs2:
        try:
            results.append(("ok", len(f.result(timeout=30))))
        except RejectedError:
            results.append(("rejected", None))
    assert ("ok", 42) in results and ("rejected", None) in results

    class Dying(HostSlotBackend):
        def step(self, page_table, tok, t):
            time.sleep(0.01)
            raise SystemExit("card lost")

    b3 = _batcher(Dying(n_slots=2, capacity=S, page_size=PAGE))
    f_res = b3.submit(np.array([1], np.int32), max_new_tokens=4)
    with pytest.raises(SystemExit):
        f_res.result(timeout=10)
    deadline = time.monotonic() + 5
    while not b3.closed and time.monotonic() < deadline:
        time.sleep(0.005)
    assert b3.closed
    with pytest.raises(RejectedError, match="closed"):
        b3.submit(np.array([1], np.int32), max_new_tokens=2)
    b3.close()


def test_drain_to_swap_refreshes_only_with_zero_residents():
    class SwapBackend(HostSlotBackend):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.pending_swap = False
            self.refreshes = []

        def wants_refresh(self):
            return self.pending_swap

        def refresh(self):
            self.refreshes.append(self.sched._has_residents())
            self.pending_swap = False

    backend = SwapBackend(n_slots=2, capacity=S, page_size=PAGE,
                          step_cost=lambda: time.sleep(0.002))
    b = _batcher(backend)
    backend.sched = b.scheduler
    try:
        f1 = b.submit(np.array([1, 2], np.int32), max_new_tokens=20)
        time.sleep(0.01)
        backend.pending_swap = True  # a hot swap lands mid-generation
        f2 = b.submit(np.array([3], np.int32), max_new_tokens=4)
        assert len(f1.result(timeout=30)) == 22
        assert len(f2.result(timeout=30)) == 5  # admitted after the swap
        deadline = time.monotonic() + 5
        while backend.pending_swap and time.monotonic() < deadline:
            time.sleep(0.005)
        assert backend.refreshes == [False]  # swapped while empty
    finally:
        b.close()


def test_hot_reload_mid_generation_drains_then_swaps(tmp_path):
    """In-flight requests finish on the old weights; a request after the
    drain gets the new checkpoint's tokens."""
    old = TransformerLM(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
                        num_blocks=NB).init(torch.Generator().manual_seed(1))
    new = TransformerLM(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
                        num_blocks=NB).init(torch.Generator().manual_seed(2))
    logdir = str(tmp_path)
    save_checkpoint(logdir, {"params": params_to_numpy(old),
                             "step": np.int32(1)}, 1)
    eng = _port_engine(logdir)
    backend = EngineSlotBackend(eng, n_slots=2, page_size=PAGE)
    b = _batcher(backend)
    prompt = np.array([5, 6, 7], np.int32)
    old_ref = eng.generate(prompt[None], 40)["tokens"][0]
    gate = threading.Event()
    step = backend._step_fn

    def slow_step(*args):
        gate.wait(10)
        return step(*args)

    backend._step_fn = slow_step
    try:
        f_old = b.submit(prompt, max_new_tokens=40)
        time.sleep(0.05)
        save_checkpoint(logdir, {"params": params_to_numpy(new),
                                 "step": np.int32(2)}, 2)
        assert eng.reload_if_newer()["swapped"]
        gate.set()
        np.testing.assert_array_equal(f_old.result(timeout=60), old_ref)
        after = b.submit(prompt, max_new_tokens=40).result(timeout=60)
    finally:
        gate.set()
        b.close()
    np.testing.assert_array_equal(after,
                                  eng.generate(prompt[None], 40)["tokens"][0])
    assert not np.array_equal(after, old_ref)
    assert backend.params_step == 2


# ------------------------------------------------------ server and flags


def test_metrics_kv_block_and_healthz_floor(lm_ckpt, plane):
    eng = _port_engine(lm_ckpt[0])
    backend = HostSlotBackend(n_slots=2, capacity=32, page_size=PAGE,
                              num_pages=8,
                              step_cost=lambda: time.sleep(0.005))
    gb = _batcher(backend)
    srv = InferenceServer(eng, InProcessClient(None, gb), port=0,
                          hbm_headroom_floor_pct=70.0).start_background()
    try:
        # a 24-token footprint commits 3 of 8 pages: free 62.5% < 70%
        f = gb.submit(np.array([1, 2], np.int32), max_new_tokens=23)
        deadline = time.monotonic() + 5
        h = srv.healthz()
        while (h["kv_page_free_pct"] in (None, 100.0)
               and time.monotonic() < deadline):
            time.sleep(0.002)
            h = srv.healthz()
        assert h["kv_page_free_pct"] == 62.5
        assert h["kv_low_pages"] and not h["ok"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.address + "/healthz", timeout=10)
        assert ei.value.code == 503
        m = json.loads(urllib.request.urlopen(srv.address + "/metrics",
                                              timeout=10).read())
        kv = m["hbm"]["kv_pages"]
        assert set(m["hbm"]) == {"kv_pages"}
        assert kv["num_pages"] == 8 and kv["pages_committed"] == 3
        assert m["generate"]["continuous"]["n_slots"] == 2
        assert len(f.result(timeout=30)) == 25
        h = srv.healthz()
        assert h["ok"] and h["kv_page_free_pct"] == 100.0
        assert not h["kv_low_pages"]
        m = srv.metrics()
        assert m["tail"]["routes"]["generate"] and m["slo"]["requests"] == 1
        assert m["generate"]["continuous"]["page_ledger_ok"]
    finally:
        gb.close()
        srv.close()


def _message(parse, argv):
    try:
        parse(argv)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("argv", [
    ["--serve_slots", "1"],
    ["--serve_kv_page", "0"],
    ["--seq_len", "64", "--serve_kv_page", "12"],
    ["--serve_kv_pages", "-1"],
    ["--seq_len", "64", "--serve_kv_page", "16", "--serve_kv_pages", "3"],
    ["--serve_scheduler", "continuous", "--model", "mlp"],
    ["--serve_scheduler", "fancy"],
    ["--serve_hbm_headroom_pct", "100"],
    ["--serve_hbm_headroom_pct", "-5"],
])
def test_flag_validators_refuse_with_jax_messages(argv):
    flags.define_flags()
    jflags.define_reference_flags()
    flags.FLAGS._reset()
    jflags.FLAGS._reset()
    try:
        got = _message(flags.FLAGS._parse, argv)
        want = _message(jflags.FLAGS._parse, argv)
    finally:
        flags.FLAGS._reset()
        jflags.FLAGS._reset()
    assert got is not None and got == want


def test_flag_defaults_and_a_continuous_parse():
    flags.define_flags()
    flags.FLAGS._reset()
    try:
        flags.FLAGS._parse(["--model", "lm", "--dataset", "lm",
                            "--serve_scheduler", "continuous", "--seq_len",
                            "64", "--serve_slots", "12", "--serve_kv_pages",
                            "4"])
        f = flags.FLAGS
        assert (f.serve_slots, f.serve_kv_page, f.serve_kv_pages) == \
            (12, 16, 4)
        assert f.serve_hbm_headroom_pct == 0.0 and f.telemetry
    finally:
        flags.FLAGS._reset()


def test_scheduler_owns_no_device_state():
    """The scheduler's state machine is pure host bookkeeping: its page
    table rows of free slots point at the scratch page."""
    sched = ContinuousScheduler(HostSlotBackend(n_slots=2, capacity=S,
                                                page_size=PAGE))
    assert sched._page_table.shape == (2, S // PAGE)
    assert not sched._page_table.any() and not sched._has_residents()
