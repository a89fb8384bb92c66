"""The port's KV-cache decode and ``/v1/generate`` against the JAX
package's, on the CPU.

The JAX package initializes a small causal LM (V = 16, S = 32, d = 32,
2 blocks) and writes its checkpoint. Greedy ``generate`` must return
JAX's tokens for the same parameters and prompts, at batch 1 and 3, with
the logits at rtol 1e-4 (atol 1e-6); every decode row must equal the
port's own full-prefix forward at that position at the same tolerance;
the port's HTTP server answers ``/v1/generate`` with those tokens, an
out-of-vocabulary prompt with a 400, and a seeded sampled request the
same way twice."""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.checkpoint import save_checkpoint
from distributed_tensorflow_tpu.models.transformer import (
    TransformerLM as JaxLM,
)
from distributed_tensorflow_tpu.serving import decode as jdec
from distributed_tensorflow_tpu.training import create_train_state, sgd
from distributed_tensorflow_tpu_torch import flags
from distributed_tensorflow_tpu_torch.models import TransformerLM
from distributed_tensorflow_tpu_torch.serving import (
    InferenceServer,
    generate_group_key,
)
from distributed_tensorflow_tpu_torch.serving import decode as tdec
from distributed_tensorflow_tpu_torch.serving.__main__ import (
    build_serving_stack,
)
from distributed_tensorflow_tpu_torch.utils.pytree import params_from_jax

V, S, D, H, NB = 16, 32, 32, 2, 2
TOL = dict(rtol=1e-4, atol=1e-6)
N_NEW = 6


@pytest.fixture(scope="module")
def jax_lm(tmp_path_factory):
    """(logdir, JAX model, JAX params): a seeded state, its checkpoint."""
    d = str(tmp_path_factory.mktemp("torch-lm-serve"))
    model = JaxLM(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
                  num_blocks=NB)
    state = create_train_state(model, sgd(0.1), seed=3)
    save_checkpoint(d, state, 4)
    return d, model, state.params


@pytest.fixture(scope="module")
def jax_fns(jax_lm):
    _, model, _ = jax_lm
    return jdec.make_prefill(model), jdec.make_decode_step(model)


def _port_model(params, **kw):
    tm = TransformerLM(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
                       num_blocks=NB, **kw)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return tm.eval()


def _prompts(b, p, seed):
    return np.random.default_rng(seed).integers(0, V, (b, p)).astype(
        np.int32)


@pytest.mark.parametrize("b,p", [(1, 5), (3, 9)])
def test_greedy_generate_equals_jax(jax_lm, jax_fns, b, p):
    _, jm, params = jax_lm
    prompts = _prompts(b, p, seed=b)
    want = jdec.generate(jm, params, prompts, N_NEW, prefill_fn=jax_fns[0],
                         step_fn=jax_fns[1])
    got = tdec.generate(_port_model(params), prompts, N_NEW)
    assert got["tokens"].shape == (b, p + N_NEW)
    assert got["logits"].shape == (b, N_NEW, V)
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    np.testing.assert_allclose(got["logits"], np.asarray(want["logits"]),
                               **TOL)


@pytest.mark.parametrize("kw", [{}, {"attn_block": 8}],
                         ids=["dense", "attn_block"])
def test_decode_rows_equal_the_full_prefix_forward(jax_lm, kw):
    """Each decode step's logits against the port's own forward over the
    generated sequence (padded to the capacity) at that position."""
    _, _, params = jax_lm
    tm = _port_model(params, **kw)
    prompts = _prompts(2, 7, seed=11)
    out = tdec.generate(tm, prompts, N_NEW)
    full = np.zeros((2, S), np.int64)
    full[:, :7 + N_NEW] = out["tokens"]
    with torch.no_grad():
        ref = tm(torch.from_numpy(full)).numpy()
    np.testing.assert_allclose(out["logits"], ref[:, 6:6 + N_NEW], **TOL)
    np.testing.assert_array_equal(out["tokens"][:, 7:],
                                  ref[:, 6:6 + N_NEW].argmax(-1))


def test_generate_refuses_bad_requests(jax_lm):
    tm = _port_model(jax_lm[2])
    with pytest.raises(ValueError, match=r"prompt ids must be in \[0, 16\)"):
        tdec.generate(tm, np.array([[1, 16]]), 2)
    with pytest.raises(ValueError, match="cache capacity"):
        tdec.generate(tm, _prompts(1, 30, seed=0), 3)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tdec.generate(tm, _prompts(1, 3, seed=0), 0)
    with pytest.raises(ValueError, match="TransformerLM"):
        tdec.check_decodable(torch.nn.Linear(2, 2))


def test_sampling_repeats_for_a_seed_and_follows_the_temperature(jax_lm):
    tm = _port_model(jax_lm[2])
    prompts = _prompts(2, 4, seed=5)

    def sample(seed, t):
        return tdec.generate(tm, prompts, N_NEW, temperature=t,
                             generator=torch.Generator().manual_seed(seed))

    a, b = sample(1, 1.0), sample(1, 1.0)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert any(not np.array_equal(sample(s, 1.0)["tokens"], a["tokens"])
               for s in range(2, 6))
    # a vanishing temperature is the greedy argmax
    np.testing.assert_array_equal(sample(1, 1e-6)["tokens"],
                                  tdec.generate(tm, prompts, N_NEW)["tokens"])


def test_generate_group_key_seeded_batches_alone():
    a = generate_group_key([1, 2], {"max_new_tokens": 4})
    assert a == generate_group_key([3, 4], {"max_new_tokens": 4})
    assert a != generate_group_key([3, 4, 5], {"max_new_tokens": 4})
    s = generate_group_key([1, 2], {"max_new_tokens": 4, "seed": 1})
    assert s != generate_group_key([1, 2], {"max_new_tokens": 4, "seed": 1})


@pytest.fixture
def fresh_flags():
    flags.define_flags()
    flags.FLAGS._reset()
    yield flags.FLAGS
    flags.FLAGS._reset()


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_generate_matches_jax(jax_lm, jax_fns, fresh_flags):
    logdir, jm, params = jax_lm
    fresh_flags._parse(["--device", "cpu", "--logdir", logdir, "--model",
                        "lm", "--dataset", "lm", "--seq_len", str(S),
                        "--vocab_size", str(V), "--d_model", str(D),
                        "--num_heads", str(H), "--num_blocks", str(NB),
                        "--serve_port", "0", "--serve_reload_secs", "0",
                        "--serve_max_new_tokens", str(N_NEW),
                        "--serve_timeout_ms", "60000"])
    engine, client, _, metrics = build_serving_stack(fresh_flags)
    assert engine.step == 4 and engine.input_dtype == np.int32
    server = InferenceServer(engine, client, port=0).start_background()
    url = server.address + "/v1/generate"
    try:
        prompt = _prompts(1, 8, seed=21)
        code, body = _post(url, {"prompt": prompt[0].tolist()})
        want = jdec.generate(jm, params, prompt, N_NEW,
                             prefill_fn=jax_fns[0], step_fn=jax_fns[1])
        assert code == 200
        assert body["tokens"] == np.asarray(want["tokens"])[0].tolist()
        code, bad = _post(url, {"prompt": [1, 99]})
        assert code == 400 and "prompt ids" in bad["error"]
        code, over = _post(url, {"prompt": [1], "max_new_tokens": N_NEW + 1})
        assert code == 400 and "cap" in over["error"]
        seeded = {"prompt": [3, 1, 4], "temperature": 1.0, "seed": 9}
        first, again = _post(url, seeded), _post(url, seeded)
        assert first[0] == again[0] == 200
        assert first[1]["tokens"] == again[1]["tokens"]
        with urllib.request.urlopen(server.address + "/metrics",
                                    timeout=30) as r:
            code, health = r.status, json.loads(r.read())
        assert code == 200 and health["generate"]["completed"] >= 3
        # the predict route serves the LM's logits from int32 ids
        logits = client.predict(prompt[0].tolist() + [0] * (S - 8))
        assert np.asarray(logits).shape == (S, V)
    finally:
        server.close()
        client.predict_batcher.close()
        client.generate_batcher.close()
        metrics.logger.close()


def test_continuous_scheduler_is_not_yet_ported(jax_lm, fresh_flags):
    fresh_flags._parse(["--device", "cpu", "--logdir", jax_lm[0], "--model",
                        "lm", "--dataset", "lm", "--serve_scheduler",
                        "continuous"])
    with pytest.raises(NotImplementedError, match="continuous"):
        build_serving_stack(fresh_flags)
