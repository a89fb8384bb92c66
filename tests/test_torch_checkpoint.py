"""The port's checkpoint format against the JAX package's: same CRC-32C,
files that restore bitwise in either direction, the same quarantine-and-
fall-back ladder."""

import os

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.checkpoint import checkpoint as jckpt
from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN
from distributed_tensorflow_tpu.training import create_train_state, sgd
from distributed_tensorflow_tpu.utils import events as jevents
from distributed_tensorflow_tpu_torch.checkpoint import checkpoint as tckpt
from distributed_tensorflow_tpu_torch.models import DeepCNN
from distributed_tensorflow_tpu_torch.utils import events as tevents
from distributed_tensorflow_tpu_torch.utils.pytree import params_to_numpy


@pytest.mark.parametrize("n", [0, 9, 1023, 4096, 70001])
def test_crc32c_matches_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    assert tevents.crc32c(data) == jevents.crc32c(data)
    assert tevents.crc32c(data.tobytes()) == tevents._crc32c(data.tobytes())


def _port_params(seed=0):
    return params_to_numpy(DeepCNN().init(torch.Generator().manual_seed(seed)))


def test_jax_checkpoint_restores_bitwise_in_port(tmp_path):
    state = create_train_state(JaxDeepCNN(), sgd(0.1), seed=0)
    jckpt.save_checkpoint(str(tmp_path), state, 7)
    out = tckpt.restore_params_with_fallback(str(tmp_path), _port_params())
    params, step, report = out
    assert step == 7 and report.fallback_depth == 0
    want = jax.tree.map(np.asarray, state.params)
    assert jax.tree.structure(params) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_port_checkpoint_restores_bitwise_in_jax(tmp_path):
    params = _port_params(seed=1)
    tckpt.save_checkpoint(str(tmp_path), {"params": params,
                                          "step": np.int32(11)}, 11)
    template = JaxDeepCNN().init(jax.random.key(0))
    got, step, _ = jckpt.restore_params_with_fallback(str(tmp_path),
                                                      template)
    assert step == 11
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_bf16_tensor_leaves_roundtrip_through_the_tag(tmp_path):
    t = torch.randn(3, 5).to(torch.bfloat16)
    tckpt.save_checkpoint(str(tmp_path), {"params": {"w": t}}, 1)
    assert "__bf16__params/w" in tckpt.load_flat(str(tmp_path / "ckpt-1.npz"))
    got, _, _ = tckpt.restore_params_with_fallback(
        str(tmp_path), {"w": torch.zeros(3, 5, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t)
    # and the JAX package reads the same file
    jgot, _, _ = jckpt.restore_params_with_fallback(
        str(tmp_path), {"w": jax.numpy.zeros((3, 5), jax.numpy.bfloat16)})
    np.testing.assert_array_equal(np.asarray(jgot["w"], np.float32),
                                  t.float().numpy())


def test_corrupt_newest_is_quarantined_and_ladder_falls_back(tmp_path):
    d = str(tmp_path)
    tckpt.save_checkpoint(d, {"params": _port_params(0)}, 10)
    tckpt.save_checkpoint(d, {"params": _port_params(1)}, 20)
    newest = os.path.join(d, "ckpt-20.npz")
    raw = bytearray(open(newest, "rb").read())
    raw[len(raw) // 2] ^= 0xFF  # one flipped byte inside an array
    open(newest, "wb").write(bytes(raw))
    params, step, report = tckpt.restore_params_with_fallback(
        d, _port_params())
    assert step == 10 and report.fallback_depth == 1
    assert any(p.endswith(".corrupt") for p in report.quarantined)
    assert tckpt.latest_checkpoint(d)[1] == 10
    np.testing.assert_array_equal(params["weights"]["wd1"],
                                  _port_params(0)["weights"]["wd1"])


def test_gc_keeps_newest_and_template_mismatch_is_loud(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        tckpt.save_checkpoint(d, {"params": {"w": np.full(2, s, np.float32)}},
                              s, max_to_keep=2)
    assert sorted(n for n in os.listdir(d) if n.endswith(".npz")) == [
        "ckpt-2.npz", "ckpt-3.npz"]
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore_params_with_fallback(d, {"w": np.zeros(3, np.float32)})


def test_sharded_checkpoint_raises_not_yet_ported(tmp_path):
    (tmp_path / "ckpt-5.shard0-of-2.npz").write_bytes(b"")
    with pytest.raises(tckpt.ShardedCheckpointNotPorted,
                       match="not yet ported"):
        tckpt.restore_params_with_fallback(str(tmp_path), _port_params())
