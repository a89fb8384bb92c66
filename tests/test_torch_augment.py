"""The port's on-device augmentation against the JAX package's
``random_crop_flip`` (CPU).

The port draws from a ``torch.Generator``, not from JAX's threefry keys,
so the test re-derives the offsets and flips that JAX draws from a key
(``ops/augment.py``'s own split, randint and bernoulli) and hands them
to the port's ``apply_crop_flip``: the crops and flips of both must be
equal bit for bit, on uint8 and on float32 images."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import augment as jaug
from distributed_tensorflow_tpu_torch.ops import augment as taug
from distributed_tensorflow_tpu_torch.training import device_step
from distributed_tensorflow_tpu_torch.training import train_state as tts

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

CIFAR = {"image_size": 32, "channels": 3}


def _images(b, dtype, seed=0, hw=32):
    r = np.random.default_rng(seed)
    x = r.integers(1, 256, (b, hw, hw, 3))  # no zeros: padding shows
    return x.astype(np.uint8) if dtype == "u8" else (x / 255).astype(
        np.float32)


def _jax_draws(key, b, pad, flip):
    """The offsets and flips ``random_crop_flip`` draws from ``key``."""
    kc, kf = jax.random.split(key)
    off = np.asarray(jax.random.randint(kc, (b, 2), 0, 2 * pad + 1))
    do = np.asarray(jax.random.bernoulli(kf, 0.5, (b,))) if flip else None
    return off, do


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("pad,flip", [(4, True), (2, False), (1, True)])
def test_apply_equals_jax_on_the_draws_jax_makes(dtype, pad, flip):
    x = _images(16, dtype, seed=pad)
    key = jax.random.PRNGKey(7 + pad)
    want = np.asarray(jaug.random_crop_flip(jnp.asarray(x), key, pad=pad,
                                            flip=flip))
    off, do = _jax_draws(key, 16, pad, flip)
    assert len(np.unique(off)) > 1 and (do is None or 0 < do.sum() < 16)
    got = taug.apply_crop_flip(
        torch.from_numpy(x), torch.from_numpy(off).long(),
        None if do is None else torch.from_numpy(do), pad).numpy()
    assert got.dtype == want.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_array_equal(got, want)


def test_pad_zero_without_flip_is_the_identity():
    x = torch.from_numpy(_images(8, "u8"))
    g = torch.Generator().manual_seed(0)
    assert torch.equal(taug.random_crop_flip(x, g, pad=0, flip=False), x)
    off, flips = taug.draw_crop_flip(8, 0, False, g)
    assert torch.equal(off, torch.zeros(8, 2, dtype=torch.int64))
    assert flips is None


def test_a_crop_is_a_shifted_window_and_a_flip_mirrors_it():
    x = torch.from_numpy(_images(2, "u8", seed=3))
    off = torch.tensor([[0, 8], [4, 4]])
    out = taug.apply_crop_flip(x, off, torch.tensor([False, True]), 4)
    # offset (0, 8): rows 0..27 of the image land on rows 4..31, columns
    # 4..31 on 0..27, zeros fill the rest
    assert torch.equal(out[0, 4:, :28], x[0, :28, 4:])
    assert not out[0, :4].any() and not out[0, :, 28:].any()
    assert torch.equal(out[1], torch.flip(x[1], dims=[1]))  # no shift


def test_make_augment_round_trips_the_flat_layout():
    flat = torch.from_numpy(_images(6, "u8", seed=5).reshape(6, -1))
    aug = taug.make_augment(CIFAR, pad=4, flip=True)
    out = aug(flat, torch.Generator().manual_seed(3))
    assert out.shape == flat.shape and out.dtype == torch.uint8
    nhwc = aug(flat.reshape(6, 32, 32, 3), torch.Generator().manual_seed(3))
    assert torch.equal(out, nhwc.reshape(6, -1))
    same = taug.make_augment(CIFAR, pad=0, flip=False)
    assert torch.equal(same(flat, torch.Generator().manual_seed(3)), flat)


def test_draws_follow_the_generator_seed():
    def draw(seed):
        return taug.draw_crop_flip(256, 4, True,
                                   torch.Generator().manual_seed(seed))

    off, flips = draw(1)
    assert int(off.min()) == 0 and int(off.max()) == 8
    assert 0.4 < float(flips.float().mean()) < 0.6
    again = draw(1)
    assert torch.equal(off, again[0]) and torch.equal(flips, again[1])
    assert not torch.equal(off, draw(2)[0])


def test_augment_seed_is_its_own_stream_of_key_step_and_rank():
    key = np.array([0, 5], np.uint32)
    a = tts.augment_seed(key, 3)
    assert a == tts.augment_seed(key, 3)
    assert a != tts.augment_seed(key, 4)
    assert a != tts.augment_seed(key, 3, rank=1)
    assert a not in (tts.dropout_seed(key, 3), device_step.sample_seed(key, 3))
    assert len({tts.augment_seed(key, 3, r) for r in range(4)}) == 4


def test_the_train_step_augments_from_the_augment_seed():
    """``make_train_step(augment_fn=)`` equals the plain step on the batch
    augmented by a generator seeded with ``augment_seed(key, step)``."""
    from distributed_tensorflow_tpu_torch.models import ResNet

    x = torch.from_numpy(_images(4, "u8", seed=9))
    y = torch.tensor([0, 1, 2, 3])
    aug = taug.make_augment(CIFAR)
    runs = []
    for fused in (True, False):
        model = ResNet()
        opt = tts.sgd(0.1)
        state = tts.create_train_state(model, opt, seed=4)
        state = state._replace(step=torch.tensor(3, dtype=torch.int32))
        if fused:
            step = tts.make_train_step(model, opt, augment_fn=aug)
            state, m = step(state, (x, y))
        else:
            g = torch.Generator().manual_seed(tts.augment_seed(state.rng, 3))
            step = tts.make_train_step(model, opt)
            state, m = step(state, (aug(x, g), y))
        runs.append((float(m["loss"]), model.head.w.detach().clone(),
                     model.stem.bn.mean.clone()))
    (l0, w0, s0), (l1, w1, s1) = runs
    assert l0 == l1 and torch.equal(w0, w1) and torch.equal(s0, s1)
