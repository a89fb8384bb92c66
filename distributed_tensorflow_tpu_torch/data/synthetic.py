"""Procedural offline datasets, numpy only.

The counterpart of ``distributed_tensorflow_tpu/data/synthetic.py``'s
``synthetic_digits`` and ``synthetic_cifar``, kept byte-identical for the
same seed: digits rendered from a 5x7 bitmap font at random sub-pixel
offsets with noise and contrast jitter, and class-conditional colored
textures for CIFAR. Every array is a pure function of the seed.
"""

from __future__ import annotations

import numpy as np

# 5x7 bitmap font, digits 0-9 (rows of 5 bits, MSB = leftmost pixel)
_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _glyph(digit: int) -> np.ndarray:
    rows = _FONT[digit]
    return np.array([[int(c) for c in r] for r in rows], dtype=np.float32)


def _render(digit: int, rng: np.random.Generator, size: int = 28) -> np.ndarray:
    """Render one digit: upscale glyph ~3x, random placement, blur-ish noise."""
    g = _glyph(digit)
    scale = rng.integers(2, 4)  # 2x or 3x upscaling
    g = np.kron(g, np.ones((scale, scale), dtype=np.float32))
    h, w = g.shape
    img = np.zeros((size, size), dtype=np.float32)
    oy = rng.integers(0, size - h + 1)
    ox = rng.integers(0, size - w + 1)
    img[oy : oy + h, ox : ox + w] = g
    # cheap separable blur for stroke softness
    k = np.array([0.25, 0.5, 0.25], dtype=np.float32)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, mode="same"), 0, img)
    contrast = 0.7 + 0.3 * rng.random()
    img = np.clip(img * contrast + rng.normal(0, 0.05, img.shape), 0.0, 1.0)
    return img


def synthetic_digits(
    num: int, seed: int = 0, size: int = 28, num_classes: int = 10
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (images [num, size*size] float32 in [0,1], labels [num] int64)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num)
    images = np.stack([_render(int(d) % 10, rng, size) for d in labels])
    return images.reshape(num, size * size).astype(np.float32), labels.astype(np.int64)


def synthetic_cifar(
    num: int, seed: int = 0, size: int = 32, num_classes: int = 10
) -> tuple[np.ndarray, np.ndarray]:
    """Class-conditional colored textures, (images [num, size, size, 3]
    float32 in [0,1], labels [num] int64).

    Each class is a fixed random 4x4x3 texture (from its own generator,
    seeded 12345, so every split shares the classes) tiled up, rolled by
    a random shift, with Gaussian noise."""
    rng = np.random.default_rng(seed)
    tex_rng = np.random.default_rng(12345)
    textures = tex_rng.random((num_classes, 4, 4, 3)).astype(np.float32)
    labels = rng.integers(0, num_classes, size=num)
    reps = size // 4
    imgs = np.empty((num, size, size, 3), dtype=np.float32)
    for i, lab in enumerate(labels):
        base = np.tile(textures[lab], (reps, reps, 1))
        shift = rng.integers(0, 4, size=2)
        base = np.roll(base, tuple(shift), axis=(0, 1))
        imgs[i] = np.clip(base + rng.normal(0, 0.15, base.shape), 0.0, 1.0)
    return imgs, labels.astype(np.int64)
