"""Procedural language-model dataset: in-context associative recall.

The counterpart of ``distributed_tensorflow_tpu/data/lm.py``, copied so
that a seed gives the same tokens byte for byte in both packages (the
port never imports the JAX package, not even its numpy-only modules).

Each sequence follows a FRESH per-sequence random permutation of the
vocabulary: x[t+1] = perm(x[t]), with perm drawn independently per
sequence. No transition is shared across sequences, so the weights
cannot memorize a bigram table: the only way to predict x[t+1] is to
find the earlier occurrence of x[t] in this sequence's own context and
copy what followed it (the induction-head solution). Next-token accuracy
is then a measure of working long-range attention:

- a bigram/MLP model is stuck near 1/vocab_size,
- a causal transformer approaches the RECALL CEILING: once a cycle of
  the permutation has been traversed every later token has an
  in-context antecedent. The achievable accuracy is the mean fraction of
  positions whose token already appeared, measured per split and exposed
  as ``recall_ceiling`` (for vocab 64 and seq 256 it is ~0.87).

Deterministic per (seed, split sizes); the whole split materializes as
uint8/uint16 tokens (vocab-dependent) so evaluation is a fixed set.
"""

from __future__ import annotations

import numpy as np


def _gen_sequences(n: int, seq_len: int, vocab_size: int,
                   rng: np.random.Generator) -> np.ndarray:
    """(n, seq_len+1) token ids: per-row random permutation walks."""
    # one fresh permutation per sequence: argsort of uniform noise
    perms = np.argsort(rng.random((n, vocab_size)), axis=1)
    toks = np.empty((n, seq_len + 1), dtype=np.int64)
    toks[:, 0] = rng.integers(0, vocab_size, n)
    rows = np.arange(n)
    for t in range(seq_len):
        toks[:, t + 1] = perms[rows, toks[:, t]]
    return toks


def recall_ceiling(tokens: np.ndarray) -> float:
    """Mean fraction of predictable positions: target y[t] = x[t+1] is
    predictable by in-context recall iff x[t] occurred earlier in the
    sequence (its successor was then observed). Computed exactly from
    the split's tokens."""
    x = tokens[:, :-1]
    n, s = x.shape
    seen = np.zeros((n, tokens.max() + 1), dtype=bool)
    rows = np.arange(n)
    predictable = np.zeros((n, s), dtype=bool)
    for t in range(s):
        predictable[:, t] = seen[rows, x[:, t]]
        seen[rows, x[:, t]] = True
    return float(predictable.mean())


class LMDataSet:
    """One LM split with the tutorial ``next_batch`` surface.

    ``next_batch(B)`` -> (x int32 (B, S), y int32 (B, S)) with
    y = x shifted one token left (next-token targets — every position
    has a target, so the token axis shards uniformly in SP mode).
    Storage is u8/u16 by vocab size; shuffled-epoch index stream like
    the image DataSet. ``images``/``labels`` expose the full split for
    the shared ``evaluate`` path (the names are the tutorial API's)."""

    def __init__(self, n: int, seq_len: int, vocab_size: int = 64,
                 seed: int = 0):
        if vocab_size < 2 or vocab_size > 65535:
            raise ValueError(f"vocab_size={vocab_size} not in [2, 65535]")
        rng = np.random.default_rng(seed)
        toks = _gen_sequences(n, seq_len, vocab_size, rng)
        store = np.uint8 if vocab_size <= 256 else np.uint16
        self._tokens = toks.astype(store)
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self._rng = np.random.default_rng(seed + 1)
        self._order = self._rng.permutation(n)
        self._pos = 0
        self.epochs_completed = 0

    @property
    def num_examples(self) -> int:
        return len(self._tokens)

    @property
    def images(self) -> np.ndarray:
        """Full split inputs (N, S) int32 — evaluate()'s batch source."""
        return self._tokens[:, :-1].astype(np.int32)

    @property
    def labels(self) -> np.ndarray:
        """Full split next-token targets (N, S) int32."""
        return self._tokens[:, 1:].astype(np.int32)

    def recall_ceiling(self) -> float:
        return recall_ceiling(self._tokens.astype(np.int64))

    def _next_indices(self, batch_size: int) -> np.ndarray:
        idx = np.empty(batch_size, dtype=np.int64)
        filled = 0
        while filled < batch_size:
            take = min(batch_size - filled, len(self._order) - self._pos)
            idx[filled:filled + take] = (
                self._order[self._pos:self._pos + take])
            self._pos += take
            filled += take
            if self._pos >= len(self._order):
                self._order = self._rng.permutation(self.num_examples)
                self._pos = 0
                self.epochs_completed += 1
        return idx

    def next_batch(self, batch_size: int) -> tuple[np.ndarray, np.ndarray]:
        idx = self._next_indices(batch_size)
        t = self._tokens[idx]
        return t[:, :-1].astype(np.int32), t[:, 1:].astype(np.int32)

    # token ids are already the thin-wire format — one batch surface
    next_batch_raw = next_batch

    def shard(self, index: int, count: int) -> "LMDataSet":
        """Disjoint contiguous shard (multi-host DP feeding)."""
        out = object.__new__(LMDataSet)
        sl = slice(index * self.num_examples // count,
                   (index + 1) * self.num_examples // count)
        out._tokens = self._tokens[sl]
        out.seq_len = self.seq_len
        out.vocab_size = self.vocab_size
        out._rng = np.random.default_rng(index)
        out._order = out._rng.permutation(len(out._tokens))
        out._pos = 0
        out.epochs_completed = 0
        return out
