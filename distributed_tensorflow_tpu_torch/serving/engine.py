"""InferenceEngine: checkpoint-to-traffic, with hot-reload.

The counterpart of ``distributed_tensorflow_tpu/serving/engine.py``. It
restores the ``params`` field of the newest checkpoint (written by either
package) through the verify-quarantine-fallback ladder, places the model
on the engine's device, and serves ``predict`` under
``torch.inference_mode()`` with power-of-two batch padding. PyTorch runs
eagerly, so there is no compile cache; the padding keeps the kernel's
shapes to a handful.

Hot-reload: a ``CheckpointWatcher`` thread polls the directory; a newer
step restores off the serving path into a fresh copy of the model, and
the reference swaps atomically between microbatches — in-flight batches
keep the module they started with, so nothing is dropped.

``generate`` decodes a causal LM's prompts through the KV cache of
``serving/decode.py``, one (prefill, step) pair per engine.

Mesh and tensor-parallel placement come with later slices.
"""

from __future__ import annotations

import copy
import threading
import time

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
    latest_checkpoint,
    restore_params_with_fallback,
)
from distributed_tensorflow_tpu_torch.serving.batcher import pow2_bucket
from distributed_tensorflow_tpu_torch.utils.pytree import (
    params_from_jax,
    params_to_numpy,
)


class NoCheckpointError(FileNotFoundError):
    """Serving needs weights: raised when the logdir holds no restorable
    checkpoint at engine construction."""


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' (--device cpu) to run on the CPU")
    return dev


class InferenceEngine:
    """Loads, places, serves and hot-swaps one model's parameters.

    ``model`` is the module template: its configuration, and its
    parameters' names and shapes as the restore template. Each restored
    parameter set lives in its own copy of it on ``device``."""

    def __init__(self, model: torch.nn.Module, logdir: str, *,
                 device="cuda", max_batch: int = 8):
        if getattr(model, "stateful", False):
            raise NotImplementedError(
                f"serving a stateful model ({type(model).__name__}: "
                f"batch-norm running stats) is not yet ported to "
                f"distributed_tensorflow_tpu_torch")
        self.model = model
        self.logdir = logdir
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        # the wire delivers JSON numbers; the LM takes int32 token ids,
        # every other model float32, so the engine owns the cast
        self.input_dtype = (np.int32 if hasattr(model, "vocab_size")
                            else np.float32)
        self._swap_lock = threading.Lock()
        # one reload at a time: two racing restores could swap an older
        # set over a newer one
        self._reload_lock = threading.Lock()
        self._module = None
        self._step = -1
        self._decode_fns = None  # (prefill, step), made on first generate
        self.counters = {"reloads": 0, "reload_failures": 0,
                         "reload_fallbacks": 0, "last_reload_ms": 0.0,
                         "last_fallback_depth": 0}
        self._template = params_to_numpy(model)
        out = restore_params_with_fallback(logdir, self._template)
        if out is None:
            raise NoCheckpointError(
                f"no restorable checkpoint in {logdir!r} — serving needs "
                f"trained weights")
        params, step, report = out
        self._module = self._place(params)
        self._step = step
        self.restore_report = report

    def _place(self, params) -> torch.nn.Module:
        module = copy.deepcopy(self.model)
        module.load_state_dict(params_from_jax(params))
        return module.to(self.device).eval()

    # --------------------------------------------------------- serving

    def current(self):
        """(module, step) — the batch worker reads this once per
        microbatch; a concurrent swap changes what the next batch sees."""
        with self._swap_lock:
            return self._module, self._step

    @property
    def step(self) -> int:
        with self._swap_lock:
            return self._step

    def counters_snapshot(self) -> dict:
        with self._swap_lock:
            return dict(self.counters)

    def _bucket(self, n: int) -> int:
        return pow2_bucket(n, self.max_batch)

    def predict(self, x) -> np.ndarray:
        """Forward one stacked batch (B, ...) -> host outputs (B, ...):
        pads the batch to its power-of-two bucket with zero rows, runs the
        current module, slices the padding back off."""
        x = np.asarray(x, dtype=self.input_dtype)
        b = x.shape[0]
        bucket = self._bucket(b)
        if bucket > b:
            pad = np.zeros((bucket - b, *x.shape[1:]), x.dtype)
            x = np.concatenate([x, pad], axis=0)
        module, _ = self.current()
        with torch.inference_mode():
            out = module(torch.from_numpy(x).to(self.device))
            return out[:b].float().cpu().numpy()

    def generate(self, prompts, max_new_tokens: int, *,
                 temperature: float = 0.0, seed: int | None = None) -> dict:
        """Autoregressive decode of a (B, P) prompt batch through the KV
        cache (``serving/decode.py``) with the current parameters. The
        batch pads to its power-of-two bucket, at least 2, with copies of
        the last prompt. Sampling draws from a CPU ``torch.Generator``
        seeded by ``seed``; ``seed=None`` with temperature > 0 draws fresh
        entropy per call, so identical prompts do not return identical
        "random" samples. Returns ``{"tokens", "logits"}`` for the real
        rows."""
        import os

        from distributed_tensorflow_tpu_torch.serving import decode as dec

        prompts = np.asarray(prompts, dtype=np.int32)
        b = prompts.shape[0]
        bucket = max(self._bucket(b), 2)  # the decode floor: see decode.py
        if bucket > b:
            pad = np.repeat(prompts[-1:], bucket - b, axis=0)
            prompts = np.concatenate([prompts, pad], axis=0)
        with self._swap_lock:
            if self._decode_fns is None:
                self._decode_fns = (dec.make_prefill(self.model),
                                    dec.make_decode_step(self.model))
            fns = self._decode_fns
        module, _ = self.current()
        generator = None
        if temperature > 0.0:
            if seed is None:
                seed = int.from_bytes(os.urandom(4), "little")
            generator = torch.Generator().manual_seed(int(seed))
        out = dec.generate(module, prompts, max_new_tokens,
                           temperature=temperature, generator=generator,
                           prefill_fn=fns[0], step_fn=fns[1])
        return {"tokens": out["tokens"][:b], "logits": out["logits"][:b]}

    # ------------------------------------------------------ hot-reload

    def reload_if_newer(self) -> dict | None:
        """One watch tick: if the directory holds a newer step, restore it
        through the fallback ladder and swap. Returns a report dict, or
        None when there was nothing newer. Never raises on a corrupt newest
        set — the ladder walks back and the engine keeps serving."""
        with self._reload_lock:
            found = latest_checkpoint(self.logdir)
            if found is None or found[1] <= self.step:
                return None
            return self._reload(found[1])

    def _reload(self, step: int) -> dict:
        t0 = time.monotonic()
        serving = self.step
        try:
            out = restore_params_with_fallback(self.logdir, self._template)
        except Exception as e:  # noqa: BLE001 — keep serving what we have
            with self._swap_lock:
                self.counters["reload_failures"] += 1
            print(f"serving reload failed (still serving step {serving}): "
                  f"{type(e).__name__}: {e}")
            return {"swapped": False, "error": str(e), "step": serving}
        ms = (time.monotonic() - t0) * 1e3
        if out is None:
            with self._swap_lock:
                self.counters["reload_failures"] += 1
            return {"swapped": False, "error": "no restorable checkpoint",
                    "step": serving}
        params, rstep, report = out
        if rstep <= serving:
            # the newest set was corrupt; the ladder landed at or below
            # what we already serve
            with self._swap_lock:
                self.counters["last_fallback_depth"] = report.fallback_depth
                self.counters["reload_fallbacks"] += 1
            print(f"serving reload: newest checkpoint (step {step}) failed "
                  f"verification; ladder landed on step {rstep} — still "
                  f"serving step {serving}")
            return {"swapped": False, "step": rstep,
                    "fallback_depth": report.fallback_depth,
                    "reload_ms": ms}
        placed = self._place(params)
        with self._swap_lock:
            self._module = placed
            self._step = rstep
            self.counters["last_fallback_depth"] = report.fallback_depth
            self.counters["reloads"] += 1
            self.counters["last_reload_ms"] = ms
        print(f"serving hot-reload: now serving step {rstep} (restore "
              f"{ms:.1f} ms, fallback depth {report.fallback_depth})")
        return {"swapped": True, "step": rstep, "reload_ms": ms,
                "fallback_depth": report.fallback_depth}

    def stats(self) -> dict:
        with self._swap_lock:
            return {"step": self._step, **self.counters}


class CheckpointWatcher:
    """Polls the logdir every ``interval_s`` and hot-swaps through
    ``engine.reload_if_newer``. ``check_now()`` runs one tick
    synchronously. Each ``start()`` hands its thread a fresh stop event,
    so a restart after ``close()`` launches a live watcher."""

    def __init__(self, engine: InferenceEngine, interval_s: float = 10.0):
        self.engine = engine
        self.interval_s = float(interval_s)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop = threading.Event()
                self._thread = threading.Thread(
                    target=self._loop, args=(self._stop,),
                    name="serve-ckpt-watcher", daemon=True)
                self._thread.start()
        return self

    def check_now(self) -> dict | None:
        return self.engine.reload_if_newer()

    def _loop(self, stop: threading.Event):
        while not stop.wait(self.interval_s):
            try:
                self.engine.reload_if_newer()
            except Exception as e:  # the watcher must outlive bad ticks
                print(f"checkpoint watcher tick failed: {e}")

    def close(self):
        with self._lock:
            self._stop.set()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)
            if thread.is_alive():
                print("checkpoint watcher still inside a reload after 10s; "
                      "abandoning the daemon thread (its stop event is set)")
