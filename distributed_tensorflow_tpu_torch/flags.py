"""Flags for the port's serving entry point, with the reference's
``tf.app.flags`` surface.

The counterpart of ``distributed_tensorflow_tpu/flags.py``: the same
lazily-parsed ``FLAGS`` singleton, ``DEFINE_*`` functions, parse-time
validators and ``run(main)``, holding only the flags the predict path
reads, plus the port-only ``--device``. Flag names and meanings match the
JAX package's, so one command line serves either package.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Callable


class _FlagValues:
    """Lazy-parsing flag namespace (attribute access parses argv once)."""

    def __init__(self):
        self.__dict__["_defs"] = {}  # name -> (type_fn, default, help)
        self.__dict__["_values"] = None
        self.__dict__["_validators"] = []  # fns(values) run after parse

    def _define(self, name: str, default, help_str: str, type_fn: Callable):
        if self._values is not None:
            self._values[name] = default
        self._defs[name] = (type_fn, default, help_str)

    def _register_validator(self, fn: Callable):
        """Cross-flag check run at parse time: ``fn(values)`` raises
        ValueError with an actionable message. Idempotent."""
        if fn not in self._validators:
            self._validators.append(fn)

    def _parse(self, argv=None):
        parser = argparse.ArgumentParser(allow_abbrev=False)
        for name, (type_fn, default, help_str) in self._defs.items():
            if type_fn is bool:
                parser.add_argument(f"--{name}", type=_parse_bool,
                                    default=default, nargs="?", const=True,
                                    help=help_str)
            else:
                parser.add_argument(f"--{name}", type=type_fn,
                                    default=default, help=help_str)
        ns, extra = parser.parse_known_args(
            sys.argv[1:] if argv is None else list(argv))
        self.__dict__["_values"] = vars(ns)
        for check in self._validators:
            check(self._values)
        return extra

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        if self._values is None:
            self._parse()
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(f"unknown flag {name!r}") from None

    def __setattr__(self, name: str, value: Any):
        if self._values is None:
            self._parse()
        self._values[name] = value

    def _reset(self):
        """Testing hook: forget parsed values (definitions stay)."""
        self.__dict__["_values"] = None


def _parse_bool(s):
    if isinstance(s, bool):
        return s
    if str(s).lower() in ("1", "true", "t", "yes", "y"):
        return True
    if str(s).lower() in ("0", "false", "f", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"invalid boolean {s!r}")


FLAGS = _FlagValues()


def DEFINE_string(name: str, default: str | None, help_str: str = ""):
    FLAGS._define(name, default, help_str, str)


def DEFINE_integer(name: str, default: int | None, help_str: str = ""):
    FLAGS._define(name, default, help_str, int)


def DEFINE_float(name: str, default: float | None, help_str: str = ""):
    FLAGS._define(name, default, help_str, float)


def DEFINE_boolean(name: str, default: bool | None, help_str: str = ""):
    FLAGS._define(name, default, help_str, bool)


def run(main: Callable | None = None, argv=None):
    """Parse flags, call ``main(unparsed_argv)``, exit with its return
    code. A validator rejection exits 2 with the message on stderr."""
    try:
        extra = FLAGS._parse(argv)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(2)
    main = main or sys.modules["__main__"].main
    sys.exit(main([sys.argv[0]] + extra))


def define_flags():
    """The predict path's flags (same names, defaults and meanings as the
    JAX package's) plus ``--device``. Idempotent."""
    if "device" in FLAGS._defs:
        return
    DEFINE_string("model", "deep_cnn", "Model architecture (ported: "
                  "deep_cnn)")
    DEFINE_string("dataset", "mnist", "Dataset the model was trained on: "
                  "mnist|fashion_mnist|cifar10 (sets the input shape)")
    DEFINE_boolean("bf16", False, "Run matmuls/convs in bfloat16")
    DEFINE_boolean("pallas", False, "Run the deep_cnn wd1 layer through "
                   "the hand-written CUDA kernel (ops/fused_dense.py); the "
                   "name is the JAX package's, where it selects the Pallas "
                   "kernel (deep_cnn only)")
    DEFINE_string("logdir", "/tmp/train_logs", "Checkpoint/metrics "
                  "directory (reference default)")
    DEFINE_string("device", "cuda", "Torch device to serve on; there is no "
                  "fallback: without a card, pass --device cpu")
    DEFINE_string("serve_host", "127.0.0.1", "Bind address for the "
                  "serving HTTP front end")
    DEFINE_integer("serve_port", 8000, "Port for the serving HTTP front "
                   "end (0 = ephemeral)")
    DEFINE_integer("serve_max_batch", 8, "Largest microbatch the dynamic "
                   "batcher assembles; must be a power of two (batches "
                   "pad to power-of-two buckets)")
    DEFINE_float("serve_max_delay_ms", 5.0, "Longest the batcher holds "
                 "the oldest queued request while waiting to fill a batch")
    DEFINE_integer("serve_queue_depth", 64, "Bounded request queue; a full "
                   "queue rejects new requests immediately. Must hold at "
                   "least one full --serve_max_batch")
    DEFINE_float("serve_timeout_ms", 1000.0, "Default per-request "
                 "deadline: a request still queued past it completes with "
                 "a deadline rejection")
    DEFINE_float("serve_reload_secs", 10.0, "Checkpoint-watcher poll "
                 "cadence (0 = watching off)")
    DEFINE_integer("serve_metrics_every", 50, "Emit serving scalars every "
                   "this many microbatches (0 = off)")
    FLAGS._register_validator(_validate_flags)


def _validate_flags(values: dict):
    model = values.get("model")
    if values.get("pallas") and model != "deep_cnn":
        raise ValueError(
            f"--pallas fuses the deep_cnn FC stack's dominant matmul; "
            f"with --model={model} it would silently change nothing — "
            f"drop it or use --model=deep_cnn")
    mb = int(values["serve_max_batch"])
    if mb < 1:
        raise ValueError(f"--serve_max_batch={mb} must be >= 1")
    if mb & (mb - 1):
        raise ValueError(f"--serve_max_batch={mb} must be a power of two — "
                         f"batches pad to power-of-two buckets")
    qd = int(values["serve_queue_depth"])
    if qd < mb:
        raise ValueError(f"--serve_queue_depth={qd} must hold at least one "
                         f"full --serve_max_batch={mb}")
    if float(values["serve_max_delay_ms"]) < 0:
        raise ValueError("--serve_max_delay_ms must be >= 0")
    if float(values["serve_timeout_ms"]) <= 0:
        raise ValueError("--serve_timeout_ms must be > 0")
    port = int(values["serve_port"])
    if not 0 <= port <= 65535:
        raise ValueError(f"--serve_port={port} must be in [0, 65535] "
                         f"(0 = ephemeral)")
    if float(values["serve_reload_secs"]) < 0:
        raise ValueError("--serve_reload_secs must be >= 0")
    if int(values["serve_metrics_every"]) < 0:
        raise ValueError("--serve_metrics_every must be >= 0 (0 = off)")
