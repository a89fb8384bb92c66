"""JSON-over-HTTP front end + in-process client for the predict and
generate routes.

The counterpart of ``distributed_tensorflow_tpu/serving/server.py``,
stdlib only (``http.server``):

    POST /v1/predict   {"inputs": [...]}  ONE example       -> {"outputs"}
    POST /v1/generate  {"prompt": [ids], "max_new_tokens",
                        "temperature", "seed"}              -> {"tokens"}
    GET  /healthz                                           -> {"ok", "step"}
    GET  /stats                                             -> counters + quantiles
    GET  /metrics                                           -> full serving JSON

One example per request by design: batching is the server's job. A
``RejectedError`` (queue full, deadline, closed) is 429, bad JSON or a
bad request (an out-of-vocabulary prompt, a budget over the cap) 400, a
request still running at the client's wait 504, anything else 500.

The admin reload route and the memory, KV-page and request-plane blocks
of ``/metrics`` come with later slices.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from distributed_tensorflow_tpu_torch.serving.batcher import (
    DynamicBatcher,
    RejectedError,
)
from distributed_tensorflow_tpu_torch.serving.engine import InferenceEngine


def _result_with_id(fut, wait_s: float):
    """``fut.result`` that stamps the request_id onto a TimeoutError."""
    try:
        return fut.result(wait_s)
    except TimeoutError as e:
        e.request_id = fut.request_id
        raise


class InProcessClient:
    """Typed request surface over the predict and/or generate batcher —
    the engine-side twin of the HTTP routes. Owns the generate route's
    request policy: the default new-token budget and temperature for
    requests that omit them (``--serve_max_new_tokens``,
    ``--serve_temperature``) and the budget cap, above which a request is
    refused (400 on the wire) instead of holding the batch worker."""

    def __init__(self, predict_batcher: DynamicBatcher | None = None,
                 generate_batcher: DynamicBatcher | None = None, *,
                 default_max_new_tokens: int = 16,
                 max_new_tokens_cap: int | None = None,
                 default_temperature: float = 0.0):
        self.predict_batcher = predict_batcher
        self.generate_batcher = generate_batcher
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.max_new_tokens_cap = (None if max_new_tokens_cap is None
                                   else int(max_new_tokens_cap))
        self.default_temperature = float(default_temperature)

    def predict(self, x, timeout_ms: float | None = None,
                wait_s: float = 30.0):
        return self.predict_ex(x, timeout_ms=timeout_ms, wait_s=wait_s)[0]

    def predict_ex(self, x, timeout_ms: float | None = None,
                   wait_s: float = 30.0, request_id: str | None = None):
        """``(outputs, meta)``; meta carries the echoed request_id."""
        if self.predict_batcher is None:
            raise ValueError("this server is not configured for predict")
        fut = self.predict_batcher.submit(np.asarray(x),
                                          timeout_ms=timeout_ms,
                                          request_id=request_id)
        out = _result_with_id(fut, wait_s)
        return out, {"request_id": fut.request_id}

    def generate(self, prompt, max_new_tokens: int | None = None,
                 temperature: float | None = None, seed: int | None = None,
                 timeout_ms: float | None = None, wait_s: float = 60.0):
        return self.generate_ex(prompt, max_new_tokens=max_new_tokens,
                                temperature=temperature, seed=seed,
                                timeout_ms=timeout_ms, wait_s=wait_s)[0]

    def generate_ex(self, prompt, max_new_tokens: int | None = None,
                    temperature: float | None = None,
                    seed: int | None = None,
                    timeout_ms: float | None = None, wait_s: float = 60.0,
                    request_id: str | None = None):
        """``(tokens, meta)``, the generate twin of ``predict_ex``."""
        if self.generate_batcher is None:
            raise ValueError("this server's model does not support generate "
                             "(token decode serves --model lm only)")
        n = (self.default_max_new_tokens if max_new_tokens is None
             else int(max_new_tokens))
        if self.max_new_tokens_cap is not None \
                and n > self.max_new_tokens_cap:
            raise ValueError(f"max_new_tokens={n} exceeds the server cap "
                             f"({self.max_new_tokens_cap})")
        t = (self.default_temperature if temperature is None
             else float(temperature))
        fut = self.generate_batcher.submit(
            np.asarray(prompt, dtype=np.int32), timeout_ms=timeout_ms,
            request_id=request_id, max_new_tokens=n, temperature=t,
            seed=None if seed is None else int(seed))
        out = _result_with_id(fut, wait_s)
        return out, {"request_id": fut.request_id}


def make_predict_runner(engine: InferenceEngine):
    """Batcher runner for the predict route: stack the per-request
    examples, one engine call, unstack."""

    def runner(payloads, opts_list):
        del opts_list
        out = engine.predict(np.stack(payloads))
        return [out[i] for i in range(len(payloads))]

    return runner


def make_generate_runner(engine: InferenceEngine):
    """Batcher runner for the generate route: the requests of one group
    (``generate_group_key``) share their prompt length and decode
    options, so one engine call serves the whole microbatch."""

    def runner(payloads, opts_list):
        o = opts_list[0]
        out = engine.generate(np.stack(payloads),
                              max_new_tokens=o.get("max_new_tokens", 16),
                              temperature=o.get("temperature", 0.0),
                              seed=o.get("seed"))
        return [out["tokens"][i] for i in range(len(payloads))]

    return runner


def generate_group_key(payload, opts):
    """Decode requests batch together only when they share the prompt
    length and the decode options. A request with an explicit seed
    batches alone: its batchmates (and so the bucket) would otherwise
    change its sampled tokens; alone it repeats exactly."""
    if opts.get("seed") is not None:
        return object()  # equal only to itself
    return (len(payload), opts.get("max_new_tokens", 16),
            opts.get("temperature", 0.0))


def predict_group_key(payload, opts):
    """Predict requests batch together only when their example shapes
    stack — one malformed request fails alone, not its whole batch."""
    del opts
    return np.asarray(payload).shape


class ServingMetrics:
    """Cadenced scalar emission through MetricsLogger, installed as the
    batcher's ``on_batch`` hook: every ``emit_every`` batches the queue
    depth, throughput, rejections, reload counters and latency quantiles
    land in the logger's JSONL sink."""

    def __init__(self, logger, engine: InferenceEngine, *,
                 emit_every: int = 50, name: str = ""):
        self.logger = logger
        self.engine = engine
        self.emit_every = int(emit_every)
        self.prefix = f"serve_{name}_" if name else "serve_"
        self._t0 = time.monotonic()
        self._last_count = 0
        self._calls = 0
        self._lock = threading.Lock()

    def on_batch(self, batcher) -> None:
        if self.emit_every <= 0:  # 0 = scalars off
            return
        # cadence on our call count: the hook only runs on success
        with self._lock:
            self._calls += 1
            if self._calls % self.emit_every:
                return
        stats = batcher.stats.as_dict()
        with self._lock:
            dt = time.monotonic() - self._t0
            done = stats["completed"]
            rps = (done - self._last_count) / dt if dt > 0 else 0.0
            self._t0 = time.monotonic()
            self._last_count = done
        p = self.prefix
        reloads = self.engine.counters_snapshot()
        scalars = {
            f"{p}queue_depth": float(stats["queue_depth"]),
            f"{p}throughput_rps": rps,
            f"{p}rejected_full": float(stats["rejected_full"]),
            f"{p}rejected_deadline": float(stats["rejected_deadline"]),
            f"{p}reloads": float(reloads["reloads"]),
            f"{p}reload_failures": float(reloads["reload_failures"]),
        }
        if batcher.latency is not None:
            scalars.update(batcher.latency.summary(f"{p}latency_ms_"))
        if self.logger is not None:
            self.logger.scalars(stats["batches"], scalars)
            self.logger.flush()


class _Handler(BaseHTTPRequestHandler):
    server_version = "dtt-serving-torch/1.0"

    def _send(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet: metrics carry the story
        pass

    def do_GET(self):
        srv: InferenceServer = self.server.serving  # type: ignore[attr-defined]
        if self.path == "/healthz":
            health = srv.healthz()
            self._send(200 if health["ok"] else 503, health)
        elif self.path == "/metrics":
            self._send(200, srv.metrics())
        elif self.path == "/stats":
            self._send(200, srv.stats())
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        srv: InferenceServer = self.server.serving  # type: ignore[attr-defined]
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": f"bad JSON: {e}"})
            return
        rid = req.get("request_id") if isinstance(req, dict) else None
        try:
            if self.path == "/v1/predict":
                out, meta = srv.client.predict_ex(
                    np.asarray(req["inputs"]),
                    timeout_ms=req.get("timeout_ms"), request_id=rid)
                self._send(200, {"outputs": np.asarray(out).tolist(),
                                 **meta})
            elif self.path == "/v1/generate":
                toks, meta = srv.client.generate_ex(
                    req["prompt"], max_new_tokens=req.get("max_new_tokens"),
                    temperature=req.get("temperature"),
                    seed=req.get("seed"), timeout_ms=req.get("timeout_ms"),
                    request_id=rid)
                self._send(200, {"tokens": np.asarray(toks).tolist(),
                                 **meta})
            else:
                self._send(404, {"error": f"no route {self.path}"})
        except RejectedError as e:
            self._send(429, {"error": e.reason, "rejected": True,
                             "request_id": e.request_id or rid})
        except (KeyError, ValueError) as e:
            self._send(400, {"error": f"{type(e).__name__}: {e}",
                             "request_id": rid})
        except TimeoutError as e:
            self._send(504, {"error": "request timed out in flight",
                             "request_id": getattr(e, "request_id",
                                                   None) or rid})
        except Exception as e:  # noqa: BLE001 — the wire must answer
            self._send(500, {"error": f"{type(e).__name__}: {e}",
                             "request_id": rid})


class InferenceServer:
    """ThreadingHTTPServer wrapper owning the route -> batcher wiring,
    with the replica-health accounting a router polls."""

    def __init__(self, engine: InferenceEngine, client: InProcessClient,
                 host: str = "127.0.0.1", port: int = 8000):
        self.engine = engine
        self.client = client
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.serving = self  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None
        self._t0 = time.monotonic()
        self._health_lock = threading.Lock()
        self._health_last_t = self._t0
        self._health_was_ok = True
        self._down_s = 0.0
        self._p99_prev: dict[str, float] = {}
        self._sat_streak: dict[str, int] = {}

    @property
    def address(self) -> str:
        h, p = self.httpd.server_address[:2]
        return f"http://{h}:{p}"

    def _batchers(self):
        if self.client.predict_batcher is not None:
            yield "predict", self.client.predict_batcher
        if self.client.generate_batcher is not None:
            yield "generate", self.client.generate_batcher

    def healthz(self) -> dict:
        """Liveness (every batcher still has a worker), the served params
        version and the queue depth. ``ok: false`` maps to HTTP 503."""
        closed = [name for name, b in self._batchers() if b.closed]
        depth = sum(b.stats.as_dict()["queue_depth"]
                    for _, b in self._batchers())
        return {"ok": not closed,
                "step": self.engine.step,
                "params_step": self.engine.step,
                "closed_batchers": closed,
                "queue_depth": depth,
                "device": str(self.engine.device),
                "uptime_s": round(time.monotonic() - self._t0, 3)}

    def _goodput_uptime_pct(self) -> float:
        """Percent of uptime not spent with a closed batcher, integrated
        lazily: each poll bills the time since the previous poll to the
        state observed then."""
        now = time.monotonic()
        ok_now = not any(b.closed for _, b in self._batchers())
        with self._health_lock:
            dt = max(0.0, now - self._health_last_t)
            if not self._health_was_ok:
                self._down_s += dt
            self._health_last_t = now
            self._health_was_ok = ok_now
            uptime = max(now - self._t0, 1e-9)
            return round(100.0 * (1.0 - min(self._down_s / uptime, 1.0)), 4)

    def _health_block(self, name: str, stats: dict, b) -> dict:
        """Per-batcher trend for a router: p99 against the previous poll's
        (rising/flat/falling at +25%/-20%) and the saturation streak."""
        p99 = b.latency.quantile(0.99) if b.latency is not None else None
        saturated = stats["queue_depth"] >= b.queue_depth
        with self._health_lock:
            prev = self._p99_prev.get(name)
            if p99 is not None:
                self._p99_prev[name] = p99
            streak = (self._sat_streak.get(name, 0) + 1) if saturated else 0
            self._sat_streak[name] = streak
        if p99 is None or prev is None or prev <= 0:
            trend = "flat"
        elif p99 > prev * 1.25:
            trend = "rising"
        elif p99 < prev * 0.8:
            trend = "falling"
        else:
            trend = "flat"
        return {"p99_ms": p99, "p99_prev_ms": prev, "p99_trend": trend,
                "saturation_streak": streak, "closed": b.closed}

    def metrics(self) -> dict:
        """Counters, latency quantiles, backpressure state and the
        params-version/reload story, per batcher."""
        reloads = self.engine.counters_snapshot()
        out = {
            "params_step": self.engine.step,
            "reloads": reloads["reloads"],
            "reload_failures": reloads["reload_failures"],
            "reload_fallbacks": reloads["reload_fallbacks"],
            "last_reload_ms": reloads["last_reload_ms"],
            "last_fallback_depth": reloads["last_fallback_depth"],
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "goodput_uptime_pct": self._goodput_uptime_pct(),
        }
        for name, b in self._batchers():
            stats = b.stats.as_dict()
            entry = dict(stats)
            if b.latency is not None:
                entry["latency_ms"] = b.latency.summary()
            entry["backpressure"] = {
                "queue_depth": stats["queue_depth"],
                "queue_limit": b.queue_depth,
                "saturated": stats["queue_depth"] >= b.queue_depth,
                "closed": b.closed,
                "rejected_full": stats["rejected_full"],
            }
            entry["health"] = self._health_block(name, stats, b)
            out[name] = entry
        return out

    def stats(self) -> dict:
        out = {"engine": self.engine.stats()}
        for name, b in self._batchers():
            out[f"{name}_batcher"] = b.stats.as_dict()
            if b.latency is not None:
                out[f"{name}_batcher"].update(
                    b.latency.summary("latency_ms_"))
        return out

    def start_background(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="serve-http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
