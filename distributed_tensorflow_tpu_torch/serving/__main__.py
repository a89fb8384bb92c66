"""Serving entry point:

    python -m distributed_tensorflow_tpu_torch.serving --logdir /tmp/train_logs \\
        --pallas [--bf16] [--serve_port 8000] [--device cuda]
    python -m distributed_tensorflow_tpu_torch.serving --logdir /tmp/lm_logs \\
        --model lm --dataset lm --seq_len 4096 --vocab_size 64 \\
        --d_model 256 --num_heads 4 --num_blocks 4 [--bf16] \\
        [--serve_scheduler continuous --serve_slots 12]

Builds the model the flags describe (``training.loop.build_model_for``),
restores the newest checkpoint's params — written by either package —
through the verified fallback ladder, and serves JSON over HTTP
(server.py routes) with dynamic batching, hot-reload from a checkpoint
watcher, and serving scalars in the logdir's serve_metrics.jsonl. With
``--model lm`` it also answers ``POST /v1/generate`` through the KV-cache
decode (``serving/decode.py``; ``--serve_max_new_tokens``,
``--serve_temperature``): whole-batch microbatches by default, or with
``--serve_scheduler continuous`` the paged-KV slot scheduler
(``serving/continuous.py``; ``--serve_slots``, ``--serve_kv_page``,
``--serve_kv_pages``), one CUDA graph replay an iteration on a card.

At start-up it configures fault injection (``--fault_spec``), the
telemetry spine with job name ``serve`` (``spans-serve-0.jsonl`` and
``flightrec-serve-0.jsonl`` in the logdir; ``--telemetry``,
``--watchdog_s``) and the request plane (``--slo_*``, ``--reqtrace_*``).

Runs on ``--device cuda`` (the default) and raises without a card; pass
``--device cpu`` to serve on the CPU.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch import flags
from distributed_tensorflow_tpu_torch.flags import FLAGS


def _dataset_meta(FLAGS) -> dict:
    """The dataset facts model construction needs, without loading data."""
    if FLAGS.dataset in ("mnist", "fashion_mnist"):
        return {"image_size": 28, "channels": 1, "num_classes": 10}
    if FLAGS.dataset == "cifar10":
        return {"image_size": 32, "channels": 3, "num_classes": 10}
    if FLAGS.dataset == "lm":
        return {"kind": "lm", "seq_len": FLAGS.seq_len,
                "vocab_size": FLAGS.vocab_size,
                "num_classes": FLAGS.vocab_size}
    raise ValueError(f"unknown --dataset {FLAGS.dataset!r}")


def build_serving_stack(FLAGS):
    """(engine, client, watcher, metrics) from parsed flags — the testable
    core of main()."""
    from distributed_tensorflow_tpu_torch.serving.batcher import (
        DynamicBatcher,
    )
    from distributed_tensorflow_tpu_torch.serving.engine import (
        CheckpointWatcher,
        InferenceEngine,
    )
    from distributed_tensorflow_tpu_torch.serving.server import (
        InProcessClient,
        ServingMetrics,
        generate_group_key,
        make_generate_runner,
        make_predict_runner,
        predict_group_key,
    )
    from distributed_tensorflow_tpu_torch.training.loop import (
        build_model_for,
    )
    from distributed_tensorflow_tpu_torch.utils.metrics import (
        MetricsLogger,
        StreamingHistogram,
    )

    from distributed_tensorflow_tpu_torch.serving import reqtrace
    from distributed_tensorflow_tpu_torch.utils import faults, telemetry

    # f32 means f32 on the card: cuDNN would run f32 convs in TF32 by
    # default, and the JAX reference runs at `highest` precision
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    faults.configure_from_flags(FLAGS)
    # job "serve": a server pointed at the trainer's logdir writes its own
    # spans-serve-N.jsonl and flightrec-serve-N.jsonl
    telemetry.configure_from_flags(FLAGS, job_name="serve")
    reqtrace.configure_from_flags(FLAGS)
    model = build_model_for(FLAGS, _dataset_meta(FLAGS))
    engine = InferenceEngine(model, FLAGS.logdir, device=FLAGS.device,
                             max_batch=FLAGS.serve_max_batch)
    print(f"serving step {engine.step} from {FLAGS.logdir} on "
          f"{engine.device} (restore fallback depth "
          f"{engine.restore_report.fallback_depth})")
    logger = MetricsLogger(FLAGS.logdir, job_name="serve",
                           filename="serve_metrics.jsonl")
    # one ServingMetrics and latency histogram per batcher: the quantiles
    # must not mix routes
    common = dict(max_batch=FLAGS.serve_max_batch,
                  max_delay_ms=FLAGS.serve_max_delay_ms,
                  queue_depth=FLAGS.serve_queue_depth,
                  default_timeout_ms=FLAGS.serve_timeout_ms)
    metrics = ServingMetrics(logger, engine, name="predict",
                             emit_every=FLAGS.serve_metrics_every)
    batcher = DynamicBatcher(make_predict_runner(engine),
                             group_key=predict_group_key,
                             latency=StreamingHistogram(),
                             on_batch=metrics.on_batch, name="predict",
                             **common)
    generate_b = None
    if FLAGS.model == "lm":
        gen_metrics = ServingMetrics(logger, engine, name="generate",
                                     emit_every=FLAGS.serve_metrics_every)
        if FLAGS.serve_scheduler == "continuous":
            from distributed_tensorflow_tpu_torch.serving.continuous import (
                ContinuousBatcher,
                EngineSlotBackend,
            )

            backend = EngineSlotBackend(
                engine, n_slots=FLAGS.serve_slots,
                page_size=FLAGS.serve_kv_page,
                num_pages=FLAGS.serve_kv_pages)
            generate_b = ContinuousBatcher(
                backend, queue_depth=FLAGS.serve_queue_depth,
                default_timeout_ms=FLAGS.serve_timeout_ms,
                latency=StreamingHistogram(),
                on_iteration=gen_metrics.on_batch, name="generate")
        else:
            generate_b = DynamicBatcher(make_generate_runner(engine),
                                        group_key=generate_group_key,
                                        latency=StreamingHistogram(),
                                        on_batch=gen_metrics.on_batch,
                                        name="generate", **common)
    # both batchers ride the constructor: the HTTP handler threads read
    # the client once the server starts
    client = InProcessClient(
        predict_batcher=batcher, generate_batcher=generate_b,
        default_max_new_tokens=FLAGS.serve_max_new_tokens,
        max_new_tokens_cap=FLAGS.serve_max_new_tokens,
        default_temperature=FLAGS.serve_temperature)
    watcher = None
    if FLAGS.serve_reload_secs > 0:
        watcher = CheckpointWatcher(engine, FLAGS.serve_reload_secs)
    return engine, client, watcher, metrics


def main(argv):
    from distributed_tensorflow_tpu_torch.serving.server import (
        InferenceServer,
    )

    engine, client, watcher, metrics = build_serving_stack(FLAGS)
    if watcher is not None:
        watcher.start()
    server = InferenceServer(
        engine, client, host=FLAGS.serve_host, port=FLAGS.serve_port,
        hbm_headroom_floor_pct=FLAGS.serve_hbm_headroom_pct)
    routes = "/v1/predict, /v1/generate" if client.generate_batcher \
        else "/v1/predict"
    print(f"serving on {server.address} (POST {routes}, /admin/reload; "
          f"GET /healthz, /stats, /metrics)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        if watcher is not None:
            watcher.close()
        for b in (client.predict_batcher, client.generate_batcher):
            if b is not None:
                b.close(drain=False)
        server.close()
        metrics.logger.close()
        # the last flush: a short-lived server must not lose its spans
        from distributed_tensorflow_tpu_torch.utils import telemetry

        telemetry.get_tracer().flush()
    return 0


if __name__ == "__main__":
    flags.define_flags()
    flags.run(main)
