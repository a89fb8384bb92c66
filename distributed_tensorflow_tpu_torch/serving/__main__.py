"""Serving entry point:

    python -m distributed_tensorflow_tpu_torch.serving --logdir /tmp/train_logs \\
        --pallas [--bf16] [--serve_port 8000] [--device cuda]

Builds the model the flags describe (``training.loop.build_model_for``),
restores the newest checkpoint's params — written by either package —
through the verified fallback ladder, and serves JSON over HTTP
(server.py routes) with dynamic batching, hot-reload from a checkpoint
watcher, and serving scalars in the logdir's serve_metrics.jsonl.

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
        return {"kind": "lm"}
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

    # f32 means f32 on the card: cuDNN would run f32 convs in TF32 by
    # default, and the JAX reference runs at `highest` precision
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model_for(FLAGS, _dataset_meta(FLAGS))
    engine = InferenceEngine(model, FLAGS.logdir, device=FLAGS.device,
                             max_batch=FLAGS.serve_max_batch)
    print(f"serving step {engine.step} from {FLAGS.logdir} on "
          f"{engine.device} (restore fallback depth "
          f"{engine.restore_report.fallback_depth})")
    logger = MetricsLogger(FLAGS.logdir, job_name="serve",
                           filename="serve_metrics.jsonl")
    metrics = ServingMetrics(logger, engine, name="predict",
                             emit_every=FLAGS.serve_metrics_every)
    batcher = DynamicBatcher(make_predict_runner(engine),
                             group_key=predict_group_key,
                             latency=StreamingHistogram(),
                             on_batch=metrics.on_batch, name="predict",
                             max_batch=FLAGS.serve_max_batch,
                             max_delay_ms=FLAGS.serve_max_delay_ms,
                             queue_depth=FLAGS.serve_queue_depth,
                             default_timeout_ms=FLAGS.serve_timeout_ms)
    client = InProcessClient(predict_batcher=batcher)
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
    server = InferenceServer(engine, client, host=FLAGS.serve_host,
                             port=FLAGS.serve_port)
    print(f"serving on {server.address} (POST /v1/predict; GET /healthz, "
          f"/stats, /metrics)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        if watcher is not None:
            watcher.close()
        client.predict_batcher.close(drain=False)
        server.close()
        metrics.logger.close()
    return 0


if __name__ == "__main__":
    flags.define_flags()
    flags.run(main)
