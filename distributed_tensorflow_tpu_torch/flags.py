"""Flags for the port's entry points, with the reference's
``tf.app.flags`` surface.

The counterpart of ``distributed_tensorflow_tpu/flags.py``: the same
lazily-parsed ``FLAGS`` singleton, ``DEFINE_*`` functions, parse-time
validators and ``run(main)``. ``define_flags`` holds the flags the serving
routes (predict, generate), the continuous scheduler, the serving
telemetry, request plane and fault injection, and model construction
read, plus the port-only ``--device``; ``define_reference_flags`` adds
the reference's 10 flags and the flags the local, sync and ps training
loops read.
Names, defaults and meanings match the JAX package's, so one command line
drives either package. Flags of paths not ported yet are not defined, and
``run`` rejects them instead of ignoring them.
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

# the request plane's flag defaults, shared by the DEFINE_* calls and the
# telemetry=false checks, so a retuned default cannot start rejecting a
# plain --telemetry=false
_REQTRACE_RING_DEFAULT = 512
_REQTRACE_EXEMPLARS_DEFAULT = 5


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
    unknown = [a for a in extra if a.startswith("-")]
    if unknown:
        print(f"error: unknown flag(s) {unknown}: not defined here, or "
              f"their path is not yet ported to "
              f"distributed_tensorflow_tpu_torch", file=sys.stderr)
        sys.exit(2)
    main = main or sys.modules["__main__"].main
    sys.exit(main([sys.argv[0]] + extra))


def define_flags():
    """The serving routes' and the models' flags (same names, defaults and
    meanings as the JAX package's) plus ``--device``. Idempotent."""
    if "device" in FLAGS._defs:
        return
    DEFINE_string("model", "deep_cnn", "Model architecture: "
                  "deep_cnn|mlp|resnet20|resnet32|transformer|lm (mlp "
                  "reads --hidden_units; lm is the causal next-token "
                  "family and requires --dataset lm)")
    DEFINE_integer("hidden_units", 100, "Number of units in the hidden layer of the NN")
    DEFINE_string("dataset", "mnist", "Dataset the model was trained on: "
                  "mnist|fashion_mnist|cifar10|lm (sets the input shape; "
                  "lm: procedural associative-recall token sequences for "
                  "the causal-LM family, shaped by --seq_len/--vocab_size)")
    DEFINE_integer("seq_len", 256, "Context length for --dataset lm "
                   "(tokens per training sequence; targets are the "
                   "sequence shifted one token)")
    DEFINE_integer("vocab_size", 64, "Vocabulary for --dataset lm")
    DEFINE_integer("d_model", 128, "Transformer width (transformer|lm)")
    DEFINE_integer("num_heads", 4, "Attention heads (transformer|lm)")
    DEFINE_integer("num_blocks", 2, "Transformer blocks (transformer|lm)")
    DEFINE_integer("attn_block", 0, "If > 0, attention streams over "
                   "key/value blocks of this many tokens (flash: online "
                   "softmax forward, recomputing backward; O(S*block) peak "
                   "memory instead of the dense O(S^2) scores). lm only")
    DEFINE_integer("ce_block", 0, "If > 0, the LM loss head streams over "
                   "row blocks of this many tokens (the (B,S,V) float32 "
                   "logits never exist; O(block*V) peak in both passes). "
                   "lm only")
    DEFINE_boolean("remat", False, "Recompute each transformer block in "
                   "the backward pass (torch.utils.checkpoint): activation "
                   "memory drops to one block's worth for one more forward")
    DEFINE_integer("moe_experts", 0, "If > 0, the LM's MLPs become "
                   "top-1 Switch mixture-of-experts layers with this "
                   "many experts (ops/moe.py); the training loss adds "
                   "--moe_aux times the load-balance term")
    DEFINE_float("moe_capacity", 1.25, "Per-expert token capacity "
                 "factor (tokens beyond ceil(cf*T/E) drop to the "
                 "residual stream — Switch semantics)")
    DEFINE_float("moe_aux", 0.01, "Load-balance auxiliary loss "
                 "coefficient for --moe_experts")
    DEFINE_boolean("expert_parallel", False, "Shard the MoE experts over "
                   "the mesh's model axis (the JAX package's "
                   "parallel/expert_parallel.py); not yet ported, so "
                   "setting it raises")
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
    DEFINE_integer("serve_max_new_tokens", 32, "Default (and cap) for "
                   "generate requests' new-token budget; prompt + budget "
                   "must fit the model's context window")
    DEFINE_float("serve_temperature", 0.0, "Default sampling temperature "
                 "for generate requests (0 = greedy)")
    DEFINE_string("serve_scheduler", "whole_batch", "Generate-route "
                  "scheduler: 'whole_batch' (DynamicBatcher: one "
                  "microbatch committed for its entire generation) or "
                  "'continuous' (iteration-level slot scheduler over a "
                  "paged KV cache, serving/continuous.py: requests "
                  "admit and retire between decode steps, on a card one "
                  "CUDA graph replay a step; greedy tokens equal "
                  "whole_batch's but at near ties). Continuous serves "
                  "--model lm on one device")
    DEFINE_integer("serve_slots", 4, "Continuous scheduler: fixed number "
                   "of batch slots (concurrent in-flight generations). "
                   "Must be >= 2 (slot width >= 2 keeps the decode "
                   "contractions GEMMs, the floor the whole-batch decode "
                   "keeps too)")
    DEFINE_integer("serve_kv_page", 16, "Continuous scheduler: tokens per "
                   "KV-cache page; must divide --seq_len (a slot's "
                   "logical pages tile the context window exactly)")
    DEFINE_integer("serve_kv_pages", 0, "Continuous scheduler: physical KV "
                   "pages in the pool. 0 = full provisioning (serve_slots "
                   "* seq_len / serve_kv_page: every slot can hold a "
                   "max-length request); smaller pools oversubscribe "
                   "slots against pages and admission gates on the page "
                   "commitment. Must hold at least one full-context "
                   "request (seq_len / serve_kv_page)")
    DEFINE_float("serve_hbm_headroom_pct", 0.0, "Drain floor: /healthz "
                 "turns 503 (ok=false) when the continuous scheduler's "
                 "uncommitted KV pages fall below this percent of the "
                 "pool, so a router drains the server before admissions "
                 "fail. 0 = off. The port has no device-memory meter "
                 "yet, so the floor judges the KV pool only")
    DEFINE_float("slo_p99_ms", 0.0, "Serving latency SLO (the request "
                 "plane, serving/reqtrace.py): a request is compliant "
                 "when it completes ok within this many milliseconds. "
                 "Arms the error-budget ledger: the /metrics slo block "
                 "(compliant_pct, budget_remaining, fast/slow burn "
                 "rates) and the /healthz 503 on a fast-burn breach. "
                 "0 = SLO accounting off (phase timelines and tail "
                 "attribution still run)")
    DEFINE_float("slo_target_pct", 99.0, "The SLO compliance target: this "
                 "percent of requests are promised within --slo_p99_ms; "
                 "the remainder is the error budget the burn rates are "
                 "measured against. Must be in (50, 100]; only "
                 "meaningful with --slo_p99_ms > 0")
    DEFINE_integer("reqtrace_ring", _REQTRACE_RING_DEFAULT, "Bounded "
                   "per-request audit ring (the request plane): how many "
                   "finished request summaries the server keeps for the "
                   "/metrics tail exemplars")
    DEFINE_integer("reqtrace_exemplars", _REQTRACE_EXEMPLARS_DEFAULT,
                   "How many worst live exemplars (request_id + phase "
                   "breakdown, by total latency) the /metrics tail block "
                   "names; must be in [1, 64]")
    DEFINE_boolean("telemetry", True, "The observability spine "
                   "(utils/telemetry.py): span tracing into "
                   "<logdir>/spans-serve-<N>.jsonl, the crash flight "
                   "recorder (<logdir>/flightrec-serve-<N>.jsonl) and the "
                   "request plane. =false disables recording entirely "
                   "(request ids still mint and echo). Read by the "
                   "serving entry point; the training loop's spans and "
                   "step-time scalars under it are not ported yet")
    DEFINE_float("watchdog_s", 0.0, "If > 0, arm a hang watchdog around "
                 "every serving batch and scheduler iteration: one still "
                 "incomplete after this many seconds dumps all-thread "
                 "stacks, the last spans and its context to stderr and "
                 "the flight recorder. 0 = off. The training loop's "
                 "watchdog around steps and collectives is not ported "
                 "yet: the training entry refuses > 0")
    DEFINE_boolean("watchdog_abort", False, "After a watchdog report, "
                   "hard-exit the process (status 124) instead of "
                   "waiting on. Requires --watchdog_s > 0")
    DEFINE_integer("flightrec_events", 512, "Flight-recorder ring length: "
                   "how many recent spans/scalars/notes the crash "
                   "postmortem (flightrec-<host>.jsonl) holds")
    DEFINE_string("fault_spec", "", "Deterministic fault injection "
                  "(utils/faults.py): comma-separated rules, each "
                  "point[:key=value]... — e.g. 'serve_batch:mode=error', "
                  "'serve_reload:mode=torn_file'. Empty (default) injects "
                  "nothing; the DTT_FAULT_SPEC env var is the fallback "
                  "for subprocesses. Every point but 'preempt' is wired; "
                  "the training entry refuses 'preempt'")
    FLAGS._register_validator(_validate_flags)
    FLAGS._register_validator(_validate_serving_scheduler_flags)
    FLAGS._register_validator(_validate_telemetry_flags)
    FLAGS._register_validator(_validate_reqtrace_flags)
    FLAGS._register_validator(_validate_fault_spec)


def define_reference_flags():
    """The reference's 10-flag surface (MNISTDist.py:13-31) and the flags
    the local, sync and ps training loops read, with the JAX package's names,
    defaults and validators, plus the predict path's flags
    (``define_flags``). Idempotent."""
    if "job_name" in FLAGS._defs:
        return
    define_flags()
    # --- reference flags, same names/defaults/meanings ---
    DEFINE_string("data_dir", "/tmp/mnist-data", "Directory for string mnist data")
    DEFINE_string("ps_hosts", "", "Comma-separated list of hostname:port pairs")
    DEFINE_string("worker_hosts", "", "Comma-separated list of hostname:port pairs")
    DEFINE_string("job_name", "", "One of 'ps', 'worker'")
    DEFINE_integer("task_index", 0, "Index of task within the job")
    DEFINE_integer("batch_size", 128, "Training batchsize")
    DEFINE_integer("training_iter", 10000, "Training iteration")
    DEFINE_float("learning_rate", 0.001, "Learning rate")
    DEFINE_integer("display_step", 100, "display step")
    # --- the JAX package's extensions that the training loops read
    DEFINE_string("mode", "auto", "Parallel mode: auto|local|sync|ps. auto "
                  "= 'ps' roles when --ps_hosts is set, sync when "
                  "--worker_hosts lists more than one worker, else local. "
                  "Sync runs one process per device (--task_index, "
                  "--device cuda:<i>) in a torch.distributed group served "
                  "by --worker_hosts[0]; ps runs --job_name=ps|worker "
                  "against the --ps_hosts parameter servers")
    DEFINE_string("optimizer", "sgd", "Optimizer: sgd|momentum|adam "
                  "(reference: sgd)")
    DEFINE_float("weight_decay", 0.0, "Decoupled weight decay: the update "
                 "subtracts lr*wd*param alongside the gradient step (AdamW "
                 "semantics for adam; classic L2 for plain sgd)")
    DEFINE_float("keep_prob", 0.75, "Dropout keep probability during "
                 "training. The reference defines DROPOUT=0.75 but feeds "
                 "1.0 (disabled); this build applies it")
    DEFINE_integer("save_model_secs", 600, "Checkpoint cadence in seconds "
                   "(reference default)")
    DEFINE_integer("max_to_keep", 5, "Checkpoints retained before GC (TF "
                   "Saver's default); older ones are deleted")
    DEFINE_integer("seed", 0, "PRNG seed")
    DEFINE_boolean("test_eval", True, "Evaluate on the test split at the "
                   "end (the reference never does; targets require it)")
    DEFINE_boolean("eval_only", False, "Restore the latest checkpoint from "
                   "--logdir and evaluate the full test split — no training")
    DEFINE_integer("eval_step", 0, "If > 0, also evaluate on the FULL test "
                   "split every this many steps. 0 = end-of-run only")
    DEFINE_integer("validation_size", 0, "Examples held out of the train "
                   "split as a validation DataSet (0 = none, reference "
                   "behavior); with --eval_step the periodic evals run on it")
    DEFINE_boolean("raw_input", False, "Feed uint8 images + int32 labels "
                   "and normalize on the device (4x less host->device "
                   "traffic)")
    DEFINE_float("clip_norm", 0.0, "If > 0, clip gradients to this global "
                 "L2 norm before the optimizer update")
    DEFINE_string("lr_schedule", "constant", "Learning-rate schedule: "
                  "constant|cosine|linear|exponential (reference: "
                  "constant). Decays over --decay_steps from "
                  "--learning_rate")
    DEFINE_integer("warmup_steps", 0, "Linear learning-rate warmup steps "
                   "before --lr_schedule takes over (0 = none)")
    DEFINE_integer("decay_steps", 0, "Schedule decay horizon in steps (0 = "
                   "the full --training_iter budget)")
    DEFINE_float("decay_rate", 0.96, "Decay factor per --decay_steps for "
                 "--lr_schedule=exponential")
    DEFINE_boolean("augment", False, "Data augmentation on the device, "
                   "inside the train step: zero-pad by --augment_pad, "
                   "random crop back, and, for 3-channel natural images "
                   "only, random horizontal flip (digits are never "
                   "mirrored). Host-fed, sync and --device_data paths")
    DEFINE_integer("augment_pad", 4, "Padding for --augment's random crop")
    DEFINE_integer("accum_steps", 1, "Gradient accumulation: split each "
                   "batch into this many equal microbatches, one backward "
                   "pass each, average, then one optimizer update")
    DEFINE_boolean("device_data", False, "Stage the train split on the "
                   "device once and draw each batch there (no batch crosses "
                   "from the host while training); on a card each step is "
                   "one replay of a CUDA graph, --device_chunk replays per "
                   "host iteration. Training batches are sampled with "
                   "replacement rather than the reference's shuffled-epoch "
                   "walk; display-step evals keep the reference's "
                   "semantics on one host batch")
    DEFINE_integer("device_chunk", 50, "Steps per chunk in --device_data "
                   "mode (clamped to divide display_step)")
    DEFINE_integer("coord_steps", 50, "Multi-process coordination cadence "
                   "in steps: sync-mode processes agree on a stop with "
                   "one tiny collective every this many steps (worst-case "
                   "stop latency = this many extra steps)")
    DEFINE_integer("init_retries", 8, "Bounded retries around "
                   "torch.distributed.init_process_group for a worker "
                   "relaunched after a crash (worker 0 may still be coming "
                   "back); linear backoff of --init_backoff_s per attempt, "
                   "loud failure when exhausted. 0 = fail on the first "
                   "refusal")
    DEFINE_float("init_backoff_s", 2.0, "Backoff unit (seconds) between "
                 "--init_retries attempts; attempt k waits k*this, capped "
                 "at 30s")
    DEFINE_float("init_timeout_s", 0.0, "Per-attempt cap (seconds) on "
                 "init_process_group's own wait for the store (0 = the "
                 "library default)")
    DEFINE_boolean("shard_data", False, "Give each worker a disjoint data "
                   "shard (reference: every worker samples the full "
                   "dataset); read by the ps mode's workers")
    DEFINE_string("ps_wire", "f32", "PS-mode transport precision: f32 "
                  "(exact, reference parity) or bf16 — every pulled param "
                  "and pushed grad moves at half width over BOTH the TCP "
                  "wire and the host<->card link (ps-side master params "
                  "stay f32; the worker widens params and narrows grads "
                  "on the card)")
    DEFINE_boolean("ps_prefetch", True, "PS mode, full-pull cycle only "
                   "(--ps_mirror=false): keep one parameter pull in "
                   "flight, overlapping the next pull with the card's "
                   "gradient computation and the push (the pulled "
                   "snapshot is one own-push staler — async-SGD "
                   "staleness class). false = serial pull/compute/push "
                   "reference cycle")
    DEFINE_boolean("ps_mirror", True, "PS mode: keep a device-resident "
                   "mirror of the params (and, for momentum/adam, the "
                   "optimizer slots) and replay each pushed gradient's "
                   "ps-side update on the card instead of re-pulling and "
                   "re-uploading the full parameter set every cycle. The "
                   "mirror resyncs from the ps every --ps_resync_steps and "
                   "at once when another worker's push is detected (the "
                   "returned global step skips ahead); =false restores "
                   "the pull cycle --ps_prefetch controls")
    DEFINE_integer("ps_resync_steps", 50, "Steps between full parameter "
                   "resyncs in --ps_mirror mode (bounds any numeric drift "
                   "between the ps-side and card-side applies)")
    DEFINE_boolean("sharded_checkpoint", True, "Cross-host-sharded state "
                   "checkpoints as per-process shard files (each rank "
                   "writes its locally-owned slices; NO allgather — the "
                   "save moves 1/P of the model per rank instead of "
                   "O(model) to one). Restore reassembles from the "
                   "complete set; --eval_only and the inspect CLI read "
                   "both formats. =false keeps the monolithic single-file "
                   "format. Locally-fetchable state always writes the "
                   "monolithic file")
    DEFINE_integer("model_axis", 1, "Tensor-parallel ways on the mesh's "
                   "'model' axis (sync mode): the CNN's FC stack is "
                   "column/row-split and the collectives are inserted "
                   "at the split boundaries. 1 = pure data parallelism "
                   "(reference-equivalent). Ranks r*m..r*m+m-1 of the "
                   "--worker_hosts group form one model group")
    DEFINE_boolean("async_checkpoint", True, "Write cadenced checkpoints "
                   "from a background thread (the state is fetched to "
                   "host on the training thread, then serialized and "
                   "written off-thread; training never blocks on the "
                   "disk). The final checkpoint on exit is always "
                   "synchronous")
    DEFINE_integer("zero", 0, "ZeRO-sharded data parallelism (sync DP "
                   "only, parallel/zero.py): 0 = replicated (default), "
                   "1 = shard the optimizer state 1/D per rank (the "
                   "gradients reduce-scatter instead of all-reduce, and "
                   "one all-gather rebuilds the updated params), 3 = "
                   "FSDP-style (the params live sharded too, gathered "
                   "into the module for forward and backward). "
                   "Trajectories match replicated DP (bit for bit where "
                   "the collectives sum in the same order; last-ulp "
                   "under --clip_norm); checkpoints stay standard-layout, "
                   "so --zero runs and replicated runs of either package "
                   "restore each other's. Composes with --device_data, "
                   "--accum_steps, --clip_norm, --augment; not with the "
                   "ps topology")
    DEFINE_boolean("zero_overlap", False, "ZeRO collective schedule "
                   "(requires --zero 1|3): the gradients reduce-scatter "
                   "in --zero_bucket_mb buckets, one collective per "
                   "bucket, and at level 3 the next step's parameter "
                   "gather is issued right after the update (the "
                   "prefetch; under --device_data it stays in the "
                   "module's parameters across CUDA graph replays). "
                   "Trajectories match the serial ZeRO path's (same "
                   "padding, same chunk ownership)")
    DEFINE_float("zero_bucket_mb", 4.0, "Bucket size in MB for "
                 "--zero_overlap's bucketed reduce-scatter/all-gather: "
                 "leaves group in canonical order until a bucket would "
                 "exceed this, one collective per bucket")
    DEFINE_string("profile_dir", "", "If set, trace --profile_steps "
                  "post-warm-up training steps with torch.profiler into "
                  "this dir (a Chrome trace) and report the device's busy "
                  "share over them")
    DEFINE_integer("profile_steps", 10, "Number of steps in the profiler "
                   "window")
    FLAGS._register_validator(_validate_training_flags)
    FLAGS._register_validator(_validate_zero_flags)
    FLAGS._register_validator(_validate_model_axis_flags)


def _require(values: dict, name: str, check, what: str):
    """One bounds check: skipped when the flag is not defined, raised with
    the flag and the bound named otherwise."""
    v = values.get(name)
    if v is not None and not check(v):
        raise ValueError(f"--{name}={v} {what}")


def _validate_training_flags(values: dict):
    """The JAX package's parse-time checks of the flags above."""
    _require(values, "training_iter", lambda v: int(v) >= 1,
             "must be >= 1 (the step budget)")
    _require(values, "learning_rate", lambda v: float(v) > 0,
             "must be > 0")
    _require(values, "display_step", lambda v: int(v) >= 1,
             "must be >= 1 (the display/eval cadence)")
    _require(values, "task_index", lambda v: int(v) >= 0,
             "must be >= 0 (a cluster-member index)")
    _require(values, "hidden_units", lambda v: int(v) >= 1,
             "must be >= 1")
    _require(values, "keep_prob", lambda v: 0 < float(v) <= 1,
             "must be in (0, 1] (a dropout KEEP probability)")
    _require(values, "weight_decay", lambda v: float(v) >= 0,
             "must be >= 0")
    _require(values, "clip_norm", lambda v: float(v) >= 0,
             "must be >= 0 (0 = no clipping)")
    _require(values, "save_model_secs", lambda v: int(v) >= 0,
             "must be >= 0 (0 = checkpoint every boundary)")
    _require(values, "max_to_keep", lambda v: int(v) >= 1,
             "must be >= 1 (GC must keep at least the newest)")
    _require(values, "seed", lambda v: int(v) >= 0,
             "must be >= 0 (PRNG keys are unsigned)")
    _require(values, "eval_step", lambda v: int(v) >= 0,
             "must be >= 0 (0 = end-of-run eval only)")
    _require(values, "validation_size", lambda v: int(v) >= 0,
             "must be >= 0 (0 = no held-out split)")
    _require(values, "accum_steps", lambda v: int(v) >= 1,
             "must be >= 1 (microbatches per update)")
    _require(values, "profile_steps", lambda v: int(v) >= 1,
             "must be >= 1 (the profiler window)")
    _require(values, "warmup_steps", lambda v: int(v) >= 0,
             "must be >= 0 (0 = no warmup)")
    _require(values, "decay_steps", lambda v: int(v) >= 0,
             "must be >= 0 (0 = the full step budget)")
    _require(values, "decay_rate", lambda v: float(v) > 0,
             "must be > 0 (a decay factor)")
    _require(values, "augment_pad", lambda v: int(v) >= 0,
             "must be >= 0 (crop padding)")
    _require(values, "device_chunk", lambda v: int(v) >= 1,
             "must be >= 1 (steps per chunk)")
    _require(values, "coord_steps", lambda v: int(v) >= 1,
             "must be >= 1 (the multi-process vote cadence)")
    _require(values, "init_retries", lambda v: int(v) >= 0,
             "must be >= 0 (0 = fail on the first refusal)")
    _require(values, "init_backoff_s", lambda v: float(v) >= 0,
             "must be >= 0 seconds")
    _require(values, "init_timeout_s", lambda v: float(v) >= 0,
             "must be >= 0 seconds (0 = the library default)")
    _require(values, "ps_resync_steps", lambda v: int(v) >= 1,
             "must be >= 1 (the mirror resync cadence)")
    wire = values.get("ps_wire")
    if wire is not None and wire not in ("f32", "bf16"):
        raise ValueError(f"--ps_wire={wire!r} must be f32 or bf16")
    mode = values.get("mode")
    if mode not in ("auto", "local", "sync", "ps"):
        raise ValueError(f"--mode={mode!r} must be one of auto, local, "
                         f"sync, ps")
    opt = values.get("optimizer")
    if opt not in ("sgd", "momentum", "adam"):
        raise ValueError(f"--optimizer={opt!r} must be one of sgd, "
                         f"momentum, adam")
    sched = values.get("lr_schedule")
    if sched not in ("constant", "cosine", "linear", "exponential"):
        raise ValueError(f"--lr_schedule={sched!r} must be one of "
                         f"constant, cosine, linear, exponential")
    dataset = values.get("dataset")
    if dataset not in ("mnist", "fashion_mnist", "cifar10", "lm"):
        raise ValueError(f"--dataset={dataset!r} must be one of mnist, "
                         f"fashion_mnist, cifar10, lm")
    if values.get("augment") and dataset == "lm":
        raise ValueError(
            "--augment crops/flips images; --dataset=lm feeds token "
            "sequences with no image layout to augment — drop one")
    job = values.get("job_name")
    if job not in ("", "ps", "worker"):
        raise ValueError(
            f"--job_name={job!r} must be 'ps', 'worker' or empty "
            f"(reference semantics, MNISTDist.py:13-31: the role this "
            f"process plays in the --ps_hosts topology)")


def _validate_zero_flags(values: dict):
    """The JAX package's parse-time --zero checks of the flags the port
    has: an unknown level, --zero_overlap or --zero_bucket_mb without
    their level, and the asynchronous ps topology. Divisibility needs no
    check: ZeRO leaves flatten and zero-pad to a multiple of D. A data
    axis of one rank is legal but pointless, and the loop says so. The
    library re-checks (parallel/zero._check_level, loop.train)."""
    raw = values.get("zero")
    z = 0 if raw is None else int(raw)
    if z not in (0, 1, 3):
        raise ValueError(
            f"--zero={z} must be 0 (replicated DP), 1 (shard the "
            f"optimizer state over the data axis) or 3 (shard the params "
            f"too, FSDP-style); level 2 (grad persistence sharding) does "
            f"not exist in this build — grads are already transient")
    overlap = bool(values.get("zero_overlap"))
    bucket = values.get("zero_bucket_mb")
    if bucket is not None and not 0 < float(bucket) <= 1024:
        raise ValueError(
            f"--zero_bucket_mb={bucket} must be in (0, 1024] MB (one "
            f"collective per bucket; 0 or negative would bucket "
            f"nothing, >1 GB is one flat scatter by another name)")
    if overlap and z == 0:
        raise ValueError(
            "--zero_overlap only applies to --zero 1|3 (it reschedules "
            "the ZeRO collectives); without --zero it would silently "
            "change nothing — drop it or pick a --zero level")
    if not overlap and bucket is not None and float(bucket) != 4.0:
        raise ValueError(
            f"--zero_bucket_mb={bucket} only applies with "
            f"--zero_overlap (it sizes the overlap pattern's buckets); "
            f"without it the flag would silently change nothing — drop "
            f"it or add --zero_overlap")
    if z == 0:
        return
    if values.get("expert_parallel"):
        raise ValueError(
            f"--zero={z} with --expert_parallel is not supported: ZeRO "
            f"shards the whole TrainState over the DATA axis while "
            f"--expert_parallel shards MoE experts over the model axis — "
            f"the two state layouts collide. Drop one (ZeRO-over-PP/EP is "
            f"a future composition)")
    mode = values.get("mode") or "auto"
    if mode == "ps" or values.get("ps_hosts") or values.get("job_name"):
        raise ValueError(
            f"--zero={z} requires SYNCHRONOUS data parallelism (the "
            f"sharded optimizer update must see the same summed gradient "
            f"on every rank); the ps topology (--ps_hosts/--job_name) is "
            f"asynchronous. Drop them and use --mode=sync")
    if mode == "local":
        raise ValueError(
            f"--zero={z} requires sync mode (a torch.distributed group "
            f"to shard over); --mode=local has none. Use --mode=sync "
            f"with --worker_hosts (one worker makes a group of one)")


def _validate_model_axis_flags(values: dict):
    """--model_axis's parse-time checks: a model axis needs the sync
    mode's process grid, and composes with none of ZeRO, the ps
    topology, the device-resident split or the MoE LM in this build.
    The loop re-checks what depends on the resolved mode and the model
    (``training/loop.py``)."""
    m = int(values.get("model_axis") or 1)
    if m < 1:
        raise ValueError(f"--model_axis={m} must be >= 1 (1 = pure data "
                         f"parallelism)")
    if m == 1:
        return
    mode = values.get("mode") or "auto"
    if mode == "ps" or values.get("ps_hosts") or values.get("job_name"):
        raise ValueError(
            f"--model_axis={m} requires sync mode (a process grid of "
            f"data x model ranks); the ps topology (--ps_hosts/"
            f"--job_name) is asynchronous and has no model axis. Drop "
            f"them and use --mode=sync")
    workers = [h for h in (values.get("worker_hosts") or "").split(",") if h]
    if mode == "local" or (mode == "auto" and len(workers) <= 1):
        # --mode=auto with one worker resolves to local (cluster.resolve_mode)
        raise ValueError(
            f"--model_axis={m} requires sync mode (a device mesh); got "
            f"mode='local'. Use --mode=sync.")
    if int(values.get("zero") or 0):
        raise ValueError(
            f"--zero={values.get('zero')} with --model_axis={m} is not "
            f"supported: ZeRO shards the whole TrainState over the DATA "
            f"axis while --model_axis shards the FC stack / blocks over "
            f"the model axis — the two state layouts collide. Drop one")
    if values.get("device_data"):
        raise ValueError(
            f"--device_data with --model_axis={m} is not yet ported to "
            f"distributed_tensorflow_tpu_torch: a CUDA graph cannot "
            f"capture gloo's host-staged collectives, and only NCCL on "
            f"several cards could show it (ROADMAP queue 1). Drop "
            f"--device_data")
    if int(values.get("moe_experts") or 0):
        raise ValueError(
            f"--moe_experts with --model_axis={m} is not yet ported to "
            f"distributed_tensorflow_tpu_torch: the MoE LM under a model "
            f"axis is expert parallelism, which comes later (ROADMAP "
            f"queue 1). Drop --moe_experts or --model_axis")


def training_entry_error(FLAGS) -> str | None:
    """Why the training entry cannot run these flags, or None: a
    --fault_spec (or DTT_FAULT_SPEC) naming ``preempt`` and
    --watchdog_s > 0 arm paths this package's training loop does not
    have yet (``training/elastic.py``'s preemption poll, the loop's
    hang watchdog), so they are refused rather than left to arm a rule
    that never fires."""
    import os

    from distributed_tensorflow_tpu_torch.utils.faults import (
        parse_fault_spec,
    )

    spec = getattr(FLAGS, "fault_spec", "") or os.environ.get(
        "DTT_FAULT_SPEC", "")
    if any(r.point == "preempt" for r in parse_fault_spec(spec)):
        return ("--fault_spec names 'preempt': the preemption poll "
                "(training/elastic.py) is not yet ported to "
                "distributed_tensorflow_tpu_torch, so the rule would "
                "never fire on the training entry")
    if float(getattr(FLAGS, "watchdog_s", 0.0) or 0.0) > 0:
        return ("--watchdog_s > 0: the training loop's hang watchdog "
                "around steps and collectives is not yet ported to "
                "distributed_tensorflow_tpu_torch (it arms serving only), "
                "so the training entry refuses it")
    return None


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
    if int(values["serve_max_new_tokens"]) < 1:
        raise ValueError("--serve_max_new_tokens must be >= 1")
    if float(values["serve_temperature"]) < 0:
        raise ValueError("--serve_temperature must be >= 0 (0 = greedy)")
    sched = values["serve_scheduler"]
    if sched not in ("whole_batch", "continuous"):
        raise ValueError(f"--serve_scheduler={sched!r} must be one of "
                         f"whole_batch, continuous")
    _require(values, "seq_len", lambda v: int(v) >= 2,
             "must be >= 2 (targets are the sequence shifted one token)")
    _require(values, "vocab_size", lambda v: int(v) >= 2,
             "must be >= 2")
    _require(values, "attn_block", lambda v: int(v) >= 0,
             "must be >= 0 (0 = dense attention)")
    _require(values, "ce_block", lambda v: int(v) >= 0,
             "must be >= 0 (0 = dense loss head)")
    _require(values, "moe_experts", lambda v: int(v) >= 0,
             "must be >= 0 (0 = dense MLPs)")
    _require(values, "moe_capacity", lambda v: float(v) > 0,
             "must be > 0 (a per-expert capacity factor)")
    _require(values, "moe_aux", lambda v: float(v) >= 0,
             "must be >= 0 (the load-balance coefficient)")


def _validate_serving_scheduler_flags(values: dict):
    """The JAX package's parse-time checks of the continuous scheduler's
    flags (``--serve_slots``, ``--serve_kv_page``, ``--serve_kv_pages``)
    and of the drain floor's range."""
    slots = values.get("serve_slots")
    if slots is not None and int(slots) < 2:
        raise ValueError(
            f"--serve_slots={slots} must be >= 2 (slot width >= 2 "
            f"keeps decode on the GEMM kernel — the bitwise-parity "
            f"floor)")
    page = values.get("serve_kv_page")
    if page is not None and int(page) < 1:
        raise ValueError(f"--serve_kv_page={page} must be >= 1")
    seq_len = int(values.get("seq_len") or 0)
    if page is not None and seq_len and seq_len % int(page):
        raise ValueError(
            f"--serve_kv_page={page} must divide --seq_len="
            f"{seq_len} (a slot's pages tile the context window)")
    pages = values.get("serve_kv_pages")
    if pages is not None and int(pages) < 0:
        raise ValueError(
            f"--serve_kv_pages={pages} must be >= 0 "
            f"(0 = full provisioning)")
    if pages and page and seq_len:
        per_slot = -(-seq_len // int(page))
        if int(pages) < per_slot:
            raise ValueError(
                f"--serve_kv_pages={pages} cannot hold one "
                f"full-context request ({per_slot} pages of "
                f"{page} tokens for --seq_len={seq_len})")
    if values.get("serve_scheduler") == "continuous":
        model = values.get("model")
        if model is not None and model != "lm":
            raise ValueError(
                f"--serve_scheduler=continuous serves --model lm "
                f"only (token decode); got --model={model!r}")
    shp = values.get("serve_hbm_headroom_pct")
    if shp is not None and not (0.0 <= float(shp) < 100.0):
        raise ValueError(f"--serve_hbm_headroom_pct={shp} must be in "
                         f"[0, 100) percent of the device limit "
                         f"(0 = off; 100 would 503 a healthy replica)")


def _validate_telemetry_flags(values: dict):
    """The JAX package's parse-time telemetry checks: a negative watchdog
    timeout, a watchdog under --telemetry=false, an abort flag with no
    watchdog, a zero-length flight ring."""
    wd = values.get("watchdog_s")
    wd = 0.0 if wd is None else float(wd)
    if wd < 0:
        raise ValueError(f"--watchdog_s={wd} must be >= 0 (0 = off)")
    telemetry_flag = values.get("telemetry")
    if wd > 0 and telemetry_flag is not None and not telemetry_flag:
        raise ValueError(
            "--watchdog_s > 0 with --telemetry=false is silently inert "
            "(the watchdog is part of the telemetry spine and is never "
            "installed when telemetry is off) — drop --watchdog_s or "
            "re-enable --telemetry")
    if values.get("watchdog_abort") and wd <= 0:
        raise ValueError(
            "--watchdog_abort only applies with --watchdog_s > 0 (no "
            "watchdog ever fires without a timeout); without it the "
            "flag would silently change nothing — drop it or set "
            "--watchdog_s")
    fe = values.get("flightrec_events")
    if fe is not None and int(fe) < 1:
        raise ValueError(f"--flightrec_events={fe} must be >= 1 (the "
                         f"crash postmortem needs at least one slot; "
                         f"use --telemetry=false to disable telemetry)")


def _validate_reqtrace_flags(values: dict):
    """The JAX package's parse-time request-plane checks: out-of-bounds
    --slo_*/--reqtrace_* values, an SLO target without the SLO armed, and
    request-plane knobs set under --telemetry=false (the plane rides the
    telemetry spine and would be silently inert)."""
    p99 = values.get("slo_p99_ms")
    if p99 is not None and float(p99) < 0:
        raise ValueError(f"--slo_p99_ms={p99} must be >= 0 ms "
                         f"(0 = SLO accounting off)")
    tgt = values.get("slo_target_pct")
    if tgt is not None and not (50.0 < float(tgt) <= 100.0):
        raise ValueError(f"--slo_target_pct={tgt} must be in (50, 100] "
                         f"(the promised compliant fraction; <= 50 "
                         f"leaves no meaningful error budget)")
    if tgt is not None and float(tgt) != 99.0 \
            and (p99 is None or float(p99) <= 0):
        raise ValueError(
            "--slo_target_pct without --slo_p99_ms > 0 is silently "
            "inert (the target only parameterizes the armed "
            "error-budget ledger) — set --slo_p99_ms or drop the "
            "target")
    ring = values.get("reqtrace_ring")
    if ring is not None and not (16 <= int(ring) <= 1_048_576):
        raise ValueError(f"--reqtrace_ring={ring} must be in "
                         f"[16, 1048576] retained request summaries")
    ex = values.get("reqtrace_exemplars")
    if ex is not None and not (1 <= int(ex) <= 64):
        raise ValueError(f"--reqtrace_exemplars={ex} must be in "
                         f"[1, 64] named tail exemplars")
    telemetry_flag = values.get("telemetry")
    if telemetry_flag is None or telemetry_flag:
        return
    if p99 is not None and float(p99) > 0:
        raise ValueError(
            "--slo_p99_ms > 0 with --telemetry=false is silently inert "
            "(the request plane's ledger, audit ring, and req:* spans "
            "ride the telemetry spine) — drop it or re-enable "
            "--telemetry")
    if ring is not None and int(ring) != _REQTRACE_RING_DEFAULT:
        raise ValueError(
            "--reqtrace_ring with --telemetry=false is silently inert "
            "(the audit ring is part of the request plane, which "
            "--telemetry=false leaves unconfigured) — drop it or "
            "re-enable --telemetry")
    if ex is not None and int(ex) != _REQTRACE_EXEMPLARS_DEFAULT:
        raise ValueError(
            "--reqtrace_exemplars with --telemetry=false is silently "
            "inert (the tail block is part of the request plane, which "
            "--telemetry=false leaves unconfigured) — drop it or "
            "re-enable --telemetry")


def _validate_fault_spec(values: dict):
    """Parse-time --fault_spec validation: a mistyped point or mode fails
    at the command line with the registered points, not as a rule that
    never fires."""
    spec = values.get("fault_spec") or ""
    if not spec:
        return
    from distributed_tensorflow_tpu_torch.utils.faults import (
        FaultSpecError,
        parse_fault_spec,
    )

    try:
        parse_fault_spec(spec)
    except FaultSpecError as e:
        raise ValueError(f"--fault_spec: {e}") from None
