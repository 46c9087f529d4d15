"""CLI entry point (counterpart of ``split_learning_tpu/launch/run.py``).

``train``, on the GPU by default: the fused transport (one process, one
program), the two-party path in one process (``--transport local``:
``SplitClientTrainer`` over ``LocalTransport`` to an in-process
``ServerRuntime`` built from the same seed, with the wire compression of
``--compress``), or the client party of a two-process run over HTTP
(``--transport http --server-url URL``). ``serve`` runs the server party
behind ``SplitHTTPServer`` until SIGINT:

  python -m split_learning_tpu_torch.launch.run train \
      --mode split --dataset synthetic --steps 20
  python -m split_learning_tpu_torch.launch.run train --transport local \
      --compress topk8 --compress-density 0.1 --dataset synthetic --steps 20
  python -m split_learning_tpu_torch.launch.run serve --port 8000 &
  python -m split_learning_tpu_torch.launch.run train --transport http \
      --server-url http://127.0.0.1:8000 --compress int8 --steps 20
  python -m split_learning_tpu_torch.launch.run train \
      --model transformer_lm --dataset lm --seq-len 256 --attn flash \
      --d-model 256 --num-heads 2 --steps 20
  python -m split_learning_tpu_torch.launch.run train \
      --model transformer_lm --dataset lm --attn flash --dtype bfloat16 \
      --optimizer adamw --lr 3e-4 --weight-decay 0.1 --warmup-steps 5 \
      --decay-steps 30 --grad-clip-norm 1.0 --steps 30

Config resolution is the JAX package's: CLI flags > environment
(``LEARNING_MODE``, ``SLT_*``, ``SLT_SERVER_URL``) > defaults.
``--device cpu`` is the only way onto the CPU, where the kernels' plain
versions run. The JAX ``--kernels`` flag does not exist here: the device
picks the kernel. The transformer families take the JAX size flags
(``--d-model``, ``--num-heads``, ``--client-depth``, ``--server-depth``),
``--seq-len`` for the token datasets and ``--attn``, with the JAX
command's checks: ``transformer_lm`` needs ``--dataset lm``,
``transformer`` needs ``--dataset tokens``, and an image model refuses
token data (rc 2). On a two-party wire ``--compress-density auto`` warns
and uses 0.1, as in JAX (the adaptive controller drives the K-stage
chain's hops only). A ``train`` client whose server reports another mode
exits 4, as in JAX.

Training as JAX's command configures it, on every transport and on
``serve`` (whose server party builds its own optimizer from them):
``--optimizer sgd|adam|adamw``, ``--momentum``, ``--weight-decay``,
``--warmup-steps``, ``--decay-steps``, ``--grad-clip-norm`` and
``--dtype float32|bfloat16`` (``runtime/state.py`` ``make_tx``).
``train --trace PATH`` writes the run's spans as a Chrome trace.

Not ported yet, each exiting 2 with the ROADMAP item it waits for:
``--replicas`` above 1 (item 19), ``--pipeline-depth`` above 1 (item
15), the U-shaped and federated modes (item 11), and the ``serve`` flags
of :data:`SERVE_NOT_PORTED`; the ``eval`` and ``generate`` commands and
checkpoints are item 13.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import Any, Dict, Optional

import torch


def _config_from_args(args):
    from split_learning_tpu_torch.utils.config import Config
    overrides = {}
    for field in ("mode", "model", "dataset", "batch_size", "epochs", "lr",
                  "optimizer", "momentum", "weight_decay", "warmup_steps",
                  "decay_steps", "grad_clip_norm", "microbatches", "seed",
                  "data_dir", "tracking", "transport", "server_url", "attn",
                  "dtype", "remat"):
        val = getattr(args, field, None)
        if val is not None:
            overrides[field] = val
    return Config.from_env(**overrides)


_ATTENTION_FAMILIES = ("transformer", "transformer_lm")
_TOKEN_SETS = ("tokens", "lm")


def _pairing_error(cfg) -> Optional[str]:
    """The JAX command's model/dataset pairing check: a mismatch would
    surface deep in the loss as a shape error."""
    if cfg.model == "transformer_lm" and cfg.dataset != "lm":
        return (f"model 'transformer_lm' needs per-token targets: "
                f"--dataset lm (got {cfg.dataset!r})")
    if cfg.model == "transformer" and cfg.dataset != "tokens":
        return (f"model 'transformer' (sequence classifier) needs "
                f"--dataset tokens (got {cfg.dataset!r})")
    if cfg.model not in _ATTENTION_FAMILIES and cfg.dataset in _TOKEN_SETS:
        return (f"dataset {cfg.dataset!r} is token-shaped; model "
                f"{cfg.model!r} consumes images (mnist | synthetic)")
    return None


def _plan_kw(args, cfg) -> Dict[str, Any]:
    """Plan-builder kwargs from the size flags. As in JAX
    (``_plan_size_kw``), ``max_len`` is derived: a ``--seq-len`` above
    the 2048 default table extends it. ``attn`` goes to the attention
    families only."""
    kw = {name: getattr(args, name) for name in (
        "d_model", "num_heads", "client_depth", "server_depth")
        if getattr(args, name) is not None}
    if cfg.model in _ATTENTION_FAMILIES:
        kw["attn"] = cfg.attn
        if args.seq_len and args.seq_len > 2048:
            kw["max_len"] = args.seq_len
    return kw


def _density_arg(v: str):
    """argparse type for --compress-density: a float, or "auto"."""
    if v == "auto":
        return v
    try:
        return float(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--compress-density must be a float or 'auto' (got {v!r})")


def _density_or_default(args) -> float:
    """The plain-float density of a two-party wire. "auto" (the adaptive
    controller, which drives the K-stage chain's hop wires only) warns
    and falls back to 0.1, as JAX's ``_density_or_default`` does."""
    d = args.compress_density
    if d == "auto":
        print("[warn] --compress-density auto drives the chain hop "
              "wires only (mode=split, --stages > 2); this wire uses "
              "the fixed default 0.1", file=sys.stderr)
        return 0.1
    return float(d)


def _wire_error(args, density: float) -> Optional[str]:
    """The two-party flags' checks; raises NotImplementedError for what
    is not ported yet."""
    if args.replicas > 1:
        raise NotImplementedError(
            "not ported yet: --replicas > 1 (ROADMAP item 19)")
    if args.pipeline_depth > 1:
        raise NotImplementedError(
            "not ported yet: --pipeline-depth > 1 (the pipelined client, "
            "ROADMAP item 15)")
    if not 0.0 < density <= 1.0:
        return f"--compress-density must be in (0, 1] (got {density})"
    if args.failure_policy is not None and args.max_retries < 0:
        return f"--max-retries must be >= 0 (got {args.max_retries})"
    return None


def _make_transport(args, cfg, density: float, server: Any):
    """The client's wire: ``LocalTransport`` to the in-process server, or
    ``HttpTransport`` to ``cfg.server_url`` after its /health barrier;
    then the chaos schedule of ``--chaos`` around either. Returns
    ``(transport, rc)``: rc 4 when the server is in another mode."""
    from split_learning_tpu_torch.transport import (
        ChaosPolicy, ChaosTransport, HttpTransport, LocalTransport)
    if server is not None:
        transport = LocalTransport(server, compress=args.compress,
                                   density=density)
    else:
        transport = HttpTransport(cfg.server_url,
                                  compress=args.compress or "none",
                                  density=density)
        # readiness barrier: the reference's client starts blind and
        # drops every batch sent before its server is up
        info = transport.wait_ready(timeout=args.wait_server)
        if info.get("mode") not in (cfg.mode, None):
            print(f"[transport] server is in mode {info.get('mode')!r} "
                  f"but this client wants {cfg.mode!r}", file=sys.stderr)
            transport.close()
            return None, 4
    if args.chaos:
        policy = ChaosPolicy(args.chaos, seed=args.chaos_seed)
        transport = ChaosTransport(transport, policy)
        print(f"[chaos] injecting {args.chaos!r} (seed {policy.seed}) on "
              "the client wire", file=sys.stderr)
    return transport, 0


def cmd_train(args) -> int:
    from split_learning_tpu_torch import obs
    from split_learning_tpu_torch.data import batches, load_dataset
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import (
        CircuitBreaker, FusedSplitTrainer, ServerRuntime, SplitClientTrainer,
        check_config, check_supported)
    from split_learning_tpu_torch.tracking import make_logger
    from split_learning_tpu_torch.transport.chaos import parse_chaos_spec
    from split_learning_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # no GPU for "cuda": raise before any work
    try:
        cfg = _config_from_args(args)
        err = _pairing_error(cfg)
        if err is None and args.seq_len is not None:
            if args.seq_len <= 0:
                err = f"--seq-len must be positive (got {args.seq_len})"
            elif cfg.dataset not in _TOKEN_SETS:
                err = (f"--seq-len applies to the token datasets (got "
                       f"--dataset {cfg.dataset!r})")
        two_party = cfg.transport in ("local", "http")
        density = _density_or_default(args) if two_party else None
        if err is None and two_party:
            err = _wire_error(args, density)
            if args.chaos:
                parse_chaos_spec(args.chaos)  # a bad spec fails here
        if err is not None:
            raise ValueError(err)
        plan = get_plan(model=cfg.model, mode=cfg.mode, dtype=cfg.dtype,
                        **_plan_kw(args, cfg))
        server = None
        if cfg.transport == "local":
            # the in-process server from the same seed: each party keeps
            # its own stages of one init, as a fused run would start
            server = ServerRuntime(plan, cfg,
                                   torch.Generator().manual_seed(cfg.seed),
                                   device=args.device)
        elif two_party:
            if cfg.mode != "split":
                raise NotImplementedError(
                    f"not ported yet: mode {cfg.mode!r} over HTTP (the "
                    "U-shaped and federated clients, ROADMAP item 11)")
            check_config(cfg)
        else:
            check_supported(cfg)
    except (ValueError, NotImplementedError) as e:
        print(f"[error] {e}", file=sys.stderr)
        return 2
    if cfg.model not in _ATTENTION_FAMILIES and cfg.attn != "full":
        print(f"[warn] --attn {cfg.attn!r} ignored: model {cfg.model!r} has "
              "no attention (transformer families only)", file=sys.stderr)
    if not two_party:
        for flag, val in (("--compress", args.compress),
                          ("--chaos", args.chaos),
                          ("--failure-policy", args.failure_policy)):
            if val is not None:
                print(f"[warn] {flag} {val!r} ignored: the fused "
                      "transport has no wire", file=sys.stderr)
    if two_party:
        # the wire before the data: a server in another mode stops here
        transport, rc = _make_transport(args, cfg, density, server)
        if rc:
            return rc
    ds = load_dataset(cfg.dataset, cfg.data_dir, seq_len=args.seq_len)
    if ds.synthetic:
        print(f"[data] using synthetic {ds.name} "
              f"({len(ds.train)} train examples)", file=sys.stderr)
    sample = ds.train.x[:cfg.batch_size]
    seed_gen = torch.Generator().manual_seed(cfg.seed)
    if two_party:
        fail_policy = args.failure_policy or "raise"
        # retry clients probe /health while the server is down instead
        # of resending full steps; its jitter is seeded from the config
        breaker = (CircuitBreaker(transport.health, seed=cfg.seed)
                   if fail_policy == "retry" else None)
        trainer = SplitClientTrainer(plan, cfg, seed_gen, transport,
                                     failure_policy=fail_policy,
                                     max_retries=args.max_retries,
                                     breaker=breaker, device=args.device)
    else:
        trainer = FusedSplitTrainer(plan, cfg, seed_gen, sample,
                                    device=args.device)
    logger = make_logger(cfg)
    # --trace: per-step spans (obs/), off by default and free when off
    step_tracer = obs.enable() if args.trace else None

    budget = {"n": args.steps if args.steps else None, "epoch": 0}

    def data_iter():
        # reshuffle per epoch; each call is one epoch
        epoch_seed = cfg.seed + budget["epoch"]
        budget["epoch"] += 1
        for xy in batches(ds.train, cfg.batch_size, seed=epoch_seed,
                          drop_remainder=True):
            if budget["n"] is not None:
                if budget["n"] <= 0:
                    return
                budget["n"] -= 1
            yield xy

    t0 = time.time()
    n_steps = 0
    final_loss = float("nan")
    for _ in range(cfg.epochs):  # the step cap is enforced by data_iter
        for x, y in data_iter():
            if two_party:
                loss = trainer.train_step(x, y, n_steps)
            else:
                loss = trainer.train_step(x, y)
            if loss is not None:
                final_loss = loss
                logger.log_metric("loss", loss, step=n_steps)
            n_steps += 1
    dt = time.time() - t0
    if step_tracer is not None:
        obs.disable()
        out_path = step_tracer.export_chrome(args.trace)
        print(f"[trace] {len(step_tracer.spans())} spans -> {out_path}",
              file=sys.stderr)
    if n_steps and dt > 0:
        logger.log_metric("steps_per_sec", n_steps / dt, step=n_steps)
    if two_party:
        wire = transport.stats.summary()
        mode = args.compress or ("none" if server is None else None)
        print(f"[transport] {cfg.transport} compress={mode} "
              f"round_trips={wire['round_trips']} "
              f"bytes_sent={wire['bytes_sent']} "
              f"bytes_received={wire['bytes_received']} "
              f"compression_ratio={wire.get('compression_ratio', 1.0):.2f} "
              f"dropped_batches={trainer.dropped_batches}")

    if args.eval:
        from split_learning_tpu_torch.runtime.evaluate import (
            evaluate, evaluate_remote)
        if cfg.transport == "http":
            # the server's stage stays remote: split-party inference
            res = evaluate_remote(plan, [trainer.params], transport,
                                  ds.test, batch_size=cfg.batch_size)
        else:
            params = ((trainer.params, server.params) if two_party
                      else trainer.params)
            res = evaluate(plan, params, ds.test,
                           batch_size=cfg.batch_size)
        logger.log_metric("test_accuracy", res["accuracy"], step=n_steps)
        logger.log_metric("test_loss", res["loss"], step=n_steps)
        print(f"[eval] accuracy={res['accuracy']:.4f} "
              f"loss={res['loss']:.4f} n={res['predictions']}")

    logger.close()
    if two_party:
        transport.close()
    print(f"[done] mode={cfg.mode} transport={cfg.transport} "
          f"steps={n_steps} final_loss={final_loss:.4f} "
          f"({n_steps / dt if dt > 0 else 0.0:.2f} steps/s)")
    return 0


def _given(v: Any) -> bool:
    return v is not None


# the JAX ``serve`` flags the port does not run yet: (attribute, whether
# it asks for something unported, the flag, its ROADMAP item). Each
# exits 2 naming its item.
SERVE_NOT_PORTED = (
    ("role", lambda v: v != "server",
     "--role stage (a stage party of the K-stage chain)", "item 16"),
    ("resume", bool, "--resume (checkpoints)", "item 13"),
    ("checkpoint_dir", _given, "--checkpoint-dir (checkpoints)", "item 13"),
    ("remat", bool, "--remat", "item 16"),
    ("coalesce_max", lambda v: v > 1,
     "--coalesce-max > 1 (request coalescing)", "item 14"),
    ("batching", lambda v: v != "window",
     "--batching continuous (continuous batching)", "item 14"),
    ("tenants", lambda v: v > 1, "--tenants > 1 (admission control)",
     "item 14"),
    ("quota", _given, "--quota (admission control)", "item 14"),
    ("slo_ms", _given, "--slo-ms (admission control)", "item 14"),
    ("no_overlap", bool, "--no-overlap (the async-dispatch escape hatch)",
     "item 14"),
    ("decouple_bwd", bool, "--decouple-bwd (2BP)", "item 14"),
    ("apply_lag", bool, "--apply-lag (2BP)", "item 14"),
    ("mesh_data", lambda v: v > 1, "--mesh-data > 1 (a sharded server)",
     "item 18"),
    ("mesh_model", lambda v: v > 1, "--mesh-model > 1 (a sharded server)",
     "item 18"),
    ("replicas", lambda v: v > 1, "--replicas > 1 (server replicas)",
     "item 19"),
    ("replica_sync_every", bool, "--replica-sync-every (server replicas)",
     "item 19"),
    ("handoff", lambda v: v != "live",
     "--handoff checkpoint (server replicas)", "item 19"),
    ("autoscale", bool, "--autoscale (elastic replicas)", "item 19"),
    ("autoscale_min", _given, "--autoscale-min (elastic replicas)",
     "item 19"),
    ("autoscale_max", _given, "--autoscale-max (elastic replicas)",
     "item 19"),
    ("autoscale_cooldown_s", _given,
     "--autoscale-cooldown-s (elastic replicas)", "item 19"),
    ("trace", _given, "--trace (the server's Chrome trace)", "item 10"),
    ("flight", _given, "--flight (the flight recorder)", "item 22"),
    ("telemetry", bool, "--telemetry (the telemetry ring)", "item 22"),
    ("telemetry_interval_s", _given,
     "--telemetry-interval-s (the telemetry ring)", "item 22"),
    ("telemetry_slo_ms", _given, "--telemetry-slo-ms (the telemetry ring)",
     "item 22"),
    ("tracking_uri", _given, "--tracking-uri (MLflow)", "item 22"),
)


def cmd_serve(args) -> int:
    """The server party behind ``SplitHTTPServer`` until SIGINT: JAX's
    ``cmd_serve``, server role, with the same ``[serve]`` line."""
    import signal

    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import ServerRuntime
    from split_learning_tpu_torch.transport import (
        ChaosPolicy, SplitHTTPServer)
    from split_learning_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # no GPU for "cuda": raise before any work
    try:
        for attr, is_set, what, item in SERVE_NOT_PORTED:
            if is_set(getattr(args, attr)):
                raise NotImplementedError(
                    f"not ported yet: {what} (ROADMAP {item})")
        if not 0.0 < args.compress_density <= 1.0:
            raise ValueError(f"--compress-density must be in (0, 1] (got "
                             f"{args.compress_density})")
        cfg = _config_from_args(args)
        plan = get_plan(model=cfg.model, mode=cfg.mode, dtype=cfg.dtype,
                        **_plan_kw(args, cfg))
        # the seed's init, of which the server keeps its own stage: a
        # client started from the same seed holds the other one
        runtime = ServerRuntime(
            plan, cfg, torch.Generator().manual_seed(cfg.seed),
            strict_steps=not args.allow_out_of_order,
            ef_mode="clapping" if args.compress == "clapping" else "topk8",
            device=args.device)
        chaos = (ChaosPolicy(args.chaos, seed=args.chaos_seed)
                 if args.chaos else None)
    except (ValueError, NotImplementedError) as e:
        print(f"[error] {e}", file=sys.stderr)
        return 2
    if chaos is not None:
        print(f"[chaos] injecting {args.chaos!r} (seed {chaos.seed}) "
              "server-side", file=sys.stderr)
    server = SplitHTTPServer(runtime, host=args.host, port=args.port,
                             compress=args.compress or "none",
                             density=args.compress_density,
                             chaos=chaos).start()
    main_thread = threading.current_thread() is threading.main_thread()
    if main_thread:
        # SIGINT stops the server even where the parent ignored it
        prev = signal.signal(signal.SIGINT, signal.default_int_handler)
    print(f"[serve] mode={cfg.mode} role=server listening on {server.url}",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        if main_thread:  # a second SIGINT must not cut the shutdown short
            signal.signal(signal.SIGINT, signal.SIG_IGN)
        print("[serve] shutting down", flush=True)
        server.stop()
    finally:
        runtime.close()
        if main_thread:
            signal.signal(signal.SIGINT, prev)
    return 0


def _add_shared(p: argparse.ArgumentParser) -> None:
    """The flags ``train`` and ``serve`` share: the model, its sizes, the
    data, the seed and the device."""
    p.add_argument("--mode", choices=["split", "federated", "u_split"],
                   default=None)
    p.add_argument("--model", default=None,
                   help="split_cnn | split_cnn_chain3 | transformer | "
                        "transformer_lm (the others are not ported)")
    p.add_argument("--dataset", default=None,
                   help="mnist | synthetic | tokens (transformer) | lm "
                        "(transformer_lm)")
    p.add_argument("--data-dir", dest="data_dir", default=None)
    p.add_argument("--batch-size", dest="batch_size", type=int,
                   default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--optimizer", choices=["sgd", "adam", "adamw"],
                   default=None,
                   help="sgd (the reference's) | adam | adamw "
                        "(runtime/state.py make_tx)")
    p.add_argument("--momentum", type=float, default=None)
    p.add_argument("--weight-decay", dest="weight_decay", type=float,
                   default=None,
                   help="adamw decoupled decay; coupled L2 for sgd")
    p.add_argument("--warmup-steps", dest="warmup_steps", type=int,
                   default=None,
                   help="linear lr warmup over this many steps")
    p.add_argument("--decay-steps", dest="decay_steps", type=int,
                   default=None,
                   help="cosine-decay the lr to 0 by this total step "
                        "count (includes warmup)")
    p.add_argument("--grad-clip-norm", dest="grad_clip_norm", type=float,
                   default=None,
                   help="clip gradients to this global L2 norm (0 = off; "
                        "each party clips over its own stages)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                   help="compute dtype (params stay float32: mixed "
                        "precision)")
    p.add_argument("--microbatches", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--tracking", default=None, help="stdout | jsonl | noop")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; raises without a GPU) or cpu "
                        "(the kernels' plain versions)")
    # size overrides for the transformer families (the fixed reference
    # CNN rejects them)
    p.add_argument("--d-model", dest="d_model", type=int, default=None)
    p.add_argument("--num-heads", dest="num_heads", type=int, default=None)
    p.add_argument("--client-depth", dest="client_depth", type=int,
                   default=None, help="blocks in the client stage")
    p.add_argument("--server-depth", dest="server_depth", type=int,
                   default=None, help="blocks in the server stage")
    p.add_argument("--seq-len", dest="seq_len", type=int, default=None,
                   help="sequence length of the synthetic token/lm "
                        "datasets (default 64; cached per length)")
    p.add_argument("--attn", choices=["full", "flash", "auto", "ring",
                                      "ring_flash", "ulysses"],
                   default=None,
                   help="transformer attention: full (dense) or flash "
                        "(the hand-written kernels on the card); auto "
                        "and the sequence-parallel forms are not ported")
    p.add_argument("--compress", choices=["none", "int8", "topk8",
                                          "clapping"], default=None,
                   help="wire compression of the cut tensors: none = the "
                        "dense float32 wire; int8; topk8; clapping = "
                        "topk8 with storage-free error feedback")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="seeded fault injection on the wire: a comma list "
                        "of kind[=rate][:ms], kinds drop_req | drop_resp "
                        "| dup | delay | corrupt | http500 (e.g. "
                        "'drop_resp=0.1,dup=0.05'); off by default")
    p.add_argument("--chaos-seed", dest="chaos_seed", type=int, default=0,
                   help="seed of the --chaos schedule (the same spec and "
                        "seed give the same faults at the same steps)")


def _add_serve_not_ported(p: argparse.ArgumentParser) -> None:
    """JAX's ``serve`` flags that exit 2 here (:data:`SERVE_NOT_PORTED`)."""
    p.add_argument("--role", choices=["server", "stage"], default="server")
    p.add_argument("--stage-index", dest="stage_index", type=int, default=1)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--checkpoint-dir", dest="checkpoint_dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--tracking-uri", dest="tracking_uri", default=None)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--coalesce-max", dest="coalesce_max", type=int,
                   default=1)
    p.add_argument("--coalesce-window-ms", dest="coalesce_window_ms",
                   type=float, default=2.0)
    p.add_argument("--batching", choices=["window", "continuous"],
                   default="window")
    p.add_argument("--tenants", type=int, default=1)
    p.add_argument("--quota", type=float, default=None)
    p.add_argument("--slo-ms", dest="slo_ms", type=float, default=None)
    p.add_argument("--no-overlap", dest="no_overlap", action="store_true")
    p.add_argument("--decouple-bwd", dest="decouple_bwd",
                   action="store_true")
    p.add_argument("--apply-lag", dest="apply_lag", type=int, default=0)
    p.add_argument("--mesh-data", dest="mesh_data", type=int, default=1)
    p.add_argument("--mesh-model", dest="mesh_model", type=int, default=1)
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--replica-sync-every", dest="replica_sync_every",
                   type=int, default=0)
    p.add_argument("--handoff", choices=["live", "checkpoint"],
                   default="live")
    p.add_argument("--autoscale", action="store_true")
    p.add_argument("--autoscale-min", dest="autoscale_min", type=int,
                   default=None)
    p.add_argument("--autoscale-max", dest="autoscale_max", type=int,
                   default=None)
    p.add_argument("--autoscale-cooldown-s", dest="autoscale_cooldown_s",
                   type=float, default=None)
    p.add_argument("--trace", default=None, metavar="PATH")
    p.add_argument("--flight", default=None, metavar="PATH")
    p.add_argument("--telemetry", action="store_true")
    p.add_argument("--telemetry-interval-s", dest="telemetry_interval_s",
                   type=float, default=None)
    p.add_argument("--telemetry-slo-ms", dest="telemetry_slo_ms",
                   type=float, default=None)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="split_learning_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pt = sub.add_parser("train", help="run a split trainer")
    _add_shared(pt)
    pt.add_argument("--steps", type=int, default=0,
                    help="stop after N steps (0 = full epochs)")
    pt.add_argument("--transport", choices=["fused", "local", "http"],
                    default="fused",
                    help="fused (one program), local (the two parties in "
                         "one process, through the wire codec) or http "
                         "(this process is the client of a serve party)")
    pt.add_argument("--server-url", dest="server_url", default=None,
                    help="the serve party's URL (--transport http; "
                         "default SLT_SERVER_URL or http://127.0.0.1:8000)")
    pt.add_argument("--wait-server", dest="wait_server", type=float,
                    default=60.0,
                    help="seconds to wait for the server's /health "
                         "(--transport http)")
    pt.add_argument("--compress-density", dest="compress_density",
                    type=_density_arg, default=0.1,
                    help="topk8/clapping kept fraction (default 0.1); "
                         "'auto' warns and uses 0.1 on a two-party wire")
    pt.add_argument("--failure-policy", dest="failure_policy",
                    choices=["raise", "retry", "skip"], default=None,
                    help="what the client does when the wire fails: raise "
                         "(default), retry (bounded, with a circuit "
                         "breaker probing /health while the server is "
                         "down) or skip (drop the batch, counted)")
    pt.add_argument("--max-retries", dest="max_retries", type=int,
                    default=3,
                    help="retries per step with --failure-policy retry")
    pt.add_argument("--replicas", type=int, default=1,
                    help="server replicas (only 1 is ported)")
    pt.add_argument("--pipeline-depth", dest="pipeline_depth", type=int,
                    default=1,
                    help="steps in flight (only 1 is ported)")
    pt.add_argument("--eval", action="store_true",
                    help="report test-split accuracy after training "
                         "(over HTTP: split-party, evaluate_remote)")
    pt.add_argument("--trace", default=None, metavar="PATH",
                    help="per-step span tracing (obs/): write a Chrome-"
                         "trace JSON here on exit (Perfetto-loadable). "
                         "Off = zero overhead")
    pt.set_defaults(fn=cmd_train)

    ps = sub.add_parser("serve", help="serve the server party over HTTP")
    _add_shared(ps)
    ps.add_argument("--host", default="0.0.0.0")
    ps.add_argument("--port", type=int, default=8000,
                    help="0 picks a free port (read it from the [serve] "
                         "line)")
    ps.add_argument("--compress-density", dest="compress_density",
                    type=float, default=0.1,
                    help="topk8/clapping: the default reply density")
    ps.add_argument("--allow-out-of-order", dest="allow_out_of_order",
                    action="store_true",
                    help="accept out-of-order client steps (the strict "
                         "step handshake off)")
    _add_serve_not_ported(ps)
    ps.set_defaults(fn=cmd_serve)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
