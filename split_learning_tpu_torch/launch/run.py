"""CLI entry point (counterpart of ``split_learning_tpu/launch/run.py``).

``train``, on the GPU by default: the fused transport (one process, one
program), the two-party path in one process (``--transport local``: the
client of ``--mode`` over ``LocalTransport`` to an in-process
``ServerRuntime`` built from the same seed, with the wire compression of
``--compress``), or the client party of a two-process run over HTTP
(``--transport http --server-url URL``). The client of each mode:
``SplitClientTrainer`` (``split``), ``USplitClientTrainer``
(``u_split``: labels stay with the client) and ``FederatedClientTrainer``
(``federated``: local epochs, one FedAvg round an epoch). ``serve`` runs
the server party of ``--mode`` behind ``SplitHTTPServer`` until SIGINT;
a federated server's round size is ``SLT_NUM_CLIENTS`` (default 1):

  python -m split_learning_tpu_torch.launch.run train \
      --mode split --dataset synthetic --steps 20
  python -m split_learning_tpu_torch.launch.run train --transport local \
      --compress topk8 --compress-density 0.1 --dataset synthetic --steps 20
  python -m split_learning_tpu_torch.launch.run serve --port 8000 &
  python -m split_learning_tpu_torch.launch.run train --transport http \
      --server-url http://127.0.0.1:8000 --compress int8 --steps 20
  python -m split_learning_tpu_torch.launch.run train --mode u_split \
      --transport local --compress int8 --dataset synthetic --steps 20
  python -m split_learning_tpu_torch.launch.run serve --mode federated &
  python -m split_learning_tpu_torch.launch.run train --mode federated \
      --transport http --server-url http://127.0.0.1:8000 --epochs 2
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
picks the kernel. The image families are the split CNN, ResNet-18
(``resnet18``; ``resnet18_4stage``, whose K-stage chain waits for
ROADMAP item 16) and the ViT (``vit``) on ``mnist``, ``cifar10`` or
``synthetic``. The transformer families and the ViT take the JAX size
flags (``--d-model``, ``--num-heads``, ``--client-depth``,
``--server-depth``) and ``--attn``; the token families ``--seq-len``,
with the JAX command's checks: ``transformer_lm`` needs ``--dataset
lm``, ``transformer`` needs ``--dataset tokens``, an image model
refuses token data, and ResNet-18 refuses the size flags (rc 2). On a
two-party wire ``--compress-density auto`` warns and uses 0.1, as in
JAX (the adaptive controller drives the K-stage chain's hops only). A ``train`` client whose server reports another mode
exits 4, as in JAX.

Training as JAX's command configures it, on every transport and on
``serve`` (whose server party builds its own optimizer from them):
``--optimizer sgd|adam|adamw``, ``--momentum``, ``--weight-decay``,
``--warmup-steps``, ``--decay-steps``, ``--grad-clip-norm`` and
``--dtype float32|bfloat16`` (``runtime/state.py`` ``make_tx``).
``train --trace PATH`` writes the run's spans as a Chrome trace. As in
JAX, ``--failure-policy`` other than ``raise`` and ``--prefetch`` apply
to the split client only: in another mode they warn and fall back.
``--eval`` scores the composition each mode trains: the client's and
the server's stages (over HTTP the server's stay remote,
``evaluate_remote``; for ``u_split`` the client's A and C around them),
or the federated client's whole model.

Checkpoints, as in JAX: ``train --checkpoint-dir D`` saves the joint
state of every party the run holds at each epoch's end (and every
``--checkpoint-every`` steps on the fused transport) with ``meta.json``
beside it (the layout, mode, model, dataset, sizes, and ``framework``:
``torch``, which marks a port directory); ``--resume`` restores the
latest step, re-arms the in-process server's handshake and resumes the
data stream where it stopped (the epoch's shuffle and the batch in it),
so a resumed run is the uninterrupted one. A client over HTTP refuses
(rc 3) a server that is behind its checkpoint. ``serve --checkpoint-dir
--resume`` owns the server half: a server-only directory, or the server
subtree of a joint one (its own saves then go to ``server_party/``);
each save there follows the step's reply, so the sidecar holds that
reply's frame. ``eval`` and ``generate`` read a checkpoint (JAX's flags,
JSON record, ``[error]`` refusals and rc 2). A JAX checkpoint directory
is refused with rc 2. ``train --prefetch N`` stages the split client's
next batches on the device (``DevicePrefetch``); ``--require-real``
refuses the synthetic fallback.

The server under many clients, as in JAX: ``serve --coalesce-max N
[--coalesce-window-ms W] [--batching continuous]`` coalesces concurrent
split steps into one step a group (classifier plans; an LM plan is
refused with rc 2), ``--tenants/--quota/--slo-ms`` turn on admission
(429 with ``Retry-After``), ``--decouple-bwd [--apply-lag N]`` replies
before the server's update, and ``--no-overlap`` reads the reply inside
the lock. ``train --transport local`` takes ``--decouple-bwd``,
``--apply-lag`` and ``--no-overlap`` for its in-process server, and
``train --pipeline-depth W`` keeps W steps in flight
(``PipelinedSplitClientTrainer``; the in-process server then accepts
out-of-order steps, and over HTTP a server without
``--allow-out-of-order`` is refused with rc 5).

Not ported yet, each exiting 2 with the ROADMAP item it waits for:
``--replicas`` above 1 (item 19), the ``train`` flags of
:data:`TRAIN_NOT_PORTED` and the ``serve`` flags of
:data:`SERVE_NOT_PORTED`.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import sys
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def _ckpt_drain(ckptr):
    """Barrier on the checkpointer's writes on every exit path: saves
    are asynchronous, and an exception that skips the success path's
    barrier must not let interpreter teardown tear the newest step."""
    try:
        yield
    finally:
        if ckptr is not None:
            ckptr.wait_until_finished()


def _config_from_args(args):
    from split_learning_tpu_torch.utils.config import Config
    overrides = {}
    for field in ("mode", "model", "dataset", "batch_size", "epochs", "lr",
                  "optimizer", "momentum", "weight_decay", "warmup_steps",
                  "decay_steps", "grad_clip_norm", "microbatches", "seed",
                  "data_dir", "tracking", "transport", "server_url", "attn",
                  "dtype", "checkpoint_dir"):
        val = getattr(args, field, None)
        if val is not None:
            overrides[field] = val
    return Config.from_env(**overrides)


# the families that take --attn and the size flags, and those that take
# token ids (the ViT has attention but consumes images)
_ATTENTION_FAMILIES = ("transformer", "transformer_lm", "vit")
_TOKEN_FAMILIES = ("transformer", "transformer_lm")
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
    if cfg.model not in _TOKEN_FAMILIES and cfg.dataset in _TOKEN_SETS:
        return (f"dataset {cfg.dataset!r} is token-shaped; model "
                f"{cfg.model!r} consumes images (mnist | cifar10 | "
                "synthetic)")
    return None


def _size_kw_from_args(args) -> Dict[str, Any]:
    """The model-size flags given on the command line."""
    return {name: getattr(args, name) for name in (
        "d_model", "num_heads", "client_depth", "server_depth")
        if getattr(args, name, None) is not None}


def _plan_kw(model: str, attn: str, size_kw: Dict[str, Any],
             seq_len: Optional[int], dataset: str) -> Dict[str, Any]:
    """Plan-builder kwargs from the size flags. As in JAX
    (``_plan_size_kw``), ``max_len`` is derived, never persisted: a
    ``--seq-len`` above the 2048 default table extends it. ``attn`` goes
    to the attention families only. The ViT's ``channels`` (what flax
    reads off the sample at init) is the dataset's, derived the same
    way."""
    from split_learning_tpu_torch.data.datasets import image_shape
    kw = dict(size_kw)
    if model in _ATTENTION_FAMILIES:
        kw["attn"] = attn
    if model in _TOKEN_FAMILIES and seq_len and seq_len > 2048:
        kw["max_len"] = seq_len
    if model == "vit":
        kw["channels"] = image_shape(dataset)[2]
    return kw


# --------------------------------------------------------------------- #
# checkpoint layout bookkeeping (JAX's): meta.json beside the step
# directories records how the saved tree maps onto the parties

def _builder_size_defaults(model: str) -> Dict[str, Any]:
    """The size-parameterised plan builder's own defaults ({} for a
    family without sizes)."""
    if model in _TOKEN_FAMILIES:
        from split_learning_tpu_torch.models.transformer import (
            transformer_plan as builder)
    elif model == "vit":
        from split_learning_tpu_torch.models.vit import vit_plan as builder
    else:
        return {}
    params = inspect.signature(builder).parameters
    return {k: params[k].default for k in (
        "d_model", "num_heads", "client_depth", "server_depth")}


def _reconcile_ckpt_sizes(meta: Dict[str, Any], size_kw: Dict[str, Any],
                          seq_len: Optional[int], what: str,
                          model: str = ""):
    """Adopt-or-refuse against a checkpoint's recorded model sizes (JAX's
    rule). Returns ``(size_kw, seq_len, error)``: flags left out adopt
    the saved sizes and ``--seq-len``; explicit flags compare as
    effective plans (merged over the builder's defaults), so restating a
    default is accepted and only a different plan is refused."""
    saved = meta.get("size_kw", {})
    defaults = _builder_size_defaults(model)
    effective_saved = {**defaults, **saved}
    effective_req = {**effective_saved, **size_kw}
    if size_kw and effective_saved != effective_req:
        keys = sorted(set(effective_saved) | set(effective_req))
        conflicts = ", ".join(
            f"{k}: saved {effective_saved.get(k)} != requested "
            f"{effective_req.get(k)}" for k in keys
            if effective_saved.get(k) != effective_req.get(k))
        return size_kw, seq_len, (
            f"checkpoint was written with sizes {saved or '{}'} but "
            f"{what} requested {size_kw} ({conflicts})")
    if saved and not size_kw:
        print(f"[ckpt] {what} with the checkpoint's model sizes "
              f"{saved}", file=sys.stderr)
    size_kw = dict(saved)
    saved_seq = meta.get("seq_len")
    if saved_seq:
        if seq_len is None:
            seq_len = saved_seq
            print(f"[ckpt] {what} with the checkpoint's --seq-len "
                  f"{seq_len}", file=sys.stderr)
        elif seq_len != saved_seq:
            return size_kw, seq_len, (
                f"checkpoint was trained at --seq-len {saved_seq} but "
                f"{what} requested {seq_len}")
    return size_kw, seq_len, None


def _write_ckpt_meta(directory: str, layout: str, cfg,
                     size_kw: Optional[Dict[str, Any]] = None,
                     seq_len: Optional[int] = None) -> None:
    """JAX's meta.json, plus ``framework``, which marks a port
    directory."""
    path = os.path.join(os.path.abspath(os.path.expanduser(directory)),
                        "meta.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    meta = {"layout": layout, "mode": cfg.mode, "model": cfg.model,
            "dataset": cfg.dataset, "framework": "torch"}
    if size_kw:
        meta["size_kw"] = size_kw
    if seq_len is not None:
        meta["seq_len"] = seq_len
    with open(path, "w") as f:
        json.dump(meta, f)


def _read_ckpt_meta(directory: str) -> Dict[str, Any]:
    path = os.path.join(os.path.abspath(os.path.expanduser(directory)),
                        "meta.json")
    with open(path) as f:
        return json.load(f)


def _assemble_full_params(layout: str, raw: Dict[str, Any]):
    """Per-stage params for ``plan.apply`` from a saved tree."""
    if layout == "fused":
        return raw["trainer"]["params"]
    if layout == "split_local":
        return [raw["client"]["params"][0], raw["server"]["params"][0]]
    if layout == "u_split_local":
        return [raw["client_a"]["params"][0], raw["server"]["params"][0],
                raw["client_c"]["params"][0]]
    if layout == "federated":
        return raw["client"]["params"]
    if layout in ("chain", "pipeline"):
        raise NotImplementedError(
            f"not ported yet: a {layout!r} checkpoint (the K-stage chain, "
            "ROADMAP item 16)")
    raise ValueError(
        f"cannot evaluate a {layout!r} checkpoint: the client half alone "
        "does not form the full composition (train with --transport local "
        "or fused to checkpoint the joint state)")


def _client_params(plan, params):
    """The client-owned stages of a full composition, in plan order."""
    return [params[i] for i in plan.stages_of("client")]


def _on_device(params, device: torch.device):
    return [{k: v.to(device) for k, v in stage.items()} for stage in params]


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
    if args.pipeline_depth < 1:
        return f"--pipeline-depth must be >= 1 (got {args.pipeline_depth})"
    if not 0.0 < density <= 1.0:
        return f"--compress-density must be in (0, 1] (got {density})"
    if args.failure_policy is not None and args.max_retries < 0:
        return f"--max-retries must be >= 0 (got {args.max_retries})"
    return None


def _make_transport(args, cfg, density: float, server: Any,
                    depth: int = 1):
    """The client's wire: ``LocalTransport`` to the in-process server, or
    ``HttpTransport`` to ``cfg.server_url`` after its /health barrier;
    then the chaos schedule of ``--chaos`` around either. Returns
    ``(transport, rc)``: rc 4 when the server is in another mode, rc 5
    when a client with ``depth`` > 1 steps in flight meets a server that
    refuses out-of-order steps."""
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
        # a server predating the field is strict: refuse it too
        if depth > 1 and info.get("strict_steps", True):
            # fail fast: with W lanes the arrival order is a thread race,
            # and a strict server would 409 at random mid-run
            print(f"[transport] --pipeline-depth {depth} needs the server "
                  "started with serve --allow-out-of-order (it reports "
                  "strict_steps=true)", file=sys.stderr)
            transport.close()
            return None, 5
    if args.chaos:
        policy = ChaosPolicy(args.chaos, seed=args.chaos_seed)
        transport = ChaosTransport(transport, policy)
        print(f"[chaos] injecting {args.chaos!r} (seed {policy.seed}) on "
              "the client wire", file=sys.stderr)
    return transport, 0


def _given(v: Any) -> bool:
    return v is not None


# the JAX ``train`` flags the port does not run yet: (attribute, whether
# it asks for something unported, the flag, its ROADMAP item). Each
# exits 2 naming its item. ``--kernels`` and ``--download`` stay out by
# design (no kernel fallback knob; no network).
TRAIN_NOT_PORTED = (
    ("num_stages", lambda v: v is not None and v > 2,
     "--stages > 2 (the K-stage chain)", "item 16"),
    ("stage_urls", _given, "--stage-urls (the K-stage chain)", "item 16"),
    ("schedule", _given, "--schedule (the K-stage chain)", "item 16"),
    ("remat", bool, "--remat", "item 16"),
    ("gate_dropped_steps", bool,
     "--gate-dropped-steps (the K-stage chain)", "item 16"),
    ("num_clients", lambda v: v is not None and v > 1,
     "--num-clients > 1 (a data-parallel mesh)", "item 18"),
    ("model_parallel", lambda v: v is not None and v > 1,
     "--model-parallel > 1 (tensor parallelism)", "item 18"),
    ("mesh_data", lambda v: v > 1, "--mesh-data > 1 (a sharded server)",
     "item 18"),
    ("mesh_model", lambda v: v > 1, "--mesh-model > 1 (a sharded server)",
     "item 18"),
    ("coordinator", _given, "--coordinator (multi-host runs)", "item 18"),
    ("num_processes", _given, "--num-processes (multi-host runs)",
     "item 18"),
    ("process_id", _given, "--process-id (multi-host runs)", "item 18"),
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
    ("seq_parallel", lambda v: v is not None and v > 1,
     "--seq-parallel > 1 (context parallelism)", "item 21"),
    ("flight", _given, "--flight (the flight recorder)", "item 22"),
    ("telemetry_port", _given, "--telemetry-port (the telemetry ring)",
     "item 22"),
    ("profile_dir", _given, "--profile-dir (the phase profiler)",
     "item 22"),
    ("tracking_uri", _given, "--tracking-uri (MLflow)", "item 22"),
    ("scan_steps", lambda v: v > 1,
     "--scan-steps > 1 (steps batched per launch; CUDA graphs)", "item 7"),
)


def _refuse_unported(table, args) -> None:
    for attr, is_set, what, item in table:
        if is_set(getattr(args, attr)):
            raise NotImplementedError(
                f"not ported yet: {what} (ROADMAP {item})")


def _open_checkpoint(cfg, args, size_kw, seq_len):
    """The run's checkpointer and reconciled sizes. A ``--resume`` onto
    a sized checkpoint adopts its sizes, or refuses different ones; a
    JAX checkpoint directory is refused (``ValueError``)."""
    from split_learning_tpu_torch.runtime.checkpoint import Checkpointer
    if not cfg.checkpoint_dir:
        return None, size_kw, seq_len
    ckptr = Checkpointer(cfg.checkpoint_dir)
    if args.resume:
        try:
            meta = _read_ckpt_meta(cfg.checkpoint_dir)
        except (FileNotFoundError, json.JSONDecodeError, OSError):
            meta = None
        if meta is not None:
            size_kw, seq_len, err = _reconcile_ckpt_sizes(
                meta, size_kw, seq_len, "--resume", model=cfg.model)
            if err:
                raise ValueError(err)
    return ckptr, size_kw, seq_len


def cmd_train(args) -> int:
    from split_learning_tpu_torch import obs
    from split_learning_tpu_torch.data import batches, load_dataset
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import (
        CircuitBreaker, FederatedClientTrainer, FusedSplitTrainer,
        PipelinedSplitClientTrainer, ServerRuntime, SplitClientTrainer,
        USplitClientTrainer, check_config, check_supported)
    from split_learning_tpu_torch.runtime.checkpoint import (
        read_latest_extras)
    from split_learning_tpu_torch.runtime.state import state_tree
    from split_learning_tpu_torch.tracking import make_logger
    from split_learning_tpu_torch.transport.chaos import parse_chaos_spec
    from split_learning_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # no GPU for "cuda": raise before any work
    try:
        _refuse_unported(TRAIN_NOT_PORTED, args)
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
        ckptr, size_kw, seq_len = _open_checkpoint(
            cfg, args, _size_kw_from_args(args), args.seq_len)
        plan = get_plan(model=cfg.model, mode=cfg.mode, dtype=cfg.dtype,
                        **_plan_kw(cfg.model, cfg.attn, size_kw, seq_len,
                                   cfg.dataset))
        depth = args.pipeline_depth if two_party else 1
        if depth > 1 and cfg.mode != "split":
            print(f"[warn] --pipeline-depth ignored in mode {cfg.mode!r} "
                  "(split only)", file=sys.stderr)
            depth = 1
        server = None
        if cfg.transport == "local":
            # the in-process server from the same seed: each party keeps
            # its own stages of one init, as a fused run would start; a
            # depth-W window's steps arrive out of order
            server = ServerRuntime(plan, cfg,
                                   torch.Generator().manual_seed(cfg.seed),
                                   strict_steps=depth <= 1,
                                   overlap=not args.no_overlap,
                                   decouple_bwd=args.decouple_bwd,
                                   apply_lag=args.apply_lag,
                                   device=args.device)
        elif two_party:
            check_config(cfg)
        else:
            check_supported(cfg)
    except (ValueError, NotImplementedError) as e:
        print(f"[error] {e}", file=sys.stderr)
        return 2
    if cfg.model not in _ATTENTION_FAMILIES and cfg.attn != "full":
        print(f"[warn] --attn {cfg.attn!r} ignored: model {cfg.model!r} has "
              "no attention (transformer/vit only)", file=sys.stderr)
    if not two_party:
        for flag, val in (("--compress", args.compress),
                          ("--chaos", args.chaos),
                          ("--failure-policy", args.failure_policy)):
            if val is not None:
                print(f"[warn] {flag} {val!r} ignored: the fused "
                      "transport has no wire", file=sys.stderr)
        if args.pipeline_depth > 1:
            print(f"[warn] --pipeline-depth ignored on transport="
                  f"{cfg.transport!r} (the in-flight window applies to the "
                  "local/http transports; the fused step has no wire to "
                  "overlap)", file=sys.stderr)
        if args.decouple_bwd:
            print(f"[warn] --decouple-bwd ignored on transport="
                  f"{cfg.transport!r} (2BP splits the server party's reply "
                  "from its weight update; the fused path has no server "
                  "party)", file=sys.stderr)
    prefetch = args.prefetch
    if prefetch > 0 and (cfg.mode != "split" or not two_party):
        print(f"[warn] --prefetch ignored in mode {cfg.mode!r} (split "
              "only)" if cfg.mode != "split" else
              "[warn] --prefetch ignored: the fused transport stages "
              "nothing", file=sys.stderr)
        prefetch = 0
    fail_policy = args.failure_policy or "raise"
    if two_party and fail_policy != "raise" and (cfg.mode != "split"
                                                 or depth > 1):
        print(f"[warn] --failure-policy {fail_policy} applies to the "
              "serialized split client only; ignored here", file=sys.stderr)
        fail_policy = "raise"
    if two_party:
        # the wire before the data: a server in another mode stops here
        transport, rc = _make_transport(args, cfg, density, server, depth)
        if rc:
            return rc
    try:
        ds = load_dataset(cfg.dataset, cfg.data_dir, seq_len=seq_len,
                          allow_synthetic=not args.require_real)
    except FileNotFoundError as e:
        print(f"[error] {e} (--require-real)", file=sys.stderr)
        return 2
    if ds.synthetic:
        print(f"[data] using synthetic {ds.name} "
              f"({len(ds.train)} train examples)", file=sys.stderr)
    sample = ds.train.x[:cfg.batch_size]
    seed_gen = torch.Generator().manual_seed(cfg.seed)
    logger = make_logger(cfg)
    if two_party and cfg.mode == "u_split":
        trainer = USplitClientTrainer(plan, cfg, seed_gen, transport,
                                      logger=logger, device=args.device)
        layout = "u_split_local" if server is not None else "client_only"
    elif two_party and cfg.mode == "federated":
        trainer = FederatedClientTrainer(plan, cfg, seed_gen, transport,
                                         device=args.device)
        layout = "federated"
    elif two_party and depth > 1:
        factory = None
        if server is None:
            # one connection and one EF ledger per in-flight lane, as JAX
            def factory():
                from split_learning_tpu_torch.transport import HttpTransport
                return HttpTransport(cfg.server_url,
                                     compress=args.compress or "none",
                                     density=density)
        trainer = PipelinedSplitClientTrainer(
            plan, cfg, seed_gen, transport, depth=depth,
            transport_factory=factory, logger=logger, device=args.device)
        layout = "split_local" if server is not None else "client_only"
    elif two_party:
        # retry clients probe /health while the server is down instead
        # of resending full steps; its jitter is seeded from the config
        breaker = (CircuitBreaker(transport.health, seed=cfg.seed)
                   if fail_policy == "retry" else None)
        trainer = SplitClientTrainer(plan, cfg, seed_gen, transport,
                                     failure_policy=fail_policy,
                                     max_retries=args.max_retries,
                                     logger=logger, breaker=breaker,
                                     device=args.device)
        layout = "split_local" if server is not None else "client_only"
    else:
        trainer = FusedSplitTrainer(plan, cfg, seed_gen, sample,
                                    device=args.device)
        layout = "fused"

    def party_tree() -> Dict[str, Any]:
        tree = trainer.export_states()
        if server is not None:
            tree["server"] = state_tree(server.export_state())
        return tree

    def save(step: int) -> None:
        if ckptr is None or ckptr.last_enqueued == step:
            return
        ckptr.save(step, party_tree(), extras=(
            server.capture_runtime_extras(step) if server is not None
            else None))

    def refuse(rc: int) -> int:
        if two_party:
            transport.close()
        return rc

    start_step = 0
    if ckptr is not None:
        latest = ckptr.latest_step()
        if args.resume and latest is not None:
            raw = ckptr.restore_raw(latest)
            try:
                trainer.restore_states(raw)
                if server is not None:
                    # re-arms the handshake at the restored step; the
                    # sidecar's replay cache and EF ledger come back when
                    # one was written for exactly this step
                    server.resume_from(raw["server"], latest,
                                       extras=read_latest_extras(
                                           ckptr.directory, step=latest))
            except (KeyError, ValueError) as e:
                print(f"[error] cannot resume from {cfg.checkpoint_dir}: "
                      f"{e}", file=sys.stderr)
                return refuse(2)
            start_step = latest
            print(f"[ckpt] resumed at step {start_step} from "
                  f"{cfg.checkpoint_dir}", file=sys.stderr)
            if layout == "client_only":
                # a fresh server with a resumed client would desync the
                # composition: the server reports its acknowledged step
                srv_step = transport.health().get("step", -1)
                if srv_step < start_step - 1:
                    print(f"[ckpt] server is at step {srv_step} but the "
                          f"client checkpoint is at {start_step}: the "
                          "server half was not resumed. Restart it with "
                          "serve --checkpoint-dir ... --resume, or drop "
                          "--resume here to start both halves fresh.",
                          file=sys.stderr)
                    return refuse(3)
        # after the resume: a refused one leaves the directory's meta
        _write_ckpt_meta(cfg.checkpoint_dir, layout, cfg, size_kw, seq_len)
    # --trace: per-step spans (obs/), off by default and free when off
    step_tracer = obs.enable() if args.trace else None

    # the data stream resumes where it stopped: the epoch's shuffle and
    # the batch in it, so a resumed run sees the uninterrupted run's data
    per_epoch = max(len(ds.train) // cfg.batch_size, 1)
    budget = {"n": args.steps if args.steps else None,
              "epoch": start_step // per_epoch,
              "skip": start_step % per_epoch, "taken": 0}

    def data_iter():
        # reshuffle per epoch; each call is one epoch
        epoch_seed = cfg.seed + budget["epoch"]
        budget["epoch"] += 1
        skip, budget["skip"] = budget["skip"], 0
        for i, xy in enumerate(batches(ds.train, cfg.batch_size,
                                       seed=epoch_seed,
                                       drop_remainder=True)):
            if i < skip:
                continue
            if budget["n"] is not None:
                if budget["n"] <= 0:
                    return
                budget["n"] -= 1
            budget["taken"] += 1
            yield xy

    def on_epoch_end(epoch: int, next_step: int) -> None:
        save(next_step)

    t0 = time.time()
    final_loss = float("nan")
    with _ckpt_drain(ckptr):
        if isinstance(trainer, FederatedClientTrainer):
            # one FedAvg round an epoch; an epoch the step cap leaves
            # empty is not run
            epochs = (cfg.epochs if not args.steps
                      else min(cfg.epochs, -(-args.steps // per_epoch)))
            trainer.train(data_iter, epochs=epochs, start_step=start_step,
                          on_epoch_end=on_epoch_end)
            for i, loss in enumerate(trainer.losses):
                final_loss = loss
                logger.log_metric("loss", loss, step=start_step + i)
        elif two_party:
            records = trainer.train(
                data_iter, epochs=cfg.epochs, start_step=start_step,
                on_epoch_end=on_epoch_end,
                **({"prefetch": prefetch} if prefetch else {}))
            if records:
                final_loss = records[-1].loss
        else:
            step = start_step
            for _ in range(cfg.epochs):  # data_iter enforces the step cap
                for x, y in data_iter():
                    final_loss = trainer.train_step(x, y)
                    logger.log_metric("loss", final_loss, step=step)
                    step += 1
                    if (args.checkpoint_every and (step - start_step)
                            % args.checkpoint_every == 0):
                        save(step)
                save(step)
    n_steps = budget["taken"]
    dt = time.time() - t0
    if step_tracer is not None:
        obs.disable()
        out_path = step_tracer.export_chrome(args.trace)
        print(f"[trace] {len(step_tracer.spans())} spans -> {out_path}",
              file=sys.stderr)
    if n_steps and dt > 0:
        logger.log_metric("steps_per_sec", n_steps / dt, step=n_steps)
    if two_party:
        # a pipelined client's lanes each count their own round trips
        wire = (trainer.stats if depth > 1 else transport.stats).summary()
        mode = args.compress or ("none" if server is None else None)
        print(f"[transport] {cfg.transport} compress={mode} "
              f"round_trips={wire['round_trips']} "
              f"bytes_sent={wire['bytes_sent']} "
              f"bytes_received={wire['bytes_received']} "
              f"compression_ratio={wire.get('compression_ratio', 1.0):.2f} "
              f"dropped_batches={getattr(trainer, 'dropped_batches', 0)}")
    if ckptr is not None:
        ckptr.close()

    if args.eval:
        from split_learning_tpu_torch.runtime.evaluate import (
            evaluate, evaluate_remote)
        client_params = (list(trainer.params) if cfg.mode == "u_split"
                         else [trainer.params])
        if cfg.mode == "federated" or not two_party:
            res = evaluate(plan, trainer.params, ds.test,
                           batch_size=cfg.batch_size)
        elif cfg.transport == "http":
            # the server's stage stays remote: split-party inference
            res = evaluate_remote(plan, client_params, transport,
                                  ds.test, batch_size=cfg.batch_size)
        else:
            # the composition in stage order: [A, trunk, C] for u_split
            params = [*client_params[:1], server.params,
                      *client_params[1:]]
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


# the JAX ``serve`` flags the port does not run yet: (attribute, whether
# it asks for something unported, the flag, its ROADMAP item). Each
# exits 2 naming its item.
SERVE_NOT_PORTED = (
    ("role", lambda v: v != "server",
     "--role stage (a stage party of the K-stage chain)", "item 16"),
    ("remat", bool, "--remat", "item 16"),
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


def _serve_checkpoint(args, cfg, runtime, size_kw, seq_len):
    """``serve``'s checkpointing (JAX's): the server half's saves and its
    resume. A joint directory (written by a local or fused ``train``)
    keeps its meta; this server's saves go to its ``server_party/``, and
    a resume takes the newer of the two. Returns ``(checkpointer,
    error)``; the error is the ``[error]`` text of an rc 2."""
    from split_learning_tpu_torch.runtime.checkpoint import (
        Checkpointer, foreign_checkpoint, read_latest_extras)
    from split_learning_tpu_torch.runtime.state import state_tree
    directory = cfg.checkpoint_dir
    foreign = foreign_checkpoint(os.path.abspath(directory))
    if foreign is not None:
        return None, foreign
    try:
        existing = _read_ckpt_meta(directory)
    except FileNotFoundError:
        existing = None
    except (json.JSONDecodeError, OSError) as e:
        print(f"[ckpt] meta.json unreadable ({e}); treating {directory} as "
              "a server-only dir", file=sys.stderr)
        existing = None
    joint = existing is not None and existing.get(
        "layout", "server_only") != "server_only"
    if existing is not None:
        for key, got in (("mode", cfg.mode), ("model", cfg.model)):
            want = existing.get(key)
            if want is not None and want != got:
                return None, (
                    f"checkpoint dir was written with {key}={want!r} but "
                    f"serve was started with {key}={got!r}; refusing to "
                    "resume a mismatched server half")
    save_dir = (os.path.join(directory, "server_party") if joint
                else directory)
    ckptr = Checkpointer(save_dir)
    _write_ckpt_meta(save_dir, "server_only", cfg, size_kw, seq_len)
    if joint:
        print(f"[ckpt] joint-layout dir: periodic server saves go to "
              f"{save_dir}", file=sys.stderr)
    latest = ckptr.latest_step()
    if args.resume and joint:
        root = Checkpointer(directory)
        root_latest = root.latest_step()
        if root_latest is not None and (latest is None
                                        or root_latest > latest):
            layout = existing.get("layout")
            raw = root.restore_raw(root_latest)
            if layout == "fused":
                # one whole-plan tree: the server's share of the params,
                # its optimizer restarted (the joint moments span every
                # stage), as in JAX
                if cfg.warmup_steps or cfg.decay_steps or cfg.momentum \
                        or cfg.optimizer != "sgd":
                    print("[ckpt] note: optimizer state (moments / "
                          "lr-schedule position) restarts on a fused-layout "
                          "handoff; params and the step handshake are "
                          "exact", file=sys.stderr)
                params = raw["trainer"]["params"]
                tree = state_tree(runtime.state)
                tree["params"] = (list(params) if cfg.mode == "federated"
                                  else [params[runtime.server_stage]])
                tree["step"] = root_latest
                runtime.resume_from(tree, root_latest)
            elif "server" not in raw:
                return None, (
                    f"checkpoint layout {layout!r} under {directory} has no "
                    "server subtree to resume (it was written by a client "
                    "whose server was remote)")
            else:
                runtime.resume_from(
                    raw["server"], root_latest,
                    extras=read_latest_extras(root.directory,
                                              step=root_latest))
            print(f"[ckpt] server resumed at step {root_latest} from joint "
                  f"{directory} (layout {layout})", file=sys.stderr)
            latest = None  # handled: skip the server_party branch
    if args.resume and latest is not None:
        raw = ckptr.restore_raw(latest)
        runtime.resume_from(raw["server"], latest, extras=read_latest_extras(
            ckptr.directory, step=latest))
        print(f"[ckpt] server resumed at step {latest} from "
              f"{ckptr.directory}", file=sys.stderr)
    every = max(args.checkpoint_every, 1)
    if cfg.mode == "federated":
        # FedAvg replies are not replay-cached: save under the lock, at
        # the acknowledged step, as JAX does
        def on_step(step: int) -> None:
            if (step + 1) % every == 0:
                runtime.checkpoint(ckptr, step + 1)
        runtime.on_step = on_step
    else:
        # once the step's frame is pinned to its replay entry, so the
        # sidecar holds it: a retry of the step after a restart is
        # served the original bytes
        def on_reply(client_id: int, op: str, step: int) -> None:
            if op in ("split_step", "u_backward") and (step + 1) % every == 0:
                runtime.checkpoint(ckptr, step + 1)
        runtime.on_reply = on_reply
    return ckptr, None


def cmd_serve(args) -> int:
    """The server party behind ``SplitHTTPServer`` until SIGINT: JAX's
    ``cmd_serve``, server role, with the same ``[serve]`` line, and its
    checkpoints (``--checkpoint-dir``, ``--checkpoint-every``,
    ``--resume``)."""
    import signal

    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import ServerRuntime
    from split_learning_tpu_torch.transport import (
        ChaosPolicy, SplitHTTPServer)
    from split_learning_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # no GPU for "cuda": raise before any work
    try:
        _refuse_unported(SERVE_NOT_PORTED, args)
        if not 0.0 < args.compress_density <= 1.0:
            raise ValueError(f"--compress-density must be in (0, 1] (got "
                             f"{args.compress_density})")
        cfg = _config_from_args(args)
        size_kw, seq_len = _size_kw_from_args(args), args.seq_len
        if cfg.checkpoint_dir:
            try:
                prior = _read_ckpt_meta(cfg.checkpoint_dir)
            except (FileNotFoundError, json.JSONDecodeError, OSError):
                prior = None
            if prior is not None:
                size_kw, seq_len, err = _reconcile_ckpt_sizes(
                    prior, size_kw, seq_len, "serve", model=cfg.model)
                if err:
                    raise ValueError(err)
        plan = get_plan(model=cfg.model, mode=cfg.mode, dtype=cfg.dtype,
                        **_plan_kw(cfg.model, cfg.attn, size_kw, seq_len,
                                   cfg.dataset))
        # the seed's init, of which the server keeps its own stage: a
        # client started from the same seed holds the other one
        runtime = ServerRuntime(
            plan, cfg, torch.Generator().manual_seed(cfg.seed),
            strict_steps=not args.allow_out_of_order,
            coalesce_max=args.coalesce_max,
            coalesce_window_ms=args.coalesce_window_ms,
            overlap=not args.no_overlap,
            batching=args.batching,
            tenants=args.tenants, quota=args.quota, slo_ms=args.slo_ms,
            decouple_bwd=args.decouple_bwd, apply_lag=args.apply_lag,
            ef_mode="clapping" if args.compress == "clapping" else "topk8",
            device=args.device)
        chaos = (ChaosPolicy(args.chaos, seed=args.chaos_seed)
                 if args.chaos else None)
        ckptr = None
        if cfg.checkpoint_dir:
            ckptr, err = _serve_checkpoint(args, cfg, runtime, size_kw,
                                           seq_len)
            if err:
                raise ValueError(err)
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
        with _ckpt_drain(ckptr):
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        if main_thread:  # a second SIGINT must not cut the shutdown short
            signal.signal(signal.SIGINT, signal.SIG_IGN)
        print("[serve] shutting down", flush=True)
        server.stop()
    finally:
        runtime.close()
        if ckptr is not None:
            # saves are asynchronous: make the newest durable before the
            # process exits, or a resume comes back behind the clients
            ckptr.close()
        if main_thread:
            signal.signal(signal.SIGINT, prev)
    return 0


def _resolve_checkpoint(args, cfg, cmd: str,
                        require_model: Optional[str] = None):
    """``eval``/``generate``'s preamble (JAX's): mode, model and dataset
    from the flags or the checkpoint's meta, the reconciled sizes, the
    plan, the step (``--step`` or the latest) and the full composition
    on ``--device``. Returns ``(None, rc)`` on a user error, else
    ``((meta, mode, model, dataset, plan, step, params, seq_len),
    None)``."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime.checkpoint import (
        Checkpointer, foreign_checkpoint)
    ckdir = cfg.checkpoint_dir
    if not ckdir:
        print(f"{cmd} requires --checkpoint-dir", file=sys.stderr)
        return None, 2
    foreign = foreign_checkpoint(os.path.abspath(ckdir))
    if foreign is not None:
        print(f"[error] {foreign}", file=sys.stderr)
        return None, 2
    try:
        meta = _read_ckpt_meta(ckdir)
    except (ValueError, OSError) as e:
        print(f"[error] no readable meta.json under {ckdir} ({e})",
              file=sys.stderr)
        return None, 2
    mode = args.mode or meta.get("mode", cfg.mode)
    model = args.model or meta.get("model", cfg.model)
    dataset = args.dataset or meta.get("dataset", cfg.dataset)
    if require_model and model != require_model:
        print(f"[error] {cmd} needs a {require_model!r} checkpoint "
              f"(got {model!r})", file=sys.stderr)
        return None, 2
    size_kw, seq_len, err = _reconcile_ckpt_sizes(
        meta, _size_kw_from_args(args), args.seq_len, cmd, model=model)
    if err:
        print(f"[error] {err}", file=sys.stderr)
        return None, 2
    try:
        ckptr = Checkpointer(ckdir)
        plan = get_plan(model=model, mode=mode, dtype=cfg.dtype,
                        **_plan_kw(model, cfg.attn, size_kw, seq_len,
                                   dataset))
        step = args.step if args.step is not None else ckptr.latest_step()
        params = _assemble_full_params(meta["layout"],
                                       ckptr.restore_raw(step))
    except (ValueError, NotImplementedError, FileNotFoundError) as e:
        print(f"[error] {e}", file=sys.stderr)
        return None, 2
    from split_learning_tpu_torch.utils.device import resolve_device
    params = _on_device(params, resolve_device(args.device))
    return (meta, mode, model, dataset, plan, step, params, seq_len), None


def _test_split(cfg, dataset: str, seq_len: Optional[int]):
    from split_learning_tpu_torch.data import load_dataset
    return load_dataset(dataset, cfg.data_dir,
                        seq_len=seq_len if dataset in _TOKEN_SETS else None)


def eval_checkpoint(args) -> Tuple[Optional[dict], Any]:
    """``eval``'s work: ``(record, result)``, JAX's record (its keys,
    values rounded to 4 places) and the unrounded result of ``evaluate``
    (or ``evaluate_remote`` with ``--server-url``); or ``(None, rc)``."""
    from split_learning_tpu_torch.runtime.evaluate import (
        evaluate, evaluate_remote)
    from split_learning_tpu_torch.utils.device import resolve_device
    resolve_device(args.device)
    cfg = _config_from_args(args)
    resolved, rc = _resolve_checkpoint(args, cfg, "eval")
    if resolved is None:
        return None, rc
    meta, mode, model, dataset, plan, step, params, seq_len = resolved
    ds = _test_split(cfg, dataset, seq_len)
    record = {"checkpoint_step": step, "dataset": dataset}
    if args.server_url:
        # split-party inference: the client stages here, the serving
        # peer's server stage behind /predict
        from split_learning_tpu_torch.transport import HttpTransport
        transport = HttpTransport(args.server_url,
                                  compress=args.compress or "none")
        try:
            transport.wait_ready(timeout=60.0)
            res = evaluate_remote(plan, _client_params(plan, params),
                                  transport, ds.test,
                                  batch_size=cfg.batch_size)
        finally:
            transport.close()
        record["remote_server"] = args.server_url
    else:
        res = evaluate(plan, params, ds.test, batch_size=cfg.batch_size)
    record.update({
        "accuracy": round(res["accuracy"], 4),
        "loss": round(res["loss"], 4),
        "perplexity": (None if res["perplexity"] is None
                       else round(res["perplexity"], 4)),
        "examples": res["examples"],
        "predictions": res["predictions"],
    })
    return record, res


def cmd_eval(args) -> int:
    record, res = eval_checkpoint(args)
    if record is None:
        return res
    print(json.dumps(record))
    return 0


def _vocab_of(params) -> Optional[int]:
    """The token table's size: the first stage's 2-D embedding weight."""
    from split_learning_tpu_torch.models.transformer import EMBED_LAYERS
    for name, leaf in params[0].items():
        parts = name.split(".")
        if len(parts) >= 2 and parts[-2] in EMBED_LAYERS and leaf.ndim == 2:
            return int(leaf.shape[0])
    return None


def generate_checkpoint(args) -> Tuple[Optional[dict], Any]:
    """``generate``'s work: ``(record, tokens)`` or ``(None, rc)``. The
    refusals are JAX's, in its order: the sampling flags, the prompt,
    then the checkpoint (a non-LM one), then ids outside its vocabulary.
    Sampling draws from a ``torch.Generator`` seeded ``--seed``: the same
    seed gives the same tokens (not JAX's, whose PRNG differs)."""
    from split_learning_tpu_torch.runtime.generate import (
        generate_remote, greedy_generate, sample_generate)
    from split_learning_tpu_torch.utils.device import resolve_device
    resolve_device(args.device)
    cfg = _config_from_args(args)
    # the flags before the (expensive) checkpoint restore; no falsy-zero
    # coercion: --temperature 0 / --top-p 0 are errors, never rewritten
    sampled = (args.temperature is not None or args.top_p is not None
               or args.top_k > 0)
    temperature = 1.0 if args.temperature is None else args.temperature
    top_p = 1.0 if args.top_p is None else args.top_p
    if sampled and not temperature > 0.0:
        print(f"[error] --temperature must be > 0 (got {temperature}); "
              "omit all sampling flags for deterministic greedy decode",
              file=sys.stderr)
        return None, 2
    if sampled and not 0.0 < top_p <= 1.0:
        print(f"[error] --top-p must be in (0, 1] (got {top_p})",
              file=sys.stderr)
        return None, 2
    if args.top_k < 0:
        print(f"[error] --top-k must be >= 0 (got {args.top_k})",
              file=sys.stderr)
        return None, 2
    tokens = None
    if args.prompt:
        try:
            tokens = [int(tok) for tok in args.prompt.split(",")]
        except ValueError:
            print(f"[error] --prompt must be comma-separated token ids "
                  f"(got {args.prompt!r})", file=sys.stderr)
            return None, 2
        if any(tok < 0 for tok in tokens):
            print(f"[error] --prompt token ids must be >= 0 "
                  f"(got {args.prompt!r})", file=sys.stderr)
            return None, 2
    resolved, rc = _resolve_checkpoint(args, cfg, "generate",
                                       require_model="transformer_lm")
    if resolved is None:
        return None, rc
    meta, mode, model, dataset, plan, step, params, seq_len = resolved
    if tokens is not None:
        prompt = np.asarray([tokens], np.int32)
        vocab = _vocab_of(params)
        if vocab is not None:
            bad = [tok for tok in tokens if tok >= vocab]
            if bad:
                print(f"[error] --prompt ids {bad} are outside the "
                      f"checkpoint's vocabulary ({vocab})", file=sys.stderr)
                return None, 2
    else:
        # no prompt: the test split's first example, as eval reads it
        ds = _test_split(cfg, dataset, seq_len)
        prompt = np.asarray(ds.test.x[:1, :args.prompt_len], np.int32)
    record = {"checkpoint_step": step, "prompt_len": int(prompt.shape[1]),
              "n_new": args.n_new,
              "decode": "sampled" if sampled else "greedy"}
    rng = (torch.Generator(device=args.device).manual_seed(cfg.seed)
           if sampled else None)
    if args.server_url:
        from split_learning_tpu_torch.transport import HttpTransport
        transport = HttpTransport(args.server_url,
                                  compress=args.compress or "none")
        try:
            transport.wait_ready(timeout=60.0)
            kw = (dict(rng=rng, temperature=temperature, top_k=args.top_k,
                       top_p=top_p) if sampled else {})
            out = generate_remote(plan, _client_params(plan, params),
                                  transport, prompt, args.n_new,
                                  device=args.device, **kw)
        finally:
            transport.close()
        record["remote_server"] = args.server_url
    elif sampled:
        out = sample_generate(plan, params, prompt, args.n_new, rng,
                              temperature=temperature, top_k=args.top_k,
                              top_p=top_p, kv_cache=not args.no_kv_cache,
                              device=args.device)
    else:
        out = greedy_generate(plan, params, prompt, args.n_new,
                              kv_cache=not args.no_kv_cache,
                              device=args.device)
    out = np.asarray(torch.as_tensor(out).cpu())
    record["prompt"] = out[:, :prompt.shape[1]].tolist()
    record["tokens"] = out[:, prompt.shape[1]:].tolist()
    return record, out


def cmd_generate(args) -> int:
    """Decode from a causal-LM checkpoint: KV-cache local decode by
    default, the re-forward decode with ``--no-kv-cache``, split-party
    decode (the client stages here, the server's behind /predict) with
    ``--server-url``."""
    record, out = generate_checkpoint(args)
    if record is None:
        return out
    print(json.dumps(record))
    return 0


def _add_shared(p: argparse.ArgumentParser) -> None:
    """The flags ``train`` and ``serve`` share: the model, its sizes, the
    data, the seed and the device."""
    p.add_argument("--mode", choices=["split", "federated", "u_split"],
                   default=None)
    p.add_argument("--model", default=None,
                   help="split_cnn | split_cnn_chain3 | resnet18 | "
                        "resnet18_4stage | vit | transformer | "
                        "transformer_lm")
    p.add_argument("--dataset", default=None,
                   help="mnist | cifar10 | synthetic | tokens "
                        "(transformer) | lm (transformer_lm)")
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
    p.add_argument("--tracking-uri", dest="tracking_uri", default=None)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--checkpoint-dir", dest="checkpoint_dir", default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; raises without a GPU) or cpu "
                        "(the kernels' plain versions)")
    # size overrides for the transformer and ViT families (the fixed
    # reference CNN and ResNet-18 reject them)
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
                   help="transformer/vit attention: full (dense) or flash "
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


def _add_server_knobs(p: argparse.ArgumentParser, serve: bool) -> None:
    """The server party's knobs of the many-clients slice: the in-process
    server's on ``train --transport local``, the HTTP server's on
    ``serve`` (which adds coalescing and admission)."""
    if serve:
        p.add_argument("--coalesce-max", dest="coalesce_max", type=int,
                       default=1,
                       help="split mode, classifier plans: run up to N "
                            "concurrent split steps as one server step "
                            "(one group-mean update); 1 = serialized")
        p.add_argument("--coalesce-window-ms", dest="coalesce_window_ms",
                       type=float, default=2.0,
                       help="how long a group waits for peers after its "
                            "first request (with --coalesce-max > 1)")
        p.add_argument("--batching", choices=["window", "continuous"],
                       default="window",
                       help="the coalescer's flush policy: 'window' waits "
                            "out --coalesce-window-ms; 'continuous' takes "
                            "what is queued the moment the previous group "
                            "is launched, earliest deadline first")
        p.add_argument("--tenants", type=int, default=1,
                       help="admission control: clients map to tenants by "
                            "client_id %% tenants")
        p.add_argument("--quota", type=float, default=None,
                       help="admission control: steps/s per tenant (token "
                            "bucket, burst one second of quota); over "
                            "quota a step gets 429 + Retry-After")
        p.add_argument("--slo-ms", dest="slo_ms", type=float, default=None,
                       help="admission control: a tenant's latency SLO; "
                            "the continuous batcher picks groups earliest-"
                            "deadline-first")
    where = "" if serve else "local transport: "
    p.add_argument("--no-overlap", dest="no_overlap", action="store_true",
                   help=f"{where}read the step's reply (the loss, a host "
                        "copy) inside the server's lock")
    p.add_argument("--decouple-bwd", dest="decouple_bwd",
                   action="store_true",
                   help=f"split mode, {where}2BP: reply with the cut "
                        "gradient first and queue the server's weight "
                        "update behind it")
    p.add_argument("--apply-lag", dest="apply_lag", type=int, default=0,
                   help="with --decouple-bwd: up to N updates may queue, "
                        "so a step's forward uses weights at most N "
                        "updates old; 0 applies each before the next step")


def _add_train_not_ported(p: argparse.ArgumentParser) -> None:
    """JAX's ``train`` flags that exit 2 here (:data:`TRAIN_NOT_PORTED`;
    ``--tracking-uri`` and ``--remat`` are shared)."""
    p.add_argument("--stages", dest="num_stages", type=int, default=None)
    p.add_argument("--stage-urls", dest="stage_urls", default=None)
    p.add_argument("--schedule", choices=["gpipe", "1f1b"], default=None)
    p.add_argument("--gate-dropped-steps", dest="gate_dropped_steps",
                   action="store_true")
    p.add_argument("--num-clients", dest="num_clients", type=int,
                   default=None)
    p.add_argument("--model-parallel", dest="model_parallel", type=int,
                   default=None)
    p.add_argument("--mesh-data", dest="mesh_data", type=int, default=1)
    p.add_argument("--mesh-model", dest="mesh_model", type=int, default=1)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", dest="num_processes", type=int,
                   default=None)
    p.add_argument("--process-id", dest="process_id", type=int, default=None)
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
    p.add_argument("--seq-parallel", dest="seq_parallel", type=int,
                   default=None)
    p.add_argument("--flight", default=None, metavar="PATH")
    p.add_argument("--telemetry-port", dest="telemetry_port", type=int,
                   default=None)
    p.add_argument("--profile-dir", dest="profile_dir", default=None)
    p.add_argument("--scan-steps", dest="scan_steps", type=int, default=0)


def _add_serve_not_ported(p: argparse.ArgumentParser) -> None:
    """JAX's ``serve`` flags that exit 2 here (:data:`SERVE_NOT_PORTED`)."""
    p.add_argument("--role", choices=["server", "stage"], default="server")
    p.add_argument("--stage-index", dest="stage_index", type=int, default=1)
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


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    """The command line as ``main`` reads it (``args.fn`` runs it)."""
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
                    help="split mode, local/http transports: keep up to N "
                         "cut-layer exchanges in flight (bounded-staleness "
                         "async SGD; an http server needs "
                         "--allow-out-of-order when N > 1)")
    pt.add_argument("--prefetch", type=int, default=0,
                    help="split mode: stage the next N batches on the "
                         "device while the current step is in flight "
                         "(DevicePrefetch; 0 = off; ignored with a warning "
                         "in the other modes)")
    pt.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint before training")
    pt.add_argument("--checkpoint-every", dest="checkpoint_every", type=int,
                    default=0,
                    help="also checkpoint every N steps (fused transport)")
    pt.add_argument("--require-real", dest="require_real",
                    action="store_true",
                    help="fail if real dataset files are absent instead of "
                         "falling back to synthetic data")
    pt.add_argument("--eval", action="store_true",
                    help="report test-split accuracy after training "
                         "(over HTTP: split-party, evaluate_remote)")
    pt.add_argument("--trace", default=None, metavar="PATH",
                    help="per-step span tracing (obs/): write a Chrome-"
                         "trace JSON here on exit (Perfetto-loadable). "
                         "Off = zero overhead")
    _add_server_knobs(pt, serve=False)
    _add_train_not_ported(pt)
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
    ps.add_argument("--resume", action="store_true",
                    help="restore the latest server checkpoint on startup")
    ps.add_argument("--checkpoint-every", dest="checkpoint_every", type=int,
                    default=100,
                    help="checkpoint the server half every N acknowledged "
                         "steps (with --checkpoint-dir)")
    _add_server_knobs(ps, serve=True)
    _add_serve_not_ported(ps)
    ps.set_defaults(fn=cmd_serve)

    pe = sub.add_parser("eval", help="evaluate a checkpoint on the test split")
    _add_shared(pe)
    pe.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    pe.add_argument("--server-url", dest="server_url", default=None,
                    help="split-party inference: run only the client-"
                         "owned stages here and the server-owned compute "
                         "behind this serving server's /predict")
    pe.set_defaults(fn=cmd_eval)

    pg = sub.add_parser("generate",
                        help="decode from a causal-LM checkpoint "
                             "(KV-cache local, or split-party remote)")
    _add_shared(pg)
    pg.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    pg.add_argument("--prompt", default=None,
                    help="comma-separated token ids (default: first "
                         "test-split example)")
    pg.add_argument("--prompt-len", dest="prompt_len", type=int, default=16,
                    help="tokens taken from the test split when no "
                         "--prompt is given")
    pg.add_argument("--n-new", dest="n_new", type=int, default=32,
                    help="tokens to generate")
    pg.add_argument("--temperature", type=float, default=None,
                    help="sample at this temperature (omit = greedy)")
    pg.add_argument("--top-k", dest="top_k", type=int, default=0)
    pg.add_argument("--top-p", dest="top_p", type=float, default=None)
    pg.add_argument("--no-kv-cache", dest="no_kv_cache",
                    action="store_true",
                    help="use the O(T^2) re-forward reference decode")
    pg.add_argument("--server-url", dest="server_url", default=None,
                    help="split-party decode: client stages here, server "
                         "compute behind this server's /predict")
    pg.set_defaults(fn=cmd_generate)
    return ap.parse_args(argv)


def main(argv: Optional[list] = None) -> int:
    args = parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
