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
(``resnet18``, and ``resnet18_4stage`` for the K-stage chain) and the
ViT (``vit``) on ``mnist``, ``cifar10`` or ``synthetic``. The transformer families and the ViT take the JAX size
flags (``--d-model``, ``--num-heads``, ``--client-depth``,
``--server-depth``) and ``--attn``; the token families ``--seq-len``,
with the JAX command's checks: ``transformer_lm`` needs ``--dataset
lm``, ``transformer`` needs ``--dataset tokens``, an image model
refuses token data, and ResNet-18 refuses the size flags (rc 2). On a
two-party wire ``--compress-density auto`` warns and uses 0.1, as in
JAX (the adaptive controller drives the K-stage chain's hops only). A
``train`` client whose server reports another mode exits 4, as in JAX.

The K-stage chain, as in JAX: ``train --stages S`` (S > 2, mode split,
a chain plan of S stages: ``split_cnn_chain3``, ``resnet18_4stage``) on
``--transport local`` (in-process ``StageRuntime`` parties behind
``LocalTransport``, with ``--compress``), ``device`` (behind
``DeviceTransport``: CUDA tensors on every hop) or ``http`` (``serve
--role stage --stage-index i`` parties behind ``--stage-urls``; one of
another role, index or ``--microbatches`` exits 4), driven by
``PipelineRunner`` over ``--microbatches`` with ``--schedule
gpipe|1f1b``; each stage defers its update under ``--apply-lag``.
``--compress-density auto`` binds one adaptive controller to every hop
wire, ``--chaos`` wraps every hop wire, ``--gate-dropped-steps`` exits
1 unless every step's loss is finite and every in-process stage
acknowledged the last step. Its checkpoints are the ``chain`` layout,
which ``--resume`` and ``eval`` read.

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

Observability, as in JAX, each off (and free) until asked for: ``train
--trace PATH`` and ``serve --trace PATH`` write the party's spans as a
Chrome trace, with the in-process server's per-program MFU
(``trace_metadata``) or the chain's per-stage report as metadata
events; ``--flight PATH`` (or ``SLT_FLIGHT``) arms the flight recorder
and dumps it at exit, on SIGTERM (``fatal:sigterm``) and on a fatal
exception, and ``serve`` answers ``GET /debug/flight``; ``train
--profile-dir D`` writes a ``torch.profiler`` trace of the run to
``D/device_trace.json`` and prints the split client's phase summary;
``serve --telemetry [--telemetry-interval-s S] [--telemetry-slo-ms MS]``
(or ``SLT_TELEMETRY``) serves the windowed ring on ``GET /telemetry``;
``train --telemetry-port P`` gives the chain's hub a ``/telemetry`` of
its own and prints the fleet view (``obs/federate.py``) of the hub and
its in-process stages; ``--tracking mlflow --tracking-uri URI`` logs to
an MLflow server (its REST protocol where the package is absent).

Server replicas, as in JAX: ``serve --replicas N`` (the server role),
``train --transport local --replicas N`` (the in-process server) and
``train --stages S --transport local --replicas N`` (each chain stage)
put N same-seed runtimes behind a ``ReplicaGroup``'s sticky router, with
``--replica-sync-every K`` (FedAvg of the replicas every K group steps)
and ``--handoff live|checkpoint``; ``--autoscale [--autoscale-min/-max/
-cooldown-s]`` (or ``SLT_AUTOSCALE``) drives the replica count from the
telemetry ring's windows (and turns telemetry on). JAX's refusals hold:
replicas or autoscaling with ``serve --checkpoint-dir`` and replicas on
a chain off ``--transport local`` or with ``--checkpoint-dir`` exit 2.
``/health`` of a group carries its ``replicas`` block.

``train --scan-steps N`` (the fused transport) runs N steps as one chunk
and reads their N losses once; N is capped to ``--checkpoint-every``
when saving, with JAX's warning, and other transports warn and ignore
it. ``--remat`` rematerialises the stage forwards in the backward (the
fused trainer and the served party).

The ``model`` mesh axis, as JAX's: ``train --model-parallel N`` on the
fused transport trains over ``global_mesh(num_clients, model_parallel,
seq_parallel)`` (tensor parallelism, ``parallel/tensor.py``, composed
with ``--seq-parallel``'s T-partitioned step); another
transport warns as JAX does and trains without it. ``--mesh-data`` and
``--mesh-model`` shard the served party (``serve``), the in-process
server of ``train --transport local`` and the chain's in-process
stages (``train --stages S``, whose per-microbatch rows must tile
``--mesh-data``; over http each stage takes its own at ``serve``). On
the CPU a mesh takes ``SLT_HOST_DEVICES`` ranks; on the card one a card,
or ``SLT_CUDA_RANKS`` ranks over the cards (virtual ranks on one card).
A mesh larger than that exits 2.
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
                  "data_dir", "tracking", "tracking_uri", "transport",
                  "server_url", "attn", "remat", "num_clients",
                  "model_parallel", "seq_parallel",
                  "dtype", "checkpoint_dir", "num_stages", "schedule"):
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
    if layout in ("fused", "pipeline"):
        return raw["trainer"]["params"]
    if layout == "split_local":
        return [raw["client"]["params"][0], raw["server"]["params"][0]]
    if layout == "u_split_local":
        return [raw["client_a"]["params"][0], raw["server"]["params"][0],
                raw["client_c"]["params"][0]]
    if layout == "federated":
        return raw["client"]["params"]
    if layout == "chain":
        # the hub's stage 0, then stage1..stage<S-1> in chain order
        stages = sorted((k for k in raw if k.startswith("stage")),
                        key=lambda k: int(k[len("stage"):]))
        return [raw["client"]["params"][0],
                *(raw[k]["params"][0] for k in stages)]
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
    """The two-party flags' checks."""
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


def _server_mesh(args):
    """The sharded server's mesh from ``--mesh-data``/``--mesh-model``
    (``serve``, the in-process server of ``train --transport local`` and
    the chain's in-process stages), JAX's: 1x1, the default, is None. A
    mesh larger than the devices raises ``ValueError`` (exit 2): on the
    CPU ``SLT_HOST_DEVICES`` ranks, with the remedy in the message; on
    the card one rank a card, or ``SLT_CUDA_RANKS`` ranks
    (``parallel/mesh.py``)."""
    from split_learning_tpu_torch.parallel.mesh import (
        make_host_mesh, make_mesh)
    data = int(getattr(args, "mesh_data", 1) or 1)
    model = int(getattr(args, "mesh_model", 1) or 1)
    if data * model <= 1:
        return None
    if torch.device(args.device).type == "cpu":
        try:
            return make_host_mesh(data=data, model=model)
        except RuntimeError as e:
            raise ValueError(str(e)) from e
    return make_mesh(num_clients=data, model_parallel=model,
                     device=args.device)


# --------------------------------------------------------------------- #
# server replicas and elastic autoscaling (runtime/replica.py,
# runtime/autoscale.py)

def _group_kw(args, cfg, density: float,
              as_cfg: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """``maybe_replicate``'s knobs from the flags, as JAX reads them: the
    sync compression rides the wire's (topk8/clapping; int8 and none
    keep the dense sync); under ``--autoscale`` (``as_cfg``) always a
    group, from ``--autoscale-min`` replicas up."""
    return dict(sync_every=args.replica_sync_every or 0,
                handoff=args.handoff or "live", seed=cfg.seed,
                sync_compress=(args.compress if args.compress in
                               ("topk8", "clapping") else None),
                sync_density=float(density),
                min_replicas=(None if as_cfg is None
                              else as_cfg["min_replicas"]))


def _start_autoscaler(group, make_replica, as_cfg: Dict[str, Any], ring,
                      coalesce_max: int = 1, slo_ms: Optional[float] = None):
    """The autoscaler over ``group``, fed by ``ring``'s windows, its pump
    started at the ring's interval; prints JAX's banner."""
    from split_learning_tpu_torch.runtime.autoscale import (
        Autoscaler, policy_from_config)
    autoscaler = Autoscaler(group, make_replica, policy_from_config(as_cfg),
                            ring, coalesce_max=coalesce_max, slo_ms=slo_ms)
    autoscaler.start(ring.interval_s)
    print(f"[autoscale] policy on: min={as_cfg['min_replicas']} "
          f"max={as_cfg['max_replicas']} cooldown={as_cfg['cooldown_s']}s",
          file=sys.stderr)
    return autoscaler


class _TrainElastic:
    """``train --autoscale``'s control loop over the in-process group: a
    telemetry ring over the group's metrics (the policy's signals) and
    the autoscaler's pump. :meth:`close` stops both."""

    def __init__(self, group, make_replica, as_cfg: Dict[str, Any]) -> None:
        from split_learning_tpu_torch.obs import telemetry as obs_telemetry
        self.ring = obs_telemetry.start(group.metrics, force=True)
        self.autoscaler = _start_autoscaler(group, make_replica, as_cfg,
                                            self.ring,
                                            slo_ms=self.ring.slo_ms)

    def close(self) -> None:
        from split_learning_tpu_torch.obs import telemetry as obs_telemetry
        # the pump first: no scale event races the run's teardown
        self.autoscaler.close()
        obs_telemetry.stop()


def _stage_step(srt) -> int:
    """A chain stage's acknowledged step; a replicated stage's is the
    group-wide furthest (the trained state may sit on any replica)."""
    h = srt.health()
    grp = h.get("replicas")
    if grp is not None and "step_max" in grp:
        return int(grp["step_max"])
    return int(h.get("step", -1))


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


def _train_data(args, cfg, seq_len):
    """The training data of ``cfg.dataset`` (the synthetic fallback
    announced), or None after the ``--require-real`` refusal."""
    from split_learning_tpu_torch.data import load_dataset
    try:
        ds = load_dataset(cfg.dataset, cfg.data_dir, seq_len=seq_len,
                          allow_synthetic=not args.require_real)
    except FileNotFoundError as e:
        print(f"[error] {e} (--require-real)", file=sys.stderr)
        return None
    if ds.synthetic:
        print(f"[data] using synthetic {ds.name} "
              f"({len(ds.train)} train examples)", file=sys.stderr)
    return ds


def _data_stream(ds, cfg, steps: int, start_step: int):
    """``(data_iter, budget, per_epoch)``: each ``data_iter()`` call is
    one epoch of batches, reshuffled per epoch, at most ``steps`` in all
    (0: no cap). The stream resumes where ``start_step`` left it: the
    epoch's shuffle and the batch in it, so a resumed run sees the
    uninterrupted run's data."""
    from split_learning_tpu_torch.data import batches
    per_epoch = max(len(ds.train) // cfg.batch_size, 1)
    budget = {"n": steps if steps else None,
              "epoch": start_step // per_epoch,
              "skip": start_step % per_epoch, "taken": 0}

    def data_iter():
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
    return data_iter, budget, per_epoch


def _chain_wires(args, cfg, plan, dc, density, compress):
    """The chain's parties and wires: ``(stage runtimes, transports,
    rc)``. Over http the stages are ``serve --role stage`` processes
    behind ``--stage-urls`` (rc 2 on a wrong count, rc 4 on a party of
    another role, stage index or microbatch count); otherwise in-process
    ``StageRuntime`` parties from the run's seed behind ``LocalTransport``
    (the codec's ``--compress``) or ``DeviceTransport``; with
    ``--replicas N`` each stage is N same-seed replicas behind a
    ``ReplicaGroup`` (``--transport local`` only). ``--chaos`` wraps
    every wire in one seeded policy."""
    from split_learning_tpu_torch.runtime.stage import StageRuntime
    from split_learning_tpu_torch.transport import (
        ChaosPolicy, ChaosTransport, DeviceTransport, HttpTransport,
        LocalTransport)
    M = cfg.microbatches
    stage_rts, transports = [], []
    if cfg.transport == "http":
        urls = [u.strip() for u in (args.stage_urls or "").split(",")
                if u.strip()]
        if len(urls) != plan.num_stages - 1:
            print(f"[error] chain over http needs --stage-urls with "
                  f"{plan.num_stages - 1} URLs (one per remote stage, "
                  f"chain order; got {len(urls)})", file=sys.stderr)
            return [], [], 2
        for i, url in enumerate(urls):
            t = HttpTransport(url, compress=compress or "none",
                              density=density, density_controller=dc,
                              wire_id=f"hop{i + 1}")
            transports.append(t)
            info = t.wait_ready(timeout=args.wait_server)
            want = (("role", "stage", "start it with serve --role stage "
                     f"--stage-index {i + 1}"),
                    ("stage_index", i + 1, "start it with serve --role "
                     f"stage --stage-index {i + 1}"),
                    ("microbatches", M, f"this client runs --microbatches "
                     f"{M}; the 1/M loss scaling must agree"))
            for key, value, hint in want:
                if info.get(key) != value:
                    print(f"[error] {url} reports {key}="
                          f"{info.get(key)!r}, expected {value!r} ({hint})",
                          file=sys.stderr)
                    for tr in transports:
                        tr.close()
                    return [], [], 4
    else:
        from split_learning_tpu_torch.runtime.replica import maybe_replicate
        ef_mode = "clapping" if compress == "clapping" else "topk8"
        group_kw = _group_kw(args, cfg, density)
        for i in range(1, plan.num_stages):
            def make_stage(_ridx: int, _i: int = i) -> StageRuntime:
                # one seed for every replica: one stage model, N parties
                return StageRuntime(plan, _i, cfg,
                                    torch.Generator().manual_seed(cfg.seed),
                                    microbatches=M, apply_lag=args.apply_lag,
                                    mesh=_server_mesh(args),
                                    ef_mode=ef_mode, device=args.device)
            srt = maybe_replicate(make_stage, args.replicas, **group_kw)
            stage_rts.append(srt)
            transports.append(
                DeviceTransport(srt) if cfg.transport == "device"
                else LocalTransport(srt, compress=compress, density=density,
                                    density_controller=dc))
    if args.chaos:
        policy = ChaosPolicy(args.chaos, seed=args.chaos_seed)
        # one policy, every hop wire: the draws key on (path, hop_seq)
        transports = [ChaosTransport(t, policy) for t in transports]
        print(f"[chaos] injecting {args.chaos!r} (seed {policy.seed}) on "
              "every hop wire", file=sys.stderr)
    return stage_rts, transports, 0


class _ChainFleet:
    """The chain's telemetry plane (JAX's hub ring): the hub's windowed
    ring over its own step and hop registry, served on ``GET /telemetry``
    with ``--telemetry-port``, and one ring a stage over each in-process
    stage's metrics, so :meth:`close` can fold the whole chain into
    ``obs/federate.py``'s fleet view (the bottleneck party per window)."""

    def __init__(self, runner, stage_rts, cfg: Dict[str, Any],
                 port: Optional[int], own_tracer: bool) -> None:
        from split_learning_tpu_torch.obs import federate as obs_federate
        from split_learning_tpu_torch.obs import telemetry as obs_telemetry
        from split_learning_tpu_torch.obs.metrics import Registry
        self.own_tracer = own_tracer
        reg = Registry()
        runner.telemetry_registry = reg
        self.hub = obs_telemetry.enable(
            reg.snapshot, party="hub", interval_s=cfg["interval_s"],
            capacity=cfg["capacity"],
            slo=obs_telemetry.tracker_from_config(cfg))
        self.stages = [
            (srt.stage_index, obs_telemetry.TelemetryRing(
                srt.metrics, party=srt.party, interval_s=cfg["interval_s"],
                capacity=cfg["capacity"])) for srt in stage_rts]
        self.server = None
        if port is not None:
            self.server, _ = obs_federate.serve_telemetry(self.hub,
                                                          port=int(port))
            print(f"[telemetry] hub /telemetry on port "
                  f"{self.server.server_address[1]}", file=sys.stderr)
        self.hub.start_sampler()
        for _, ring in self.stages:
            ring.start_sampler()

    def close(self) -> Dict[str, Any]:
        """Close the last windows, stop serving, and return the fleet
        view's bottleneck count and critical path."""
        from split_learning_tpu_torch.obs import telemetry as obs_telemetry
        from split_learning_tpu_torch.obs.federate import FleetCollector
        # every ring closes the windows its clock has crossed, then its
        # partial one, so the rings end on the same window index
        for ring in [self.hub] + [r for _, r in self.stages]:
            ring.close()
            ring.advance()
            ring.advance(force=True)
        view = FleetCollector(
            [{"role": "hub", "dump": self.hub.dump()}]
            + [{"role": "stage", "stage": i, "dump": ring.dump()}
               for i, ring in self.stages]).collect()
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
        obs_telemetry.disable()
        if self.own_tracer:
            from split_learning_tpu_torch import obs
            obs.disable()
        return {"bottlenecks": view["bottlenecks"],
                "critical_path": view["critical_path"]}


def _chain_telemetry(args, runner, stage_rts) -> Optional[_ChainFleet]:
    """The chain's telemetry, on with ``--telemetry-port`` or
    ``SLT_TELEMETRY``; None (and nothing built) otherwise. Telemetry
    implies tracing: the windows read the tracer-gated histograms."""
    from split_learning_tpu_torch import obs
    from split_learning_tpu_torch.obs import telemetry as obs_telemetry
    port = args.telemetry_port
    cfg = obs_telemetry.env_config()
    if cfg is None and port is not None:
        cfg = {"interval_s": obs_telemetry.DEFAULT_INTERVAL_S,
               "capacity": obs_telemetry.DEFAULT_CAPACITY}
    if cfg is None:
        return None
    own = obs.get_tracer() is None
    if own:
        obs.enable()
    return _ChainFleet(runner, stage_rts, cfg, port, own)


def _train_chain(args, cfg, plan, ckptr, size_kw, seq_len) -> int:
    """``train --stages S`` (S > 2, mode split) on the local, device or
    http transport: stage 0 trains here in a ``PipelineRunner`` (GPipe or
    1F1B over ``--microbatches``), stages 1..S-1 are ``StageRuntime``
    parties, each deferring its update under ``--apply-lag``. Prints the
    wires' ``[transport] hop i`` and ``[pipeline] stage i: bubble=...``
    lines, the adaptive controller's ``[density]`` line, and with
    ``--gate-dropped-steps`` the exactly-once gate (rc 1 on a non-finite
    loss or a stage behind the last step). Checkpoints are the
    ``chain`` layout: one tree (``client``, ``stage1``...) and each
    in-process stage's sidecar under ``stage<i>/``."""
    from split_learning_tpu_torch import obs
    from split_learning_tpu_torch.runtime.checkpoint import (
        read_latest_extras, write_extras)
    from split_learning_tpu_torch.runtime.evaluate import evaluate
    from split_learning_tpu_torch.runtime.pipeline_runner import (
        PipelineRunner)
    from split_learning_tpu_torch.runtime.state import restore_state
    from split_learning_tpu_torch.tracking import make_logger
    from split_learning_tpu_torch.transport.chaos import parse_chaos_spec
    from split_learning_tpu_torch.transport.density import DensityController
    from split_learning_tpu_torch.utils.profiling import device_trace
    try:
        if plan.num_stages != cfg.num_stages:
            raise ValueError(
                f"--stages {cfg.num_stages} does not match model "
                f"{cfg.model!r} ({plan.num_stages} stages); pick a chain "
                "plan (e.g. split_cnn_chain3, resnet18_4stage)")
        if args.replicas > 1 and cfg.transport != "local":
            raise ValueError(
                "--replicas > 1 on the chain composes in-process stage "
                "parties behind the group router and needs --transport "
                "local (http stages are their own processes; the device "
                "wire's replay entries are device-resident and die with "
                "the replica)")
        if args.replicas > 1 and cfg.checkpoint_dir:
            raise ValueError(
                "--replicas > 1 does not compose with --checkpoint-dir yet "
                "(per-replica save/resume layout is ambiguous); drop one "
                "of them")
        if args.chaos:
            parse_chaos_spec(args.chaos)  # a bad spec fails here
        # --mesh-data/--mesh-model shard the in-process stage parties;
        # a stage scatters each microbatch over 'data', so the rows of a
        # microbatch must tile it (the sharded server's rule)
        mesh_data = int(args.mesh_data or 1)
        if cfg.transport != "http":
            _server_mesh(args)   # a mesh larger than the devices fails here
        if mesh_data * int(args.mesh_model or 1) > 1 \
                and cfg.transport == "http":
            print("[warn] --mesh-data/--mesh-model shard in-process "
                  "stage parties; remote http stages take their own "
                  "mesh flags at serve time — ignored here",
                  file=sys.stderr)
        elif mesh_data > 1 and (
                cfg.batch_size % cfg.microbatches
                or (cfg.batch_size // cfg.microbatches) % mesh_data):
            raise ValueError(
                f"--mesh-data {mesh_data} needs the per-microbatch rows "
                f"(batch_size/microbatches = {cfg.batch_size}/"
                f"{cfg.microbatches}) divisible by the data axis — the "
                "same rule as the sharded server role")
        compress = args.compress
        if compress and cfg.transport == "device":
            print("[warn] --compress ignored on --transport device "
                  "(zero-copy device wire; nothing to compress)",
                  file=sys.stderr)
            compress = None
        density, dc = args.compress_density, None
        if density == "auto":
            if compress in ("topk8", "clapping"):
                dc = DensityController()
            else:
                print("[warn] --compress-density auto needs --compress "
                      "topk8 or clapping; using the fixed default 0.1",
                      file=sys.stderr)
            density = 0.1  # the controller drives the wires it is bound to
        elif not 0.0 < density <= 1.0:
            raise ValueError(
                f"--compress-density must be in (0, 1] (got {density})")
    except (ValueError, NotImplementedError) as e:
        print(f"[error] {e}", file=sys.stderr)
        return 2
    if args.autoscale:
        print("[warn] --autoscale applies to the replicated server role "
              "only; ignored on the K-stage chain", file=sys.stderr)
    for flag, on in (("--pipeline-depth", args.pipeline_depth > 1),
                     ("--prefetch", args.prefetch > 0),
                     ("--decouple-bwd", args.decouple_bwd),
                     ("--failure-policy", args.failure_policy is not None)):
        if on:
            print(f"[warn] {flag} ignored on the K-stage chain (the runner "
                  "retries hops itself; every stage defers its update "
                  "under --apply-lag)", file=sys.stderr)
    stage_rts, transports, rc = _chain_wires(args, cfg, plan, dc, density,
                                             compress)
    if rc:
        return rc
    ds = _train_data(args, cfg, seq_len)
    if ds is None:
        return 2
    runner = PipelineRunner(plan, cfg, torch.Generator().manual_seed(cfg.seed),
                            None, transports,
                            microbatches=cfg.microbatches,
                            schedule=cfg.schedule, device=args.device)
    runner.density_controller = dc
    if compress:
        print(f"[compress] chain hop wires: {compress} (density "
              f"{'auto' if dc is not None else density})", file=sys.stderr)
    logger = make_logger(cfg)
    step_tracer = obs.enable() if args.trace else None
    fleet = _chain_telemetry(args, runner, stage_rts)

    start_step = 0
    if ckptr is not None:
        latest = ckptr.latest_step()
        if args.resume and latest is not None and stage_rts:
            raw = ckptr.restore_raw(latest)
            try:
                restore_state(runner.state, raw["client"])
                for srt in stage_rts:
                    # each stage's sidecar restores (or clears) its own
                    # replay cache and ledger
                    srt.resume_from(raw[srt.party], latest,
                                    extras=read_latest_extras(
                                        os.path.join(ckptr.directory,
                                                     srt.party),
                                        step=latest))
            except (KeyError, ValueError) as e:
                print(f"[error] cannot resume from {cfg.checkpoint_dir}: "
                      f"{e}", file=sys.stderr)
                return 2
            start_step = runner.steps_done = latest
            print(f"[ckpt] chain resumed at step {start_step} from "
                  f"{cfg.checkpoint_dir}", file=sys.stderr)
        elif not stage_rts:
            print("[warn] the chain over http checkpoints no party: the "
                  "stage processes own their state (JAX's behaviour)",
                  file=sys.stderr)
        _write_ckpt_meta(cfg.checkpoint_dir, "chain", cfg, size_kw, seq_len)

    def save_chain(step: int) -> None:
        if ckptr is None or not stage_rts or ckptr.last_enqueued == step:
            return
        # export_state flushes each stage's deferred queue first: the
        # joint tree never holds a party behind the replies it sent
        ckptr.save(step, {"client": runner.state,
                          **{srt.party: srt.export_state()
                             for srt in stage_rts}})
        for srt in stage_rts:
            d = os.path.join(ckptr.directory, srt.party)
            os.makedirs(d, exist_ok=True)
            write_extras(d, srt.export_runtime_extras(step))

    data_iter, budget, _ = _data_stream(ds, cfg, args.steps, start_step)
    step, bad_losses = start_step, 0
    final_loss = float("nan")
    t0 = time.time()
    try:
        with _ckpt_drain(ckptr), device_trace(args.profile_dir):
            for _ in range(cfg.epochs):
                for x, y in data_iter():
                    final_loss = runner.step(x, y, step)
                    if not np.isfinite(final_loss):
                        bad_losses += 1
                    logger.log_metric("loss", final_loss, step=step)
                    step += 1
                    if (args.checkpoint_every and (step - start_step)
                            % args.checkpoint_every == 0):
                        save_chain(step)
                save_chain(step)
    finally:
        meta = runner.trace_metadata()
        if fleet is not None:
            fleet = fleet.close()
        runner.close()
        for t in transports:
            t.close()
        for srt in stage_rts:
            srt.close()
        if ckptr is not None:
            ckptr.close()
    dt = time.time() - t0
    n_steps = budget["taken"]
    for i, t in enumerate(transports):
        print(f"[transport] hop {i + 1}: {t.stats.summary()}",
              file=sys.stderr)
    for st in meta["stages"]:
        bf = st["bubble_fraction"]
        shares = [st["busy_share_forward"], st["busy_share_backward"]]
        print(f"[pipeline] stage {st['stage']} [{st['schedule']}]: bubble="
              f"{bf if bf is None else round(bf, 3)} (ideal "
              f"{st['bubble_theoretical']:.3f}) host busy/wall fwd, bwd "
              f"{[v if v is None else round(v, 3) for v in shares]} "
              f"reply_p50={st['reply_p50_ms']:.1f}ms", file=sys.stderr)
    if fleet is not None:
        print(f"[telemetry] fleet {json.dumps(fleet)}", file=sys.stderr)
    _report_profile(None, args.profile_dir)
    if step_tracer is not None:
        obs.disable()
        out_path = step_tracer.export_chrome(args.trace,
                                             stage_metadata=meta)
        print(f"[trace] {len(step_tracer.spans())} spans -> {out_path}",
              file=sys.stderr)
    if "density" in meta:
        snap = meta["density"]
        print(f"[density] adaptive controller: windows="
              f"{snap['windows_closed']} densities={snap['densities']} "
              f"(budget {snap['budget_nats']} nats / {snap['window']}-step "
              "window)", file=sys.stderr)
    if args.gate_dropped_steps:
        # every scheduled step produced a finite loss and every stage
        # party acknowledged the last step
        want = step - 1
        lagging = [(srt.stage_index, _stage_step(srt))
                   for srt in stage_rts if _stage_step(srt) != want]
        if bad_losses or lagging:
            print(f"[gate] DROPPED-STEPS GATE FAILED: nonfinite_losses="
                  f"{bad_losses} lagging_stages={lagging} (want step "
                  f"{want})", file=sys.stderr)
            return 1
        handoffs = sum(int(srt.counters().get("replica_handoffs", 0))
                       for srt in stage_rts)
        print(f"[gate] ok: {n_steps} steps completed, 0 dropped"
              + (f" ({handoffs} replica handoff(s))" if handoffs else ""),
              file=sys.stderr)
    if n_steps and dt > 0:
        logger.log_metric("steps_per_sec", n_steps / dt, step=n_steps)
    if args.eval:
        if not stage_rts:
            print("[eval] full composition unavailable over a remote "
                  "transport; skipping", file=sys.stderr)
        else:
            params = [runner.params] + [srt.params for srt in stage_rts]
            res = evaluate(plan, params, ds.test, batch_size=cfg.batch_size)
            logger.log_metric("test_accuracy", res["accuracy"], step=n_steps)
            logger.log_metric("test_loss", res["loss"], step=n_steps)
            print(f"[eval] accuracy={res['accuracy']:.4f} "
                  f"loss={res['loss']:.4f} n={res['predictions']}")
    logger.close()
    print(f"[done] mode={cfg.mode} transport={cfg.transport} "
          f"steps={n_steps} final_loss={final_loss:.4f} "
          f"({n_steps / dt if dt > 0 else 0.0:.2f} steps/s)")
    return 0


def _scan_chunk(args, saving: bool) -> int:
    """``--scan-steps``'s chunk, JAX's rule: with saves every
    ``--checkpoint-every`` steps a chunk is capped to that many (saves
    land on chunk boundaries), and a cap to 1 is the stepwise loop."""
    scan = args.scan_steps or 0
    if scan > 1 and saving and args.checkpoint_every \
            and scan > args.checkpoint_every:
        print(f"[warn] --scan-steps {scan} capped to --checkpoint-every "
              f"{args.checkpoint_every} so checkpoint cadence is preserved",
              file=sys.stderr)
        scan = args.checkpoint_every
    return scan if scan > 1 else 0


def _fused_mesh(cfg, plan, sample, size_kw, seq_len, multi_host: bool,
                device: str):
    """The fused transport's mesh, JAX's rules: ``--seq-parallel`` is
    ignored (with a warning) for a model without a sequence axis or a
    ViT whose patch tokens do not divide over it; a mesh is built for
    ``--num-clients`` > 1, ``--model-parallel`` > 1, ``--seq-parallel`` >
    1 or a multi-host run (too few devices raise ``ValueError``); a ring form
    with no ``seq`` axis warns that it runs the single-device math; an
    attention plan is rebuilt with the mesh. Returns ``(cfg, mesh,
    plan)``."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.parallel import global_mesh
    from split_learning_tpu_torch.parallel.mesh import SEQ_AXIS
    attention_family = cfg.model in _ATTENTION_FAMILIES
    if cfg.seq_parallel > 1 and not attention_family:
        print(f"[warn] --seq-parallel ignored: model {cfg.model!r} "
              "has no sequence axis (transformer/vit only)", file=sys.stderr)
        cfg = cfg.replace(seq_parallel=1)
    if cfg.seq_parallel > 1 and cfg.model == "vit":
        from split_learning_tpu_torch.models.vit import vit_plan
        patch = inspect.signature(vit_plan).parameters["patch"].default
        h, w = sample.shape[1:3]
        t_tokens = (h // patch) * (w // patch)
        if t_tokens % cfg.seq_parallel:
            print(f"[warn] --seq-parallel {cfg.seq_parallel} ignored: "
                  f"{t_tokens} patch tokens ({h}x{w}, patch {patch}) do not "
                  "divide across it", file=sys.stderr)
            cfg = cfg.replace(seq_parallel=1)
    mesh = None
    if (cfg.num_clients > 1 or cfg.model_parallel > 1
            or cfg.seq_parallel > 1 or multi_host):
        mesh = global_mesh(num_clients=cfg.num_clients, num_stages=1,
                           model_parallel=cfg.model_parallel,
                           seq_parallel=cfg.seq_parallel, device=device)
    if attention_family and cfg.attn in ("ring", "ring_flash", "ulysses") \
            and (mesh is None or SEQ_AXIS not in mesh.axis_names):
        fallback = ("the single-device flash kernel"
                    if cfg.attn == "ring_flash" else "dense attention")
        print(f"[warn] --attn {cfg.attn!r} runs as {fallback}: no 'seq' "
              "mesh axis (pass --seq-parallel > 1 to shard the sequence)",
              file=sys.stderr)
    if attention_family and mesh is not None:
        plan = get_plan(model=cfg.model, mode=cfg.mode, dtype=cfg.dtype,
                        mesh=mesh, **_plan_kw(cfg.model, cfg.attn, size_kw,
                                              seq_len, cfg.dataset))
    return cfg, mesh, plan


def _train_fused(args, cfg, trainer, data_iter, logger, save,
                 start_step: int, saving: bool) -> float:
    """The fused transport's loop: stepwise, or with ``--scan-steps N``
    chunks of N batches through ``train_epoch`` (the N steps launched
    back to back, their N losses read in one host read) and the tail of
    an epoch (fewer than N batches) stepwise. Each step's loss, and the
    lr where a schedule is on (``make_lr`` on the host), is logged under
    its step's number; saves land on the ``--checkpoint-every``
    boundaries and at each epoch's end, as JAX's. Returns the last
    loss."""
    from split_learning_tpu_torch.obs import dispatch_debug as obs_dispatch
    from split_learning_tpu_torch.runtime.state import make_lr
    scan = _scan_chunk(args, saving) if cfg.transport == "fused" else 0
    lr_fn = make_lr(cfg)
    if not callable(lr_fn):   # a constant lr is not logged
        lr_fn = None
    every = args.checkpoint_every
    step, final_loss = start_step, float("nan")

    def log(loss: float) -> None:
        logger.log_metric("loss", loss, step=step)
        if lr_fn is not None:
            logger.log_metric("lr", float(lr_fn(step)), step=step)

    for _ in range(cfg.epochs):  # data_iter enforces the step cap
        if not scan:
            tail = data_iter()
        else:
            buf_x, buf_y = [], []
            for x, y in data_iter():
                buf_x.append(x)
                buf_y.append(y)
                if len(buf_x) < scan:
                    continue
                series = trainer.train_epoch(np.stack(buf_x),
                                             np.stack(buf_y))
                buf_x, buf_y = [], []
                with obs_dispatch.expected_d2h(trainer._dd):
                    losses = series.tolist()   # the chunk's one host read
                for final_loss in losses:
                    log(final_loss)
                    step += 1
                if every and ((step - start_step) // every
                              != (step - start_step - len(losses)) // every):
                    save(step)
            tail = zip(buf_x, buf_y)
        for x, y in tail:
            final_loss = trainer.train_step(x, y)
            log(final_loss)
            step += 1
            if every and (step - start_step) % every == 0:
                save(step)
        save(step)
    return final_loss


def _report_profile(phase_prof, profile_dir: Optional[str]) -> None:
    """``--profile-dir``'s report, JAX's lines: the phase summary, the
    transport fraction, where the device trace went."""
    if phase_prof is not None and phase_prof.summary():
        print(f"[profile] {json.dumps(phase_prof.summary())}",
              file=sys.stderr)
        frac = phase_prof.fraction("transport")
        if frac > 0:  # 0.0: no transport phase (the fused step)
            print(f"[profile] transport fraction: {frac:.3f}",
                  file=sys.stderr)
    if profile_dir:
        from split_learning_tpu_torch.utils.profiling import TRACE_FILE
        print(f"[profile] device trace written to "
              f"{os.path.join(profile_dir, TRACE_FILE)} (view in "
              "Perfetto)", file=sys.stderr)


def cmd_train(args) -> int:
    from split_learning_tpu_torch.parallel.distributed import shutdown
    try:
        return _train(args)
    finally:
        shutdown()   # a multi-host run leaves its process group


def _train(args) -> int:
    from split_learning_tpu_torch import obs
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.parallel.distributed import (
        init_multi_host, is_coordinator)
    from split_learning_tpu_torch.runtime import (
        CircuitBreaker, FederatedClientTrainer, FusedSplitTrainer,
        PipelinedSplitClientTrainer, ServerRuntime, SplitClientTrainer,
        USplitClientTrainer, check_config, check_supported)
    from split_learning_tpu_torch.runtime import autoscale as rt_autoscale
    from split_learning_tpu_torch.runtime.checkpoint import (
        read_latest_extras)
    from split_learning_tpu_torch.runtime.replica import maybe_replicate
    from split_learning_tpu_torch.runtime.state import state_tree
    from split_learning_tpu_torch.tracking import make_logger
    from split_learning_tpu_torch.transport.chaos import parse_chaos_spec
    from split_learning_tpu_torch.utils.device import resolve_device
    from split_learning_tpu_torch.utils.profiling import (
        PhaseProfiler, device_trace)

    resolve_device(args.device)  # no GPU for "cuda": raise before any work
    try:
        # a multi-host run joins its process group before any work (a
        # no-op for one process)
        multi_host = init_multi_host(args.coordinator, args.num_processes,
                                     args.process_id, device=args.device)
        cfg = _config_from_args(args)
        err = _pairing_error(cfg)
        if err is None and args.seq_len is not None:
            if args.seq_len <= 0:
                err = f"--seq-len must be positive (got {args.seq_len})"
            elif cfg.dataset not in _TOKEN_SETS:
                err = (f"--seq-len applies to the token datasets (got "
                       f"--dataset {cfg.dataset!r})")
        chain = (cfg.mode == "split" and cfg.num_stages > 2
                 and cfg.transport in ("local", "http", "device"))
        if cfg.transport == "device" and not chain:
            err = err or (
                "--transport device is the co-located K-stage chain: it "
                "needs mode=split, a chain plan and --stages > 2 (the "
                "2-party split has no device-native wire: use --transport "
                "local)")
        two_party = cfg.transport in ("local", "http") and not chain
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
        server = make_replica = as_cfg = None
        if chain:
            check_config(cfg)
        elif cfg.transport == "local":
            # the in-process server from the same seed: each party keeps
            # its own stages of one init, as a fused run would start; a
            # depth-W window's steps arrive out of order
            def make_replica(_idx: int) -> ServerRuntime:
                # every replica from the same seed: the group starts as
                # one model, and the FedAvg sync keeps it one
                return ServerRuntime(plan, cfg,
                                     torch.Generator().manual_seed(cfg.seed),
                                     strict_steps=depth <= 1,
                                     overlap=not args.no_overlap,
                                     decouple_bwd=args.decouple_bwd,
                                     apply_lag=args.apply_lag,
                                     mesh=_server_mesh(args),
                                     device=args.device)
            as_cfg = rt_autoscale.args_config(args)
            server = maybe_replicate(make_replica, args.replicas,
                                     **_group_kw(args, cfg, density, as_cfg))
        elif two_party or cfg.transport == "pipeline":
            check_config(cfg)
        else:
            check_supported(cfg)
    except (ValueError, NotImplementedError) as e:
        print(f"[error] {e}", file=sys.stderr)
        return 2
    if cfg.transport != "fused" and cfg.model_parallel > 1:
        print(f"[warn] --model-parallel ignored on transport="
              f"{cfg.transport!r} (tensor parallelism requires the "
              f"fused transport)", file=sys.stderr)
        cfg = cfg.replace(model_parallel=1)
    if cfg.transport not in ("fused", "pipeline") and cfg.seq_parallel > 1:
        print(f"[warn] --seq-parallel ignored on transport="
              f"{cfg.transport!r} (context parallelism requires the fused "
              "transport)", file=sys.stderr)
    if cfg.transport != "fused" and args.scan_steps > 1:
        print(f"[warn] --scan-steps ignored on transport="
              f"{cfg.transport!r} (only the fused transport scans steps)",
              file=sys.stderr)
    if chain:
        return _train_chain(args, cfg, plan, ckptr, size_kw, seq_len)
    if server is None and (args.replicas > 1 or args.autoscale):
        print(f"[warn] --replicas/--autoscale ignored on transport="
              f"{cfg.transport!r} (they replicate the in-process server of "
              "--transport local and serve's server role)", file=sys.stderr)
    if args.telemetry_port is not None:
        print("[warn] --telemetry-port applies to the K-stage chain (the "
              "hub's ring); ignored", file=sys.stderr)
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
    ds = _train_data(args, cfg, seq_len)
    if ds is None:
        return 2
    sample = ds.train.x[:cfg.batch_size]
    seed_gen = torch.Generator().manual_seed(cfg.seed)
    mesh = None
    try:
        if cfg.transport == "fused":
            cfg, mesh, plan = _fused_mesh(cfg, plan, sample, size_kw,
                                          seq_len, multi_host, args.device)
        elif cfg.transport == "pipeline":
            from split_learning_tpu_torch.parallel import global_mesh
            mesh = global_mesh(num_clients=cfg.num_clients,
                               num_stages=plan.num_stages,
                               device=args.device)
    except (ValueError, NotImplementedError) as e:
        print(f"[error] {e}", file=sys.stderr)
        return 2
    if multi_host and not is_coordinator():
        # one metrics stream a job: the other processes stay silent
        cfg = cfg.replace(tracking="noop")
    logger = make_logger(cfg)
    # --profile-dir: the phase profiler (the split client's compute vs
    # transport) and the torch.profiler device trace
    phase_prof = PhaseProfiler() if args.profile_dir else None
    if two_party and cfg.mode == "u_split":
        trainer = USplitClientTrainer(plan, cfg, seed_gen, transport,
                                      logger=logger, device=args.device)
        layout = "u_split_local" if server is not None else "client_only"
    elif two_party and cfg.mode == "federated":
        trainer = FederatedClientTrainer(plan, cfg, seed_gen, transport,
                                         device=args.device)
        layout = "federated"
    elif two_party and depth > 1:
        if phase_prof is not None:
            print("[warn] --profile-dir phase accounting is not supported "
                  "with --pipeline-depth > 1 (phases overlap by design); "
                  "the device trace still records", file=sys.stderr)
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
                                     logger=logger, profiler=phase_prof,
                                     breaker=breaker, device=args.device)
        layout = "split_local" if server is not None else "client_only"
    elif cfg.transport == "pipeline":
        from split_learning_tpu_torch.parallel.pipeline import (
            PipelinedTrainer)
        trainer = PipelinedTrainer(plan, cfg, seed_gen, sample, mesh)
        layout = "fused"   # JAX's meta.json names both programs "fused"
    else:
        trainer = FusedSplitTrainer(plan, cfg, seed_gen, sample,
                                    device=args.device, mesh=mesh)
        layout = "fused"

    def party_tree() -> Dict[str, Any]:
        tree = trainer.export_states()
        if server is not None:
            tree["server"] = state_tree(server.export_state())
        return tree

    def save(step: int) -> None:
        # one replica a job: the coordinator's
        if ckptr is None or ckptr.last_enqueued == step \
                or not is_coordinator():
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
    # --autoscale: the policy over the in-process group's telemetry
    elastic = (_TrainElastic(server, make_replica, as_cfg)
               if as_cfg is not None else None)

    data_iter, budget, per_epoch = _data_stream(ds, cfg, args.steps,
                                                start_step)

    def on_epoch_end(epoch: int, next_step: int) -> None:
        save(next_step)

    t0 = time.time()
    final_loss = float("nan")
    with _ckpt_drain(ckptr), device_trace(args.profile_dir), \
            (contextlib.closing(elastic) if elastic is not None
             else contextlib.nullcontext()):
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
            final_loss = _train_fused(args, cfg, trainer, data_iter, logger,
                                      save, start_step, ckptr is not None)
    n_steps = budget["taken"]
    dt = time.time() - t0
    _report_profile(phase_prof, args.profile_dir)
    if step_tracer is not None:
        obs.disable()
        out_path = step_tracer.export_chrome(
            args.trace, metadata=(server.trace_metadata()
                                  if server is not None else None))
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


def serve_party(args):
    """What ``serve`` builds, started: ``(runtime, server, checkpointer)``
    (the server listening), or ``(None, rc, None)`` after an ``[error]``
    refusal. The server role with its checkpoints (``--checkpoint-dir``,
    ``--checkpoint-every``, ``--resume``), or ``--role stage
    --stage-index i``, a stage party of the K-stage chain
    (``StageRuntime``; ``--microbatches`` must be the client's). The
    server role with ``--replicas N`` (or ``--autoscale``) is a
    ``ReplicaGroup`` of same-seed replicas; its replica factory and the
    autoscale config ride on ``args`` (``replica_factory``,
    ``autoscale_cfg``) for :func:`cmd_serve`."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import ServerRuntime, StageRuntime
    from split_learning_tpu_torch.runtime import autoscale as rt_autoscale
    from split_learning_tpu_torch.runtime.replica import maybe_replicate
    from split_learning_tpu_torch.transport import (
        ChaosPolicy, SplitHTTPServer)
    from split_learning_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # no GPU for "cuda": raise before any work
    try:
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
        ef_mode = "clapping" if args.compress == "clapping" else "topk8"
        args.replica_factory = args.autoscale_cfg = None
        if args.role == "stage":
            # a middle or last party of the K-stage chain: the same HTTP
            # wire, serving the hop ops; its state is the chain client's
            # to checkpoint, as in JAX
            if args.autoscale:
                print("[warn] --autoscale applies to the replicated server "
                      "role only; ignored for --role stage", file=sys.stderr)
            if cfg.checkpoint_dir:
                print("[warn] stage parties do not own checkpoints; "
                      "--checkpoint-dir ignored", file=sys.stderr)
                cfg = cfg.replace(checkpoint_dir=None)
            runtime = StageRuntime(
                plan, args.stage_index, cfg,
                torch.Generator().manual_seed(cfg.seed),
                strict_steps=not args.allow_out_of_order,
                microbatches=cfg.microbatches, apply_lag=args.apply_lag,
                tenants=args.tenants, quota=args.quota, slo_ms=args.slo_ms,
                mesh=_server_mesh(args), ef_mode=ef_mode,
                device=args.device)
        else:
            as_cfg = rt_autoscale.args_config(args)
            if (args.replicas > 1 or as_cfg is not None) \
                    and cfg.checkpoint_dir:
                # the group's checkpoint story is the handoff sidecar,
                # not N interleaved trees in one directory (JAX's rule)
                raise ValueError(
                    "--replicas > 1 / --autoscale does not compose with "
                    "--checkpoint-dir yet (per-replica save/resume layout "
                    "is ambiguous); drop one of them")

            def make_replica(_idx: int) -> ServerRuntime:
                # the seed's init, of which the server keeps its own
                # stage (a client from the same seed holds the other);
                # every replica the same: one model, N servers
                return ServerRuntime(
                    plan, cfg, torch.Generator().manual_seed(cfg.seed),
                    strict_steps=not args.allow_out_of_order,
                    coalesce_max=args.coalesce_max,
                    coalesce_window_ms=args.coalesce_window_ms,
                    overlap=not args.no_overlap,
                    batching=args.batching,
                    tenants=args.tenants, quota=args.quota,
                    slo_ms=args.slo_ms,
                    decouple_bwd=args.decouple_bwd, apply_lag=args.apply_lag,
                    mesh=_server_mesh(args), ef_mode=ef_mode,
                    device=args.device)
            runtime = maybe_replicate(
                make_replica, args.replicas,
                **_group_kw(args, cfg, args.compress_density, as_cfg))
            args.replica_factory, args.autoscale_cfg = make_replica, as_cfg
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
        return None, 2, None
    if chaos is not None:
        print(f"[chaos] injecting {args.chaos!r} (seed {chaos.seed}) "
              "server-side", file=sys.stderr)
    server = SplitHTTPServer(runtime, host=args.host, port=args.port,
                             compress=args.compress or "none",
                             density=args.compress_density,
                             chaos=chaos).start()
    return runtime, server, ckptr


def cmd_serve(args) -> int:
    """:func:`serve_party` until SIGINT: JAX's ``cmd_serve`` with the
    same ``[serve]`` line."""
    import signal

    from split_learning_tpu_torch.obs import telemetry as obs_telemetry
    runtime, server, ckptr = serve_party(args)
    if runtime is None:
        return server
    step_tracer, ring = _serve_observability(args, runtime, server)
    autoscaler = None
    if getattr(args, "autoscale_cfg", None) is not None:
        # scale-up spawns through the group's own factory; scale-down
        # drives the exactly-once handoff
        autoscaler = _start_autoscaler(
            runtime, args.replica_factory, args.autoscale_cfg, ring,
            coalesce_max=args.coalesce_max,
            slo_ms=(args.telemetry_slo_ms or args.slo_ms or None))
    if step_tracer is not None:
        # cmd_serve runs under _run_with_flight, which set the list up
        args.sigterm_hooks.append(
            lambda: _export_serve_trace(step_tracer, args.trace, runtime))
    main_thread = threading.current_thread() is threading.main_thread()
    if main_thread:
        # SIGINT stops the server even where the parent ignored it
        prev = signal.signal(signal.SIGINT, signal.default_int_handler)
    print(f"[serve] mode={runtime.cfg.mode} role={args.role} listening on "
          f"{server.url}", flush=True)
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
        if autoscaler is not None:
            # the pump first: a scale event must not race the teardown
            autoscaler.close()
        if ring is not None:
            ring.advance(force=True)
            obs_telemetry.stop()  # and the tracer, if the ring turned it on
        runtime.close()
        if step_tracer is not None:
            _export_serve_trace(step_tracer, args.trace, runtime)
        if ckptr is not None:
            # saves are asynchronous: make the newest durable before the
            # process exits, or a resume comes back behind the clients
            ckptr.close()
        if main_thread:
            signal.signal(signal.SIGINT, prev)
    return 0


def _export_serve_trace(step_tracer, path: str, runtime) -> None:
    """``serve --trace``'s last words (at shutdown, or on SIGTERM): the
    Chrome trace with the per-program MFU sidecar, and this process's
    kernel launches (``ops.common.LAUNCHES``), which a client in another
    process cannot count."""
    from split_learning_tpu_torch import obs
    from split_learning_tpu_torch.ops.common import LAUNCHES
    obs.disable()
    step_tracer.export_chrome(path, metadata=runtime.trace_metadata())
    print(f"[trace] Chrome trace written to {path}; kernel launches "
          f"{json.dumps(LAUNCHES.snapshot())}", file=sys.stderr, flush=True)


def _serve_observability(args, runtime, server):
    """``serve``'s ``--trace`` (the tracer: live histograms on ``GET
    /metrics``, the Chrome trace at shutdown) and ``--telemetry`` (or
    ``SLT_TELEMETRY``; the flags win over the env knobs): a windowed
    ring over ``runtime.metrics`` behind ``GET /telemetry``, advanced by
    its sampler thread; telemetry implies tracing. Returns ``(tracer or
    None, ring or None)``."""
    from split_learning_tpu_torch import obs
    from split_learning_tpu_torch.obs import telemetry as obs_telemetry
    step_tracer = None
    if args.trace:
        step_tracer = obs.enable()
        print(f"[serve] tracing on: /metrics histograms live; Chrome trace "
              f"-> {args.trace} on shutdown", file=sys.stderr)
    party = (f"stage{args.stage_index}" if args.role == "stage"
             else "server")
    # --autoscale implies telemetry: the policy reads its windows
    ring = obs_telemetry.start(
        runtime.metrics, party=party,
        force=(args.telemetry
               or getattr(args, "autoscale_cfg", None) is not None),
        interval_s=args.telemetry_interval_s,
        slo_ms=args.telemetry_slo_ms, tenants=args.tenants)
    if ring is None:
        return step_tracer, None
    server.telemetry = ring
    print(f"[telemetry] windowed ring on: GET /telemetry (interval "
          f"{ring.interval_s}s, capacity {ring.capacity})",
          file=sys.stderr)
    return step_tracer, ring


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
    p.add_argument("--tracking", default=None,
                   help="stdout | jsonl | noop | mlflow (the mlflow package, "
                        "else its REST protocol for an http(s) "
                        "--tracking-uri, else stdout)")
    p.add_argument("--tracking-uri", dest="tracking_uri", default=None,
                   help="the MLflow tracking server (env "
                        "MLFLOW_TRACKING_URI)")
    p.add_argument("--remat", action="store_const", const=True, default=None,
                   help="rematerialise each stage's forward in the backward "
                        "(torch.utils.checkpoint): activation memory for "
                        "recompute; the fused trainer and the served party")
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


def _add_chain_flags(p: argparse.ArgumentParser) -> None:
    """The K-stage chain's ``train`` flags (``--microbatches`` and
    ``--apply-lag`` are shared)."""
    p.add_argument("--stages", dest="num_stages", type=int, default=None,
                   help="pipeline stages; > 2 with mode split and the "
                        "local, device or http transport trains the "
                        "K-stage chain of a chain plan (split_cnn_chain3: "
                        "3, resnet18_4stage: 4)")
    p.add_argument("--stage-urls", dest="stage_urls", default=None,
                   help="the chain over http: the serve --role stage "
                        "parties' URLs, comma-separated, in chain order")
    p.add_argument("--schedule", choices=["gpipe", "1f1b"], default=None,
                   help="the chain's injection schedule (default gpipe)")
    p.add_argument("--gate-dropped-steps", dest="gate_dropped_steps",
                   action="store_true",
                   help="the chain: exit 1 unless every step produced a "
                        "finite loss and every in-process stage "
                        "acknowledged the last step")


def _add_mesh_flags(p: argparse.ArgumentParser) -> None:
    """JAX's ``train`` mesh and multi-host flags (``--tracking-uri`` and
    ``--remat`` are shared)."""
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
    p.add_argument("--seq-parallel", dest="seq_parallel", type=int,
                   default=None)


def _add_serve_mesh_flags(p: argparse.ArgumentParser) -> None:
    """JAX's ``serve`` mesh flags: the served party's ``data`` and
    ``model`` axes."""
    p.add_argument("--mesh-data", dest="mesh_data", type=int, default=1)
    p.add_argument("--mesh-model", dest="mesh_model", type=int, default=1)


def _add_replica_flags(p: argparse.ArgumentParser) -> None:
    """Server replicas and elastic autoscaling (``runtime/replica.py``,
    ``runtime/autoscale.py``), on ``serve`` and ``train``'s in-process
    server or chain stages."""
    p.add_argument("--replicas", type=int, default=1,
                   help="same-init server replicas behind the sticky "
                        "failover router (1 = the bare server)")
    p.add_argument("--replica-sync-every", dest="replica_sync_every",
                   type=int, default=0,
                   help="FedAvg the replicas' parameters every K group "
                        "steps (0 = never)")
    p.add_argument("--handoff", choices=["live", "checkpoint"],
                   default="live",
                   help="how a dead replica's step state reaches its "
                        "successors: in memory, or through the durable "
                        "extras sidecar")
    p.add_argument("--autoscale", action="store_true",
                   help="policy-driven replica count over the telemetry "
                        "ring's windows (implies telemetry; env twin "
                        "SLT_AUTOSCALE=1)")
    p.add_argument("--autoscale-min", dest="autoscale_min", type=int,
                   default=None, help="floor on live replicas (default 1)")
    p.add_argument("--autoscale-max", dest="autoscale_max", type=int,
                   default=None, help="ceiling on live replicas (default 4)")
    p.add_argument("--autoscale-cooldown-s", dest="autoscale_cooldown_s",
                   type=float, default=None,
                   help="scale-up cooldown; scale-down's is twice it "
                        "(default 5)")


def _add_flight(p: argparse.ArgumentParser) -> None:
    p.add_argument("--flight", default=None, metavar="PATH",
                   help="flight recorder (obs/flight.py): journal causal "
                        "runtime events in a bounded ring and dump them "
                        "here as JSON on exit, SIGTERM, a fatal exception "
                        "or a watchdog trip (merge with "
                        "scripts/postmortem.py); serve also answers GET "
                        "/debug/flight. Off = zero overhead")


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    """The command line as ``main`` reads it (``args.fn`` runs it)."""
    ap = argparse.ArgumentParser(prog="split_learning_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pt = sub.add_parser("train", help="run a split trainer")
    _add_shared(pt)
    pt.add_argument("--steps", type=int, default=0,
                    help="stop after N steps (0 = full epochs)")
    pt.add_argument("--transport",
                    choices=["fused", "local", "http", "device", "pipeline"],
                    default="fused",
                    help="fused (one program), local (the parties in one "
                         "process, through the wire codec), http (this "
                         "process is the client of serve parties) or "
                         "device (the K-stage chain's co-located stages, "
                         "device tensors on every hop); pipeline is not "
                         "ported")
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
                         "'auto': the adaptive controller on the K-stage "
                         "chain's hop wires (a two-party wire warns and "
                         "uses 0.1)")
    pt.add_argument("--failure-policy", dest="failure_policy",
                    choices=["raise", "retry", "skip"], default=None,
                    help="what the client does when the wire fails: raise "
                         "(default), retry (bounded, with a circuit "
                         "breaker probing /health while the server is "
                         "down) or skip (drop the batch, counted)")
    pt.add_argument("--max-retries", dest="max_retries", type=int,
                    default=3,
                    help="retries per step with --failure-policy retry")
    pt.add_argument("--scan-steps", dest="scan_steps", type=int, default=0,
                    help="the fused transport: run N steps as one chunk "
                         "and read their N losses once (capped to "
                         "--checkpoint-every; no CUDA graph yet)")
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
                    help="also checkpoint every N steps (the fused "
                         "transport and the K-stage chain)")
    pt.add_argument("--require-real", dest="require_real",
                    action="store_true",
                    help="fail if real dataset files are absent instead of "
                         "falling back to synthetic data")
    pt.add_argument("--eval", action="store_true",
                    help="report test-split accuracy after training "
                         "(over HTTP: split-party, evaluate_remote)")
    pt.add_argument("--trace", default=None, metavar="PATH",
                    help="per-step span tracing (obs/): write a Chrome-"
                         "trace JSON here on exit (Perfetto-loadable; an "
                         "in-process server's per-program MFU and the "
                         "chain's per-stage report ride as metadata "
                         "events). Off = zero overhead")
    pt.add_argument("--profile-dir", dest="profile_dir", default=None,
                    help="write a torch.profiler trace (CPU and CUDA "
                         "activity, device_trace.json) here and report "
                         "the per-phase (compute vs transport) wall "
                         "clock")
    pt.add_argument("--telemetry-port", dest="telemetry_port", type=int,
                    default=None,
                    help="the K-stage chain: serve the hub's windowed "
                         "telemetry ring on this port's GET /telemetry "
                         "(0 = ephemeral) and print the fleet view of the "
                         "hub and its in-process stages at the end; also "
                         "turns telemetry on (SLT_TELEMETRY=1 does too, "
                         "without the port)")
    _add_flight(pt)
    _add_server_knobs(pt, serve=False)
    _add_chain_flags(pt)
    _add_mesh_flags(pt)
    _add_replica_flags(pt)
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
    ps.add_argument("--role", choices=["server", "stage"], default="server",
                    help="server (the two-party server party) or stage (a "
                         "stage party of the K-stage chain: it serves the "
                         "hop ops)")
    ps.add_argument("--stage-index", dest="stage_index", type=int, default=1,
                    help="--role stage: which stage of the chain plan "
                         "(1..S-1)")
    ps.add_argument("--trace", default=None, metavar="PATH",
                    help="per-step span tracing (obs/): live queue-wait/"
                         "dispatch histograms on GET /metrics and a Chrome "
                         "trace here on shutdown, with the per-program MFU "
                         "as its metadata event. Off = zero overhead")
    _add_flight(ps)
    ps.add_argument("--telemetry", action="store_true",
                    help="telemetry plane (obs/telemetry.py): a windowed "
                         "rates/percentiles ring on GET /telemetry "
                         "(implies tracing; env twin SLT_TELEMETRY=1)")
    ps.add_argument("--telemetry-interval-s", dest="telemetry_interval_s",
                    type=float, default=None,
                    help="telemetry window width in seconds (default 1.0; "
                         "env twin SLT_TELEMETRY_INTERVAL_S)")
    ps.add_argument("--telemetry-slo-ms", dest="telemetry_slo_ms",
                    type=float, default=None,
                    help="per-tenant latency SLO of the burn-rate tracker "
                         "(slt_slo_burn_rate_* gauges and fl_slo_alert "
                         "flight events; env twin SLT_TELEMETRY_SLO_MS)")
    _add_server_knobs(ps, serve=True)
    _add_serve_mesh_flags(ps)
    _add_replica_flags(ps)
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


def _run_with_flight(args) -> int:
    """Run one subcommand under the flight recorder's process triggers
    (JAX's): ``--flight PATH`` arms the recorder and dumps the journal at
    exit; SIGTERM and a fatal exception dump it on the way down. A
    SIGTERM then runs the callables the command appended to
    ``args.sigterm_hooks`` (``serve --trace`` writes its trace there;
    JAX's serve loses it) and the process dies of the signal, as in
    JAX. With neither the flag nor ``SLT_FLIGHT`` (nor
    ``serve --trace``) this is ``args.fn(args)``: the recorder stays
    ``None`` and nothing here allocates."""
    import signal
    from split_learning_tpu_torch.obs import flight as obs_flight
    party = "server" if args.cmd == "serve" else "client"
    flight_path = getattr(args, "flight", None)
    was_on = obs_flight.enabled()
    if flight_path:
        # the flag is switch and dump path; it wins over SLT_FLIGHT
        obs_flight.enable(party=party, dump_path=flight_path)
    else:
        obs_flight.maybe_enable_from_env(party=party)
    prev = None
    args.sigterm_hooks = []
    if obs_flight.enabled() or (args.cmd == "serve" and args.trace):
        def _on_sigterm(signum, frame):
            obs_flight.fatal("sigterm", f"signal {signum}")
            for hook in list(args.sigterm_hooks):
                try:
                    hook()
                except Exception as exc:  # noqa: BLE001 (dying anyway)
                    print(f"[warn] SIGTERM hook failed: {exc}",
                          file=sys.stderr)
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

        try:
            prev = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            pass  # not the main thread (embedded use): no hook
    try:
        rc = args.fn(args)
    except Exception as exc:
        # journal what led up to the crash; the exception propagates
        obs_flight.fatal(type(exc).__name__, str(exc))
        raise
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        fl = obs_flight.get_recorder()
        if fl is not None and not was_on:
            # this command armed it: the next command in the process
            # starts with the recorder off
            obs_flight.disable()
    if fl is not None and fl.dump_path:
        out = fl.dump_json(fl.dump_path, reason="exit")
        print(f"[flight] {len(fl.events())} events -> {out} (merge with "
              "scripts/postmortem.py)", file=sys.stderr)
    return rc


def main(argv: Optional[list] = None) -> int:
    args = parse_args(argv)
    return _run_with_flight(args)


if __name__ == "__main__":
    sys.exit(main())
