"""CLI entry point (counterpart of ``split_learning_tpu/launch/run.py``).

The ``train`` subcommand on the fused transport, on the GPU by default:

  python -m split_learning_tpu_torch.launch.run train \
      --mode split --dataset synthetic --steps 20
  python -m split_learning_tpu_torch.launch.run train \
      --model transformer_lm --dataset lm --seq-len 256 --attn flash \
      --d-model 256 --num-heads 2 --steps 20

Config resolution is the JAX package's: CLI flags > environment
(``LEARNING_MODE``, ``SLT_*``) > defaults. ``--device cpu`` is the only
way onto the CPU, where the kernels' plain versions run. The JAX
``--kernels`` flag does not exist here: the device picks the kernel.
The transformer families take the JAX size flags (``--d-model``,
``--num-heads``, ``--client-depth``, ``--server-depth``), ``--seq-len``
for the token datasets and ``--attn``, with the JAX command's checks:
``transformer_lm`` needs ``--dataset lm``, ``transformer`` needs
``--dataset tokens``, and an image model refuses token data (rc 2).
The two-party transports, ``serve``, ``eval`` and checkpoints are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, Optional

import torch


def _config_from_args(args):
    from split_learning_tpu_torch.utils.config import Config
    overrides = {}
    for field in ("mode", "model", "dataset", "batch_size", "epochs", "lr",
                  "momentum", "microbatches", "seed", "data_dir",
                  "tracking", "transport", "attn"):
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


def cmd_train(args) -> int:
    from split_learning_tpu_torch.data import batches, load_dataset
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime.fused import (
        FusedSplitTrainer, check_supported)
    from split_learning_tpu_torch.tracking import make_logger
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
        if err is not None:
            raise ValueError(err)
        plan = get_plan(model=cfg.model, mode=cfg.mode, dtype=cfg.dtype,
                        **_plan_kw(args, cfg))
        check_supported(cfg)
    except (ValueError, NotImplementedError) as e:
        print(f"[error] {e}", file=sys.stderr)
        return 2
    if cfg.model not in _ATTENTION_FAMILIES and cfg.attn != "full":
        print(f"[warn] --attn {cfg.attn!r} ignored: model {cfg.model!r} has "
              "no attention (transformer families only)", file=sys.stderr)
    ds = load_dataset(cfg.dataset, cfg.data_dir, seq_len=args.seq_len)
    if ds.synthetic:
        print(f"[data] using synthetic {ds.name} "
              f"({len(ds.train)} train examples)", file=sys.stderr)
    sample = ds.train.x[:cfg.batch_size]
    trainer = FusedSplitTrainer(
        plan, cfg, torch.Generator().manual_seed(cfg.seed), sample,
        device=args.device)
    logger = make_logger(cfg)

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
            final_loss = trainer.train_step(x, y)
            logger.log_metric("loss", final_loss, step=n_steps)
            n_steps += 1
    dt = time.time() - t0
    if n_steps and dt > 0:
        logger.log_metric("steps_per_sec", n_steps / dt, step=n_steps)

    if args.eval:
        from split_learning_tpu_torch.runtime.evaluate import evaluate
        res = evaluate(plan, trainer.params, ds.test,
                       batch_size=cfg.batch_size)
        logger.log_metric("test_accuracy", res["accuracy"], step=n_steps)
        logger.log_metric("test_loss", res["loss"], step=n_steps)
        print(f"[eval] accuracy={res['accuracy']:.4f} "
              f"loss={res['loss']:.4f} n={res['predictions']}")

    logger.close()
    print(f"[done] mode={cfg.mode} transport={cfg.transport} "
          f"steps={n_steps} final_loss={final_loss:.4f} "
          f"({n_steps / dt if dt > 0 else 0.0:.2f} steps/s)")
    return 0


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="split_learning_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pt = sub.add_parser("train", help="run the fused split trainer")
    pt.add_argument("--mode", choices=["split", "federated", "u_split"],
                    default=None)
    pt.add_argument("--model", default=None,
                    help="split_cnn | split_cnn_chain3 | transformer | "
                         "transformer_lm (the others are not ported)")
    pt.add_argument("--dataset", default=None,
                    help="mnist | synthetic | tokens (transformer) | lm "
                         "(transformer_lm)")
    pt.add_argument("--data-dir", dest="data_dir", default=None)
    pt.add_argument("--batch-size", dest="batch_size", type=int,
                    default=None)
    pt.add_argument("--epochs", type=int, default=None)
    pt.add_argument("--steps", type=int, default=0,
                    help="stop after N steps (0 = full epochs)")
    pt.add_argument("--lr", type=float, default=None)
    pt.add_argument("--momentum", type=float, default=None)
    pt.add_argument("--microbatches", type=int, default=None)
    pt.add_argument("--seed", type=int, default=None)
    pt.add_argument("--tracking", default=None, help="stdout | jsonl | noop")
    pt.add_argument("--transport", choices=["fused"], default="fused",
                    help="only the fused single-process path is ported")
    pt.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu "
                         "(the kernels' plain versions)")
    # size overrides for the transformer families (the fixed reference
    # CNN rejects them)
    pt.add_argument("--d-model", dest="d_model", type=int, default=None)
    pt.add_argument("--num-heads", dest="num_heads", type=int, default=None)
    pt.add_argument("--client-depth", dest="client_depth", type=int,
                    default=None, help="blocks in the client stage")
    pt.add_argument("--server-depth", dest="server_depth", type=int,
                    default=None, help="blocks in the server stage")
    pt.add_argument("--seq-len", dest="seq_len", type=int, default=None,
                    help="sequence length of the synthetic token/lm "
                         "datasets (default 64; cached per length)")
    pt.add_argument("--attn", choices=["full", "flash", "auto", "ring",
                                       "ring_flash", "ulysses"],
                    default=None,
                    help="transformer attention: full (dense) or flash "
                         "(the hand-written kernels on the card); auto "
                         "and the sequence-parallel forms are not ported")
    pt.add_argument("--eval", action="store_true",
                    help="report test-split accuracy after training")
    pt.set_defaults(fn=cmd_train)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
