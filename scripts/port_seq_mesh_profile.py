#!/usr/bin/env python3
"""Where the time and the memory of the port's T-partitioned LM step go,
on the card.

The bf16 AdamW LM at the width ``chip_smoke.py`` trains (d_model 256,
2 heads, 3 blocks, batch 64, T 1024), from one init, in four forms:

- ``unsharded``: ``attn="flash"``, no mesh;
- ``seq4_ring_flash``: ``ring_flash`` on ``seq 4`` (phase 30's leg);
- ``model2_seq2_ring_flash``, ``model2_seq2_ulysses``: ``model 2 x seq
  2`` (phase 33's legs).

Each meshed form runs with its ranks as virtual ranks of card 0 and,
where the machine has four cards, with its ranks on distinct cards. For
each form and placement it prints:

- the median step ms (host clock to the loss's read) of ``--steps``
  steps after two warm-up steps;
- each card's peak bytes above what it held before a step (the step's
  activations, gradients and the optimizer's temporaries), from
  ``torch.cuda.max_memory_allocated``;
- a ``torch.profiler`` window of ``--window`` steps: per card, device
  busy ms a step and idle share of the window's wall time, kernel
  launches a step and memcpy ms a step;
- on distinct cards, the largest loss gap to the virtual placement's
  run (the same math from the same init).

One JSON object per line as it goes, then the whole record, also written
to ``--out``::

    python3 scripts/port_seq_mesh_profile.py --out chiprun_out/p.json

Needs a CUDA card; raises without one.
"""

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(model="transformer_lm", mode="split", vocab=256, d_model=256,
          num_heads=2, client_depth=1, server_depth=2, max_len=2048)
BATCH, SEQ_LEN = 64, 1024
CFG = dict(transport="fused", model="transformer_lm", batch_size=BATCH,
           dtype="bfloat16", warmup_steps=5, decay_steps=30,
           grad_clip_norm=1.0, optimizer="adamw", lr=3e-4,
           weight_decay=0.1)
# name: (attn, model ranks, seq ranks)
FORMS = {"unsharded": ("flash", 1, 1),
         "seq4_ring_flash": ("ring_flash", 1, 4),
         "model2_seq2_ring_flash": ("ring_flash", 2, 2),
         "model2_seq2_ulysses": ("ulysses", 2, 2)}
WARMUP = 2


def placements(torch, n: int) -> list:
    """n virtual ranks on card 0, and n distinct cards where there are."""
    if n == 1:
        return [("card 0", [torch.device("cuda", 0)])]
    out = [("virtual", [torch.device("cuda", 0)] * n)]
    if torch.cuda.device_count() >= n:
        out.append(("distinct", [torch.device("cuda", i) for i in range(n)]))
    return out


def window(torch, trainer, data, cards) -> dict:
    """A profiler window over ``data``'s steps: per card busy ms a step,
    idle share of the wall time, kernel launches and memcpy ms a step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for x, y in data:
            trainer.train_step(x, y)
        for c in cards:
            torch.cuda.synchronize(c)
        wall_ms = (time.perf_counter() - t) * 1e3
    n = len(data)
    per = {c: dict(busy_ms=0.0, kernels=0, memcpy_ms=0.0) for c in cards}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rec = per.setdefault(e.device_index,
                             dict(busy_ms=0.0, kernels=0, memcpy_ms=0.0))
        ms = (e.time_range.end - e.time_range.start) / 1e3
        rec["busy_ms"] += ms
        if "Memcpy" in e.name or "Memset" in e.name:
            rec["memcpy_ms"] += ms
        else:
            rec["kernels"] += 1
    seen = any(r["busy_ms"] for r in per.values())
    return dict(steps=n, wall_ms_per_step=wall_ms / n, cards={
        str(c): dict(busy_ms_per_step=r["busy_ms"] / n,
                     idle_share=(1 - r["busy_ms"] / wall_ms) if seen
                     else None,
                     kernels_per_step=r["kernels"] / n,
                     memcpy_ms_per_step=r["memcpy_ms"] / n)
        for c, r in sorted(per.items())}, traced=seen)


def run_form(torch, name, devs, init, data, steps, n_window) -> dict:
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.parallel.mesh import make_mesh
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    from split_learning_tpu_torch.utils import Config
    attn, m, s = FORMS[name]
    cards = sorted({d.index for d in devs})
    if m * s == 1:
        mesh, plan = None, get_plan(dtype="bfloat16", **dict(LM, attn=attn))
    else:
        mesh = make_mesh(model_parallel=m, seq_parallel=s, devices=devs)
        plan = get_plan(dtype="bfloat16", mesh=mesh, **dict(LM, attn=attn))
    cfg = Config(model_parallel=m, seq_parallel=s, **CFG)
    trainer = FusedSplitTrainer(plan, cfg, init, data[0][0], device=devs[0],
                                mesh=mesh)
    losses, ms = [], []
    for x, y in data[:WARMUP + steps]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(trainer.train_step(x, y))
        ms.append((time.perf_counter() - t) * 1e3)
    if not all(v == v and abs(v) < 1e4 for v in losses):
        raise RuntimeError(f"{name}: losses {losses}")
    # each card's peak above what it holds between steps
    for c in cards:
        torch.cuda.synchronize(c)
        torch.cuda.reset_peak_memory_stats(c)
    base = {c: torch.cuda.memory_allocated(c) for c in cards}
    x, y = data[0]
    trainer.train_step(x, y)
    peak = {str(c): torch.cuda.max_memory_allocated(c) - base[c]
            for c in cards}
    prof = window(torch, trainer, data[:n_window], cards)
    del trainer
    torch.cuda.empty_cache()
    return dict(form=name, attn=attn, model=m, seq=s,
                step_ms_median=statistics.median(ms[WARMUP:]),
                step_ms=ms, losses=losses, resident_bytes={
                    str(c): v for c, v in base.items()},
                step_peak_bytes=peak, profile=prof)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--window", type=int, default=3)
    ap.add_argument("--forms", default=",".join(FORMS))
    ap.add_argument("--out", default=os.path.join(
        "chiprun_out", "seq_mesh_profile.json"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("port_seq_mesh_profile.py needs a CUDA card")
    from split_learning_tpu_torch.data import batches, synthetic_lm
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import load_kernels
    from split_learning_tpu_torch.utils import gpu_name_and_power_limit
    smi = gpu_name_and_power_limit().splitlines()
    print(json.dumps(dict(cards=smi, torch=torch.__version__)), flush=True)
    t0 = time.perf_counter()
    load_kernels()
    n = max(WARMUP + args.steps, args.window)
    lm = synthetic_lm(n_train=BATCH * n, n_test=BATCH, vocab=LM["vocab"],
                      seq_len=SEQ_LEN, seed=0)
    data = list(batches(lm.train, BATCH, seed=0, drop_remainder=True))
    init = get_plan(dtype="bfloat16", **dict(LM, attn="flash")).init(
        torch.Generator().manual_seed(0), torch.zeros(1))
    out = dict(cards=smi, build_s=time.perf_counter() - t0, runs=[])
    for name in args.forms.split(","):
        _, m, s = FORMS[name]
        first = None
        for placement, devs in placements(torch, m * s):
            rec = run_form(torch, name, devs, init, data, args.steps,
                           args.window)
            rec["placement"] = placement
            if first is None:
                first = rec["losses"]
            else:   # the same math on other cards: the same losses
                rec["loss_gap_to_virtual"] = max(
                    abs(a - b) for a, b in zip(rec["losses"], first))
            out["runs"].append(rec)
            print(json.dumps(rec), flush=True)
    out["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
