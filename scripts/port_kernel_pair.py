#!/usr/bin/env python3
"""K1 and K2 device times of one checkout of the port, with its training
steps, on the card.

Imports the port from ``--repo`` (which builds its own kernels there) and
prints one JSON line:

- K1, the cross-entropy forward and backward launches, at the CNN's
  [64, 10] logits and the LM's [65536, 256], float32 and bf16: median
  device ms from CUDA events behind a sleep kernel, and the host
  microseconds a wrapper call takes to return;
- K2, the SGD update, over the split CNN's 6 leaves at momentum 0 and 0.9
  and the LM's 54 leaves at 0.9: median device ms, host microseconds and
  launches a call;
- the fused split-CNN step (batch 64, median of steps 6-30) and the fused
  LM step (float32, d_model 256, batch 64, T 1024, median of the steps
  after the first three), host clock to a synchronised loss, and the LM
  step's K2 launches.

Two trees are compared on one card in one call, in turns (parent, change,
change, parent):

    python3 scripts/port_kernel_pair.py --repo build/parent --label parent

Needs a CUDA card; raises without one.
"""

import argparse
import json
import math
import os
import statistics
import sys
import time

CE_SHAPES = {"cnn": (64, 10), "lm": (65536, 256)}
CNN_LEAF_SHAPES = ((32, 1, 3, 3), (32,), (64, 32, 3, 3), (64,), (10, 9216),
                   (10,))
LM = dict(model="transformer_lm", mode="split", vocab=256, d_model=256,
          num_heads=2, client_depth=1, server_depth=2, max_len=2048,
          attn="flash")


def device_ms(torch, fn, reps: int = 100) -> float:
    """Median device time of one call of ``fn`` (as chip_smoke.py's)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(int(2e8))
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def host_us(torch, fn, reps: int = 500) -> float:
    """Host microseconds a call of ``fn`` takes to return (the wrapper's
    checks, allocations and launch), without waiting for the device."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def step_ms(torch, trainer, data, skip: int) -> float:
    ms = []
    for x, y in data:
        t = time.perf_counter()
        trainer.train_step(x, y)  # returns a float: syncs the step
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ms[skip:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", required=True, help="checkout root to import")
    ap.add_argument("--label", default="")
    ap.add_argument("--lm-steps", type=int, default=13)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    from split_learning_tpu_torch.data import batches, synthetic, synthetic_lm
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import LAUNCHES, load_kernels
    from split_learning_tpu_torch.ops.cross_entropy import (
        ce_backward_cuda, ce_forward_cuda)
    from split_learning_tpu_torch.ops.sgd import NAME as SGD, sgd_step_cuda
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    from split_learning_tpu_torch.utils import Config

    t0 = time.perf_counter()
    load_kernels()
    out = {"label": args.label, "repo": args.repo,
           "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0), "k1": {}, "k2": {}}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    g_one = torch.ones((), device=dev)
    for cut, (n, c) in CE_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = (3.0 * torch.randn(n, c, device=dev, generator=gen)).to(dtype)
            y = torch.randint(0, c, (n,), device=dev, generator=gen)
            _, lse = ce_forward_cuda(x, y)
            out["k1"][f"{cut}_{str(dtype)[6:]}"] = dict(
                shape=[n, c],
                fwd_ms=device_ms(torch, lambda: ce_forward_cuda(x, y)),
                bwd_ms=device_ms(torch, lambda: ce_backward_cuda(
                    x, y, lse, g_one)),
                fwd_host_us=host_us(torch, lambda: ce_forward_cuda(x, y)),
                bwd_host_us=host_us(torch, lambda: ce_backward_cuda(
                    x, y, lse, g_one)))

    lm_shapes = [tuple(t.shape) for st in get_plan(dtype="float32", **LM).init(
        torch.Generator().manual_seed(0), torch.zeros(1)) for t in st.values()]
    for name, shapes, mus in (("cnn", CNN_LEAF_SHAPES, (0.0, 0.9)),
                              ("lm", lm_shapes, (0.9,))):
        for mu in mus:
            ps = [torch.randn(s, device=dev, generator=gen) for s in shapes]
            gs = [1e-3 * torch.randn(s, device=dev, generator=gen)
                  for s in shapes]
            ms_ = [torch.zeros_like(t) for t in ps] if mu else None
            LAUNCHES.reset()
            sgd_step_cuda(ps, gs, ms_, 0.01, mu)
            out["k2"][f"{name}_mu{mu}"] = dict(
                leaves=len(shapes), params=sum(math.prod(s) for s in shapes),
                launches=LAUNCHES.snapshot().get(SGD, 0),
                ms=device_ms(torch, lambda: sgd_step_cuda(
                    ps, gs, ms_, 0.01, mu)),
                host_us=host_us(torch, lambda: sgd_step_cuda(
                    ps, gs, ms_, 0.01, mu)))

    ds = synthetic("mnist", n_train=64 * 30, n_test=8, seed=0)
    data = list(batches(ds.train, 64, seed=0, drop_remainder=True))
    cnn = FusedSplitTrainer(get_plan(model="split_cnn", mode="split"),
                            Config(transport="fused", batch_size=64, lr=0.01),
                            torch.Generator().manual_seed(0), data[0][0],
                            device="cuda")
    out["cnn_step_ms"] = step_ms(torch, cnn, data, 5)
    lm_ds = synthetic_lm(n_train=64 * args.lm_steps, n_test=64,
                         vocab=LM["vocab"], seq_len=1024, seed=0)
    lm_data = list(batches(lm_ds.train, 64, seed=0, drop_remainder=True))
    cfg = Config(transport="fused", model="transformer_lm", attn="flash",
                 batch_size=64, lr=0.1, momentum=0.9)
    lm = FusedSplitTrainer(get_plan(dtype="float32", **LM), cfg,
                           torch.Generator().manual_seed(0), lm_data[0][0],
                           device="cuda")
    LAUNCHES.reset()
    out["lm_step_ms"] = step_ms(torch, lm, lm_data, 3)
    out["lm_sgd_launches_per_step"] = (LAUNCHES.snapshot().get(SGD, 0)
                                       / len(lm_data))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
