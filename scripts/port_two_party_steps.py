#!/usr/bin/env python3
"""Two-party split-CNN step times of one checkout of the port, on the card.

Trains the split CNN at batch 64 through ``SplitClientTrainer`` over
``LocalTransport(ServerRuntime)`` in one process, on ``cuda``, for each
wire mode, and prints one JSON line: per mode the median, min and max
host-clock step time over the steps after the first five (each step ends
in a synchronise), and the host syncs PyTorch makes in one step (its
sync debug mode warns on each). The checkout is imported from ``--repo``
and builds its own kernels there, so two trees can be compared on one
card in one call (parent, change, change, parent):

    python3 scripts/port_two_party_steps.py --repo build/parent --label parent

Needs a CUDA card; raises without one.
"""

import argparse
import json
import os
import statistics
import sys
import time
import warnings


def syncs_in(torch, fn) -> int:
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA operation" in str(w.message) for w in seen)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", required=True, help="checkout root to import")
    ap.add_argument("--label", default="")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--modes", default="int8,topk8")
    ap.add_argument("--density", type=float, default=0.1)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import load_kernels
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, SplitClientTrainer)
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils import Config

    t0 = time.perf_counter()
    load_kernels()
    build_s = time.perf_counter() - t0
    batch = 64
    ds = synthetic("mnist", n_train=batch * args.steps, n_test=8, seed=0)
    data = list(batches(ds.train, batch, seed=0, drop_remainder=True))
    out = {"label": args.label, "repo": args.repo, "build_s": build_s,
           "device": torch.cuda.get_device_name(0), "modes": {}}
    for mode in args.modes.split(","):
        cfg = Config(transport="local", batch_size=batch, lr=0.01)
        server = ServerRuntime(get_plan(), cfg,
                               torch.Generator().manual_seed(0),
                               device="cuda")
        client = SplitClientTrainer(
            get_plan(), cfg, torch.Generator().manual_seed(0),
            LocalTransport(server, compress=mode, density=args.density),
            device="cuda")
        ms = []
        for i, (x, y) in enumerate(data):
            t = time.perf_counter()
            client.train_step(x, y, i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        x, y = data[0]
        steady = ms[5:]
        out["modes"][mode] = dict(
            step_ms_median=statistics.median(steady),
            step_ms_min=min(steady), step_ms_max=max(steady),
            host_syncs_per_step=syncs_in(
                torch, lambda: client.train_step(x, y, len(data))))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
