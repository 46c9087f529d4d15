#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero, with no result line,
when ``torch.cuda.is_available()`` is false or the port's package is not
beside this script. Phases, any failure ending the run with a traceback:

1. device and build: the card's name and power limit, then the kernels
   built from ``split_learning_tpu_torch/csrc`` (build seconds printed);
2. fused cross-entropy (forward, backward) against its plain version over
   N x C shapes, float32 and bfloat16 logits, and the LM training path's
   [65536, 256] logits;
3. multi-tensor SGD against its plain version on the split CNN's six
   leaves, without and with momentum, over five steps: bit-identical;
4. the main path: ``FusedSplitTrainer`` on ``cuda`` with the full-width
   split CNN, batch 64, synthetic MNIST, 30 steps. Launch counts are
   reset just before and read just after; each kernel must have run
   exactly once per step. The loss must fall, a CPU twin started from
   the same parameters must agree on the first three losses, and the CLI
   (``launch.run.main``) must train five steps and return 0;
5. times with CUDA events: kernel, plain version and one PyTorch library
   call computing the same function, at the main path's shapes, beside
   the least time the card could take (``bound_ms``); the main path's
   median step time, and a ``torch.profiler`` window of 20 more steps
   giving the device's idle share and its time by kernel;
6. flash attention (forward) against its plain version over T in {1, 63,
   64, 65, 1000, 1024}, D in {16, 64, 128}, B*H in {1, 16}, non-causal,
   causal and causal+strict, float32 and bfloat16, plus strided q/k/v
   views and the training shape (B 64, T 1024, H 2, D 128, causal): O
   and LSE within 2e-5 (float32) and within 3e-2 / 1e-3 (bfloat16: two
   bf16 ulps at |o| near 2), row 0 of a strict mask o = 0 and
   lse = NEG_BIG;
7. the serving path at full width: the split causal LM (bf16, d_model
   256, 2 heads, vocab 256, depths 1 + 2, max_len 2048, attn="flash")
   from a seeded init. Launch counts reset before and read after each
   of: ``greedy_generate`` at batch 8, prompt 1024, 256 new tokens, KV
   cache (exactly 3 flash launches, one per block); the same with
   ``kv_cache=False`` and 16 new tokens (exactly 3 x 16);
   ``sample_generate`` (temperature 0.8, top-k 40, top-p 0.9: tokens in
   the vocabulary, the same seed gives the same tokens); ``evaluate`` on
   ``synthetic_lm`` at seq_len 1024 (finite perplexity, 3 launches per
   batch). A float32 CPU twin from the same parameters: prefill logits
   within 1e-4, and each of 32 greedy tokens of the card within 1e-4 of
   the CPU row's max logit;
8. times at the prefill shape (B 8, T 1024, H 2, D 128, causal, bf16 and
   float32): kernel, plain, ``F.scaled_dot_product_attention`` and the
   bound; prefill ms, KV-decode and re-forward tokens/s, and a
   ``torch.profiler`` window over one KV generate;
9. the flash-attention backward (K6: its delta, dK/dV and dQ launches)
   against its plain version over T in {1, 63, 64, 65, 1000, 1024}, D
   in {16, 64, 128, 256}, B*H in {1, 16}, non-causal, causal and
   causal+strict, float32 and bfloat16, without and with an LSE
   cotangent, plus strided views and the training shape (B 64, T 1024,
   H 2, D 128, causal): every gradient within ``FA_BWD_TOL``
   of the largest plain entry (float32 2e-5: the tile loop's summation
   order against one dense sum per product; bf16 8e-3: two bf16 ulps,
   both sides rounding float32 sums), strict row 0 dQ = 0; autograd
   through ``flash_attention_with_lse`` against autograd of dense
   attention, and two runs giving bit-identical dQ, dK, dV;
10. the training path at full width: ``FusedSplitTrainer`` on ``cuda``
   with the split causal LM (float32, d_model 256, 2 heads, vocab 256,
   depths 1 + 2, max_len 2048, attn="flash"), ``synthetic_lm`` at
   seq_len 1024, batch 64, 30 steps of SGD at lr 0.1, momentum 0.9.
   Launch counts reset before and read after: per step exactly 3 K5
   and 3 of each K6 launch, one K1 pair and ceil(54 leaves / 24) = 3 K2
   launches. The loss must fall; a float32 CPU twin on the first 2 rows
   of the first 3 batches agrees with the card on the same rows: losses
   within ``TWIN_TOL``, each leaf's summed update within
   ``TWIN_UPDATE_TOL`` of its largest entry (or of a floor, for leaves
   whose exact gradient is zero), and the same twin with the
   plain backward's dQ planted as zero must fail that bound; the CLI
   trains ``transformer_lm`` (flash) for 5 steps
   at a small size, and the classifier ``transformer`` at T 256, batch
   64, for 5 steps at full width, each with exact launch counts;
11. times at the training shape (B 64, T 1024, H 2, D 128, causal,
   float32 and bf16): each K6 launch, the whole backward, its plain
   version, ``torch.linalg.vecdot`` for the delta launch and the backward
   of ``F.scaled_dot_product_attention`` (``torch.autograd.grad`` on a
   retained graph) for the whole, beside the bound; the
   step's median ms over steps 6-30, tokens/s, and a
   ``torch.profiler`` window of 10 steps.

Output, last lines: one JSON object with a record per kernel, one JSON
object with the main path's step time, one with the serving path's
times, one with the LM training path's, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# (memory bytes/s, float32 FLOP/s outside the tensor cores, bf16 dense
# tensor-core FLOP/s) by the nvidia-smi name; NVIDIA data sheets, dense
# rates without sparsity at the full power limit
_CARD_PEAKS = (
    ("H100 80GB HBM3", 3.35e12, 67e12, 989e12),   # H100 SXM
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H200", 4.8e12, 67e12, 989e12),
)

BATCH, STEPS, LR = 64, 30, 0.01
CE_SHAPES_N = (1, 32, 64, 1000, 4096)
CE_SHAPES_C = (10, 256, 1000)
CE_GRAD_RTOL = 1e-5
CNN_LEAF_SHAPES = ((32, 1, 3, 3), (32,), (64, 32, 3, 3), (64,), (10, 9216),
                   (10,))
# flash attention: shapes held to the plain version, and the serving path
FA_T = (1, 63, 64, 65, 1000, 1024)
FA_D = (16, 64, 128)
FA_BH = ((1, 1), (8, 2))
FA_MASKS = ((False, False), (True, False), (True, True))
FA_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (3e-2, 1e-3)}  # (O, LSE)
LM = dict(model="transformer_lm", mode="split", vocab=256, d_model=256,
          num_heads=2, client_depth=1, server_depth=2, max_len=2048,
          attn="flash")
SERVE_B, SERVE_P, SERVE_NEW, REFWD_NEW, TWIN_B, TWIN_NEW = 8, 1024, 256, 16, 2, 32
N_BLOCKS = LM["client_depth"] + LM["server_depth"]
# flash backward grid (T, B*H and masks as the forward's) and tolerance,
# times the largest entry of the plain version's gradient (at least 1)
FA_BWD_D = (16, 64, 128, 256)
FA_BWD_TOL = {"float32": 2e-5, "bfloat16": 8e-3}
# the training path: the serving LM's widths in float32
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR, TRAIN_MU = 64, 1024, 30, 0.1, 0.9
LM_LEAVES, SGD_TABLE = 54, 24
TRAIN_SHAPE = (TRAIN_B, TRAIN_T, LM["num_heads"],
               LM["d_model"] // LM["num_heads"])   # attention's [B, T, H, D]
TWIN_ROWS, TWIN_STEPS, TWIN_TOL = 2, 3, 1e-4
# the twin's summed parameter updates, per leaf, relative to its largest
# entry: float32 GEMMs and reductions summed in another order on the card.
# A leaf whose updates are all below TWIN_UPDATE_FLOOR of the model's
# largest is held to that instead: the key projections' bias has a zero
# gradient in exact arithmetic (softmax ignores a per-row shift of the
# scores), so both sides move it by rounding noise alone
TWIN_UPDATE_TOL, TWIN_UPDATE_FLOOR = 1e-3, 1e-3


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_peaks(name: str):
    for key, bw, fp32, bf16 in _CARD_PEAKS:
        if key in name:
            return bw, fp32, bf16, key
    _, bw, fp32, bf16 = _CARD_PEAKS[0]
    return bw, fp32, bf16, f"H100 SXM (assumed; {name!r} is not in the table)"


def bound(nbytes: float, ops: float, bw: float, fp32: float):
    t_bytes, t_ops = nbytes / bw, ops / fp32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_ms(torch, fn, reps: int = 100) -> float:
    """Median device time of one call of ``fn``, from CUDA events.

    A long sleep kernel holds the stream while the host enqueues every
    call, so each event pair brackets the device's work for that call and
    not the host's time to launch it."""
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


def profile_window(torch, run, n: int, per: str = "step") -> dict:
    """Device busy share of ``run()`` (``n`` units of work) and the device
    time by kernel per unit, from ``torch.profiler``; ``None`` figures
    where the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.end - e.time_range.start)
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        f"{per}s": n, "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3 if by_name else None,
        "device_idle_share": 1 - busy_us / wall_us if by_name else None,
        f"device_ms_per_{per}_by_kernel": {
            name[:80]: us / 1e3 / n for name, us in top}}


def profile_steps(torch, trainer, data) -> dict:
    """:func:`profile_window` over ``train_step`` on each batch."""
    def run():
        for x, y in data:
            trainer.train_step(x, y)
    return profile_window(torch, run, len(data))


def host_ms(torch, fn, reps: int = 3) -> float:
    """Median host-clock time of ``fn()`` ending in a synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from split_learning_tpu_torch.data import batches, synthetic, synthetic_lm
    from split_learning_tpu_torch.launch import run as launch_run
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.common import (
        LAUNCHES, NEG_BIG, load_kernels)
    from split_learning_tpu_torch.ops.cross_entropy import (
        BWD, FWD, ce_backward_cuda, ce_backward_plain, ce_forward_cuda,
        ce_forward_plain)
    from split_learning_tpu_torch.ops.sgd import (
        NAME as SGD, sgd_step_cuda, sgd_step_plain)
    import split_learning_tpu_torch.ops.flash_attention as fa_mod
    from split_learning_tpu_torch.ops.flash_attention import (
        BWD_DELTA, BWD_DKV, BWD_DQ, BWD_NAMES, NAME as FA,
        flash_attention_bwd_plain, flash_attention_with_lse,
        flash_attention_with_lse_plain, flash_bwd_cuda, flash_bwd_delta_cuda,
        flash_bwd_delta_plain, flash_bwd_dkv_cuda, flash_bwd_dkv_plain,
        flash_bwd_dq_cuda, flash_bwd_dq_plain, flash_fwd_cuda)
    from split_learning_tpu_torch.runtime import (
        FusedSplitTrainer, evaluate, greedy_generate, sample_generate)
    from split_learning_tpu_torch.utils import (
        Config, gpu_name_and_power_limit, resolve_device)

    # ---- 1. device and build ---------------------------------------- #
    dev = resolve_device("cuda")
    smi = gpu_name_and_power_limit().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    bw, fp32, bf16_peak, peak_key = card_peaks(kind)
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | peaks of {peak_key}: "
          f"{bw / 1e12} TB/s, {fp32 / 1e12} TFLOP/s f32, "
          f"{bf16_peak / 1e12} TFLOP/s bf16", flush=True)
    t0 = time.perf_counter()
    load_kernels()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)

    def ce_inputs(n, c, dtype=torch.float32):
        x = (3.0 * torch.randn(n, c, device=dev, generator=gen)).to(dtype)
        y = torch.randint(0, c, (n,), device=dev, generator=gen)
        return x, y

    # ---- 2. cross-entropy kernels vs plain -------------------------- #
    g_one = torch.ones((), device=dev)
    ce_err = {FWD: 0.0, BWD: 0.0}
    cases = [(n, c, torch.float32) for n in CE_SHAPES_N for c in CE_SHAPES_C]
    cases.append((64, 10, torch.bfloat16))
    # the LM training path's logits, [B*T, V]
    cases.append((TRAIN_B * TRAIN_T, LM["vocab"], torch.float32))
    for n, c, dtype in cases:
        x, y = ce_inputs(n, c, dtype)
        loss_k, lse_k = ce_forward_cuda(x, y)
        torch.cuda.synchronize()
        loss_p, lse_p = ce_forward_plain(x, y)
        grad_k = ce_backward_cuda(x, y, lse_k, g_one)
        torch.cuda.synchronize()
        grad_p = ce_backward_plain(x, y, lse_p, g_one)
        rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        check(rel <= 1e-5, f"CE loss N={n} C={c} {dtype}: rel {rel}")
        gk, gp = grad_k.float(), grad_p.float()
        err = (gk - gp).abs().max().item()
        if dtype == torch.float32:
            # entries are at most 1/N: hold them to the largest one too
            # (float32 rounding of the exp and of the row LSE)
            scale = gp.abs().max().item()
            check(err <= 1e-6 and err <= CE_GRAD_RTOL * scale,
                  f"CE grad N={n} C={c}: abs {err} (largest {scale})")
            ce_err[FWD] = max(ce_err[FWD], abs(loss_k.item() - loss_p.item()))
            ce_err[BWD] = max(ce_err[BWD], err)
        else:
            ok = ((gk - gp).abs() <= 1e-2 * gp.abs() + 1e-12).all().item()
            check(ok, f"CE bf16 grad N={n} C={c}: max abs {err}")
    print(f"[k1] cross-entropy matches its plain version on {len(cases)} "
          f"shapes (max abs err fwd {ce_err[FWD]:.3g}, bwd "
          f"{ce_err[BWD]:.3g})", flush=True)

    # ---- 3. SGD kernel vs plain ------------------------------------- #
    lm_shapes = [tuple(t.shape) for st in get_plan(dtype="float32", **LM).init(
        torch.Generator().manual_seed(0), torch.zeros(1)) for t in st.values()]
    check(len(lm_shapes) == LM_LEAVES, f"LM leaves: {len(lm_shapes)}")
    for shapes in (CNN_LEAF_SHAPES, lm_shapes):
        for mu in (0.0, 0.9):
            p_k = [torch.randn(s, device=dev, generator=gen) for s in shapes]
            p_p = [t.clone() for t in p_k]
            m_k = [torch.zeros_like(t) for t in p_k] if mu else None
            m_p = [torch.zeros_like(t) for t in p_k] if mu else None
            for _ in range(5):
                grads = [torch.randn(s, device=dev, generator=gen)
                         for s in shapes]
                LAUNCHES.reset()
                sgd_step_cuda(p_k, grads, m_k, LR, mu)
                torch.cuda.synchronize()
                check(LAUNCHES.snapshot().get(SGD) == math.ceil(
                    len(shapes) / SGD_TABLE), f"SGD launches for "
                    f"{len(shapes)} leaves: {LAUNCHES.snapshot()}")
                sgd_step_plain(p_p, grads, m_p, LR, mu)
            for a, b in zip(p_k + (m_k or []), p_p + (m_p or [])):
                check(torch.equal(a, b), f"SGD mu={mu}: not bit-identical "
                      f"(max abs {(a - b).abs().max().item()})")
    print(f"[k2] SGD bit-identical to its plain version (mu 0 and 0.9, "
          f"5 steps; the CNN's 6 leaves in one launch, the LM's "
          f"{LM_LEAVES} in {math.ceil(LM_LEAVES / SGD_TABLE)})", flush=True)

    # ---- 4. the main path ------------------------------------------- #
    ds = synthetic("mnist", n_train=BATCH * STEPS, n_test=512, seed=0)
    data = list(batches(ds.train, BATCH, seed=0, drop_remainder=True))
    check(len(data) == STEPS, "batch count")
    plan = get_plan(model="split_cnn", mode="split")
    cfg = Config(transport="fused", batch_size=BATCH, lr=LR)
    trainer = FusedSplitTrainer(plan, cfg, torch.Generator().manual_seed(0),
                                data[0][0], device="cuda")
    init_cpu = tuple({k: v.detach().cpu().clone() for k, v in st.items()}
                     for st in trainer.params)

    LAUNCHES.reset()
    losses, step_ms = [], []
    for x, y in data:
        t = time.perf_counter()
        losses.append(trainer.train_step(x, y))  # float(): syncs the step
        step_ms.append((time.perf_counter() - t) * 1e3)
    counts = LAUNCHES.snapshot()
    print(f"[main] {STEPS} steps, launches {counts}, losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    for name in (FWD, BWD, SGD):
        check(counts.get(name) == STEPS,
              f"{name} launched {counts.get(name)} times in {STEPS} steps")
    check(all(math.isfinite(v) for v in losses), "finite losses")
    check(statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
          f"loss did not fall: {losses}")
    for st in trainer.params:
        for k, v in st.items():
            check(bool(torch.isfinite(v).all()), f"finite param {k}")

    twin = FusedSplitTrainer(plan, cfg, init_cpu, data[0][0], device="cpu")
    twin_losses = [twin.train_step(x, y) for x, y in data[:3]]
    diffs = [abs(a - b) for a, b in zip(twin_losses, losses[:3])]
    check(max(diffs) <= 1e-4, f"CPU twin: {twin_losses} vs {losses[:3]}")
    res = evaluate(plan, trainer.params, ds.test, batch_size=512)
    check(0.0 <= res["accuracy"] <= 1.0 and math.isfinite(res["loss"]),
          f"evaluate: {res}")
    print(f"[main] CPU twin agrees (max diff {max(diffs):.3g}); test "
          f"accuracy {res['accuracy']:.4f}", flush=True)

    LAUNCHES.reset()
    rc = launch_run.main(["train", "--steps", "5", "--dataset", "synthetic",
                          "--data-dir",
                          os.path.join(REPO, "build", "chip_smoke_data")])
    cli_counts = LAUNCHES.snapshot()
    check(rc == 0, f"launch.run.main returned {rc}")
    check(all(cli_counts.get(n) == 5 for n in (FWD, BWD, SGD)),
          f"CLI launches {cli_counts}")

    # ---- 5. times ---------------------------------------------------- #
    x64, y64 = ce_inputs(BATCH, 10)
    _, lse64 = ce_forward_cuda(x64, y64)
    xr = x64.clone().requires_grad_(True)
    lib_loss = F.cross_entropy(xr, y64)
    n_c = BATCH * 10
    ce_common = dict(route="cuda",
                     source="split_learning_tpu_torch/csrc/cross_entropy.cu",
                     jax_counterpart="split_learning_tpu/ops/cross_entropy.py"
                                     ":fused_cross_entropy",
                     shape=[BATCH, 10], dtype="float32")
    fwd_bytes = n_c * 4 + BATCH * 8 + BATCH * 4 + 4
    bwd_bytes = n_c * 4 + BATCH * 8 + BATCH * 4 + 4 + n_c * 4
    records = []
    b_ms, b_by = bound(fwd_bytes, 4 * n_c, bw, fp32)
    records.append(dict(
        name="fused_cross_entropy_fwd",
        replaces="split_learning_tpu/ops/cross_entropy.py:58",
        launches=counts[FWD], launches_per_step=1,
        max_abs_err=ce_err[FWD],
        ms=device_ms(torch, lambda: ce_forward_cuda(x64, y64)),
        plain_ms=device_ms(torch, lambda: ce_forward_plain(x64, y64)),
        library_ms=device_ms(torch, lambda: F.cross_entropy(x64, y64)),
        library_call="torch.nn.functional.cross_entropy (forward)",
        bytes=fwd_bytes, bound_ms=b_ms, bound_by=b_by, **ce_common))
    b_ms, b_by = bound(bwd_bytes, 4 * n_c, bw, fp32)
    records.append(dict(
        name="fused_cross_entropy_bwd",
        replaces="split_learning_tpu/ops/cross_entropy.py:82",
        launches=counts[BWD], launches_per_step=1,
        max_abs_err=ce_err[BWD],
        ms=device_ms(torch, lambda: ce_backward_cuda(x64, y64, lse64, g_one)),
        plain_ms=device_ms(
            torch, lambda: ce_backward_plain(x64, y64, lse64, g_one)),
        library_ms=device_ms(torch, lambda: torch.autograd.grad(
            lib_loss, xr, retain_graph=True)),
        library_call="torch.autograd.grad of F.cross_entropy (backward)",
        bytes=bwd_bytes, bound_ms=b_ms, bound_by=b_by, **ce_common))

    n_par = sum(math.prod(s) for s in CNN_LEAF_SHAPES)
    sgd_times = {}
    for mu in (0.0, 0.9):
        ps = [torch.randn(s, device=dev, generator=gen)
              for s in CNN_LEAF_SHAPES]
        gs = [torch.randn(s, device=dev, generator=gen) * 1e-3
              for s in CNN_LEAF_SHAPES]
        ms_ = [torch.zeros_like(t) for t in ps] if mu else None
        kernel = device_ms(torch, lambda: sgd_step_cuda(ps, gs, ms_, LR, mu))
        plain = device_ms(torch, lambda: sgd_step_plain(ps, gs, ms_, LR, mu))
        lib = {}
        for flag in ("foreach", "fused"):
            lp = [t.clone() for t in ps]
            for t, g in zip(lp, gs):
                t.grad = g
            opt = torch.optim.SGD(lp, lr=LR, momentum=mu, **{flag: True})
            lib[flag] = device_ms(torch, opt.step)
        nbytes = n_par * (20 if mu else 12)
        b_ms, b_by = bound(nbytes, n_par * (4 if mu else 2), bw, fp32)
        sgd_times[mu] = dict(ms=kernel, plain_ms=plain,
                             library_ms=lib["fused"],
                             library_foreach_ms=lib["foreach"],
                             bytes=nbytes, bound_ms=b_ms, bound_by=b_by)
    records.append(dict(
        name="fused_sgd_step", route="cuda",
        source="split_learning_tpu_torch/csrc/sgd.cu",
        replaces="split_learning_tpu/ops/sgd.py:56",
        jax_counterpart="split_learning_tpu/ops/sgd.py:fused_sgd_step",
        launches=counts[SGD], launches_per_step=1, max_abs_err=0.0,
        params=n_par, momentum=0.0,
        library_call="torch.optim.SGD(fused=True).step()",
        **sgd_times[0.0],
        with_momentum_0_9=sgd_times[0.9]))

    steady = step_ms[5:]
    step = dict(main_path=dict(
        model="split_cnn", mode="split", batch=BATCH, steps=STEPS,
        device=kind, step_ms_median=statistics.median(steady),
        steps_per_s=1e3 / statistics.median(steady),
        step_ms_first=step_ms[0], loss_first=losses[0],
        loss_last=losses[-1],
        profile=profile_steps(torch, trainer, data[:20])))

    # ---- 6. flash attention kernel vs plain ------------------------- #
    fa_err = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    fa_err_train = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    n_cases = 0

    def fa_check(q, k, v, causal, strict, what, errs=fa_err):
        o_k, lse_k = flash_fwd_cuda(q, k, v, causal, strict)
        torch.cuda.synchronize()
        o_p, lse_p = flash_attention_with_lse_plain(q, k, v, causal, strict)
        name = str(q.dtype).replace("torch.", "")
        e_o = (o_k.float() - o_p.float()).abs().max().item()
        e_l = (lse_k - lse_p).abs().max().item()
        tol_o, tol_l = FA_TOL[name]
        check(e_o <= tol_o and e_l <= tol_l,
              f"flash {what} {name}: O err {e_o}, LSE err {e_l}")
        if strict:
            check(bool((o_k[:, 0] == 0).all()) and
                  bool((lse_k[:, 0] == NEG_BIG).all()),
                  f"flash {what} {name}: strict row 0 not (0, NEG_BIG)")
        errs[name][0] = max(errs[name][0], e_o)
        errs[name][1] = max(errs[name][1], e_l)

    for dtype in (torch.float32, torch.bfloat16):
        for t in FA_T:
            for d in FA_D:
                for b, h in FA_BH:
                    q, k, v = (torch.randn(b, t, h, d, device=dev,
                                           generator=gen).to(dtype)
                               for _ in range(3))
                    for causal, strict in FA_MASKS:
                        fa_check(q, k, v, causal, strict,
                                 f"B{b} T{t} H{h} D{d} causal={causal} "
                                 f"strict={strict}")
                        n_cases += 1
        # q, k, v as strided views of one packed [B, T, 3, H, D] tensor
        packed = torch.randn(2, 100, 3, 3, 40, device=dev,
                             generator=gen).to(dtype)
        fa_check(*packed.unbind(2), True, False, "strided views")
        n_cases += 1
        # the LM training path's shape
        q, k, v = (torch.randn(TRAIN_SHAPE, device=dev, generator=gen).to(
            dtype) for _ in range(3))
        fa_check(q, k, v, True, False, f"training shape {TRAIN_SHAPE}",
                 fa_err_train)
        n_cases += 1
    print(f"[k5] flash attention matches its plain version on {n_cases} "
          f"cases (max abs err O/LSE: f32 {fa_err['float32'][0]:.3g}/"
          f"{fa_err['float32'][1]:.3g}, bf16 {fa_err['bfloat16'][0]:.3g}/"
          f"{fa_err['bfloat16'][1]:.3g}; at the training shape "
          f"{fa_err_train})", flush=True)

    # ---- 7. the serving path at full width -------------------------- #
    plan_lm = get_plan(dtype="bfloat16", **LM)
    on_card = torch.zeros(1, device=dev)
    params_lm = plan_lm.init(torch.Generator().manual_seed(0), on_card)
    prompt = np.random.RandomState(0).randint(
        0, LM["vocab"], (SERVE_B, SERVE_P)).astype(np.int32)
    serve_counts = {}

    def counted(label, fn):
        LAUNCHES.reset()
        out = fn()
        torch.cuda.synchronize()
        serve_counts[label] = LAUNCHES.snapshot().get(FA, 0)
        return out

    toks = counted("kv_generate", lambda: greedy_generate(
        plan_lm, params_lm, prompt, SERVE_NEW, device="cuda"))
    check(tuple(toks.shape) == (SERVE_B, SERVE_P + SERVE_NEW),
          f"KV generate shape {tuple(toks.shape)}")
    check(bool((toks[:, :SERVE_P].cpu() == torch.from_numpy(prompt)).all()),
          "KV generate kept the prompt")
    check(0 <= toks.min().item() and toks.max().item() < LM["vocab"],
          "KV generate tokens in the vocabulary")
    check(serve_counts["kv_generate"] == N_BLOCKS,
          f"KV generate launched flash {serve_counts['kv_generate']} times")
    refwd = counted("reforward_generate", lambda: greedy_generate(
        plan_lm, params_lm, prompt, REFWD_NEW, kv_cache=False,
        device="cuda"))
    check(serve_counts["reforward_generate"] == N_BLOCKS * REFWD_NEW,
          f"re-forward generate launched flash "
          f"{serve_counts['reforward_generate']} times")
    agree = (refwd[:, SERVE_P:] == toks[:, SERVE_P:SERVE_P + REFWD_NEW]
             ).float().mean().item()

    def sample(seed):
        return sample_generate(
            plan_lm, params_lm, prompt, TWIN_NEW,
            torch.Generator(device=dev).manual_seed(seed), 0.8, top_k=40,
            top_p=0.9, device="cuda")

    s1 = counted("sample_generate", lambda: sample(1))
    s2 = sample(1)
    check(torch.equal(s1, s2), "sampling: one seed, two token streams")
    check(0 <= s1.min().item() and s1.max().item() < LM["vocab"],
          "sampled tokens in the vocabulary")
    check(serve_counts["sample_generate"] == N_BLOCKS,
          f"sample generate launched flash "
          f"{serve_counts['sample_generate']} times")
    lm_ds = synthetic_lm(n_train=8, n_test=4 * SERVE_B, vocab=LM["vocab"],
                         seq_len=SERVE_P, seed=0)
    res_lm = counted("evaluate", lambda: evaluate(
        plan_lm, params_lm, lm_ds.test, batch_size=SERVE_B))
    check(res_lm["perplexity"] is not None
          and math.isfinite(res_lm["perplexity"]), f"evaluate: {res_lm}")
    check(serve_counts["evaluate"] == N_BLOCKS * 4,
          f"evaluate launched flash {serve_counts['evaluate']} times in 4 "
          "batches")
    print(f"[serve] launches {serve_counts}; re-forward agrees with KV on "
          f"{agree:.3f} of its tokens; eval perplexity "
          f"{res_lm['perplexity']:.2f}", flush=True)

    # CPU twin at float32 from the same parameters
    plan32 = get_plan(dtype="float32", **LM)
    params_cpu = plan32.init(torch.Generator().manual_seed(0), torch.zeros(1))
    params_dev = tuple({k: v.to(dev) for k, v in st.items()}
                       for st in params_cpu)
    prompt2 = prompt[:TWIN_B]

    def prefill_logits(params, device):
        x = torch.from_numpy(prompt2).to(device)
        with torch.no_grad():
            for st, pr in zip(plan32.stages, params):
                x, _ = st.apply(pr, x, cache_len=SERVE_P)
        return x

    with torch.no_grad():
        want = plan32.apply(params_cpu, torch.from_numpy(prompt2))
    twin_prefill = (prefill_logits(params_dev, dev).cpu() - want).abs().max()
    check(twin_prefill.item() <= 1e-4,
          f"CPU twin: prefill logits differ by {twin_prefill.item()}")
    toks32 = greedy_generate(plan32, params_dev, prompt2, TWIN_NEW,
                             device="cuda").cpu()
    with torch.no_grad():
        cpu_logits = plan32.apply(params_cpu, toks32[:, :-1])
    rows = cpu_logits[:, SERVE_P - 1:]
    chosen = rows.gather(-1, toks32[:, SERVE_P:, None].long())[..., 0]
    gap = (rows.max(dim=-1).values - chosen).max().item()
    check(gap <= 1e-4, f"CPU twin: a card token is {gap} below the CPU "
                       "row's max logit")
    print(f"[serve] CPU twin: prefill logits within {twin_prefill.item():.3g}"
          f"; {TWIN_B}x{TWIN_NEW} greedy tokens within {gap:.3g} of the CPU "
          "row max", flush=True)

    # ---- 8. times ---------------------------------------------------- #
    fa_rec = {}
    for dtype, peak in ((torch.bfloat16, bf16_peak), (torch.float32, fp32)):
        shape = (SERVE_B, SERVE_P, LM["num_heads"],
                 LM["d_model"] // LM["num_heads"])
        q, k, v = (torch.randn(shape, device=dev, generator=gen).to(dtype)
                   for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        n = math.prod(shape)
        nbytes = 4 * n * q.element_size() + n // shape[3] * 4
        flops = 2 * shape[0] * shape[2] * shape[1] ** 2 * shape[3]
        b_ms, b_by = bound(nbytes, flops, bw, peak)
        name = str(dtype).replace("torch.", "")
        fa_rec[name] = dict(
            shape=list(shape), dtype=name, causal=True,
            ms=device_ms(torch, lambda: flash_fwd_cuda(q, k, v, True)),
            plain_ms=device_ms(torch, lambda: flash_attention_with_lse_plain(
                q, k, v, True), reps=20),
            library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
            bytes=nbytes, flops=flops, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=fa_err[name][0], max_abs_err_lse=fa_err[name][1],
            train_shape_max_abs_err=fa_err_train[name])
    records.append(dict(
        name="flash_attention_fwd", route="cuda",
        source="split_learning_tpu_torch/csrc/flash_attention.cu",
        replaces="split_learning_tpu/ops/flash_attention.py:391",
        jax_counterpart="split_learning_tpu/ops/flash_attention.py"
                        ":flash_attention",
        launches=serve_counts["kv_generate"], launches_per_generate=N_BLOCKS,
        launches_reforward=serve_counts["reforward_generate"],
        launches_evaluate=serve_counts["evaluate"],
        library_call="torch.nn.functional.scaled_dot_product_attention("
                     "is_causal=True)",
        **fa_rec["bfloat16"], float32=fa_rec["float32"]))

    def prefill():
        x = torch.from_numpy(prompt).to(dev)
        with torch.no_grad():
            for st, pr in zip(plan_lm.stages, params_lm):
                x, _ = st.apply(pr, x, cache_len=SERVE_P + SERVE_NEW)
        return x

    prefill_ms = host_ms(torch, prefill, reps=5)
    kv_ms = host_ms(torch, lambda: greedy_generate(
        plan_lm, params_lm, prompt, SERVE_NEW, device="cuda"))
    refwd_ms = host_ms(torch, lambda: greedy_generate(
        plan_lm, params_lm, prompt, REFWD_NEW, kv_cache=False,
        device="cuda"))
    decode_ms = kv_ms - prefill_ms
    serving = dict(serving_path=dict(
        model="transformer_lm", mode="split", dtype="bfloat16",
        d_model=LM["d_model"], num_heads=LM["num_heads"],
        vocab=LM["vocab"], blocks=N_BLOCKS, attn="flash", batch=SERVE_B,
        prompt=SERVE_P, new_tokens=SERVE_NEW, device=kind,
        prefill_ms=prefill_ms, kv_generate_ms=kv_ms,
        kv_decode_ms_per_token=decode_ms / (SERVE_NEW - 1),
        kv_decode_tokens_per_s=SERVE_B * (SERVE_NEW - 1) / decode_ms * 1e3,
        kv_generate_tokens_per_s=SERVE_B * SERVE_NEW / kv_ms * 1e3,
        reforward_new_tokens=REFWD_NEW, reforward_generate_ms=refwd_ms,
        reforward_tokens_per_s=SERVE_B * REFWD_NEW / refwd_ms * 1e3,
        flash_launches=serve_counts, eval_perplexity=res_lm["perplexity"],
        twin_prefill_max_abs=twin_prefill.item(), twin_token_gap=gap,
        profile_kv_generate=profile_window(torch, lambda: greedy_generate(
            plan_lm, params_lm, prompt, SERVE_NEW, device="cuda"), 1,
            per="generate")))

    # ---- 9. flash backward kernels vs plain ------------------------- #
    bwd_err, bwd_err_train = ({dt: {n: 0.0 for n in BWD_NAMES}
                               for dt in ("float32", "bfloat16")}
                              for _ in range(2))
    n_bwd = 0

    def bwd_check(q, k, v, do, g_lse, causal, strict, what, errs=bwd_err):
        """Each K6 launch against its plain part, on the same inputs."""
        name = str(q.dtype).replace("torch.", "")
        tol = FA_BWD_TOL[name]
        o, lse = flash_fwd_cuda(q, k, v, causal, strict)
        delta = flash_bwd_delta_cuda(o, do, g_lse)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, strict)
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, strict)
        torch.cuda.synchronize()
        parts = {
            BWD_DELTA: ((delta,), (flash_bwd_delta_plain(o, do, g_lse),)),
            BWD_DKV: ((dk, dv), flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                    causal, strict)),
            BWD_DQ: ((dq,), (flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                causal, strict),))}
        for launch, (got, want) in parts.items():
            for a, b in zip(got, want):
                err = (a.float() - b.float()).abs().max().item()
                scale = max(1.0, b.float().abs().max().item())
                check(a.dtype == b.dtype and err <= tol * scale,
                      f"{launch} {what} {name}: err {err} (scale {scale})")
                errs[name][launch] = max(errs[name][launch], err)
        # the composite launcher is the kernels above, in order
        whole = flash_bwd_cuda(q, k, v, o, lse, do, g_lse, causal, strict)
        check(all(torch.equal(a, b) for a, b in zip(whole, (dq, dk, dv))),
              f"flash_bwd_cuda {what} {name}: differs from its launches")
        if strict:
            check(bool((dq[:, 0] == 0).all()),
                  f"K6 {what} {name}: strict row 0 has dq != 0")

    for dtype in (torch.float32, torch.bfloat16):
        for t in FA_T:
            for d in FA_BWD_D:
                for b, h in FA_BH:
                    q, k, v, do = (torch.randn(b, t, h, d, device=dev,
                                               generator=gen).to(dtype)
                                   for _ in range(4))
                    g_lse = torch.randn(b, t, h, device=dev, generator=gen)
                    for causal, strict in FA_MASKS:
                        for gl in (None, g_lse):
                            bwd_check(q, k, v, do, gl, causal, strict,
                                      f"B{b} T{t} H{h} D{d} causal={causal} "
                                      f"strict={strict} g_lse={gl is not None}")
                            n_bwd += 1
        # q, k, v and dO as strided views of one packed tensor
        packed = torch.randn(2, 100, 4, 3, 40, device=dev,
                             generator=gen).to(dtype)
        bwd_check(*packed.unbind(2), None, True, False, "strided views")
        n_bwd += 1
        # the LM training path's shape: causal, no LSE cotangent
        q, k, v, do = (torch.randn(TRAIN_SHAPE, device=dev,
                                   generator=gen).to(dtype)
                       for _ in range(4))
        bwd_check(q, k, v, do, None, True, False,
                  f"training shape {TRAIN_SHAPE}", bwd_err_train)
        n_bwd += 1
        del q, k, v, do

    # autograd through the kernels against autograd of dense attention
    aq, ak, av, aw = (torch.randn(2, 300, 2, 128, device=dev, generator=gen)
                      for _ in range(4))
    aw_lse = torch.randn(2, 300, 2, device=dev, generator=gen)

    def dense_with_lse(q, k, v):
        s_ = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[3] ** -0.5
        keep = torch.ones(s_.shape[-1], s_.shape[-1], dtype=torch.bool,
                          device=dev).tril()
        s_ = s_.masked_fill(~keep, NEG_BIG)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s_, dim=-1), v)
        return o, torch.logsumexp(s_, dim=-1).permute(0, 2, 1)

    def attn_grads(fn):
        leaves = [x.clone().requires_grad_(True) for x in (aq, ak, av)]
        o, lse = fn(*leaves)
        return torch.autograd.grad((o * aw).sum() + (lse * aw_lse).sum(),
                                   leaves)

    LAUNCHES.reset()
    g_flash = attn_grads(lambda *a: flash_attention_with_lse(*a, causal=True))
    torch.cuda.synchronize()
    check(LAUNCHES.snapshot() == {FA: 1, **{n: 1 for n in BWD_NAMES}},
          f"autograd launches {LAUNCHES.snapshot()}")
    g_dense = attn_grads(dense_with_lse)
    autograd_err = max((a - b).abs().max().item() / max(
        1.0, b.abs().max().item()) for a, b in zip(g_flash, g_dense))
    check(autograd_err <= FA_BWD_TOL["float32"],
          f"autograd through flash vs dense: rel err {autograd_err}")
    g_again = attn_grads(lambda *a: flash_attention_with_lse(*a,
                                                             causal=True))
    check(all(torch.equal(a, b) for a, b in zip(g_flash, g_again)),
          "two runs of the flash backward differ")
    print(f"[k6] flash backward matches its plain version on {n_bwd} cases "
          f"(max abs err f32 {bwd_err['float32']}, bf16 "
          f"{bwd_err['bfloat16']}; at the training shape {bwd_err_train}); "
          f"autograd vs dense rel err "
          f"{autograd_err:.3g}; two runs bit-identical", flush=True)

    # ---- 10. the training path at full width ------------------------ #
    plan_tr = get_plan(dtype="float32", **LM)
    lm_train = synthetic_lm(n_train=TRAIN_B * TRAIN_STEPS, n_test=TRAIN_B,
                            vocab=LM["vocab"], seq_len=TRAIN_T, seed=0)
    tr_data = list(batches(lm_train.train, TRAIN_B, seed=0,
                           drop_remainder=True))
    check(len(tr_data) == TRAIN_STEPS, "LM batch count")
    cfg_tr = Config(transport="fused", model="transformer_lm", attn="flash",
                    batch_size=TRAIN_B, lr=TRAIN_LR, momentum=TRAIN_MU)
    trainer_lm = FusedSplitTrainer(plan_tr, cfg_tr,
                                   torch.Generator().manual_seed(0),
                                   tr_data[0][0], device="cuda")
    tr_init = tuple({k: v.detach().cpu().clone() for k, v in st.items()}
                    for st in trainer_lm.params)
    check(sum(len(st) for st in tr_init) == LM_LEAVES, "LM leaf count")

    LAUNCHES.reset()
    tr_losses, tr_ms = [], []
    for x, y in tr_data:
        t = time.perf_counter()
        tr_losses.append(trainer_lm.train_step(x, y))  # float(): syncs
        tr_ms.append((time.perf_counter() - t) * 1e3)
    tr_counts = LAUNCHES.snapshot()
    want_counts = {FA: N_BLOCKS * TRAIN_STEPS,
                   **{n: N_BLOCKS * TRAIN_STEPS for n in BWD_NAMES},
                   FWD: TRAIN_STEPS, BWD: TRAIN_STEPS,
                   SGD: math.ceil(LM_LEAVES / SGD_TABLE) * TRAIN_STEPS}
    print(f"[train] {TRAIN_STEPS} steps, launches {tr_counts}, losses "
          f"{tr_losses[0]:.4f} -> {tr_losses[-1]:.4f}", flush=True)
    check(tr_counts == want_counts,
          f"training launches {tr_counts}, want {want_counts}")
    check(all(math.isfinite(v) for v in tr_losses), "finite LM losses")
    check(statistics.mean(tr_losses[-5:]) < statistics.mean(tr_losses[:5]),
          f"LM loss did not fall: {tr_losses}")
    for st in trainer_lm.params:
        for k, v in st.items():
            check(bool(torch.isfinite(v).all()), f"finite LM param {k}")

    cfg_twin = cfg_tr.replace(batch_size=TWIN_ROWS)
    rows = [(x[:TWIN_ROWS], y[:TWIN_ROWS]) for x, y in tr_data[:TWIN_STEPS]]
    twin_card = FusedSplitTrainer(plan_tr, cfg_twin, tr_init, rows[0][0],
                                  device="cuda")
    twin_cpu = FusedSplitTrainer(plan_tr, cfg_twin, tr_init, rows[0][0],
                                 device="cpu")
    card_rows = [twin_card.train_step(x, y) for x, y in rows]
    cpu_rows = [twin_cpu.train_step(x, y) for x, y in rows]
    twin_lm_diff = max(abs(a - b) for a, b in zip(card_rows, cpu_rows))
    check(twin_lm_diff <= TWIN_TOL,
          f"LM CPU twin: {cpu_rows} vs card {card_rows}")

    def update_err(params, ref):
        """Worst leaf's max abs difference of the summed update (final
        minus initial parameters) from ``ref``'s, over the larger of
        ``ref``'s largest update entry in that leaf and TWIN_UPDATE_FLOOR
        of the largest in any leaf: ``(error, leaf)``."""
        diffs, tops = {}, {}
        for i, (st, st_ref, st0) in enumerate(zip(params, ref, tr_init)):
            for key, p0 in st0.items():
                u_ref = st_ref[key].detach().cpu() - p0
                tops[i, key] = u_ref.abs().max().item()
                diffs[i, key] = (st[key].detach().cpu() - p0
                                 - u_ref).abs().max().item()
        floor = TWIN_UPDATE_FLOOR * max(tops.values())
        rel = {leaf: diffs[leaf] / max(tops[leaf], floor) for leaf in tops}
        leaf = max(rel, key=rel.get)
        return rel[leaf], f"stage {leaf[0]} {leaf[1]}"

    twin_update, twin_leaf = update_err(twin_card.params, twin_cpu.params)
    check(twin_update <= TWIN_UPDATE_TOL,
          f"LM CPU twin: parameter updates differ by {twin_update} in "
          f"{twin_leaf}")
    # the check must see a broken backward: the CPU twin again, with the
    # plain backward's dQ planted as zero
    planted = fa_mod.flash_attention_bwd_plain

    def zero_dq(*args):
        dq, dk, dv = planted(*args)
        return torch.zeros_like(dq), dk, dv

    fa_mod.flash_attention_bwd_plain = zero_dq
    try:
        twin_bad = FusedSplitTrainer(plan_tr, cfg_twin, tr_init, rows[0][0],
                                     device="cpu")
        bad_rows = [twin_bad.train_step(x, y) for x, y in rows]
    finally:
        fa_mod.flash_attention_bwd_plain = planted
    bad_update, bad_leaf = update_err(twin_bad.params, twin_cpu.params)
    bad_loss = max(abs(a - b) for a, b in zip(bad_rows, cpu_rows))
    check(bad_update > TWIN_UPDATE_TOL,
          f"a zero dQ moved the updates by only {bad_update}")
    print(f"[train] CPU twin on {TWIN_ROWS} rows x {TWIN_STEPS} steps agrees "
          f"(losses within {twin_lm_diff:.3g}; updates within "
          f"{twin_update:.3g}, worst in {twin_leaf}, tolerance "
          f"{TWIN_UPDATE_TOL}); a planted zero dQ moves the updates by "
          f"{bad_update:.3g} (in {bad_leaf}) and the losses by "
          f"{bad_loss:.3g}", flush=True)

    cli_runs = {}
    for model, dataset, size in (
            ("transformer_lm", "lm", ["--seq-len", "128", "--d-model", "64",
                                      "--batch-size", "8"]),
            ("transformer", "tokens", ["--seq-len", "256", "--d-model",
                                       str(LM["d_model"]), "--batch-size",
                                       str(TRAIN_B)])):
        LAUNCHES.reset()
        rc = launch_run.main([
            "train", "--model", model, "--dataset", dataset, "--attn",
            "flash", "--num-heads", "2", "--steps", "5", "--lr", "0.1",
            "--tracking", "noop", "--data-dir",
            os.path.join(REPO, "build", "chip_smoke_data"), *size])
        cli_runs[model] = LAUNCHES.snapshot()
        check(rc == 0, f"launch.run.main {model} returned {rc}")
        check(cli_runs[model] == {FA: 15, **{n: 15 for n in BWD_NAMES},
                                  FWD: 5, BWD: 5, SGD: 15},
              f"CLI {model} launches {cli_runs[model]}")
    print(f"[train] CLI trained transformer_lm and transformer 5 steps each "
          f"(launches {cli_runs})", flush=True)

    # ---- 11. times ---------------------------------------------------- #
    shape = TRAIN_SHAPE
    head_dim = shape[3]
    n_rows, n_el = math.prod(shape[:3]), math.prod(shape)
    bh = shape[0] * shape[2]
    pairs = TRAIN_T * (TRAIN_T + 1) // 2 * bh   # live causal (row, col)
    # products of T x T x D per kernel: dK/dV 4 (S, dP, dV, dK), dQ 3
    # (S, dP, dQ); the least work for the whole backward is 5
    work = {BWD_DELTA: 2 * n_el, BWD_DKV: 8 * pairs * head_dim,
            BWD_DQ: 6 * pairs * head_dim, "whole": 10 * pairs * head_dim}
    k6_rec = {n: {} for n in BWD_NAMES}
    k6_whole = {}
    for dtype, peak in ((torch.float32, fp32), (torch.bfloat16, bf16_peak)):
        name = str(dtype).replace("torch.", "")
        e = torch.tensor([], dtype=dtype).element_size()
        q, k, v, do = (torch.randn(shape, device=dev, generator=gen).to(dtype)
                       for _ in range(4))
        o, lse = flash_fwd_cuda(q, k, v, True)
        delta = flash_bwd_delta_cuda(o, do)
        nbytes = {BWD_DELTA: 2 * n_el * e + 4 * n_rows,
                  BWD_DKV: 6 * n_el * e + 8 * n_rows,
                  BWD_DQ: 5 * n_el * e + 8 * n_rows,
                  "whole": 8 * n_el * e + 4 * n_rows}
        launch = {BWD_DELTA: lambda: flash_bwd_delta_cuda(o, do),
                  BWD_DKV: lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                      True),
                  BWD_DQ: lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                    True)}
        plain = {BWD_DELTA: lambda: flash_bwd_delta_plain(o, do),
                 BWD_DKV: lambda: flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                      True),
                 BWD_DQ: lambda: flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                    True)}
        for n in BWD_NAMES:
            b_ms, b_by = bound(nbytes[n], work[n], bw, peak)
            k6_rec[n][name] = dict(
                ms=device_ms(torch, launch[n], reps=20),
                plain_ms=device_ms(torch, plain[n], reps=10),
                bytes=nbytes[n], flops=work[n], bound_ms=b_ms, bound_by=b_by,
                max_abs_err=bwd_err_train[name][n],
                max_abs_err_grid=bwd_err[name][n])
        # delta with no LSE cotangent, as on the training path, is one
        # library call (its output in the input dtype)
        k6_rec[BWD_DELTA][name]["library_ms"] = device_ms(
            torch, lambda: torch.linalg.vecdot(o, do, dim=-1), reps=20)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        do_t = do.transpose(1, 2)
        b_ms, b_by = bound(nbytes["whole"], work["whole"], bw, peak)
        k6_whole[name] = dict(
            shape=list(shape), dtype=name, causal=True,
            ms=device_ms(torch, lambda: flash_bwd_cuda(q, k, v, o, lse, do,
                                                       None, True), reps=20),
            plain_ms=device_ms(torch, lambda: flash_attention_bwd_plain(
                q, k, v, o, lse, do, None, True), reps=10),
            library_ms=device_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), do_t, retain_graph=True), reps=20),
            library_call="torch.autograd.grad of "
                         "F.scaled_dot_product_attention(is_causal=True)",
            bytes=nbytes["whole"], flops=work["whole"], bound_ms=b_ms,
            bound_by=b_by)
        # no library call computes dK, dV or dQ alone: the SDPA backward,
        # which computes all three, stands on the dK/dV record
        k6_rec[BWD_DKV][name]["library_ms"] = k6_whole[name]["library_ms"]
        k6_rec[BWD_DQ][name]["library_ms"] = None
        del q, k, v, do, o, lse, delta, qt, kt, vt, lib_out, do_t
    replaces = {BWD_DELTA: "split_learning_tpu/ops/flash_attention.py:693",
                BWD_DKV: "split_learning_tpu/ops/flash_attention.py:542",
                BWD_DQ: "split_learning_tpu/ops/flash_attention.py:503"}
    library_call = {
        BWD_DELTA: "torch.linalg.vecdot(o, do, dim=-1)",
        BWD_DKV: "torch.autograd.grad of F.scaled_dot_product_attention("
                 "is_causal=True): the whole backward, all three launches",
        BWD_DQ: None}
    for n in BWD_NAMES:
        records.append(dict(
            name=n, route="cuda",
            source="split_learning_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=replaces[n],
            also_replaces="split_learning_tpu/ops/flash_attention.py:443",
            jax_counterpart="split_learning_tpu/ops/flash_attention.py"
                            ":_make_flash.vjp_bwd",
            launches=tr_counts[n], launches_per_step=N_BLOCKS,
            library_call=library_call[n],
            shape=list(shape), dtype="float32", causal=True,
            **k6_rec[n]["float32"], bfloat16=k6_rec[n]["bfloat16"]))
    records[-1]["library_note"] = (
        "no one PyTorch call computes dQ alone; the SDPA backward, which "
        "computes dQ, dK and dV, is the dK/dV record's library_ms")
    launch_of = {"fused_cross_entropy_fwd": FWD,
                 "fused_cross_entropy_bwd": BWD, "fused_sgd_step": SGD}
    for rec in records:
        rec["launches_train_lm"] = tr_counts[launch_of.get(rec["name"],
                                                           rec["name"])]

    steady_tr = tr_ms[5:]
    train_lm = dict(train_lm=dict(
        model="transformer_lm", mode="split", dtype="float32",
        d_model=LM["d_model"], num_heads=LM["num_heads"], vocab=LM["vocab"],
        blocks=N_BLOCKS, attn="flash", batch=TRAIN_B, seq_len=TRAIN_T,
        steps=TRAIN_STEPS, lr=TRAIN_LR, momentum=TRAIN_MU, device=kind,
        step_ms_median=statistics.median(steady_tr),
        step_ms_min=min(steady_tr), step_ms_max=max(steady_tr),
        tokens_per_s=TRAIN_B * TRAIN_T / statistics.median(steady_tr) * 1e3,
        step_ms_first=tr_ms[0], loss_first=tr_losses[0],
        loss_last=tr_losses[-1], launches=tr_counts,
        twin_rows=TWIN_ROWS, twin_steps=TWIN_STEPS,
        twin_max_abs_diff=twin_lm_diff, twin_update_rel_err=twin_update,
        twin_update_worst_leaf=twin_leaf,
        planted_zero_dq_update_rel_err=bad_update,
        planted_zero_dq_loss_diff=bad_loss, cli_launches=cli_runs,
        k6=k6_whole, k6_autograd_rel_err=autograd_err,
        profile=profile_steps(torch, trainer_lm, tr_data[:10])))

    print(json.dumps({"kernels": records}))
    print(json.dumps(step))
    print(json.dumps(serving))
    print(json.dumps(train_lm))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
