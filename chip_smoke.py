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
   N x C shapes, float32 and bfloat16 logits;
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
   views: O and LSE within 2e-5 (float32) and within 3e-2 / 1e-3
   (bfloat16: two bf16 ulps at |o| near 2), row 0 of a strict mask
   o = 0 and lse = NEG_BIG;
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
   ``torch.profiler`` window over one KV generate.

Output, last lines: one JSON object with a record per kernel, one JSON
object with the main path's step time, one with the serving path's
times, the ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
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
    from split_learning_tpu_torch.ops.flash_attention import (
        NAME as FA, flash_attention_with_lse_plain, flash_fwd_cuda)
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
            check(err <= 1e-6, f"CE grad N={n} C={c}: abs {err}")
            ce_err[FWD] = max(ce_err[FWD], abs(loss_k.item() - loss_p.item()))
            ce_err[BWD] = max(ce_err[BWD], err)
        else:
            ok = ((gk - gp).abs() <= 1e-2 * gp.abs() + 1e-12).all().item()
            check(ok, f"CE bf16 grad N={n} C={c}: max abs {err}")
    print(f"[k1] cross-entropy matches its plain version on {len(cases)} "
          f"shapes (max abs err fwd {ce_err[FWD]:.3g}, bwd "
          f"{ce_err[BWD]:.3g})", flush=True)

    # ---- 3. SGD kernel vs plain ------------------------------------- #
    for mu in (0.0, 0.9):
        p_k = [torch.randn(s, device=dev, generator=gen)
               for s in CNN_LEAF_SHAPES]
        p_p = [t.clone() for t in p_k]
        m_k = [torch.zeros_like(t) for t in p_k] if mu else None
        m_p = [torch.zeros_like(t) for t in p_k] if mu else None
        for _ in range(5):
            grads = [torch.randn(s, device=dev, generator=gen)
                     for s in CNN_LEAF_SHAPES]
            sgd_step_cuda(p_k, grads, m_k, LR, mu)
            torch.cuda.synchronize()
            sgd_step_plain(p_p, grads, m_p, LR, mu)
        for a, b in zip(p_k + (m_k or []), p_p + (m_p or [])):
            check(torch.equal(a, b), f"SGD mu={mu}: not bit-identical "
                  f"(max abs {(a - b).abs().max().item()})")
    print("[k2] SGD bit-identical to its plain version (mu 0 and 0.9, "
          "5 steps, 6 CNN leaves)", flush=True)

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
    n_cases = 0

    def fa_check(q, k, v, causal, strict, what):
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
        fa_err[name][0] = max(fa_err[name][0], e_o)
        fa_err[name][1] = max(fa_err[name][1], e_l)

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
    print(f"[k5] flash attention matches its plain version on {n_cases} "
          f"cases (max abs err O/LSE: f32 {fa_err['float32'][0]:.3g}/"
          f"{fa_err['float32'][1]:.3g}, bf16 {fa_err['bfloat16'][0]:.3g}/"
          f"{fa_err['bfloat16'][1]:.3g})", flush=True)

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
            max_abs_err=fa_err[name][0], max_abs_err_lse=fa_err[name][1])
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

    print(json.dumps({"kernels": records}))
    print(json.dumps(step))
    print(json.dumps(serving))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
