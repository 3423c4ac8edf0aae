#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what it serves.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (CUDA toolkit) and the repository's
``fashionvisualexpl_tpu_torch`` package; without either it exits non-zero
and prints no result.  It imports no JAX.

Phases, each of which raises on a failure (nothing is swallowed):

1. card: name and power limit from ``nvidia-smi``;
2. build: every kernel source under ``fashionvisualexpl_tpu_torch/ops/csrc``
   compiled with ``nvcc`` for sm_90a, one process per source, all started
   together;
3. kernel: ``segmax_scores`` (the CUDA kernel) against its plain PyTorch
   version on the card over many geometries, then its time, the plain
   version's time, one ``torch.matmul`` of the same bf16 operands (a
   yardstick the port never calls) and the bound, at the serving shapes;
4. serve: ``RecServer`` over BPRMF K=128, 1M users x 1M items, random
   weights from a seeded generator, a P=20 history made with numpy, k=20,
   seg=32, oversample=2; refresh, then query buckets B = 8, 64, 1024, 4096
   through the kernel (its launch count must rise in every bucket), 64
   users checked against a full-catalog fp32 oracle on the card, p50 ms
   and QPS per bucket, peak memory;
5. options: the fp32 and int8 stage-1 block scans on the same index size,
   checked against the same oracle;
6. train kernels: the fused BPR loss (K1, forward and backward kernels) and
   the fused Adam sweep (K6) against their plain PyTorch versions over many
   shapes, then their times, the plain versions' times, the library call
   (K6 only: ``torch._fused_adam_`` with a zero gradient, which reads one
   more array) and the bounds at the training step's shapes, each call
   timed with the L2 flushed and no kernel allowed under its bound;
7. train: the fast BPRMF path (``make_fast_epoch_fn``, ``pallas_bpr=True``,
   ``fused_adam=True``) at the JAX package's scaled training configuration,
   K=128, 1M users x 500k items, 20 positives per user, batch 8192, 200
   steps per epoch, user_perm sampling.  5 steps by the kernel route against
   5 by the plain route from one state; 3 epochs through the kernels (the
   launch counts must show 2 K1 and 3 K6 launches per step) with triples/s,
   ms per step and peak memory; one ``torch.profiler`` pass of 10 steps;
8. fit: the generic ``fit`` at the reference workload (10k x 10k, 20
   interactions per user, K=64, batch 256, 2 epochs), whose epoch losses
   must be finite and falling.

The line before the last is a JSON object of the kernels with their
numbers; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "fashionvisualexpl_tpu_torch"

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# serving configuration (the JAX package's own 1M x 1M serving bench)
U_FULL = I_FULL = 1_000_000
EMBED_K = 128
K_TOP, SEG, OVERSAMPLE, ITEM_BLOCK, HIST_P = 20, 32, 2, 65536, 20
BUCKETS = (8, 64, 1024, 4096)
# kernel vs plain version: the kernel sums D products sequentially in f32
# FMAs, cuBLAS in another order, on scores of magnitude up to ~20
K_ATOL, K_RTOL = 1e-4, 1e-5

# training configuration (the JAX package's scripts/scaled_bench.py)
TRAIN_U, TRAIN_I, TRAIN_POS = 1_000_000, 500_000, 20
TRAIN_B, TRAIN_STEPS, TRAIN_EPOCHS, TRAIN_LR, TRAIN_REG = 8192, 200, 3, 0.001, 0.001
ROUTE_STEPS, PROFILE_STEPS = 5, 10
# the reference workload (bench.py) for the generic fit
REF_U = REF_I = 10_000
REF_K, REF_B, REF_PER_USER, REF_EPOCHS = 64, 256, 20, 2
# K1 kernel vs plain version: the loss sums in another order (rtol 1e-5).
# sigma follows diff, whose K products the kernel sums with FMAs in lane
# order and torch in its own: the rounding grows with the products, which
# scale as the inputs squared, so sigma's atol is BPR_ATOL * scale**2.  The
# backward is compared on the kernel's own sigma (rtol 1e-4, atol 1e-5).
BPR_LOSS_RTOL = 1e-5
BPR_RTOL, BPR_ATOL = 1e-4, 1e-5
# K6 kernel vs plain version: the same f32 operations in the same order
ADAM_RTOL_MV, ADAM_RTOL_P = 1e-6, 1e-5
# kernel route vs plain route over 5 full-width steps.  Params where Adam's
# denominator is tiny may leave the tolerance: at most a 1e-6 share of them
# (6 and 7 of 192.5M in two runs on an H100), each by less than the two
# routes' updates can differ, 2 lr a step
ROUTE_RTOL, ROUTE_ATOL = 2e-4, 1e-6
ROUTE_EXEMPT_CAP = 1e-6
ROUTE_DRIFT = 2 * TRAIN_LR * ROUTE_STEPS


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn over iters launches, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def segmax_bound_ms(B: int, Ip: int, D: int, seg: int, elt: int, peak: float):
    """(ms, "bytes"|"operations"): each input read once, the output written
    once, against 2*B*Ip*D operations at the operand type's peak rate."""
    bytes_ = (B + Ip) * D * elt + Ip * 4 + B * (Ip // seg) * 4
    t_bytes = bytes_ / PEAK_BYTES
    t_ops = 2.0 * B * Ip * D / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, segmax):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def inputs(B, Ip, D, dtype, n_pad=0):
        uf = (torch.randn(B, D, device=dev, generator=g) * (3.0 / D**0.5)).to(dtype)
        iv = torch.randn(Ip, D, device=dev, generator=g).to(dtype)
        ib = torch.randn(Ip, device=dev, generator=g) * 0.1
        if n_pad:
            ib[Ip - n_pad:] = -1e30
        return uf, iv, ib

    def check(label, uf, iv, ib, seg):
        got = segmax.segmax_scores(uf, iv, ib, seg)
        torch.cuda.synchronize()
        want = segmax.segmax_scores_reference(uf, iv, ib, seg)
        err = (got - want).abs()
        ok = bool((err <= K_ATOL + K_RTOL * want.abs()).all())
        worst = float(err.max())
        print(f"kernel check {label}: max_abs_err={worst!r} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"segmax kernel disagrees with its plain version at {label}")
        return worst

    names = {torch.bfloat16: "bf16", torch.float32: "f32"}
    for seg in (8, 32):
        for D in (16, 128):
            for B in (8, 100, 4096):
                for dtype in (torch.bfloat16, torch.float32):
                    check(f"seg={seg} D={D} B={B} {names[dtype]} Ip=65536",
                          *inputs(B, 65536, D, dtype), seg)
        for dtype in (torch.bfloat16, torch.float32):
            Ip = seg * 1001  # ragged catalog, trailing pad items at -1e30
            check(f"seg={seg} D=128 B=100 {names[dtype]} Ip={Ip} pads=500",
                  *inputs(100, Ip, 128, dtype, n_pad=500), seg)

    # times at the serving shapes: 1M items padded to the 65536 block
    Ip, D = 16 * ITEM_BLOCK, EMBED_K
    rows = {}
    for B, iters in ((8, 50), (4096, 5)):
        uf, iv, ib = inputs(B, Ip, D, torch.bfloat16, n_pad=Ip - I_FULL)
        err = check(f"serving shape seg={SEG} D={D} B={B} bf16 Ip={Ip}", uf, iv, ib, SEG)
        ms = cuda_ms(torch, lambda: segmax.segmax_scores(uf, iv, ib, SEG), iters)
        plain = cuda_ms(
            torch, lambda: segmax.segmax_scores_reference(uf, iv, ib, SEG), iters
        )
        lib = cuda_ms(torch, lambda: torch.matmul(uf, iv.T), iters)
        bound, by = segmax_bound_ms(B, Ip, D, SEG, 2, PEAK_BF16_FLOPS)
        check_bound(f"segmax B={B}", ms, bound)
        rows[B] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                       bound_by=by, library_ms=lib)
        print(f"kernel time B={B} Ip={Ip} D={D} seg={SEG} bf16: ms={ms!r} "
              f"plain_ms={plain!r} library_ms(matmul bf16)={lib!r} "
              f"bound_ms={bound!r} ({by})")
        del uf, iv, ib
        torch.cuda.empty_cache()
    return rows


def oracle_topk(torch, model, users, padded, counts, k):
    """Full-catalog fp32 scores of `users` on the card, history masked."""
    with torch.no_grad():
        u = torch.as_tensor(users, device=model.device, dtype=torch.long)
        s = model.predict_user_block(u)
        for row, uid in enumerate(users):
            hist = torch.as_tensor(padded[uid, : counts[uid]], device=s.device).long()
            s[row, hist] = float("-inf")
        vals, ids = torch.topk(s, k, dim=1)
    return ids.cpu().numpy(), vals.cpu().numpy()


def check_served(np, label, ids, vals, want_ids, want_vals):
    if not np.isfinite(vals).all():
        fail(f"{label}: non-finite served values")
    if not np.array_equal(ids, want_ids):
        bad = int((ids != want_ids).any(axis=1).sum())
        fail(f"{label}: served ids differ from the fp32 oracle for {bad} users")
    if not np.allclose(vals, want_vals, rtol=1e-5, atol=0.0):
        fail(f"{label}: served values differ from the fp32 oracle beyond rtol 1e-5")
    err = float(np.abs(vals - want_vals).max())
    print(f"{label}: ids equal to the fp32 oracle, max_abs_err={err!r}")


def serve_phase(torch, np, segmax):
    from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
    from fashionvisualexpl_tpu_torch.serve import RecServer

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(0)
    model = BPRMF(U_FULL, I_FULL, embed_k=EMBED_K, generator=g)
    with torch.no_grad():  # a random item bias on the dot products' scale
        model.Bi.normal_(0.0, 2e-5, generator=g)
    rng = np.random.default_rng(0)
    padded = rng.integers(0, I_FULL, (U_FULL, HIST_P), dtype=np.int32)
    counts = rng.integers(0, HIST_P + 1, U_FULL).astype(np.int32)
    # RecServer reads only the counts from `data` when `history` is given
    data = types.SimpleNamespace(num_users=U_FULL, num_items=I_FULL)
    torch.cuda.synchronize()
    print(f"serve setup (model + history): {time.perf_counter() - t0!r} s")

    srv = RecServer(model, data, k=K_TOP, seg=SEG, oversample=OVERSAMPLE,
                    item_block=ITEM_BLOCK, history=(padded, counts))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv.refresh()
    torch.cuda.synchronize()
    print(f"refresh: {time.perf_counter() - t0!r} s  k_seg={srv._k_seg} "
          f"padded_items={srv._padded_items}")

    batches = {B: rng.choice(U_FULL, B, replace=False) for B in BUCKETS}
    reps = {8: 30, 64: 30, 1024: 10, 4096: 5}
    results, served = {}, {}
    segmax.segmax_scores.launches = 0  # main path starts here
    for B in BUCKETS:
        before = segmax.segmax_scores.launches
        ids, vals = srv.query(batches[B])  # warm-up
        times = []
        for _ in range(reps[B]):
            t0 = time.perf_counter()
            ids, vals = srv.query(batches[B])
            times.append(time.perf_counter() - t0)
        launched = segmax.segmax_scores.launches - before
        if launched < 1:
            fail(f"bucket B={B} did not launch the segmax kernel")
        if ids.shape != (B, K_TOP) or not np.isfinite(vals).all():
            fail(f"bucket B={B}: bad result shape {ids.shape} or non-finite values")
        p50 = statistics.median(times)
        results[B] = dict(p50_ms=1e3 * p50, qps=B / p50, launches=launched)
        served[B] = (ids, vals)
        print(f"serve B={B}: p50_ms={1e3 * p50!r} qps={B / p50!r} "
              f"min_ms={1e3 * min(times)!r} kernel_launches={launched}")
    launches = segmax.segmax_scores.launches  # main path ends here
    peak = torch.cuda.max_memory_allocated()
    print(f"serve peak device memory: {peak / 2**30!r} GiB")
    print(f"serve main path: {launches} segmax launches over "
          f"{sum(reps[B] + 1 for B in BUCKETS)} queries")

    users = batches[64]
    want_ids, want_vals = oracle_topk(torch, model, users, padded, counts, K_TOP)
    check_served(np, "serve check B=64 bf16 kernel", *served[64], want_ids, want_vals)
    del srv
    torch.cuda.empty_cache()

    for label, kw in (("fp32 stage 1", dict(stage1_dtype="fp32")),
                      ("int8 stage 1", dict(quantized=True))):
        opt = RecServer(model, data, k=K_TOP, seg=SEG, oversample=OVERSAMPLE,
                        item_block=ITEM_BLOCK, history=(padded, counts), **kw)
        opt.refresh()
        ids, vals = opt.query(users)
        check_served(np, f"options check B=64 {label}", ids, vals, want_ids, want_vals)
        del opt
        torch.cuda.empty_cache()
    return results, launches


def bound_ms(bytes_: float, ops: float, peak: float):
    """(ms, "bytes"|"operations"): the larger of the bytes over the memory
    rate and the operations over the peak rate of their type."""
    t_bytes, t_ops = bytes_ / PEAK_BYTES, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bpr_bounds(B: int, K: int):
    """Forward and backward bounds of K1 at [B, K] f32 (4 bytes each).
    Forward: reads gu, gp, gn and bp, bn, writes sigma and the loss; about
    3 operations per element (sub, mul, add) and 20 per triple (clip,
    softplus, sigmoid).  Backward: reads sigma, gu, gp, gn and g, writes
    three [B, K] and two [B] gradients; 7 operations per element."""
    fwd = bound_ms(4 * (3 * B * K + 2 * B + B + 1), 3 * B * K + 20 * B, PEAK_F32_FLOPS)
    bwd = bound_ms(4 * (B + 3 * B * K + 1 + 3 * B * K + 2 * B), 7 * B * K + 2 * B,
                   PEAK_F32_FLOPS)
    return fwd, bwd


def adam_bound(n: int):
    """K6 on n f32 elements: p, m, v read once and written once; 8
    operations per element (two decays, v scale, sqrt, eps add, lr mul,
    divide, subtract)."""
    return bound_ms(4 * 6 * n + 8, 8 * n, PEAK_F32_FLOPS)


def dev_us(ev) -> float:
    """Self device time (us) of a torch.profiler event average."""
    return (getattr(ev, "self_device_time_total", 0)
            or getattr(ev, "self_cuda_time_total", 0))


def kernel_times(torch, label, fn, iters: int, flush):
    """(ms, call_ms) per call of fn, with the L2 emptied before each call
    by a fill of ``flush`` (a buffer larger than the 50 MB L2) that neither
    time counts, so that fn's inputs come from device memory.  ``ms``: the
    durations of fn's kernels from torch.profiler, launch gaps left out;
    fails if the profiler saw none.  ``call_ms``: CUDA events around each
    call, which also holds the host's launch cost when the kernels are
    shorter than it."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    marks = []
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            flush.fill_(1.0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            marks.append((start, end))
        torch.cuda.synchronize()
    call_ms = sum(s.elapsed_time(e) for s, e in marks) / iters
    us = sum(dev_us(ev) for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA and "FillFunctor" not in ev.key)
    if not us:
        fail(f"{label}: torch.profiler recorded no device time")
    return us / 1e3 / iters, call_ms


def check_bound(label, ms: float, bound: float) -> None:
    """A kernel timed below its bound means the bound does not describe
    how it was timed (data left in L2, a miscounted byte)."""
    if ms < bound:
        fail(f"{label}: timed at {ms!r} ms, under its bound {bound!r} ms")


def worst(torch, label, got, want, rtol, atol):
    """Max |got - want|, after failing if any element is beyond atol +
    rtol * |want|."""
    err = (got - want).abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        fail(f"{label}: kernel disagrees with its plain version "
             f"(max_abs_err={float(err.max())!r})")
    return float(err.max())


def make_scaled_arrays(num_users, num_items, pos_per_user, seed=0):
    """The JAX package's scaled training arrays (scripts/scaled_bench.py):
    row u gets pos_per_user distinct pseudo-random items (affine spread),
    sorted ascending; the pair list is user-major."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.integers(0, num_items, size=(num_users, 1), dtype=np.int64)
    stride = (num_items // (pos_per_user + 1)) - 1
    items = (base + np.arange(pos_per_user, dtype=np.int64) * stride) % num_items
    items = np.sort(items, axis=1).astype(np.int32)
    counts = np.full((num_users,), pos_per_user, dtype=np.int32)
    users = np.repeat(np.arange(num_users, dtype=np.int32), pos_per_user)
    pairs = np.stack([users, items.reshape(-1)], axis=1)
    return pairs, items, counts


def train_kernel_phase(torch, bpr, adam):
    """K1 and K6 against their plain versions, then timed at the step's
    shapes.  Returns the kernels' rows (launches filled in later)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    one = torch.ones((), device=dev)
    errs = {"bpr_fwd": 0.0, "bpr_bwd": 0.0, "adam_sweep": 0.0}
    loss_rel = 0.0

    def bpr_inputs(B, K, scale):
        rows = [torch.randn(B, K, device=dev, generator=g) * scale for _ in range(3)]
        return rows + [torch.randn(B, device=dev, generator=g) for _ in range(2)]

    for B in (1, 100, TRAIN_B):
        for K in (8, 64, EMBED_K):
            for scale in (1.0, 20.0):  # scale 20 pushes diff past the clip
                args = bpr_inputs(B, K, scale)
                loss, sigma = bpr.bpr_forward(*args)
                grads = bpr.bpr_backward(sigma, *args[:3], one)
                torch.cuda.synchronize()
                want_loss, want_sigma = bpr.bpr_forward_reference(*args)
                want_grads = bpr.bpr_backward_reference(sigma, *args[:3], one)
                label = f"B={B} K={K} scale={scale:g}"
                rel = abs(float(loss) - float(want_loss)) / max(abs(float(want_loss)), 1e-30)
                if rel > BPR_LOSS_RTOL:
                    fail(f"bpr_fwd {label}: loss {float(loss)!r} vs plain "
                         f"{float(want_loss)!r}")
                e_f = worst(torch, f"bpr_fwd {label} sigma", sigma, want_sigma,
                            BPR_RTOL, BPR_ATOL * scale**2)
                e_b = max(worst(torch, f"bpr_bwd {label}", a, w, BPR_RTOL, BPR_ATOL)
                          for a, w in zip(grads, want_grads))
                clipped = int((sigma == 0).sum())
                print(f"kernel check bpr {label}: loss_rel_err={rel!r} "
                      f"sigma_max_abs_err={e_f!r} grads_max_abs_err={e_b!r} "
                      f"clipped={clipped}/{B} ok")
                loss_rel = max(loss_rel, rel)
                errs["bpr_fwd"] = max(errs["bpr_fwd"], e_f)
                errs["bpr_bwd"] = max(errs["bpr_bwd"], e_b)

    def adam_state(shape):
        p = torch.randn(shape, device=dev, generator=g)
        m = torch.randn(shape, device=dev, generator=g) * 0.1
        v = torch.randn(shape, device=dev, generator=g).abs() * 0.01
        return p, m, v

    scal = adam.adam_scalars(TRAIN_LR, torch.tensor(7.0, device=dev))

    def adam_check(label, p, m, v):
        pk, mk, vk = (x.clone() for x in (p, m, v))
        adam.fused_adam_sweep(pk, mk, vk, scal)
        torch.cuda.synchronize()
        adam.fused_adam_sweep_reference(p, m, v, scal)
        e = max(worst(torch, f"adam_sweep {label} m", mk, m, ADAM_RTOL_MV, 0.0),
                worst(torch, f"adam_sweep {label} v", vk, v, ADAM_RTOL_MV, 0.0),
                worst(torch, f"adam_sweep {label} p", pk, p, ADAM_RTOL_P, 0.0))
        print(f"kernel check adam_sweep {label}: max_abs_err={e!r} ok")
        errs["adam_sweep"] = max(errs["adam_sweep"], e)

    for shape in ((1001, 7), (4099,), (3,), (257, EMBED_K)):
        adam_check(f"shape={shape}", *adam_state(shape))
    # a table whose data is not 16-byte aligned takes the scalar loop
    base = [x for x in adam_state((10_004,))]
    adam_check("shape=(10003,) unaligned", *(x[1:] for x in base))

    # times at the step's shapes, every input read from device memory (the
    # L2 flushed before each call), as the bounds assume: K1 on [8192, 128]
    # rows, K6 on each table
    flush = torch.empty(64 * 2**20 // 4, device=dev)  # 64 MB > the 50 MB L2
    fwd_b, bwd_b = bpr_bounds(TRAIN_B, EMBED_K)
    args = bpr_inputs(TRAIN_B, EMBED_K, 1.0)
    _, sigma = bpr.bpr_forward(*args)
    shape = f"B={TRAIN_B} K={EMBED_K} f32, cold L2"
    rows = {}
    for name, run, plain, (b, by) in (
        ("bpr_fwd", lambda: bpr.bpr_forward(*args),
         lambda: bpr.bpr_forward_reference(*args), fwd_b),
        ("bpr_bwd", lambda: bpr.bpr_backward(sigma, *args[:3], one),
         lambda: bpr.bpr_backward_reference(sigma, *args[:3], one), bwd_b),
    ):
        ms, call_ms = kernel_times(torch, name, run, 200, flush)
        plain_ms, plain_call_ms = kernel_times(torch, f"{name} plain", plain, 200, flush)
        check_bound(name, ms, b)
        rows[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                          bound_ms=b, bound_by=by, library_ms=None,
                          call_ms=call_ms, plain_call_ms=plain_call_ms, shape=shape)
        print(f"kernel time {name} {shape}: ms={ms!r} call_ms={call_ms!r} "
              f"plain_ms={plain_ms!r} plain_call_ms={plain_call_ms!r} "
              f"bound_ms={b!r} ({by}) library_ms=None (no single PyTorch call "
              f"computes it)")
    rows["bpr_fwd"]["loss_max_rel_err"] = loss_rel
    del args, sigma

    tables = {}
    for name, shape in (("Gu", (TRAIN_U, EMBED_K)), ("Gi", (TRAIN_I, EMBED_K)),
                        ("Bi", (TRAIN_I,))):
        p, m, v = adam_state(shape)
        adam_check(f"{name} shape={shape}", p, m, v)
        gz = torch.zeros_like(p)
        step = torch.tensor(7.0, device=dev)
        b, by = adam_bound(p.numel())
        label = f"adam_sweep {name}"
        ms, call_ms = kernel_times(torch, label, lambda: adam.fused_adam_sweep(
            p, m, v, scal), 20, flush)
        plain_ms, plain_call_ms = kernel_times(
            torch, f"{label} plain", lambda: adam.fused_adam_sweep_reference(p, m, v, scal),
            10, flush)
        lib_ms, lib_call_ms = kernel_times(
            torch, f"{label} library", lambda: torch._fused_adam_(
                [p], [gz], [m], [v], [], [step], lr=TRAIN_LR, beta1=0.9, beta2=0.999,
                weight_decay=0.0, eps=1e-7, amsgrad=False, maximize=False), 20, flush)
        check_bound(label, ms, b)
        tables[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b,
                            bound_by=by, call_ms=call_ms, plain_call_ms=plain_call_ms,
                            library_call_ms=lib_call_ms, shape=str(shape))
        print(f"kernel time {label} {shape}: ms={ms!r} "
              f"call_ms={call_ms!r} plain_ms={plain_ms!r} library_ms(_fused_adam_, "
              f"reads a zero grad too)={lib_ms!r} bound_ms={b!r} ({by})")
        del p, m, v, gz
    torch.cuda.empty_cache()
    rows["adam_sweep"] = dict(
        max_abs_err=errs["adam_sweep"],
        **{k: sum(r[k] for r in tables.values())
           for k in ("ms", "plain_ms", "bound_ms", "library_ms", "call_ms")},
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in tables.values())
        else "operations",
        shape="per step: Gu 1000000x128 + Gi 500000x128 + Bi 500000 f32, cold L2",
        library="torch._fused_adam_ with a zero gradient (reads one more array)",
        tables=tables,
    )
    return rows


def train_phase(torch, np, bpr, adam):
    """The fast path at full width: route check, the 3-epoch main path
    through K1 and K6, one profiler pass.  Returns (main-path launch
    counts, summary)."""
    from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
    from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
    from fashionvisualexpl_tpu_torch.train.fast import (
        init_fast_state,
        make_fast_bprmf_step,
        make_fast_epoch_fn,
    )

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    tabs = [torch.from_numpy(a).to(dev)
            for a in make_scaled_arrays(TRAIN_U, TRAIN_I, TRAIN_POS, seed=0)]
    model = BPRMF(TRAIN_U, TRAIN_I, embed_k=EMBED_K,
                  generator=torch.Generator(device=dev).manual_seed(2))
    params = {k: v.detach() for k, v in model.named_parameters()}
    torch.cuda.synchronize()
    print(f"train setup (arrays + model): {time.perf_counter() - t0!r} s")

    # the kernel route against the plain route, 5 steps from one state
    kern = init_fast_state({k: v.clone() for k, v in params.items()})
    plain = init_fast_state({k: v.clone() for k, v in params.items()})
    triples = sample_triplets(1, *tabs, TRAIN_I, ROUTE_STEPS, TRAIN_B)
    step_k = make_fast_bprmf_step(model, TRAIN_LR, TRAIN_REG, fused_adam=True,
                                  pallas_bpr=True)
    step_p = make_fast_bprmf_step(model, TRAIN_LR, TRAIN_REG)
    for s in range(ROUTE_STEPS):
        batch = tuple(t[s] for t in triples)
        kern, lk = step_k(kern, batch)
        plain, lp = step_p(plain, batch)
        lk, lp = float(lk), float(lp)
        if not (np.isfinite(lk) and abs(lk - lp) <= 1e-5 * abs(lp)):
            fail(f"route check step {s}: loss {lk!r} (kernels) vs {lp!r} (plain)")
    route_err, amplified, n_params = 0.0, 0, 0
    bc2 = 1.0 - 0.999**ROUTE_STEPS
    for k in params:
        for field in ("mu", "nu"):
            e = worst(torch, f"route check {field}[{k}]", getattr(kern, field)[k],
                      getattr(plain, field)[k], ROUTE_RTOL, ROUTE_ATOL)
            route_err = max(route_err, e)
        # p: where the gradient history is tiny (sqrt(v_hat) < 10 eps), the
        # update m_hat / (sqrt(v_hat) + eps) turns the last bits of a
        # near-cancelled gradient sum into a share of lr.  Such elements may
        # leave the tolerance, but only a few of them (ROUTE_EXEMPT_CAP), and
        # only by what the two routes' updates can differ: 2 lr a step.
        # Every other element must agree; rows neither route touched (v = 0
        # in both) to the bit.  A NaN fails every comparison.
        pk, pp = kern.params[k], plain.params[k]
        err = (pk - pp).abs()
        beyond = ~(err <= ROUTE_ATOL + ROUTE_RTOL * pp.abs())
        tiny = torch.sqrt(plain.nu[k] / bc2) < 10 * 1e-7
        if bool((beyond & ~tiny).any()):
            fail(f"route check params[{k}]: kernel route disagrees with the plain "
                 f"route (max_abs_err={float(err[~tiny].max())!r})")
        if bool((beyond & ~(err <= ROUTE_DRIFT)).any()):
            fail(f"route check params[{k}]: an element with tiny sqrt(v_hat) "
                 f"moved apart by more than {ROUTE_DRIFT!r} or is not finite")
        untouched = (kern.nu[k] == 0) & (plain.nu[k] == 0)
        if not torch.equal(pk[untouched], pp[untouched]):
            fail(f"route check params[{k}]: untouched rows differ between routes")
        amplified += int(beyond.sum())
        n_params += pk.numel()
        route_err = max(route_err, float(err.max()))
    if amplified > ROUTE_EXEMPT_CAP * n_params:
        fail(f"route check: {amplified} of {n_params} params beyond tolerance, "
             f"more than {ROUTE_EXEMPT_CAP!r} of them")
    print(f"route check: {ROUTE_STEPS} full-width steps, kernel route vs plain "
          f"route, params/m/v max_abs_err={route_err!r}; {amplified} of {n_params} "
          f"params beyond rtol {ROUTE_RTOL} atol {ROUTE_ATOL} (cap "
          f"{ROUTE_EXEMPT_CAP * n_params!r}), all with sqrt(v_hat) < 1e-6 and "
          f"within {ROUTE_DRIFT!r}; untouched rows bit-equal ok (last loss {lk!r})")
    del kern, plain, triples, pk, pp, err, beyond, tiny, untouched
    torch.cuda.empty_cache()

    # main path: 3 epochs through both kernels
    state = init_fast_state(params)
    epoch_fn = make_fast_epoch_fn(model, TRAIN_LR, TRAIN_REG, TRAIN_I, TRAIN_STEPS,
                                  TRAIN_B, fused_adam=True, pallas_bpr=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bpr.bpr_forward.launches = bpr.bpr_backward.launches = 0
    adam.fused_adam_sweep.launches = 0  # main path starts here
    epochs = []
    for e in range(TRAIN_EPOCHS):
        t0 = time.perf_counter()
        state, loss = epoch_fn(state, 100 + e, *tabs)
        loss = float(loss)  # one read per epoch; it waits for the epoch
        dt = time.perf_counter() - t0
        epochs.append(dict(loss=loss, s=dt, triples_per_s=TRAIN_STEPS * TRAIN_B / dt,
                           ms_per_step=1e3 * dt / TRAIN_STEPS))
        print(f"train epoch {e + 1}: loss={loss!r} s={dt!r} "
              f"triples_per_s={epochs[-1]['triples_per_s']!r} "
              f"ms_per_step={epochs[-1]['ms_per_step']!r}")
    launches = {"bpr_fwd": bpr.bpr_forward.launches,
                "bpr_bwd": bpr.bpr_backward.launches,
                "adam_sweep": adam.fused_adam_sweep.launches}  # main path ends here
    peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_EPOCHS * TRAIN_STEPS
    print(f"train main path: {launches} over {steps} steps; peak device memory "
          f"{peak / 2**30!r} GiB")
    want = {"bpr_fwd": steps, "bpr_bwd": steps, "adam_sweep": 3 * steps}
    if launches != want:
        fail(f"train main path launched {launches}, expected {want}")
    # the scaled arrays plant no structure that carries to the next epoch's
    # fresh users, so only finiteness is asked of these losses; the route
    # check above and the fit phase below check what is learnt
    if not np.isfinite([r["loss"] for r in epochs]).all():
        fail(f"train epoch losses not finite: {epochs}")

    # one profiler pass of 10 steps: device time by kernel, idle share
    triples = sample_triplets(200, *tabs, TRAIN_I, PROFILE_STEPS, TRAIN_B)
    step = make_fast_bprmf_step(model, TRAIN_LR, TRAIN_REG, fused_adam=True,
                                pallas_bpr=True)
    state, _ = step(state, tuple(t[0] for t in triples))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for s in range(PROFILE_STEPS):
            state, _ = step(state, tuple(t[s] for t in triples))
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    from torch.autograd import DeviceType

    ops = sorted(((dev_us(ev), ev.key, ev.count) for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA and dev_us(ev) > 0),
                 reverse=True)
    busy = sum(us for us, _, _ in ops)
    profile = dict(steps=PROFILE_STEPS, wall_ms_per_step=wall_us / 1e3 / PROFILE_STEPS,
                   device_ms_per_step=busy / 1e3 / PROFILE_STEPS,
                   device_ops_per_step=sum(c for _, _, c in ops) / PROFILE_STEPS,
                   idle_share=(1.0 - busy / wall_us) if busy else None)
    print(f"profile {PROFILE_STEPS} steps: wall_ms_per_step="
          f"{profile['wall_ms_per_step']!r} device_ms_per_step="
          f"{profile['device_ms_per_step']!r} device_ops_per_step="
          f"{profile['device_ops_per_step']!r} idle_share={profile['idle_share']!r}")
    if not ops:
        fail("profile: torch.profiler recorded no device time")
    for us, name, count in ops[:15]:
        print(f"  {us / 1e3 / PROFILE_STEPS:10.4f} ms/step  {count / PROFILE_STEPS:6.1f}"
              f" launches/step  {100.0 * us / busy:5.1f}%  {name[:90]}")
    del state, tabs, model, params, triples
    torch.cuda.empty_cache()
    return launches, dict(epochs=epochs, peak_gib=peak / 2**30, profile=profile,
                          route_max_abs_err=route_err, route_amplified=amplified)


def fit_phase(torch, np, bpr, adam):
    """The generic fit at the reference workload; it runs no kernel."""
    from fashionvisualexpl_tpu_torch.core.config import TrainConfig
    from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
    from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
    from fashionvisualexpl_tpu_torch.train.trainer import fit

    data = synthetic_interactions(REF_U, REF_I, interactions_per_user=REF_PER_USER,
                                  seed=0)
    model = BPRMF(REF_U, REF_I, embed_k=REF_K,
                  generator=torch.Generator(device="cuda").manual_seed(3))
    cfg = TrainConfig(batch_size=REF_B, epochs=REF_EPOCHS, lr=0.001, reg=0.001)
    before = (bpr.bpr_forward.launches, bpr.bpr_backward.launches,
              adam.fused_adam_sweep.launches)
    logs = []
    fit(model, data, cfg, log=logs.append)
    torch.cuda.synchronize()
    steps = data.steps_per_epoch(REF_B)
    for r in logs:
        print(f"fit epoch {r['epoch']}: loss={r['loss']!r} train_s={r['train_time_s']!r} "
              f"triples_per_s={steps * REF_B / r['train_time_s']!r}")
    losses = [r["loss"] for r in logs]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"fit epoch losses not finite and falling: {losses}")
    if (bpr.bpr_forward.launches, bpr.bpr_backward.launches,
            adam.fused_adam_sweep.launches) != before:
        fail("the generic fit launched a fast-path kernel")
    return [dict(loss=r["loss"], triples_per_s=steps * REF_B / r["train_time_s"])
            for r in logs]


def main() -> int:
    if not (PKG / "ops" / "csrc" / "segmax.cu").is_file():
        print("chip_smoke: run from a checkout of the repository "
              "(fashionvisualexpl_tpu_torch/ not found)", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from fashionvisualexpl_tpu_torch.ops import adam, bpr, cuda_build, segmax

    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    sources = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    cuda_build.build(sources)
    print(f"kernel build ({', '.join(sources)}): {time.perf_counter() - t0!r} s")
    for name, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  nvcc {name}: {line.strip()}")

    rows = kernel_phase(torch, segmax)
    serve, launches = serve_phase(torch, np, segmax)
    train_rows = train_kernel_phase(torch, bpr, adam)
    train_launches, train = train_phase(torch, np, bpr, adam)
    fitted = fit_phase(torch, np, bpr, adam)

    main_row = rows[4096]
    kernels = [{
        "name": "segmax_scores",
        "route": "cuda",
        "source": "fashionvisualexpl_tpu_torch/ops/csrc/segmax.cu",
        "replaces": "fashionvisualexpl_tpu/ops/segmax.py:34",
        "launches": launches,
        **main_row,
        "shape": f"B=4096 Ip={16 * ITEM_BLOCK} D={EMBED_K} seg={SEG} bf16",
        "at_B8": rows[8],
    }]
    for name, source, replaces in (
        ("bpr_fwd", "bpr.cu", "fashionvisualexpl_tpu/ops/bpr.py:36"),
        ("bpr_bwd", "bpr.cu", "fashionvisualexpl_tpu/ops/bpr.py:53"),
        ("adam_sweep", "adam.cu", "fashionvisualexpl_tpu/ops/adam.py:28"),
    ):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"fashionvisualexpl_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": train_launches[name],
            **train_rows[name],
        })
    print(json.dumps({"serve": {str(b): r for b, r in serve.items()}}))
    print(json.dumps({"train": train, "fit": fitted}))
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
