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
3. kernel: ``segmax_scores`` (the CUDA kernel: tensor cores for bf16)
   against its plain PyTorch version on the card over many geometries
   (seg 8 ... 1024, B not a multiple of 8 or 16, D = 16, 33, 64, 128, both
   dtypes), then its time, the plain
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
   shapes (K1's forward on both of its routes, float4 loads and scalar
   loads of misaligned rows, two runs bit-equal, one kernel a call, with
   the route and tile it took), then their times, the plain versions'
   times, the library call
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
   must be finite and falling;
9. eval kernel: the fused scoring + counts kernel (K2) against its plain
   PyTorch version (full fp32: no TF32) over many geometries on quantized
   data, where every score is exact in f32 and the counts must be
   bit-equal (users and items not tile multiples, T = 1 and 3, W = 1 and
   4 or more, -1 pads, duplicate ids, pad users and pad items); then its
   time, the plain version's time, one fp32 ``torch.matmul`` of the same
   product (a yardstick the port never calls) and the bound at the
   evaluator's shapes (B=4096, 500k items padded to 501,760, D=128, W from
   the evaluation data's banned sets); on Gaussian data, the size of the
   tie band: the items whose fp64 score lies within f32 rounding of the
   reference, the only ones where kernel and plain may differ; and the
   kernel's recheck band: its default counts bit-equal to those with
   ``_band_scale=inf`` (every pair through the exact f32 chain) on that
   Gaussian data and on cancelling rows, with the number of pairs the band
   sent to the exact chain, and equal to the exact counts on rows whose
   every coordinate is a worst case of the bf16 split (D = 1, 6, 16, 128);
10. eval: ``FactoredEvaluator(counts_impl="kernel").evaluate`` at the
   scaled evaluation configuration (BPRMF K=128, 1M users x 500k items, 20
   train + 1 validation + 1 test item per user, k=20, user_block 4096,
   quantized random weights), both splits: ms per split, user-item scores
   per second, peak memory; K2 must launch 2 * ceil(U / 4096) times; the
   first two user blocks of each split also run through the "bucketed"
   engine, and the per-user metrics must be equal;
11. cli: ``train_rec.train`` in process (``--rec bprmf --streaming_eval
   --embed_k 128 --epochs 2 --verbose 1``) on a reference-layout dataset
   written here (20k users x 20k items, 20 interactions per user), then
   ``serve_rec.serve`` from its checkpoint for 64 users: K2 and K3 must
   launch, the dumps hold U x k rows, the metrics are finite and in [0, 1].

12. tower kernel, AttentiveFashion training and path (K7): see PERF.md;
13. row kernels: the row gather (K4) and the row scatter-set (K5) against
   their plain versions, bit for bit (compared as int32), at the JAX test
   geometries (out-of-range, negative and internally padded ids) and at the
   packed rows' widths (385, 388, 257, 259, 193, 195, 512) for 8192 and
   16384 rows of a 1M-row table of random bit patterns; then timed at the
   JAX benches' shapes beside their bounds, plain versions and
   ``torch.index_select`` / ``Tensor.index_copy_``; ``bench_gather`` and
   ``bench_scatter`` once;
14. packed training: ``Trainer(train_path="packed")`` for BPRMF at the fast
   path's configuration (1M x 500k, K=128, batch 8192; fp32 moments,
   lazy_catchup).  3 steps on the card against the same 3 steps on CPU
   copies (the plain route), and again without catch-up and with bf16 and
   fp8 moments; one epoch of 200 steps (4 K4 + 2 K5 launches a step) with
   triples/s, ms per step and peak memory; a profile of 10 steps (K4's and
   K5's share of device time, the idle share).  AttentiveFashion at its
   training configuration (1M x 200k): 2 steps against the CPU route at
   batch 1024 (the CPU's plain tower at 8192 would take minutes), then 20
   steps at batch 8192 through K4, K5 and K7;
15. packed CLI: ``train_rec --train_path packed`` on the CLI dataset, then
   ``serve_rec`` from its checkpoint.

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
# evaluation configuration (the JAX package's scaled configuration with a
# leave-one-out split: 20 train + 1 validation + 1 test item per user)
EVAL_U, EVAL_I, EVAL_TRAIN, EVAL_K = 1_000_000, 500_000, 20, 20
EVAL_BLOCK, EVAL_TILE, EVAL_CHECK_BLOCKS = 4096, 2048, 2
# the CLI phase: a reference-layout dataset written by this script
CLI_U = CLI_I = 20_000
CLI_PER_USER, CLI_K, CLI_SERVE_USERS = 20, 20, 64
CLI_DIR = ROOT / "build" / "chip_smoke_cli"
# the edge-tower kernel K7: the JAX test geometries, two groups of
# channels, the training step's shape and the reference resolution (B, H,
# W, C; the last two are timed); constant images tie every pool window
# (0.5) and every ReLU boundary too (0.0)
TOWER_TIMED = ((8192, 32, 32, 64), (256, 224, 224, 64))
TOWER_GEOMS = ((5, 8, 16, 4), (8, 6, 10, 3), (3, 12, 8, 8), (4, 10, 12, 300)) + TOWER_TIMED
TOWER_TIES = ((4, 8, 12, 4, 0.5), (16, 32, 32, 64, 0.5), (16, 32, 32, 64, 0.0))
# edge maps as the model's stack holds them (data/pipeline.py: tiff / 255):
# k/255, mostly zero, so zero regions tie every window at pre = bias
TOWER_EDGES = ((64, 32, 32, 64), (2, 224, 224, 64))
# the forward on worst-case splits (every pixel and weight drops about the
# most its bf16 pieces can, all terms of one sign) at the training shape
TOWER_WORST = (8192, 32, 32, 64)
# the forward kernel's wgmma k16 steps per 64 channels and 64 conv pixels
# (csrc/edge_tower.cu: hi x hi in 2, the five cross products in 10)
FWD_K16_STEPS = 12
# the float64 witness: edge maps at the training step's batch, where the
# backward and its plain version (cuDNN's f32 conv) may decide near ties
# differently; a float64 conv decides them (seeds of the edge maps)
TOWER_WITNESS, TOWER_WITNESS_SEEDS, TOWER_WITNESS_CHUNK = (8192, 32, 32, 64), (0, 1), 1024
# kernel vs plain version: the forward sums 25 taps and (H/2)(W/2) pooled
# values in another order (rtol 1e-5, atol 1e-6).  A gradient sums g * x
# over every image and pooled pixel: its rounding grows with the sum of
# |terms| S (the plain backward of |dout|; the images are >= 0), so
# atol = 1e-5 + 1e-6 * S (about 8 f32 ulps of S), rtol 1e-4
TOWER_RTOL, TOWER_ATOL = 1e-5, 1e-6
TOWER_GRAD_RTOL, TOWER_GRAD_ATOL, TOWER_SUM_ATOL = 1e-4, 1e-5, 1e-6
# AttentiveFashion training: the JAX package's scaled configuration for the
# model (scripts/scaled_bench.py:158-176): 1M users x 200k items, 20
# positives a user, 32x32 edges, K=128, hidden 256, 64 filters, attention
# (64, 1), dropout 0.5, batch 8192, f32; cut only in depth (steps)
AF_U, AF_I, AF_POS, AF_HW, AF_B = 1_000_000, 200_000, 20, 32, 8192
AF_ROUTE_STEPS, AF_STEPS, AF_PROFILE_STEPS = 3, 50, 5
AF_LR, AF_REG = 0.001, 0.001
AF_ROUTE_DRIFT = 2 * AF_LR * AF_ROUTE_STEPS
# the AttentiveFashion path through the CLI: the CLI phase's dataset with
# color histograms, class one-hots and 32x32 edge tiffs
AF_CLI_CLASSES, AF_CLI_BATCH_EVAL, AF_SERVE_BUCKETS = 10, 128, (8, 64, 1024)
# the row kernels K4 and K5: the packed rows' widths (fp32 / bf16 / fp8
# moments at K=128, users then items; 512 a 128-aligned row) at the packed
# step's unique-row counts over a 1M-row table; timed at the JAX benches'
# shapes (rows, width, batch)
ROW_WIDTHS, ROW_TABLE, ROW_BATCHES = (385, 388, 257, 259, 193, 195, 512), 1_000_000, (8192, 16384)
GATHER_SHAPE, SCATTER_SHAPE = (1_000_000, 128, 24576), (1_000_000, 384, 24576)
# packed training: the fast path's BPRMF configuration (scripts/scaled_bench.py
# --packed --packed_engine generic), one epoch cut to 200 steps; the
# AttentiveFashion configuration above.  Route checks: 3 (BPRMF) and 2
# (AttentiveFashion, batch 1024) steps on the card against CPU copies
PACKED_ROUTE_STEPS, PACKED_STEPS, PACKED_PROFILE_STEPS = 3, 200, 10
AF_PACKED_ROUTE_STEPS, AF_PACKED_ROUTE_B, AF_PACKED_STEPS = 2, 1024, 20
# the packed route: the card sums the forward's dot products and a row's
# gradients in another order than the CPU.  So a stored bf16 or e5m2
# moment at a rounding boundary may land one code apart (2**-7 of the
# value for bf16, 2**-2 for e5m2, whose v is stored as sqrt(v)), and a
# param whose gradient nearly cancels (an item drawn as a positive and as
# a negative in one batch: its bias gradient is a difference of two
# sigmoids) may take a visibly different Adam step: at most a 1e-3 share
# of the touched values may do either, moments within one code, params
# within the drift of 2 lr a step.  Below that, the route tolerances
# (rtol 2e-4, atol 1e-6) and, for stored moments, those of
# tests/test_moment_dtype.py: rtol 1/256 (bf16), 0.13 (fp8) on m, sqrt(v)
PACKED_FLIP_CAP = 1e-3
# the packed CLI run: the CLI dataset at batch 1024 (the packed step is
# host-bound at ~13 ms; at the default 256 the run would take ~40 s)
PACKED_CLI_B = 1024
MOMENT_RTOL = {"float32": ROUTE_RTOL, "bfloat16": 1 / 256, "float8": 0.13}
MOMENT_CODE = {"float32": 0.0, "bfloat16": 2.0**-7, "float8": 2.0**-2}


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
        checked.append(label)
        return worst

    checked = []
    t0 = time.perf_counter()
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
    # the tensor-core kernel's other paths: seg a multiple of 16 only, seg
    # at and above the block's item tile up to the whole catalog (as
    # RecServer may pass), for B <= 64 (register kernel) and B > 64
    # (warpgroup kernel), B not a multiple of 8 or 16, D = 64 (registers,
    # zero-padded to 128) and D not a multiple of 8 (shared memory, 2-byte
    # staging)
    for dtype in (torch.bfloat16, torch.float32):
        for seg in (16, 64, 128, 1024, 65536):
            for B in (8, 100):
                check(f"seg={seg} D=128 B={B} {names[dtype]} Ip=65536",
                      *inputs(B, 65536, 128, dtype), seg)
        for B, D in ((4097, 128), (4097, 64), (100, 64), (100, 33)):
            Ip = 32 * 1001
            check(f"seg=32 D={D} B={B} {names[dtype]} Ip={Ip} pads=500",
                  *inputs(B, Ip, D, dtype, n_pad=500), 32)
    print(f"segmax checks: {len(checked)} geometries in {time.perf_counter() - t0!r} s")

    # times at the serving shapes: 1M items padded to the 65536 block
    Ip, D = 16 * ITEM_BLOCK, EMBED_K
    rows = {}
    for B, iters in ((8, 200), (4096, 20)):
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


PROFILE_ATTEMPTS = 5
LEAD_KERNELS = 1024
_FLUSH_NAMES: set = set()


def lead_in(torch, flush, gen) -> None:
    """LEAD_KERNELS small flushes (the same kernel as a flush) at the start
    of a profile.  Profiles on an H100 lost the records of their first
    kernels (7 in each profile of the tower phase, up to 260 in others,
    whatever the idle time before them); these take that loss."""
    for _ in range(LEAD_KERNELS):
        flush[:1].uniform_(generator=gen)
    torch.cuda.synchronize()


def device_events(torch, prof):
    """The profile's device kernels as (name, us), in the order they ran."""
    from torch.autograd import DeviceType

    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in evs]


def flush_names(torch, flush, gen):
    """The kernels that ``flush.uniform_`` launches, read from a profile of
    it alone.  No timed function draws random numbers, so these names mark
    the flushes in a profile."""
    for _ in range(PROFILE_ATTEMPTS):
        if _FLUSH_NAMES:
            break
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            lead_in(torch, flush, gen)
            flush.uniform_(generator=gen)
            torch.cuda.synchronize()
        _FLUSH_NAMES.update(name for name, _ in device_events(torch, prof))
    if not _FLUSH_NAMES:
        fail("torch.profiler recorded no kernel of the L2 flush")
    return _FLUSH_NAMES


def kernel_times(torch, label, fn, iters: int, flush):
    """(ms, call_ms, kernels) per call of fn, with the L2 emptied before each call
    by a random fill of ``flush`` (a buffer larger than the 50 MB L2) that
    neither time counts, so that fn's inputs come from device memory.

    ``ms``: the summed durations of one call's kernels from torch.profiler,
    launch gaps left out, averaged over the calls recorded whole.  The
    profiler can lose kernel records (see ``lead_in``).  So the profile is
    cut at the flushes into calls, and only the calls whose kernels (names
    and numbers) match those of most calls count; a profile where fewer
    than a majority of the calls match is taken again,
    at most PROFILE_ATTEMPTS times.  ``call_ms``: CUDA events around each
    call, which also holds the host's launch cost when the kernels are
    shorter than it.  ``kernels``: each kernel a whole call launched, by
    name, as (launches a call, mean ms a call)."""
    from collections import Counter

    gen = torch.Generator(device=flush.device).manual_seed(0)
    marker = flush_names(torch, flush, gen)
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        marks = []
        with torch.profiler.profile(activities=acts) as prof:
            lead_in(torch, flush, gen)
            for _ in range(iters):
                flush.uniform_(generator=gen)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                marks.append((start, end))
            torch.cuda.synchronize()
        call_ms = sum(s.elapsed_time(e) for s, e in marks) / iters
        calls, cur = [], []
        events = device_events(torch, prof)
        for name, us in events:
            if name not in marker:
                cur.append((name, us))
            elif cur:
                calls.append(cur)
                cur = []
        if cur:
            calls.append(cur)
        kinds = [tuple(sorted(Counter(n for n, _ in c).items())) for c in calls]
        kind, whole = Counter(kinds).most_common(1)[0] if kinds else ((), 0)
        if whole < iters:
            lost = LEAD_KERNELS + iters * (1 + sum(n for _, n in kind)) - len(events)
            letters = {}
            order = "".join("|" if n in marker else letters.setdefault(
                n, chr(ord("a") + len(letters) % 26)) for n, _ in events[-80:])
            print(f"{label}: profile {attempt} recorded {whole} of {iters} calls "
                  f"whole, {lost} records missing (flushes |, the last kernels in "
                  f"the order they ran: {order}; "
                  f"{ {c: n[:48] for n, c in letters.items()} })")
        if 2 * whole > iters:
            per_name = Counter()
            for c, k in zip(calls, kinds):
                if k == kind:
                    for name, us in c:
                        per_name[name] += us
            kernels = {n: (dict(kind)[n], us / whole / 1e3) for n, us in per_name.items()}
            return sum(per_name.values()) / whole / 1e3, call_ms, kernels
    fail(f"{label}: torch.profiler lost kernel records in {PROFILE_ATTEMPTS} profiles")


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

    def bpr_inputs(B, K, scale, offset=0):
        # offset 1 starts each tensor one float into its storage: off the 16
        # bytes a float4 load needs, so the forward takes its plain route
        def t(shape, s):
            n = B * (K if len(shape) == 2 else 1)
            return (torch.randn(n + offset, device=dev, generator=g) * s)[offset:].view(shape)
        return [t((B, K), scale) for _ in range(3)] + [t((B,), 1.0) for _ in range(2)]

    def route_of(args):
        aligned = all(x.data_ptr() % 16 == 0 for x in args[:3])
        return bpr.fwd_tiles(*args[0].shape, aligned)

    # the step's geometries, the forward's edges (B around its tiles, K off
    # the float4 loads' 16 bytes, a wide K) and misaligned rows
    geoms = [(B, K, 0) for B in (1, 100, TRAIN_B) for K in (8, 64, EMBED_K)]
    geoms += [(33, 129, 0), (8193, 7, 0), (65537, 512, 0), (100, 64, 1),
              (TRAIN_B, EMBED_K, 1)]
    for B, K, offset in geoms:
        for scale in (1.0, 20.0):  # scale 20 pushes diff past the clip
            args = bpr_inputs(B, K, scale, offset)
            loss, sigma = bpr.bpr_forward(*args)
            grads = bpr.bpr_backward(sigma, *args[:3], one)
            loss2, sigma2 = bpr.bpr_forward(*args)
            torch.cuda.synchronize()
            want_loss, want_sigma = bpr.bpr_forward_reference(*args)
            want_grads = bpr.bpr_backward_reference(sigma, *args[:3], one)
            route, tile, blocks = route_of(args)
            label = f"B={B} K={K} scale={scale:g}{' misaligned' if offset else ''}"
            if not (torch.equal(loss.view(torch.int32), loss2.view(torch.int32))
                    and torch.equal(sigma.view(torch.int32), sigma2.view(torch.int32))):
                fail(f"bpr_fwd {label}: two runs differ in their bits")
            rel = abs(float(loss) - float(want_loss)) / max(abs(float(want_loss)), 1e-30)
            if rel > BPR_LOSS_RTOL:
                fail(f"bpr_fwd {label}: loss {float(loss)!r} vs plain "
                     f"{float(want_loss)!r}")
            e_f = worst(torch, f"bpr_fwd {label} sigma", sigma, want_sigma,
                        BPR_RTOL, BPR_ATOL * scale**2)
            e_b = max(worst(torch, f"bpr_bwd {label}", a, w, BPR_RTOL, BPR_ATOL)
                      for a, w in zip(grads, want_grads))
            clipped = int((sigma == 0).sum())
            print(f"kernel check bpr {label}: route={route} tile={tile} "
                  f"blocks={blocks} loss_rel_err={rel!r} "
                  f"sigma_max_abs_err={e_f!r} grads_max_abs_err={e_b!r} "
                  f"clipped={clipped}/{B} repeat bit-equal ok")
            loss_rel = max(loss_rel, rel)
            errs["bpr_fwd"] = max(errs["bpr_fwd"], e_f)
            errs["bpr_bwd"] = max(errs["bpr_bwd"], e_b)
            del args, grads, want_grads

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
        ms, call_ms, kernels = kernel_times(torch, name, run, 200, flush)
        plain_ms, plain_call_ms, _ = kernel_times(torch, f"{name} plain", plain, 200, flush)
        check_bound(name, ms, b)
        n_kernels = sum(n for n, _ in kernels.values())
        if n_kernels != 1:
            fail(f"{name}: one call launched {n_kernels} kernels: {kernels}")
        print(f"kernel launches {name}: one kernel a call "
              f"({next(iter(kernels))[:72]})")
        rows[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                          bound_ms=b, bound_by=by, library_ms=None,
                          call_ms=call_ms, plain_call_ms=plain_call_ms, shape=shape)
        print(f"kernel time {name} {shape}: ms={ms!r} call_ms={call_ms!r} "
              f"plain_ms={plain_ms!r} plain_call_ms={plain_call_ms!r} "
              f"bound_ms={b!r} ({by}) library_ms=None (no single PyTorch call "
              f"computes it)")
    rows["bpr_fwd"]["loss_max_rel_err"] = loss_rel
    route, tile, blocks = route_of(args)
    rows["bpr_fwd"].update(load_route=route, tile=tile)
    print(f"kernel route bpr_fwd {shape}: {route}, tile {tile} triples, "
          f"{blocks} blocks")
    # the forward as the step runs it: its rows just written (by the
    # gathers there, by copy_ here, whose kernels are not counted), so read
    # from the L2
    srcs = [x.clone() for x in args[:3]]
    _, _, kernels = kernel_times(
        torch, "bpr_fwd resident",
        lambda: ([x.copy_(s) for x, s in zip(args[:3], srcs)], bpr.bpr_forward(*args)),
        200, flush)
    resident_ms = sum(t for n, (_, t) in kernels.items() if "bpr_fwd" in n)
    rows["bpr_fwd"]["resident_ms"] = resident_ms
    print(f"kernel time bpr_fwd B={TRAIN_B} K={EMBED_K} f32, rows in L2: "
          f"ms={resident_ms!r}")
    del args, sigma, srcs

    tables = {}
    for name, shape in (("Gu", (TRAIN_U, EMBED_K)), ("Gi", (TRAIN_I, EMBED_K)),
                        ("Bi", (TRAIN_I,))):
        p, m, v = adam_state(shape)
        adam_check(f"{name} shape={shape}", p, m, v)
        gz = torch.zeros_like(p)
        step = torch.tensor(7.0, device=dev)
        b, by = adam_bound(p.numel())
        label = f"adam_sweep {name}"
        ms, call_ms, _ = kernel_times(torch, label, lambda: adam.fused_adam_sweep(
            p, m, v, scal), 20, flush)
        plain_ms, plain_call_ms, _ = kernel_times(
            torch, f"{label} plain", lambda: adam.fused_adam_sweep_reference(p, m, v, scal),
            10, flush)
        lib_ms, lib_call_ms, _ = kernel_times(
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


def make_eval_items(np, num_users, num_items, per_user, seed):
    """[U, per_user] int32: distinct uniform random items per user (rows
    with a repeat are drawn again)."""
    rng = np.random.default_rng(seed)
    items = rng.integers(0, num_items, (num_users, per_user))
    while True:
        s = np.sort(items, axis=1)
        dup = (s[:, 1:] == s[:, :-1]).any(axis=1)
        if not dup.any():
            return items.astype(np.int32)
        items[dup] = rng.integers(0, num_items, (int(dup.sum()), per_user))


def q64(x):
    """Onto the 1/64 grid within [-1, 1]: a product of two such values is a
    multiple of 2^-12 of magnitude <= 1, so a sum of up to 2^12 of them
    plus a bias is exact in f32 (24-bit significand) in any order."""
    return (x * 64).round().clamp(-64, 64) / 64


def counts_bound_ms(B: int, Ip: int, D: int, T: int, n_tiles: int, W: int):
    """K2 at [B, D] x [Ip, D]: each input read once (uf, iv, ib, ref, the
    banned offsets), the counts written once; 2*B*Ip*D operations for the
    product at the bf16 tensor-core rate, the least time the card needs for
    a product on its tensor cores, as for K3 (the kernel computes it in
    bf16x3 on the tensor cores; the compares are left out).  Until the
    kernel ran on the tensor cores the bound took the f32 CUDA-core rate."""
    bytes_ = 4 * (B * D + Ip * D + Ip + B * T + n_tiles * B * W + B * T)
    return bound_ms(bytes_, 2.0 * B * Ip * D, PEAK_BF16_FLOPS)


def eval_kernel_phase(torch, np, counts, topk, eval_items):
    """K2 against its plain version, then timed at the evaluator's shapes
    and its tie band measured on Gaussian data.  Returns the kernel row."""
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        fail("fp32 matmuls are not full fp32 (TF32 enabled): the plain version "
             "must compute as the kernel does")
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    g = torch.Generator(device=dev).manual_seed(9)

    def qrand(*shape, scale=0.25):
        return q64(torch.randn(*shape, device=dev, generator=g) * scale)

    def banned_ids(B, I, Pb, tile, wide):
        n_tiles = -(-I // tile)
        b = rng.integers(0, I, (B, Pb))
        if wide:  # four distinct ids of one tile, then -1 pads and duplicates
            t = rng.integers(0, n_tiles, B)
            span = np.minimum(tile, I - t * tile)
            start = (rng.random(B) * span).astype(int)
            b[:, :4] = t[:, None] * tile + (start[:, None] + np.arange(4)) % span[:, None]
            b[1::3, 5:] = -1
            b[2::3, 6] = b[2::3, 4]
        b[0] = -1
        return torch.from_numpy(b.astype(np.int32)).to(dev)

    def padded(uf, iv, ib, ref, banned, I, tile, W=None):
        W = W or topk.banned_bucket_width(banned.cpu().numpy(), I, tile)
        loc, msk = topk.bucket_banned_ids_device(banned, I, tile, W)
        *args, item_tile, ut = counts.pad_counts_inputs(uf, iv, ib, ref, loc, msk, tile)
        return args, item_tile, ut, W

    def check(label, args, item_tile, ut):
        got = counts.counts_kernel(*args, item_tile=item_tile, user_tile=ut)
        torch.cuda.synchronize()
        want = counts.counts_kernel_reference(*args, item_tile)
        if not torch.equal(got, want):
            bad = int((got != want).any(dim=1).sum())
            fail(f"counts kernel disagrees with its plain version at {label} "
                 f"({bad} users)")
        print(f"kernel check counts {label}: bit-equal ok "
              f"(counted {int(got.sum())})")
        errs.append(int((got - want).abs().max()))

    seen_w, errs = set(), []
    for B, I, D in ((100, 5000, 128), (300, 70_001, 33), (4096, 20_000, 128)):
        for T in (1, 3):
            for wide in (False, True):
                tile = 2048 if I > 5000 else 256
                banned = banned_ids(B, I, 8 if wide else 1, tile, wide)
                uf, iv, ib = qrand(B, D), qrand(I, D), qrand(I)
                ref = qrand(B, T, scale=1.0)
                args, item_tile, ut, W = padded(uf, iv, ib, ref, banned, I, tile)
                seen_w.add(W)
                check(f"B={B} I={I} D={D} T={T} W={W} tile={tile} "
                      f"(pads: users {args[0].shape[0] - B}, items {args[1].shape[0] - I})",
                      args, item_tile, ut)
    if 1 not in seen_w or max(seen_w) < 4:
        fail(f"counts checks covered W={sorted(seen_w)}, not 1 and 4 or more")

    # the evaluator's shapes: one 4096-user block of the test split, W the
    # probe's over every user's banned set (train + test item)
    I, D, B = EVAL_I, EMBED_K, EVAL_BLOCK
    shape = f"B={B} I={I} D={D} T=1 W={{}} f32, cold L2"
    test_banned = np.concatenate([eval_items[:, :EVAL_TRAIN], eval_items[:, -1:]], axis=1)
    W = topk.banned_bucket_width(test_banned, I, EVAL_TILE)
    shape = shape.format(W)
    banned = torch.from_numpy(test_banned[:B]).to(dev)
    uf, iv, ib = qrand(B, D), qrand(I, D), qrand(I)
    ref = torch.einsum("bd,bwd->bw", uf, iv[banned[:, -1:].long()]) + ib[banned[:, -1:].long()]
    args, item_tile, ut, _ = padded(uf, iv, ib, ref, banned, I, EVAL_TILE, W)
    check(f"evaluator shape B={B} I={I} D={D} T=1 W={W}", args, item_tile, ut)
    n_re = torch.zeros(1, dtype=torch.int64, device=dev)
    counts.counts_kernel(*args, item_tile=item_tile, user_tile=ut, _rechecked=n_re)
    rechecked = int(n_re)
    print(f"counts evaluator shape: {rechecked} of {B * args[1].shape[0]} pairs scored "
          f"again exactly (the band)")
    flush = torch.empty(64 * 2**20 // 4, device=dev)  # 64 MB > the 50 MB L2
    ms, call_ms, _ = kernel_times(torch, "counts", lambda: counts.counts_kernel(
        *args, item_tile=item_tile, user_tile=ut), 10, flush)
    plain_ms, _, _ = kernel_times(torch, "counts plain", lambda: counts.counts_kernel_reference(
        *args, item_tile), 5, flush)
    uf_p, iv_p = args[0], args[1]
    lib_ms, _, _ = kernel_times(torch, "counts library", lambda: torch.matmul(uf_p, iv_p.T),
                             5, flush)
    Ip = iv_p.shape[0]
    b, by = counts_bound_ms(B, Ip, D, 1, Ip // EVAL_TILE, W)
    check_bound("counts", ms, b)
    print(f"kernel time counts B={B} Ip={Ip} D={D} T=1 W={W} f32: ms={ms!r} "
          f"call_ms={call_ms!r} plain_ms={plain_ms!r} library_ms(matmul f32, product "
          f"only)={lib_ms!r} bound_ms={b!r} ({by}, bf16 tensor-core rate)")
    del args, uf, iv, ib, ref, uf_p, iv_p
    torch.cuda.empty_cache()

    # Gaussian data: kernel and plain may differ only inside the tie band
    B, I, D = 1024, 65_536, EMBED_K
    uf = torch.randn(B, D, device=dev, generator=g) * 0.3
    iv = torch.randn(I, D, device=dev, generator=g) * 0.3
    ib = torch.randn(I, device=dev, generator=g) * 0.1
    j = torch.from_numpy(rng.integers(0, I, B)).to(dev)
    ref = torch.einsum("bd,bd->b", uf, iv[j])[:, None] + ib[j][:, None]
    args, item_tile, ut, _ = padded(uf, iv, ib, ref, j[:, None].to(torch.int32), I, EVAL_TILE)
    got = counts.counts_kernel(*args, item_tile=item_tile, user_tile=ut)[:B, 0]
    want = counts.counts_kernel_reference(*args, item_tile)[:B, 0]
    s64 = uf.double() @ iv.double().T + ib.double()
    # f32 rounding of a D-term dot plus a bias, either summation order
    tol = 2 * D * 2.0**-24 * (uf.abs().double() @ iv.abs().double().T + ib.abs().double())
    gap = s64 - ref.double()
    rows = torch.arange(B, device=dev)
    band = gap.abs() <= tol
    band[rows, j] = False
    above = gap >= 0
    above[rows, j] = False
    band_u = band.sum(dim=1)
    d_plain = (got - want).abs()
    d_exact = (got - above.sum(dim=1)).abs()
    if bool((d_plain > band_u).any()) or bool((d_exact > band_u).any()):
        fail("counts kernel differs from the plain version or the fp64 count "
             "beyond the tie band on Gaussian data")
    tie = dict(users=B, items=I, band_items=int(band_u.sum()),
               band_users=int((band_u > 0).sum()),
               kernel_vs_plain=int(d_plain.sum()), kernel_vs_fp64=int(d_exact.sum()))
    print(f"tie band (Gaussian, B={B} I={I} D={D}): {tie}")
    del s64, tol, gap, band, above
    torch.cuda.empty_cache()

    # the recheck band: the default kernel and _band_scale=inf (every pair
    # through the exact fmaf chain) bit-equal on the Gaussian data above and
    # on cancelling rows (large +- terms, dot products near 0, refs on them)
    t0 = time.perf_counter()
    sign = torch.randint(0, 2, (B, 1), device=dev, generator=g) * 2.0 - 1
    big = torch.randn(I, 1, device=dev, generator=g) * 30
    uc = uf.clone()
    uc[:, : D // 2] += sign
    uc[:, D // 2:] -= sign
    vc = iv + big
    rc = torch.einsum("bd,bd->b", uc, vc[j])[:, None] + ib[j][:, None]
    cancel, _, _, _ = padded(uc, vc, ib, rc, j[:, None].to(torch.int32), I, EVAL_TILE)
    band_check = {}
    for label, a in (("gaussian", args), ("cancelling", cancel)):
        n_band = torch.zeros(1, dtype=torch.int64, device=dev)
        n_all = torch.zeros(1, dtype=torch.int64, device=dev)
        got = counts.counts_kernel(*a, item_tile=item_tile, user_tile=ut, _rechecked=n_band)
        every = counts.counts_kernel(*a, item_tile=item_tile, user_tile=ut,
                                     _band_scale=float("inf"), _rechecked=n_all)
        torch.cuda.synchronize()
        if not torch.equal(got, every):
            bad = int((got != every).any(dim=1).sum())
            fail(f"counts kernel with its band differs from the exact chain on {label} data "
                 f"({bad} users)")
        band_check[label] = dict(rechecked=int(n_band), exact_pairs=int(n_all),
                                 counted=int(got.sum()))
        print(f"counts band check ({label}, B={B} I={I} D={D}): default band and "
              f"_band_scale=inf bit-equal ok; {int(n_band)} of {int(n_all)} pairs "
              f"rechecked with the band")
    # rows whose every coordinate is a worst case of the bf16 split, refs
    # between the bf16x3 and the exact scores: the band must hold the miss
    for Dw in (1, 6, 16, 128):
        uw, vw, bw, rw, want = (x.to(dev) for x in counts.band_worst_case(Dw, seed=Dw))
        lw = torch.full((1, uw.shape[0], 1), -1, dtype=torch.int32, device=dev)
        n_band = torch.zeros(1, dtype=torch.int64, device=dev)
        got = counts.counts_kernel(uw, vw, bw, rw, lw, 128, 8, _rechecked=n_band)
        every = counts.counts_kernel(uw, vw, bw, rw, lw, 128, 8, _band_scale=float("inf"))
        torch.cuda.synchronize()
        if not (torch.equal(got, every) and torch.equal(got, want)):
            fail(f"counts kernel miscounts the worst-case split rows at D={Dw}")
        band_check[f"worst_split_D{Dw}"] = dict(rechecked=int(n_band),
                                                exact_pairs=int(uw.shape[0] * vw.shape[0]),
                                                counted=int(got.sum()))
        print(f"counts band check (worst-case split, B={uw.shape[0]} I={vw.shape[0]} D={Dw}): "
              f"default band, _band_scale=inf and the exact counts equal ok; "
              f"{int(n_band)} pairs rechecked")
    print(f"counts band checks: {time.perf_counter() - t0!r} s")
    del args, cancel, uc, vc, uf, iv
    torch.cuda.empty_cache()
    return dict(max_abs_err=float(max(errs)), ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=lib_ms, call_ms=call_ms,
                rechecked=rechecked, tie_band=tie, band_check=band_check, shape=shape)


def quantized_bprmf(torch, num_users, num_items, seed):
    """BPRMF K=128 on the card with every weight on the 1/64 grid, so that
    every score is exact in f32 and the counts engines agree to the bit."""
    from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF

    g = torch.Generator(device="cuda").manual_seed(seed)
    model = BPRMF(num_users, num_items, embed_k=EMBED_K, generator=g)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(q64(torch.randn(p.shape, device="cuda", generator=g) * 0.25))
    return model


def eval_phase(torch, np, counts, eval_items):
    """The streaming evaluator through K2 at the scaled configuration."""
    from fashionvisualexpl_tpu_torch.data.interactions import Interactions
    from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator

    t0 = time.perf_counter()
    data = Interactions.from_lists(eval_items[:, :EVAL_TRAIN].tolist(),
                                   eval_items[:, -1:].tolist(), EVAL_I,
                                   eval_items[:, EVAL_TRAIN:-1].tolist())
    host_s = time.perf_counter() - t0
    model = quantized_bprmf(torch, EVAL_U, EVAL_I, seed=10)
    t0 = time.perf_counter()
    ev = FactoredEvaluator(model, data, k=EVAL_K, user_block=EVAL_BLOCK,
                           counts_impl="kernel")
    setup_s = time.perf_counter() - t0
    print(f"eval setup: Interactions {host_s!r} s, FactoredEvaluator {setup_s!r} s "
          f"(bucket widths {ev._bucket_w})")

    split_s = {}
    inner = ev._eval_split

    def timed(split, *a):  # per-split wall time, ended by reading the mean
        t = time.perf_counter()
        out = inner(split, *a)
        float(out.hr)
        split_s[split] = time.perf_counter() - t
        return out

    ev._eval_split = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.counts_kernel.launches = 0  # main path starts here
    t0 = time.perf_counter()
    metrics = ev.evaluate(None, None)
    total_s = time.perf_counter() - t0
    launches = counts.counts_kernel.launches  # main path ends here
    peak = torch.cuda.max_memory_allocated()
    want = 2 * -(-EVAL_U // EVAL_BLOCK)
    if launches != want:
        fail(f"evaluate launched the counts kernel {launches} times, expected {want}")
    vals = np.array(list(metrics.values()))
    if not (np.isfinite(vals).all() and (vals >= 0).all() and (vals <= 1).all()):
        fail(f"eval metrics not finite in [0, 1]: {metrics}")
    per_split = {s: dict(ms=1e3 * t, scores_per_s=EVAL_U * EVAL_I / t)
                 for s, t in split_s.items()}
    print(f"eval main path: {launches} counts launches; evaluate {total_s!r} s; "
          f"per split {per_split}; peak device memory {peak / 2**30!r} GiB")
    print(f"eval metrics: {metrics}")

    # the first user blocks again through the bucketed engine: equal metrics
    evb = FactoredEvaluator(model, data, k=EVAL_K, user_block=EVAL_BLOCK,
                            counts_impl="bucketed")
    uf, iv, ib = ev._factors(None)
    for split in ("val", "test"):
        for blk in range(EVAL_CHECK_BLOCKS):
            ids = torch.arange(blk * EVAL_BLOCK, (blk + 1) * EVAL_BLOCK, device="cuda")
            mk = ev._eval_block(split, uf[ids], iv, ib, ids)
            mb = evb._eval_block(split, uf[ids], iv, ib, ids)
            if not all(torch.equal(a, b) for a, b in zip(mk, mb)):
                fail(f"eval {split} block {blk}: kernel and bucketed metrics differ")
    print(f"eval check: the first {EVAL_CHECK_BLOCKS} user blocks of each split "
          f"give equal per-user metrics through the kernel and the bucketed engine")
    del ev, evb, model, data, uf, iv, ib
    torch.cuda.empty_cache()
    return launches, dict(metrics=metrics, per_split=per_split, evaluate_s=total_s,
                          peak_gib=peak / 2**30, host_s=host_s, setup_s=setup_s)


def write_reference_dataset(np, d: Path):
    """Split TSVs (``user\\titem\\t0\\t1.0``) and the stats file in the
    reference's layout: per user CLI_PER_USER distinct random items, the
    last one the test item, the one before it the validation item."""
    items = make_eval_items(np, CLI_U, CLI_I, CLI_PER_USER, seed=11)
    d.mkdir(parents=True, exist_ok=True)
    (d / "stats_after_downloading").write_text(
        f"dataset stats\n----\nusers: {CLI_U}\nitems: {CLI_I}\n")
    for fname, cols in (("trainingset.tsv", slice(0, -2)),
                        ("validationset.tsv", slice(-2, -1)),
                        ("testset.tsv", slice(-1, None))):
        part = items[:, cols]
        users = np.repeat(np.arange(CLI_U), part.shape[1])
        (d / fname).write_text("".join(
            f"{u}\t{i}\t0\t1.0\n" for u, i in zip(users, part.reshape(-1))))


def cli_phase(torch, np, counts, segmax):
    """train_rec --rec bprmf --streaming_eval, then serve_rec from its
    checkpoint, in process."""
    import glob
    import pickle
    import shutil

    from fashionvisualexpl_tpu_torch.cli.serve_rec import serve
    from fashionvisualexpl_tpu_torch.cli.train_rec import train

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    write_reference_dataset(np, CLI_DIR / "cli")
    write_s = time.perf_counter() - t0
    results = CLI_DIR / "results"
    common = ["--rec", "bprmf", "--dataset", "cli", "--data_root", str(CLI_DIR),
              "--results_root", str(results), "--embed_k", str(EMBED_K),
              "--top_k", str(CLI_K)]
    served = CLI_DIR / "served.tsv"
    users = ",".join(str(u * (CLI_U // CLI_SERVE_USERS)) for u in range(CLI_SERVE_USERS))
    counts.counts_kernel.launches = 0
    segmax.segmax_scores.launches = 0  # main path starts here
    t0 = time.perf_counter()
    train(common + ["--streaming_eval", "--epochs", "2", "--verbose", "1"])
    train_s = time.perf_counter() - t0
    (ckpt,) = glob.glob(str(results / "rec_model_weights" / "cli" / "bprmf" / "ckpt-*"))
    t0 = time.perf_counter()
    serve(common + ["--ckpt", ckpt, "--users", users, "--output", str(served)])
    serve_s = time.perf_counter() - t0
    launches = {"counts": counts.counts_kernel.launches,
                "segmax_scores": segmax.segmax_scores.launches}  # main path ends here
    if not all(launches.values()):
        fail(f"the CLI did not launch every kernel of its path: {launches}")
    rdir = results / "rec_results" / "cli" / "bprmf"
    rows = {}
    for pattern in ("recs-2-*.tsv", "best-recs-*.tsv"):
        (path,) = glob.glob(str(rdir / pattern))
        with open(path) as f:
            rows[pattern] = sum(1 for _ in f)
        if rows[pattern] != CLI_U * CLI_K:
            fail(f"{pattern}: {rows[pattern]} rows, expected {CLI_U * CLI_K}")
    with open(served) as f:
        n_served = sum(1 for _ in f)
    if n_served != CLI_SERVE_USERS * CLI_K:
        fail(f"serve_rec wrote {n_served} rows, expected {CLI_SERVE_USERS * CLI_K}")
    (pkl,) = glob.glob(str(rdir / "results-metrics-*.pkl"))
    with open(pkl, "rb") as f:
        per_epoch = pickle.load(f)
    vals = np.array([v for m in per_epoch.values() for v in m.values()])
    if sorted(per_epoch) != [1, 2] or not (
            np.isfinite(vals).all() and (vals >= 0).all() and (vals <= 1).all()):
        fail(f"CLI metrics not finite in [0, 1] for epochs 1, 2: {per_epoch}")
    print(f"cli: dataset write {write_s!r} s, train_rec {train_s!r} s, serve_rec "
          f"{serve_s!r} s; launches {launches}; rows {rows}, served {n_served}")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    return launches, dict(write_s=write_s, train_s=train_s, serve_s=serve_s,
                          metrics=per_epoch[2])


def tower_taps(torch, n: int, device):
    """[n]: the taps of a 5-wide SAME window that fall inside a line of n
    pixels, at each position (5n - 6 in all for n >= 4)."""
    pos = torch.arange(n, device=device)
    return sum(((pos + k - 2 >= 0) & (pos + k - 2 < n)).long() for k in range(5))


def tower_fwd_issued(E, B, H, W, C):
    """Tensor-core operations the forward kernel issues: FWD_K16_STEPS
    products of 64 channels x 64 conv pixels x 16 a step, for every group
    of 64 channels and every N tile of 16 pooled columns of a pooled row
    (``E.fwd_tiles``: a tile's ragged last N tile counts whole)."""
    _, cw, _ = E.fwd_tiles(H, W)
    wp = W // 2
    chunks = sum(-(-min(cw, wp - q) // E.FWD_CHUNK) for q in range(0, wp, cw))
    n_tiles = B * (H // 2) * chunks
    return 2.0 * 64 * -(-C // 64) * 64 * 16 * FWD_K16_STEPS * n_tiles


def tower_bounds(torch, E, x, w, b):
    """K7's forward and backward bounds on this run's inputs: images x
    [B, H, W, 1], filters w [5, 5, 1, C], bias b [C].  The conv: one FMA (2
    operations) for each tap inside the image at every conv output,
    (5H-6)(5W-6) per channel and image.  The forward runs it on the tensor
    cores, at the bf16 rate (K2's convention since the tensor cores took
    its product).  The backward recomputes it at the f32 CUDA-core rate;
    its tap sums run on the tensor cores: one FMA for each tap inside the
    image of each pooled pixel's winning conv output where its
    pre-activation is > 0 (dW), and one there (db), each as three bf16
    products (the image's exact split), at the bf16 rate; the two units
    run side by side, so the backward's bound is the larger of the two
    times.  ``f32``: each bound with every operation at the f32 rate (the
    backward: one FMA per dW tap, one add per db), the convention before.
    The winners are found by the kernel's tie rule on the plain conv's
    values.  Bytes: the images, weights and bias read once, [B, C] written
    (forward) or read (backward), dW and db written.  Returns (fwd, bwd,
    fwd at f32, bwd at f32)."""
    B, H, W, _ = x.shape
    C = w.shape[3]
    th, tw = tower_taps(torch, H, x.device), tower_taps(torch, W, x.device)
    conv = 2.0 * B * C * int(th.sum()) * int(tw.sum())
    with E.fp32_convs():
        z = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                       padding=2)  # [B, C, H, W], pre-bias
    even = z[..., 0::2] >= z[..., 1::2]  # the even column wins ties
    zh = torch.where(even, z[..., 0::2], z[..., 1::2])
    del z
    bias = b[None, :, None, None]
    top = torch.relu(zh[:, :, 0::2] + bias) >= torch.relu(zh[:, :, 1::2] + bias)
    live = torch.where(top, zh[:, :, 0::2], zh[:, :, 1::2]) + bias > 0
    col_even = torch.where(top, even[:, :, 0::2], even[:, :, 1::2])
    del zh, even
    taps = (torch.where(top, th[0::2, None], th[1::2, None])
            * torch.where(col_even, tw[0::2], tw[1::2]))
    dw_fmas = int(torch.where(live, taps, 0).sum())
    n_live = int(live.sum())
    del top, live, col_even, taps
    params = 4 * 26 * C
    fwd_bytes = 4 * B * H * W + params + 4 * B * C
    fwd = bound_ms(fwd_bytes, conv, PEAK_BF16_FLOPS)
    fwd_f32 = bound_ms(fwd_bytes, conv, PEAK_F32_FLOPS)
    bwd_bytes = 4 * B * H * W + params + 4 * B * C + params
    tc = bound_ms(bwd_bytes, 3 * 2.0 * (dw_fmas + n_live), PEAK_BF16_FLOPS)
    cuda_cores = bound_ms(bwd_bytes, conv, PEAK_F32_FLOPS)
    bwd = max(tc, cuda_cores)
    bwd_f32 = bound_ms(bwd_bytes, conv + 2.0 * dw_fmas + n_live, PEAK_F32_FLOPS)
    return fwd, bwd, fwd_f32, bwd_f32


def tower_winners(torch, z, b):
    """[B, C, H, W] bool from pre-bias conv values z [B, C, H, W]: the
    winning pixel of each 2x2 window whose pre-activation is > 0, by the
    kernel's tie rule (even column on z, top row on ReLU(z + b))."""
    even = z[..., 0::2] >= z[..., 1::2]
    zh = torch.where(even, z[..., 0::2], z[..., 1::2])
    bias = b[None, :, None, None]
    pre_t, pre_b = zh[:, :, 0::2] + bias, zh[:, :, 1::2] + bias
    top = torch.relu(pre_t) >= torch.relu(pre_b)
    live = torch.where(top, pre_t, pre_b) > 0
    m = torch.zeros_like(z, dtype=torch.bool)
    for dy, row in ((0, top), (1, ~top)):
        win_even = even[:, :, dy::2]
        m[:, :, dy::2, 0::2] = live & row & win_even
        m[:, :, dy::2, 1::2] = live & row & ~win_even
    return m


def tower_f64_witness(torch, E, seed):
    """Edge maps at TOWER_WITNESS: which pool windows' winners the kernel's
    f32 chain and cuDNN's f32 conv decide unlike a float64 conv, and each
    gradient's excess over the check's tolerance against the gradient of the
    float64 decisions (summed in float64).  The kernel's decisions come from
    its conv2x2 chain replayed here: fmaf(w, x, z) over the taps in its
    order, each product exact in float64 and the sum rounded to f32.  Prints
    the readings; fails if a gradient is not finite or if the kernel's
    leaves the tolerance against the gradient of its replayed decisions."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    B, H, W, C = TOWER_WITNESS
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randint(1, 256, (B, H, W, 1), device=dev, generator=g)
    keep = torch.rand(B, H, W, 1, device=dev, generator=g) < 0.15
    x = torch.where(keep, k, 0).float() / 255
    w = torch.randn(5, 5, 1, C, device=dev, generator=g) * 0.1
    b = torch.randn(C, device=dev, generator=g) * 0.1
    dout = torch.randn(B, C, device=dev, generator=g)
    got = E.edge_tower_bwd(x, w, b, dout)
    plain = E.edge_tower_gap_plain_backward(x, w, b, dout)
    wt = w.reshape(25, C)
    flips = {"kernel/f64": 0, "cudnn/f64": 0, "kernel/cudnn": 0}
    sums = {key: torch.zeros(26, C, dtype=torch.float64, device=dev)
            for key in ("f64", "f64_abs", "kernel_replay")}
    for lo in range(0, B, TOWER_WITNESS_CHUNK):
        xs = x[lo:lo + TOWER_WITNESS_CHUNK].permute(0, 3, 1, 2)  # [n, 1, H, W]
        n = xs.shape[0]
        cols = F.unfold(xs.double(), 5, padding=2)  # [n, 25, H*W], exact
        z64 = torch.einsum("jc,njp->ncp", wt.double(), cols).reshape(n, C, H, W)
        with E.fp32_convs():
            z_cudnn = F.conv2d(xs, w.permute(3, 2, 0, 1), padding=2)
        xp = F.pad(xs, (2, 2, 2, 2))
        z_k = torch.zeros(n, C, H, W, device=dev)
        for j in range(25):
            ky, kx = divmod(j, 5)
            prod = wt[j].double()[None, :, None, None] * xp[:, :, ky:ky + H, kx:kx + W].double()
            z_k = (prod + z_k.double()).float()
        masks = {"f64": tower_winners(torch, z64, b.double()),
                 "cudnn": tower_winners(torch, z_cudnn, b),
                 "kernel": tower_winners(torch, z_k, b)}
        del z64, z_cudnn, z_k, prod, xp
        windows = {key: m.reshape(n, C, H // 2, 2, W // 2, 2) for key, m in masks.items()}
        for pair in flips:
            u, v = pair.split("/")
            flips[pair] += int((windows[u] != windows[v]).any(dim=(3, 5)).sum())
        cols = torch.cat([cols, torch.ones_like(cols[:, :1])], dim=1).transpose(1, 2)
        gs = dout[lo:lo + n].double() / ((H // 2) * (W // 2))
        for key, m, gg in (("f64", masks["f64"], gs), ("f64_abs", masks["f64"], gs.abs()),
                           ("kernel_replay", masks["kernel"], gs)):
            taps = torch.bmm(m.reshape(n, C, H * W).double(), cols)  # [n, C, 26]
            sums[key] += torch.einsum("nc,ncj->jc", gg, taps)
        del masks, windows, cols, taps
    ref, s = sums["f64"], sums["f64_abs"]
    tol = TOWER_GRAD_RTOL * ref.abs() + TOWER_GRAD_ATOL + TOWER_SUM_ATOL * s

    def flat(dw, db):
        return torch.cat([dw.reshape(25, C), db[None]]).double()

    kernel, cudnn = flat(*got), flat(*plain)
    if not bool(torch.isfinite(kernel).all() and torch.isfinite(cudnn).all()):
        fail(f"tower witness seed {seed}: non-finite gradient")
    readings = {name: float(((v - r).abs() - tol).max()) for name, v, r in (
        ("kernel-f64", kernel, ref), ("cudnn-f64", cudnn, ref), ("kernel-cudnn", kernel, cudnn),
        ("kernel-replay", kernel, sums["kernel_replay"]))}
    print(f"tower witness B={B} H={H} W={W} C={C} edge maps seed {seed}: windows whose "
          f"winner differs {flips} of {B * C * (H // 2) * (W // 2)}; max excess of "
          f"|a - b| over the check's tolerance (<= 0 passes) {readings}; "
          f"{time.perf_counter() - t0!r} s")
    if readings["kernel-replay"] > 0:
        fail(f"tower witness seed {seed}: the backward leaves the tolerance against "
             f"its own replayed decisions ({readings['kernel-replay']!r})")
    return flips, readings


def tower_kernel_phase(torch, E):
    """K7 forward and backward against their plain versions over the
    geometries and ties, two backward runs bit-equal, then timed at the
    training step's shape and the reference resolution."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    errs = {"edge_tower_fwd": 0.0, "edge_tower_bwd": 0.0}

    def inputs(B, H, W, C, value=None, edges=False):
        if value is not None:
            x = torch.full((B, H, W, 1), value, device=dev)
        elif edges:
            k = torch.randint(1, 256, (B, H, W, 1), device=dev, generator=g)
            keep = torch.rand(B, H, W, 1, device=dev, generator=g) < 0.15
            x = torch.where(keep, k, 0).float() / 255
        else:
            x = torch.rand(B, H, W, 1, device=dev, generator=g)
        w = torch.randn(5, 5, 1, C, device=dev, generator=g) * 0.1
        b = torch.randn(C, device=dev, generator=g) * 0.1
        dout = torch.randn(B, C, device=dev, generator=g)
        return x, w, b, dout

    def check_fwd(label, x, w, b):
        out = E.edge_tower_fwd(x, w, b)
        out2 = E.edge_tower_fwd(x, w, b)
        torch.cuda.synchronize()
        e_f = worst(torch, f"edge_tower_fwd {label}", out, E.edge_tower_gap_plain(x, w, b),
                    TOWER_RTOL, TOWER_ATOL)
        if not torch.equal(out, out2):
            fail(f"edge_tower_fwd {label}: two runs differ")
        errs["edge_tower_fwd"] = max(errs["edge_tower_fwd"], e_f)
        return e_f

    def check(label, x, w, b, dout):
        e_f = check_fwd(label, x, w, b)
        dw, db = E.edge_tower_bwd(x, w, b, dout)
        dw2, db2 = E.edge_tower_bwd(x, w, b, dout)
        torch.cuda.synchronize()
        want = E.edge_tower_gap_plain_backward(x, w, b, dout)
        sums = E.edge_tower_gap_plain_backward(x, w, b, dout.abs())
        e_b = 0.0
        for name, got, ref, s in zip(("dconv_w", "dconv_b"), (dw, db), want, sums):
            e_b = max(e_b, worst(torch, f"edge_tower_bwd {label} {name}", got, ref,
                                 TOWER_GRAD_RTOL, TOWER_GRAD_ATOL + TOWER_SUM_ATOL * s))
        if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
            fail(f"edge_tower_bwd {label}: two runs differ")
        print(f"kernel check edge_tower {label}: fwd max_abs_err={e_f!r} bwd max_abs_err="
              f"{e_b!r} (max |dW| {float(want[0].abs().max())!r}); two forward and two "
              f"backward runs bit-equal ok")
        errs["edge_tower_bwd"] = max(errs["edge_tower_bwd"], e_b)

    for B, H, W, C in TOWER_GEOMS:
        check(f"B={B} H={H} W={W} C={C}", *inputs(B, H, W, C))
        torch.cuda.empty_cache()
    for B, H, W, C, v in TOWER_TIES:
        check(f"B={B} H={H} W={W} C={C} constant {v}", *inputs(B, H, W, C, v))
    for B, H, W, C in TOWER_EDGES:
        check(f"B={B} H={H} W={W} C={C} edge maps k/255", *inputs(B, H, W, C, edges=True))
    B, H, W, C = TOWER_WORST
    x, w, b = E.split_worst_case(B, H, W, C, seed=13, device=dev)
    e_f = check_fwd(f"B={B} H={H} W={W} C={C} worst-case split", x, w, b)
    print(f"kernel check edge_tower_fwd B={B} H={H} W={W} C={C} worst-case split: "
          f"max_abs_err={e_f!r} (max |out| {float(E.edge_tower_gap_plain(x, w, b).max())!r}); "
          f"two forward runs bit-equal ok")
    del x, w, b
    for seed in TOWER_WITNESS_SEEDS:
        tower_f64_witness(torch, E, seed)
        torch.cuda.empty_cache()

    flush = torch.empty(64 * 2**20 // 4, device=dev)  # 64 MB > the 50 MB L2
    conv = torch.nn.functional.conv2d
    rows = {}
    for B, H, W, C in TOWER_TIMED:
        x, w, b, dout = inputs(B, H, W, C)
        xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        with E.fp32_convs():
            lib_ms, _, _ = kernel_times(torch, "conv2d", lambda: conv(xc, wc, padding=2), 5,
                                     flush)
        bounds = tower_bounds(torch, E, x, w, b)
        f32_bound = {"edge_tower_fwd": bounds[2][0], "edge_tower_bwd": bounds[3][0]}
        issued = tower_fwd_issued(E, B, H, W, C)
        extra = {"edge_tower_fwd": f"; issued on the tensor cores {issued!r} operations, "
                                   f"{issued / PEAK_BF16_FLOPS * 1e3!r} ms at peak",
                 "edge_tower_bwd": ""}
        torch.cuda.empty_cache()
        shape = f"B={B} H={H} W={W} C={C} f32, cold L2"
        for name, run, plain, (bnd, by) in (
            ("edge_tower_fwd", lambda: E.edge_tower_fwd(x, w, b),
             lambda: E.edge_tower_gap_plain(x, w, b), bounds[0]),
            ("edge_tower_bwd", lambda: E.edge_tower_bwd(x, w, b, dout),
             lambda: E.edge_tower_gap_plain_backward(x, w, b, dout), bounds[1]),
        ):
            ms, call_ms, _ = kernel_times(torch, name, run, 10, flush)
            plain_ms, _, _ = kernel_times(torch, f"{name} plain", plain, 5, flush)
            check_bound(f"{name} {shape}", ms, bnd)
            rows.setdefault(name, {})[(H, W)] = dict(
                ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                library_ms=lib_ms, shape=shape)
            print(f"kernel time {name} {shape}: ms={ms!r} call_ms={call_ms!r} "
                  f"plain_ms={plain_ms!r} bound_ms={bnd!r} ({by}; all at the f32 rate "
                  f"{f32_bound[name]!r}{extra[name]}) library_ms(conv2d f32, no TF32, "
                  f"conv only)={lib_ms!r}")
        del x, w, b, dout, xc, wc
        torch.cuda.empty_cache()
    out = {}
    for name, by_shape in rows.items():
        main, ref = by_shape[(AF_HW, AF_HW)], by_shape[(224, 224)]
        out[name] = dict(max_abs_err=errs[name], **main, at_224=ref,
                         library="torch.nn.functional.conv2d f32, no TF32 (conv only)")
    return out


def route_check(torch, label, kern, plain, steps, drift):
    """Params, m and v of two train states after the same steps: within
    rtol/atol of train_phase's route check, except where Adam's tiny
    sqrt(v_hat) amplifies a near-cancelled gradient's last bits (at most a
    ROUTE_EXEMPT_CAP share, each within ``drift``).  Returns (max err,
    number of exempt elements)."""
    err_max, amplified, n = 0.0, 0, 0
    bc2 = 1.0 - 0.999**steps
    for k, pk in kern.params.items():
        pk, pp = pk.detach(), plain.params[k].detach()
        for field in ("mu", "nu"):
            err_max = max(err_max, worst(torch, f"{label} {field}[{k}]",
                                         getattr(kern.opt_state, field)[k],
                                         getattr(plain.opt_state, field)[k],
                                         ROUTE_RTOL, ROUTE_ATOL))
        err = (pk - pp).abs()
        beyond = ~(err <= ROUTE_ATOL + ROUTE_RTOL * pp.abs())
        tiny = torch.sqrt(plain.opt_state.nu[k] / bc2) < 10 * 1e-7
        if bool((beyond & ~tiny).any()) or bool((beyond & ~(err <= drift)).any()):
            fail(f"{label} params[{k}]: kernel route disagrees with the plain route "
                 f"(max_abs_err={float(err.max())!r})")
        amplified += int(beyond.sum())
        n += pk.numel()
        err_max = max(err_max, float(err.max()))
    if amplified > ROUTE_EXEMPT_CAP * n:
        fail(f"{label}: {amplified} of {n} params beyond tolerance")
    return err_max, amplified


def af_model(torch, np, edge_tower, seed):
    """AttentiveFashion at the scaled configuration on the card, random
    weights from ``seed``; its inputs from numpy seeds 1, 2, 3."""
    from fashionvisualexpl_tpu_torch.data.features import synthetic_features
    from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion

    edges = np.random.default_rng(2).random((AF_I, AF_HW, AF_HW, 1), dtype=np.float32)
    return AttentiveFashion(
        AF_U, AF_I, synthetic_features(AF_I, 512, seed=1), edges,
        synthetic_features(AF_I, 100, seed=3), embed_k=EMBED_K, attention_layers=(64, 1),
        encoder_hidden=256, dropout_rate=0.5, conv_filters=64, edge_tower=edge_tower,
        generator=torch.Generator(device="cuda").manual_seed(seed))


def af_train_phase(torch, np, E):
    """AttentiveFashion through the generic Trainer at the scaled
    configuration: the kernel route against the plain route, then the main
    path through K7 and a profiler pass."""
    from fashionvisualexpl_tpu_torch.core.config import TrainConfig
    from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
    from fashionvisualexpl_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    pairs, items, counts = make_scaled_arrays(AF_U, AF_I, AF_POS, seed=0)
    # the Trainer reads these fields of an Interactions; the sorted uniform
    # rows are their own padded positives (no pads)
    data = types.SimpleNamespace(
        num_items=AF_I, num_train=len(pairs), train_pairs=pairs, padded_pos=items,
        pos_counts=counts, steps_per_epoch=lambda b: len(pairs) // b)
    cfg = TrainConfig(batch_size=AF_B, lr=AF_LR, reg=AF_REG)
    kern_model = af_model(torch, np, "auto", seed=4)
    if kern_model.tower_route != "kernel":
        fail(f"AttentiveFashion(edge_tower='auto') on the card took {kern_model.tower_route}")
    trainer = Trainer(kern_model, data, cfg)
    torch.cuda.synchronize()
    print(f"af train setup (arrays, features, model): {time.perf_counter() - t0!r} s")

    plain_model = af_model(torch, np, "xla", seed=4)
    plain_trainer = Trainer(plain_model, data, cfg)
    tabs = (trainer._train_pairs, trainer._padded_pos, trainer._pos_counts)
    triples = sample_triplets(1, *tabs, AF_I, AF_ROUTE_STEPS, AF_B)
    states = []
    for tr in (trainer, plain_trainer):
        state, frozen = tr.init_state()
        losses = []
        for s in range(AF_ROUTE_STEPS):
            state, loss = tr.run_steps(state, frozen, tuple(t[s:s + 1] for t in triples),
                                       step_key=100 + s)
            losses.append(float(loss))
        states.append((state, losses))
    (kern, lk), (plain, lp) = states
    for s, (a, b) in enumerate(zip(lk, lp)):
        if not (np.isfinite(a) and abs(a - b) <= 1e-5 * abs(b)):
            fail(f"af route check step {s}: loss {a!r} (kernel) vs {b!r} (plain)")
    route_err, amplified = route_check(torch, "af route check", kern, plain,
                                       AF_ROUTE_STEPS, AF_ROUTE_DRIFT)
    print(f"af route check: {AF_ROUTE_STEPS} full-width steps, K7 route vs plain tower, "
          f"same triples and dropout draws: losses {lk} vs {lp}; params/m/v "
          f"max_abs_err={route_err!r}, {amplified} params exempt (tiny sqrt(v_hat))")
    del plain_trainer, plain_model, plain, states
    torch.cuda.empty_cache()

    triples = sample_triplets(2, *tabs, AF_I, AF_STEPS, AF_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    E.edge_tower_fwd.launches = E.edge_tower_bwd.launches = 0  # main path starts here
    t0 = time.perf_counter()
    kern, loss = trainer.run_steps(kern, None, triples, step_key=200)
    loss = float(loss)  # waits for the steps
    dt = time.perf_counter() - t0
    launches = {"edge_tower_fwd": E.edge_tower_fwd.launches,
                "edge_tower_bwd": E.edge_tower_bwd.launches}  # main path ends here
    peak = torch.cuda.max_memory_allocated()
    want = {"edge_tower_fwd": 2 * AF_STEPS, "edge_tower_bwd": 2 * AF_STEPS}
    if launches != want:
        fail(f"af main path launched {launches}, expected {want}")
    if not np.isfinite(loss):
        fail(f"af main path loss {loss!r}")
    summary = dict(steps=AF_STEPS, s=dt, triples_per_s=AF_STEPS * AF_B / dt,
                   ms_per_step=1e3 * dt / AF_STEPS, peak_gib=peak / 2**30,
                   mean_loss=loss / AF_STEPS, route_max_abs_err=route_err,
                   route_exempt=amplified)
    print(f"af train main path: {AF_STEPS} steps in {dt!r} s, triples_per_s="
          f"{summary['triples_per_s']!r} ms_per_step={summary['ms_per_step']!r}, "
          f"peak {peak / 2**30!r} GiB, launches {launches}, mean loss {loss / AF_STEPS!r}")

    from torch.autograd import DeviceType

    triples = sample_triplets(3, *tabs, AF_I, AF_PROFILE_STEPS, AF_B)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        kern, _ = trainer.run_steps(kern, None, triples, step_key=300)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    ops = sorted(((dev_us(ev), ev.key, ev.count) for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA and dev_us(ev) > 0), reverse=True)
    if not ops:
        fail("af profile: torch.profiler recorded no device time")
    busy = sum(us for us, _, _ in ops)
    summary["profile"] = dict(
        steps=AF_PROFILE_STEPS, wall_ms_per_step=wall_us / 1e3 / AF_PROFILE_STEPS,
        device_ms_per_step=busy / 1e3 / AF_PROFILE_STEPS, idle_share=1.0 - busy / wall_us,
        edge_tower_ms_per_step=sum(us for us, k, _ in ops if "edge_" in k)
        / 1e3 / AF_PROFILE_STEPS)
    print(f"af profile {AF_PROFILE_STEPS} steps: {summary['profile']}")
    for us, name, count in ops[:12]:
        print(f"  {us / 1e3 / AF_PROFILE_STEPS:10.4f} ms/step  {count / AF_PROFILE_STEPS:6.1f}"
              f" launches/step  {100.0 * us / busy:5.1f}%  {name[:90]}")
    del trainer, kern_model, kern, triples, tabs
    torch.cuda.empty_cache()
    return launches, summary


def write_af_features(np, d: Path):
    """The AttentiveFashion inputs in the reference's layout under data
    directory ``d``: color histograms, class one-hots and 32x32 edge
    tiffs (L mode).  Returns the edge stack as ``load_edge_image_stack``
    reads it back ([I, H, W, 1], the 8-bit values / 255)."""
    from PIL import Image

    rng = np.random.default_rng(13)
    feats = d / "original" / "features"
    (feats / "edges").mkdir(parents=True, exist_ok=True)
    np.save(feats / "histograms.npy", rng.integers(0, 100, (CLI_I, 512)).astype(np.int32))
    np.save(feats / "one_hot_enc.npy", np.eye(AF_CLI_CLASSES, dtype=np.float32)[
        rng.integers(0, AF_CLI_CLASSES, CLI_I)])
    imgs = (rng.random((CLI_I, AF_HW, AF_HW)) * 255).astype(np.uint8)
    for i in range(CLI_I):
        Image.fromarray(imgs[i], mode="L").save(feats / "edges" / f"{i}.tiff")
    return (imgs.astype(np.float32) / 255.0)[..., None]


def read_tsv(np, path, cols: int):
    """[rows, cols] float64 of a numeric TSV dump."""
    with open(path) as f:
        return np.array(f.read().split(), dtype=np.float64).reshape(-1, cols)


class launch_deltas:
    """Record K7 forward launches of every call of ``cls.method`` while
    active (an instrument of this script, not of the port)."""

    def __init__(self, cls, method, E):
        self.cls, self.method, self.E, self.deltas = cls, method, E, []

    def __enter__(self):
        inner = getattr(self.cls, self.method)

        def counted(obj, *a, **kw):
            before = self.E.edge_tower_fwd.launches
            out = inner(obj, *a, **kw)
            self.deltas.append(self.E.edge_tower_fwd.launches - before)
            return out

        self.inner = inner
        setattr(self.cls, self.method, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.method, self.inner)


def af_path_phase(torch, np, E):
    """train_rec --rec attentive_fashion then serve_rec, in process, on the
    CLI phase's dataset with edge tiffs; then direct serving timed per
    bucket and checked against an oracle on the card."""
    import glob
    import pickle
    import shutil

    from fashionvisualexpl_tpu_torch.cli import train_rec as cli
    from fashionvisualexpl_tpu_torch.cli.serve_rec import serve
    from fashionvisualexpl_tpu_torch.core.checkpoint import CheckpointManager
    from fashionvisualexpl_tpu_torch.core.config import Paths, TrainConfig
    from fashionvisualexpl_tpu_torch.data.features import (
        load_class_onehot,
        load_color_histograms,
    )
    from fashionvisualexpl_tpu_torch.data.interactions import Interactions
    from fashionvisualexpl_tpu_torch.eval.evaluator import Evaluator
    from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion
    from fashionvisualexpl_tpu_torch.serve import RecServer

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    write_reference_dataset(np, CLI_DIR / "cli")
    edges = write_af_features(np, CLI_DIR / "cli")
    write_s = time.perf_counter() - t0
    results = CLI_DIR / "results"
    common = ["--rec", "attentive_fashion", "--dataset", "cli", "--data_root", str(CLI_DIR),
              "--results_root", str(results), "--embed_k", str(EMBED_K), "--top_k",
              str(CLI_K), "--edge_hw", str(AF_HW), str(AF_HW), "--batch_eval",
              str(AF_CLI_BATCH_EVAL)]
    served = CLI_DIR / "served.tsv"
    users = ",".join(str(u * (CLI_U // CLI_SERVE_USERS)) for u in range(CLI_SERVE_USERS))
    per_pass = -(-CLI_I // AF_CLI_BATCH_EVAL)
    E.edge_tower_fwd.launches = E.edge_tower_bwd.launches = 0
    with launch_deltas(Evaluator, "evaluate", E) as evals, \
            launch_deltas(RecServer, "refresh", E) as refreshes:
        t0 = time.perf_counter()
        cli.train(common + ["--batch_size", "1024", "--epochs", "2", "--verbose", "1"])
        train_s = time.perf_counter() - t0
        (ckpt,) = glob.glob(str(results / "rec_model_weights" / "cli" / "attentive_fashion"
                                / "ckpt-*"))
        t0 = time.perf_counter()
        serve(common + ["--ckpt", ckpt, "--users", users, "--output", str(served)])
        serve_s = time.perf_counter() - t0
    launches = {"edge_tower_fwd": E.edge_tower_fwd.launches,
                "edge_tower_bwd": E.edge_tower_bwd.launches}
    if evals.deltas != [per_pass, per_pass] or refreshes.deltas != [per_pass]:
        fail(f"K7 forward launches per evaluate {evals.deltas} and per refresh "
             f"{refreshes.deltas}, expected {per_pass} each")
    rdir = results / "rec_results" / "cli" / "attentive_fashion"
    rows = {}
    for pattern in ("recs-2-*.tsv", "best-recs-*.tsv", "att-recs-2-*.tsv",
                    "best-att-recs-*.tsv"):
        (path,) = glob.glob(str(rdir / pattern))
        table = read_tsv(np, path, 6 if "att" in pattern else 3)
        rows[pattern] = len(table)
        if len(table) != CLI_U * CLI_K:
            fail(f"{pattern}: {len(table)} rows, expected {CLI_U * CLI_K}")
        if "att" in pattern and not np.allclose(table[:, 3:].sum(1), 1.0, rtol=0, atol=1e-5):
            fail(f"{pattern}: attention weights do not sum to 1 within 1e-5")
    n_served = len(read_tsv(np, served, 3))
    if n_served != CLI_SERVE_USERS * CLI_K:
        fail(f"serve_rec wrote {n_served} rows, expected {CLI_SERVE_USERS * CLI_K}")
    (pkl,) = glob.glob(str(rdir / "results-metrics-*.pkl"))
    with open(pkl, "rb") as f:
        per_epoch = pickle.load(f)
    vals = np.array([v for m in per_epoch.values() for v in m.values()])
    if sorted(per_epoch) != [1, 2] or not (
            np.isfinite(vals).all() and (vals >= 0).all() and (vals <= 1).all()):
        fail(f"af CLI metrics not finite in [0, 1] for epochs 1, 2: {per_epoch}")
    print(f"af cli: dataset write {write_s!r} s, train_rec {train_s!r} s, serve_rec "
          f"{serve_s!r} s; K7 launches {launches} (forward {evals.deltas} per evaluate, "
          f"{refreshes.deltas} per refresh); rows {rows}, served {n_served}")

    # direct serving of the best params, timed per bucket; the model as
    # build_model makes it, from the edge stack in memory (the tiffs hold
    # the same values; reading 20k of them again costs seconds of host time)
    paths = Paths(root=str(CLI_DIR), results_root=str(results))
    data = Interactions.load(TrainConfig(dataset="cli", paths=paths))
    model = AttentiveFashion(
        CLI_U, CLI_I, load_color_histograms(paths, "cli"), edges,
        load_class_onehot(paths, "cli"), embed_k=EMBED_K, attention_layers=(64, 1),
        batch_eval=AF_CLI_BATCH_EVAL)
    params = CheckpointManager(ckpt).restore_best(dict(model.named_parameters()))
    srv = RecServer(model, data, k=CLI_K)
    t0 = time.perf_counter()
    srv.refresh(params)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    rng = np.random.default_rng(14)
    serving = {}
    for B in AF_SERVE_BUCKETS:
        batch = rng.choice(CLI_U, B, replace=False)
        ids, vals = srv.query(batch)
        times = []
        for _ in range(10 if B < 1024 else 5):
            t0 = time.perf_counter()
            ids, vals = srv.query(batch)
            times.append(time.perf_counter() - t0)
        if ids.shape != (B, CLI_K) or not np.isfinite(vals).all():
            fail(f"af direct serving B={B}: bad result shape {ids.shape} or values")
        serving[B] = dict(p50_ms=1e3 * statistics.median(times),
                          qps=B / statistics.median(times))
        if B == 64:
            with torch.no_grad():
                u = torch.as_tensor(batch, device="cuda")
                s = model.predict_user_block(u, srv._index["ctx"], params=params)
                for row, uid in enumerate(batch):
                    s[row, torch.as_tensor(data.training_list[uid], device="cuda")] = \
                        float("-inf")
                want_vals, want_ids = torch.topk(s, CLI_K, dim=1)
            check_served(np, "af direct serving B=64", ids, vals, want_ids.cpu().numpy(),
                         want_vals.cpu().numpy())
        print(f"af serve B={B}: p50_ms={serving[B]['p50_ms']!r} qps={serving[B]['qps']!r}")
    del srv, model, params
    torch.cuda.empty_cache()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    return launches, dict(write_s=write_s, train_s=train_s, serve_s=serve_s,
                          refresh_s=refresh_s, serving=serving, metrics=per_epoch[2],
                          eval_launches=evals.deltas)


def rows_bound(B: int, W: int):
    """K4 / K5 on B rows of W float32: each row read once and written once,
    the B int32 ids read once; no arithmetic."""
    return bound_ms(4 * (2 * B * W + B), 0, PEAK_F32_FLOPS)


def row_kernel_phase(torch, G, S):
    """K4 and K5 against their plain versions, bit for bit, then timed at
    the JAX benches' shapes; bench_gather / bench_scatter once."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)

    def bits(R, W):
        return torch.randint(-2**31, 2**31 - 1, (R, W), device=dev, generator=g,
                             dtype=torch.int32).view(torch.float32)

    def ids32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    def check(label, table, gather_ids, scatter_ids, vals):
        got = G.gather_rows(table, gather_ids)
        kern = S.scatter_rows_set(table.clone(), scatter_ids, vals)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32),
                           G.gather_rows_reference(table, gather_ids).view(torch.int32)):
            fail(f"gather kernel disagrees with its plain version at {label}")
        plain = S.scatter_rows_set_reference(table.clone(), scatter_ids, vals)
        if not torch.equal(kern.view(torch.int32), plain.view(torch.int32)):
            fail(f"scatter kernel disagrees with its plain version at {label}")
        print(f"kernel check rows {label}: gather and scatter bit-equal ok")

    # the JAX tests' geometries (tests/test_gather_kernel.py,
    # tests/test_row_scatter.py): random, duplicates, out of range and
    # negative, a batch that is no multiple of the TPU's rows_per_step
    for label, (R, W), gids, sids in (
        ("64x16 random", (64, 16), torch.randint(0, 64, (40,), device=dev, generator=g,
                                                 dtype=torch.int32),
         torch.randperm(64, device=dev, generator=g)[:40].to(torch.int32)),
        ("8x4 duplicates / drops", (8, 4), ids32([3, 3, 0, 7, 3]), ids32([3, 8, 100, -1, 0])),
        ("6x3 out of range", (6, 3), ids32([1, 2**30, -1, 5, 7, -2, -6, -7, -100, 6,
                                           2**31 - 1, -2**31, 12]),
         ids32([1, 2**30, -1, 5, 7, -2, -6, -7, -100, 6, 2**31 - 1, -2**31, 12])),
        ("16x8 internal pad", (16, 8), ids32([5, 2, 11]), ids32([5, 2, 11])),
    ):
        check(label, bits(R, W), gids, sids, bits(len(sids), W))
    for W in ROW_WIDTHS:
        table = bits(ROW_TABLE, W)
        for B in ROW_BATCHES:
            gids = torch.randint(0, ROW_TABLE, (B,), device=dev, generator=g,
                                 dtype=torch.int32)
            sids = torch.randperm(ROW_TABLE, device=dev, generator=g)[:B].to(torch.int32)
            gids[-B // 4:] = sids[-B // 4:] = 2**30  # the dedupe's pads
            check(f"R={ROW_TABLE} W={W} B={B}", table, gids, sids, bits(B, W))
        del table
        torch.cuda.empty_cache()

    flush = torch.empty(64 * 2**20 // 4, device=dev)  # 64 MB > the 50 MB L2
    rows = {}
    R, W, B = GATHER_SHAPE
    table = torch.randn(R, W, device=dev, generator=g)
    ids = torch.randint(0, R, (B,), device=dev, generator=g, dtype=torch.int32)
    err = float((G.gather_rows(table, ids) - G.gather_rows_reference(table, ids)).abs().max())
    runs = (lambda: G.gather_rows(table, ids), lambda: G.gather_rows_reference(table, ids),
            lambda: torch.index_select(table, 0, ids))
    rows["gather_rows"] = (err, runs, rows_bound(B, W), f"R={R} W={W} B={B} f32, cold L2",
                           "torch.index_select")
    R, W, B = SCATTER_SHAPE
    stable = torch.randn(R, W, device=dev, generator=g)
    sids64 = torch.randperm(R, device=dev, generator=g)[:B]
    sids = sids64.to(torch.int32)
    vals = torch.randn(B, W, device=dev, generator=g)
    err = float((S.scatter_rows_set(stable.clone(), sids, vals)
                 - S.scatter_rows_set_reference(stable.clone(), sids, vals)).abs().max())
    runs = (lambda: S.scatter_rows_set(stable, sids, vals),
            lambda: S.scatter_rows_set_reference(stable, sids, vals),
            lambda: stable.index_copy_(0, sids64, vals))
    rows["scatter_rows_set"] = (err, runs, rows_bound(B, W), f"R={R} W={W} B={B} f32, cold L2",
                                "Tensor.index_copy_ (int64 ids)")
    out = {}
    for name, (err, (run, plain, lib), (b, by), shape, library) in rows.items():
        ms, call_ms, _ = kernel_times(torch, name, run, 20, flush)
        plain_ms, _, _ = kernel_times(torch, f"{name} plain", plain, 10, flush)
        lib_ms, _, _ = kernel_times(torch, f"{name} library", lib, 20, flush)
        check_bound(name, ms, b)
        out[name] = dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                         bound_ms=b, bound_by=by, library_ms=lib_ms, shape=shape,
                         library=library)
        print(f"kernel time {name} {shape}: ms={ms!r} call_ms={call_ms!r} "
              f"plain_ms={plain_ms!r} library_ms({library})={lib_ms!r} bound_ms={b!r} ({by})")
    del table, stable, vals, flush
    torch.cuda.empty_cache()
    for name, bench in (("bench_gather", G.bench_gather), ("bench_scatter", S.bench_scatter)):
        kernel_ms, torch_ms = bench()
        out[name] = dict(kernel_ms=kernel_ms, torch_ms=torch_ms)
        print(f"{name}(): kernel_ms={kernel_ms!r} torch_ms={torch_ms!r} "
              f"speedup={torch_ms / kernel_ms!r}")
        torch.cuda.empty_cache()
    return out


def capped_close(label, got, want, rtol, atol, cap, slack, allowed=None):
    """(max |got - want|, number beyond tolerance): fails unless every
    element is within atol + rtol |want|, but for at most cap * n of them,
    each within ``slack`` and, where ``allowed`` is given, only where it
    holds.  A NaN fails."""
    err = (got - want).abs()
    beyond = ~(err <= atol + rtol * want.abs())
    n = int(beyond.sum())
    if n > cap * want.numel():
        fail(f"{label}: {n} of {want.numel()} values beyond rtol {rtol} atol {atol} "
             f"(max_abs_err={float(err.max())!r}), more than a {cap!r} share")
    if n and (bool((beyond & ~(err <= slack)).any())
              or (allowed is not None and bool((beyond & ~allowed).any()))):
        fail(f"{label}: a value beyond tolerance is further apart than allowed "
             f"(max_abs_err={float(err.max())!r})")
    return float(err.max()), n


def packed_groups(PG, spec, md):
    """(table, [(label, param column, width, moment columns, kind)], tau
    column) of the packed user and item rows."""
    (_, Wu), (_, Wi) = spec.user_tables[0], spec.item_tables[0]
    gs, mw_u, mw_i = PG._scalar_group(md), PG._mom_width(md, Wu), PG._mom_width(md, Wi)
    items = [("Gi", 0, Wi, (Wi, Wi + mw_i), md)]
    for j, sname in enumerate(spec.item_scalars):
        c = Wi + mw_i + gs * j  # scalars: [p | m | v], or [p | bf16 pair]
        items.append((sname, c, 1, (c + 1, c + gs), "float32" if gs == 3 else "bfloat16"))
    return (("user_pmv", [("Gu", 0, Wu, (Wu, Wu + mw_u), md)], Wu + mw_u),
            ("item_pmv", items, Wi + mw_i + gs * len(spec.item_scalars)))


def decode_moments(PG, cols, w, kind):
    if kind == "float32":
        return cols[:, :w], cols[:, w:]
    if kind == "bfloat16":
        return PG._mv_unpack(cols)
    return PG._mv_unpack_fp8(cols, w)


def packed_route_check(torch, PG, label, kern, plain, spec, md, steps, lr):
    """The packed states after the same steps by the kernel route (card)
    and the plain route (CPU copies): tau and row_align pad columns
    bit-equal, untouched rows bit-equal, touched rows' params and decoded
    moments within the route tolerances (see PACKED_FLIP_CAP); dense m, v
    within them, dense params too but where sqrt(v_hat) is tiny (within
    the drift there).  Returns (max err, values beyond)."""
    err_max, beyond = 0.0, 0
    bc2 = 1.0 - 0.999**steps
    for name, groups, tau in packed_groups(PG, spec, md):
        a = getattr(kern, name)
        b = getattr(plain, name).to(a.device)  # compared on the card
        ai, bi = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(ai[:, tau:], bi[:, tau:]):
            fail(f"{label} {name}: tau or pad columns differ between routes")
        touched = b[:, tau] > 0
        if not torch.equal(ai[~touched], bi[~touched]):
            fail(f"{label} {name}: untouched rows differ between routes")
        a, b = a[touched], b[touched]
        for g_name, c0, w, (m0, m1), kind in groups:
            (am, av), (bm, bv) = (decode_moments(PG, t[:, m0:m1], w, kind) for t in (a, b))
            code = MOMENT_CODE[kind]
            cap = PACKED_FLIP_CAP if code else 0.0
            if kind == "float8":  # e5m2 holds sqrt(v)
                av, bv = torch.sqrt(av), torch.sqrt(bv)
            for f, x, y in (("m", am, bm), ("v", av, bv)):
                e, n = capped_close(f"{label} {name} {g_name} {f}", x, y, MOMENT_RTOL[kind],
                                    ROUTE_ATOL, cap, code * y.abs() + ROUTE_ATOL)
                err_max, beyond = max(err_max, e), beyond + n
            e, n = capped_close(f"{label} {name} {g_name} p", a[:, c0:c0 + w],
                                b[:, c0:c0 + w], ROUTE_RTOL, ROUTE_ATOL, PACKED_FLIP_CAP,
                                2 * lr * steps)
            err_max, beyond = max(err_max, e), beyond + n
    for name, (p, m, v) in plain.dense.items():
        kp, km, kv = kern.dense[name]
        for k in p:
            for f, x, y in (("m", km[k], m[k]), ("v", kv[k], v[k])):
                err_max = max(err_max, worst(torch, f"{label} {name}.{k} {f}", x.cpu(), y,
                                             ROUTE_RTOL, ROUTE_ATOL))
            tiny = torch.sqrt(v[k] / bc2) < 10 * 1e-7
            e, n = capped_close(f"{label} {name}.{k} p", kp[k].cpu(), p[k], ROUTE_RTOL,
                                ROUTE_ATOL, 1.0, 2 * lr * steps, tiny)
            err_max, beyond = max(err_max, e), beyond + n
    return err_max, beyond


def to_cpu_state(torch, PG, state):
    """A CPU copy of a packed state (the plain route's start)."""
    def copy(x):
        return x.cpu() if isinstance(x, torch.Tensor) else {k: v.cpu() for k, v in x.items()}

    dense = {n: tuple(copy(x) for x in pmv) for n, pmv in state.dense.items()}
    return PG.GenericPackedState(state.step.cpu(), state.user_pmv.cpu(),
                                 state.item_pmv.cpu(), dense)


def step_profile(torch, label, run, triples, n: int):
    """One torch.profiler pass over ``run(triples)`` (n steps): wall and
    device ms a step, device operations a step, the idle share and the
    shares of device time of K4, K5 and K7."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(triples)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    ops = sorted(((dev_us(ev), ev.key, ev.count) for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA and dev_us(ev) > 0), reverse=True)
    if not ops:
        fail(f"{label} profile: torch.profiler recorded no device time")
    busy = sum(us for us, _, _ in ops)
    share = {k: sum(us for us, key, _ in ops if tag in key) / busy
             for k, tag in (("k4", "gather_rows_kernel"), ("k5", "scatter_rows_kernel"),
                            ("k7", "edge_"))}
    out = dict(steps=n, wall_ms_per_step=wall_us / 1e3 / n, device_ms_per_step=busy / 1e3 / n,
               device_ops_per_step=sum(c for _, _, c in ops) / n,
               idle_share=1.0 - busy / wall_us, **{f"{k}_share": v for k, v in share.items()})
    print(f"{label} profile {n} steps: {out}")
    for us, name, count in ops[:15]:
        print(f"  {us / 1e3 / n:10.4f} ms/step  {count / n:6.1f} launches/step  "
              f"{100.0 * us / busy:5.1f}%  {name[:90]}")
    return out


def phase_start(torch) -> int:
    """Bytes still allocated when a phase begins, after the earlier phases'
    tensors are collected and the cache is emptied: a phase's own peak is
    its max_memory_allocated() less this."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def packed_train_phase(torch, np, G, S):
    """BPRMF through Trainer(train_path="packed") at full width: route
    checks, one 200-step epoch through K4 and K5, a profile."""
    from fashionvisualexpl_tpu_torch.core.config import TrainConfig
    from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
    from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
    from fashionvisualexpl_tpu_torch.train import packed_generic as PG
    from fashionvisualexpl_tpu_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    start = phase_start(torch)  # what earlier phases left allocated
    t0 = time.perf_counter()
    pairs, items, counts = make_scaled_arrays(TRAIN_U, TRAIN_I, TRAIN_POS, seed=0)
    data = types.SimpleNamespace(
        num_items=TRAIN_I, num_train=len(pairs), train_pairs=pairs, padded_pos=items,
        pos_counts=counts, steps_per_epoch=lambda b: len(pairs) // b)
    model = BPRMF(TRAIN_U, TRAIN_I, embed_k=EMBED_K,
                  generator=torch.Generator(device=dev).manual_seed(16))
    cfg = TrainConfig(batch_size=TRAIN_B, lr=TRAIN_LR, reg=TRAIN_REG, train_path="packed")
    trainer = Trainer(model, data, cfg)
    tabs = (trainer._train_pairs, trainer._padded_pos, trainer._pos_counts)
    torch.cuda.synchronize()
    print(f"packed train setup (arrays + model): {time.perf_counter() - t0!r} s")

    triples = sample_triplets(1, *tabs, TRAIN_I, PACKED_ROUTE_STEPS, TRAIN_B)
    route = {}
    for md, catchup in (("float32", True), ("float32", False), ("bfloat16", True),
                        ("float8", True)):
        label = f"packed route {md}{'' if catchup else ' no catch-up'}"
        t0 = time.perf_counter()
        kern = PG.pack_generic_state(model, dict(model.named_parameters()), moment_dtype=md)
        plain = to_cpu_state(torch, PG, kern)
        step = PG.make_generic_packed_step(model, TRAIN_LR, TRAIN_REG, moment_dtype=md,
                                           lazy_catchup=catchup)
        losses = []
        for s in range(PACKED_ROUTE_STEPS):
            batch = tuple(t[s] for t in triples)
            kern, lk = step(kern, (None, batch, None))
            plain, lp = step(plain, (None, tuple(t.cpu() for t in batch), None))
            lk, lp = float(lk), float(lp)
            if not (np.isfinite(lk) and abs(lk - lp) <= 1e-5 * abs(lp)):
                fail(f"{label} step {s}: loss {lk!r} (kernels) vs {lp!r} (plain)")
            losses.append((lk, lp))
        err, beyond = packed_route_check(torch, PG, label, kern, plain, model.packed_spec(),
                                         md, PACKED_ROUTE_STEPS, TRAIN_LR)
        route[label] = dict(max_abs_err=err, beyond=beyond, s=time.perf_counter() - t0)
        print(f"{label}: {PACKED_ROUTE_STEPS} full-width steps, card vs CPU copies, losses "
              f"{losses}; max_abs_err={err!r}, {beyond} values one code or drift apart; tau, "
              f"pads and untouched rows bit-equal ok")
        del kern, plain
        torch.cuda.empty_cache()

    # main path: one epoch of 200 steps through K4 and K5
    state, frozen = trainer.init_state()
    epoch_fn = PG.make_generic_packed_epoch_fn(
        model, TRAIN_LR, TRAIN_REG, TRAIN_I, PACKED_STEPS, TRAIN_B,
        with_replacement=cfg.sampling_scheme, moment_dtype=cfg.moment_dtype,
        lazy_catchup=cfg.lazy_catchup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    G.gather_rows.launches = S.scatter_rows_set.launches = 0  # main path starts here
    t0 = time.perf_counter()
    inner, loss = epoch_fn(state.inner, frozen, 100, *tabs)
    loss = float(loss)  # waits for the epoch
    dt = time.perf_counter() - t0
    launches = {"gather_rows": G.gather_rows.launches,
                "scatter_rows_set": S.scatter_rows_set.launches}  # main path ends here
    peak = torch.cuda.max_memory_allocated() - start  # the phase's own peak
    want = {"gather_rows": 4 * PACKED_STEPS, "scatter_rows_set": 2 * PACKED_STEPS}
    if launches != want:
        fail(f"packed main path launched {launches}, expected {want}")
    if not np.isfinite(loss) or int(inner.step) != PACKED_STEPS:
        fail(f"packed epoch: loss {loss!r}, step {int(inner.step)}")
    summary = dict(steps=PACKED_STEPS, s=dt, triples_per_s=PACKED_STEPS * TRAIN_B / dt,
                   ms_per_step=1e3 * dt / PACKED_STEPS, peak_gib=peak / 2**30,
                   start_gib=start / 2**30, mean_loss=loss / PACKED_STEPS, route=route)
    print(f"packed train main path: {PACKED_STEPS} steps in {dt!r} s (sampling included), "
          f"triples_per_s={summary['triples_per_s']!r} ms_per_step={summary['ms_per_step']!r}"
          f", the phase's own peak {peak / 2**30!r} GiB (allocated when it began "
          f"{start / 2**30!r}), launches {launches}")

    state = state.with_inner(inner)
    summary["profile"] = step_profile(
        torch, "packed", lambda tr: trainer.run_steps(state, frozen, tr, step_key=300),
        sample_triplets(200, *tabs, TRAIN_I, PACKED_PROFILE_STEPS, TRAIN_B),
        PACKED_PROFILE_STEPS)
    del trainer, model, state, inner, tabs
    torch.cuda.empty_cache()
    return launches, summary


def af_packed_phase(torch, np, G, S, E):
    """AttentiveFashion through Trainer(train_path="packed") at its training
    configuration: 2 steps (batch 1024) on the card against CPU copies with
    the plain tower, then 20 steps at batch 8192 through K4, K5 and K7."""
    from fashionvisualexpl_tpu_torch.core.config import TrainConfig
    from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
    from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion
    from fashionvisualexpl_tpu_torch.train import packed_generic as PG
    from fashionvisualexpl_tpu_torch.train.trainer import Trainer

    start = phase_start(torch)  # what earlier phases left allocated
    t0 = time.perf_counter()
    pairs, items, counts = make_scaled_arrays(AF_U, AF_I, AF_POS, seed=0)
    data = types.SimpleNamespace(
        num_items=AF_I, num_train=len(pairs), train_pairs=pairs, padded_pos=items,
        pos_counts=counts, steps_per_epoch=lambda b: len(pairs) // b)
    model = af_model(torch, np, "auto", seed=17)
    cfg = TrainConfig(batch_size=AF_B, lr=AF_LR, reg=AF_REG, train_path="packed")
    trainer = Trainer(model, data, cfg)
    if model.tower_route != "kernel":
        fail(f"AttentiveFashion(edge_tower='auto') on the card took {model.tower_route}")
    tabs = (trainer._train_pairs, trainer._padded_pos, trainer._pos_counts)
    state, frozen = trainer.init_state()
    # the plain route's model: the same weights and inputs on the CPU
    cpu_model = AttentiveFashion(
        AF_U, AF_I, model.Fc.cpu().numpy(), model.Fe_img.cpu().numpy(),
        model.Fcls.cpu().numpy(), embed_k=EMBED_K, attention_layers=(64, 1),
        encoder_hidden=256, dropout_rate=0.5, conv_filters=64, device="cpu")
    torch.cuda.synchronize()
    print(f"af packed setup (arrays, features, models): {time.perf_counter() - t0!r} s")

    t0 = time.perf_counter()
    plain = to_cpu_state(torch, PG, state.inner)
    kern = state.inner
    steps = [PG.make_generic_packed_step(m, AF_LR, AF_REG, lazy_catchup=True)
             for m in (model, cpu_model)]
    triples = sample_triplets(1, *tabs, AF_I, AF_PACKED_ROUTE_STEPS, AF_PACKED_ROUTE_B)
    gen = torch.Generator().manual_seed(18)
    losses = []
    for s in range(AF_PACKED_ROUTE_STEPS):
        batch = tuple(t[s] for t in triples)
        masks = [torch.rand(AF_PACKED_ROUTE_B, w, generator=gen) < 0.5
                 for w in (256, 64, 256) * 2]
        kern, lk = steps[0](kern, (None, batch, [m.cuda() for m in masks]))
        plain, lp = steps[1](plain, (None, tuple(t.cpu() for t in batch), masks))
        lk, lp = float(lk), float(lp)
        if not (np.isfinite(lk) and abs(lk - lp) <= 1e-5 * abs(lp)):
            fail(f"af packed route step {s}: loss {lk!r} (kernels) vs {lp!r} (plain)")
        losses.append((lk, lp))
    err, beyond = packed_route_check(torch, PG, "af packed route", kern, plain,
                                     model.packed_spec(), "float32", AF_PACKED_ROUTE_STEPS,
                                     AF_LR)
    route_s = time.perf_counter() - t0
    print(f"af packed route: {AF_PACKED_ROUTE_STEPS} steps at batch {AF_PACKED_ROUTE_B} "
          f"(full tables), card (K4, K5, K7) vs CPU copies (plain rows, plain tower), the "
          f"same masks: losses {losses}; max_abs_err={err!r}, {beyond} params exempt "
          f"(tiny sqrt(v_hat)); {route_s!r} s")
    del plain, cpu_model, kern
    torch.cuda.empty_cache()

    state, frozen = trainer.init_state()
    triples = sample_triplets(2, *tabs, AF_I, AF_PACKED_STEPS + 1, AF_B)
    # one step first at batch 8192 (allocations, library handles), untimed
    state, _ = trainer.run_steps(state, frozen, tuple(t[:1] for t in triples), step_key=199)
    triples = tuple(t[1:] for t in triples)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    G.gather_rows.launches = S.scatter_rows_set.launches = 0
    E.edge_tower_fwd.launches = E.edge_tower_bwd.launches = 0  # main path starts here
    t0 = time.perf_counter()
    state, loss = trainer.run_steps(state, frozen, triples, step_key=200)
    loss = float(loss)
    dt = time.perf_counter() - t0
    launches = {"gather_rows": G.gather_rows.launches,
                "scatter_rows_set": S.scatter_rows_set.launches,
                "edge_tower_fwd": E.edge_tower_fwd.launches,
                "edge_tower_bwd": E.edge_tower_bwd.launches}  # main path ends here
    peak = torch.cuda.max_memory_allocated() - start  # the phase's own peak
    n = AF_PACKED_STEPS
    want = {"gather_rows": 4 * n, "scatter_rows_set": 2 * n, "edge_tower_fwd": 2 * n,
            "edge_tower_bwd": 2 * n}
    if launches != want:
        fail(f"af packed main path launched {launches}, expected {want}")
    if not np.isfinite(loss):
        fail(f"af packed main path loss {loss!r}")
    summary = dict(steps=n, s=dt, ms_per_step=1e3 * dt / n, triples_per_s=n * AF_B / dt,
                   peak_gib=peak / 2**30, start_gib=start / 2**30, mean_loss=loss / n,
                   route_max_abs_err=err,
                   route_exempt=beyond, route_losses=losses)
    print(f"af packed main path: {n} steps in {dt!r} s, ms_per_step={summary['ms_per_step']!r}"
          f" triples_per_s={summary['triples_per_s']!r}, the phase's own peak "
          f"{peak / 2**30!r} GiB (allocated when it began {start / 2**30!r}), "
          f"launches {launches}")
    summary["profile"] = step_profile(
        torch, "af packed", lambda tr: trainer.run_steps(state, frozen, tr, step_key=300),
        sample_triplets(3, *tabs, AF_I, AF_PROFILE_STEPS, AF_B), AF_PROFILE_STEPS)
    del trainer, model, state, triples, tabs
    torch.cuda.empty_cache()
    return launches, summary


def packed_cli_phase(torch, np, counts, segmax, G, S):
    """train_rec --rec bprmf --train_path packed --streaming_eval, then
    serve_rec from its checkpoint, in process, on the CLI dataset."""
    import glob
    import pickle
    import shutil

    from fashionvisualexpl_tpu_torch.cli.serve_rec import serve
    from fashionvisualexpl_tpu_torch.cli.train_rec import train

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    write_reference_dataset(np, CLI_DIR / "cli")
    results = CLI_DIR / "results"
    common = ["--rec", "bprmf", "--dataset", "cli", "--data_root", str(CLI_DIR),
              "--results_root", str(results), "--embed_k", str(EMBED_K),
              "--top_k", str(CLI_K)]
    served = CLI_DIR / "served.tsv"
    users = ",".join(str(u * (CLI_U // CLI_SERVE_USERS)) for u in range(CLI_SERVE_USERS))
    counts.counts_kernel.launches = segmax.segmax_scores.launches = 0
    G.gather_rows.launches = S.scatter_rows_set.launches = 0  # main path starts here
    t0 = time.perf_counter()
    train(common + ["--train_path", "packed", "--streaming_eval", "--epochs", "2",
                    "--verbose", "1", "--batch_size", str(PACKED_CLI_B)])
    train_s = time.perf_counter() - t0
    (ckpt,) = glob.glob(str(results / "rec_model_weights" / "cli" / "bprmf" / "ckpt-*"))
    t0 = time.perf_counter()
    serve(common + ["--ckpt", ckpt, "--users", users, "--output", str(served)])
    serve_s = time.perf_counter() - t0
    launches = {"gather_rows": G.gather_rows.launches,
                "scatter_rows_set": S.scatter_rows_set.launches,
                "counts": counts.counts_kernel.launches,
                "segmax_scores": segmax.segmax_scores.launches}  # main path ends here
    steps = 2 * (CLI_U * (CLI_PER_USER - 2) // PACKED_CLI_B)
    if (launches["gather_rows"], launches["scatter_rows_set"]) != (4 * steps, 2 * steps) \
            or not all(launches.values()):
        fail(f"the packed CLI launched {launches}, expected {4 * steps} K4 and {2 * steps} "
             f"K5 and the evaluation and serving kernels")
    rdir = results / "rec_results" / "cli" / "bprmf"
    for pattern in ("recs-2-*.tsv", "best-recs-*.tsv"):
        (path,) = glob.glob(str(rdir / pattern))
        with open(path) as f:
            n_rows = sum(1 for _ in f)
        if n_rows != CLI_U * CLI_K:
            fail(f"packed CLI {pattern}: {n_rows} rows, expected {CLI_U * CLI_K}")
    with open(served) as f:
        n_served = sum(1 for _ in f)
    (pkl,) = glob.glob(str(rdir / "results-metrics-*.pkl"))
    with open(pkl, "rb") as f:
        per_epoch = pickle.load(f)
    vals = np.array([v for m in per_epoch.values() for v in m.values()])
    if n_served != CLI_SERVE_USERS * CLI_K or sorted(per_epoch) != [1, 2] or not (
            np.isfinite(vals).all() and (vals >= 0).all() and (vals <= 1).all()):
        fail(f"packed CLI: served {n_served} rows, metrics {per_epoch}")
    print(f"packed cli: train_rec {train_s!r} s, serve_rec {serve_s!r} s; launches {launches}"
          f"; metrics epoch 2 {per_epoch[2]}")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    return launches, dict(train_s=train_s, serve_s=serve_s, metrics=per_epoch[2])


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
    from fashionvisualexpl_tpu_torch.ops import (
        adam,
        bpr,
        counts,
        cuda_build,
        segmax,
        topk,
    )
    from fashionvisualexpl_tpu_torch.ops import edge_tower as E
    from fashionvisualexpl_tpu_torch.ops import gather as G
    from fashionvisualexpl_tpu_torch.ops import row_scatter as S

    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    sources = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    cuda_build.build(sources)
    print(f"kernel build ({', '.join(sources)}): {time.perf_counter() - t0!r} s")
    for name, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "smem", "spill", "wgmma", "warning")):
                print(f"  nvcc {name}: {line.strip()}")

    rows = kernel_phase(torch, segmax)
    serve, launches = serve_phase(torch, np, segmax)
    train_rows = train_kernel_phase(torch, bpr, adam)
    train_launches, train = train_phase(torch, np, bpr, adam)
    fitted = fit_phase(torch, np, bpr, adam)
    eval_items = make_eval_items(np, EVAL_U, EVAL_I, EVAL_TRAIN + 2, seed=0)
    counts_row = eval_kernel_phase(torch, np, counts, topk, eval_items)
    eval_launches, evaluated = eval_phase(torch, np, counts, eval_items)
    del eval_items
    cli_launches, cli = cli_phase(torch, np, counts, segmax)
    tower_rows = tower_kernel_phase(torch, E)
    af_launches, af_train = af_train_phase(torch, np, E)
    af_cli_launches, af_cli = af_path_phase(torch, np, E)
    row_rows = row_kernel_phase(torch, G, S)
    packed_launches, packed = packed_train_phase(torch, np, G, S)
    af_packed_launches, af_packed = af_packed_phase(torch, np, G, S, E)
    packed_cli_launches, packed_cli = packed_cli_phase(torch, np, counts, segmax, G, S)

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
        "cli_launches": cli_launches["segmax_scores"],
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
    kernels.append({
        "name": "counts", "route": "cuda",
        "source": "fashionvisualexpl_tpu_torch/ops/csrc/counts.cu",
        "replaces": "fashionvisualexpl_tpu/ops/counts.py:31",
        "launches": eval_launches, **counts_row,
        "cli_launches": cli_launches["counts"],
    })
    for name, line in (("edge_tower_fwd", 114), ("edge_tower_bwd", 127)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fashionvisualexpl_tpu_torch/ops/csrc/edge_tower.cu",
            "replaces": f"fashionvisualexpl_tpu/ops/edge_tower.py:{line}",
            "launches": af_launches[name], **tower_rows[name],
            "cli_launches": af_cli_launches[name],
        })
    for name, source, line in (("gather_rows", "gather.cu", "gather.py:22"),
                               ("scatter_rows_set", "row_scatter.cu", "row_scatter.py:29")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"fashionvisualexpl_tpu_torch/ops/csrc/{source}",
            "replaces": f"fashionvisualexpl_tpu/ops/{line}",
            "launches": packed_launches[name], **row_rows[name],
            "af_launches": af_packed_launches[name], "cli_launches": packed_cli_launches[name],
            "bench": row_rows["bench_" + name.split("_")[0]],
        })
    print(json.dumps({"serve": {str(b): r for b, r in serve.items()}}))
    print(json.dumps({"train": train, "fit": fitted}))
    print(json.dumps({"eval": evaluated, "cli": cli}))
    print(json.dumps({"af_train": af_train, "af_cli": af_cli}))
    print(json.dumps({"packed": packed, "af_packed": af_packed, "packed_cli": packed_cli}))
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
