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
   checked against the same oracle.

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
    from fashionvisualexpl_tpu_torch.ops import cuda_build, segmax

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
    print(json.dumps({"serve": {str(b): r for b, r in serve.items()}}))
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
