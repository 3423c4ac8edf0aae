"""Time K5 (``ops/csrc/row_scatter.cu`` behind
``ops/row_scatter.py::scatter_rows_set``) of this tree against K5 of other
checkouts, ``Tensor.index_copy_`` and a contiguous ``Tensor.copy_`` of the
same bytes (the card's copy rate, a ceiling no scatter passes), in turns in
one process on one card, with the L2 flushed (a 256 MB fill) before each
call: at every width K5 writes, 16,384 unique rows of each narrow width
(385, 388, 257, 259, 193, 195, 445, 297) over R=1M and 384 at 24,576 (the
JAX bench's shape); 16,384 and 24,576 rows of the fused item widths
(4355, 4867, 4484, 4996) over R=500k; 163,840 and 16,384 rows of ACF's
item widths (769, 513, 25857, 25601, 25473) over R=200k; in the order
others, this, this, others reversed.  Then the dedupe's layout: a batch of
kept rows followed by pads (ACF's fused item rows: 4,096 kept of 45,056
slots; BPRMF's and VBPR's item rows: 12,288 of 16,384).  This tree's K5
also runs with its other kind of route forced (the lanes at wide rows, the bulk copies at
narrow ones), and the narrow widths are also timed warm (vals and the rows
left in the L2 by the call before, as the packed step leaves them).  Then
the width thresholds between the two kinds (rows of 4-byte words about 1
KB, of 16-byte words about 4 KB), each kernel parameter in turn (loads a
lane; stages and piece bytes), the wrappers' host cost (host microseconds
a call over 2000 calls of 16 rows, ``call_ms`` at W=128) and
``bench_scatter()`` of each tree, and the alignment question: K5 (and its
lanes4 route forced), ``index_copy_`` and ``copy_`` at W = 192, 193, 195,
196, 200 and 224 (rows of 24, 24.125, 24.375, 24.5, 25 and 28 sectors of
32 bytes; 192 and 224 whole 128-byte lines).  Every output is first held
bit for bit against the plain version: the written rows equal to vals
(overwritten with their complement first), every other row unchanged.

    git archive <commit> | tar -x -C build/archive/parent
    python scripts_torch/k5_ab.py --other build/archive/parent

Prints each build's ptxas registers and spills, one line per timing and a
JSON summary last, also written to ``build/k5_ab/k5_ab.json``; the times
are torch.profiler's kernel durations of ``chip_smoke.kernel_times``."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "scripts_torch")]

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from fashionvisualexpl_tpu_torch.ops import cuda_build  # noqa: E402
from fashionvisualexpl_tpu_torch.ops import row_scatter as S  # noqa: E402
from k4_ab import build_other  # noqa: E402

OUT = ROOT / "build" / "k5_ab"
R_USERS, R_ITEMS, R_ACF = C.ROW_TABLE, C.EVAL_I, C.ACF_I
ACF_WIDTHS = (769, 513, 25857, 25601, 25473)
SHAPES = ([(R_USERS, w, C.GATHER_B) for w in C.GATHER_NARROW]
          + [(R_USERS, 384, 24_576)]
          + [(R_ITEMS, w, B) for B in (C.GATHER_B, 24_576) for w in C.GATHER_WIDE]
          + [(R_ACF, w, B) for w in ACF_WIDTHS for B in C.ACF_ROW_B])
# rows of 4-byte words (odd widths) about lanes4's 1 KB, rows of 16-byte
# words about lanes16's 4 KB
THRESHOLD_WIDTHS = (193, 225, 241, 255, 257, 289, 385, 512, 768, 1024, 1028, 1536, 2048)
# the dedupe's layout (R, W, slots, kept): its kept rows first, pads of
# 2**30 after; ACF's fused item rows at batch 2048 (2B + BP slots), and
# BPRMF's and VBPR's item rows at batch 8192 (2B slots)
PAD_SHAPES = ((R_ACF, 25857, 45_056, 4096), (R_USERS, 385, 16_384, 12_288),
              (R_ITEMS, 4484, 16_384, 12_288))
ALIGN_WIDTHS = (192, 193, 195, 196, 200, 224)
ITERS = 20
CHUNK = 8192  # rows a comparison takes at a time


def bit_equal(table, sids64, vals, run):
    """run() writes vals into table's rows sids64 as the plain version
    would: those rows (first set to the complement of vals) equal vals
    afterwards, bit for bit, and every other row is unchanged."""
    t32, v32 = table.view(torch.int32), vals.view(torch.int32)
    for i in range(0, sids64.shape[0], CHUNK):
        t32[sids64[i:i + CHUNK]] = ~v32[i:i + CHUNK]
    keep = torch.ones(table.shape[0], dtype=torch.bool, device=table.device)
    keep[sids64] = False
    others = keep.nonzero()[:, 0]
    before = t32[others]
    run()
    torch.cuda.synchronize()
    ok = all(torch.equal(t32[sids64[i:i + CHUNK]], v32[i:i + CHUNK])
             for i in range(0, sids64.shape[0], CHUNK))
    ok = ok and all(torch.equal(t32[others[i:i + CHUNK]], before[i:i + CHUNK])
                    for i in range(0, others.shape[0], CHUNK))
    del before
    return ok


def timed(label, fn, flush, warm=False):
    ms, call_ms, _ = C.kernel_times(torch, label, fn, ITERS, flush[:256] if warm else flush)
    print(f"{label}{' warm' if warm else ''}: {ms!r} ms (call_ms {call_ms!r})")
    return ms, call_ms


def operands(dev, g, R, W, B):
    """A [R, W] table, B unique ids (int64 and int32) and [B, W] vals."""
    table = torch.randn(R, W, device=dev, generator=g)
    sids64 = torch.randperm(R, device=dev, generator=g)[:B]
    return table, sids64, sids64.to(torch.int32), torch.randn(B, W, device=dev, generator=g)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, nargs="*", default=[],
                    help="checkouts to compare with")
    ap.add_argument("--no-sweep", action="store_true",
                    help="skip the threshold and parameter sweeps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_ab: no CUDA card", file=sys.stderr)
        return 2
    card = C.card_line()
    print(f"card: {card}")
    others = build_other([(str(c), c) for c in args.other], "row_scatter", OUT)
    print(f"build this: {cuda_build.build_seconds.get('row_scatter')!r} s")
    for row in cuda_build.ptxas_report(cuda_build.build_logs["row_scatter"]):
        print(f"  ptxas this: {row}")
    for label, (_, seconds, report) in others.items():
        print(f"build {label}: {seconds!r} s")
        for row in report:
            print(f"  ptxas {label}: {row}")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(256 * 2**20 // 4, device=dev)
    summary = {"card": card, "shapes": {}, "threshold": {}, "params": {}, "host": {},
               "alignment": {}}
    order = list(others) + ["this", "this"] + list(others)[::-1]
    fns = {label: mod.scatter_rows_set for label, (mod, _, _) in others.items()}
    fns["this"] = S.scatter_rows_set
    table = sids64 = vals = None

    def fresh(R, W, B):
        nonlocal table, sids64, vals
        table = sids64 = vals = None
        torch.cuda.empty_cache()
        table, sids64, sids, vals = operands(dev, g, R, W, B)
        return sids

    for R, W, B in SHAPES:
        sids = fresh(R, W, B)
        plan = S.scatter_plan(W, table.data_ptr(), vals.data_ptr())
        forced = "lanes" if plan.route.startswith("bulk") else "bulk"
        runs = {label: (lambda f=f: f(table, sids, vals)) for label, f in fns.items()}
        runs[f"this {forced}"] = lambda: S.scatter_rows_set(table, sids, vals, _route=forced)
        runs["index_copy_"] = lambda: table.index_copy_(0, sids64, vals)
        flat = table.view(-1)[:B * W]
        runs["copy_"] = lambda: flat.copy_(vals.view(-1))
        for label, run in runs.items():
            if label != "copy_" and not bit_equal(table, sids64, vals, run):
                print(f"k5_ab: {label} disagrees with the plain version at R={R} W={W} "
                      f"B={B}", file=sys.stderr)
                return 1
        key = f"R={R} W={W} B={B}"
        bound, _ = C.rows_bound(B, W)
        times = {"route": plan.route, "plan": list(plan), "bound_ms": bound,
                 "resident_blocks": S.scatter_residency(W, plan)[0]}
        warm = R == R_USERS  # the narrow rows
        for label in order + [f"this {forced}", "index_copy_", "copy_"]:
            ms, call_ms = timed(f"{key} {label}", runs[label], flush)
            times.setdefault(label, []).append(ms)
            times.setdefault(f"{label} call_ms", []).append(call_ms)
        if warm:
            for label in order + [f"this {forced}", "index_copy_"]:
                times.setdefault(f"{label} warm", []).append(
                    timed(f"{key} {label}", runs[label], flush, warm=True)[0])
        best = min(times["this"])
        print(f"{key}: {plan}, bound {bound!r} ms, this at {100 * bound / best:.1f}% of it"
              + "".join(f", {label} {min(times[label]) / best:.4f}x this"
                        for label in list(others) + ["index_copy_"]))
        summary["shapes"][key] = times
        del flat, runs

    summary["pads"] = {}
    for R, W, B, K in PAD_SHAPES:  # kept rows, then the dedupe's pads
        fresh(R, W, B)
        kept = sids64[:K]
        ids = torch.cat([kept, torch.full((B - K,), 2**30, device=dev)]).to(torch.int32)
        runs = {label: (lambda f=f: f(table, ids, vals)) for label, f in fns.items()}
        runs["index_copy_ (kept rows)"] = lambda: table.index_copy_(0, kept, vals[:K])
        for label, run in runs.items():
            if not bit_equal(table, kept, vals[:K], run):
                print(f"k5_ab: {label} disagrees with the plain version at R={R} W={W} "
                      f"B={B} ({K} kept)", file=sys.stderr)
                return 1
        key = f"R={R} W={W} B={B} kept={K}"
        times = {"bound_ms": C.rows_bound(K, W)[0]}
        for label in order + ["index_copy_ (kept rows)"]:
            times.setdefault(label, []).append(timed(f"pads {key} {label}", runs[label],
                                                     flush)[0])
        print(f"pads {key}: " + ", ".join(f"{k} {min(v)!r} ms" for k, v in times.items()
                                           if k != "bound_ms"))
        summary["pads"][key] = times
        del runs, ids, kept

    for W in ALIGN_WIDTHS:  # partial-sector writes: K5, index_copy_ and copy_
        R, B = R_USERS, C.GATHER_B
        sids = fresh(R, W, B)
        key = f"R={R} W={W} B={B}"
        runs = {"this": lambda: S.scatter_rows_set(table, sids, vals),
                "this lanes4": lambda: S.scatter_rows_set(table, sids, vals, _route="lanes4"),
                "index_copy_": lambda: table.index_copy_(0, sids64, vals)}
        for label, run in runs.items():
            if not bit_equal(table, sids64, vals, run):
                print(f"k5_ab: {label} disagrees at {key}", file=sys.stderr)
                return 1
        flat = table.view(-1)[:B * W]
        runs["copy_"] = lambda: flat.copy_(vals.view(-1))
        bound, _ = C.rows_bound(B, W)
        times = {"bound_ms": bound, "row_sectors": 4 * W / 32}
        for label, run in runs.items():
            ms = timed(f"align {key} {label}", run, flush)[0]
            times[label] = ms
            times[f"{label} bound_share"] = bound / ms
        print(f"align {key}: " + ", ".join(f"{k} {100 * times[f'{k} bound_share']:.1f}%"
                                          for k in runs))
        summary["alignment"][key] = times
        del flat, runs

    if not args.no_sweep:
        for W in THRESHOLD_WIDTHS:  # lanes or bulk
            R, B = R_USERS, C.GATHER_B
            sids = fresh(R, W, B)
            key = f"R={R} W={W} B={B}"
            times = {}
            for kind in ("lanes", "bulk") + (("bulk_lanes",) if W % 4 == 0 else ()):
                run = lambda kind=kind: S.scatter_rows_set(table, sids, vals,  # noqa: E731
                                                           _route=kind)
                if not bit_equal(table, sids64, vals, run):
                    print(f"k5_ab: {kind} disagrees at {key}", file=sys.stderr)
                    return 1
                times[kind] = timed(f"{key} {kind}", run, flush)[0]
            summary["threshold"][key] = times
        for R, W, B in ([(R_USERS, w, C.GATHER_B) for w in C.GATHER_NARROW + (384,)]
                        + [(R_ITEMS, w, 24_576) for w in (4484, 4355, 4996)]
                        + [(R_ACF, w, C.GATHER_B) for w in (769, 513, 25857)]):
            sids = fresh(R, W, B)
            base = S.scatter_plan(W, table.data_ptr(), vals.data_ptr())
            if base.route.startswith("lanes"):  # loads a lane
                top = 8 if base.route == "lanes16" else 16
                plans = [base._replace(param=u) for u in (2, 4, 8, 16)
                         if base.param // 2 <= u <= min(2 * base.param, top)
                         and u != base.param]
            else:  # stages, then other pieces (rows of more than one piece)
                plans = [base._replace(param=st) for st in (2, 4, 6, 8, 12)
                         if st != base.param]
                if 4 * W > 4096:
                    plans += [S.ScatterPlan(base.route, st, pc) for pc, st in (
                        (2048, 8), (4096, 4), (8192, 4), (8192, 6), (16384, 3))
                        if (pc, st) != (base.piece_bytes, base.param)]
                plans = [p for p in plans if S.bulk_smem(p) <= S.MAX_SMEM]
            key = f"R={R} W={W} B={B}"
            times = {}
            for plan in [base] + plans:
                run = lambda plan=plan: S.scatter_rows_set(table, sids, vals,  # noqa: E731
                                                           _route=plan)
                if not bit_equal(table, sids64, vals, run):
                    print(f"k5_ab: {plan} disagrees at {key}", file=sys.stderr)
                    return 1
                per_sm = S.scatter_residency(W, plan)[0]
                name = (f"{plan.route} param={plan.param} piece={plan.piece_bytes} "
                        f"blocks={per_sm}" + (" (default)" if plan == base else ""))
                times[name] = timed(f"{key} {tuple(plan)} ({per_sm} blocks an SM)", run,
                                    flush)[0]
            run = lambda: S.scatter_rows_set(table, sids, vals)  # noqa: E731
            times[f"default {tuple(base)} again"] = timed(f"{key} default again", run, flush)[0]
            summary["params"][key] = times
    table = sids64 = vals = None
    torch.cuda.empty_cache()

    # the wrappers' host cost: host us a call, call_ms at W=128, then
    # bench_scatter, each in turns
    sids = fresh(R_USERS, 128, 24_576)
    few, few_vals = sids[:16].clone(), vals[:16].clone()
    for label in order:
        for _ in range(200):
            fns[label](table, few, few_vals)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fns[label](table, few, few_vals)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / 2000 * 1e6
        print(f"host {label}: {us!r} us a call (16 rows of 128)")
        summary["host"].setdefault(f"{label} host_us", []).append(us)
    for label in order:
        _, call_ms = timed(f"host W=128 {label}", lambda: fns[label](table, sids, vals), flush)
        summary["host"].setdefault(f"{label} call_ms", []).append(call_ms)
    table = sids64 = vals = None
    torch.cuda.empty_cache()
    mods = {label: mod for label, (mod, _, _) in others.items()}
    mods["this"] = S
    for label in order:
        kernel_ms, torch_ms = mods[label].bench_scatter()
        print(f"bench_scatter {label}: kernel_ms={kernel_ms!r} torch_ms={torch_ms!r}")
        summary["host"].setdefault(f"{label} bench_scatter", []).append([kernel_ms, torch_ms])
        torch.cuda.empty_cache()
    summary["build_s"] = {"this": cuda_build.build_seconds.get("row_scatter"),
                          **{k: v[1] for k, v in others.items()}}
    summary["ptxas"] = {"this": cuda_build.ptxas_report(cuda_build.build_logs["row_scatter"]),
                        **{k: v[2] for k, v in others.items()}}
    text = json.dumps(summary)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "k5_ab.json").write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
