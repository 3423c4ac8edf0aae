"""Time K4 (``ops/csrc/gather.cu`` behind ``ops/gather.py::gather_rows``)
of this tree against K4 of other checkouts and ``torch.index_select``, in
turns in one process on one card, with the L2 flushed before each call:
at every width the packed paths gather, at B=16,384 (385, 388, 257, 259,
193, 195, 445, 297 over R=1M; 4355, 4867, 4484, 4996 over R=500k) and at
B=24,576 (128 over R=1M; 4484, 4996 over R=500k), in the order others,
this, this, others reversed.  This tree's K4 also runs with its other kind
of route forced (the lanes at wide rows, the bulk copies at narrow ones),
the narrow widths are timed warm too (their rows left in the L2 by the
call before), and each shape's bytes are also copied by one contiguous
``Tensor.copy_`` (the card's copy rate, a ceiling no gather passes).  Then
the width threshold between the two kinds (rows of 1 ... 8 KB, 16-byte
rows and rows one float wider, cold and warm), each kernel parameter in
turn (loads a lane; stages and piece bytes), the wrappers' host cost (host
microseconds a call over 2000 calls of 16 rows, ``call_ms`` at W=128) and
``bench_gather()`` of each tree.  Every output is first held bit for bit
against the plain version.

    git archive <commit> | tar -x -C build/archive/parent
    python scripts_torch/k4_ab.py --other build/archive/parent

Prints each build's ptxas registers and spills, one line per timing and a
JSON summary last, also written to ``build/k4_ab/k4_ab.json``; the times
are torch.profiler's kernel durations of ``chip_smoke.kernel_times``."""

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from fashionvisualexpl_tpu_torch.ops import cuda_build  # noqa: E402
from fashionvisualexpl_tpu_torch.ops import gather as G  # noqa: E402

OUT = ROOT / "build" / "k4_ab"
R_USERS, R_ITEMS = C.ROW_TABLE, C.EVAL_I
SHAPES = ([(R_USERS, w, C.GATHER_B) for w in C.GATHER_NARROW]
          + [(R_ITEMS, w, C.GATHER_B) for w in C.GATHER_WIDE]
          + [(R_USERS, 128, 24_576), (R_ITEMS, 4484, 24_576), (R_ITEMS, 4996, 24_576)])
THRESHOLD_WIDTHS = (256, 384, 512, 768, 1024, 1536, 2048)
ITERS = 20


def build_other(jobs, name="gather", out_dir=OUT):
    """{label: (module, build seconds, ptxas report)} for jobs of (label,
    checkout): each checkout's ops/csrc/<name>.cu built with this tree's
    flags into ``out_dir`` (this tree's own by ``cuda_build``), all nvcc
    processes started together; its ops/<name>.py loaded under its own name
    and bound to that library."""
    out_dir.mkdir(parents=True, exist_ok=True)
    rel = Path("fashionvisualexpl_tpu_torch") / "ops"
    procs = []
    for n, (label, root) in enumerate(jobs):
        so = out_dir / f"lib{name}_{n}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
               str(root / rel / "csrc" / f"{name}.cu")]
        procs.append((n, label, root, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter()))
    cuda_build.build([name])
    out = {}
    for n, label, root, so, proc, t0 in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0  # an upper bound: waited in order
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        spec = importlib.util.spec_from_file_location(f"{name}_other_{n}",
                                                      root / rel / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        lib = ctypes.CDLL(str(so))
        real = cuda_build.load_library
        cuda_build.load_library = lambda name, lib=lib: lib
        try:  # the module's own typing of its entries, on the other library
            bind = getattr(mod, "_bind", None) or mod._library
            bound = bind()
        finally:
            cuda_build.load_library = real
        if hasattr(mod, "_library"):
            mod._library = lambda bound=bound: bound
        out[label] = (mod, seconds, cuda_build.ptxas_report(log))
    return out


def bit_equal(table, ids, got):
    return torch.equal(got.view(torch.int32),
                       G.gather_rows_reference(table, ids).view(torch.int32))


def timed(label, fn, flush, warm=False):
    ms, call_ms, _ = C.kernel_times(torch, label, fn, ITERS, flush[:256] if warm else flush)
    print(f"{label}{' warm' if warm else ''}: {ms!r} ms (call_ms {call_ms!r})")
    return ms, call_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, nargs="*", default=[],
                    help="checkouts to compare with")
    ap.add_argument("--no-sweep", action="store_true",
                    help="skip the threshold and parameter sweeps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_ab: no CUDA card", file=sys.stderr)
        return 2
    card = C.card_line()
    print(f"card: {card}")
    others = build_other([(str(c), c) for c in args.other])
    print(f"build this: {cuda_build.build_seconds.get('gather')!r} s")
    for row in cuda_build.ptxas_report(cuda_build.build_logs["gather"]):
        print(f"  ptxas this: {row}")
    for label, (_, seconds, report) in others.items():
        print(f"build {label}: {seconds!r} s")
        for row in report:
            print(f"  ptxas {label}: {row}")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    flush = torch.empty(64 * 2**20 // 4, device=dev)
    summary = {"card": card, "shapes": {}, "threshold": {}, "params": {}, "host": {}}
    order = list(others) + ["this", "this"] + list(others)[::-1]
    fns = {label: mod.gather_rows for label, (mod, _, _) in others.items()}
    fns["this"] = G.gather_rows
    table = None
    for R, W, B in SHAPES:
        del table
        torch.cuda.empty_cache()
        table = torch.randn(R, W, device=dev, generator=g)
        ids = torch.randint(0, R, (B,), device=dev, generator=g, dtype=torch.int32)
        plan = G.gather_plan(W, table.data_ptr(), table.data_ptr())
        forced = "lanes" if plan.route.startswith("bulk") else "bulk"
        runs = {label: (lambda f=f: f(table, ids)) for label, f in fns.items()}
        runs[f"this {forced}"] = lambda: G.gather_rows(table, ids, _route=forced)
        runs["index_select"] = lambda: torch.index_select(table, 0, ids)
        flat, dst = table.view(-1)[:B * W], torch.empty(B * W, device=dev)
        runs["copy_"] = lambda: dst.copy_(flat)
        for label, run in runs.items():
            if label not in ("index_select", "copy_") and not bit_equal(table, ids, run()):
                print(f"k4_ab: {label} disagrees with the plain version at R={R} W={W} "
                      f"B={B}", file=sys.stderr)
                return 1
        key = f"R={R} W={W} B={B}"
        bound, _ = C.rows_bound(B, W)
        times = {"route": plan.route, "plan": list(plan), "bound_ms": bound}
        warm = 4 * W < G.BULK_MIN_BYTES
        for label in order + [f"this {forced}", "index_select", "copy_"]:
            ms, call_ms = timed(f"{key} {label}", runs[label], flush)
            times.setdefault(label, []).append(ms)
            times.setdefault(f"{label} call_ms", []).append(call_ms)
        if warm:
            for label in order + [f"this {forced}", "index_select"]:
                times.setdefault(f"{label} warm", []).append(
                    timed(f"{key} {label}", runs[label], flush, warm=True)[0])
        print(f"{key}: {plan}, bound {bound!r} ms")
        summary["shapes"][key] = times
        del flat, dst

    if not args.no_sweep:
        for W in [w + odd for w in THRESHOLD_WIDTHS for odd in (0, 1)]:  # lanes or bulk
            R, B = R_USERS, C.GATHER_B
            del table
            torch.cuda.empty_cache()
            table = torch.randn(R, W, device=dev, generator=g)
            ids = torch.randint(0, R, (B,), device=dev, generator=g, dtype=torch.int32)
            key = f"R={R} W={W} B={B}"
            times = {}
            for kind in ("lanes", "bulk") + (("bulk_lanes",) if W % 4 == 0 else ()):
                run = lambda kind=kind: G.gather_rows(table, ids, _route=kind)  # noqa: E731
                if not bit_equal(table, ids, run()):
                    print(f"k4_ab: {kind} disagrees at {key}", file=sys.stderr)
                    return 1
                times[kind] = timed(f"{key} {kind}", run, flush)[0]
                times[f"{kind} warm"] = timed(f"{key} {kind}", run, flush, warm=True)[0]
            summary["threshold"][key] = times
        for R, W in ([(R_USERS, w) for w in C.GATHER_NARROW + (128,)]
                     + [(R_ITEMS, 4484), (R_ITEMS, 4355), (R_ITEMS, 4996)]):
            B = C.GATHER_B
            del table
            torch.cuda.empty_cache()
            table = torch.randn(R, W, device=dev, generator=g)
            ids = torch.randint(0, R, (B,), device=dev, generator=g, dtype=torch.int32)
            base = G.gather_plan(W, table.data_ptr(), table.data_ptr())
            if base.route.startswith("lanes"):  # loads a lane
                top = 8 if base.route == "lanes16" else 16
                plans = [base._replace(param=u) for u in (2, 4, 8, 16)
                         if base.param // 2 <= u <= min(2 * base.param, top)]
            elif base.route == "bulk_store":
                plans = [base._replace(param=st) for st in (6, 10, 12)] + [
                    G.GatherPlan(base.route, st, 4096) for st in (8, 12)]
            else:
                plans = [G.GatherPlan(base.route, st, pc) for pc, st in (
                    (4096, 6), (6016, 4), (8192, 4), (8192, 6))]
            key = f"R={R} W={W} B={B}"
            times = {}
            for plan in plans:
                run = lambda plan=plan: G.gather_rows(table, ids, _route=plan)  # noqa: E731
                if not bit_equal(table, ids, run()):
                    print(f"k4_ab: {plan} disagrees at {key}", file=sys.stderr)
                    return 1
                per_sm = G.gather_residency(W, plan)[0]
                name = (f"{plan.route} param={plan.param} piece={plan.piece_bytes} "
                        f"blocks={per_sm}")
                times[name] = timed(f"{key} {tuple(plan)} ({per_sm} blocks an SM)", run, flush)[0]
                if base.route.startswith("lanes"):
                    times[f"{name} warm"] = timed(f"{key} {tuple(plan)}", run, flush, warm=True)[0]
            run = lambda: G.gather_rows(table, ids)  # noqa: E731
            times[f"default {tuple(base)} again"] = timed(f"{key} default again", run, flush)[0]
            summary["params"][key] = times
    del table
    torch.cuda.empty_cache()

    # the wrappers' host cost: host us a call, call_ms at W=128, then
    # bench_gather, each in turns
    table = torch.randn(R_USERS, 128, device=dev, generator=g)
    ids = torch.randint(0, R_USERS, (24_576,), device=dev, generator=g, dtype=torch.int32)
    few = ids[:16].clone()
    for label in order:
        for _ in range(200):
            fns[label](table, few)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fns[label](table, few)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / 2000 * 1e6
        print(f"host {label}: {us!r} us a call (16 rows of 128)")
        summary["host"].setdefault(f"{label} host_us", []).append(us)
    for label in order:
        _, call_ms = timed(f"host W=128 {label}", lambda: fns[label](table, ids), flush)
        summary["host"].setdefault(f"{label} call_ms", []).append(call_ms)
    del table
    torch.cuda.empty_cache()
    mods = {label: mod for label, (mod, _, _) in others.items()}
    mods["this"] = G
    for label in order:
        kernel_ms, torch_ms = mods[label].bench_gather()
        print(f"bench_gather {label}: kernel_ms={kernel_ms!r} torch_ms={torch_ms!r}")
        summary["host"].setdefault(f"{label} bench_gather", []).append([kernel_ms, torch_ms])
        torch.cuda.empty_cache()
    summary["build_s"] = {"this": cuda_build.build_seconds.get("gather"),
                          **{k: v[1] for k, v in others.items()}}
    summary["ptxas"] = {"this": cuda_build.ptxas_report(cuda_build.build_logs["gather"]),
                        **{k: v[2] for k, v in others.items()}}
    text = json.dumps(summary)
    (OUT / "k4_ab.json").write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
