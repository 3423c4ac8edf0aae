"""Time K3 (``ops/csrc/segmax.cu``) of this tree against K3 of other
checkouts, in turns in one process on one card, with the L2 flushed
before each call:
at BPRMF's serving shape (Ip=1,048,576 items, D=128, B = 8 and 4096), at
VBPR's and GradFashion's (Ip=524,288, D=148, B = 8, 64, 1024 and 4096) and
at CompVBPR's (Ip=262,144, D=208, the same buckets), seg 32, bf16, in the
order others, this, this, others reversed;
``torch.matmul`` of the same operands once.
Every library's output is first held against the plain version
(``chip_smoke.K_ATOL`` / ``K_RTOL``).

    git archive <commit> | tar -x -C build/archive/parent
    python scripts_torch/k3_ab.py --other build/archive/parent

Prints each build's ptxas registers and spills for the segmax kernels, one
line per timing and a JSON summary last; the times are torch.profiler's
kernel durations of ``chip_smoke.kernel_times``.  Then the wrapper's host
cost: microseconds a call of ``segmax.segmax_scores`` against the same call
made as the wrapper made it before it skipped ``torch.cuda.device`` on the
current device and bound its C entry once (a tiny geometry, so that the
host sets the pace), in turns."""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from fashionvisualexpl_tpu_torch.ops import cuda_build, segmax  # noqa: E402

SHAPES = ((C.EMBED_K, 16 * C.ITEM_BLOCK, (8, 4096)),
          (C.VIS_D, 8 * C.ITEM_BLOCK, (8, 64, 1024, 4096)),
          (C.COMP_D, -(-C.COMP_I // C.ITEM_BLOCK) * C.ITEM_BLOCK, (8, 64, 1024, 4096)))
OUT = ROOT / "build" / "k3_ab"


def build_all(jobs):
    """{label: (fvx_segmax_bf16, takes a route pointer, build seconds,
    ptxas report, warning lines)} for jobs of (label, source), each built
    with this tree's flags, all nvcc processes started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for n, (label, src) in enumerate(jobs):
        out = OUT / f"libsegmax_{n}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(src)]
        procs.append((label, src, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter()))
    libs = {}
    for label, src, out, proc, t0 in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0  # an upper bound: waited in order
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        fn = ctypes.CDLL(str(out)).fvx_segmax_bf16
        routed = "int* route" in src.read_text()
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
                       + [ctypes.c_void_p] * (2 if routed else 1))
        fn.restype = ctypes.c_int
        libs[label] = (fn, routed, seconds, cuda_build.ptxas_report(log),
                       [line.strip() for line in log.splitlines() if "warning" in line])
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, nargs="*", default=[],
                    help="checkouts to compare with")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_ab: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {C.card_line()}")
    rel = Path("fashionvisualexpl_tpu_torch") / "ops" / "csrc" / "segmax.cu"
    libs = build_all([(str(c), c / rel) for c in args.other] + [("this", ROOT / rel)])
    for label, (_, _, seconds, report, warnings) in libs.items():
        print(f"build {label}: {seconds!r} s")
        for row in report:
            print(f"  ptxas {label}: {row}")
        for line in warnings:
            print(f"  nvcc {label}: {line}")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(64 * 2**20 // 4, device=dev)
    summary = {}
    for D, Ip, buckets in SHAPES:
        for B in buckets:
            uf = (torch.randn(B, D, device=dev, generator=g) * (3.0 / D**0.5)).bfloat16()
            iv = torch.randn(Ip, D, device=dev, generator=g).bfloat16()
            ib = torch.randn(Ip, device=dev, generator=g) * 0.1
            want = segmax.segmax_scores_reference(uf, iv, ib, C.SEG)
            out = torch.empty_like(want)
            route = ctypes.c_int(-1)

            def call(fn, routed, out=out, uf=uf, iv=iv, ib=ib, B=B, D=D, Ip=Ip):
                extra = (ctypes.byref(route),) if routed else ()
                rc = fn(uf.data_ptr(), iv.data_ptr(), ib.data_ptr(), out.data_ptr(),
                        B, Ip, D, C.SEG, torch.cuda.current_stream().cuda_stream, *extra)
                if rc:
                    raise RuntimeError(f"segmax launch failed: cudaError {rc}")

            runs = {label: (lambda f=fn, r=routed: call(f, r))
                    for label, (fn, routed, *_) in libs.items()}
            for label, run in runs.items():
                run()
                torch.cuda.synchronize()
                worst = 0.0
                for lo in range(0, B, 512):  # in row blocks: [4096, 1M] f32 is 17 GB
                    got, ref = out[lo:lo + 512], want[lo:lo + 512]
                    err = (got - ref).abs()
                    if not bool((err <= C.K_ATOL + C.K_RTOL * ref.abs()).all()):
                        print(f"k3_ab: {label} disagrees with the plain version at "
                              f"D={D} B={B}", file=sys.stderr)
                        return 1
                    worst = max(worst, float(err.max()))
                taken = f" route {segmax.ROUTES[route.value]}" if libs[label][1] else ""
                print(f"D={D} B={B} {label}:{taken} max_abs_err={worst!r}")
            others = [k for k in runs if k != "this"]
            times = {}
            for label in others + ["this", "this"] + others[::-1]:
                ms, _, _ = C.kernel_times(torch, f"segmax {label} D={D} B={B}", runs[label],
                                          args.iters, flush)
                times.setdefault(label, []).append(ms)
                print(f"D={D} B={B} {label}: {ms!r} ms")
            lib, _, _ = C.kernel_times(torch, f"matmul D={D} B={B}",
                                       lambda: torch.matmul(uf, iv.T), args.iters, flush)
            times["torch.matmul"] = [lib]
            print(f"D={D} B={B} torch.matmul: {lib!r} ms")
            summary[f"D{D}_B{B}"] = times
            del uf, iv, ib, want, out
            torch.cuda.empty_cache()
    wrapper = wrapper_us(dev, g)
    print(f"wrapper host us a call (B=8 D={C.COMP_D} Ip=2048): {wrapper}")
    print(json.dumps({"card": C.card_line(), "k3_ab": summary, "wrapper_us": wrapper,
                      "build_s": {k: v[2] for k, v in libs.items()}}))
    return 0


def wrapper_us(dev, g, calls=2000, rounds=2):
    """{"this": [...], "before": [...]}: host microseconds a call, this
    tree's ``segmax_scores`` and the former wrapper's body (entry bound on
    every call, the launch inside ``torch.cuda.device``), in turns."""
    from fashionvisualexpl_tpu_torch.ops.cuda_build import load_library

    B, D, Ip = 8, C.COMP_D, 2048
    uf = torch.randn(B, D, device=dev, generator=g).bfloat16()
    iv = torch.randn(Ip, D, device=dev, generator=g).bfloat16()
    ib = torch.randn(Ip, device=dev, generator=g)

    def before():
        segmax._check(uf, iv, ib, C.SEG)
        fn = load_library("segmax").fvx_segmax_bf16
        fn.argtypes = segmax._LAUNCH_ARGS
        fn.restype = ctypes.c_int
        out = torch.empty((B, Ip // C.SEG), dtype=torch.float32, device=dev)
        route = ctypes.c_int(-1)
        with torch.cuda.device(uf.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(uf.data_ptr(), iv.data_ptr(), ib.data_ptr(), out.data_ptr(), B, Ip, D,
                    C.SEG, stream, ctypes.byref(route))
        if rc:
            raise RuntimeError(f"segmax launch failed: cudaError {rc}")
        return out

    runs = {"this": lambda: segmax.segmax_scores(uf, iv, ib, C.SEG), "before": before}
    if not torch.equal(runs["this"](), runs["before"]()):
        raise RuntimeError("the two wrappers disagree")
    out = {}
    for label in ["this", "before"] * rounds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            runs[label]()
        torch.cuda.synchronize()
        out.setdefault(label, []).append(1e6 * (time.perf_counter() - t0) / calls)
    return out


if __name__ == "__main__":
    sys.exit(main())
