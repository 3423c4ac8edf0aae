"""K7 (``ops/csrc/edge_tower.cu``) of this tree against K7 of other
checkouts, in one process on one card: the f32 forward and backward of
every build bit-equal to this tree's on the same inputs (the JAX test
geometries, ties, k/255 edge maps, ragged tiles, the training step's shape
and the reference resolution), then timed with the L2 flushed in the order
others, this, this, others reversed at 8192 x 32x32 x 64 and 256 x 224x224
x 64, with this tree's bf16 kernels beside them.

    git archive <commit> | tar -x -C build/archive/parent
    python scripts_torch/k7_ab.py --other build/archive/parent

Prints each build's ptxas registers and spills, one line per timing and a
JSON summary last; the times are torch.profiler's kernel durations of
``chip_smoke.kernel_times``."""

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
from fashionvisualexpl_tpu_torch.ops import cuda_build  # noqa: E402
from fashionvisualexpl_tpu_torch.ops import edge_tower as E  # noqa: E402

CHECKED = ((5, 8, 16, 4), (8, 6, 10, 3), (3, 12, 8, 8), (4, 10, 12, 300), (5, 34, 36, 130),
           (3, 18, 200, 100), (64, 32, 32, 64), (2, 224, 224, 64))
OUT = ROOT / "build" / "k7_ab"


def build_all(jobs):
    """{label: (library, build seconds, ptxas report)} for jobs of (label,
    source), each built with this tree's flags, all nvcc processes started
    together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for n, (label, src) in enumerate(jobs):
        out = OUT / f"libedge_tower_{n}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(src)]
        procs.append((label, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter()))
    libs = {}
    for label, out, proc, t0 in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0  # an upper bound: waited in order
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        lib = E.type_entries(ctypes.CDLL(str(out)), ("",) if label != "this" else ("", "_bf16"))
        libs[label] = (lib, seconds, cuda_build.ptxas_report(log))
    return libs


def use(lib):
    """Points ``ops/edge_tower.py``'s wrappers at ``lib`` (its grid, which
    depends on the build's registers, asked anew)."""
    E._library = lambda: lib
    E._resident_blocks.cache_clear()


def fwd(lib, x, w, b):
    use(lib)
    return E.edge_tower_fwd(x, w, b)


def bwd(lib, x, w, b, dout):
    use(lib)
    dw, db = E.edge_tower_bwd(x, w, b, dout)
    return torch.cat([dw.reshape(-1), db])


def inputs(B, H, W, Cn, seed, value=None, edges=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if value is not None:
        x = torch.full((B, H, W, 1), value, device="cuda")
    elif edges:
        k = torch.randint(1, 256, (B, H, W, 1), device="cuda", generator=g)
        keep = torch.rand(B, H, W, 1, device="cuda", generator=g) < 0.15
        x = torch.where(keep, k, 0).float() / 255
    else:
        x = torch.rand(B, H, W, 1, device="cuda", generator=g)
    w = torch.randn(5, 5, 1, Cn, device="cuda", generator=g) * 0.1
    b = torch.randn(Cn, device="cuda", generator=g) * 0.1
    return x, w, b, torch.randn(B, Cn, device="cuda", generator=g)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, nargs="*", default=[],
                    help="checkouts to compare with")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_ab: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {C.card_line()}")
    rel = Path("fashionvisualexpl_tpu_torch") / "ops" / "csrc" / "edge_tower.cu"
    libs = build_all([(str(c), c / rel) for c in args.other] + [("this", ROOT / rel)])
    for label, (_, seconds, report) in libs.items():
        print(f"build {label}: {seconds!r} s")
        for row in report:
            print(f"  ptxas {label}: {row}")
    this = libs["this"][0]
    others = [str(c) for c in args.other]

    cases = [(f"{B}x{H}x{W}x{Cn}", inputs(B, H, W, Cn, seed=B + Cn)) for B, H, W, Cn in CHECKED]
    cases += [(f"16x32x32x64 constant {v}", inputs(16, 32, 32, 64, 1, value=v)) for v in (0.5, 0.0)]
    cases += [("64x32x32x64 edge maps", inputs(64, 32, 32, 64, 2, edges=True))]
    for label, (x, w, b, dout) in cases:
        want_f, want_b = fwd(this, x, w, b), bwd(this, x, w, b, dout)
        for o in others:
            lib = libs[o][0]
            if not (torch.equal(fwd(lib, x, w, b), want_f)
                    and torch.equal(bwd(lib, x, w, b, dout), want_b)):
                print(f"k7_ab: f32 kernels of {o} and this differ at {label}", file=sys.stderr)
                return 1
        print(f"f32 bit-equal {label}: this and {others} ok")

    flush = torch.empty(64 * 2**20 // 4, device="cuda")
    order = others + ["this", "this"] + others[::-1]
    summary = {}
    for B, H, W, Cn in C.TOWER_TIMED:
        x, w, b, dout = inputs(B, H, W, Cn, seed=7)
        xb = x.bfloat16()
        times = {}
        for label in order:
            lib = libs[label][0]
            for name, run in (("fwd", lambda: fwd(lib, x, w, b)),
                              ("bwd", lambda: bwd(lib, x, w, b, dout))):
                ms, _, _ = C.kernel_times(torch, f"{name} {label}", run, args.iters, flush)
                times.setdefault(f"{name} f32 {label}", []).append(ms)
                print(f"time {B}x{H}x{W}x{Cn} {name} f32 {label}: {ms!r} ms")
        for name, run in (("fwd", lambda: fwd(this, xb, w, b)),
                          ("bwd", lambda: bwd(this, xb, w, b, dout))):
            ms, _, _ = C.kernel_times(torch, f"{name} bf16", run, args.iters, flush)
            times[f"{name} bf16 this"] = [ms]
            print(f"time {B}x{H}x{W}x{Cn} {name} bf16 this: {ms!r} ms")
        summary[f"{B}x{H}x{W}x{Cn}"] = times
    print(f"card: {C.card_line()}")
    print(json.dumps({"k7_ab": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
