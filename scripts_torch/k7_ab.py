"""K7 (``ops/csrc/edge_tower.cu`` and its wrapper ``ops/edge_tower.py``) of
this tree against K7 of other checkouts, in one process on one card, each
build through its own wrapper:

- the f32 forward and backward and the bf16 forward of every build
  bit-equal to this tree's on the same inputs (the JAX test geometries,
  ties, k/255 edge maps, ragged tiles, the training step's shape and the
  reference resolution);
- the bf16 backward of every build within the tower tolerance of this
  tree's (``chip_smoke.py``'s TOWER_GRAD_*: the two may decide near ties
  apart by an f32 rounding, as the kernel and its plain version may);
- timed with the L2 flushed in the order others, this, this, others at
  8192 x 32x32 x 64 and 256 x 224x224 x 64: f32 and bf16, forward and
  backward;
- the wrappers' host cost: host microseconds a call at 1 x 8x8 x 4, the
  builds in turns over HOST_ROUNDS rounds, each build's median.

    git archive <commit> | tar -x -C build/archive/parent
    python scripts_torch/k7_ab.py --other build/archive/parent

Prints each build's ptxas registers and spills, one line per timing and a
JSON summary last; the times are torch.profiler's kernel durations of
``chip_smoke.kernel_times``."""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts_torch"))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from fashionvisualexpl_tpu_torch.ops import cuda_build  # noqa: E402
from fashionvisualexpl_tpu_torch.ops import edge_tower as E  # noqa: E402
from k4_ab import build_other  # noqa: E402

CHECKED = ((5, 8, 16, 4), (8, 6, 10, 3), (3, 12, 8, 8), (4, 10, 12, 300), (5, 34, 36, 130),
           (3, 18, 200, 100), (1, 32, 32, 300), (64, 32, 32, 64), (2, 224, 224, 64))
OUT = ROOT / "build" / "k7_ab"
HOST_CALLS, HOST_ROUNDS = 1000, 6


def flat(dw, db):
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


def host_us(run) -> float:
    """Host microseconds a call of ``run`` (the kernels are shorter)."""
    for _ in range(100):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / HOST_CALLS * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, nargs="*", default=[],
                    help="checkouts to compare with")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_ab: no CUDA card", file=sys.stderr)
        return 2
    card = C.card_line()
    print(f"card: {card}")
    others = build_other([(str(c), c) for c in args.other], "edge_tower", OUT)
    mods = {label: mod for label, (mod, _, _) in others.items()}
    mods["this"] = E
    print(f"build this: {cuda_build.build_seconds.get('edge_tower')!r} s")
    for row in cuda_build.ptxas_report(cuda_build.build_logs["edge_tower"]):
        print(f"  ptxas this: {row}")
    for label, (_, seconds, report) in others.items():
        print(f"build {label}: {seconds!r} s")
        for row in report:
            print(f"  ptxas {label}: {row}")

    cases = [(f"{B}x{H}x{W}x{Cn}", inputs(B, H, W, Cn, seed=B + Cn)) for B, H, W, Cn in CHECKED]
    cases += [(f"16x32x32x64 constant {v}", inputs(16, 32, 32, 64, 1, value=v)) for v in (0.5, 0.0)]
    cases += [("64x32x32x64 edge maps", inputs(64, 32, 32, 64, 2, edges=True))]
    bf16_excess = {}
    for label, (x, w, b, dout) in cases:
        xb = x.bfloat16()
        want = (E.edge_tower_fwd(x, w, b), flat(*E.edge_tower_bwd(x, w, b, dout)),
                E.edge_tower_fwd(xb, w, b))
        got_b = flat(*E.edge_tower_bwd(xb, w, b, dout))
        s = flat(*E.edge_tower_gap_bf16_plain_backward(xb, w, b, dout.abs()))
        tol = C.TOWER_GRAD_RTOL * got_b.abs() + C.TOWER_GRAD_ATOL + C.TOWER_SUM_ATOL * s
        for o in others:
            m = mods[o]
            got = (m.edge_tower_fwd(x, w, b), flat(*m.edge_tower_bwd(x, w, b, dout)),
                   m.edge_tower_fwd(xb, w, b))
            if not all(torch.equal(u, v) for u, v in zip(got, want)):
                print(f"k7_ab: f32 kernels or the bf16 forward of {o} and this differ at {label}",
                      file=sys.stderr)
                return 1
            excess = float(((flat(*m.edge_tower_bwd(xb, w, b, dout)) - got_b).abs() - tol).max())
            bf16_excess[f"{o} {label}"] = excess
            if excess > 0:
                print(f"k7_ab: the bf16 backward of {o} leaves the tower tolerance of this "
                      f"tree's at {label} ({excess!r})", file=sys.stderr)
                return 1
        print(f"f32 and bf16 forward bit-equal, bf16 backward within tolerance {label}: this "
              f"and {list(others)} ok")

    flush = torch.empty(64 * 2**20 // 4, device="cuda")
    order = list(others) + ["this", "this"] + list(others)[::-1]
    summary = {"card": card, "times": {}, "host_us": {}, "bf16_bwd_excess": bf16_excess}
    for B, H, W, Cn in C.TOWER_TIMED:
        x, w, b, dout = inputs(B, H, W, Cn, seed=7)
        xb = x.bfloat16()
        times = {}
        for label in order:
            m = mods[label]
            for name, run in (("fwd f32", lambda: m.edge_tower_fwd(x, w, b)),
                              ("bwd f32", lambda: m.edge_tower_bwd(x, w, b, dout)),
                              ("fwd bf16", lambda: m.edge_tower_fwd(xb, w, b)),
                              ("bwd bf16", lambda: m.edge_tower_bwd(xb, w, b, dout))):
                ms, _, _ = C.kernel_times(torch, f"{name} {label}", run, args.iters, flush)
                times.setdefault(f"{name} {label}", []).append(ms)
                print(f"time {B}x{H}x{W}x{Cn} {name} {label}: {ms!r} ms")
        summary["times"][f"{B}x{H}x{W}x{Cn}"] = times
        del x, xb, w, b, dout
        torch.cuda.empty_cache()

    x, w, b, dout = inputs(1, 8, 8, 4, seed=3)
    xb = x.bfloat16()
    for _ in range(HOST_ROUNDS):
        for label in list(others) + ["this"]:
            m = mods[label]
            for name, run in (("fwd f32", lambda: m.edge_tower_fwd(x, w, b)),
                              ("bwd f32", lambda: m.edge_tower_bwd(x, w, b, dout)),
                              ("fwd bf16", lambda: m.edge_tower_fwd(xb, w, b)),
                              ("bwd bf16", lambda: m.edge_tower_bwd(xb, w, b, dout))):
                summary["host_us"].setdefault(f"{name} {label}", []).append(host_us(run))
    for key, us in summary["host_us"].items():
        print(f"host {key}: median {statistics.median(us)!r} us a call (1 x 8x8 x 4) of {us!r}")
    print(f"card: {card}")
    print(json.dumps({"k7_ab": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
