"""K7 (``ops/csrc/edge_tower.cu`` and its wrapper ``ops/edge_tower.py``) of
this tree against K7 of other checkouts, in one process on one card, each
build through its own wrapper:

- the f32 forward and backward of every build bit-equal to this tree's on
  the same inputs (the JAX test geometries, ties, k/255 edge maps, ragged
  tiles, the training step's shape and the reference resolution);
- the bf16 forward and backward of every build within the tower tolerance
  of this tree's (``chip_smoke.py``'s TOWER_RTOL ... and TOWER_GRAD_*: the
  bf16 forwards sum the mean in another order; the backwards may decide
  near ties apart by an f32 rounding, as the kernel and its plain version
  may);
- timed with the L2 flushed in the order others, this, this, others at
  8192 x 32x32 x 64, 256 x 224x224 x 64 and 128 x 32x32 x 64 (the
  evaluator's block of --batch_eval 128): f32 and bf16, forward and
  backward;
- the wrappers' host cost: host microseconds a call at 1 x 8x8 x 4, the
  builds in turns over HOST_ROUNDS rounds, each build's median;
- with ``--steps``, in the same order, the bf16 AttentiveFashion paths
  through each build's K7 (its ``edge_tower_fwd`` / ``edge_tower_bwd`` in
  this tree's autograd Function): the generic and packed steps at 1M x
  200k, 32x32, batch 8192, ``precompute_eval`` at --batch_eval 128 over
  the 200k items, and the streamed step at 224x224, batch 256 (ms a step
  or an evaluation, idle share, K7 share; ``chip_smoke.py``'s phases cut
  to STEPS steps).

    git archive <commit> | tar -x -C build/archive/parent
    python scripts_torch/k7_ab.py --other build/archive/parent [--steps]

Prints each build's ptxas registers and spills, one line per timing and a
JSON summary last; the kernel times are torch.profiler's kernel durations
of ``chip_smoke.kernel_times``.  Exits 1 if a check failed (after the
timings)."""

import argparse
import json
import statistics
import sys
import time
import types
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
           (3, 18, 200, 100), (1, 32, 32, 300), (64, 32, 32, 64), (2, 224, 224, 64),
           (128, 32, 32, 64))
TIMED = C.TOWER_TIMED + (C.TOWER_EVAL,)
OUT = ROOT / "build" / "k7_ab"
HOST_CALLS, HOST_ROUNDS = 1000, 6
STEPS = 10


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


def excess(got, want, rtol, atol):
    """max(|got - want| - (atol + rtol |want|)): > 0 where they part."""
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def steps_phase(mods, order):
    """The bf16 AttentiveFashion paths through each build's K7, in ``order``
    (module docstring): {label: [one row a turn]}."""
    import numpy as np

    from fashionvisualexpl_tpu_torch.core.config import TrainConfig
    from fashionvisualexpl_tpu_torch.data.features import synthetic_features
    from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
    from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion
    from fashionvisualexpl_tpu_torch.ops import gather as G
    from fashionvisualexpl_tpu_torch.ops import row_scatter as S
    from fashionvisualexpl_tpu_torch.train.streamed import (
        STEP_SEED_BASE,
        ArrayFeatureStore,
        StreamedTrainer,
    )
    from fashionvisualexpl_tpu_torch.train.trainer import Trainer, fold_in

    n = STEPS
    start = C.phase_start(torch)
    pairs, items, counts = C.make_scaled_arrays(C.AF_U, C.AF_I, C.AF_POS, seed=0)
    data = types.SimpleNamespace(
        num_items=C.AF_I, num_train=len(pairs), train_pairs=pairs, padded_pos=items,
        pos_counts=counts, steps_per_epoch=lambda b: len(pairs) // b)
    model = C.af_model(torch, np, "auto", seed=4, compute_dtype="bfloat16")
    trainers = {}
    for path in ("generic", "packed"):
        tr = Trainer(model, data, TrainConfig(batch_size=C.AF_B, lr=C.AF_LR, reg=C.AF_REG,
                                              train_path=path))
        state, frozen = tr.init_state()
        trainers[path] = dict(tr=tr, state=state, frozen=frozen,
                              tabs=(tr._train_pairs, tr._padded_pos, tr._pos_counts))

    C.SAF_DIR.mkdir(parents=True, exist_ok=True)
    stack = C.SAF_DIR / "edges_stack.npy"
    C.write_edge_stack(np, stack, C.SAF_I, C.SAF_HW, seed=2)
    edges = np.load(str(stack), mmap_mode="r")
    store = ArrayFeatureStore(synthetic_features(C.SAF_I, 512, seed=1), edges,
                              synthetic_features(C.SAF_I, 100, seed=3))
    spairs, sitems, scounts = C.make_scaled_arrays(C.SAF_U, C.SAF_I, C.SAF_POS, seed=0)
    sdata = types.SimpleNamespace(
        num_items=C.SAF_I, num_train=len(spairs), train_pairs=spairs, padded_pos=sitems,
        pos_counts=scounts, steps_per_epoch=lambda b: len(spairs) // b)
    host = AttentiveFashion(
        C.SAF_U, C.SAF_I, store.color, edges, store.cls, embed_k=C.EMBED_K,
        attention_layers=(64, 1), encoder_hidden=256, dropout_rate=0.5, conv_filters=64,
        batch_eval=C.SAF_BATCH_EVAL, host_features=True, compute_dtype="bfloat16",
        generator=torch.Generator(device="cuda").manual_seed(4))
    strainer = StreamedTrainer(host, sdata, TrainConfig(batch_size=C.SAF_B, lr=C.AF_LR,
                                                        reg=C.AF_REG),
                               store, prefetch_depth=C.SAF_DEPTH)
    sstate = {"s": strainer.init_state()[0]}
    stabs = (strainer._train_pairs, strainer._padded_pos, strainer._pos_counts)

    def srun(tr):
        rngs = [torch.Generator(device="cuda").manual_seed(fold_in(2, STEP_SEED_BASE + s))
                for s in range(tr[0].shape[0])]
        sstate["s"], loss = strainer.run_streamed_steps(sstate["s"], tr, store, rngs)
        return loss

    k7 = {"edge_tower_fwd_bf16": 2 * n, "edge_tower_bwd_bf16": 2 * n, "edge_tower_fwd": 0,
          "edge_tower_bwd": 0}
    orig = (E.edge_tower_fwd, E.edge_tower_bwd)
    out = {}
    for turn, label in enumerate(order):
        m = mods[label]
        E.edge_tower_fwd, E.edge_tower_bwd = orig if m is E else (m.edge_tower_fwd,
                                                                   m.edge_tower_bwd)
        row = {}
        for path, t in trainers.items():
            packed = path == "packed"
            rows = (G, S) if packed else (None, None)
            triples = sample_triplets(2 + turn, *t["tabs"], C.AF_I, n + 1, C.AF_B)

            def run(tr, t=t, key=[300 + 100 * turn]):
                key[0] += 1
                t["state"], loss = t["tr"].run_steps(t["state"], t["frozen"], tr,
                                                     step_key=key[0])
                return loss

            want = dict(k7, **({"gather_rows": 4 * n, "scatter_rows_set": 2 * n}
                               if packed else {}))
            r = C.timed_steps(torch, np, f"{label} af bf16 {path}", run,
                              tuple(a[:1] for a in triples), tuple(a[1:] for a in triples), n,
                              start, (lambda rows=rows: C.zero_counts(E, *rows),
                                      lambda rows=rows: C.bf16_counts(E, *rows)),
                              want, lambda t=t: t["state"].params)
            r["profile"] = C.step_profile(torch, f"{label} af bf16 {path}", run, sample_triplets(
                50 + turn, *t["tabs"], C.AF_I, C.BF16_PROFILE_STEPS, C.AF_B),
                C.BF16_PROFILE_STEPS)
            row[path] = r
        row["precompute_eval"] = C.af_precompute_eval(torch, E, model, f"{label} af bf16")
        triples = sample_triplets(2 + turn, *stabs, C.SAF_I, n + 1, C.SAF_B)
        r = C.timed_steps(torch, np, f"{label} streamed bf16", srun,
                          tuple(a[:1] for a in triples), tuple(a[1:] for a in triples), n, start,
                          (lambda: C.zero_counts(E), lambda: C.bf16_counts(E)), k7,
                          lambda: sstate["s"].params)
        r["profile"] = C.step_profile(torch, f"{label} streamed bf16", srun, sample_triplets(
            50 + turn, *stabs, C.SAF_I, C.BF16_PROFILE_STEPS, C.SAF_B), C.BF16_PROFILE_STEPS)
        row["streamed"] = r
        for path in ("generic", "packed", "streamed"):
            p = row[path]["profile"]
            print(f"steps {label} {path}: {row[path]['ms_per_step']!r} ms a step, idle "
                  f"{p['idle_share']!r}, K7 {p['k7_share']!r}")
        pe = row["precompute_eval"]
        print(f"steps {label} precompute_eval: {pe['ms']!r} ms, idle "
              f"{pe['profile']['idle_share']!r}, K7 {pe['profile']['k7_share']!r}")
        out.setdefault(label, []).append(row)
    E.edge_tower_fwd, E.edge_tower_bwd = orig
    stack.unlink()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, nargs="*", default=[],
                    help="checkouts to compare with")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--steps", action="store_true",
                    help="also the bf16 AttentiveFashion paths through each build's K7")
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
    failures = []
    bf16_excess = {}
    for label, (x, w, b, dout) in cases:
        xb = x.bfloat16()
        want = (E.edge_tower_fwd(x, w, b), flat(*E.edge_tower_bwd(x, w, b, dout)))
        want_fb = E.edge_tower_fwd(xb, w, b)
        want_bb = flat(*E.edge_tower_bwd(xb, w, b, dout))
        s = flat(*E.edge_tower_gap_bf16_plain_backward(xb, w, b, dout.abs()))
        for o in others:
            m = mods[o]
            got = (m.edge_tower_fwd(x, w, b), flat(*m.edge_tower_bwd(x, w, b, dout)))
            if not all(torch.equal(u, v) for u, v in zip(got, want)):
                failures.append(f"the f32 kernels of {o} and this differ at {label}")
            ex = {"fwd": excess(m.edge_tower_fwd(xb, w, b), want_fb, C.TOWER_RTOL, C.TOWER_ATOL),
                  "bwd": excess(flat(*m.edge_tower_bwd(xb, w, b, dout)), want_bb,
                                C.TOWER_GRAD_RTOL, C.TOWER_GRAD_ATOL + C.TOWER_SUM_ATOL * s)}
            bf16_excess[f"{o} {label}"] = ex
            for k, v in ex.items():
                if v > 0:
                    failures.append(f"the bf16 {k} of {o} leaves the tower tolerance of this "
                                    f"tree's at {label} ({v!r})")
        print(f"f32 bit-equal, bf16 within tolerance {label}: this and {list(others)}: "
              f"{[bf16_excess[f'{o} {label}'] for o in others]}")

    flush = torch.empty(64 * 2**20 // 4, device="cuda")
    order = list(others) + ["this", "this"] + list(others)[::-1]
    summary = {"card": card, "times": {}, "host_us": {}, "bf16_excess": bf16_excess}
    for B, H, W, Cn in TIMED:
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
    if args.steps:
        summary["steps"] = steps_phase(mods, order)
    print(f"card: {card}")
    print(json.dumps({"k7_ab": summary}))
    for f in failures:
        print(f"k7_ab: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
