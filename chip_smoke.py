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
   dtypes; D = 148, 152, 160 on the register and warpgroup kernels, 164,
   208 and 256 on the register and wide warpgroup kernels, 150 and 264 on
   ``segmax_mma_kernel``, each launch's route asserted; each
   kernel's ptxas registers and spills, and segmax.cu's build time, go
   into the ``kernels`` line), then its time, the plain
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
   engine, and the per-user metrics must be equal; then
   ``store_recommendation_attention`` over the first 4,096 users of the
   configuration (BPRMF K=128, 500k items, k=20, blocks of 128 users) with
   an attention function of a seed: the top-k through K3 (launches
   counted), the rows held against ``store_recommendation``'s dump and the
   weights against the function;
11. cli: ``train_rec.train`` in process (``--rec bprmf --streaming_eval
   --embed_k 128 --epochs 2 --verbose 1``) on a reference-layout dataset
   written here (4,096 users x 20k items, 20 interactions per user), then
   ``serve_rec.serve`` from its checkpoint for 64 users: K2 and K3 must
   launch, the dumps hold U x k rows, the metrics are finite and in [0, 1].

12. tower kernel, AttentiveFashion training and path (K7): see PERF.md;
13. row kernels: the row gather (K4) and the row scatter-set (K5) against
   their plain versions, bit for bit (compared as int32), at the JAX test
   geometries (out-of-range, negative and internally padded ids) and at the
   packed rows' widths (385, 388, 257, 259, 193, 195, 512) for 8192 and
   16384 rows of a 1M-row table of random bit patterns; then timed at the
   JAX benches' shapes beside their bounds, plain versions and
   ``torch.index_select`` / ``Tensor.index_copy_``, each on the route its
   plan names (``gather_plan`` / ``scatter_plan``); K4 also at 16,384 rows
   of the narrow widths of fp32 moments the packed paths gather (BPRMF's
   385 and 388, VBPR's and GradFashion's user rows 445) over 1M-row tables,
   cold and warm, each on the route its plan names (a lanes route),
   bit-equal and beside ``index_select``; ``bench_gather`` and
   ``bench_scatter`` once;
14. packed training: ``Trainer(train_path="packed")`` for BPRMF at the fast
   path's configuration (1M x 500k, K=128, batch 8192; fp32 moments,
   lazy_catchup).  3 steps on the card against the same 3 steps on CPU
   copies (the plain route), and again without catch-up and with bf16 and
   fp8 moments; one epoch of 200 steps (4 K4 + 2 K5 launches a step) with
   triples/s, ms per step and peak memory, K4's and K5's launches by route
   (K5's: each table's writes on the route its plan names); a profile of
   10 steps (K4's and K5's share of device time, the idle share).
   AttentiveFashion at its training configuration (1M x 200k): 2 steps
   against the CPU route at batch 1024 (the CPU's plain tower at 8192
   would take minutes), then 20 steps at batch 8192 through K4, K5 and K7;
14b. (run right after the packed BPRMF phase) the specialized packed
   steps (``train/packed.py``, 1-D tau arrays): BPRMF at the same
   configuration, 3 steps on the card against CPU copies and against the
   generic engine's 3 steps on the card from the same params (both within
   the packed route check, tau, pads and untouched rows bit-equal), then
   ``make_packed_epoch_fn`` and the generic engine's epoch, 200 steps each
   on the same arrays and seed, timed in turns (specialized, generic,
   generic, specialized), 4 K4 + 2 K5 launches a specialized step and
   their routes; VBPR and GradFashion at the CLI's widths over the same
   arrays (4096-wide features, GradFashion's 512-wide colors and families
   of 32), 3 steps on a 20k x 20k catalog, each on the card and on a CPU
   copy of the card's state before it (dense E, Bp, Ec, Ee within their
   summation slack), then 200-step epochs beside the
   generic engine's, the frozen features read by id in both;
15. packed CLI: ``train_rec --train_path packed`` on the CLI dataset, then
   ``serve_rec`` from its checkpoint;
16. VBPR's and GradFashion's shapes (the JAX CLI's default widths: K=128,
   embed_d=20, 4096-wide CNN and edge features, 512-wide color
   histograms; factored D=148): K3 checked at D=148 and 150 (B = 8, 100,
   4097, both dtypes) and timed at D=148 over a 500k catalog at the
   serving buckets, the route of each bucket asserted (the register kernel
   at B <= 64, the warpgroup kernel above); K2 checked bit-equal at D=148
   on quantized data (T = 1 and 3, W = 1 and 4 or more, users and items
   off the tiles) and timed at
   the evaluator's block (4096 x 500k); K4 and K5 bit-equal at the fused
   row widths (from ``packed_spec``, fp32 and bf16 moments) and timed at
   24,576 rows of a 500k-row table (both on a bulk route), K4 also at
   16,384 rows of the four item widths (4355, 4867, 4484, 4996); each
   timed phase with the L2 flushed;
17. VBPR at full width over the evaluation phase's 1M users x 500k items
   and its data: the packed route with the frozen columns fused (3 steps
   on the card against CPU copies, 20k x 20k), one packed epoch of 200
   steps (4 K4 + 2 K5 a step, the two item-row gathers on a bulk route)
   and a 10-step profile, 50 generic
   ``Trainer`` steps, a 200-step fast epoch, ``RecServer`` at B = 8, 64,
   1024, 4096 through K3 (64 users against a full-catalog fp32 oracle;
   its launches on the register and warpgroup kernels only),
   ``FactoredEvaluator``
   through K2 (2 * ceil(U / 4096) launches; weights on the 1/64 grid, the
   first user blocks equal through the bucketed engine);
18. the visual CLI on the CLI dataset with 4096-wide features:
   ``train_rec --rec vbpr`` (generic, then ``--train_path packed``),
   ``--rec grad_fashion`` with both grads dumps (a row of two finite
   attributions per positive), ``serve_rec`` for each (no K3 launch on
   ``segmax_mma_kernel``), and
   ``get_explanations`` on the best grads dump.  Phases 16-18 print their
   seconds;
19. ACF at the JAX CLI's default widths (K=128, attention (64, 1)) over
   7x7x512 spatial maps (S=49, C=512; 20.07 GB made on the card), 1M users
   x 200k items, P=20: the packed route on a 4096 x 4096 catalog (fp32,
   bf16, fp8 moments, the maps fused and read by id, 3 steps at batch 256,
   each on the card and on the CPU from the CPU route's state: losses,
   rows and moments within the route tolerances, the fused Fspat columns,
   tau and untouched rows bit-equal, the last step's extra rows stamped)
   and 3 generic ``Trainer`` steps likewise; the chunked profile (``pos_chunk`` 8) against the
   one-shot one within 2e-6; a packed epoch of 25 steps at batch 8192 (the
   maps read by id; 5 K4 + 2 K5 a step) and 10 fused steps at batch 2048
   (cut for memory), each with a 10-step profile; 10 generic steps;
   ``precompute_eval`` over 1M users and the test split through K2 (245
   launches); ``RecServer`` through K3 at the buckets, 64 users against a
   full-catalog fp32 oracle; ``train_rec --rec acf`` (generic, packed) and
   ``serve_rec`` on a 1024 x 1024 dataset with 7x7x512 ``.npy`` maps
   written here; K4 and K5 at ACF's item rows (769, 513 and, fused,
   25,857 floats over 200k rows, at 163,840 and 16,384 rows) and K5 at
   K4's narrow widths, each on the route its plan names, beside
   ``index_select`` / ``index_copy_`` and their bounds; the rows where K5
   trails ``index_copy_`` or reaches under half its bound are printed;
20. CompVBPR at the JAX CLI's default widths (K=128, d=20, semantic 4096,
   color 512, texture 1024, 32x32 edge images through the trainable CNN,
   every family at weight 0.25; factored D=208), 1M users x 200k items,
   P=20: the packed step (fp32 and fp8 moments) and the generic Trainer
   step on the card against the CPU on a 4096 x 4096 catalog (2 steps at
   batch 256, each from the CPU route's state, dropout masks shared); a
   packed epoch of 10 steps at batch 8192 (4 K4 + 2 K5 a step, the user
   rows 625 floats) and 5 generic steps, each with a 5-step profile (the
   idle share, K4's, K5's, the convolutions' and the GEMMs' shares, no
   TF32 kernel); ``FactoredEvaluator(counts_impl="kernel").evaluate``
   through K2 at D=208 (245 launches); ``RecServer`` through K3 at the
   buckets, every launch on the register kernel (B <= 64) or
   ``segmax_wgmma_wide_kernel``, 64 users against a full-catalog fp32
   oracle; K3 (with its D=208 instantiations' ptxas registers and spills)
   and K2 alone at D=208 and K4 and K5 at the
   user rows (625 and, at row_align 128, 640 floats over 1M rows, batch
   8192), each checked against its plain version and timed beside its
   bound and the library call; the CNN at 224x224 (B=256) against float64
   and timed forward and backward beside the f32 bound; ``train_rec --rec
   comp_vbpr`` at ``--edge_hw 224 224``: generic with the streaming
   evaluator on 512 users x 16,384 items, packed with the dense one and
   ``serve_rec`` from its checkpoint on 512 x 512, both written here;
21. (run right after the build) the native host data plane
   (``data/native.py``, built with ``g++`` on the card's host; its path and
   build seconds printed): ``read_split_tsv``
   natively and in Python on a 2,000,000-row split TSV written here (equal
   pairs, both timed), ``write_recs_tsv`` on 1M users x 20 (its ids
   parsed back equal) and, against the Python writer, on the first 100k
   of them (both dumps parsed back equal), each timed; the CLI phase's dumps
   (phase 11) go through the native writer, by its call counter;
22. the streamed trainer: AttentiveFashion at the JAX CLI's full width
   (K=128, attention (64, 1), hidden 256, 64 filters, dropout 0.5, 224x224
   edges, batch 256), ``host_features=True``, over 1M users x 32,768
   items, 20 positives a user; the edge stack a 6.58 GB ``.npy`` written
   here chunk by chunk (k/255 edge maps) and read as a memmap.  3 steps of
   ``run_streamed_steps`` against the resident ``Trainer.run_steps`` from
   one state with the same triples and step seeds, both on K7 (losses and
   params within the AttentiveFashion phase's route tolerances; the
   largest difference printed); ``precompute_eval`` in host blocks of 128
   against the resident one (rtol 1e-6, atol 1e-7), both timed; 50 steps
   through the prefetcher (depth 2) with ms a step, triples/s, peak
   memory against the resident model's, every batch's rows through the
   native gather (its counter); a 5-step profile (idle share, K7's share);
   one batch's host gather by the native gather, numpy ``src[ids]`` and
   ``torch.index_select`` on the memmapped tensor, and its copy to the
   card, each in GB/s (the page cache warm);
23. the streamed CLI: ``train_rec --rec attentive_fashion --streamed
   --edge_hw 224 224`` on a 1,024 x 1,024 dataset with 224x224 edge tiffs
   written here (the stack built by ``build_edge_stack_npy``), 2 epochs
   with dense evaluation: the JAX CLI's file set, ``--resume`` to a third
   epoch from its checkpoint, then ``serve_rec --streamed``.

24. (run last) multi-device: ranks of this
   script (``--mesh-rank``) sharing the one card over gloo, each forming
   its group with ``parallel/multihost.py::initialize_from_env``, after the
   parent built the kernels.  ``RecServer(mesh)`` over a (1, 2) mesh at
   phase 4's size and seeds (K3 on every rank; the ids of every bucket
   equal to one device's server on the same weights, B=64 to the fp32
   oracle; p50 per bucket, "2 ranks sharing one H100", not a multi-card
   figure); ``FactoredEvaluator(mesh, counts_impl="kernel")`` at phase
   10's size, on its Interactions pickled by the parent (K2 490 times on
   each rank; the metrics equal to phase 10's, the first block's per-user
   values to one device's); BPRMF at 1M x 500k, batch 8192,
   over a (2, 2) mesh, 3 generic steps and 3 packed steps with fp32 and
   with bf16 moments (4 K4 + 2 K5 launches a step on every rank), held
   against one device's steps from the same state and triples by
   ``route_check`` / ``packed_route_check``; ``torchrun --nproc_per_node=4
   ... train_rec --mesh_data 2 --mesh_model 2`` on a 4,096 x 20k dataset
   written as phase 11's, at batch 8192, against ``train_rec`` on one
   device with the same flags (the file set and, within
   ``tests/test_golden.py``'s tolerances, the metrics; ``serve_rec`` on one
   device from the mesh run's checkpoint equal to its best dump); one rank
   on nccl answering through the sharded server.  The train job also runs
   BPRMF's specialized sharded steps 3 times each: the sparse one
   (``make_fast_spmd_step``, 3 K6 sweeps a step on every rank) against one
   device's fast step with ``fused_adam=True`` (``route_check``), the
   packed one with 1-D tau (4 K4 + 2 K5 a step) against one device's
   ``make_packed_bprmf_step`` (``packed_route_check``).

26. (run after CompVBPR, before the vision phase) the bf16 towers
   (``compute_dtype="bfloat16"``): K7's bf16 forward and backward (the
   weights rounded to bf16, one exact bf16 piece a pixel, f32 sums)
   against their plain version ``edge_tower_gap_bf16_plain`` at the tower
   phase's geometries, ties and edge maps, at ragged tiles of odd counts
   and at the evaluator's block (128 x 32x32 x 64), with the f32 kernels'
   tolerances, two runs bit-equal, the
   float64 witness on one seed of edge maps (the bf16 backward's decisions
   replayed by the tensor cores' measured rounding, its near-tie band by
   the f32 chain), the tensor-core probes (``tensor_core_probes``: the
   measured rounding model against wgmma and mma.sync on crafted operands,
   the transposed tap-sum product against torch.matmul), the bf16
   forward's and backward's ptxas registers and spills (none), timed at
   8192 x 32x32 x 64, 256 x 224x224 x 64 and 128 x 32x32 x 64 beside the
   f32 kernels' times of phase 12, cuDNN's bf16 conv alone, the bound (the
   operations at the bf16 rate, or the bytes with 2-byte images) and the
   forward's issued tensor work; then in bf16
   AttentiveFashion's generic step at 1M x 200k (the bf16 kernels' main
   path: 2 + 2 bf16 launches a step, no f32 ones), its packed step, the
   streamed step at 256 x 224x224 from phase 22's stack and CompVBPR's
   packed and generic steps at phase 20's shape, each beside its f32
   figure of this run (AttentiveFashion's also in f32 on the same model
   just before and after) with a profile (idle share, K7's or the convs'
   share), peak memory and every param f32; AttentiveFashion's
   ``precompute_eval`` over the 200k items at --batch_eval 128 (one bf16
   forward a block: ms, launches, idle and K7 share); the bf16 CNN at 224x224
   (B=256) against the f32 CNN on the same weights and timed beside the
   bf16 bound; CompVBPR's generic step at 224x224, batch 1024, over 1M x
   32,768, in bf16 and in f32 on the same model; ``train_rec
   --compute_dtype bfloat16`` for ``attentive_fashion`` (``--edge_hw 32
   32``) and ``comp_vbpr`` (its default 224x224) on 2,048 x 2,048
   datasets, one epoch: the JAX CLI's file set.

25. (run before the multi-device phase) vision: ResNet-50 (``avg_pool``
   and ``spatial_features``), ResNet-152 (``avg_pool``) and VGG19 (``fc2``
   and ``block5_pool``) at 224x224 under ``fp32_math``, random weights from
   a seed, at B = 64 and 256 from preprocessed images made on the card: ms
   a batch, images/s, peak memory, the share of the f32 peak (operations
   counted from the layer shapes: 8.17, 23.02 and 39.26 GFLOP an image),
   each output held against the CPU route on 2 images; then
   ``extract_features --cnn_model VGG19 --output_layer fc2 --batch 64
   --resize 224 --skip_low`` on 1,024 JPEG item images of 256x256 written
   here (wall seconds, the host's share against the card's two passes a
   batch; the file set; two rows against the CPU route on a copy of the
   CLI's weights) and ``train_rec --rec vbpr --cnn_model VGG19
   --output_layer fc2`` for one epoch on what it extracted, over a 1,024 x
   1,024 interaction set written beside the images (K3 in its dumps; the
   catalog is under the 16,384 items from which the evaluator takes K2).

The line before the last is a JSON object of the kernels with their
numbers; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import math
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
# the serving phases after the first: queries timed at each bucket, and the
# K3 kernels their buckets take at D <= 160 (the register kernel at B <= 64,
# the warpgroup kernel above)
SERVE_REPS = {8: 20, 64: 20, 1024: 5, 4096: 3}
K3_SERVE_ROUTES = {"segmax_mma_regs_kernel", "segmax_wgmma_kernel"}
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
# the factored attention dump: the evaluation configuration's first ATT_U
# users (cut: each user block's weights are [ATT_BLOCK, 500k, 3] floats)
ATT_U, ATT_BLOCK = 4096, 128
ATT_DIR = ROOT / "build" / "chip_smoke_attention"
# the CLI phase: a reference-layout dataset written by this script (20k
# users until the bf16 phase came, 4,096 since; the items stay at 20k,
# above the 16,384 from which FactoredEvaluator sends a catalog to K2)
CLI_U, CLI_I = 4_096, 20_000
CLI_PER_USER, CLI_K, CLI_SERVE_USERS = 20, 20, 64
CLI_DIR = ROOT / "build" / "chip_smoke_cli"
# the edge-tower kernel K7: the JAX test geometries, two groups of
# channels, the training step's shape and the reference resolution (B, H,
# W, C; the last two are timed); constant images tie every pool window
# (0.5) and every ReLU boundary too (0.0)
TOWER_TIMED = ((8192, 32, 32, 64), (256, 224, 224, 64))
# the evaluator's block: precompute_eval's tower call a --batch_eval 128
# block (the bf16 forward is checked and timed there too)
TOWER_EVAL = (128, 32, 32, 64)
TOWER_GEOMS = ((5, 8, 16, 4), (8, 6, 10, 3), (3, 12, 8, 8), (4, 10, 12, 300)) + TOWER_TIMED
TOWER_TIES = ((4, 8, 12, 4, 0.5), (16, 32, 32, 64, 0.5), (16, 32, 32, 64, 0.0))
# edge maps as the model's stack holds them (data/pipeline.py: tiff / 255):
# k/255, mostly zero, so zero regions tie every window at pre = bias
TOWER_EDGES = ((64, 32, 32, 64), (2, 224, 224, 64))
# the forward on worst-case splits (every pixel and weight drops about the
# most its bf16 pieces can, all terms of one sign) at the training shape
TOWER_WORST = (8192, 32, 32, 64)
# the forward kernel's wgmma k16 steps per 64 channels and 64 conv pixels
# (csrc/edge_tower.cu: hi x hi in 2, the five cross products in 10; the
# bf16 forward's 2)
FWD_K16_STEPS, FWD_BF16_K16_STEPS = 12, 2
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
# the AttentiveFashion path through the CLI: a dataset written as the CLI
# phase's with color histograms, class one-hots and 32x32 edge tiffs, of
# AF_CLI_N users x AF_CLI_N items (the CLI phase's 20k x 20k until the
# vision phase came: ~135 s of host work, mostly the dense evaluation and
# the attention dumps, cut to ~1/6 of the user-item pairs; 8192 x 8192
# until the bf16 phase came, ~41 s, cut to 1/16 of the pairs)
AF_CLI_CLASSES, AF_CLI_BATCH_EVAL, AF_SERVE_BUCKETS = 10, 128, (8, 64, 1024)
AF_CLI_N = 2048
# the native host data plane: a split TSV and a recommendation dump at the
# scaled configuration's sizes (rows; users x k); the Python writer, at
# ~60 s for the full dump on the card's host, writes its first 100k users
NATIVE_TSV_ROWS, NATIVE_DUMP_U, NATIVE_DUMP_K = 2_000_000, 1_000_000, 20
NATIVE_PY_DUMP_U = 100_000
NATIVE_DIR = ROOT / "build" / "chip_smoke_native"
# the streamed trainer: AttentiveFashion at the JAX CLI's full width
# (cli/train_rec.py: K=128, attention (64, 1), hidden 256, 64 filters,
# dropout 0.5, --edge_hw 224 224, --batch_size 256) over 1M users x 32,768
# items, 20 positives a user: a 6.58 GB edge stack read as a memmap; the
# prefetcher's depth and the evaluation's encoding block (--batch_eval)
SAF_U, SAF_I, SAF_POS, SAF_HW, SAF_B = 1_000_000, 32_768, 20, 224, 256
SAF_ROUTE_STEPS, SAF_STEPS, SAF_PROFILE_STEPS = 3, 50, 5
SAF_DEPTH, SAF_BATCH_EVAL, SAF_CLI_N = 2, 128, 1024  # the CLI's 2048 cut (bf16 phase)
SAF_DIR = ROOT / "build" / "chip_smoke_streamed"
# the row kernels K4 and K5: the packed rows' widths (fp32 / bf16 / fp8
# moments at K=128, users then items; 512 a 128-aligned row) at the packed
# step's unique-row counts over a 1M-row table; timed at the JAX benches'
# shapes (rows, width, batch)
ROW_WIDTHS, ROW_TABLE, ROW_BATCHES = (385, 388, 257, 259, 193, 195, 512), 1_000_000, (8192, 16384)
GATHER_SHAPE, SCATTER_SHAPE = (1_000_000, 128, 24576), (1_000_000, 384, 24576)
# K4 timed at the widths the packed paths gather, at the packed step's
# item batch: BPRMF rows with fp32 moments (users, items) and VBPR's and
# GradFashion's user rows (445 fp32) over 1M-row tables, their item rows
# (4355 / 4867 bf16, 4484 / 4996 fp32) over the 500k-row catalog (phase
# 16); the narrow ones also warm (their rows left in the L2 by the call
# before, as the packed step's dedupe gather finds them).  The narrow
# widths of bf16 and fp8 moments (257, 259, 193, 195; VBPR's 297) were cut
# from this grid and from K5's (acf_row_phase) when the bf16 phase came
GATHER_B = 16_384
GATHER_NARROW = (385, 388, 445)
# calls a row-kernel timing averages (K4, K5 and their library calls; the
# plain versions half of it): 20 before the multi-device phase came, cut
# for its time
ROW_ITERS = 10
GATHER_WIDE = (4355, 4867, 4484, 4996)
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
# VBPR and GradFashion at the JAX CLI's default widths
# (fashionvisualexpl_tpu/cli/train_rec.py:57-66): K=128, embed_d=20, vgg19
# fc2 features 4096 wide (CNN and edges), 8x8x8 color histograms,
# embed_color = embed_edges = 32.  Factored, D = K + embed_d = 148, which
# K2 takes in two chunks of 80 columns and K3 on its register (B <= 64)
# and warpgroup kernels, D zero-padded to 160, rows staged 8 bytes at a
# time (296-byte rows); both are also checked at 150, K2 at 1024 too (the
# user tile staged).  The full
# width phase runs over the evaluation phase's 1M users x 500k items and
# data: packed training 3 steps against CPU copies on a 20k x 20k catalog,
# then a 200-step epoch; 50 generic steps; a 200-step fast epoch; both
# evaluation splits; serving at the buckets
VIS_EMBED_D, VIS_DIM_F, VIS_DIM_C, VIS_EMBED_FAMILY = 20, 4096, 512, 32
VIS_D = EMBED_K + VIS_EMBED_D
VIS_D_OTHER = 150
VIS_ROUTE_N, VIS_ROUTE_STEPS, VIS_STEPS, VIS_GENERIC_STEPS = 20_000, 3, 200, 50
# K4 / K5 at the fused row widths: checked over a 100k-row table at the
# packed step's unique-row counts, timed at 24,576 rows of a 500k-row table
VIS_ROW_TABLE, VIS_ROW_TIMED = 100_000, 24_576
# the visual CLI runs: the CLI dataset with 4096-wide CNN and edge
# features, 512-wide color histograms and a review table; batch 1024
VIS_CLI_B, VIS_CLI_REVIEWS, VIS_TOP_N = 1024, 5, 50
# ACF at the JAX CLI's default widths (fashionvisualexpl_tpu/cli/train_rec.py:
# 54-63: K=128, layers_component = layers_item = (64, 1)) over spatial maps
# of the reference's 7x7 grid (S=49, SURVEY.md:205-208) by C=512, the
# channels of VGG19's last conv block (vgg19 is the CLI's default
# --cnn_model), at the JAX package's own ACF scale (SPEED.md:145): 1M users
# x 200k items, P=20 positives a user (make_scaled_arrays, the array path);
# Fspat [200k, 49, 512] (20.07 GB) made on the card from a seed on the 1/64
# grid.  Cut in depth (25 packed, 10 fused and 10 generic steps since the
# multi-device phase came; 50, 20, 20 before) and, fused, in batch
# (2048: at 8192 the fused item table, the extra rows and the deduped rows
# do not fit beside Fspat).  Route checks on a 4096 x 4096 catalog at batch
# 256 (the CPU route's attention over B x P x S x C), the chunked profile
# over 4096 users, the CLI on a 2048 x 2048 dataset with 7x7x512 .npy maps
ACF_U, ACF_I, ACF_P, ACF_S, ACF_C = 1_000_000, 200_000, 20, 49, 512
ACF_B, ACF_STEPS, ACF_FUSED_B, ACF_FUSED_STEPS = 8192, 25, 2048, 10
ACF_GENERIC_STEPS, ACF_PROFILE_STEPS, ACF_CHUNK, ACF_CHUNK_USERS = 10, 10, 8, 4096
ACF_ROUTE_N, ACF_ROUTE_B, ACF_ROUTE_STEPS = 4096, 256, 3
ACF_CLI_N, ACF_CLI_B = 1024, 1024  # the CLI's 2048 cut when the bf16 phase came
# the chunked profile against the one-shot one (tests/test_acf.py:105)
ACF_CHUNK_TOL = 2e-6
# K4 and K5 timed at ACF's item rows over the 200k catalog: at the B*P =
# 163,840 extra rows of a batch-8192 step and at the packed item batch
ACF_ROW_B = (ACF_B * ACF_P, GATHER_B)
# the fused widths (the maps in the item rows) at GATHER_B rows only (cut
# for the multi-device phase's time), fp32 moments' 25,857 only (bf16's
# 25,601 and fp8's 25,473 cut when the bf16 phase came)
ACF_FUSED_ROW_B = (GATHER_B,)
ACF_ROW_WIDTHS = (769, 513, 25857)
ACF_DEV = "cuda"
# CompVBPR at the JAX CLI's default widths (fashionvisualexpl_tpu/cli/
# train_rec.py:57-74: K=128, d=20, every family on at weight 0.25): semantic
# = vgg19 fc2 (4096), color = the 8x8x8 histogram (512), texture = one
# layer of the 32x32 gram grid (1024, vision/extractors.py:204), the edge
# images through the trainable CNN at 32x32x1; factored D = K + 4 d = 208.
# The JAX package's own CompVBPR scale (scripts/scaled_bench.py:189-202,
# SPEED.md:89): 1M users x 200k items, P=20, batch 8192.  Cut only in depth
# (10 packed and 5 generic steps, 5-step profiles).  Route checks on a
# 4096 x 4096 catalog at batch 256, 2 steps each (the CPU route runs the
# CNN on 512 images a step).  The CNN also at the reference's 224x224 (B =
# 256), and the CLI at its default --edge_hw 224 224, generic on 512 users
# x 16,384 items (the smallest catalog FactoredEvaluator sends to K2 by
# default), packed and serve_rec on 512 x 512 (1024 users until the bf16
# phase came), at batch 1024 (the default 256 would take four times the
# steps)
COMP_U, COMP_I, COMP_P, COMP_B, COMP_HW = 1_000_000, 200_000, 20, 8192, 32
COMP_EMBED_D, COMP_DIM_S, COMP_DIM_C, COMP_DIM_T = 20, 4096, 512, 1024
COMP_D = EMBED_K + 4 * COMP_EMBED_D
# (the packed epoch cut from 50 steps and the generic run from 20 when the
# streamed phases came, to 10 and 5 when the multi-device phase came: ~263
# ms a step)
COMP_STEPS, COMP_GENERIC_STEPS, COMP_PROFILE_STEPS = 10, 5, 5
COMP_ROUTE_N, COMP_ROUTE_B, COMP_ROUTE_STEPS = 4096, 256, 2
COMP_CNN_B, COMP_CLI_U, COMP_CLI_I, COMP_CLI_B = 256, 512, 16_384, 1024
# the packed user rows (Gu and the four Tu*, 208 floats) with fp32 moments,
# then at row_align 128 (bf16 / fp8 moments' 417 / 313, 512 / 384 cut when
# the bf16 phase came)
COMP_USER_WIDTHS = (625, 640)
# the CNN's f32 forward on the card against float64, relative to its
# largest output: f32 rounding accumulates to ~1e-6, TF32 to ~1e-3
COMP_F64_RTOL = 1e-4
# the route checks of the CNN (``cnn_route_check``): the routes' moments
# within this share of their norm (a ReLU at its rounding moves a few
# terms of the gradient sums)
COMP_CNN_NORM = 0.05
# the vision phase: the extraction CLI's three backbones (ResNet-50,
# ResNet-152, VGG19) at the reference's 224x224 (the JAX CLI's --resize),
# at its default --batch 64 and at 256, random weights from a seed, from
# preprocessed images made on the card; each output held against the
# port's CPU route on VISION_CHECK images (f32 on both sides, summed in
# other orders): |card - cpu| <= VISION_RTOL * (|cpu| + max |cpu|)
VISION_HW, VISION_BATCHES, VISION_CHECK, VISION_RTOL = 224, (64, 256), 2, 1e-4
# then the extraction CLI on VISION_IMAGES item images of VISION_IMG_HW
# square (JPEG, written here with PIL): VGG19 fc2 (train_rec's default
# --cnn_model / --output_layer), --batch 64, --resize 224, --skip_low (cv2
# and sklearn are not known to be on the card's machine); and train_rec
# --rec vbpr for one epoch on those features over a VISION_IMAGES x
# VISION_IMAGES interaction set written beside the images
VISION_IMAGES, VISION_IMG_HW, VISION_CLI_B = 1024, 256, 64  # 2048 until the bf16 phase
VISION_DIR = ROOT / "build" / "chip_smoke_vision"


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


def wide_kernel(B: int, D: int) -> str:
    """K3's kernel for B users x D in 8- or 16-byte rows, D <= 256."""
    if B <= 64:
        return "segmax_mma_regs_kernel"
    return "segmax_wgmma_kernel" if D <= 160 else "segmax_wgmma_wide_kernel"


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

    def check(label, uf, iv, ib, seg, kernel=None):
        """kernel: the route the launch must take (segmax.ROUTES)"""
        before = segmax.segmax_scores.routes.copy()
        got = segmax.segmax_scores(uf, iv, ib, seg)
        torch.cuda.synchronize()
        (route,) = segmax.segmax_scores.routes - before
        want = segmax.segmax_scores_reference(uf, iv, ib, seg)
        err = (got - want).abs()
        ok = bool((err <= K_ATOL + K_RTOL * want.abs()).all())
        worst = float(err.max())
        print(f"kernel check {label}: {route} max_abs_err={worst!r} {'ok' if ok else 'MISMATCH'}")
        if kernel is not None and route != kernel:
            fail(f"segmax at {label} took {route}, not {kernel}")
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
        for B, D in ((4097, 128), (4097, 64), (100, 64), (100, 33), (8, VIS_D),
                     (100, VIS_D), (4097, VIS_D), (8, VIS_D_OTHER), (100, VIS_D_OTHER)):
            Ip = 32 * 1001
            check(f"seg=32 D={D} B={B} {names[dtype]} Ip={Ip} pads=500",
                  *inputs(B, Ip, D, dtype, n_pad=500), 32)
    # D up to 256 in 8- or 16-byte rows (VBPR's and GradFashion's 148, 152,
    # 160; 164, CompVBPR's 208, 256) on the register kernel (B <= 64) and a
    # warpgroup kernel (up to 160 segmax_wgmma_kernel, above it
    # segmax_wgmma_wide_kernel), at every epilogue (seg 12: the score tile,
    # or the merge in shared memory; 64: above 160 a thread's items; 1024:
    # walked in sub-tiles), ragged catalogs with pads; D = 150 (4-byte
    # rows) and 264 on segmax_mma_kernel; iv 8-byte aligned only (the view
    # big[1:])
    for D in (VIS_D, 152, 160, 164, COMP_D, 256):
        for B in (8, 64, 65, 100, 4097):
            kernel = wide_kernel(B, D)
            for seg in (8, 12, 16, 32, 64, 1024):
                Ip = seg * (3 if seg > 256 else 2400 // seg + 1)
                check(f"seg={seg} D={D} B={B} bf16 Ip={Ip} pads={seg + 3}",
                      *inputs(B, Ip, D, torch.bfloat16, n_pad=seg + 3), seg, kernel)
    for D in (VIS_D_OTHER, 264):
        for B in (8, 100, 4097):
            check(f"seg=32 D={D} B={B} bf16 Ip=2432 pads=35",
                  *inputs(B, 2432, D, torch.bfloat16, n_pad=35), 32, "segmax_mma_kernel")
    for B in (8, 100, 4097):
        uf, big, ib = inputs(B, 2433, VIS_D, torch.bfloat16)
        if segmax.operand_align(uf, big[1:]) != 8:
            fail("the view big[1:] of a D=148 bf16 tensor is not 8-byte aligned only")
        check(f"seg=32 D={VIS_D} B={B} bf16 Ip=2432 iv=big[1:]", uf, big[1:], ib[1:], 32,
              wide_kernel(B, VIS_D))
        # D=208 rows (416 bytes) keep a 16-byte base: a view 4 elements in
        uf, big, ib = inputs(B, 2433, COMP_D, torch.bfloat16)
        iv = big.view(-1)[4:4 + 2432 * COMP_D].view(2432, COMP_D)
        if segmax.operand_align(uf, iv) != 8:
            fail("a D=208 bf16 view 4 elements in is not 8-byte aligned only")
        check(f"seg=32 D={COMP_D} B={B} bf16 Ip=2432 iv 8-byte aligned", uf, iv, ib[1:], 32,
              wide_kernel(B, COMP_D))
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

    # VBPR's and GradFashion's width over their 500k catalog padded to the
    # 65536 block, at the serving buckets, the L2 flushed
    t0 = time.perf_counter()
    Ip, D = 8 * ITEM_BLOCK, VIS_D
    flush = torch.empty(64 * 2**20 // 4, device=dev)  # 64 MB > the 50 MB L2
    rows["d148"] = {}
    for B, iters in ((8, 50), (64, 50), (1024, 20), (4096, 10)):
        uf, iv, ib = inputs(B, Ip, D, torch.bfloat16, n_pad=Ip - EVAL_I)
        kernel = "segmax_wgmma_kernel" if B > 64 else "segmax_mma_regs_kernel"
        route = segmax.segmax_route(B, D, SEG, segmax.operand_align(uf, iv))
        print(f"segmax route D={D} B={B}: {route}")
        if route["kernel"] != kernel:
            fail(f"segmax at D={D} B={B} plans {route['kernel']}, not {kernel}")
        err = check(f"VBPR serving shape seg={SEG} D={D} B={B} bf16 Ip={Ip}", uf, iv, ib, SEG,
                    kernel)
        before = segmax.segmax_scores.routes.copy()
        bound, by = segmax_bound_ms(B, Ip, D, SEG, 2, PEAK_BF16_FLOPS)
        ms, call_ms, _ = kernel_times(torch, f"segmax D={D} B={B}",
                                      lambda: segmax.segmax_scores(uf, iv, ib, SEG), iters, flush,
                                      bound)
        if set(segmax.segmax_scores.routes - before) != {kernel}:
            fail(f"segmax timed at D={D} B={B} took {segmax.segmax_scores.routes - before}")
        plain, _, _ = kernel_times(torch, f"segmax plain D={D} B={B}",
                                   lambda: segmax.segmax_scores_reference(uf, iv, ib, SEG), 5,
                                   flush)
        lib, _, _ = kernel_times(torch, f"segmax library D={D} B={B}",
                                 lambda: torch.matmul(uf, iv.T), iters, flush)
        check_bound(f"segmax D={D} B={B}", ms, bound)
        rows["d148"][B] = dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain,
                               bound_ms=bound, bound_by=by, library_ms=lib,
                               kernel=route["kernel"], copy_bytes=route["copy_bytes"])
        print(f"kernel time segmax B={B} Ip={Ip} D={D} seg={SEG} bf16, cold L2: ms={ms!r} "
              f"call_ms={call_ms!r} plain_ms={plain!r} library_ms(matmul bf16)={lib!r} "
              f"bound_ms={bound!r} ({by})")
        del uf, iv, ib
        torch.cuda.empty_cache()
    print(f"segmax at D={D}: {time.perf_counter() - t0!r} s")
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


def serve_buckets(np, segmax, srv, batches, reps, label, want_routes=None):
    """``srv.query`` at each bucket of ``batches`` (B -> user ids): a
    warm-up query, then ``reps[B]`` timed ones, each bucket launching K3 and
    returning [B, K_TOP] finite scores; with ``want_routes``, the set of K3
    kernels the buckets together must take.  K3's counts are set to 0 at the
    start (the serving path) and read at the end.  Returns ({B: p50_ms, qps,
    launches}, {B: (ids, vals)}, launches, routes)."""
    serving, served = {}, {}
    segmax.segmax_scores.launches = 0  # the serving path starts here
    segmax.segmax_scores.routes.clear()
    for B, users in batches.items():
        before = segmax.segmax_scores.launches
        ids, vals = srv.query(users)  # warm-up
        times = []
        for _ in range(reps[B]):
            t0 = time.perf_counter()
            ids, vals = srv.query(users)
            times.append(time.perf_counter() - t0)
        launched = segmax.segmax_scores.launches - before
        if not launched or ids.shape != (B, K_TOP) or not np.isfinite(vals).all():
            fail(f"{label} B={B}: {launched} K3 launches, result shape {ids.shape} or "
                 "non-finite values")
        p50 = statistics.median(times)
        serving[B] = dict(p50_ms=1e3 * p50, qps=B / p50, launches=launched)
        served[B] = (ids, vals)
        print(f"{label} B={B}: p50_ms={1e3 * p50!r} qps={B / p50!r} "
              f"min_ms={1e3 * min(times)!r} kernel_launches={launched}")
    launches = segmax.segmax_scores.launches  # ... and ends here
    routes = dict(segmax.segmax_scores.routes)
    if want_routes is not None and set(routes) != want_routes:
        fail(f"{label}: K3 took {routes}, not the kernels {sorted(want_routes)}")
    return serving, served, launches, routes


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
    results, served, launches, _ = serve_buckets(np, segmax, srv, batches, reps, "serve")
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


def kernel_times(torch, label, fn, iters: int, flush, bound=None):
    """(ms, call_ms, kernels) per call of fn, with the L2 emptied before each call
    by a random fill of ``flush`` (a buffer larger than the 50 MB L2) that
    neither time counts, so that fn's inputs come from device memory.

    ``ms``: the summed durations of one call's kernels from torch.profiler,
    launch gaps left out, averaged over the calls recorded whole.  The
    profiler can lose kernel records (see ``lead_in``).  So the profile is
    cut at the flushes into calls, and only the calls whose kernels (names
    and numbers) match those of most calls count, and of those only the
    ones whose kernel records are each at least half that kernel's median
    over the profile (the profiler has also cut records short: PERF.md
    §6, PR 17); a profile where fewer than a majority of the calls count is
    taken again, at most PROFILE_ATTEMPTS times.  With ``bound`` (the least
    time in ms the card could take for fn's work), a profile that reads fn
    under it is taken again too: no kernel outruns the memory and the
    arithmetic, so all of that profile's records were cut short (one run read
    K4 at W=384, B=8192 at 0.00545 ms where four others read 0.0115-0.0117);
    the last profile's reading is returned whatever it is, for
    ``check_bound`` to judge.  ``call_ms``: CUDA events around each
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
        kind = Counter(kinds).most_common(1)[0][0] if kinds else ()
        same = [c for c, k in zip(calls, kinds) if k == kind]
        totals = [Counter() for _ in same]
        for total, c in zip(totals, same):
            for name, us in c:
                total[name] += us
        # a kernel record under half the same kernel's median over the
        # profile's calls was cut short by the profiler, not run faster: a
        # bulk-copy kernel read so had CUDA events at its usual time
        median = {n: statistics.median(t[n] for t in totals) for n in dict(kind)} if same else {}
        kept = [t for t in totals if all(t[n] >= median[n] / 2 for n in median)]
        if len(kept) < len(same):
            print(f"{label}: profile {attempt} recorded {len(same) - len(kept)} of {iters} calls "
                  f"under half the median ({ {n: m / 1e3 for n, m in median.items()} } ms): "
                  f"{[{n: t[n] / 1e3 for n in median} for t in totals if t not in kept]}")
        whole = len(kept)
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
            per_name = sum(kept, Counter())
            ms = sum(per_name.values()) / whole / 1e3
            if bound is not None and ms < bound and attempt < PROFILE_ATTEMPTS:
                print(f"{label}: profile {attempt} read {ms!r} ms a call, under the bound "
                      f"{bound!r} ms (CUDA events {call_ms!r} ms): taken again")
                continue
            kernels = {n: (dict(kind)[n], us / whole / 1e3) for n, us in per_name.items()}
            return ms, call_ms, kernels
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
        ms, call_ms, kernels = kernel_times(torch, name, run, 200, flush, b)
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
            p, m, v, scal), 20, flush, b)
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
    for B, I, D in ((100, 5000, 128), (300, 70_001, 33), (4096, 20_000, 128),
                    (100, 5000, VIS_D), (300, 70_001, VIS_D), (300, 70_001, VIS_D_OTHER),
                    (100, 5000, 1024)):
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
    # probe's over every user's banned set (train + test item), at BPRMF's
    # D=128 and VBPR's and GradFashion's D=148
    I, B = EVAL_I, EVAL_BLOCK
    test_banned = np.concatenate([eval_items[:, :EVAL_TRAIN], eval_items[:, -1:]], axis=1)
    W = topk.banned_bucket_width(test_banned, I, EVAL_TILE)
    banned = torch.from_numpy(test_banned[:B]).to(dev)
    flush = torch.empty(64 * 2**20 // 4, device=dev)  # 64 MB > the 50 MB L2
    timed = {}
    for D in (EMBED_K, VIS_D):
        t0 = time.perf_counter()
        shape = f"B={B} I={I} D={D} T=1 W={W} f32, cold L2"
        uf, iv, ib = qrand(B, D), qrand(I, D), qrand(I)
        ref = (torch.einsum("bd,bwd->bw", uf, iv[banned[:, -1:].long()])
               + ib[banned[:, -1:].long()])
        args, item_tile, ut, _ = padded(uf, iv, ib, ref, banned, I, EVAL_TILE, W)
        check(f"evaluator shape B={B} I={I} D={D} T=1 W={W}", args, item_tile, ut)
        n_re = torch.zeros(1, dtype=torch.int64, device=dev)
        counts.counts_kernel(*args, item_tile=item_tile, user_tile=ut, _rechecked=n_re)
        rechecked = int(n_re)
        print(f"counts evaluator shape D={D}: {rechecked} of {B * args[1].shape[0]} pairs "
              f"scored again exactly (the band)")
        if rechecked == 0:
            fail(f"counts at D={D} rechecked no pair on data with ties")
        uf_p, iv_p = args[0], args[1]
        Ip = iv_p.shape[0]
        b, by = counts_bound_ms(B, Ip, D, 1, Ip // EVAL_TILE, W)
        ms, call_ms, _ = kernel_times(torch, f"counts D={D}", lambda: counts.counts_kernel(
            *args, item_tile=item_tile, user_tile=ut), 10, flush, b)
        plain_ms, _, _ = kernel_times(torch, f"counts plain D={D}",
                                      lambda: counts.counts_kernel_reference(*args, item_tile),
                                      5, flush)
        lib_ms, _, _ = kernel_times(torch, f"counts library D={D}",
                                    lambda: torch.matmul(uf_p, iv_p.T), 5, flush)
        check_bound(f"counts D={D}", ms, b)
        timed[D] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                        library_ms=lib_ms, rechecked=rechecked, shape=shape)
        print(f"kernel time counts B={B} Ip={Ip} D={D} T=1 W={W} f32: ms={ms!r} "
              f"call_ms={call_ms!r} plain_ms={plain_ms!r} library_ms(matmul f32, product "
              f"only)={lib_ms!r} bound_ms={b!r} ({by}, bf16 tensor-core rate); "
              f"{time.perf_counter() - t0!r} s")
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
    # through the exact fmaf chain) bit-equal on Gaussian rows and on
    # cancelling rows (large +- terms, dot products near 0, refs on them), at
    # D=128 (one chunk of D) and VBPR's 148 (two)
    t0 = time.perf_counter()
    band_check = {}
    gauss = args
    del args
    for D in (EMBED_K, VIS_D):
        if D != EMBED_K:  # at D=128 the tie band's rows above
            uf = torch.randn(B, D, device=dev, generator=g) * 0.3
            iv = torch.randn(I, D, device=dev, generator=g) * 0.3
            ref = torch.einsum("bd,bd->b", uf, iv[j])[:, None] + ib[j][:, None]
            gauss, item_tile, ut, _ = padded(uf, iv, ib, ref, j[:, None].to(torch.int32), I,
                                             EVAL_TILE)
        sign = torch.randint(0, 2, (B, 1), device=dev, generator=g) * 2.0 - 1
        big = torch.randn(I, 1, device=dev, generator=g) * 30
        uc = uf.clone()
        uc[:, : D // 2] += sign
        uc[:, D // 2:] -= sign
        vc = iv + big
        rc = torch.einsum("bd,bd->b", uc, vc[j])[:, None] + ib[j][:, None]
        cancel, _, _, _ = padded(uc, vc, ib, rc, j[:, None].to(torch.int32), I, EVAL_TILE)
        for label, a in (("gaussian", gauss), ("cancelling", cancel)):
            n_band = torch.zeros(1, dtype=torch.int64, device=dev)
            n_all = torch.zeros(1, dtype=torch.int64, device=dev)
            got = counts.counts_kernel(*a, item_tile=item_tile, user_tile=ut,
                                       _rechecked=n_band)
            every = counts.counts_kernel(*a, item_tile=item_tile, user_tile=ut,
                                         _band_scale=float("inf"), _rechecked=n_all)
            torch.cuda.synchronize()
            if not torch.equal(got, every):
                bad = int((got != every).any(dim=1).sum())
                fail(f"counts kernel with its band differs from the exact chain on {label} "
                     f"data at D={D} ({bad} users)")
            if int(n_band) == 0:
                fail(f"counts band check ({label}, D={D}): no pair rechecked")
            band_check[f"{label}_D{D}"] = dict(rechecked=int(n_band), exact_pairs=int(n_all),
                                               counted=int(got.sum()))
            print(f"counts band check ({label}, B={B} I={I} D={D}): default band and "
                  f"_band_scale=inf bit-equal ok; {int(n_band)} of {int(n_all)} pairs "
                  f"rechecked with the band")
        del gauss, cancel, uc, vc, uf, iv
    # rows whose every coordinate is a worst case of the bf16 split, refs
    # between the bf16x3 and the exact scores: the band must hold the miss
    for Dw in (1, 6, 16, 128, VIS_D, 1024):
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
    torch.cuda.empty_cache()
    return dict(max_abs_err=float(max(errs)), **timed[EMBED_K], tie_band=tie,
                band_check=band_check, d148=timed[VIS_D])


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


def eval_interactions(np, eval_items):
    """(the scaled evaluation configuration's Interactions, seconds the host
    took to build them): train, validation and test lists per user."""
    from fashionvisualexpl_tpu_torch.data.interactions import Interactions

    t0 = time.perf_counter()
    data = Interactions.from_lists(eval_items[:, :EVAL_TRAIN].tolist(),
                                   eval_items[:, -1:].tolist(), EVAL_I,
                                   eval_items[:, EVAL_TRAIN:-1].tolist())
    return data, time.perf_counter() - t0


def eval_phase(torch, np, counts, data, host_s):
    """The streaming evaluator through K2 at the scaled configuration."""
    from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator

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
    del ev, evb, model, uf, iv, ib
    torch.cuda.empty_cache()
    return launches, dict(metrics=metrics, per_split=per_split, evaluate_s=total_s,
                          peak_gib=peak / 2**30, host_s=host_s, setup_s=setup_s)


def attention_dump_phase(torch, np, segmax, eval_items):
    """``FactoredEvaluator.store_recommendation_attention`` at the
    evaluation configuration's widths (BPRMF K=128 over the 500k catalog,
    k=20) for its first ATT_U users (``eval_items``' rows), with an
    attention function of the seed: the top-k through K3 (its launches
    counted), the weights per user block.  The rows are checked against
    ``store_recommendation``'s dump of the same evaluator (ids equal,
    scores rtol 1e-6) and the attention function itself."""
    from fashionvisualexpl_tpu_torch.data.interactions import Interactions
    from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator

    t0 = time.perf_counter()
    data = Interactions.from_lists(eval_items[:, :EVAL_TRAIN].tolist(),
                                   eval_items[:, -1:].tolist(), EVAL_I,
                                   eval_items[:, EVAL_TRAIN:-1].tolist())
    model = quantized_bprmf(torch, ATT_U, EVAL_I, seed=12)
    coef = torch.randn(3, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(13))

    def weights(u, i):
        """Softmax weights [..., 3] of (user, item) pairs (float tensors)."""
        return torch.softmax(torch.sin(coef[0] * (u * 1e-3) + coef[1] * (i * 1e-5) + coef[2]),
                             dim=-1)

    def attention(params, frozen, users, ctx):
        """[B, I, 3]: the weights of every item for each of ``users``."""
        i = torch.arange(EVAL_I, dtype=torch.float32, device=users.device)
        return weights(users.to(torch.float32)[:, None, None], i[None, :, None])

    ev = FactoredEvaluator(model, data, k=EVAL_K, user_block=ATT_BLOCK)
    ATT_DIR.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    segmax.segmax_scores.launches = 0  # main path starts here
    t1 = time.perf_counter()
    ev.store_recommendation_attention(None, None, str(ATT_DIR / "att.tsv"), attention)
    dump_s = time.perf_counter() - t1
    launches = segmax.segmax_scores.launches  # main path ends here
    if not launches:
        fail("the factored attention dump launched no K3")
    rows = np.loadtxt(ATT_DIR / "att.tsv", delimiter="\t", dtype=np.float64)
    ev.store_recommendation(None, None, str(ATT_DIR / "recs.tsv"))
    recs = np.loadtxt(ATT_DIR / "recs.tsv", delimiter="\t", dtype=np.float64)
    if rows.shape != (ATT_U * EVAL_K, 6) or not np.isfinite(rows).all():
        fail(f"attention dump: {rows.shape} rows, expected {(ATT_U * EVAL_K, 6)}, finite")
    if not (np.array_equal(rows[:, :2], recs[:, :2])
            and np.allclose(rows[:, 2], recs[:, 2], rtol=1e-6, atol=0.0)):
        fail("attention dump: its top-k differs from store_recommendation's")
    u, i = (torch.as_tensor(rows[:, c:c + 1], dtype=torch.float32, device="cuda")
            for c in (0, 1))
    if not np.allclose(rows[:, 3:], weights(u, i).cpu().numpy(), rtol=1e-6, atol=0.0):
        fail("attention dump: its weights differ from the attention function's")
    out = dict(users=ATT_U, items=EVAL_I, k=EVAL_K, user_block=ATT_BLOCK, dump_s=dump_s,
               rows=int(rows.shape[0]), k3_launches=launches, s=time.perf_counter() - t0)
    print(f"factored attention dump: {out}")
    import shutil

    shutil.rmtree(ATT_DIR, ignore_errors=True)
    del ev, model
    torch.cuda.empty_cache()
    return launches, out


def write_reference_dataset(np, d: Path, num_users: int = CLI_U, num_items: int = CLI_I):
    """Split TSVs (``user\\titem\\t0\\t1.0``) and the stats file in the
    reference's layout: per user CLI_PER_USER distinct random items, the
    last one the test item, the one before it the validation item."""
    items = make_eval_items(np, num_users, num_items, CLI_PER_USER, seed=11)
    d.mkdir(parents=True, exist_ok=True)
    (d / "stats_after_downloading").write_text(
        f"dataset stats\n----\nusers: {num_users}\nitems: {num_items}\n")
    for fname, cols in (("trainingset.tsv", slice(0, -2)),
                        ("validationset.tsv", slice(-2, -1)),
                        ("testset.tsv", slice(-1, None))):
        part = items[:, cols]
        users = np.repeat(np.arange(num_users), part.shape[1])
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
    from fashionvisualexpl_tpu_torch.data.native import write_recs_tsv

    write_recs_tsv.calls = 0
    counts.counts_kernel.launches = 0
    segmax.segmax_scores.launches = 0  # main path starts here
    t0 = time.perf_counter()
    train(common + ["--streaming_eval", "--epochs", "2", "--verbose", "1"])
    train_s = time.perf_counter() - t0
    if write_recs_tsv.calls != 2:
        fail(f"the CLI's two dumps took the native writer {write_recs_tsv.calls} times")
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
          f"{serve_s!r} s; launches {launches}; rows {rows}, served {n_served}; "
          f"dumps through the native writer: {write_recs_tsv.calls}")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    return launches, dict(write_s=write_s, train_s=train_s, serve_s=serve_s,
                          metrics=per_epoch[2])


def tower_taps(torch, n: int, device):
    """[n]: the taps of a 5-wide SAME window that fall inside a line of n
    pixels, at each position (5n - 6 in all for n >= 4)."""
    pos = torch.arange(n, device=device)
    return sum(((pos + k - 2 >= 0) & (pos + k - 2 < n)).long() for k in range(5))


def tower_fwd_issued(E, B, H, W, C, bf16=False):
    """Tensor-core operations the forward kernel issues: FWD_K16_STEPS
    products of 64 channels x 64 conv pixels x 16 a step, for every group
    of 64 channels and every N tile of 16 pooled columns of a pooled row
    (``E.fwd_tiles``: a tile's ragged last N tile counts whole).  With
    ``bf16``, the bf16 forward's: FWD_BF16_K16_STEPS products of 64 pixels x
    64 channels x 16 for each of the two M tiles of a window group (2
    pooled rows x 16 pooled columns of a tile of ``E.fwd_tiles_bf16``; a
    ragged group counts whole)."""
    wp = W // 2
    if bf16:
        rp, cw, _ = E.fwd_tiles_bf16(H, W)
        hp = H // 2
        rows = sum(-(-min(rp, hp - r) // 2) for r in range(0, hp, rp))
        chunks = sum(-(-min(cw, wp - q) // E.FWD_CHUNK) for q in range(0, wp, cw))
        return 2.0 * 64 * -(-C // 64) * 64 * 16 * FWD_BF16_K16_STEPS * 2 * B * rows * chunks
    _, cw, _ = E.fwd_tiles(H, W)
    chunks = sum(-(-min(cw, wp - q) // E.FWD_CHUNK) for q in range(0, wp, cw))
    n_tiles = B * (H // 2) * chunks
    return 2.0 * 64 * -(-C // 64) * 64 * 16 * FWD_K16_STEPS * n_tiles


def tower_bounds(torch, E, x, w, b, bf16=False):
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
    (forward) or read (backward), dW and db written.  With ``bf16`` (the
    bf16 kernels; x and w hold the bf16 values, as f32) the images are 2
    bytes a pixel and every operation is on bf16 operands: the conv and one
    product per tap sum (dW) and per live window (db), each at the bf16
    rate, the backward's bound the conv's and the tap sums' operations
    together.  Returns (fwd, bwd, fwd at f32, bwd at f32)."""
    from fashionvisualexpl_tpu_torch.core.precision import fp32_math

    B, H, W, _ = x.shape
    C = w.shape[3]
    th, tw = tower_taps(torch, H, x.device), tower_taps(torch, W, x.device)
    conv = 2.0 * B * C * int(th.sum()) * int(tw.sum())
    with fp32_math():
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
    pixel = 2 if bf16 else 4
    fwd_bytes = pixel * B * H * W + params + 4 * B * C
    fwd = bound_ms(fwd_bytes, conv, PEAK_BF16_FLOPS)
    fwd_f32 = bound_ms(fwd_bytes, conv, PEAK_F32_FLOPS)
    bwd_bytes = pixel * B * H * W + params + 4 * B * C + params
    if bf16:
        bwd = bound_ms(bwd_bytes, conv + 2.0 * (dw_fmas + n_live), PEAK_BF16_FLOPS)
    else:
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


def tower_band(torch, z, s, wmax, b):
    """[B, C, H/2, W/2] bool: the pool windows that the bf16 backward
    recomputes by the f32 chain (``edge_tower.cu::near_tie``), from its
    wgmma conv values z [B, C, H, W] (f32), the sums S_p [B, 1, H, W] of
    |x| over each pixel's 25 taps, the largest |w| of each channel wmax [C]
    and the bias b [C]: a row's two values within the band of their
    pixels' larger S, the rows' pre-activations within that of their
    winners' larger S, or one's sign within that of its winner's (no band
    where that S is 0)."""
    B, C, H, W = z.shape
    zw = z.reshape(B, C, H // 2, 2, W // 2, 2)
    z00, z01 = zw[:, :, :, 0, :, 0], zw[:, :, :, 0, :, 1]
    z10, z11 = zw[:, :, :, 1, :, 0], zw[:, :, :, 1, :, 1]
    sw = s.reshape(B, 1, H // 2, 2, W // 2, 2)
    s00, s01, s10, s11 = sw[:, :, :, 0, :, 0], sw[:, :, :, 0, :, 1], sw[:, :, :, 1, :, 0], \
        sw[:, :, :, 1, :, 1]
    bc = b[None, :, None, None]
    even_t, even_b = z00 >= z01, z10 >= z11
    pt = torch.where(even_t, z00, z01) + bc
    pb = torch.where(even_b, z10, z11) + bc
    swt, swb = torch.where(even_t, s00, s01), torch.where(even_b, s10, s11)
    wm = wmax[None, :, None, None]

    def band(sv):
        return torch.where((sv > 0) & (wm > 0),
                           (1.5 * 2.0**-18 + 2.0**-21) * wm * sv + 2.0**-21 * bc.abs(), -1.0)

    return (((z00 - z01).abs() <= band(torch.maximum(s00, s01)))
            | ((z10 - z11).abs() <= band(torch.maximum(s10, s11)))
            | ((pt - pb).abs() <= band(torch.maximum(swt, swb)))
            | (pt.abs() <= band(swt)) | (pb.abs() <= band(swb)))


def tower_f64_witness(torch, E, seed, bf16=False):
    """Edge maps at TOWER_WITNESS: which pool windows' winners the kernel's
    f32 chain and cuDNN's f32 conv decide unlike a float64 conv, and each
    gradient's excess over the check's tolerance against the gradient of the
    float64 decisions (summed in float64).  The kernel's decisions come from
    its conv2x2 chain replayed here: fmaf(w, x, z) over the taps in its
    order, each product exact in float64 and the sum rounded to f32.  Prints
    the readings; fails if a gradient is not finite or if the kernel's
    leaves the tolerance against the gradient of its replayed decisions.
    With ``bf16`` the bf16 kernels on the maps' bf16 values (k/255 rounded)
    and the weights rounded to bf16, against the bf16 plain version; the
    dW sums take g = dout * (1/n) rounded to bf16, db the f32 g, as the
    kernels do.  The bf16 backward decides on its wgmma sums, replayed by
    the tensor cores' measured rounding (``ops/tc_rounding.py::conv_sums``:
    "tc"), except in the windows of its near-tie band (``tower_band``),
    where it takes the f32 chain's values: its replay ("kernel") is the
    one, or in the band the other, window by window."""
    from fashionvisualexpl_tpu_torch.core.precision import fp32_math
    from fashionvisualexpl_tpu_torch.ops import tc_rounding

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
    if bf16:
        xk = x.bfloat16()
        got = E.edge_tower_bwd(xk, w, b, dout)
        plain = E.edge_tower_gap_bf16_plain_backward(xk, w, b, dout)
        x, wt = xk.float(), w.bfloat16().float().reshape(25, C)
        g32 = dout * (torch.ones((), device=dev) / ((H // 2) * (W // 2)))
        g_w, g_b = g32.bfloat16().double(), g32.double()
        wmax = wt.abs().amax(dim=0)
    else:
        got = E.edge_tower_bwd(x, w, b, dout)
        plain = E.edge_tower_gap_plain_backward(x, w, b, dout)
        wt = w.reshape(25, C)
        g_w = g_b = dout.double() / ((H // 2) * (W // 2))
    flips = {"kernel/f64": 0, "cudnn/f64": 0, "kernel/cudnn": 0}
    if bf16:
        flips.update({"tc/f64": 0, "tc/cudnn": 0, "band": 0})
    sums = {key: torch.zeros(26, C, dtype=torch.float64, device=dev)
            for key in ("f64", "f64_abs", "kernel_replay")}
    for lo in range(0, B, TOWER_WITNESS_CHUNK):
        xs = x[lo:lo + TOWER_WITNESS_CHUNK].permute(0, 3, 1, 2)  # [n, 1, H, W]
        n = xs.shape[0]
        cols = F.unfold(xs.double(), 5, padding=2)  # [n, 25, H*W], exact
        z64 = torch.einsum("jc,njp->ncp", wt.double(), cols).reshape(n, C, H, W)
        with fp32_math():
            z_cudnn = F.conv2d(xs, wt.reshape(5, 5, 1, C).permute(3, 2, 0, 1), padding=2)
        xp = F.pad(xs, (2, 2, 2, 2))
        z_k = torch.zeros(n, C, H, W, device=dev)
        for j in range(25):
            ky, kx = divmod(j, 5)
            prod = wt[j].double()[None, :, None, None] * xp[:, :, ky:ky + H, kx:kx + W].double()
            z_k = (prod + z_k.double()).float()
        masks = {"f64": tower_winners(torch, z64, b.double()),
                 "cudnn": tower_winners(torch, z_cudnn, b),
                 "kernel": tower_winners(torch, z_k, b)}
        if bf16:
            z_tc = tc_rounding.conv_sums(xs, wt)
            s_p = F.conv2d(xs.abs().double(), xs.new_ones(1, 1, 5, 5, dtype=torch.float64),
                           padding=2).float()
            band = tower_band(torch, z_tc, s_p, wmax, b)
            flips["band"] += int(band.sum())
            masks["tc"] = tower_winners(torch, z_tc, b)
            in_band = band[:, :, :, None, :, None].expand(-1, -1, -1, 2, -1, 2).reshape(n, C, H, W)
            masks["kernel"] = torch.where(in_band, masks["kernel"], masks["tc"])
            del z_tc, s_p, band, in_band
        del z64, z_cudnn, z_k, prod, xp
        windows = {key: m.reshape(n, C, H // 2, 2, W // 2, 2) for key, m in masks.items()}
        for pair in [p for p in flips if "/" in p]:
            u, v = pair.split("/")
            flips[pair] += int((windows[u] != windows[v]).any(dim=(3, 5)).sum())
        cols = torch.cat([cols, torch.ones_like(cols[:, :1])], dim=1).transpose(1, 2)
        gw, gb = g_w[lo:lo + n], g_b[lo:lo + n]
        for key, m, ww, bb in (("f64", masks["f64"], gw, gb),
                               ("f64_abs", masks["f64"], gw.abs(), gb.abs()),
                               ("kernel_replay", masks["kernel"], gw, gb)):
            taps = torch.bmm(m.reshape(n, C, H * W).double(), cols)  # [n, C, 26]
            sums[key][:25] += torch.einsum("nc,ncj->jc", ww, taps[:, :, :25])
            sums[key][25] += torch.einsum("nc,nc->c", bb, taps[:, :, 25])
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
    band = flips.pop("band", None)
    print(f"tower witness B={B} H={H} W={W} C={C} edge maps{' bf16' if bf16 else ''} seed "
          f"{seed}: windows whose "
          f"winner differs {flips} of {B * C * (H // 2) * (W // 2)}"
          f"{'' if band is None else f', in the near-tie band {band}'}; max excess of "
          f"|a - b| over the check's tolerance (<= 0 passes) {readings}; "
          f"{time.perf_counter() - t0!r} s")
    if readings["kernel-replay"] > 0:
        fail(f"tower witness seed {seed}: the backward leaves the tolerance against "
             f"its own replayed decisions ({readings['kernel-replay']!r})")
    if band is not None:
        flips["band"] = band
    return flips, readings


def tower_kernel_phase(torch, E):
    """K7 forward and backward against their plain versions over the
    geometries and ties, two backward runs bit-equal, then timed at the
    training step's shape and the reference resolution."""
    from fashionvisualexpl_tpu_torch.core.precision import fp32_math

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
        with fp32_math():
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
            ms, call_ms, _ = kernel_times(torch, name, run, 10, flush, bnd)
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


def af_model(torch, np, edge_tower, seed, compute_dtype="float32"):
    """AttentiveFashion at the scaled configuration on the card, random
    weights from ``seed``; its inputs from numpy seeds 1, 2, 3."""
    from fashionvisualexpl_tpu_torch.data.features import synthetic_features
    from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion

    edges = np.random.default_rng(2).random((AF_I, AF_HW, AF_HW, 1), dtype=np.float32)
    return AttentiveFashion(
        AF_U, AF_I, synthetic_features(AF_I, 512, seed=1), edges,
        synthetic_features(AF_I, 100, seed=3), embed_k=EMBED_K, attention_layers=(64, 1),
        encoder_hidden=256, dropout_rate=0.5, conv_filters=64, edge_tower=edge_tower,
        compute_dtype=compute_dtype, generator=torch.Generator(device="cuda").manual_seed(seed))


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


def write_af_features(np, d: Path, n: int = CLI_I, hw: int = AF_HW):
    """The AttentiveFashion inputs of ``n`` items in the reference's layout
    under data directory ``d``: color histograms, class one-hots and hw x hw
    edge tiffs (L mode).  Returns the edge stack as
    ``load_edge_image_stack`` reads it back ([I, H, W, 1], the 8-bit
    values / 255)."""
    from PIL import Image

    rng = np.random.default_rng(13)
    feats = d / "original" / "features"
    (feats / "edges").mkdir(parents=True, exist_ok=True)
    np.save(feats / "histograms.npy", rng.integers(0, 100, (n, 512)).astype(np.int32))
    np.save(feats / "one_hot_enc.npy", np.eye(AF_CLI_CLASSES, dtype=np.float32)[
        rng.integers(0, AF_CLI_CLASSES, n)])
    imgs = (rng.random((n, hw, hw)) * 255).astype(np.uint8)
    for i in range(n):
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
    """train_rec --rec attentive_fashion then serve_rec, in process, on an
    AF_CLI_N x AF_CLI_N dataset with edge tiffs; then direct serving timed
    per bucket and checked against an oracle on the card."""
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
    write_reference_dataset(np, CLI_DIR / "cli", AF_CLI_N, AF_CLI_N)
    edges = write_af_features(np, CLI_DIR / "cli", AF_CLI_N)
    write_s = time.perf_counter() - t0
    results = CLI_DIR / "results"
    common = ["--rec", "attentive_fashion", "--dataset", "cli", "--data_root", str(CLI_DIR),
              "--results_root", str(results), "--embed_k", str(EMBED_K), "--top_k",
              str(CLI_K), "--edge_hw", str(AF_HW), str(AF_HW), "--batch_eval",
              str(AF_CLI_BATCH_EVAL)]
    served = CLI_DIR / "served.tsv"
    users = ",".join(str(u * (AF_CLI_N // CLI_SERVE_USERS)) for u in range(CLI_SERVE_USERS))
    per_pass = -(-AF_CLI_N // AF_CLI_BATCH_EVAL)
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
        if len(table) != AF_CLI_N * CLI_K:
            fail(f"{pattern}: {len(table)} rows, expected {AF_CLI_N * CLI_K}")
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
    # the same values; reading them again costs seconds of host time)
    paths = Paths(root=str(CLI_DIR), results_root=str(results))
    data = Interactions.load(TrainConfig(dataset="cli", paths=paths))
    model = AttentiveFashion(
        AF_CLI_N, AF_CLI_N, load_color_histograms(paths, "cli"), edges,
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
        batch = rng.choice(AF_CLI_N, B, replace=False)
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


def native_phase(np):
    """The native host data plane, built with g++ here: the split-TSV parse
    and the dump writer against their Python paths at full size."""
    import shutil

    from fashionvisualexpl_tpu_torch.data import native as N
    from fashionvisualexpl_tpu_torch.data.interactions import read_split_tsv

    t0 = time.perf_counter()
    if N.load_library() is None:
        fail("the native host library did not build: g++ missing or failed")
    load_s = time.perf_counter() - t0
    built = "built before" if N.build_seconds is None else f"g++ {N.build_seconds!r} s"
    print(f"native library {N.library_path()}: {built} (load {load_s!r} s)")
    shutil.rmtree(NATIVE_DIR, ignore_errors=True)
    NATIVE_DIR.mkdir(parents=True)
    rng = np.random.default_rng(21)
    u = rng.integers(0, SAF_U, NATIVE_TSV_ROWS).tolist()
    i = rng.integers(0, 500_000, NATIVE_TSV_ROWS).tolist()
    tsv = NATIVE_DIR / "trainingset.tsv"
    tsv.write_text("".join(f"{a}\t{b}\t0\t1.0\n" for a, b in zip(u, i)))
    calls = N.parse_interactions_tsv.calls
    t0 = time.perf_counter()
    native_pairs = read_split_tsv(str(tsv))
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    python_pairs = read_split_tsv(str(tsv), use_native=False)
    parse_py_s = time.perf_counter() - t0
    if N.parse_interactions_tsv.calls != calls + 1:
        fail("read_split_tsv did not take the native parser")
    if native_pairs != python_pairs or native_pairs != list(zip(u, i)):
        fail("read_split_tsv: the native and Python parses differ")
    del native_pairs, python_pairs, u, i

    U, K, Up = NATIVE_DUMP_U, NATIVE_DUMP_K, NATIVE_PY_DUMP_U
    users = np.arange(U, dtype=np.int32)
    ids = rng.integers(0, 500_000, (U, K)).astype(np.int32)
    vals = (rng.standard_normal((U, K)) * 5).astype(np.float32)
    dumps = {"native": NATIVE_DIR / "recs-native.tsv",
             "native_part": NATIVE_DIR / "recs-native-part.tsv",
             "python_part": NATIVE_DIR / "recs-python-part.tsv"}
    write_s = {}
    for label, n in (("native", U), ("native_part", Up)):
        t0 = time.perf_counter()
        if not N.write_recs_tsv(str(dumps[label]), users[:n], ids[:n], vals[:n]):
            fail("write_recs_tsv did not take the native writer")
        write_s[label] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(dumps["python_part"], "w") as out:  # eval/factored.py's fallback
        out.writelines(f"{a}\t{ids[r, j]}\t{vals[r, j]}\n"
                       for r, a in enumerate(users[:Up]) for j in range(K))
    write_s["python_part"] = time.perf_counter() - t0
    # the ids of every dump by the native parser; the scores of the two
    # 100k-user dumps in full (one writer wrote both native dumps; parsing
    # the full one's 20M floats takes ~10 s)
    for label, path in dumps.items():
        n = U if label == "native" else Up
        pu, pi, _ = N.parse_interactions_tsv(str(path))
        ok = np.array_equal(pu, np.repeat(users[:n], K)) and np.array_equal(
            pi, ids[:n].reshape(-1))
        if label != "native":
            with open(path) as f:
                scores = np.fromstring(f.read(), dtype=np.float64, sep=" ")[2::3]
            ok = ok and np.array_equal(scores.astype(np.float32), vals[:n].reshape(-1))
        if not ok:
            fail(f"{path.name} does not parse back to the dumped rows")
    out = dict(build_s=N.build_seconds, library=str(N.library_path()),
               tsv_rows=NATIVE_TSV_ROWS, tsv_bytes=tsv.stat().st_size, parse_s=parse_s,
               parse_python_s=parse_py_s, dump_rows=U * K, part_rows=Up * K,
               dump_bytes=dumps["native"].stat().st_size,
               **{f"write_{k}_s": v for k, v in write_s.items()})
    print(f"native plane: read_split_tsv {NATIVE_TSV_ROWS} rows native {parse_s!r} s, "
          f"Python {parse_py_s!r} s; write_recs_tsv {U} x {K} native {write_s['native']!r} "
          f"s; {Up} x {K} native {write_s['native_part']!r} s, Python "
          f"{write_s['python_part']!r} s; parsed back equal")
    shutil.rmtree(NATIVE_DIR, ignore_errors=True)
    return out


def write_edge_stack(np, path: Path, n: int, hw: int, seed: int):
    """[n, hw, hw, 1] float32 k/255 edge maps (k uniform in 0..255, numpy
    seed ``seed``) written into a .npy through ``open_memmap`` a chunk of
    1024 items at a time."""
    from numpy.lib.format import open_memmap

    rng = np.random.default_rng(seed)
    out = open_memmap(str(path), mode="w+", dtype=np.float32, shape=(n, hw, hw, 1))
    for s in range(0, n, 1024):
        e = min(s + 1024, n)
        out[s:e] = rng.integers(0, 256, (e - s, hw, hw, 1), dtype=np.uint8) / np.float32(255)
    out.flush()
    del out


def gather_rates(torch, np, store, ring, pos, neg):
    """One batch's host gather in GB/s by the native gather into a pinned
    slot, numpy ``src[ids]`` and ``torch.index_select`` on the memmapped
    tensors (median of 3 each), then the slot's copy to the card, and the
    native gather's time for one row (its fixed cost a call)."""
    import warnings

    nbytes = sum(4 * int(np.prod(s)) for s in store.shapes(len(pos)).values())
    srcs = (store.color, store.edges, store.cls)
    with warnings.catch_warnings():  # the memmap is read-only; nothing writes it
        warnings.simplefilter("ignore", UserWarning)
        tensors = [torch.from_numpy(a) for a in srcs]
    ids = [torch.from_numpy(x.astype(np.int64)) for x in (pos, neg)]
    i = ring.acquire()

    def med(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    rates = dict(
        bytes=nbytes,
        native_gbs=nbytes / med(lambda: store.gather(pos, neg, out=ring.views[i])) / 1e9,
        numpy_gbs=nbytes / med(lambda: [a[x] for x in (pos, neg) for a in srcs]) / 1e9,
        index_select_gbs=nbytes / med(lambda: [torch.index_select(t, 0, x) for x in ids
                                               for t in tensors]) / 1e9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ring.to_device(i)
    torch.cuda.synchronize()
    rates["h2d_gbs"] = nbytes / (time.perf_counter() - t0) / 1e9
    # the native gather's fixed cost a call (it starts and joins its threads)
    from fashionvisualexpl_tpu_torch.data.native import gather_rows_native

    row = np.empty((1,) + store.cls.shape[1:], np.float32)
    rates["native_call_us"] = 1e6 * med(lambda: gather_rows_native(store.cls, pos[:1], out=row))
    return rates


def streamed_phase(torch, np, E):
    """AttentiveFashion with host features through the streamed trainer at
    full width from a memmapped 224x224 edge stack: held to the resident
    Trainer, timed, profiled; the host-blocked evaluation held to the
    resident one."""
    import shutil

    from fashionvisualexpl_tpu_torch.core.config import TrainConfig
    from fashionvisualexpl_tpu_torch.data import native as N
    from fashionvisualexpl_tpu_torch.data.features import synthetic_features
    from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
    from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion
    from fashionvisualexpl_tpu_torch.train.streamed import (
        STEP_SEED_BASE,
        ArrayFeatureStore,
        StreamedTrainer,
    )
    from fashionvisualexpl_tpu_torch.train.trainer import Trainer, fold_in

    base = phase_start(torch)
    shutil.rmtree(SAF_DIR, ignore_errors=True)
    SAF_DIR.mkdir(parents=True)
    stack = SAF_DIR / "edges_stack.npy"
    t0 = time.perf_counter()
    write_edge_stack(np, stack, SAF_I, SAF_HW, seed=2)
    stack_s = time.perf_counter() - t0
    edges = np.load(str(stack), mmap_mode="r")
    color = synthetic_features(SAF_I, 512, seed=1)
    cls = synthetic_features(SAF_I, 100, seed=3)
    store = ArrayFeatureStore(color, edges, cls)
    pairs, items, counts = make_scaled_arrays(SAF_U, SAF_I, SAF_POS, seed=0)
    data = types.SimpleNamespace(
        num_items=SAF_I, num_train=len(pairs), train_pairs=pairs, padded_pos=items,
        pos_counts=counts, steps_per_epoch=lambda b: len(pairs) // b)
    cfg = TrainConfig(batch_size=SAF_B, lr=AF_LR, reg=AF_REG)

    def model(host):
        return AttentiveFashion(
            SAF_U, SAF_I, color, edges, cls, embed_k=EMBED_K, attention_layers=(64, 1),
            encoder_hidden=256, dropout_rate=0.5, conv_filters=64, batch_eval=SAF_BATCH_EVAL,
            host_features=host, generator=torch.Generator(device="cuda").manual_seed(4))

    torch.cuda.reset_peak_memory_stats()
    host = model(True)
    if host.tower_route != "kernel" or dict(host.named_buffers()):
        fail(f"streamed AttentiveFashion: route {host.tower_route}, buffers "
             f"{sorted(dict(host.named_buffers()))}")
    strainer = StreamedTrainer(host, data, cfg, store, prefetch_depth=SAF_DEPTH)
    sstate, _ = strainer.init_state()
    tabs = (strainer._train_pairs, strainer._padded_pos, strainer._pos_counts)
    triples = sample_triplets(1, *tabs, SAF_I, SAF_ROUTE_STEPS, SAF_B)
    s_losses = []
    for s in range(SAF_ROUTE_STEPS):
        sstate, loss = strainer.run_streamed_steps(
            sstate, tuple(t[s:s + 1] for t in triples), store, 100 + s)
        s_losses.append(float(loss))
    streamed_peak = torch.cuda.max_memory_allocated() - base
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resident = model(False)
    torch.cuda.synchronize()
    resident_build_s = time.perf_counter() - t0
    rtrainer = Trainer(resident, data, cfg)
    rstate, frozen = rtrainer.init_state()
    r_losses = []
    for s in range(SAF_ROUTE_STEPS):
        rstate, loss = rtrainer.run_steps(rstate, frozen, tuple(t[s:s + 1] for t in triples),
                                          step_key=100 + s)
        r_losses.append(float(loss))
    resident_peak = torch.cuda.max_memory_allocated() - before
    for s, (a, b) in enumerate(zip(s_losses, r_losses)):
        if not (np.isfinite(a) and abs(a - b) <= 1e-5 * abs(b)):
            fail(f"streamed route check step {s}: loss {a!r} (streamed) vs {b!r} (resident)")
    route_err, exempt = route_check(torch, "streamed route check", sstate, rstate,
                                    SAF_ROUTE_STEPS, AF_ROUTE_DRIFT)
    bit_equal = s_losses == r_losses and all(
        torch.equal(p, rstate.params[k]) for k, p in sstate.params.items())
    print(f"streamed route check: {SAF_ROUTE_STEPS} steps at {SAF_B} x {SAF_HW}x{SAF_HW}, "
          f"streamed vs resident, same triples and step seeds: losses {s_losses} vs "
          f"{r_losses}; params/m/v max_abs_err={route_err!r}, {exempt} exempt; bit-equal "
          f"{bit_equal}; resident build {resident_build_s!r} s")

    # the host-blocked evaluation against the resident one
    fwd = E.edge_tower_fwd.launches
    t0 = time.perf_counter()
    ctx_host = host.precompute_eval()
    torch.cuda.synchronize()
    eval_host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx_resident = resident.precompute_eval()
    torch.cuda.synchronize()
    eval_resident_s = time.perf_counter() - t0
    blocks = -(-SAF_I // SAF_BATCH_EVAL)
    if E.edge_tower_fwd.launches - fwd != 2 * blocks:
        fail(f"precompute_eval launched K7 {E.edge_tower_fwd.launches - fwd} times, "
             f"expected {blocks} each")
    eval_err = worst(torch, "streamed precompute_eval", ctx_host, ctx_resident, 1e-6, 1e-7)
    print(f"streamed precompute_eval over {SAF_I} items in {blocks} blocks: host "
          f"{eval_host_s!r} s, resident {eval_resident_s!r} s, max_abs_err {eval_err!r}")
    del resident, rtrainer, rstate, frozen, ctx_host, ctx_resident
    phase_start(torch)  # collects the resident model

    # the main path: 50 steps as an epoch of fit_streamed runs them
    triples = sample_triplets(2, *tabs, SAF_I, SAF_STEPS, SAF_B)
    rngs = [torch.Generator(device="cuda").manual_seed(fold_in(2, STEP_SEED_BASE + s))
            for s in range(SAF_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    N.gather_rows_native.calls = 0
    E.edge_tower_fwd.launches = E.edge_tower_bwd.launches = 0  # main path starts here
    t0 = time.perf_counter()
    sstate, loss = strainer.run_streamed_steps(sstate, triples, store, rngs)
    loss = float(loss)  # waits for the steps
    dt = time.perf_counter() - t0
    launches = {"edge_tower_fwd": E.edge_tower_fwd.launches,
                "edge_tower_bwd": E.edge_tower_bwd.launches}  # main path ends here
    gathers = N.gather_rows_native.calls
    peak = torch.cuda.max_memory_allocated() - base
    want = {"edge_tower_fwd": 2 * SAF_STEPS, "edge_tower_bwd": 2 * SAF_STEPS}
    if launches != want:
        fail(f"streamed main path launched {launches}, expected {want}")
    if gathers != 3 * SAF_STEPS:
        fail(f"streamed main path: {gathers} native gathers, expected 3 a batch "
             f"({3 * SAF_STEPS}): a batch went around the native gather")
    if not np.isfinite(loss):
        fail(f"streamed main path loss {loss!r}")
    stack_bytes = edges.nbytes
    if not peak + stack_bytes // 2 < resident_peak:
        fail(f"streamed peak {peak} B is not well under the resident model's "
             f"{resident_peak} B (the stack is {stack_bytes} B)")
    summary = dict(steps=SAF_STEPS, s=dt, ms_per_step=1e3 * dt / SAF_STEPS,
                   triples_per_s=SAF_STEPS * SAF_B / dt, peak_gib=peak / 2**30,
                   streamed_route_peak_gib=streamed_peak / 2**30,
                   resident_peak_gib=resident_peak / 2**30, stack_bytes=stack_bytes,
                   stack_write_s=stack_s, mean_loss=loss / SAF_STEPS, native_gathers=gathers,
                   route_max_abs_err=route_err, route_exempt=exempt, route_bit_equal=bit_equal,
                   eval_host_s=eval_host_s, eval_resident_s=eval_resident_s,
                   eval_max_abs_err=eval_err)
    print(f"streamed main path: {SAF_STEPS} steps in {dt!r} s, ms_per_step="
          f"{summary['ms_per_step']!r} triples_per_s={summary['triples_per_s']!r}, peak "
          f"{peak / 2**30!r} GiB (resident {resident_peak / 2**30!r} GiB), launches "
          f"{launches}, native gathers {gathers}, mean loss {loss / SAF_STEPS!r}")

    triples = sample_triplets(3, *tabs, SAF_I, SAF_PROFILE_STEPS, SAF_B)
    summary["profile"] = step_profile(
        torch, "streamed", lambda t: strainer.run_streamed_steps(sstate, t, store, 300),
        triples, SAF_PROFILE_STEPS)
    pos, neg = (t[0].cpu().numpy() for t in triples[1:])
    summary["gather"] = gather_rates(torch, np, store, strainer._staging(store, SAF_B),
                                     pos, neg)
    print(f"streamed host gather of one batch ({summary['gather']['bytes']} B, page cache "
          f"warm): {summary['gather']}")
    del strainer, host, sstate, store, edges, triples, tabs
    torch.cuda.empty_cache()  # the stack stays for the bf16 phase, which removes it
    return launches, summary


def streamed_cli_phase(torch, np, E):
    """train_rec --rec attentive_fashion --streamed --edge_hw 224 224 on a
    1024 x 1024 dataset with 224x224 edge tiffs, --resume to a third epoch,
    then serve_rec --streamed, in process."""
    import glob
    import pickle
    import shutil

    from fashionvisualexpl_tpu_torch.cli.serve_rec import serve
    from fashionvisualexpl_tpu_torch.cli.train_rec import train
    from fashionvisualexpl_tpu_torch.data import native as N

    root = SAF_DIR / "cli"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_reference_dataset(np, root / "cli", SAF_CLI_N, SAF_CLI_N)
    write_af_features(np, root / "cli", SAF_CLI_N, SAF_HW)
    write_s = time.perf_counter() - t0
    results = root / "results"
    common = ["--rec", "attentive_fashion", "--dataset", "cli", "--data_root", str(root),
              "--results_root", str(results), "--embed_k", str(EMBED_K), "--top_k",
              str(CLI_K), "--edge_hw", str(SAF_HW), str(SAF_HW), "--batch_eval",
              str(SAF_BATCH_EVAL), "--batch_size", str(SAF_B), "--streamed"]
    N.gather_rows_native.calls = 0
    E.edge_tower_fwd.launches = E.edge_tower_bwd.launches = 0
    t0 = time.perf_counter()
    train(common + ["--epochs", "2", "--verbose", "1"])
    train_s = time.perf_counter() - t0
    launches = {"edge_tower_fwd": E.edge_tower_fwd.launches,
                "edge_tower_bwd": E.edge_tower_bwd.launches}
    stack = np.load(str(root / "cli" / "original" / "features" / "edges_stack.npy"),
                    mmap_mode="r")
    if stack.shape != (SAF_CLI_N, SAF_HW, SAF_HW, 1):
        fail(f"the CLI's edge stack is {stack.shape}")
    steps = 2 * ((SAF_CLI_N * (CLI_PER_USER - 2)) // SAF_B)
    if launches["edge_tower_bwd"] != 2 * steps or N.gather_rows_native.calls < 3 * steps:
        fail(f"streamed CLI: {launches} K7 launches, {N.gather_rows_native.calls} native "
             f"gathers over {steps} steps")
    rdir = results / "rec_results" / "cli" / "attentive_fashion"
    wdir = results / "rec_model_weights" / "cli" / "attentive_fashion"
    names = sorted(os.path.basename(p) for p in glob.glob(str(rdir / "*")))
    patterns = ("recs-2-", "best-recs-", "att-recs-2-", "best-att-recs-", "results-metrics-",
                "log-")
    if len(names) != len(patterns) or not all(
            any(n.startswith(p) for n in names) for p in patterns):
        fail(f"streamed CLI wrote {names}, not the JAX CLI's file set")
    rows = {}
    for name in names:
        if name.endswith(".tsv"):
            table = read_tsv(np, rdir / name, 6 if name.startswith(("att", "best-att")) else 3)
            rows[name] = len(table)
            if len(table) != SAF_CLI_N * CLI_K:
                fail(f"{name}: {len(table)} rows, expected {SAF_CLI_N * CLI_K}")
    (ckpt,) = glob.glob(str(wdir / "ckpt-*"))
    if sorted(os.listdir(ckpt)) != ["1", "2", "best-state"]:
        fail(f"streamed CLI checkpoints {sorted(os.listdir(ckpt))}")
    t0 = time.perf_counter()
    train(common + ["--epochs", "3", "--verbose", "1", "--resume"])
    resume_s = time.perf_counter() - t0
    (pkl,) = glob.glob(str(rdir / "results-metrics-*.pkl"))
    with open(pkl, "rb") as f:
        per_epoch = pickle.load(f)
    vals = np.array([v for m in per_epoch.values() for v in m.values()])
    if sorted(per_epoch) != [3] or "3" not in os.listdir(ckpt) or not (
            np.isfinite(vals).all() and (vals >= 0).all() and (vals <= 1).all()):
        fail(f"streamed CLI --resume: epochs {sorted(per_epoch)}, checkpoints "
             f"{sorted(os.listdir(ckpt))}, metrics {per_epoch}")
    served = root / "served.tsv"
    users = ",".join(str(u * (SAF_CLI_N // CLI_SERVE_USERS)) for u in range(CLI_SERVE_USERS))
    t0 = time.perf_counter()
    serve(common + ["--ckpt", ckpt, "--users", users, "--output", str(served)])
    serve_s = time.perf_counter() - t0
    n_served = len(read_tsv(np, served, 3))
    if n_served != CLI_SERVE_USERS * CLI_K:
        fail(f"serve_rec --streamed wrote {n_served} rows, expected {CLI_SERVE_USERS * CLI_K}")
    launches = {"edge_tower_fwd": E.edge_tower_fwd.launches,
                "edge_tower_bwd": E.edge_tower_bwd.launches}
    print(f"streamed cli: dataset write {write_s!r} s, train_rec (stack build included) "
          f"{train_s!r} s, --resume {resume_s!r} s, serve_rec {serve_s!r} s; K7 launches "
          f"{launches}; rows {rows}; served {n_served}; metrics at epoch 3 {per_epoch[3]}")
    shutil.rmtree(root, ignore_errors=True)
    return launches, dict(write_s=write_s, train_s=train_s, resume_s=resume_s,
                          serve_s=serve_s, stack_bytes=stack.nbytes, metrics=per_epoch[3])


def rows_bound(B: int, W: int):
    """K4 / K5 on B rows of W float32: each row read once and written once,
    the B int32 ids read once; no arithmetic."""
    return bound_ms(4 * (2 * B * W + B), 0, PEAK_F32_FLOPS)


def scatter_routes(S, label, launched, steps=0, tables=()):
    """K5's launches by route since its counts were set to 0: they add up
    to its ``launched`` launches, and with ``tables`` (a packed state's
    user and item tables, each written once a step from rows the step has
    just made, so 16-byte aligned) each table's ``steps`` writes take the
    route its plan names.  Returns them."""
    routes = dict(S.scatter_rows_set.routes)
    want = {}
    for table in tables:
        r = S.scatter_plan(table.shape[1], table.data_ptr(), 0).route
        want[r] = want.get(r, 0) + steps
    if sum(routes.values()) != launched or (tables and routes != want):
        fail(f"{label}: K5 launched {launched} times, by route {routes}"
             + (f", expected {want}" if tables else ""))
    return routes


def gather_timed(torch, G, label, table, ids, flush, warm=False):
    """K4 at one shape: bit-equal to its plain version on the route its
    plan names (a bulk route for rows of BULK_MIN_BYTES or more, a lanes
    route below), then timed with the L2 flushed beside its plain version,
    ``torch.index_select`` and its bound; with ``warm``, K4 and
    ``index_select`` also timed with their rows left in the L2 by the call
    before."""
    R, W = table.shape
    B = ids.shape[0]
    before = dict(G.gather_rows.routes)
    got = G.gather_rows(table, ids)
    torch.cuda.synchronize()
    routes = [k for k, v in G.gather_rows.routes.items() if v != before.get(k, 0)]
    plan = G.gather_plan(W, table.data_ptr(), got.data_ptr())
    bulk = 4 * W >= G.BULK_MIN_BYTES
    if routes != [plan.route] or plan.route.startswith("bulk") != bulk:
        fail(f"gather {label}: launched on {routes}, planned {plan}")
    if not torch.equal(got.view(torch.int32),
                       G.gather_rows_reference(table, ids).view(torch.int32)):
        fail(f"gather kernel disagrees with its plain version at {label}")
    del got
    run = lambda: G.gather_rows(table, ids)  # noqa: E731
    lib = lambda: torch.index_select(table, 0, ids)  # noqa: E731
    b, by = rows_bound(B, W)
    ms, call_ms, _ = kernel_times(torch, f"gather_rows {label}", run, ROW_ITERS, flush, b)
    plain_ms, _, _ = kernel_times(torch, f"gather_rows plain {label}",
                                  lambda: G.gather_rows_reference(table, ids), ROW_ITERS // 2,
                                  flush)
    lib_ms, _, _ = kernel_times(torch, f"gather_rows library {label}", lib, ROW_ITERS, flush)
    check_bound(f"gather_rows {label}", ms, b)
    row = dict(route=plan.route, param=plan.param, piece_bytes=plan.piece_bytes,
               resident_blocks=G.gather_residency(W, plan)[0], max_abs_err=0.0, ms=ms,
               call_ms=call_ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
               library_ms=lib_ms, bound_share=b / ms, beats_library=ms < lib_ms,
               shape=f"R={R} W={W} B={B} f32, cold L2", library="torch.index_select")
    if warm:  # the flushes shrunk to one marker kernel of 256 floats
        row["warm_ms"], _, _ = kernel_times(torch, f"gather_rows warm {label}", run,
                                            ROW_ITERS, flush[:256])
        row["warm_library_ms"], _, _ = kernel_times(
            torch, f"gather_rows library warm {label}", lib, ROW_ITERS, flush[:256])
    print(f"kernel time gather_rows {row['shape']} ({plan.route}, param {plan.param}, "
          f"piece {plan.piece_bytes}, {row['resident_blocks']} blocks an SM): ms={ms!r} "
          f"call_ms={call_ms!r} plain_ms={plain_ms!r} library_ms(torch.index_select)="
          f"{lib_ms!r} bound_ms={b!r} ({by}, {100 * b / ms:.1f}%)"
          + (f" warm_ms={row['warm_ms']!r} warm_library_ms={row['warm_library_ms']!r}"
             if warm else ""))
    return row


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
    before = G.gather_rows.routes["lanes16"]
    err = float((G.gather_rows(table, ids) - G.gather_rows_reference(table, ids)).abs().max())
    if G.gather_rows.routes["lanes16"] != before + 1:
        fail(f"gather at the JAX bench's shape left lanes16: {dict(G.gather_rows.routes)}")
    runs = (lambda: G.gather_rows(table, ids), lambda: G.gather_rows_reference(table, ids),
            lambda: torch.index_select(table, 0, ids))
    rows["gather_rows"] = (err, runs, rows_bound(B, W), f"R={R} W={W} B={B} f32, cold L2",
                           "torch.index_select")
    R, W, B = SCATTER_SHAPE
    stable = torch.randn(R, W, device=dev, generator=g)
    sids64 = torch.randperm(R, device=dev, generator=g)[:B]
    sids = sids64.to(torch.int32)
    vals = torch.randn(B, W, device=dev, generator=g)
    splan = S.scatter_plan(W, stable.data_ptr(), vals.data_ptr())
    before = S.scatter_rows_set.routes[splan.route]
    err = float((S.scatter_rows_set(stable.clone(), sids, vals)
                 - S.scatter_rows_set_reference(stable.clone(), sids, vals)).abs().max())
    if S.scatter_rows_set.routes[splan.route] != before + 1:
        fail(f"scatter at the JAX bench's shape left {splan.route}: "
             f"{dict(S.scatter_rows_set.routes)}")
    runs = (lambda: S.scatter_rows_set(stable, sids, vals),
            lambda: S.scatter_rows_set_reference(stable, sids, vals),
            lambda: stable.index_copy_(0, sids64, vals))
    rows["scatter_rows_set"] = (err, runs, rows_bound(B, W), f"R={R} W={W} B={B} f32, cold L2",
                                "Tensor.index_copy_ (int64 ids)")
    out = {}
    route = {"gather_rows": "lanes16", "scatter_rows_set": splan.route}
    for name, (err, (run, plain, lib), (b, by), shape, library) in rows.items():
        ms, call_ms, _ = kernel_times(torch, name, run, ROW_ITERS, flush, b)
        plain_ms, _, _ = kernel_times(torch, f"{name} plain", plain, ROW_ITERS // 2, flush)
        lib_ms, _, _ = kernel_times(torch, f"{name} library", lib, ROW_ITERS, flush)
        check_bound(name, ms, b)
        out[name] = dict(route=route[name], max_abs_err=err, ms=ms, call_ms=call_ms,
                         plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=lib_ms,
                         shape=shape, library=library)
        print(f"kernel time {name} {shape} ({route[name]}): ms={ms!r} call_ms={call_ms!r} "
              f"plain_ms={plain_ms!r} library_ms({library})={lib_ms!r} bound_ms={b!r} ({by})")
    del table, stable, vals
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    grid = {}
    for W in GATHER_NARROW:  # K4 at the narrow widths, R=1M, B=16,384
        table = torch.randn(ROW_TABLE, W, device=dev, generator=g)
        ids = torch.randint(0, ROW_TABLE, (GATHER_B,), device=dev, generator=g,
                            dtype=torch.int32)
        grid[f"W={W} B={GATHER_B}"] = gather_timed(
            torch, G, f"R={ROW_TABLE} W={W} B={GATHER_B}", table, ids, flush, warm=True)
        del table
        torch.cuda.empty_cache()
    print(f"gather timing grid, narrow widths: {time.perf_counter() - t0!r} s")
    out["fused"] = fused_row_phase(torch, G, S, bits, flush)
    out["gather_rows"]["grid"] = {**grid, **out["fused"].pop("gather_grid")}
    del flush
    torch.cuda.empty_cache()
    for name, bench in (("bench_gather", G.bench_gather), ("bench_scatter", S.bench_scatter)):
        kernel_ms, torch_ms = bench()
        out[name] = dict(kernel_ms=kernel_ms, torch_ms=torch_ms)
        print(f"{name}(): kernel_ms={kernel_ms!r} torch_ms={torch_ms!r} "
              f"speedup={torch_ms / kernel_ms!r}")
        torch.cuda.empty_cache()
    return out


def fused_row_widths(torch):
    """{label: width} of VBPR's and GradFashion's packed rows at the CLI's
    default widths with fp32 and bf16 moments, from their packed_spec:
    rows packed for two users and items, frozen columns fused."""
    from fashionvisualexpl_tpu_torch.models.grad_fashion import GradFashion
    from fashionvisualexpl_tpu_torch.models.vbpr import VBPR
    from fashionvisualexpl_tpu_torch.train import packed_generic as PG

    def zeros(w):
        return torch.zeros(2, w, device="cuda")

    models = {
        "vbpr": VBPR(2, 2, zeros(VIS_DIM_F), embed_k=EMBED_K, embed_d=VIS_EMBED_D),
        "grad_fashion": GradFashion(2, 2, zeros(VIS_DIM_C), zeros(VIS_DIM_F), embed_k=EMBED_K,
                                    embed_d=VIS_EMBED_D, embed_color=VIS_EMBED_FAMILY,
                                    embed_edges=VIS_EMBED_FAMILY),
    }
    out = {}
    for name, model in models.items():
        for md in ("float32", "bfloat16"):
            st = PG.pack_generic_state(model, dict(model.named_parameters()),
                                       frozen=dict(model.named_buffers()), moment_dtype=md)
            out[f"{name} users {md}"] = st.user_pmv.shape[1]
            out[f"{name} items {md}"] = st.item_pmv.shape[1]
    return out


def fused_row_phase(torch, G, S, bits, flush):
    """K4 and K5 at the fused row widths: bit for bit against their plain
    versions over a 100k-row table at the packed step's unique-row counts,
    then timed at 24,576 rows of a 500k-row table (VBPR's and GradFashion's
    catalog) with fp32 moments, beside their bounds, plain versions and
    ``torch.index_select`` / ``Tensor.index_copy_``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    t0 = time.perf_counter()
    widths = fused_row_widths(torch)
    print(f"fused row widths: {widths}")
    for W in sorted(set(widths.values())):
        table = bits(VIS_ROW_TABLE, W)
        for B in ROW_BATCHES:
            gids = torch.randint(0, VIS_ROW_TABLE, (B,), device=dev, generator=g,
                                 dtype=torch.int32)
            sids = torch.randperm(VIS_ROW_TABLE, device=dev, generator=g)[:B].to(torch.int32)
            gids[-B // 4:] = sids[-B // 4:] = 2**30  # the dedupe's pads
            vals = bits(B, W)
            got = G.gather_rows(table, gids)
            kern = S.scatter_rows_set(table.clone(), sids, vals)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32),
                               G.gather_rows_reference(table, gids).view(torch.int32)):
                fail(f"gather kernel disagrees with its plain version at fused width {W} B={B}")
            plain = S.scatter_rows_set_reference(table.clone(), sids, vals)
            if not torch.equal(kern.view(torch.int32), plain.view(torch.int32)):
                fail(f"scatter kernel disagrees with its plain version at fused width {W} B={B}")
            print(f"kernel check rows R={VIS_ROW_TABLE} W={W} B={B}: gather and scatter "
                  f"bit-equal ok")
            del kern, plain
        del table
        torch.cuda.empty_cache()
    out = {}
    R, B = EVAL_I, VIS_ROW_TIMED
    for label in ("vbpr items float32", "grad_fashion items float32"):
        W = widths[label]
        table = torch.randn(R, W, device=dev, generator=g)
        ids = torch.randint(0, R, (B,), device=dev, generator=g, dtype=torch.int32)
        sids64 = torch.randperm(R, device=dev, generator=g)[:B]
        sids = sids64.to(torch.int32)
        vals = torch.randn(B, W, device=dev, generator=g)
        out[label] = {}
        for name, run, plain, lib, library in (
            ("gather_rows", lambda: G.gather_rows(table, ids),
             lambda: G.gather_rows_reference(table, ids),
             lambda: torch.index_select(table, 0, ids), "torch.index_select"),
            ("scatter_rows_set", lambda: S.scatter_rows_set(table, sids, vals),
             lambda: S.scatter_rows_set_reference(table, sids, vals),
             lambda: table.index_copy_(0, sids64, vals), "Tensor.index_copy_ (int64 ids)"),
        ):
            if name == "gather_rows":
                before = dict(G.gather_rows.routes)
                err = float((run() - plain()).abs().max())
                if G.gather_rows.routes["bulk_store"] != before.get("bulk_store", 0) + 1:
                    fail(f"gather at W={W} B={B} left bulk_store: {dict(G.gather_rows.routes)}")
            else:  # the scattered rows, read back, against the values
                plan = S.scatter_plan(W, table.data_ptr(), vals.data_ptr())
                before = S.scatter_rows_set.routes[plan.route]
                run()
                err = float((table[sids64] - vals).abs().max())
                if S.scatter_rows_set.routes[plan.route] != before + 1 \
                        or not plan.route.startswith("bulk"):
                    fail(f"scatter at W={W} B={B} left {plan.route}: "
                         f"{dict(S.scatter_rows_set.routes)}")
            b, by = rows_bound(B, W)
            ms, call_ms, _ = kernel_times(torch, f"{name} W={W}", run, ROW_ITERS, flush, b)
            plain_ms, _, _ = kernel_times(torch, f"{name} plain W={W}", plain, ROW_ITERS // 2,
                                          flush)
            lib_ms, _, _ = kernel_times(torch, f"{name} library W={W}", lib, ROW_ITERS, flush)
            check_bound(f"{name} W={W}", ms, b)
            shape = f"R={R} W={W} ({label}) B={B} f32, cold L2"
            route = "bulk_store" if name == "gather_rows" else plan.route
            out[label][name] = dict(route=route, max_abs_err=err, ms=ms, call_ms=call_ms,
                                    plain_ms=plain_ms, bound_ms=b, bound_by=by,
                                    library_ms=lib_ms, shape=shape, library=library)
            print(f"kernel time {name} {shape} ({route}): ms={ms!r} call_ms={call_ms!r} "
                  f"plain_ms={plain_ms!r} library_ms({library})={lib_ms!r} bound_ms={b!r} "
                  f"({by}, {100 * b / ms:.1f}%)")
        del table, vals
        torch.cuda.empty_cache()
    out["gather_grid"] = {}
    for W in GATHER_WIDE:  # K4 at the item rows, R=500k, B=16,384
        table = torch.randn(R, W, device=dev, generator=g)
        ids = torch.randint(0, R, (GATHER_B,), device=dev, generator=g, dtype=torch.int32)
        out["gather_grid"][f"W={W} B={GATHER_B}"] = gather_timed(
            torch, G, f"R={R} W={W} B={GATHER_B}", table, ids, flush)
        del table
        torch.cuda.empty_cache()
    print(f"fused row widths phase: {time.perf_counter() - t0!r} s")
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


def packed_groups(PG, spec, md, fused=False):
    """(table, [(label, param column, width, moment columns, kind)], tau
    column, first column that passes through the step unchanged: the
    fused frozen columns, tau and the pads) of the packed user and item
    rows."""
    Wu, Wi = (sum(w for _, w in tables) for tables in (spec.user_tables, spec.item_tables))
    gs, mw_u, mw_i = PG._scalar_group(md), PG._mom_width(md, Wu), PG._mom_width(md, Wi)
    items = [("+".join(n for n, _ in spec.item_tables), 0, Wi, (Wi, Wi + mw_i), md)]
    for j, sname in enumerate(spec.item_scalars):
        c = Wi + mw_i + gs * j  # scalars: [p | m | v], or [p | bf16 pair]
        items.append((sname, c, 1, (c + 1, c + gs), "float32" if gs == 3 else "bfloat16"))
    F0 = Wi + mw_i + gs * len(spec.item_scalars)
    frozen_w = sum(w for _, w in spec.frozen_item_tables) if fused else 0
    return (("user_pmv", [("+".join(n for n, _ in spec.user_tables), 0, Wu, (Wu, Wu + mw_u),
                           md)], Wu + mw_u, Wu + mw_u),
            ("item_pmv", items, F0 + frozen_w, F0))


def decode_moments(PG, cols, w, kind):
    if kind == "float32":
        return cols[:, :w], cols[:, w:]
    if kind == "bfloat16":
        return PG._mv_unpack(cols)
    return PG._mv_unpack_fp8(cols, w)


def packed_route_check(torch, PG, label, kern, plain, spec, md, steps, lr, fused=False,
                       dense_slack=None, at_floor=False):
    """The packed states after the same steps by the kernel route (card)
    and the plain route (CPU copies): fused frozen, tau and row_align pad
    columns bit-equal, untouched rows bit-equal, touched rows' params and decoded
    moments within the route tolerances (see PACKED_FLIP_CAP); dense m, v
    within them, dense params too but where sqrt(v_hat) is tiny (within
    the drift there).  ``dense_slack`` ({param: (m slack, v slack)}, see
    ``dense_sum_slack``) widens a dense param's m and v by its rounding
    slack, and lets its params drift where that slack passes the route
    tolerance.  ``at_floor`` lets a dense param drift where its m agrees
    only within the absolute floor (see ``route_check``).  Returns (max
    err, values beyond)."""
    err_max, beyond = 0.0, 0
    bc2 = 1.0 - 0.999**steps
    for name, groups, tau, keep in packed_groups(PG, spec, md, fused):
        a = getattr(kern, name)
        b = getattr(plain, name).to(a.device)  # compared on the card
        ai, bi = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(ai[:, keep:], bi[:, keep:]):
            fail(f"{label} {name}: frozen, tau or pad columns differ between routes")
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
    for name, pmv in plain.dense.items():
        (p, m, v), (kp, km, kv) = ([PG._flat_dense(name, x) for x in t]
                                   for t in (pmv, kern.dense[name]))
        for k in p:
            slack = (dense_slack or {}).get(k)
            for f, x, y, j in (("m", km[k], m[k], 0), ("v", kv[k], v[k], 1)):
                if slack is None:
                    err_max = max(err_max, worst(torch, f"{label} {k} {f}", x.cpu(), y,
                                                 ROUTE_RTOL, ROUTE_ATOL))
                    continue
                e, n = capped_close(f"{label} {k} {f}", x.cpu(), y, ROUTE_RTOL, ROUTE_ATOL,
                                    1.0, ROUTE_ATOL + slack[j].cpu())
                err_max, beyond = max(err_max, e), beyond + n
            tiny = torch.sqrt(v[k] / bc2) < 10 * 1e-7
            if slack is not None:  # a gradient summed below its rounding
                tiny |= slack[0].cpu() > ROUTE_RTOL * m[k].abs()
            if at_floor:
                tiny |= (km[k].cpu() - m[k]).abs() > ROUTE_RTOL * m[k].abs()
            e, n = capped_close(f"{label} {k} p", kp[k].cpu(), p[k], ROUTE_RTOL,
                                ROUTE_ATOL, 1.0, 2 * lr * steps, tiny)
            err_max, beyond = max(err_max, e), beyond + n
    return err_max, beyond


def dense_sum_slack(slack, S, n: int):
    """Accumulate into ``slack`` ({param: (m slack, v slack)}) a step's
    bound on how far two routes' dense Adam moments may part.  ``S``
    ({param: tensor}) bounds each gradient entry's sum of |terms| over the
    step's n batch rows; two f32 sums of n terms in different orders differ
    by about sqrt(n) ulps of that (a statistical bound, taken twice: one
    rounding per route).  m = sum (1-b1) b1^(t-k) g_k moves by (1-b1) times
    that; v = sum (1-b2) b2^(t-k) g_k^2 by (1-b2) 2 |g_k| times it, |g_k|
    <= S.  Earlier steps' slack decays as the moments do."""
    eps = 2 * n**0.5 * 2.0**-24
    for k, s_k in S.items():
        m_sl, v_sl = slack.get(k, (0.0, 0.0))
        slack[k] = (0.9 * m_sl + 0.1 * eps * s_k, 0.999 * v_sl + 0.001 * 2 * eps * s_k * s_k)
    return slack


def state_on(torch, state, device="cpu", model=None):
    """A copy of a train state, packed or generic (tuples and dicts of
    tensors), on ``device`` (the CPU: the plain route's start); with
    ``model``, a generic state's params are the model's own parameters
    (which its ``loss`` reads), set to the state's values."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, copy=True)
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        return type(x)(*map(copy, x)) if hasattr(x, "_fields") else tuple(map(copy, x))

    out = copy(state)
    if model is not None:
        params = dict(model.named_parameters())
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(out.params[k])
        out = out._replace(params=params)
    return out


CONV_TAGS = ("conv", "fprop", "dgrad", "wgrad", "winograd", "implicit")


def step_profile(torch, label, run, triples, n: int):
    """One torch.profiler pass over ``run(triples)`` (n steps): wall and
    device ms a step, device operations a step, the idle share and the
    shares of device time of K4, K5, K7, the convolutions, the GEMMs and of
    kernels named for TF32."""
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
    share = {k: sum(us for us, key, _ in ops if any(t in key for t in tags)) / busy
             for k, tags in (("k4", ("gather_lanes_kernel", "gather_bulk_kernel")),
                             ("k5", ("scatter_lanes_kernel", "scatter_bulk_kernel")),
                             ("k7", ("edge_",)), ("tf32", ("tf32",)))}
    # cuDNN's convolutions (forward, data and weight gradients) and the
    # GEMMs (cuBLAS; the CNN's FCs and the families' projections)
    conv = [any(t in key.lower() for t in CONV_TAGS) for _, key, _ in ops]
    share["conv"] = sum(us for (us, _, _), c in zip(ops, conv) if c) / busy
    share["gemm"] = sum(us for (us, key, _), c in zip(ops, conv)
                        if not c and "gemm" in key.lower()) / busy
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
        plain = state_on(torch, kern)
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
    G.gather_rows.launches = S.scatter_rows_set.launches = 0
    S.scatter_rows_set.routes.clear()
    G.gather_rows.routes.clear()  # main path starts here
    t0 = time.perf_counter()
    inner, loss = epoch_fn(state.inner, frozen, 100, *tabs)
    loss = float(loss)  # waits for the epoch
    dt = time.perf_counter() - t0
    launches = {"gather_rows": G.gather_rows.launches,
                "scatter_rows_set": S.scatter_rows_set.launches}  # main path ends here
    gather_routes = dict(G.gather_rows.routes)
    peak = torch.cuda.max_memory_allocated() - start  # the phase's own peak
    want = {"gather_rows": 4 * PACKED_STEPS, "scatter_rows_set": 2 * PACKED_STEPS}
    scatter = scatter_routes(S, "packed main path", launches["scatter_rows_set"],
                             PACKED_STEPS, (inner.user_pmv, inner.item_pmv))
    if launches != want:
        fail(f"packed main path launched {launches}, expected {want}")
    if not np.isfinite(loss) or int(inner.step) != PACKED_STEPS:
        fail(f"packed epoch: loss {loss!r}, step {int(inner.step)}")
    summary = dict(steps=PACKED_STEPS, s=dt, triples_per_s=PACKED_STEPS * TRAIN_B / dt,
                   ms_per_step=1e3 * dt / PACKED_STEPS, peak_gib=peak / 2**30,
                   start_gib=start / 2**30, mean_loss=loss / PACKED_STEPS, route=route,
                   gather_routes=gather_routes, scatter_routes=scatter)
    print(f"packed train main path: {PACKED_STEPS} steps in {dt!r} s (sampling included), "
          f"triples_per_s={summary['triples_per_s']!r} ms_per_step={summary['ms_per_step']!r}"
          f", the phase's own peak {peak / 2**30!r} GiB (allocated when it began "
          f"{start / 2**30!r}), launches {launches}, K4 routes {gather_routes}, K5 routes "
          f"{scatter}")

    state = state.with_inner(inner)
    summary["profile"] = step_profile(
        torch, "packed", lambda tr: trainer.run_steps(state, frozen, tr, step_key=300),
        sample_triplets(200, *tabs, TRAIN_I, PACKED_PROFILE_STEPS, TRAIN_B),
        PACKED_PROFILE_STEPS)
    del trainer, model, state, inner, tabs
    torch.cuda.empty_cache()
    return launches, summary


def as_generic(torch, PG, st):
    """A specialized packed state (``train/packed.py``) in the generic
    engine's layout, tau as a last float32 column, for
    ``packed_route_check``."""
    return PG.GenericPackedState(
        st.step, torch.cat([st.user_pmv, st.tau_u.to(torch.float32)[:, None]], dim=1),
        torch.cat([st.item_pmv, st.tau_i.to(torch.float32)[:, None]], dim=1),
        st.dense)


def spec_dense_slack(torch, kind, st, batch, frozen, slack):
    """``dense_sum_slack`` for a specialized VBPR or GradFashion step on
    ``batch`` from state ``st``: each dense gradient entry's bound on its
    sum of |terms| over the 2B item rows (|sigmoid| <= 1); ``frozen`` the
    model's buffers.  VBPR: Bp's terms F_ij, E's F_ij Tu_d (vbpr_phase's).
    GradFashion, vf = [Fc Ec | Fe Ee]: Bp's |vf_ij|, E's |vf_ij| |Tu_d|,
    Ec's and Ee's |F_ij| times the largest |d score / d vf_k| = |Tu|
    |E_k|^T + |Bp_k|."""
    D = VIS_EMBED_D
    ii = torch.cat(batch[1:]).long()
    tu = st.user_pmv[batch[0].long(), EMBED_K:EMBED_K + D].abs()
    if kind == "vbpr":
        f_sum = frozen["F"][ii].sum(0)
        S = {"Bp": f_sum[:, None], "E": f_sum[:, None] * tu.amax(0)[None, :]}
    else:
        Fc, Fe = frozen["Fc"], frozen["Fe"]
        dense = {n: x[0].abs() for n, x in st.dense.items()}
        c, e = Fc[ii].abs(), Fe[ii].abs()
        vf_sum = torch.cat([c @ dense["Ec"], e @ dense["Ee"]], dim=1).sum(0)
        g_vf = (tu @ dense["E"].T + dense["Bp"][:, 0]).amax(0)
        ec = dense["Ec"].shape[1]
        S = {"Bp": vf_sum[:, None], "E": vf_sum[:, None] * tu.amax(0)[None, :],
             "Ec": c.sum(0)[:, None] * g_vf[None, :ec], "Ee": e.sum(0)[:, None] * g_vf[None, ec:]}
    return dense_sum_slack(slack, S, 2 * TRAIN_B)


def specialized_epochs(torch, np, G, S, label, runs, steps, extra):
    """The specialized and the generic packed epochs of one model on the
    same arrays and seed, timed in turns (specialized, generic, generic,
    specialized), each from a fresh state.  ``runs`` maps "specialized" /
    "generic" to (fresh state, epoch(state) -> (state, loss)).  K4's and
    K5's launches are counted over the first specialized epoch, the main
    path (4 and 2 a step).  ``extra`` joins the summary.  Returns
    (launches, summary)."""
    out = {"specialized": [], "generic": []}
    launches = routes = scatter = None
    for engine in ("specialized", "generic", "generic", "specialized"):
        make_state, epoch = runs[engine]
        state = make_state()
        torch.cuda.synchronize()
        main = engine == "specialized" and launches is None
        if main:
            G.gather_rows.launches = S.scatter_rows_set.launches = 0
            S.scatter_rows_set.routes.clear()
            G.gather_rows.routes.clear()  # the specialized main path starts here
        t0 = time.perf_counter()
        state, loss = epoch(state)
        loss = float(loss)  # waits for the epoch
        dt = time.perf_counter() - t0
        if main:
            launches = {"gather_rows": G.gather_rows.launches,
                        "scatter_rows_set": S.scatter_rows_set.launches}  # ... ends here
            routes = dict(G.gather_rows.routes)
            scatter = scatter_routes(S, f"{label} specialized epoch",
                                     launches["scatter_rows_set"], steps,
                                     (state.user_pmv, state.item_pmv))
            want = {"gather_rows": 4 * steps, "scatter_rows_set": 2 * steps}
            if launches != want:
                fail(f"{label} specialized epoch launched {launches}, expected {want}")
        if not np.isfinite(loss) or int(state.step) != steps:
            fail(f"{label} {engine} epoch: loss {loss!r}, step {int(state.step)}")
        out[engine].append(dict(ms_per_step=1e3 * dt / steps, mean_loss=loss / steps))
        del state
        torch.cuda.empty_cache()
    summary = {e: dict(ms_per_step=[r["ms_per_step"] for r in rs],
                       mean_loss=rs[0]["mean_loss"]) for e, rs in out.items()}
    summary.update(steps=steps, batch=TRAIN_B, gather_routes=routes, scatter_routes=scatter,
                   **extra)
    print(f"{label} epochs of {steps} steps, specialized vs generic (in turns s, g, g, s): "
          f"{summary}; K4 routes {routes}, K5 routes {scatter}, launches {launches}")
    return launches, summary


def specialized_phase(torch, np, G, S):
    """The specialized packed steps (``train/packed.py``) at full width:
    BPRMF at the packed phase's configuration (3 steps on the card against
    CPU copies, and against the generic engine's 3 steps from the same
    params; a 200-step epoch beside the generic engine's), then VBPR and
    GradFashion at the CLI's widths over the same arrays (3 steps on a
    20k x 20k catalog against CPU copies; a 200-step epoch each beside the
    generic engine's, the frozen features read by id in both)."""
    from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
    from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
    from fashionvisualexpl_tpu_torch.models.grad_fashion import GradFashion
    from fashionvisualexpl_tpu_torch.models.vbpr import VBPR
    from fashionvisualexpl_tpu_torch.train import packed as P
    from fashionvisualexpl_tpu_torch.train import packed_generic as PG

    phase_t0 = time.perf_counter()
    dev = torch.device("cuda")
    start = phase_start(torch)
    torch.cuda.reset_peak_memory_stats()
    pairs, items, counts = make_scaled_arrays(TRAIN_U, TRAIN_I, TRAIN_POS, seed=0)
    tabs = tuple(torch.as_tensor(x, device=dev) for x in (pairs, items, counts))
    del pairs, items, counts
    g = torch.Generator(device=dev).manual_seed(23)
    launches, summary = {}, {}

    # BPRMF: the route (card vs CPU copies) and the generic engine's steps
    model = BPRMF(TRAIN_U, TRAIN_I, embed_k=EMBED_K, generator=g)
    params = dict(model.named_parameters())
    triples = sample_triplets(7, *tabs, TRAIN_I, PACKED_ROUTE_STEPS, TRAIN_B)
    kern = P.pack_bprmf_state(params)
    plain = state_on(torch, kern)
    gen = PG.pack_generic_state(model, params)
    step = P.make_packed_step(model, TRAIN_LR, TRAIN_REG)
    gstep = PG.make_generic_packed_step(model, TRAIN_LR, TRAIN_REG)
    losses = []
    for s in range(PACKED_ROUTE_STEPS):
        batch = tuple(t[s] for t in triples)
        kern, lk = step(kern, batch)
        plain, lp = step(plain, tuple(x.cpu() for x in batch))
        gen, lg = gstep(gen, (None, batch, None))
        lk, lp, lg = float(lk), float(lp), float(lg)
        if not (np.isfinite(lk) and abs(lk - lp) <= 1e-5 * abs(lp)
                and abs(lk - lg) <= 1e-5 * abs(lg)):
            fail(f"bprmf specialized step {s}: loss {lk!r} (card) vs {lp!r} (CPU) vs "
                 f"{lg!r} (generic engine)")
        losses.append((lk, lp, lg))
    spec = model.packed_spec()
    err, beyond = packed_route_check(torch, PG, "bprmf specialized route",
                                     as_generic(torch, PG, kern), as_generic(torch, PG, plain),
                                     spec, "float32", PACKED_ROUTE_STEPS, TRAIN_LR)
    gerr, gbeyond = packed_route_check(torch, PG, "bprmf specialized vs generic", gen,
                                       as_generic(torch, PG, kern), spec, "float32",
                                       PACKED_ROUTE_STEPS, TRAIN_LR)
    summary["bprmf"] = dict(route=dict(max_abs_err=err, beyond=beyond),
                            vs_generic=dict(max_abs_err=gerr, beyond=gbeyond),
                            widths=[kern.user_pmv.shape[1], kern.item_pmv.shape[1]])
    print(f"bprmf specialized: {PACKED_ROUTE_STEPS} full-width steps, losses (card, CPU, "
          f"generic) {losses}; card vs CPU max_abs_err={err!r} ({beyond} values one drift "
          f"apart), vs the generic engine on the card max_abs_err={gerr!r} ({gbeyond}); tau, "
          f"pads and untouched rows bit-equal ok")
    del kern, plain, gen
    torch.cuda.empty_cache()

    sepoch = P.make_packed_epoch_fn(model, TRAIN_LR, TRAIN_REG, TRAIN_I, PACKED_STEPS,
                                    TRAIN_B)
    gepoch = PG.make_generic_packed_epoch_fn(model, TRAIN_LR, TRAIN_REG, TRAIN_I,
                                             PACKED_STEPS, TRAIN_B)
    launches["bprmf"], epochs = specialized_epochs(
        torch, np, G, S, "bprmf", {
            "specialized": (lambda: P.pack_bprmf_state(params),
                            lambda st: sepoch(st, 110, *tabs)),
            "generic": (lambda: PG.pack_generic_state(model, params),
                        lambda st: gepoch(st, None, 110, *tabs))},
        PACKED_STEPS, {})
    summary["bprmf"].update(epochs)
    del model, params
    torch.cuda.empty_cache()

    # VBPR and GradFashion at the CLI's widths over the same arrays
    for kind in ("vbpr", "grad_fashion"):
        t0 = time.perf_counter()
        # maxabs-normalized non-negative features on the 1/64 grid, made on the card
        feats = [torch.rand(TRAIN_I, w, device=dev, generator=g).mul_(64).round_().div_(64)
                 for w in ((VIS_DIM_F,) if kind == "vbpr" else (VIS_DIM_C, VIS_DIM_F))]

        def make(n, feats=feats, kind=kind):
            if kind == "vbpr":
                return VBPR(n[0], n[1], feats[0][:n[1]], embed_k=EMBED_K, embed_d=VIS_EMBED_D,
                            generator=g)
            return GradFashion(n[0], n[1], feats[0][:n[1]], feats[1][:n[1]], embed_k=EMBED_K,
                               embed_d=VIS_EMBED_D, embed_color=VIS_EMBED_FAMILY,
                               embed_edges=VIS_EMBED_FAMILY, generator=g)

        pack = P.pack_vbpr_state if kind == "vbpr" else P.pack_grad_fashion_state

        # the route: 3 steps on a 20k x 20k catalog, each on the card and on
        # a CPU copy of the card's state before it.  Carried over steps, the
        # routes would part by more than a step's rounding: Adam's first
        # steps move a dense entry whose gradient sums to about 0 by about
        # lr either way, and the dense E, Bp (Ec, Ee) then feed every row's
        # next gradient
        small = make((VIS_ROUTE_N, VIS_ROUTE_N))
        kern = pack(dict(small.named_parameters()))
        step = P.make_packed_step(small, TRAIN_LR, TRAIN_REG)
        fr = dict(small.named_buffers())
        fr_cpu = {k: v.cpu() for k, v in fr.items()}
        losses, err, beyond = [], 0.0, 0
        for s in range(VIS_ROUTE_STEPS):
            batch = tuple(torch.randint(0, VIS_ROUTE_N, (TRAIN_B,), device=dev, generator=g,
                                        dtype=torch.int32) for _ in range(3))
            plain = state_on(torch, kern)
            slack = spec_dense_slack(torch, kind, kern, batch, fr, {})
            kern, lk = step(kern, batch, frozen=fr)
            plain, lp = step(plain, tuple(x.cpu() for x in batch), frozen=fr_cpu)
            lk, lp = float(lk), float(lp)
            if not (np.isfinite(lk) and abs(lk - lp) <= 1e-5 * abs(lp)):
                fail(f"{kind} specialized step {s}: loss {lk!r} (card) vs {lp!r} (CPU)")
            losses.append((lk, lp))
            e, n = packed_route_check(torch, PG, f"{kind} specialized route step {s}",
                                      as_generic(torch, PG, kern),
                                      as_generic(torch, PG, plain), small.packed_spec(),
                                      "float32", s + 1, TRAIN_LR, dense_slack=slack)
            err, beyond = max(err, e), beyond + n
        summary[kind] = dict(route=dict(max_abs_err=err, beyond=beyond),
                             widths=[kern.user_pmv.shape[1], kern.item_pmv.shape[1]])
        print(f"{kind} specialized: {VIS_ROUTE_STEPS} steps at batch {TRAIN_B} on a "
              f"{VIS_ROUTE_N} x {VIS_ROUTE_N} catalog, each on the card and on a CPU copy "
              f"of the card's state, losses {losses}; "
              f"max_abs_err={err!r}, {beyond} values drift apart; tau, pads and untouched "
              f"rows bit-equal ok")
        del small, kern, plain, step, fr, fr_cpu

        # the epochs at full size, the frozen features read by id in both engines
        model = make((TRAIN_U, TRAIN_I))
        params, frozen = dict(model.named_parameters()), dict(model.named_buffers())
        sepoch = P.make_packed_epoch_fn(model, TRAIN_LR, TRAIN_REG, TRAIN_I, VIS_STEPS,
                                        TRAIN_B)
        gepoch = PG.make_generic_packed_epoch_fn(model, TRAIN_LR, TRAIN_REG, TRAIN_I,
                                                 VIS_STEPS, TRAIN_B)
        launches[kind], epochs = specialized_epochs(
            torch, np, G, S, kind, {
                "specialized": (lambda: pack(params),
                                lambda st: sepoch(st, 111, *tabs, frozen=frozen)),
                "generic": (lambda: PG.pack_generic_state(model, params),
                            lambda st: gepoch(st, frozen, 111, *tabs))},
            VIS_STEPS, dict(setup_and_route_s=time.perf_counter() - t0))
        summary[kind].update(epochs)
        del model, params, frozen, feats, sepoch, gepoch
        torch.cuda.empty_cache()
    summary["peak_gib"] = (torch.cuda.max_memory_allocated() - start) / 2**30
    summary["phase_s"] = time.perf_counter() - phase_t0
    print(f"specialized phase: {summary['phase_s']!r} s")
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
    plain = state_on(torch, state.inner)
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
    S.scatter_rows_set.routes.clear()
    G.gather_rows.routes.clear()
    E.edge_tower_fwd.launches = E.edge_tower_bwd.launches = 0  # main path starts here
    t0 = time.perf_counter()
    state, loss = trainer.run_steps(state, frozen, triples, step_key=200)
    loss = float(loss)
    dt = time.perf_counter() - t0
    launches = {"gather_rows": G.gather_rows.launches,
                "scatter_rows_set": S.scatter_rows_set.launches,
                "edge_tower_fwd": E.edge_tower_fwd.launches,
                "edge_tower_bwd": E.edge_tower_bwd.launches}  # main path ends here
    gather_routes = dict(G.gather_rows.routes)
    scatter = scatter_routes(S, "af packed main path", launches["scatter_rows_set"],
                             AF_PACKED_STEPS, (state.inner.user_pmv, state.inner.item_pmv))
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
                   route_exempt=beyond, route_losses=losses, gather_routes=gather_routes,
                   scatter_routes=scatter)
    print(f"af packed main path: {n} steps in {dt!r} s, ms_per_step={summary['ms_per_step']!r}"
          f" triples_per_s={summary['triples_per_s']!r}, the phase's own peak "
          f"{peak / 2**30!r} GiB (allocated when it began {start / 2**30!r}), "
          f"launches {launches}, K4 routes {gather_routes}, K5 routes {scatter}")
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
    G.gather_rows.launches = S.scatter_rows_set.launches = 0
    S.scatter_rows_set.routes.clear()
    G.gather_rows.routes.clear()  # main path starts here
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
    gather_routes = dict(G.gather_rows.routes)
    scatter = scatter_routes(S, "packed cli", launches["scatter_rows_set"])
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
          f", K4 routes {gather_routes}, K5 routes {scatter}; metrics epoch 2 {per_epoch[2]}")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    return launches, dict(train_s=train_s, serve_s=serve_s, metrics=per_epoch[2],
                          gather_routes=gather_routes, scatter_routes=scatter)


def vbpr_phase(torch, np, counts, segmax, G, S, data):
    """VBPR at full width (K=128, d=20, dim_f=4096) over the evaluation
    phase's 1M users x 500k items and its Interactions: the packed route (3
    steps on the card against CPU copies, a 20k x 20k catalog), one packed
    epoch of 200 steps with the frozen columns fused (4 K4 + 2 K5 a step)
    and a 10-step profile,
    50 generic Trainer steps, a 200-step fast epoch, RecServer through K3
    at D=148 (64 users against a full-catalog fp32 oracle), then
    FactoredEvaluator through K2 at D=148 on the 1/64 grid (exact scores:
    the first user blocks equal through the bucketed engine)."""
    from fashionvisualexpl_tpu_torch.core.config import TrainConfig
    from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
    from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator
    from fashionvisualexpl_tpu_torch.models.vbpr import VBPR
    from fashionvisualexpl_tpu_torch.serve import RecServer
    from fashionvisualexpl_tpu_torch.train import fast as FT
    from fashionvisualexpl_tpu_torch.train import packed_generic as PG
    from fashionvisualexpl_tpu_torch.train.trainer import Trainer

    phase_t0 = t0 = time.perf_counter()
    dev = torch.device("cuda")
    start = phase_start(torch)
    g = torch.Generator(device=dev).manual_seed(22)
    U, I = data.num_users, data.num_items
    # maxabs-normalized non-negative features on the 1/64 grid, made on the card
    F = torch.rand(I, VIS_DIM_F, device=dev, generator=g).mul_(64).round_().div_(64)
    model = VBPR(U, I, F, embed_k=EMBED_K, embed_d=VIS_EMBED_D, generator=g)
    del F
    torch.cuda.synchronize()
    summary = dict(setup_s=time.perf_counter() - t0)
    print(f"vbpr setup (features + model): {summary['setup_s']!r} s")

    # the packed route: 3 steps on the card against CPU copies
    t0 = time.perf_counter()
    small = VBPR(VIS_ROUTE_N, VIS_ROUTE_N, model.F[:VIS_ROUTE_N], embed_k=EMBED_K,
                 embed_d=VIS_EMBED_D, generator=g)
    kern = PG.pack_generic_state(small, dict(small.named_parameters()),
                                 frozen=dict(small.named_buffers()))
    plain = state_on(torch, kern)
    step = PG.make_generic_packed_step(small, TRAIN_LR, TRAIN_REG, fused_frozen=True,
                                       lazy_catchup=True)
    losses, slack = [], {}
    for s in range(VIS_ROUTE_STEPS):
        batch = tuple(torch.randint(0, VIS_ROUTE_N, (TRAIN_B,), device=dev, generator=g,
                                    dtype=torch.int32) for _ in range(3))
        # each dense gradient entry sums 2B rows' terms w_i F_ij (Bp) and
        # w_i F_ij Tu_id (E), |w_i| <= 1 (a sigmoid)
        f_sum = small.F[torch.cat(batch[1:]).long()].sum(0)
        tu = kern.user_pmv[batch[0].long(), EMBED_K:EMBED_K + VIS_EMBED_D].abs().amax(0)
        dense_sum_slack(slack, {"Bp": f_sum[:, None], "E": f_sum[:, None] * tu[None, :]},
                        2 * TRAIN_B)
        kern, lk = step(kern, (None, batch, None))
        plain, lp = step(plain, (None, tuple(x.cpu() for x in batch), None))
        lk, lp = float(lk), float(lp)
        if not (np.isfinite(lk) and abs(lk - lp) <= 1e-5 * abs(lp)):
            fail(f"vbpr packed route step {s}: loss {lk!r} (kernels) vs {lp!r} (plain)")
        losses.append((lk, lp))
    err, beyond = packed_route_check(torch, PG, "vbpr packed route", kern, plain,
                                     small.packed_spec(), "float32", VIS_ROUTE_STEPS, TRAIN_LR,
                                     fused=True, dense_slack=slack)
    summary["route"] = dict(max_abs_err=err, beyond=beyond, s=time.perf_counter() - t0,
                            item_width=kern.item_pmv.shape[1])
    print(f"vbpr packed route: {VIS_ROUTE_STEPS} steps at batch {TRAIN_B}, item rows "
          f"{kern.item_pmv.shape[1]} wide, card vs CPU copies, losses {losses}; "
          f"max_abs_err={err!r}, {beyond} values drift apart; frozen, tau, pads and "
          f"untouched rows bit-equal ok; {summary['route']['s']!r} s")
    del small, kern, plain, step
    torch.cuda.empty_cache()

    # main path 1: one packed epoch, frozen columns fused
    cfg = TrainConfig(batch_size=TRAIN_B, lr=TRAIN_LR, reg=TRAIN_REG, train_path="packed")
    trainer = Trainer(model, data, cfg)
    tabs = (trainer._train_pairs, trainer._padded_pos, trainer._pos_counts)
    state, frozen = trainer.init_state()
    epoch_fn = PG.make_generic_packed_epoch_fn(
        model, TRAIN_LR, TRAIN_REG, I, VIS_STEPS, TRAIN_B, with_replacement=cfg.sampling_scheme,
        fused_frozen=cfg.fused_frozen, moment_dtype=cfg.moment_dtype,
        lazy_catchup=cfg.lazy_catchup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    G.gather_rows.launches = S.scatter_rows_set.launches = 0
    S.scatter_rows_set.routes.clear()
    G.gather_rows.routes.clear()  # VBPR packed path starts here
    t0 = time.perf_counter()
    inner, loss = epoch_fn(state.inner, frozen, 101, *tabs)
    loss = float(loss)
    dt = time.perf_counter() - t0
    launches = {"gather_rows": G.gather_rows.launches,
                "scatter_rows_set": S.scatter_rows_set.launches}  # ... and ends here
    gather_routes = dict(G.gather_rows.routes)
    # the user rows on a lanes route, the fused item rows on a bulk route
    scatter = scatter_routes(S, "vbpr packed epoch", launches["scatter_rows_set"], VIS_STEPS,
                             (inner.user_pmv, inner.item_pmv))
    peak = torch.cuda.max_memory_allocated() - start
    want = {"gather_rows": 4 * VIS_STEPS, "scatter_rows_set": 2 * VIS_STEPS}
    if launches != want or not np.isfinite(loss) or int(inner.step) != VIS_STEPS:
        fail(f"vbpr packed epoch: launches {launches} (expected {want}), loss {loss!r}, "
             f"step {int(inner.step)}")
    # two item-row gathers a step (the forward's and the deduped rows'), each
    # on a bulk route; the user rows on a lanes route
    bulk = sum(v for k, v in gather_routes.items() if k.startswith("bulk"))
    if bulk != 2 * VIS_STEPS or sum(gather_routes.values()) != 4 * VIS_STEPS:
        fail(f"vbpr packed epoch: K4 routes {gather_routes}, expected {2 * VIS_STEPS} "
             f"item gathers on a bulk route")
    summary["packed"] = dict(steps=VIS_STEPS, s=dt, triples_per_s=VIS_STEPS * TRAIN_B / dt,
                             ms_per_step=1e3 * dt / VIS_STEPS, peak_gib=peak / 2**30,
                             item_width=inner.item_pmv.shape[1], mean_loss=loss / VIS_STEPS,
                             gather_routes=gather_routes, scatter_routes=scatter)
    print(f"vbpr packed main path: {summary['packed']}, launches {launches}")
    state = state.with_inner(inner)
    summary["packed"]["profile"] = step_profile(
        torch, "vbpr packed", lambda tr: trainer.run_steps(state, frozen, tr, step_key=105),
        sample_triplets(106, *tabs, I, PACKED_PROFILE_STEPS, TRAIN_B), PACKED_PROFILE_STEPS)
    del state, inner, trainer, epoch_fn
    torch.cuda.empty_cache()

    # 50 generic Trainer steps (autograd, dense TF-parity Adam)
    trainer = Trainer(model, data, TrainConfig(batch_size=TRAIN_B, lr=TRAIN_LR, reg=TRAIN_REG))
    state, frozen = trainer.init_state()
    triples = sample_triplets(102, *tabs, I, VIS_GENERIC_STEPS, TRAIN_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, loss = trainer.run_steps(state, frozen, triples, step_key=103)
    loss = float(loss)
    dt = time.perf_counter() - t0
    if not np.isfinite(loss) or int(state.step) != VIS_GENERIC_STEPS:
        fail(f"vbpr generic steps: loss {loss!r}, step {int(state.step)}")
    summary["generic"] = dict(steps=VIS_GENERIC_STEPS, s=dt,
                              triples_per_s=VIS_GENERIC_STEPS * TRAIN_B / dt,
                              ms_per_step=1e3 * dt / VIS_GENERIC_STEPS,
                              peak_gib=(torch.cuda.max_memory_allocated() - start) / 2**30,
                              mean_loss=loss / VIS_GENERIC_STEPS)
    print(f"vbpr generic Trainer: {summary['generic']}")
    del state, trainer, triples
    torch.cuda.empty_cache()

    # the fast VBPR epoch (sparse row Adam, dense E and Bp; no custom kernel)
    fast = FT.init_fast_state({k: v.detach().clone() for k, v in model.named_parameters()})
    epoch = FT.make_fast_vbpr_epoch_fn(model, TRAIN_LR, TRAIN_REG, I, VIS_STEPS, TRAIN_B)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fast, loss = epoch(fast, model.F, 104, *tabs)
    loss = float(loss)
    dt = time.perf_counter() - t0
    if not np.isfinite(loss) or int(fast.step) != VIS_STEPS:
        fail(f"vbpr fast epoch: loss {loss!r}, step {int(fast.step)}")
    summary["fast"] = dict(steps=VIS_STEPS, s=dt, triples_per_s=VIS_STEPS * TRAIN_B / dt,
                           ms_per_step=1e3 * dt / VIS_STEPS, mean_loss=loss / VIS_STEPS)
    print(f"vbpr fast epoch: {summary['fast']}")
    del fast, epoch
    torch.cuda.empty_cache()

    # main path 2: serving the trained model at D=148
    t0 = time.perf_counter()
    padded, hist_counts = data.padded_pos, data.pos_counts
    srv = RecServer(model, data, k=K_TOP, seg=SEG, oversample=OVERSAMPLE,
                    item_block=ITEM_BLOCK, history=(padded, hist_counts))
    srv.refresh()
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    rng = np.random.default_rng(23)
    batches = {B: rng.choice(U, B, replace=False) for B in BUCKETS}
    serving, served, serve_launches, serve_routes = serve_buckets(
        np, segmax, srv, batches, SERVE_REPS, f"vbpr serving D={VIS_D}", K3_SERVE_ROUTES)
    print(f"vbpr serving: {serve_launches} K3 launches by kernel {serve_routes}")
    want_ids, want_vals = oracle_topk(torch, model, batches[64], padded, hist_counts, K_TOP)
    check_served(np, f"vbpr serve check B=64 bf16 kernel D={VIS_D}", *served[64], want_ids,
                 want_vals)
    summary["serve"] = dict(refresh_s=refresh_s, buckets=serving)
    print(f"vbpr serving at D={VIS_D}: refresh {refresh_s!r} s, {serving}")
    del srv
    torch.cuda.empty_cache()

    # main path 3: evaluation at D=148, weights on the 1/64 grid (E and Bp
    # narrower: every score and partial sum stays exact in f32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = 0.05 if name in ("E", "Bp") else 0.25
            p.copy_(q64(torch.randn(p.shape, device=dev, generator=g) * scale))
    ev = FactoredEvaluator(model, data, k=EVAL_K, user_block=EVAL_BLOCK, counts_impl="kernel")
    split_s = {}
    inner_split = ev._eval_split

    def timed(split, *a):  # per-split wall time, ended by reading the mean
        t1 = time.perf_counter()
        out = inner_split(split, *a)
        float(out.hr)
        split_s[split] = time.perf_counter() - t1
        return out

    ev._eval_split = timed
    torch.cuda.synchronize()
    counts.counts_kernel.launches = 0  # VBPR evaluation path starts here
    t0 = time.perf_counter()
    metrics = ev.evaluate(None, None)
    total_s = time.perf_counter() - t0
    eval_launches = counts.counts_kernel.launches  # ... and ends here
    if eval_launches != 2 * -(-U // EVAL_BLOCK):
        fail(f"vbpr evaluate launched K2 {eval_launches} times, expected "
             f"{2 * -(-U // EVAL_BLOCK)}")
    vals = np.array(list(metrics.values()))
    if not (np.isfinite(vals).all() and (vals >= 0).all() and (vals <= 1).all()):
        fail(f"vbpr eval metrics not finite in [0, 1]: {metrics}")
    evb = FactoredEvaluator(model, data, k=EVAL_K, user_block=EVAL_BLOCK,
                            counts_impl="bucketed")
    uf, iv, ib = ev._factors(None)
    # the checked blocks' K2 calls, after the timed run, add their rechecked
    # pairs into n_re
    from fashionvisualexpl_tpu_torch.eval import factored

    engine, n_re = factored.streaming_counts_kernel, torch.zeros(1, dtype=torch.int64,
                                                                 device=dev)
    factored.streaming_counts_kernel = lambda *a, **k: engine(*a, _rechecked=n_re, **k)
    try:
        for split in ("val", "test"):
            for blk in range(EVAL_CHECK_BLOCKS):
                ids = torch.arange(blk * EVAL_BLOCK, (blk + 1) * EVAL_BLOCK, device=dev)
                mk = ev._eval_block(split, uf[ids], iv, ib, ids)
                mb = evb._eval_block(split, uf[ids], iv, ib, ids)
                if not all(torch.equal(a, b) for a, b in zip(mk, mb)):
                    fail(f"vbpr eval {split} block {blk}: kernel and bucketed metrics "
                         f"differ")
    finally:
        factored.streaming_counts_kernel = engine
    rechecked = int(n_re)
    if rechecked == 0:
        fail("vbpr eval's checked blocks rechecked no pair on quantized data (ties)")
    summary["eval"] = dict(metrics=metrics, evaluate_s=total_s, rechecked=rechecked,
                           per_split={k: dict(ms=1e3 * v, scores_per_s=U * I / v)
                                      for k, v in split_s.items()})
    print(f"vbpr evaluation at D={VIS_D}: {eval_launches} K2 launches, evaluate {total_s!r} s, "
          f"per split {summary['eval']['per_split']}; the first {EVAL_CHECK_BLOCKS} "
          f"blocks of each split equal through the bucketed engine, {rechecked} pairs "
          f"rechecked in them; metrics "
          f"{metrics}")
    summary["peak_gib"] = (torch.cuda.max_memory_allocated() - start) / 2**30
    summary["s"] = time.perf_counter() - phase_t0
    print(f"vbpr phase: {summary['s']!r} s")
    del ev, evb, model, uf, iv, ib, tabs
    torch.cuda.empty_cache()
    return dict(launches, segmax_scores=serve_launches, segmax_routes=serve_routes,
                counts=eval_launches), summary


def write_visual_features(np, d: Path):
    """VBPR's and GradFashion's inputs in the reference's layout under data
    directory ``d``: 4096-wide vgg19 fc2 CNN and edge features, 8x8x8 color
    histograms (non-negative, as the extractors write them), and the
    review table ``all_final.tsv`` over the first VIS_CLI_REVIEWS
    training items of each user."""
    from fashionvisualexpl_tpu_torch.core.config import Paths

    rng = np.random.default_rng(17)
    paths = Paths(root=str(d.parent))
    for path, arr in (
        (paths.cnn_features(d.name, "vgg19", "fc2"),
         np.abs(rng.standard_normal((CLI_I, VIS_DIM_F), np.float32))),
        (paths.edge_features(d.name, "vgg19", "fc2"),
         np.abs(rng.standard_normal((CLI_I, VIS_DIM_F), np.float32))),
        (paths.hist_color_features(d.name),
         rng.integers(0, 100, (CLI_I, VIS_DIM_C)).astype(np.int32)),
    ):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, arr)
    rows = [line.split("\t")[:2] for line in
            (d / "trainingset.tsv").read_text().split("\n") if line]
    with open(d / "all_final.tsv", "w") as f:
        f.write("USER_ID\tITEM_ID\tREVIEW\n")
        for n, (u, i) in enumerate(rows):
            if n % (CLI_PER_USER - 2) < VIS_CLI_REVIEWS:
                f.write(f"{u}\t{i}\treview {n} of user {u}\n")


def check_cli_run(np, label, results, rdir, n_users, launches, rows, must_launch,
                  served=True):
    """One ``train_rec`` (+ ``serve_rec`` when ``served``) run of the CLI
    phases: K4 and K5 launched ``rows`` = (K4, K5) times, each kernel of
    ``must_launch`` at least once; the epoch-2 and best recs dumps
    ``n_users`` x CLI_K rows, serve_rec's CLI_SERVE_USERS x CLI_K; metrics
    finite in [0, 1] for epochs 1 and 2.  Returns epoch 2's metrics."""
    import glob
    import pickle

    if (launches["gather_rows"], launches["scatter_rows_set"]) != rows \
            or not all(launches[k] for k in must_launch):
        fail(f"{label}: launched {launches}; expected {', '.join(must_launch)} and "
             f"{rows[0]} K4, {rows[1]} K5")
    for pattern in ("recs-2-*.tsv", "best-recs-*.tsv"):
        (path,) = glob.glob(str(rdir / pattern))
        n_rows = len(read_tsv(np, path, 3))
        if n_rows != n_users * CLI_K:
            fail(f"{label} {pattern}: {n_rows} rows, expected {n_users * CLI_K}")
    if served and len(read_tsv(np, results / "served.tsv", 3)) != CLI_SERVE_USERS * CLI_K:
        fail(f"{label}: serve_rec wrote a wrong number of rows")
    (pkl,) = glob.glob(str(rdir / "results-metrics-*.pkl"))
    with open(pkl, "rb") as f:
        per_epoch = pickle.load(f)
    vals = np.array([v for m in per_epoch.values() for v in m.values()])
    if sorted(per_epoch) != [1, 2] or not (
            np.isfinite(vals).all() and (vals >= 0).all() and (vals <= 1).all()):
        fail(f"{label}: metrics not finite in [0, 1] for epochs 1, 2: {per_epoch}")
    return per_epoch[2]


def visual_cli_phase(torch, np, counts, segmax, G, S):
    """``train_rec --rec vbpr`` (generic, then ``--train_path packed`` with
    fused frozen columns) and ``--rec grad_fashion`` (both grads dumps),
    ``serve_rec`` for both, and ``get_explanations`` on the best grads
    dump, in process, on the CLI dataset with 4096-wide features."""
    import glob
    import shutil

    from fashionvisualexpl_tpu_torch.cli.get_explanations import main as explain
    from fashionvisualexpl_tpu_torch.cli.serve_rec import serve
    from fashionvisualexpl_tpu_torch.cli.train_rec import train
    from fashionvisualexpl_tpu_torch.explain.grads import read_tsv as read_table

    phase_t0 = t0 = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    write_reference_dataset(np, CLI_DIR / "cli")
    write_visual_features(np, CLI_DIR / "cli")
    summary = dict(write_s=time.perf_counter() - t0)
    users = ",".join(str(u * (CLI_U // CLI_SERVE_USERS)) for u in range(CLI_SERVE_USERS))
    steps = 2 * (CLI_U * (CLI_PER_USER - 2) // VIS_CLI_B)
    n_pos = CLI_U * CLI_PER_USER
    all_launches = {}

    def run(label, rec, extra):
        results = CLI_DIR / label
        common = ["--rec", rec, "--dataset", "cli", "--data_root", str(CLI_DIR),
                  "--results_root", str(results), "--embed_k", str(EMBED_K),
                  "--embed_d", str(VIS_EMBED_D), "--top_k", str(CLI_K)]
        counts.counts_kernel.launches = segmax.segmax_scores.launches = 0
        segmax.segmax_scores.routes.clear()
        G.gather_rows.launches = S.scatter_rows_set.launches = 0
        S.scatter_rows_set.routes.clear()
        G.gather_rows.routes.clear()  # this run starts here
        t1 = time.perf_counter()
        train(common + ["--streaming_eval", "--epochs", "2", "--batch_size", str(VIS_CLI_B),
                        *extra])
        train_s = time.perf_counter() - t1
        (ckpt,) = glob.glob(str(results / "rec_model_weights" / "cli" / rec / "ckpt-*"))
        t1 = time.perf_counter()
        serve(common + [*extra, "--ckpt", ckpt, "--users", users, "--output",
                        str(results / "served.tsv")])
        serve_s = time.perf_counter() - t1
        launches = {"gather_rows": G.gather_rows.launches,
                    "scatter_rows_set": S.scatter_rows_set.launches,
                    "counts": counts.counts_kernel.launches,
                    "segmax_scores": segmax.segmax_scores.launches,
                    "segmax_routes": dict(segmax.segmax_scores.routes),
                    "gather_routes": dict(G.gather_rows.routes),
                    "scatter_routes": dict(S.scatter_rows_set.routes)}  # ... and ends here
        scatter_routes(S, label, launches["scatter_rows_set"])
        if "segmax_mma_kernel" in launches["segmax_routes"]:
            fail(f"{label}: K3 at D={VIS_D} took segmax_mma_kernel: {launches['segmax_routes']}")
        rdir = results / "rec_results" / "cli" / rec
        metrics = check_cli_run(np, label, results, rdir, CLI_U, launches,
                                (4 * steps, 2 * steps) if "packed" in extra else (0, 0),
                                ("counts", "segmax_scores"))
        all_launches[label] = launches
        summary[label] = dict(train_s=train_s, serve_s=serve_s, metrics=metrics)
        print(f"{label}: train_rec {train_s!r} s, serve_rec {serve_s!r} s; launches "
              f"{launches}; metrics epoch 2 {metrics}")
        return rdir

    run("vbpr", "vbpr", ())
    run("vbpr-packed", "vbpr", ("--train_path", "packed"))
    rdir = run("grad_fashion", "grad_fashion",
               ("--embed_color", str(VIS_EMBED_FAMILY), "--embed_edges", str(VIS_EMBED_FAMILY)))
    for pattern in ("grads-2-*.tsv", "best-grads-*.tsv"):
        (best,) = glob.glob(str(rdir / pattern))  # the last one: the best params'
        rows = read_tsv(np, best, 4)  # user, item, color, edges
        users = len(np.unique(rows[:, 0]))
        if len(rows) != n_pos or not np.isfinite(rows[:, 2:]).all() or users != CLI_U:
            fail(f"grad_fashion {pattern}: {len(rows)} rows over {users} users, expected "
                 f"{n_pos} rows of two finite attributions over {CLI_U} users")
    t0 = time.perf_counter()
    explain(["--dataset", "cli", "--rec", "grad_fashion", "--file", os.path.basename(best),
             "--top_n", str(VIS_TOP_N), "--data_root", str(CLI_DIR),
             "--results_root", str(CLI_DIR / "grad_fashion")])
    for name in ("color_reviews.tsv", "edges_reviews.tsv"):
        table = read_table(str(rdir / name))
        if list(table) != ["USER_ID", "ITEM_ID", "COLOR", "EDGES", "REVIEW", "DIFF"] \
                or len(table["DIFF"]) != VIS_TOP_N or not np.isfinite(table["DIFF"]).all():
            fail(f"get_explanations {name}: columns {list(table)}, {len(table['DIFF'])} rows")
    diffs = [read_table(str(rdir / n))["DIFF"]
             for n in ("color_reviews.tsv", "edges_reviews.tsv")]
    if not (np.all(np.diff(diffs[0]) <= 0) and np.all(np.diff(diffs[1]) >= 0)
            and diffs[0][-1] >= diffs[1][-1]):
        fail("get_explanations: the tables are not ranked by DIFF")
    summary["explain_s"] = time.perf_counter() - t0
    summary["s"] = time.perf_counter() - phase_t0
    print(f"visual cli: grads dumps {n_pos} rows of two finite attributions each, "
          f"get_explanations {summary['explain_s']!r} s; phase {summary['s']!r} s")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    return all_launches, summary


def acf_model(torch, ACF, n_users, n_items, fspat, items, cnt, device, seed):
    """ACF at the reference's widths over ``fspat`` and the padded
    positives, random weights from ``seed`` (its own generator's draws)."""
    return ACF(n_users, n_items, fspat, padded_positives=items, positive_counts=cnt,
               embed_k=EMBED_K, layers_component=(64, 1), layers_item=(64, 1), device=device,
               generator=torch.Generator(device=device).manual_seed(seed))


def acf_route_phase(torch, np, PG, ACF, fspat):
    """ACF's packed step on the card against the same step on the CPU on a
    4096 x 4096 catalog (the first rows of the full Fspat; counts 0-20,
    user 0 with no positive): fp32 / bf16 / fp8 moments, the maps fused
    into the item rows or read by id, catch-up on, 3 steps at batch 256;
    then 3 generic Trainer steps likewise.  Each step starts both routes
    from the CPU route's state: the extra rows' Gi take gradients only
    through the item attention, some near Adam's eps, and the attention's
    dense gradients sum B x P (x S) terms that nearly cancel in places;
    there a normalised Adam step follows the gradient's last bits (such
    params may drift, ``at_floor``), and after a step taken apart the next
    steps' gradients would part by more than rounding.  The fused
    Fspat columns, tau and untouched rows bit-equal between routes, the
    maps bit-equal to Fspat, the last step's extra rows stamped."""
    from fashionvisualexpl_tpu_torch.core.config import TrainConfig
    from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
    from fashionvisualexpl_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    N, B, n = ACF_ROUTE_N, ACF_ROUTE_B, ACF_ROUTE_STEPS
    pairs, items, _ = make_scaled_arrays(N, N, ACF_P, seed=1)
    cnt = np.random.default_rng(26).integers(0, ACF_P + 1, N).astype(np.int32)
    cnt[0] = 0
    models = [acf_model(torch, ACF, N, N, f, items, cnt, d, 27)
              for f, d in ((fspat[:N], ACF_DEV), (fspat[:N].cpu(), "cpu"))]
    if models[0].Fspat.data_ptr() != fspat.data_ptr():
        fail("ACF copied the card's spatial maps")
    with torch.no_grad():
        for a, b in zip(models[0].parameters(), models[1].parameters()):
            b.copy_(a.cpu())
    frozen = [dict(m.named_buffers()) for m in models]
    spec = models[0].packed_spec()
    maps = fspat[:N].reshape(N, -1).view(torch.int32)
    g = torch.Generator(device=ACF_DEV).manual_seed(28)
    out = {}
    for md in ("float32", "bfloat16", "float8"):
        for fused in (True, False):
            label = f"acf packed route {md} {'fused' if fused else 'by id'}"
            t1 = time.perf_counter()
            plain = state_on(torch, PG.pack_generic_state(
                models[0], dict(models[0].named_parameters()),
                frozen=frozen[0] if fused else None, moment_dtype=md))
            steps = [PG.make_generic_packed_step(m, TRAIN_LR, TRAIN_REG, fused_frozen=fused,
                                                 moment_dtype=md, lazy_catchup=True)
                     for m in models]
            losses, err, beyond = [], 0.0, 0
            for s in range(n):
                kern = state_on(torch, plain, ACF_DEV)  # the CPU route's state
                batch = tuple(torch.randint(0, N, (B,), device=ACF_DEV, generator=g,
                                            dtype=torch.int32) for _ in range(3))
                batch[0][0] = 0  # the user with no positive
                kern, lk = steps[0](kern, (frozen[0], batch, None))
                plain, lp = steps[1](plain, (frozen[1], tuple(x.cpu() for x in batch), None))
                lk, lp = float(lk), float(lp)
                if not (np.isfinite(lk) and abs(lk - lp) <= 1e-5 * abs(lp)):
                    fail(f"{label} step {s}: loss {lk!r} (kernels) vs {lp!r} (plain)")
                losses.append((lk, lp))
                e, nb = packed_route_check(torch, PG, f"{label} step {s}", kern, plain, spec,
                                           md, s + 1, TRAIN_LR, fused=fused, at_floor=True)
                err, beyond = max(err, e), beyond + nb
            F0 = 2 * EMBED_K + PG._mom_width(md, 2 * EMBED_K)
            tau = kern.item_pmv[:, F0 + (ACF_S * ACF_C if fused else 0)]
            xids = models[0].packed_extra_item_ids(frozen[0], tuple(x.long() for x in batch))
            if not bool((tau[xids.long()] == n).all()):
                fail(f"{label}: the last step's extra rows were not stamped with its step")
            if fused and not torch.equal(kern.item_pmv[:, F0:F0 + ACF_S * ACF_C].view(
                    torch.int32), maps):
                fail(f"{label}: the fused Fspat columns left the maps' bits")
            out[label] = dict(max_abs_err=err, beyond=beyond, losses=losses,
                              item_width=kern.item_pmv.shape[1], s=time.perf_counter() - t1)
            print(f"{label}: {n} steps at batch {B}, item rows {kern.item_pmv.shape[1]} wide, "
                  f"each from the CPU route's state, card vs CPU: losses {losses}; "
                  f"max_abs_err={err!r}, {beyond} values a code or drift apart; Fspat, tau, "
                  f"pads and untouched rows bit-equal, the extra rows stamped ok")
            del kern, plain
    # 3 generic Trainer steps, each from the CPU route's state
    data = types.SimpleNamespace(num_items=N, num_train=len(pairs), train_pairs=pairs,
                                 padded_pos=items, pos_counts=cnt,
                                 steps_per_epoch=lambda b: len(pairs) // b)
    trainers = [Trainer(m, data, TrainConfig(batch_size=B, lr=TRAIN_LR, reg=TRAIN_REG))
                for m in models]
    plain = trainers[1].init_state()[0]
    triples = sample_triplets(29, *(trainers[0]._train_pairs, trainers[0]._padded_pos,
                                    trainers[0]._pos_counts), N, n, B, device=ACF_DEV)
    losses, err, exempt = [], 0.0, 0
    for s in range(n):
        kern = state_on(torch, plain, ACF_DEV, models[0])
        kern, lk = trainers[0].run_steps(kern, frozen[0], tuple(t[s:s + 1] for t in triples),
                                         step_key=30 + s)
        plain, lp = trainers[1].run_steps(plain, frozen[1],
                                          tuple(t[s:s + 1].cpu() for t in triples),
                                          step_key=30 + s)
        lk, lp = float(lk), float(lp)
        if not abs(lk - lp) <= 1e-5 * abs(lp):
            fail(f"acf generic route step {s}: loss {lk!r} (card) vs {lp!r} (CPU)")
        losses.append((lk, lp))
        e, x = route_check(torch, f"acf generic route step {s}", kern,
                           state_on(torch, plain, ACF_DEV), s + 1, 2 * TRAIN_LR)
        err, exempt = max(err, e), exempt + x
    out["generic"] = dict(losses=losses, max_abs_err=err, exempt=exempt)
    out["s"] = time.perf_counter() - t0
    print(f"acf generic route: {n} Trainer steps at batch {B}, each from the CPU route's "
          f"state, card vs CPU: losses {losses}; max_abs_err={err!r}, {exempt} params "
          f"exempt (tiny sqrt(v_hat)); route checks {out['s']!r} s")
    del models, trainers, kern, plain
    torch.cuda.empty_cache()
    return out


def acf_full_phase(torch, np, G, S, ACF, fspat, data, items, cnt, start):
    """The chunked profile against the one-shot one; the packed epoch
    (unfused, batch 8192) through K4 and K5 with a profile, 20 fused steps
    at batch 2048 with a profile, and 20 generic Trainer steps, each with
    its peak memory above ``start`` (the ACF phase's, Fspat not yet made)."""
    from fashionvisualexpl_tpu_torch.core.config import TrainConfig
    from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
    from fashionvisualexpl_tpu_torch.models.base import param_group
    from fashionvisualexpl_tpu_torch.train.trainer import Trainer

    model = acf_model(torch, ACF, ACF_U, ACF_I, fspat, items, cnt, ACF_DEV, 31)
    out = {}

    # the chunked profile (exact_eval's) against the one-shot profile, with
    # a user of no positive and users whose last window has no valid slot
    with torch.no_grad():
        users = torch.arange(ACF_CHUNK_USERS, device=ACF_DEV)
        pos, c = model.pos_eval[users], model.cnt_eval[users].clone()
        c[:4] = torch.tensor([0, 5, 8, 17], dtype=c.dtype)
        p = dict(model.named_parameters())
        model.pos_chunk = ACF_CHUNK
        chunked = model._attentive_profile_chunked(p, p["Gu"][users], pos, c)
        pl = pos.long()
        oneshot = model._attentive_profile(param_group(p, "comp"), param_group(p, "item"),
                                           p["Gu"][users], model.Fspat[pl], p["Gi"][pl],
                                           p["Pi"][pl], c)
        err = worst(torch, "acf chunked profile", chunked, oneshot, ACF_CHUNK_TOL,
                    ACF_CHUNK_TOL)
        if not torch.equal(chunked[0], p["Gu"][0]):
            fail("acf chunked profile: the user with no positive left its embedding")
    out["chunked"] = dict(users=ACF_CHUNK_USERS, pos_chunk=ACF_CHUNK, max_abs_err=err)
    print(f"acf chunked profile (pos_chunk {ACF_CHUNK}, P={ACF_P}) over {ACF_CHUNK_USERS} "
          f"users against the one-shot profile: max_abs_err={err!r} (rtol = atol = "
          f"{ACF_CHUNK_TOL})")
    del chunked, oneshot, pos, pl

    def packed_run(label, batch, steps, fused, key):
        cfg = TrainConfig(batch_size=batch, lr=TRAIN_LR, reg=TRAIN_REG, train_path="packed",
                          fused_frozen=fused)
        trainer = Trainer(model, data, cfg)
        tabs = (trainer._train_pairs, trainer._padded_pos, trainer._pos_counts)
        state, frozen = trainer.init_state()
        width = state.inner.item_pmv.shape[1]
        triples = sample_triplets(key, *tabs, ACF_I, steps + 1, batch, device=ACF_DEV)
        # one step first (allocations, library handles), untimed
        state, _ = trainer.run_steps(state, frozen, tuple(t[:1] for t in triples),
                                     step_key=key + 1)
        triples = tuple(t[1:] for t in triples)
        torch.cuda.synchronize()
        G.gather_rows.launches = S.scatter_rows_set.launches = 0
        S.scatter_rows_set.routes.clear()
        G.gather_rows.routes.clear()  # this run's main path starts here
        t0 = time.perf_counter()
        state, loss = trainer.run_steps(state, frozen, triples, step_key=key + 2)
        loss = float(loss)
        dt = time.perf_counter() - t0
        launches = {"gather_rows": G.gather_rows.launches,
                    "scatter_rows_set": S.scatter_rows_set.launches}  # ... and ends here
        routes = dict(G.gather_rows.routes)
        # the user rows (385 floats) and the item rows (769 or 25,857
        # floats), once a step each, all on bulk_lanes
        scatter = scatter_routes(S, label, launches["scatter_rows_set"], steps,
                                 (state.inner.user_pmv, state.inner.item_pmv))
        peak = torch.cuda.max_memory_allocated() - start
        want = {"gather_rows": 5 * steps, "scatter_rows_set": 2 * steps}
        # the user rows (385 floats: lanes4) twice a step, the item rows (the
        # forward's, the extra ones, the deduped ones; 769 or 25,857 floats:
        # bulk_lanes) three times, each on the route its plan names
        want_routes = {}
        for table, k in ((state.inner.user_pmv, 2), (state.inner.item_pmv, 3)):
            r = G.gather_plan(table.shape[1], table.data_ptr(), 0).route
            want_routes[r] = want_routes.get(r, 0) + k * steps
        if launches != want or routes != want_routes \
                or not np.isfinite(loss) or int(state.step) != steps + 1:
            fail(f"{label}: launches {launches} (expected {want}), K4 routes {routes} "
                 f"(expected {want_routes}), loss {loss!r}, step {int(state.step)}")
        row = dict(steps=steps, batch=batch, s=dt, ms_per_step=1e3 * dt / steps,
                   triples_per_s=steps * batch / dt, peak_gib=peak / 2**30,
                   item_width=width, mean_loss=loss / steps, launches=launches,
                   gather_routes=routes, scatter_routes=scatter)
        print(f"{label}: {row}")
        row["profile"] = step_profile(
            torch, label, lambda tr: trainer.run_steps(state, frozen, tr, step_key=key + 3),
            sample_triplets(key + 4, *tabs, ACF_I, ACF_PROFILE_STEPS, batch, device=ACF_DEV),
            ACF_PROFILE_STEPS)
        return row, tabs

    torch.cuda.reset_peak_memory_stats()
    out["packed"], tabs = packed_run("acf packed", ACF_B, ACF_STEPS, False, 120)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["fused"], _ = packed_run("acf packed fused", ACF_FUSED_B, ACF_FUSED_STEPS, True, 130)
    torch.cuda.empty_cache()

    # 20 generic Trainer steps (autograd, dense TF-parity Adam)
    trainer = Trainer(model, data, TrainConfig(batch_size=ACF_B, lr=TRAIN_LR, reg=TRAIN_REG))
    state, frozen = trainer.init_state()
    triples = sample_triplets(140, *tabs, ACF_I, ACF_GENERIC_STEPS, ACF_B, device=ACF_DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, loss = trainer.run_steps(state, frozen, triples, step_key=141)
    loss = float(loss)
    dt = time.perf_counter() - t0
    if not np.isfinite(loss) or int(state.step) != ACF_GENERIC_STEPS:
        fail(f"acf generic steps: loss {loss!r}, step {int(state.step)}")
    out["generic"] = dict(steps=ACF_GENERIC_STEPS, s=dt,
                          ms_per_step=1e3 * dt / ACF_GENERIC_STEPS,
                          triples_per_s=ACF_GENERIC_STEPS * ACF_B / dt,
                          peak_gib=(torch.cuda.max_memory_allocated() - start) / 2**30,
                          mean_loss=loss / ACF_GENERIC_STEPS)
    print(f"acf generic Trainer: {out['generic']}")
    del trainer, state, triples, tabs
    torch.cuda.empty_cache()
    return model, out


def acf_eval_serve_phase(torch, np, counts, segmax, model, items, cnt):
    """The trained model's profiles over 1M users (``precompute_eval``), one
    split of ``FactoredEvaluator`` through K2 at D=128, then ``RecServer``
    through K3 at the serving buckets, 64 users against a full-catalog fp32
    oracle."""
    from fashionvisualexpl_tpu_torch.eval.evaluator import concat_metrics, split_record
    from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator
    from fashionvisualexpl_tpu_torch.ops.metrics import mean_metrics
    from fashionvisualexpl_tpu_torch.serve import RecServer

    out = {}
    t0 = time.perf_counter()
    # the evaluation split: the train positives, one test item per user
    # outside them (their sorted spread leaves every gap wider than 1)
    data = types.SimpleNamespace(num_users=ACF_U, num_items=ACF_I,
                                 training_list=items.tolist(),
                                 test_list=(items[:, :1] + 1).tolist(), validation_list=[],
                                 has_validation=False)
    ev = FactoredEvaluator(model, data, k=EVAL_K, user_block=EVAL_BLOCK, counts_impl="kernel")
    evb = FactoredEvaluator(model, data, k=EVAL_K, user_block=EVAL_BLOCK,
                            counts_impl="bucketed")
    out["setup_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uf, iv, ib = ev._factors(None)  # precompute_eval: the profiles of every user
    torch.cuda.synchronize()
    out["precompute_eval_s"] = time.perf_counter() - t0
    counts.counts_kernel.launches = 0  # ACF's evaluation path starts here
    t0 = time.perf_counter()
    metrics = {k: v for k, v in split_record(ev._eval_split("test", uf, iv, ib), None).items()
               if k.endswith("_t")}
    out["split_s"] = time.perf_counter() - t0
    launches = counts.counts_kernel.launches  # ... and ends here
    want = -(-ACF_U // EVAL_BLOCK)
    vals = np.array(list(metrics.values()))
    if launches != want or not (np.isfinite(vals).all() and (vals >= 0).all()
                                and (vals <= 1).all()):
        fail(f"acf evaluation: {launches} K2 launches (expected {want}), metrics {metrics}")
    # the first user blocks again through the bucketed engine: Gaussian
    # scores, so counts may part at f32 near-ties; the means agree
    per = []
    for e in (ev, evb):
        blocks = []
        for blk in range(EVAL_CHECK_BLOCKS):
            ids = torch.arange(blk * EVAL_BLOCK, (blk + 1) * EVAL_BLOCK, device=ACF_DEV)
            blocks.append(e._eval_block("test", uf[ids], iv, ib, ids))
        per.append(mean_metrics(concat_metrics(blocks)))
    for f in ("hr", "prec", "rec", "auc", "ndcg"):
        a, b = float(getattr(per[0], f)), float(getattr(per[1], f))
        if not abs(a - b) <= 2e-4 + 2e-3 * abs(b):
            fail(f"acf evaluation: the first blocks' mean {f} {a!r} (K2) vs {b!r} (bucketed)")
    out.update(metrics=metrics, launches=launches,
               scores_per_s=ACF_U * ACF_I / out["split_s"])
    print(f"acf evaluation at D={EMBED_K}: precompute_eval {out['precompute_eval_s']!r} s "
          f"over {ACF_U} users, the test split {out['split_s']!r} s, {launches} K2 launches, "
          f"evaluator setup {out['setup_s']!r} s; the first {EVAL_CHECK_BLOCKS} blocks' means "
          f"equal through the bucketed engine within rtol 2e-3; metrics {metrics}")
    del ev, evb, iv, ib

    # serving
    t0 = time.perf_counter()
    srv = RecServer(model, data, k=K_TOP, seg=SEG, oversample=OVERSAMPLE,
                    item_block=ITEM_BLOCK, history=(items, cnt), device=ACF_DEV)
    srv.refresh()
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    rng = np.random.default_rng(32)
    batches = {B: rng.choice(ACF_U, B, replace=False) for B in BUCKETS}
    serving, served, serve_launches, serve_routes = serve_buckets(
        np, segmax, srv, batches, SERVE_REPS, f"acf serving D={EMBED_K}", K3_SERVE_ROUTES)
    # the oracle: the 64 users' profiles computed anew (a 256-user block, the
    # shape precompute_eval computes) against every item in fp32
    with torch.no_grad():
        u64 = batches[64]
        block = np.concatenate([u64, np.setdiff1d(np.arange(256), u64)[:256 - 64]])
        prof = model.user_profile(torch.as_tensor(block, device=ACF_DEV), False)[:64]
        s = prof @ model.Gi.T
        for row, uid in enumerate(u64):
            s[row, torch.as_tensor(items[uid, :cnt[uid]], device=ACF_DEV).long()] = -np.inf
        want_vals, want_ids = torch.topk(s, K_TOP, dim=1)
    check_served(np, f"acf serve check B=64 bf16 kernel D={EMBED_K}", *served[64],
                 want_ids.cpu().numpy(), want_vals.cpu().numpy())
    out["serve"] = dict(refresh_s=refresh_s, buckets=serving, launches=serve_launches,
                        routes=serve_routes)
    print(f"acf serving: refresh {refresh_s!r} s, {serving}, K3 {serve_routes}")
    del srv, uf
    torch.cuda.empty_cache()
    return out


def write_acf_maps(np, d: Path, num_items: int):
    """Per-item 7x7x512 spatial maps ([H, W, C] float32 .npy, the
    extractor's layout) under the CLI dataset's cnn_features_split_dir."""
    sdir = d / "original" / "features" / "cnn_vgg19_fc2"
    sdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(33)
    for i in range(num_items):
        np.save(sdir / f"{i}.npy", np.round(rng.random((7, 7, ACF_C), dtype=np.float32) * 64)
                / np.float32(64))
    return sdir


def acf_cli_phase(torch, np, counts, segmax, G, S):
    """``train_rec --rec acf`` (generic, then ``--train_path packed`` with the
    maps fused) and ``serve_rec`` on a 1024 x 1024 dataset with per-item
    7x7x512 .npy maps written here: the file set, row counts and metrics."""
    import glob
    import shutil

    from fashionvisualexpl_tpu_torch.cli.serve_rec import serve
    from fashionvisualexpl_tpu_torch.cli.train_rec import train

    phase_t0 = t0 = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    N = ACF_CLI_N
    write_reference_dataset(np, CLI_DIR / "cli", N, N)
    sdir = write_acf_maps(np, CLI_DIR / "cli", N)
    out = dict(write_s=time.perf_counter() - t0)
    users = ",".join(str(u * (N // CLI_SERVE_USERS)) for u in range(CLI_SERVE_USERS))
    steps = 2 * (N * (CLI_PER_USER - 2) // ACF_CLI_B)
    launches = {}
    for label, extra in (("acf", ()), ("acf-packed", ("--train_path", "packed"))):
        results = CLI_DIR / label
        common = ["--rec", "acf", "--dataset", "cli", "--data_root", str(CLI_DIR),
                  "--results_root", str(results), "--embed_k", str(EMBED_K),
                  "--top_k", str(CLI_K), "--max_user_pos", str(ACF_P), "--device", ACF_DEV,
                  *extra]
        G.gather_rows.launches = S.scatter_rows_set.launches = 0
        S.scatter_rows_set.routes.clear()
        counts.counts_kernel.launches = segmax.segmax_scores.launches = 0  # run starts
        t1 = time.perf_counter()
        train(common + ["--streaming_eval", "--epochs", "2", "--verbose", "1",
                        "--batch_size", str(ACF_CLI_B)])
        train_s = time.perf_counter() - t1
        (ckpt,) = glob.glob(str(results / "rec_model_weights" / "cli" / "acf" / "ckpt-*"))
        t1 = time.perf_counter()
        serve(common + ["--ckpt", ckpt, "--users", users, "--output",
                        str(results / "served.tsv")])
        serve_s = time.perf_counter() - t1
        run = {"gather_rows": G.gather_rows.launches,
               "scatter_rows_set": S.scatter_rows_set.launches,
               "counts": counts.counts_kernel.launches,
               "segmax_scores": segmax.segmax_scores.launches}  # ... and ends here
        run["scatter_routes"] = scatter_routes(S, f"{label} cli", run["scatter_rows_set"])
        rdir = results / "rec_results" / "cli" / "acf"
        metrics = check_cli_run(np, f"{label} cli", results, rdir, N, run,
                                (5 * steps, 2 * steps) if extra else (0, 0),
                                ("segmax_scores",))
        files = sorted(os.path.basename(p) for p in glob.glob(str(rdir / "*")))
        kinds = sorted({f.split("-")[0] for f in files})
        if kinds != ["best", "log", "recs", "results"] or len(files) != 4:
            fail(f"{label} cli: wrote {files}")
        ckpts = sorted(os.listdir(ckpt))
        if ckpts != ["1", "2", "best-state"]:
            fail(f"{label} cli: checkpoints {ckpts}")
        launches[label] = run
        out[label] = dict(train_s=train_s, serve_s=serve_s, metrics=metrics, files=files)
        print(f"{label} cli: train_rec {train_s!r} s, serve_rec {serve_s!r} s; launches "
              f"{run}; files {files}; metrics epoch 2 {metrics}")
    out["s"] = time.perf_counter() - phase_t0
    print(f"acf cli: {N} x {N} with {N} maps of 7x7x{ACF_C} under {sdir.name} "
          f"(written in {out['write_s']!r} s); phase {out['s']!r} s")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    return launches, out


def scatter_timed(torch, S, label, table, sids64, vals, flush):
    """K5 at one shape: on the route its plan names (``scatter_plan``: a
    lanes route for rows that one trip of 8 loads a lane holds, a bulk
    route above), the written rows bit-equal to ``vals`` and 4096 other
    rows unchanged, then timed with the L2 flushed beside its plain
    version, ``Tensor.index_copy_`` and its bound."""
    R, W = table.shape
    B = sids64.shape[0]
    sids = sids64.to(torch.int32)
    keep = torch.ones(R, dtype=torch.bool, device=table.device)
    keep[sids64] = False
    others = keep.nonzero()[:4096, 0]
    before = table[others].view(torch.int32).clone()
    launched, by_route = S.scatter_rows_set.launches, dict(S.scatter_rows_set.routes)
    S.scatter_rows_set(table, sids, vals)
    torch.cuda.synchronize()
    routes = [k for k, v in S.scatter_rows_set.routes.items() if v != by_route.get(k, 0)]
    plan = S.scatter_plan(W, table.data_ptr(), vals.data_ptr())
    if S.scatter_rows_set.launches != launched + 1 or routes != [plan.route]:
        fail(f"scatter {label}: launched on {routes}, planned {plan}")
    if not torch.equal(table[sids64].view(torch.int32), vals.view(torch.int32)) \
            or not torch.equal(table[others].view(torch.int32), before):
        fail(f"scatter kernel wrote other bits than its values at {label}")
    del before
    b, by = rows_bound(B, W)
    ms, call_ms, _ = kernel_times(torch, f"scatter_rows_set {label}",
                                  lambda: S.scatter_rows_set(table, sids, vals), ROW_ITERS,
                                  flush, b)
    plain_ms, _, _ = kernel_times(torch, f"scatter_rows_set plain {label}",
                                  lambda: S.scatter_rows_set_reference(table, sids, vals),
                                  ROW_ITERS // 2, flush)
    lib_ms, _, _ = kernel_times(torch, f"scatter_rows_set library {label}",
                                lambda: table.index_copy_(0, sids64, vals), ROW_ITERS, flush)
    row = dict(route=plan.route, param=plan.param, piece_bytes=plan.piece_bytes,
               resident_blocks=S.scatter_residency(W, plan)[0], max_abs_err=0.0, ms=ms,
               call_ms=call_ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
               library_ms=lib_ms, bound_share=b / ms, beats_library=ms < lib_ms,
               shape=f"R={R} W={W} B={B} f32, cold L2",
               library="Tensor.index_copy_ (int64 ids)")
    print(f"kernel time scatter_rows_set {row['shape']} ({plan.route}, param {plan.param}, "
          f"piece {plan.piece_bytes}, {row['resident_blocks']} blocks an SM): ms={ms!r} "
          f"call_ms={call_ms!r} plain_ms={plain_ms!r} library_ms(index_copy_)={lib_ms!r} "
          f"bound_ms={b!r} ({by}, {100 * b / ms:.1f}%)")
    check_bound(f"scatter_rows_set {label}", ms, b)  # after the line, which keeps call_ms
    return row


def acf_row_phase(torch, G, S):
    """K4 and K5 at ACF's item rows over the 200k catalog (769 / 513 floats
    at 163,840 and 16,384 rows, 25,857 with the maps fused at 16,384), K4
    on the route its plan names; K5 also at the narrow widths GATHER_NARROW
    at 16,384 unique rows of 1M-row tables.  Each bit-equal, timed with the
    L2 flushed beside the library call and its bound."""
    dev = torch.device(ACF_DEV)
    g = torch.Generator(device=dev).manual_seed(34)
    t0 = time.perf_counter()
    # 256 MB: after a 64 MB fill, 16,384 rows of 513 floats (33.6 MB, the
    # same rows each call) were once read partly from the 50 MB L2, under
    # their bound
    flush = torch.empty(256 * 2**20 // 4, device=dev)
    out = {"gather_rows": {}, "scatter_rows_set": {}}
    for W in ACF_ROW_WIDTHS:
        table = torch.randn(ACF_I, W, device=dev, generator=g)
        for B in (ACF_ROW_B if W < 1024 else ACF_FUSED_ROW_B):
            ids = torch.randint(0, ACF_I, (B,), device=dev, generator=g, dtype=torch.int32)
            key = f"W={W} B={B}"
            out["gather_rows"][key] = gather_timed(
                torch, G, f"R={ACF_I} W={W} B={B}", table, ids, flush)
            del ids
            sids64 = torch.randperm(ACF_I, device=dev, generator=g)[:B]
            vals = torch.randn(B, W, device=dev, generator=g)
            out["scatter_rows_set"][key] = scatter_timed(
                torch, S, f"R={ACF_I} W={W} B={B}", table, sids64, vals, flush)
            del sids64, vals
            torch.cuda.empty_cache()
        del table
        torch.cuda.empty_cache()
    for W in GATHER_NARROW:  # K5 at the narrow widths, R=1M, B=16,384
        table = torch.randn(ROW_TABLE, W, device=dev, generator=g)
        sids64 = torch.randperm(ROW_TABLE, device=dev, generator=g)[:GATHER_B]
        vals = torch.randn(GATHER_B, W, device=dev, generator=g)
        out["scatter_rows_set"][f"W={W} B={GATHER_B}"] = scatter_timed(
            torch, S, f"R={ROW_TABLE} W={W} B={GATHER_B}", table, sids64, vals, flush)
        del table, sids64, vals
        torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    losing = {k: r["ms"] / r["library_ms"] for k, r in out["scatter_rows_set"].items()
              if r["ms"] >= r["library_ms"] or r["bound_share"] < 0.5}
    print(f"acf row timing grid: {out['s']!r} s; K5 behind index_copy_ or under half its "
          f"bound at {losing}")
    del flush
    torch.cuda.empty_cache()
    return out


def acf_phase(torch, np, counts, segmax, G, S):
    """ACF at the reference's widths (module docstring, phase 19)."""
    from fashionvisualexpl_tpu_torch.models.acf import ACF
    from fashionvisualexpl_tpu_torch.train import packed_generic as PG

    phase_t0 = time.perf_counter()
    start = phase_start(torch)
    g = torch.Generator(device=ACF_DEV).manual_seed(25)
    # non-negative maps on the 1/64 grid (post-ReLU CNN activations), made
    # on the card
    fspat = torch.rand(ACF_I, ACF_S, ACF_C, device=ACF_DEV, generator=g)
    fspat.mul_(64).round_().div_(64)
    pairs, items, cnt = make_scaled_arrays(ACF_U, ACF_I, ACF_P, seed=0)
    data = types.SimpleNamespace(num_items=ACF_I, num_train=len(pairs), train_pairs=pairs,
                                 padded_pos=items, pos_counts=cnt,
                                 steps_per_epoch=lambda b: len(pairs) // b)
    summary = dict(setup_s=time.perf_counter() - phase_t0)
    summary["route"] = acf_route_phase(torch, np, PG, ACF, fspat)
    model, full = acf_full_phase(torch, np, G, S, ACF, fspat, data, items, cnt, start)
    summary.update(full)
    summary.update(acf_eval_serve_phase(torch, np, counts, segmax, model, items, cnt))
    summary["peak_gib"] = (torch.cuda.max_memory_allocated() - start) / 2**30
    del model, fspat
    torch.cuda.empty_cache()
    cli_launches, summary["cli"] = acf_cli_phase(torch, np, counts, segmax, G, S)
    rows = acf_row_phase(torch, G, S)
    summary["s"] = time.perf_counter() - phase_t0
    print(f"acf phase: {summary['s']!r} s")
    return cli_launches, summary, rows


def comp_features(torch, n_items, g, hw=COMP_HW):
    """CompVBPR's frozen inputs made on the card from ``g``: semantic (vgg19
    fc2, 4096), color (8x8x8 histograms, 512) and texture (one layer of the
    32x32 gram grid, 1024) maxabs-normalized non-negative features on the
    1/64 grid, and edge images [I, hw, hw, 1] in [0, 1]."""
    dev = g.device
    feats = [torch.rand(n_items, dim, device=dev, generator=g).mul_(64).round_().div_(64)
             for dim in (COMP_DIM_S, COMP_DIM_C, COMP_DIM_T)]
    edges = torch.rand(n_items, hw, hw, 1, device=dev, generator=g)
    return feats[0], feats[1], edges, feats[2]


def comp_model(torch, CompVBPR, n_users, n_items, feats, device, seed,
               compute_dtype="float32"):
    """CompVBPR at the JAX CLI's widths (K=128, d=20, every family at
    weight 0.25) over ``feats``, random weights from ``seed``."""
    return CompVBPR(n_users, n_items, *feats, embed_k=EMBED_K, embed_d=COMP_EMBED_D,
                    compute_dtype=compute_dtype, device=device,
                    generator=torch.Generator(device=device).manual_seed(seed))


def comp_masks(torch, B, g):
    """The CNN's four dropout keep-masks of one step (the positives' fc6,
    fc7, then the negatives'), drawn on the card: both routes take them."""
    return [torch.rand(B, 4096, device=g.device, generator=g) < 0.5 for _ in range(4)]


def comp_generic_step(torch, model, tx, state, batch, masks):
    """One generic Trainer step (autograd of ``loss``, TF-parity Adam) with
    the given dropout masks, as ``Trainer.run_steps`` takes it."""
    from fashionvisualexpl_tpu_torch.core.train_state import apply_gradients

    names = list(state.params)
    with torch.enable_grad():
        loss = model.loss(*(x.long() for x in batch), TRAIN_REG, rng=masks)
        grads = torch.autograd.grad(loss, [state.params[k] for k in names])
    return apply_gradients(state, dict(zip(names, grads)), tx), float(loss.detach())


def comp_route_phase(torch, np, PG, CompVBPR, feats):
    """CompVBPR's packed step (fp32 and fp8 moments) and generic Trainer
    step on the card against the same steps on the CPU, on a 4096 x 4096
    catalog (the first rows of the full inputs) at batch 256, each step
    from the CPU route's state with dropout masks drawn once and shared.
    The rows and the other dense params by ``packed_route_check`` and the
    route tolerances, the CNN by ``cnn_route_check`` (its ReLUs part the
    routes' gradients beyond rounding)."""
    from fashionvisualexpl_tpu_torch.core.train_state import create_train_state, tf_parity_adam

    t0 = time.perf_counter()
    N, B, n = COMP_ROUTE_N, COMP_ROUTE_B, COMP_ROUTE_STEPS
    models = [comp_model(torch, CompVBPR, N, N, [f[:N].to(d) for f in feats], d, 40)
              for d in ("cuda", "cpu")]
    with torch.no_grad():
        for a, b in zip(models[0].parameters(), models[1].parameters()):
            b.copy_(a.cpu())
    spec = models[0].packed_spec()
    g = torch.Generator(device="cuda").manual_seed(41)
    batches = [tuple(torch.randint(0, N, (B,), device="cuda", generator=g, dtype=torch.int32)
                     for _ in range(3)) for _ in range(n)]
    masks = [comp_masks(torch, B, g) for _ in range(n)]
    out = {}
    for md in ("float32", "float8"):
        label = f"comp_vbpr packed route {md}"
        plain = state_on(torch, PG.pack_generic_state(
            models[0], dict(models[0].named_parameters()), moment_dtype=md))
        steps = [PG.make_generic_packed_step(m, TRAIN_LR, TRAIN_REG, moment_dtype=md,
                                             lazy_catchup=True) for m in models]
        losses, err, beyond, cnn_gap, cnn_apart = [], 0.0, 0, 0.0, 0
        for s in range(n):
            kern = state_on(torch, plain, "cuda")  # the CPU route's state
            kern, lk = steps[0](kern, (None, batches[s], masks[s]))
            plain, lp = steps[1](plain, (None, tuple(x.cpu() for x in batches[s]),
                                         [m.cpu() for m in masks[s]]))
            lk, lp = float(lk), float(lp)
            if not (np.isfinite(lk) and abs(lk - lp) <= 1e-5 * abs(lp)):
                fail(f"{label} step {s}: loss {lk!r} (kernels) vs {lp!r} (plain)")
            losses.append((lk, lp))
            rest = {k: v for k, v in plain.dense.items() if k != "cnn"}
            e, nb = packed_route_check(torch, PG, f"{label} step {s}", kern,
                                       plain._replace(dense=rest), spec, md, s + 1, TRAIN_LR)
            cnn_norm, apart = cnn_route_check(torch, f"{label} step {s}", kern.dense["cnn"],
                                              plain.dense["cnn"], s + 1)
            err, beyond = max(err, e), beyond + nb
            cnn_gap, cnn_apart = max(cnn_gap, cnn_norm), cnn_apart + apart
        out[md] = dict(max_abs_err=err, beyond=beyond, cnn_norm_gap=cnn_gap,
                       cnn_params_apart=cnn_apart, losses=losses,
                       user_width=kern.user_pmv.shape[1], item_width=kern.item_pmv.shape[1])
        print(f"{label}: {n} steps at batch {B}, user rows {kern.user_pmv.shape[1]} and item "
              f"rows {kern.item_pmv.shape[1]} wide, each from the CPU route's state, shared "
              f"dropout masks, card vs CPU: losses {losses}; rows and other dense params "
              f"max_abs_err={err!r}, {beyond} values a code or drift apart; the CNN's moments "
              f"within {cnn_gap!r} of their norm, {cnn_apart} of its params apart; tau, pads "
              f"and untouched rows bit-equal ok")
        del kern, plain
    # the generic Trainer's step, each from the CPU route's state
    tx = tf_parity_adam(TRAIN_LR)
    plain = create_train_state({k: v.detach().clone()
                                for k, v in models[1].named_parameters()}, tx)
    losses, err, cnn_gap, cnn_apart = [], 0.0, 0.0, 0
    for s in range(n):
        kern = state_on(torch, plain, "cuda", models[0])
        cpu = state_on(torch, plain, "cpu", models[1])
        kern, lk = comp_generic_step(torch, models[0], tx, kern, batches[s], masks[s])
        plain, lp = comp_generic_step(torch, models[1], tx, cpu,
                                      tuple(x.cpu() for x in batches[s]),
                                      [m.cpu() for m in masks[s]])
        if not abs(lk - lp) <= 1e-5 * abs(lp):
            fail(f"comp_vbpr generic route step {s}: loss {lk!r} (card) vs {lp!r} (CPU)")
        losses.append((lk, lp))
        e, gap, apart = comp_generic_check(torch, f"comp_vbpr generic route step {s}", kern,
                                           plain, s + 1)
        err, cnn_gap, cnn_apart = max(err, e), max(cnn_gap, gap), cnn_apart + apart
    out["generic"] = dict(losses=losses, max_abs_err=err, cnn_norm_gap=cnn_gap,
                          cnn_params_apart=cnn_apart)
    out["s"] = time.perf_counter() - t0
    print(f"comp_vbpr generic route: {n} Trainer steps at batch {B}, each from the CPU "
          f"route's state, shared dropout masks, card vs CPU: losses {losses}; other params "
          f"max_abs_err={err!r}; the CNN's moments within {cnn_gap!r} of their norm, "
          f"{cnn_apart} of its params apart; route checks {out['s']!r} s")
    del models, kern, plain, cpu
    torch.cuda.empty_cache()
    return out


def cnn_route_check(torch, label, kern, plain, steps):
    """The CNN's params and moments ({member: tensor} triples (p, m, v), the
    kernel route's on the card, the plain route's on the CPU) after the same
    step from one state.  These are plain PyTorch on both routes (cuDNN and
    cuBLAS against the CPU), not a kernel of ours, and they part beyond
    rounding: where a pre-activation lies within the two routes' rounding
    of 0, one route's ReLU passes its term and the other's stops it, which
    moves whole columns of that layer's gradient and, through the row it
    sits in, every gradient below it, while the forward and the loss agree
    to rounding.  So m and v within COMP_CNN_NORM of the plain route's, as
    the norm of the difference over the norm (this check prints each); the
    params within the route tolerances where m agrees entry by entry within
    rtol, elsewhere within Adam's 2 lr a step.  Returns (the largest
    relative norm, params apart)."""
    worst_norm, apart_n = 0.0, 0
    p, m, v = plain
    kp, km, kv = (({k: t.cpu() for k, t in x.items()}) for x in kern)
    norms = {}
    for k in p:
        for f, x, y in (("m", km[k], m[k]), ("v", kv[k], v[k])):
            ref = float(torch.linalg.vector_norm(y))
            rel = float(torch.linalg.vector_norm(x - y)) / ref if ref else 0.0
            if not rel <= COMP_CNN_NORM:
                fail(f"{label} cnn.{k} {f}: the routes part by {rel!r} of its norm")
            norms[f"{k} {f}"] = rel
            worst_norm = max(worst_norm, rel)
        # m apart beyond its own rounding (below the absolute floor too: a
        # tiny m may change sign, and Adam's step with it)
        apart = (km[k] - m[k]).abs() > ROUTE_RTOL * m[k].abs()
        capped_close(f"{label} cnn.{k} p", kp[k], p[k], ROUTE_RTOL, ROUTE_ATOL, 1.0,
                     2 * TRAIN_LR * steps, apart)
        apart_n += int(apart.sum())
    print(f"{label} CNN m and v, the routes' gap over the norm: "
          + ", ".join(f"{k} {r:.2g}" for k, r in norms.items()))
    return worst_norm, apart_n


def comp_generic_check(torch, label, kern, plain, steps):
    """Two generic train states after the same step (the kernel route's on
    the card, the plain route's on the CPU): the CNN's by
    ``cnn_route_check``, every other param, m and v within the route
    tolerances.  Returns (max err, the CNN's largest relative norm, its
    params apart)."""
    err_max = 0.0
    cnn = [k for k in plain.params if k.startswith("cnn.")]
    for k, pk in kern.params.items():
        if k in cnn:
            continue
        for a, b in ((pk.detach(), plain.params[k].detach()),
                     (kern.opt_state.mu[k], plain.opt_state.mu[k]),
                     (kern.opt_state.nu[k], plain.opt_state.nu[k])):
            err_max = max(err_max, worst(torch, f"{label} {k}", a.cpu(), b, ROUTE_RTOL,
                                         ROUTE_ATOL))

    def group(st):
        return tuple({k[4:]: t[k].detach() for k in cnn}
                     for t in (st.params, st.opt_state.mu, st.opt_state.nu))

    return (err_max, *cnn_route_check(torch, label, group(kern), group(plain), steps))


def comp_full_phase(torch, np, G, S, CompVBPR, feats, data, start):
    """The packed epoch (20 steps at batch 8192, fp32 moments) through K4
    and K5 and 10 generic Trainer steps, each timed with its peak memory
    above ``start`` and profiled (5 steps): the idle share and the shares
    of K4, K5, the convs and the GEMMs."""
    from fashionvisualexpl_tpu_torch.core.config import TrainConfig
    from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
    from fashionvisualexpl_tpu_torch.train.trainer import Trainer

    model = comp_model(torch, CompVBPR, COMP_U, COMP_I, feats, "cuda", 42)
    out = {}
    for path, steps, key in (("packed", COMP_STEPS, 150), ("generic", COMP_GENERIC_STEPS, 160)):
        label = f"comp_vbpr {path}"
        trainer = Trainer(model, data, TrainConfig(batch_size=COMP_B, lr=TRAIN_LR,
                                                   reg=TRAIN_REG, train_path=path))
        tabs = (trainer._train_pairs, trainer._padded_pos, trainer._pos_counts)
        state, frozen = trainer.init_state()
        triples = sample_triplets(key, *tabs, COMP_I, steps + 1, COMP_B, device="cuda")
        # one step first (allocations, library handles), untimed
        state, _ = trainer.run_steps(state, frozen, tuple(t[:1] for t in triples),
                                     step_key=key + 1)
        triples = tuple(t[1:] for t in triples)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        G.gather_rows.launches = S.scatter_rows_set.launches = 0
        S.scatter_rows_set.routes.clear()
        G.gather_rows.routes.clear()  # this path starts here
        t0 = time.perf_counter()
        state, loss = trainer.run_steps(state, frozen, triples, step_key=key + 2)
        loss = float(loss)
        dt = time.perf_counter() - t0
        launches = {"gather_rows": G.gather_rows.launches,
                    "scatter_rows_set": S.scatter_rows_set.launches}  # ... and ends here
        routes = dict(G.gather_rows.routes)
        row = dict(steps=steps, batch=COMP_B, s=dt, ms_per_step=1e3 * dt / steps,
                   triples_per_s=steps * COMP_B / dt,
                   peak_gib=(torch.cuda.max_memory_allocated() - start) / 2**30,
                   mean_loss=loss / steps, launches=launches)
        if path == "packed":
            inner = state.inner
            # the user rows (625 floats) and the item rows (388), each
            # gathered twice and written once a step, on the routes their
            # plans name
            row["scatter_routes"] = scatter_routes(S, label, launches["scatter_rows_set"],
                                                   steps, (inner.user_pmv, inner.item_pmv))
            want = {"gather_rows": 4 * steps, "scatter_rows_set": 2 * steps}
            want_routes = {}
            for table in (inner.user_pmv, inner.item_pmv):
                r = G.gather_plan(table.shape[1], table.data_ptr(), 0).route
                want_routes[r] = want_routes.get(r, 0) + 2 * steps
            if launches != want or routes != want_routes:
                fail(f"{label}: launches {launches} (expected {want}), K4 routes {routes} "
                     f"(expected {want_routes})")
            row.update(gather_routes=routes, user_width=inner.user_pmv.shape[1],
                       item_width=inner.item_pmv.shape[1])
        elif any(launches.values()):
            fail(f"{label}: the generic path launched the row kernels {launches}")
        if not np.isfinite(loss) or int(state.step) != steps + 1:
            fail(f"{label}: loss {loss!r}, step {int(state.step)}")
        print(f"{label}: {row}")
        row["profile"] = step_profile(
            torch, label, lambda tr: trainer.run_steps(state, frozen, tr, step_key=key + 3),
            sample_triplets(key + 4, *tabs, COMP_I, COMP_PROFILE_STEPS, COMP_B, device="cuda"),
            COMP_PROFILE_STEPS)
        if row["profile"]["tf32_share"] or not row["profile"]["conv_share"]:
            fail(f"{label}: TF32 kernels in the step, or no convolution: {row['profile']}")
        out[path] = row
        del trainer, state, triples
        torch.cuda.empty_cache()
    return model, out


def comp_eval_serve_phase(torch, np, counts, segmax, model, items, cnt):
    """The trained model through ``FactoredEvaluator(counts_impl="kernel")``
    at D=208 (the test split over 1M users: one item per user outside its
    20 positives), the first user blocks again through the bucketed engine;
    then ``RecServer`` through K3 at the serving buckets (every launch on
    the register kernel at B <= 64 and on ``segmax_wgmma_wide_kernel``
    above), 64 users against a full-catalog fp32 oracle
    (the evaluator's factors, so the CNN encodes the catalog three times,
    not four)."""
    from fashionvisualexpl_tpu_torch.eval.evaluator import concat_metrics
    from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator
    from fashionvisualexpl_tpu_torch.ops.metrics import mean_metrics
    from fashionvisualexpl_tpu_torch.serve import RecServer

    out = {}
    t0 = time.perf_counter()
    data = types.SimpleNamespace(num_users=COMP_U, num_items=COMP_I,
                                 training_list=items.tolist(),
                                 test_list=(items[:, :1] + 1).tolist(), validation_list=[],
                                 has_validation=False)
    ev = FactoredEvaluator(model, data, k=EVAL_K, user_block=EVAL_BLOCK, counts_impl="kernel")
    evb = FactoredEvaluator(model, data, k=EVAL_K, user_block=EVAL_BLOCK,
                            counts_impl="bucketed")
    out["setup_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts.counts_kernel.launches = 0  # CompVBPR's evaluation path starts here
    t0 = time.perf_counter()
    metrics = ev.evaluate(None, None)
    out["evaluate_s"] = time.perf_counter() - t0
    launches = counts.counts_kernel.launches  # ... and ends here
    t0 = time.perf_counter()
    uf, iv, ib = ev._factors(None)  # factored_eval: every item's edge image encoded
    torch.cuda.synchronize()
    out["factored_eval_s"] = time.perf_counter() - t0
    want = -(-COMP_U // EVAL_BLOCK)
    vals = np.array(list(metrics.values()))
    if launches != want or uf.shape[1] != COMP_D or not (
            np.isfinite(vals).all() and (vals >= 0).all() and (vals <= 1).all()):
        fail(f"comp_vbpr evaluation: {launches} K2 launches (expected {want}), D "
             f"{uf.shape[1]}, metrics {metrics}")
    per = []
    for e in (ev, evb):
        blocks = []
        for blk in range(EVAL_CHECK_BLOCKS):
            ids = torch.arange(blk * EVAL_BLOCK, (blk + 1) * EVAL_BLOCK, device="cuda")
            blocks.append(e._eval_block("test", uf[ids], iv, ib, ids))
        per.append(mean_metrics(concat_metrics(blocks)))
    for f in ("hr", "prec", "rec", "auc", "ndcg"):
        a, b = float(getattr(per[0], f)), float(getattr(per[1], f))
        if not abs(a - b) <= 2e-4 + 2e-3 * abs(b):
            fail(f"comp_vbpr evaluation: the first blocks' mean {f} {a!r} (K2) vs {b!r} "
                 f"(bucketed)")
    out.update(metrics=metrics, launches=launches,
               split_ms=1e3 * (out["evaluate_s"] - out["factored_eval_s"]),
               scores_per_s=COMP_U * COMP_I / (out["evaluate_s"] - out["factored_eval_s"]))
    print(f"comp_vbpr evaluation at D={COMP_D}: evaluate {out['evaluate_s']!r} s (of which "
          f"factored_eval, the CNN over every item, {out['factored_eval_s']!r} s), test split "
          f"{out['split_ms']!r} ms, {launches} K2 launches, evaluator setup "
          f"{out['setup_s']!r} s; the first {EVAL_CHECK_BLOCKS} blocks' means equal through "
          f"the bucketed engine within rtol 2e-3; metrics {metrics}")
    del ev, evb

    t0 = time.perf_counter()
    srv = RecServer(model, data, k=K_TOP, seg=SEG, oversample=OVERSAMPLE,
                    item_block=ITEM_BLOCK, history=(items, cnt))
    srv.refresh()
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    rng = np.random.default_rng(43)
    batches = {B: rng.choice(COMP_U, B, replace=False) for B in BUCKETS}
    serving, served, serve_launches, serve_routes = serve_buckets(
        np, segmax, srv, batches, SERVE_REPS, f"comp_vbpr serving D={COMP_D}",
        {"segmax_mma_regs_kernel", "segmax_wgmma_wide_kernel"})
    with torch.no_grad():  # the oracle: full-catalog fp32 scores of the factors
        u64 = torch.as_tensor(batches[64], device="cuda").long()
        s = uf[u64] @ iv.T + ib
        for row, uid in enumerate(batches[64]):
            s[row, torch.as_tensor(items[uid, :cnt[uid]], device="cuda").long()] = -np.inf
        want_vals, want_ids = torch.topk(s, K_TOP, dim=1)
    check_served(np, f"comp_vbpr serve check B=64 bf16 kernel D={COMP_D}", *served[64],
                 want_ids.cpu().numpy(), want_vals.cpu().numpy())
    out["serve"] = dict(refresh_s=refresh_s, buckets=serving, launches=serve_launches,
                        routes=serve_routes)
    print(f"comp_vbpr serving: refresh {refresh_s!r} s, {serving}, K3 {serve_routes}")
    del srv, uf, iv, ib
    torch.cuda.empty_cache()
    return out


def comp_kernel_phase(torch, np, counts, segmax, topk, G, S, items):
    """K3 and K2 alone at D=208 and K4 and K5 at CompVBPR's user rows, each
    checked against its plain version (K3 within its tolerance on its
    asserted route, K2 bit-equal on 1/64-grid data, K4 and K5 bit-equal)
    and timed with the L2 flushed beside its bound and the library call;
    the ptxas registers and spills of K3's D=208 instantiations."""
    from fashionvisualexpl_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(44)
    flush = torch.empty(256 * 2**20 // 4, device=dev)
    out = {"segmax_scores": {}, "gather_rows": {}, "scatter_rows_set": {}}
    out["segmax_ptxas"] = [r for r in cuda_build.ptxas_report(cuda_build.build_logs["segmax"])
                           if r["kernel"].startswith(("segmax_mma_regs_kernel<16,",
                                                      "segmax_wgmma_wide_kernel"))]
    for row in out["segmax_ptxas"]:
        print(f"segmax D={COMP_D} instantiation ptxas: {row}")
    t0 = time.perf_counter()
    # K3 over the 200k catalog padded to the serving block, at the buckets
    Ip, D = -(-COMP_I // ITEM_BLOCK) * ITEM_BLOCK, COMP_D
    iv = torch.randn(Ip, D, device=dev, generator=g).bfloat16()
    ib = torch.randn(Ip, device=dev, generator=g) * 0.1
    ib[COMP_I:] = -1e30
    for B, iters in ((8, 50), (64, 50), (1024, 20), (4096, 10)):
        uf = (torch.randn(B, D, device=dev, generator=g) * (3.0 / D**0.5)).bfloat16()
        route = segmax.segmax_route(B, D, SEG, segmax.operand_align(uf, iv))
        before = segmax.segmax_scores.routes.copy()
        got = segmax.segmax_scores(uf, iv, ib, SEG)
        torch.cuda.synchronize()
        took = segmax.segmax_scores.routes - before
        want = segmax.segmax_scores_reference(uf, iv, ib, SEG)
        err = float((got - want).abs().max())
        kernel = wide_kernel(B, D)
        if route["kernel"] != kernel or set(took) != {kernel} or \
                not bool(((got - want).abs() <= K_ATOL + K_RTOL * want.abs()).all()):
            fail(f"segmax at D={D} B={B}: planned {route}, took {dict(took)}, "
                 f"max_abs_err={err!r}")
        bound, by = segmax_bound_ms(B, Ip, D, SEG, 2, PEAK_BF16_FLOPS)
        ms, call_ms, _ = kernel_times(torch, f"segmax D={D} B={B}",
                                      lambda: segmax.segmax_scores(uf, iv, ib, SEG), iters, flush,
                                      bound)
        plain, _, _ = kernel_times(torch, f"segmax plain D={D} B={B}",
                                   lambda: segmax.segmax_scores_reference(uf, iv, ib, SEG), 5,
                                   flush)
        lib, _, _ = kernel_times(torch, f"segmax library D={D} B={B}",
                                 lambda: torch.matmul(uf, iv.T), iters, flush)
        check_bound(f"segmax D={D} B={B}", ms, bound)
        out["segmax_scores"][B] = dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain,
                                       bound_ms=bound, bound_by=by, library_ms=lib,
                                       kernel=route["kernel"], Dp=route["Dp"],
                                       copy_bytes=route["copy_bytes"],
                                       vs_library=ms / lib, shape=f"B={B} Ip={Ip} D={D} "
                                       f"seg={SEG} bf16, cold L2")
        print(f"kernel time segmax B={B} Ip={Ip} D={D} seg={SEG} bf16, cold L2 "
              f"({route['kernel']}, Dp {route['Dp']}, {route['copy_bytes']}-byte copies): "
              f"ms={ms!r} call_ms={call_ms!r} plain_ms={plain!r} library_ms(matmul bf16)="
              f"{lib!r} ({ms / lib:.2f}x) bound_ms={bound!r} ({by})")
        del uf, got, want
    del iv, ib
    torch.cuda.empty_cache()

    # K2 at the evaluator's block: 4096 users of the test split x the
    # catalog, D=208, the banned sets of the evaluation data, 1/64 grid
    I, B = COMP_I, EVAL_BLOCK
    banned_np = np.concatenate([items[:B], items[:B, :1] + 1], axis=1)
    W = topk.banned_bucket_width(banned_np, I, EVAL_TILE)
    banned = torch.from_numpy(banned_np).to(dev)
    uf, iv, ib = (q64(torch.randn(*shape, device=dev, generator=g) * 0.25)
                  for shape in ((B, D), (I, D), (I,)))
    ref = torch.einsum("bd,bwd->bw", uf, iv[banned[:, -1:].long()]) + ib[banned[:, -1:].long()]
    loc, msk = topk.bucket_banned_ids_device(banned, I, EVAL_TILE, W)
    *args, item_tile, ut = counts.pad_counts_inputs(uf, iv, ib, ref, loc, msk, EVAL_TILE)
    got = counts.counts_kernel(*args, item_tile=item_tile, user_tile=ut)
    torch.cuda.synchronize()
    if not torch.equal(got, counts.counts_kernel_reference(*args, item_tile)):
        fail(f"counts kernel disagrees with its plain version at D={D}")
    uf_p, iv_p = args[0], args[1]
    Ip = iv_p.shape[0]
    b, by = counts_bound_ms(B, Ip, D, 1, Ip // EVAL_TILE, W)
    ms, call_ms, _ = kernel_times(torch, f"counts D={D}", lambda: counts.counts_kernel(
        *args, item_tile=item_tile, user_tile=ut), 10, flush, b)
    plain_ms, _, _ = kernel_times(torch, f"counts plain D={D}",
                                  lambda: counts.counts_kernel_reference(*args, item_tile), 5,
                                  flush)
    lib_ms, _, _ = kernel_times(torch, f"counts library D={D}",
                                lambda: torch.matmul(uf_p, iv_p.T), 5, flush)
    check_bound(f"counts D={D}", ms, b)
    out["counts"] = dict(max_abs_err=0.0, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                         bound_ms=b, bound_by=by, library_ms=lib_ms, vs_library=ms / lib_ms,
                         shape=f"B={B} Ip={Ip} D={D} T=1 W={W} f32, cold L2")
    print(f"kernel time counts B={B} Ip={Ip} D={D} T=1 W={W} f32, cold L2: bit-equal ok, "
          f"ms={ms!r} call_ms={call_ms!r} plain_ms={plain_ms!r} library_ms(matmul f32, product "
          f"only)={lib_ms!r} ({ms / lib_ms:.2f}x) bound_ms={b!r} ({by})")
    del args, uf, iv, ib, ref, uf_p, iv_p, got
    torch.cuda.empty_cache()

    # K4 and K5 at the packed user rows over a 1M-row table, batch 8192
    for W in COMP_USER_WIDTHS:
        table = torch.randn(COMP_U, W, device=dev, generator=g)
        ids = torch.randint(0, COMP_U, (COMP_B,), device=dev, generator=g, dtype=torch.int32)
        out["gather_rows"][W] = gather_timed(torch, G, f"R={COMP_U} W={W} B={COMP_B}",
                                             table, ids, flush)
        sids64 = torch.randperm(COMP_U, device=dev, generator=g)[:COMP_B]
        vals = torch.randn(COMP_B, W, device=dev, generator=g)
        out["scatter_rows_set"][W] = scatter_timed(torch, S, f"R={COMP_U} W={W} B={COMP_B}",
                                                   table, sids64, vals, flush)
        del table, ids, sids64, vals
        torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    print(f"comp_vbpr kernel grid: {out['s']!r} s; K4 routes "
          f"{ {W: r['route'] for W, r in out['gather_rows'].items()} }, K5 routes "
          f"{ {W: r['route'] for W, r in out['scatter_rows_set'].items()} }")
    del flush
    torch.cuda.empty_cache()
    return out


def cnn_flops(B: int, h: int, w: int) -> tuple:
    """(forward, backward) operations of the CNN at [B, h, w, 1] images
    (2 a multiply-add): the convs at their SAME output sizes and the FCs;
    the backward twice the forward but for conv1's input gradient (the
    images are frozen)."""
    from fashionvisualexpl_tpu_torch.models.cnn import CONVS, POOL_AFTER

    fwd, cin, first = 0.0, 1, 0.0
    for name, k, cout, stride in CONVS:
        h, w = -(-h // stride), -(-w // stride)
        fwd += 2.0 * B * h * w * cout * k * k * cin
        if name == "conv1":
            first = fwd
        if name in POOL_AFTER:
            h, w = -(-h // 2), -(-w // 2)
        cin = cout
    for fan_in, fan_out in ((h * w * 256, 4096), (4096, 4096), (4096, COMP_EMBED_D)):
        fwd += 2.0 * B * fan_in * fan_out
    return fwd, 2 * fwd - first


def comp_cnn_phase(torch):
    """The CNN at the reference's 224x224 (B=256): TF32 off (the card's
    forward within COMP_F64_RTOL of a float64 forward on the CPU, relative
    to its largest output; TF32 rounds at ~1e-3), then forward and forward +
    backward timed with CUDA events beside the f32 operations bound."""
    from fashionvisualexpl_tpu_torch.models.cnn import CNN

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(45)
    cnn = CNN(COMP_EMBED_D, in_channels=1, input_hw=(224, 224), device=dev, generator=g)
    x = torch.rand(COMP_CNN_B, 224, 224, 1, device=dev, generator=g)
    ref = CNN(COMP_EMBED_D, in_channels=1, input_hw=(224, 224), device="cpu").double()
    with torch.no_grad():
        for a, b in zip(cnn.parameters(), ref.parameters()):
            b.copy_(a.double().cpu())
        got = cnn.encode(x[:2]).double().cpu()
        want = ref.encode(x[:2].double().cpu())
    rel = float((got - want).abs().max() / want.abs().max())
    if rel > COMP_F64_RTOL:
        fail(f"CNN at 224x224 on the card: {rel!r} relative to float64 (TF32 left on?)")
    w = torch.randn(COMP_CNN_B, COMP_EMBED_D, device=dev, generator=g)
    params = list(cnn.parameters())

    def fwd():
        with torch.no_grad():
            cnn.encode(x)

    def fwd_bwd():
        torch.autograd.grad(torch.sum(cnn.encode(x) * w), params)

    fwd_ms, step_ms = cuda_ms(torch, fwd, 5), cuda_ms(torch, fwd_bwd, 5)
    f_ops, b_ops = cnn_flops(COMP_CNN_B, 224, 224)
    f_bound, b_bound = (bound_ms(0, ops, PEAK_F32_FLOPS)[0] for ops in (f_ops, f_ops + b_ops))
    out = dict(batch=COMP_CNN_B, f64_rel_err=rel, fwd_ms=fwd_ms, fwd_bwd_ms=step_ms,
               fwd_bound_ms=f_bound, fwd_bwd_bound_ms=b_bound, fwd_tflops=f_ops / fwd_ms / 1e9,
               fwd_bwd_tflops=(f_ops + b_ops) / step_ms / 1e9)
    print(f"CNN 224x224 B={COMP_CNN_B} f32 (TF32 off: {rel!r} relative to float64): forward "
          f"{fwd_ms!r} ms (bound {f_bound!r} ms at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s f32, "
          f"{out['fwd_tflops']!r} TFLOP/s), forward + backward {step_ms!r} ms (bound "
          f"{b_bound!r} ms, {out['fwd_bwd_tflops']!r} TFLOP/s)")
    del cnn, ref, x
    torch.cuda.empty_cache()
    return out


def write_comp_features(np, d: Path, n: int):
    """CompVBPR's inputs in the reference's layout under data directory
    ``d``: 4096-wide vgg19 fc2 features, 8x8x8 color histograms, 1024-wide
    texture features and 224x224 edge tiffs (L mode: sparse white edges on
    black, as edge maps are; item i's is the (i mod 64)-th of 64 drawn
    maps, encoded once: writing 16,384 encoded anew took 25 s)."""
    from PIL import Image

    from fashionvisualexpl_tpu_torch.core.config import Paths

    rng = np.random.default_rng(46)
    paths = Paths(root=str(d.parent))
    for path, arr in (
        (paths.cnn_features(d.name, "vgg19", "fc2"),
         np.abs(rng.standard_normal((n, COMP_DIM_S), np.float32))),
        (paths.hist_color_features(d.name),
         rng.integers(0, 100, (n, COMP_DIM_C)).astype(np.int32)),
        (paths.texture_features(d.name, "vgg19"),
         np.abs(rng.standard_normal((n, COMP_DIM_T), np.float32))),
    ):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, arr)
    edir = Path(paths.edges_dir(d.name))
    edir.mkdir(parents=True, exist_ok=True)
    tiffs = []
    for _ in range(64):
        buf = io.BytesIO()
        Image.fromarray(((rng.random((224, 224)) < 0.1) * 255).astype(np.uint8),
                        mode="L").save(buf, format="TIFF")
        tiffs.append(buf.getvalue())
    for i in range(n):
        (edir / f"{i}.tiff").write_bytes(tiffs[i % 64])


def comp_cli_phase(torch, np, counts, segmax, G, S):
    """``train_rec --rec comp_vbpr`` at its default ``--edge_hw 224 224``:
    generic with ``--streaming_eval`` on 512 users x 16,384 items (the
    smallest catalog the streaming evaluator sends to K2 by default; K3 in
    its dumps), then ``--train_path packed`` with the dense evaluator (K4,
    K5) and ``serve_rec`` from its checkpoint (K3) on 512 x 512; both
    datasets written here.  The file sets, row counts, metrics and each
    run's launches.  Each run reads its catalog's tiffs anew (16,384: ~25 s
    on the card's host), so only the generic run takes the large one."""
    import glob
    import shutil

    from fashionvisualexpl_tpu_torch.cli.serve_rec import serve
    from fashionvisualexpl_tpu_torch.cli.train_rec import train

    phase_t0 = t0 = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    N = COMP_CLI_U
    for name, n_items in (("cli", COMP_CLI_I), ("cli_small", N)):
        write_reference_dataset(np, CLI_DIR / name, N, n_items)
        write_comp_features(np, CLI_DIR / name, n_items)
    out = dict(write_s=time.perf_counter() - t0)
    users = ",".join(str(u * (N // CLI_SERVE_USERS)) for u in range(CLI_SERVE_USERS))
    steps = 2 * (N * (CLI_PER_USER - 2) // COMP_CLI_B)
    launches = {}
    for label, dataset, extra in (("comp_vbpr", "cli", ("--streaming_eval",)),
                                  ("comp_vbpr-packed", "cli_small", ("--train_path", "packed"))):
        packed = "packed" in label
        results = CLI_DIR / label
        common = ["--rec", "comp_vbpr", "--dataset", dataset, "--data_root", str(CLI_DIR),
                  "--results_root", str(results), "--embed_k", str(EMBED_K),
                  "--embed_d", str(COMP_EMBED_D), "--top_k", str(CLI_K), *extra]
        counts.counts_kernel.launches = segmax.segmax_scores.launches = 0
        segmax.segmax_scores.routes.clear()
        G.gather_rows.launches = S.scatter_rows_set.launches = 0
        S.scatter_rows_set.routes.clear()  # this run starts here
        t1 = time.perf_counter()
        train(common + ["--epochs", "2", "--batch_size", str(COMP_CLI_B)])
        train_s = time.perf_counter() - t1
        (ckpt,) = glob.glob(str(results / "rec_model_weights" / dataset / "comp_vbpr" /
                                "ckpt-*"))
        serve_s = None
        if packed:
            t1 = time.perf_counter()
            serve(common + ["--ckpt", ckpt, "--users", users, "--output",
                            str(results / "served.tsv")])
            serve_s = time.perf_counter() - t1
        run = {"gather_rows": G.gather_rows.launches,
               "scatter_rows_set": S.scatter_rows_set.launches,
               "counts": counts.counts_kernel.launches,
               "segmax_scores": segmax.segmax_scores.launches,
               "segmax_routes": dict(segmax.segmax_scores.routes)}  # ... and ends here
        run["scatter_routes"] = scatter_routes(S, f"{label} cli", run["scatter_rows_set"])
        rdir = results / "rec_results" / dataset / "comp_vbpr"
        metrics = check_cli_run(np, f"{label} cli", results, rdir, N, run,
                                (4 * steps, 2 * steps) if packed else (0, 0),
                                ("segmax_scores",) if packed else ("counts", "segmax_scores"),
                                served=packed)
        files = sorted(os.path.basename(p) for p in glob.glob(str(rdir / "*")))
        kinds = sorted({f.split("-")[0] for f in files})
        ckpts = sorted(os.listdir(ckpt))
        if kinds != ["best", "log", "recs", "results"] or len(files) != 4 \
                or ckpts != ["best-state"] or not set(run["segmax_routes"]) <= {
                    "segmax_mma_regs_kernel", "segmax_wgmma_wide_kernel"}:
            fail(f"{label} cli: wrote {files}, checkpoints {ckpts}, K3 {run['segmax_routes']}")
        launches[label] = run
        out[label] = dict(dataset=dataset, train_s=train_s, serve_s=serve_s, metrics=metrics,
                          files=files)
        print(f"{label} cli ({dataset}): train_rec {train_s!r} s"
              + (f", serve_rec {serve_s!r} s" if packed else "")
              + f"; launches {run}; files {files}; metrics epoch 2 {metrics}")
    out["s"] = time.perf_counter() - phase_t0
    print(f"comp_vbpr cli: {N} x {COMP_CLI_I} and {N} x {N} with 224x224 edge tiffs "
          f"(written in {out['write_s']!r} s); phase {out['s']!r} s")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    return launches, out


def comp_vbpr_phase(torch, np, counts, segmax, topk, G, S):
    """CompVBPR at the JAX CLI's widths (module docstring, phase 20)."""
    from fashionvisualexpl_tpu_torch.models.comp_vbpr import CompVBPR
    from fashionvisualexpl_tpu_torch.train import packed_generic as PG

    phase_t0 = time.perf_counter()
    start = phase_start(torch)
    feats = comp_features(torch, COMP_I, torch.Generator(device="cuda").manual_seed(47))
    pairs, items, cnt = make_scaled_arrays(COMP_U, COMP_I, COMP_P, seed=0)
    data = types.SimpleNamespace(num_items=COMP_I, num_train=len(pairs), train_pairs=pairs,
                                 padded_pos=items, pos_counts=cnt,
                                 steps_per_epoch=lambda b: len(pairs) // b)
    summary = dict(setup_s=time.perf_counter() - phase_t0)
    summary["route"] = comp_route_phase(torch, np, PG, CompVBPR, feats)
    model, full = comp_full_phase(torch, np, G, S, CompVBPR, feats, data, start)
    summary.update(full)
    summary.update(comp_eval_serve_phase(torch, np, counts, segmax, model, items, cnt))
    summary["peak_gib"] = (torch.cuda.max_memory_allocated() - start) / 2**30
    del model, feats
    torch.cuda.empty_cache()
    summary["kernels"] = comp_kernel_phase(torch, np, counts, segmax, topk, G, S, items)
    summary["cnn_224"] = comp_cnn_phase(torch)
    cli_launches, summary["cli"] = comp_cli_phase(torch, np, counts, segmax, G, S)
    summary["s"] = time.perf_counter() - phase_t0
    print(f"comp_vbpr phase: {summary['s']!r} s")
    return cli_launches, summary


# --- the bf16 towers (compute_dtype="bfloat16") ------------------------------

# K7 on bf16 images against its bf16 plain version
# (ops/edge_tower.py::edge_tower_gap_bf16_plain: the f32 tower over the
# images' bf16 values and the weights rounded to bf16) at the tower phase's
# geometries, ties and edge maps and at ragged tiles of odd counts, with the
# f32 kernels' tolerances (TOWER_RTOL ...): every conv product of bf16
# operands is exact in f32, so kernel and plain version differ only in the
# order of f32 sums, as the f32 kernels do (and less: no dropped pieces);
# the float64 witness on one seed of edge maps; timed at TOWER_TIMED beside
# the f32 times of the tower phase.  Then AttentiveFashion's generic,
# packed and streamed steps and CompVBPR's at their phases' shapes in bf16,
# cut in depth to BF16_STEPS (CompVBPR: BF16_COMP_STEPS) timed steps and a
# profile of BF16_PROFILE_STEPS each, and the CLI for both models with
# --compute_dtype bfloat16 on BF16_CLI_N x BF16_CLI_N datasets, one epoch
# (AttentiveFashion's tiffs at 32x32, CompVBPR's at its default
# --edge_hw 224 224)
BF16_ODD = ((5, 34, 36, 130), (3, 18, 200, 100), (1, 32, 32, 300))
# the tensor-core probes' seeds (ops/tc_rounding.py::probe_operands)
TC_PROBE_SEEDS = (0, 1)
BF16_STEPS, BF16_COMP_STEPS, BF16_PROFILE_STEPS = 10, 3, 3
BF16_CLI_N = 2048
# CompVBPR at the reference's 224x224 in bf16: the CNN alone at
# COMP_CNN_B images against the f32 CNN on the same weights, within JAX's
# 5e-2 of the largest output (tests/test_precision.py's bf16 CNN check),
# timed beside the bf16 operations bound; then the generic step at batch
# BF16_224_B (2 x 1024 images through the CNN) over 1M users x BF16_224_I
# items, in bf16 and in f32 on the same model (the catalog cut from 200k:
# a 224x224 edge image is 200 KB in f32, 40 GB for 200k items)
BF16_CNN_TOL, BF16_224_B, BF16_224_I, BF16_224_STEPS = 5e-2, 1024, 32_768, 3


def ptxas_rows(kernel_prefix: str):
    """The ptxas rows of edge_tower.cu's kernels whose names start with
    ``kernel_prefix``, by name."""
    from fashionvisualexpl_tpu_torch.ops import cuda_build

    return {r["kernel"]: r for r in cuda_build.ptxas_report(cuda_build.build_logs["edge_tower"])
            if r["kernel"].startswith(kernel_prefix)}


def tensor_core_probes(torch):
    """How the tensor cores round their f32 sums, on the card
    (``ops/tc_rounding.py``): ``wgmma.m64n64k16`` and ``mma.sync.m16n8k16``
    on every crafted operand kind and TC_PROBE_SEEDS, each model of the
    family scored by the outputs it gets wrong; fails unless
    ``tc_rounding.MEASURED`` gets every output of both right.  Then the bf16
    backward's tap-sum product (the im2col tile read transposed) on 0/1 x
    integer operands, whose sums are exact: equal to ``torch.matmul`` with
    the kernel's byte offsets, unequal with them swapped."""
    from fashionvisualexpl_tpu_torch.core.precision import fp32_math
    from fashionvisualexpl_tpu_torch.ops import tc_rounding as R

    dev = torch.device("cuda")
    runs = {"wgmma": [], "mma.sync": []}
    for kind in R.KINDS:
        for seed in TC_PROBE_SEEDS:
            a, b, c = (t.to(dev) for t in R.probe_operands(kind, seed))
            for op in runs:
                runs[op].append((a, b, c, R.probe_sums(a, b, c, use_mma=op == "mma.sync")))
    out = {}
    for op, rs in runs.items():
        wrong = R.fit(rs)
        ranked = sorted(wrong.items(), key=lambda kv: kv[1])
        out[op] = {R.name(m): n for m, n in ranked[:3]}
        print(f"tensor-core sums {op}: {64 * 64 * len(rs)} outputs of {len(R.KINDS)} crafted "
              f"kinds; {len(wrong)} models, the best three and the outputs each gets wrong: "
              f"{out[op]}")
        if wrong[R.MEASURED]:
            fail(f"tensor-core sums {op}: the measured model ({R.name(R.MEASURED)}) gets "
                 f"{wrong[R.MEASURED]} outputs wrong")
    g = torch.Generator().manual_seed(3)
    a = torch.randint(0, 2, (64, 64), generator=g).bfloat16().to(dev)
    x = torch.randint(-128, 128, (64, 32), generator=g).bfloat16().to(dev)
    with fp32_math():
        want = torch.matmul(a.float(), x.float())
    got, swapped = R.probe_tap_sums(a, x), R.probe_tap_sums(a, x, swap=True)
    if not torch.equal(got, want) or torch.equal(swapped, want):
        fail(f"tap sums through the transposed descriptors: equal to torch.matmul "
             f"{torch.equal(got, want)}, with lbo and sbo swapped {torch.equal(swapped, want)}")
    out["tap_sums_transposed"] = "equal to torch.matmul; with lbo and sbo swapped unequal"
    print(f"tap sums through the transposed descriptors: {out['tap_sums_transposed']}")
    return out


def tower_bf16_phase(torch, E, f32_rows):
    """K7's bf16 kernels against their plain version (also at the
    evaluator's block, TOWER_EVAL), two forward and two backward runs
    bit-equal, the witness, the bf16 kernels' registers against the f32
    ones', then timed beside cuDNN's bf16 conv and the bound at TOWER_TIMED
    and TOWER_EVAL."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(52)
    errs = {"edge_tower_fwd": 0.0, "edge_tower_bwd": 0.0}
    regs = ptxas_rows("edge_")
    f32_bwd, bf16_bwd = regs["edge_bwd_kernel"], regs["edge_bwd_wgmma_kernel"]
    bf16_fwd = regs["edge_fwd_bf16_kernel"]
    print(f"edge_tower bf16 ptxas: {bf16_fwd}, {bf16_bwd} "
          f"(f32: {regs['edge_fwd_kernel']}, {f32_bwd})")
    for name, row in (("forward", bf16_fwd), ("backward", bf16_bwd)):
        if row["spill_stores"] or row["spill_loads"]:
            fail(f"the bf16 {name} spills: {row}")
    probes = tensor_core_probes(torch)

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
        return x.bfloat16(), w, b, torch.randn(B, C, device=dev, generator=g)

    def check(label, x, w, b, dout):
        out, out2 = E.edge_tower_fwd(x, w, b), E.edge_tower_fwd(x, w, b)
        dw, db = E.edge_tower_bwd(x, w, b, dout)
        dw2, db2 = E.edge_tower_bwd(x, w, b, dout)
        torch.cuda.synchronize()
        e_f = worst(torch, f"edge_tower_fwd bf16 {label}", out,
                    E.edge_tower_gap_bf16_plain(x, w, b), TOWER_RTOL, TOWER_ATOL)
        want = E.edge_tower_gap_bf16_plain_backward(x, w, b, dout)
        sums = E.edge_tower_gap_bf16_plain_backward(x, w, b, dout.abs())
        e_b = 0.0
        for name, got, ref, s in zip(("dconv_w", "dconv_b"), (dw, db), want, sums):
            e_b = max(e_b, worst(torch, f"edge_tower_bwd bf16 {label} {name}", got, ref,
                                 TOWER_GRAD_RTOL, TOWER_GRAD_ATOL + TOWER_SUM_ATOL * s))
        if not (torch.equal(out, out2) and torch.equal(dw, dw2) and torch.equal(db, db2)):
            fail(f"edge_tower bf16 {label}: two runs differ")
        print(f"kernel check edge_tower bf16 {label}: fwd max_abs_err={e_f!r} bwd "
              f"max_abs_err={e_b!r} (max |dW| {float(want[0].abs().max())!r}); two forward "
              f"and two backward runs bit-equal ok")
        errs["edge_tower_fwd"] = max(errs["edge_tower_fwd"], e_f)
        errs["edge_tower_bwd"] = max(errs["edge_tower_bwd"], e_b)

    for B, H, W, C in TOWER_GEOMS + BF16_ODD + (TOWER_EVAL,):
        check(f"B={B} H={H} W={W} C={C}", *inputs(B, H, W, C))
        torch.cuda.empty_cache()
    for B, H, W, C, v in TOWER_TIES:
        check(f"B={B} H={H} W={W} C={C} constant {v}", *inputs(B, H, W, C, v))
    for B, H, W, C in TOWER_EDGES:
        check(f"B={B} H={H} W={W} C={C} edge maps k/255", *inputs(B, H, W, C, edges=True))
    flips, readings = tower_f64_witness(torch, E, TOWER_WITNESS_SEEDS[0], bf16=True)
    torch.cuda.empty_cache()

    flush = torch.empty(64 * 2**20 // 4, device=dev)
    conv = torch.nn.functional.conv2d
    rows = {}
    for B, H, W, C in TOWER_TIMED + (TOWER_EVAL,):
        x, w, b, dout = inputs(B, H, W, C)
        xc, wc = x.permute(0, 3, 1, 2), w.bfloat16().permute(3, 2, 0, 1)
        lib_ms, _, _ = kernel_times(torch, "conv2d bf16", lambda: conv(xc, wc, padding=2), 5,
                                    flush)
        bounds = tower_bounds(torch, E, x.float(), w.bfloat16().float(), b, bf16=True)
        issued = tower_fwd_issued(E, B, H, W, C, bf16=True)
        print(f"edge_tower_fwd bf16 B={B} H={H} W={W} C={C}: issued on the tensor cores "
              f"{issued!r} operations, {issued / PEAK_BF16_FLOPS * 1e3!r} ms at peak")
        torch.cuda.empty_cache()
        shape = f"B={B} H={H} W={W} C={C} bf16, cold L2"
        for name, run, plain, (bnd, by) in (
            ("edge_tower_fwd", lambda: E.edge_tower_fwd(x, w, b),
             lambda: E.edge_tower_gap_bf16_plain(x, w, b), bounds[0]),
            ("edge_tower_bwd", lambda: E.edge_tower_bwd(x, w, b, dout),
             lambda: E.edge_tower_gap_bf16_plain_backward(x, w, b, dout), bounds[1]),
        ):
            ms, call_ms, _ = kernel_times(torch, f"{name} bf16", run, 10, flush, bnd)
            plain_ms, _, _ = kernel_times(torch, f"{name} bf16 plain", plain, 5, flush)
            check_bound(f"{name} {shape}", ms, bnd)
            f32 = (None if B == TOWER_EVAL[0] else f32_rows[name] if (H, W) == (AF_HW, AF_HW)
                   else f32_rows[name]["at_224"])
            f32_ms = None if f32 is None else f32["ms"]
            rows.setdefault(name, {})[(B, H, W)] = dict(
                ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                library_ms=lib_ms, shape=shape, f32_ms=f32_ms)
            print(f"kernel time {name} {shape}: ms={ms!r} call_ms={call_ms!r} "
                  f"plain_ms={plain_ms!r} bound_ms={bnd!r} ({by}) library_ms(conv2d bf16, "
                  f"conv only)={lib_ms!r}; the f32 kernel in this run {f32_ms!r} ms")
        del x, w, b, dout, xc, wc
        torch.cuda.empty_cache()
    out = {}
    for name, by_shape in rows.items():
        main, ref = by_shape[TOWER_TIMED[0][:3]], by_shape[TOWER_TIMED[1][:3]]
        reg = bf16_bwd if name == "edge_tower_bwd" else bf16_fwd
        out[name] = dict(max_abs_err=errs[name], **main, at_224=ref,
                         at_eval_block=by_shape[TOWER_EVAL[:3]], ptxas=reg,
                         library="torch.nn.functional.conv2d bf16 (conv only)")
    out["edge_tower_bwd"].update(witness_flips=flips, witness_readings=readings,
                                 tensor_core_probes=probes)
    return out


def bf16_counts(E, G=None, S=None):
    """The launch counts a bf16 path reads: K7's by dtype, and K4 and K5."""
    out = {"edge_tower_fwd_bf16": E.edge_tower_fwd.launches_bf16,
           "edge_tower_bwd_bf16": E.edge_tower_bwd.launches_bf16,
           "edge_tower_fwd": E.edge_tower_fwd.launches,
           "edge_tower_bwd": E.edge_tower_bwd.launches}
    if G is not None:
        out.update(gather_rows=G.gather_rows.launches, scatter_rows_set=S.scatter_rows_set.launches)
    return out


def zero_counts(E, G=None, S=None):
    """Sets the counts ``bf16_counts`` reads to 0."""
    E.edge_tower_fwd.launches = E.edge_tower_bwd.launches = 0
    E.edge_tower_fwd.launches_bf16 = E.edge_tower_bwd.launches_bf16 = 0
    if G is not None:
        G.gather_rows.launches = S.scatter_rows_set.launches = 0


def af_precompute_eval(torch, E, model, label: str, batch_eval: int = AF_CLI_BATCH_EVAL):
    """``model.precompute_eval()`` in blocks of ``batch_eval`` items (the
    CLI's default --batch_eval: one K7 forward a block) after one untimed
    run: ms (host clock, ended by a synchronize), the K7 launches of the
    timed run (counts set to 0 just before, read just after; checked
    against one a block), the encodings' shape and finiteness, and one
    profile (idle share, K7 share)."""
    saved, model.batch_eval = model.batch_eval, batch_eval
    try:
        model.precompute_eval()
        torch.cuda.synchronize()
        zero_counts(E)
        t0 = time.perf_counter()
        enc = model.precompute_eval()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = bf16_counts(E)
        blocks = -(-model.num_items // batch_eval)
        key = "edge_tower_fwd_bf16" if model.compute_dtype == torch.bfloat16 else "edge_tower_fwd"
        if launches[key] != blocks or enc.shape[0] != model.num_items \
                or not bool(torch.isfinite(enc).all()):
            fail(f"{label} precompute_eval: {launches} launches (expected {blocks} of {key}), "
                 f"encodings {tuple(enc.shape)}, finite {bool(torch.isfinite(enc).all())}")
        del enc
        profile = step_profile(torch, f"{label} precompute_eval", lambda _: model.precompute_eval(),
                               None, 1)
    finally:
        model.batch_eval = saved
    print(f"{label} precompute_eval over {model.num_items} items, batch_eval {batch_eval}: "
          f"{ms!r} ms, launches {launches}, idle {profile['idle_share']!r}, K7 "
          f"{profile['k7_share']!r}")
    return dict(ms=ms, batch_eval=batch_eval, blocks=blocks, launches=launches, profile=profile)


def timed_steps(torch, np, label, run, first, triples, n, start, counts, want, params):
    """One untimed step over ``first``, then ``n`` timed steps: ms a step,
    peak memory above ``start``, the launch counts (``counts``: a reset and
    a read, the counts set to 0 just before and read just after) against
    ``want``, every param f32."""
    reset, read = counts
    run(first)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()  # this path starts here
    t0 = time.perf_counter()
    loss = float(run(triples))
    dt = time.perf_counter() - t0
    launches = read()  # ... and ends here
    if launches != want:
        fail(f"{label}: launched {launches}, expected {want}")
    if not np.isfinite(loss):
        fail(f"{label}: loss {loss!r}")
    bad = [k for k, p in params().items() if p.dtype != torch.float32]
    if bad:
        fail(f"{label}: params left f32: {bad}")
    return dict(steps=n, ms_per_step=1e3 * dt / n, mean_loss=loss / n, launches=launches,
                peak_gib=(torch.cuda.max_memory_allocated() - start) / 2**30)


def bf16_train_phase(torch, np, E, G, S, f32):
    """AttentiveFashion's generic, packed and streamed steps and CompVBPR's
    packed and generic steps with compute_dtype="bfloat16" at their phases'
    shapes: ms a step beside the f32 figure of the same run (AttentiveFashion's
    steps also in f32 on the same model just before and after their bf16
    steps), the idle share and K7's or the convs' share, peak memory, every
    param f32; AttentiveFashion's ``precompute_eval`` at --batch_eval 128.
    The generic AttentiveFashion step is the bf16 kernels' main path."""
    import shutil

    from fashionvisualexpl_tpu_torch.core.config import TrainConfig
    from fashionvisualexpl_tpu_torch.data.features import synthetic_features
    from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
    from fashionvisualexpl_tpu_torch.models.attentive_fashion import AttentiveFashion
    from fashionvisualexpl_tpu_torch.models.comp_vbpr import CompVBPR
    from fashionvisualexpl_tpu_torch.train.streamed import (
        STEP_SEED_BASE,
        ArrayFeatureStore,
        StreamedTrainer,
    )
    from fashionvisualexpl_tpu_torch.train.trainer import Trainer, fold_in

    out = {}
    n = BF16_STEPS
    start = phase_start(torch)
    pairs, items, counts = make_scaled_arrays(AF_U, AF_I, AF_POS, seed=0)
    data = types.SimpleNamespace(
        num_items=AF_I, num_train=len(pairs), train_pairs=pairs, padded_pos=items,
        pos_counts=counts, steps_per_epoch=lambda b: len(pairs) // b)
    model = af_model(torch, np, "auto", seed=4, compute_dtype="bfloat16")
    if model.tower_route != "kernel":
        fail(f"bf16 AttentiveFashion on the card took {model.tower_route}")
    for path, f32_row in (("generic", f32["af_train"]), ("packed", f32["af_packed"])):
        label = f"af bf16 {path}"
        trainer = Trainer(model, data, TrainConfig(batch_size=AF_B, lr=AF_LR, reg=AF_REG,
                                                   train_path=path))
        tabs = (trainer._train_pairs, trainer._padded_pos, trainer._pos_counts)
        state, frozen = trainer.init_state()
        triples = sample_triplets(2, *tabs, AF_I, n + 1, AF_B)
        packed = path == "packed"
        rows = (G, S) if packed else (None, None)

        def run(tr, key=[200]):
            nonlocal state
            key[0] += 1
            state, loss = trainer.run_steps(state, frozen, tr, step_key=key[0])
            return loss

        def timed(dtype):
            model.compute_dtype = dtype
            k7 = 2 * n if dtype == torch.bfloat16 else 0
            want = {"edge_tower_fwd_bf16": k7, "edge_tower_bwd_bf16": k7,
                    "edge_tower_fwd": 2 * n - k7, "edge_tower_bwd": 2 * n - k7}
            if packed:
                want.update(gather_rows=4 * n, scatter_rows_set=2 * n)
            return timed_steps(torch, np, f"{label} {dtype}", run, tuple(t[:1] for t in triples),
                               tuple(t[1:] for t in triples), n, start,
                               (lambda: zero_counts(E, *rows), lambda: bf16_counts(E, *rows)),
                               want, lambda: state.params)

        # the step also in f32 on the same model, before and after: the
        # host's state at this point of the run is the same for both
        before = timed(torch.float32)["ms_per_step"]
        row = timed(torch.bfloat16)
        row["f32_same_model_ms_per_step"] = [before, timed(torch.float32)["ms_per_step"]]
        model.compute_dtype = torch.bfloat16
        row["profile"] = step_profile(torch, label, run, sample_triplets(
            3, *tabs, AF_I, BF16_PROFILE_STEPS, AF_B), BF16_PROFILE_STEPS)
        row["f32_ms_per_step"] = f32_row["ms_per_step"]
        print(f"{label}: {row['ms_per_step']!r} ms a step (f32 in this run "
              f"{f32_row['ms_per_step']!r}; on this model here "
              f"{row['f32_same_model_ms_per_step']}), idle "
              f"{row['profile']['idle_share']!r}, K7 "
              f"{row['profile']['k7_share']!r} of the device time, peak {row['peak_gib']!r} "
              f"GiB, launches {row['launches']}")
        out[f"af_{path}"] = row
        del trainer, state, frozen, triples, tabs
        torch.cuda.empty_cache()
    # the evaluation's encodings at the CLI's --batch_eval: one bf16 forward
    # a block of 128 items
    out["af_precompute_eval"] = af_precompute_eval(torch, E, model, "af bf16")
    del model
    phase_start(torch)

    # the streamed step from the streamed phase's stack (written again if gone)
    stack = SAF_DIR / "edges_stack.npy"
    if not stack.exists():
        SAF_DIR.mkdir(parents=True, exist_ok=True)
        write_edge_stack(np, stack, SAF_I, SAF_HW, seed=2)
    edges = np.load(str(stack), mmap_mode="r")
    store = ArrayFeatureStore(synthetic_features(SAF_I, 512, seed=1), edges,
                              synthetic_features(SAF_I, 100, seed=3))
    pairs, items, counts = make_scaled_arrays(SAF_U, SAF_I, SAF_POS, seed=0)
    data = types.SimpleNamespace(
        num_items=SAF_I, num_train=len(pairs), train_pairs=pairs, padded_pos=items,
        pos_counts=counts, steps_per_epoch=lambda b: len(pairs) // b)
    host = AttentiveFashion(
        SAF_U, SAF_I, store.color, edges, store.cls, embed_k=EMBED_K, attention_layers=(64, 1),
        encoder_hidden=256, dropout_rate=0.5, conv_filters=64, batch_eval=SAF_BATCH_EVAL,
        host_features=True, compute_dtype="bfloat16",
        generator=torch.Generator(device="cuda").manual_seed(4))
    strainer = StreamedTrainer(host, data, TrainConfig(batch_size=SAF_B, lr=AF_LR, reg=AF_REG),
                               store, prefetch_depth=SAF_DEPTH)
    sstate, _ = strainer.init_state()
    tabs = (strainer._train_pairs, strainer._padded_pos, strainer._pos_counts)
    triples = sample_triplets(2, *tabs, SAF_I, n + 1, SAF_B)

    def srun(tr):
        nonlocal sstate
        steps = tr[0].shape[0]
        rngs = [torch.Generator(device="cuda").manual_seed(fold_in(2, STEP_SEED_BASE + s))
                for s in range(steps)]
        sstate, loss = strainer.run_streamed_steps(sstate, tr, store, rngs)
        return loss

    def stimed(dtype):
        host.compute_dtype = dtype
        k7 = 2 * n if dtype == torch.bfloat16 else 0
        want = {"edge_tower_fwd_bf16": k7, "edge_tower_bwd_bf16": k7,
                "edge_tower_fwd": 2 * n - k7, "edge_tower_bwd": 2 * n - k7}
        return timed_steps(torch, np, f"streamed {dtype}", srun, tuple(t[:1] for t in triples),
                           tuple(t[1:] for t in triples), n, start,
                           (lambda: zero_counts(E), lambda: bf16_counts(E)), want,
                           lambda: sstate.params)

    before = stimed(torch.float32)["ms_per_step"]  # f32 on the same model, as above
    row = stimed(torch.bfloat16)
    row["f32_same_model_ms_per_step"] = [before, stimed(torch.float32)["ms_per_step"]]
    host.compute_dtype = torch.bfloat16
    row["profile"] = step_profile(torch, "streamed bf16", srun, sample_triplets(
        3, *tabs, SAF_I, BF16_PROFILE_STEPS, SAF_B), BF16_PROFILE_STEPS)
    row["f32_ms_per_step"] = f32["streamed"]["ms_per_step"]
    print(f"streamed bf16: {row['ms_per_step']!r} ms a step (f32 in this run "
          f"{row['f32_ms_per_step']!r}; on this model here "
          f"{row['f32_same_model_ms_per_step']}), idle {row['profile']['idle_share']!r}, K7 "
          f"{row['profile']['k7_share']!r}, peak {row['peak_gib']!r} GiB, launches "
          f"{row['launches']}")
    out["streamed"] = row
    del strainer, host, sstate, store, edges, triples, tabs
    torch.cuda.empty_cache()
    shutil.rmtree(SAF_DIR, ignore_errors=True)
    phase_start(torch)

    # CompVBPR at the comp_vbpr phase's training shape
    feats = comp_features(torch, COMP_I, torch.Generator(device="cuda").manual_seed(47))
    pairs, items, cnt = make_scaled_arrays(COMP_U, COMP_I, COMP_P, seed=0)
    data = types.SimpleNamespace(num_items=COMP_I, num_train=len(pairs), train_pairs=pairs,
                                 padded_pos=items, pos_counts=cnt,
                                 steps_per_epoch=lambda b: len(pairs) // b)
    model = comp_model(torch, CompVBPR, COMP_U, COMP_I, feats, "cuda", 42,
                       compute_dtype="bfloat16")
    m = BF16_COMP_STEPS
    for path, key in (("packed", 150), ("generic", 160)):
        label = f"comp_vbpr bf16 {path}"
        trainer = Trainer(model, data, TrainConfig(batch_size=COMP_B, lr=TRAIN_LR,
                                                   reg=TRAIN_REG, train_path=path))
        tabs = (trainer._train_pairs, trainer._padded_pos, trainer._pos_counts)
        state, frozen = trainer.init_state()
        triples = sample_triplets(key, *tabs, COMP_I, m + 1, COMP_B, device="cuda")

        def run(tr, k=[key]):
            nonlocal state
            k[0] += 1
            state, loss = trainer.run_steps(state, frozen, tr, step_key=k[0])
            return loss

        packed = path == "packed"
        want = dict(gather_rows=4 * m if packed else 0, scatter_rows_set=2 * m if packed else 0,
                    edge_tower_fwd_bf16=0, edge_tower_bwd_bf16=0, edge_tower_fwd=0,
                    edge_tower_bwd=0)
        row = timed_steps(torch, np, label, run, tuple(t[:1] for t in triples),
                          tuple(t[1:] for t in triples), m, start,
                          (lambda: zero_counts(E, G, S), lambda: bf16_counts(E, G, S)), want,
                          lambda: state.params)
        row["profile"] = step_profile(torch, label, run, sample_triplets(
            key + 4, *tabs, COMP_I, BF16_PROFILE_STEPS, COMP_B, device="cuda"),
            BF16_PROFILE_STEPS)
        if row["profile"]["tf32_share"] or not row["profile"]["conv_share"]:
            fail(f"{label}: TF32 kernels in the step, or no convolution: {row['profile']}")
        row["f32_ms_per_step"] = f32["comp"][path]["ms_per_step"]
        print(f"{label}: {row['ms_per_step']!r} ms a step (f32 in this run "
              f"{row['f32_ms_per_step']!r}), idle {row['profile']['idle_share']!r}, convs "
              f"{row['profile']['conv_share']!r}, GEMMs {row['profile']['gemm_share']!r}, "
              f"peak {row['peak_gib']!r} GiB")
        out[f"comp_{path}"] = row
        del trainer, state, frozen, triples, tabs
        torch.cuda.empty_cache()
    del model, feats
    phase_start(torch)
    out["cnn_224"] = bf16_cnn_224(torch)
    out["comp_224"] = bf16_comp_224(torch, np, E, phase_start(torch))
    return out


def bf16_cnn_224(torch):
    """The bf16 CNN at 224x224, COMP_CNN_B images: its output against the
    f32 CNN's on the same weights (BF16_CNN_TOL of the largest), forward
    and forward + backward timed with CUDA events beside the bound at the
    bf16 rate, every gradient f32."""
    from fashionvisualexpl_tpu_torch.models.cnn import CNN

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(53)
    cnn = CNN(COMP_EMBED_D, in_channels=1, input_hw=(224, 224), compute_dtype="bfloat16",
              device=dev, generator=g)
    x = torch.rand(COMP_CNN_B, 224, 224, 1, device=dev, generator=g)
    f32 = CNN(COMP_EMBED_D, in_channels=1, input_hw=(224, 224), device=dev)
    f32.load_state_dict(cnn.state_dict())
    with torch.no_grad():
        got, want = cnn.encode(x), f32.encode(x)
    del f32
    if got.dtype != torch.float32 or not bool(torch.isfinite(got).all()):
        fail(f"bf16 CNN at 224x224: output {got.dtype}, finite "
             f"{bool(torch.isfinite(got).all())}")
    rel = float((got - want).abs().max() / want.abs().max())
    if rel > BF16_CNN_TOL:
        fail(f"bf16 CNN at 224x224: {rel!r} of the largest f32 output")
    w = torch.randn(COMP_CNN_B, COMP_EMBED_D, device=dev, generator=g)
    params = list(cnn.parameters())

    def fwd():
        with torch.no_grad():
            cnn.encode(x)

    def fwd_bwd():
        return torch.autograd.grad(torch.sum(cnn.encode(x) * w), params)

    bad = [p.shape for p, gr in zip(params, fwd_bwd())
           if p.dtype != torch.float32 or gr.dtype != torch.float32]
    if bad:
        fail(f"bf16 CNN at 224x224: params or gradients left f32: {bad}")
    fwd_ms, step_ms = cuda_ms(torch, fwd, 5), cuda_ms(torch, fwd_bwd, 5)
    f_ops, b_ops = cnn_flops(COMP_CNN_B, 224, 224)
    f_bound, b_bound = (bound_ms(0, ops, PEAK_BF16_FLOPS)[0] for ops in (f_ops, f_ops + b_ops))
    out = dict(batch=COMP_CNN_B, rel_to_f32=rel, fwd_ms=fwd_ms, fwd_bwd_ms=step_ms,
               fwd_bound_ms=f_bound, fwd_bwd_bound_ms=b_bound, fwd_tflops=f_ops / fwd_ms / 1e9,
               fwd_bwd_tflops=(f_ops + b_ops) / step_ms / 1e9)
    print(f"CNN 224x224 B={COMP_CNN_B} bf16 ({rel!r} of the largest f32 output): forward "
          f"{fwd_ms!r} ms (bound {f_bound!r} ms at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, "
          f"{out['fwd_tflops']!r} TFLOP/s), forward + backward {step_ms!r} ms (bound "
          f"{b_bound!r} ms, {out['fwd_bwd_tflops']!r} TFLOP/s)")
    del cnn, x, w, params
    torch.cuda.empty_cache()
    return out


def bf16_comp_224(torch, np, E, start):
    """CompVBPR's generic step at 224x224, batch BF16_224_B, over 1M users
    x BF16_224_I items, in bf16 and then in f32 on the same model: ms a
    step, peak memory, every param f32; the bf16 step's profile (idle
    share, the convolutions' and GEMMs' shares, no TF32)."""
    from fashionvisualexpl_tpu_torch.core.config import TrainConfig
    from fashionvisualexpl_tpu_torch.data.sampler import sample_triplets
    from fashionvisualexpl_tpu_torch.models.comp_vbpr import CompVBPR
    from fashionvisualexpl_tpu_torch.train.trainer import Trainer

    n_items, B, m = BF16_224_I, BF16_224_B, BF16_224_STEPS
    feats = comp_features(torch, n_items, torch.Generator(device="cuda").manual_seed(54),
                          hw=224)
    pairs, items, cnt = make_scaled_arrays(COMP_U, n_items, COMP_P, seed=0)
    data = types.SimpleNamespace(num_items=n_items, num_train=len(pairs), train_pairs=pairs,
                                 padded_pos=items, pos_counts=cnt,
                                 steps_per_epoch=lambda b: len(pairs) // b)
    model = comp_model(torch, CompVBPR, COMP_U, n_items, feats, "cuda", 55,
                       compute_dtype="bfloat16")
    trainer = Trainer(model, data, TrainConfig(batch_size=B, lr=TRAIN_LR, reg=TRAIN_REG))
    tabs = (trainer._train_pairs, trainer._padded_pos, trainer._pos_counts)
    state, frozen = trainer.init_state()
    triples = sample_triplets(170, *tabs, n_items, m + 1, B, device="cuda")

    def run(tr, k=[170]):
        nonlocal state
        k[0] += 1
        state, loss = trainer.run_steps(state, frozen, tr, step_key=k[0])
        return loss

    none = dict.fromkeys(("edge_tower_fwd_bf16", "edge_tower_bwd_bf16", "edge_tower_fwd",
                          "edge_tower_bwd"), 0)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        model.compute_dtype = model.cnn.compute_dtype = dtype
        rows[str(dtype)] = timed_steps(
            torch, np, f"comp_vbpr 224x224 {dtype}", run, tuple(t[:1] for t in triples),
            tuple(t[1:] for t in triples), m, start,
            (lambda: zero_counts(E), lambda: bf16_counts(E)), none, lambda: state.params)
    model.compute_dtype = model.cnn.compute_dtype = torch.bfloat16
    row = rows["torch.bfloat16"]
    row["f32_same_model_ms_per_step"] = rows["torch.float32"]["ms_per_step"]
    row["f32_peak_gib"] = rows["torch.float32"]["peak_gib"]
    row["profile"] = step_profile(torch, "comp_vbpr 224x224 bf16", run, sample_triplets(
        174, *tabs, n_items, BF16_PROFILE_STEPS, B, device="cuda"), BF16_PROFILE_STEPS)
    if row["profile"]["tf32_share"] or not row["profile"]["conv_share"]:
        fail(f"comp_vbpr 224x224 bf16: TF32 kernels in the step, or no convolution: "
             f"{row['profile']}")
    row.update(batch=B, items=n_items, hw=224)
    print(f"comp_vbpr bf16 generic 224x224 batch {B} (1M x {n_items}): {row['ms_per_step']!r} "
          f"ms a step (f32 on this model {row['f32_same_model_ms_per_step']!r}), idle "
          f"{row['profile']['idle_share']!r}, convs {row['profile']['conv_share']!r}, GEMMs "
          f"{row['profile']['gemm_share']!r}, peak {row['peak_gib']!r} GiB (f32 "
          f"{row['f32_peak_gib']!r})")
    del trainer, state, frozen, triples, tabs, model, feats
    torch.cuda.empty_cache()
    return row


def bf16_cli_phase(torch, np, E):
    """``train_rec --compute_dtype bfloat16`` for attentive_fashion (32x32
    edge tiffs, --edge_hw 32 32) and comp_vbpr (224x224 tiffs at its default
    --edge_hw 224 224) on BF16_CLI_N x BF16_CLI_N datasets, one epoch: the
    JAX CLI's file set (recs, best recs, metrics, log; attentive_fashion's
    two attention dumps), BF16_CLI_N x CLI_K rows a dump, metrics finite in [0, 1], K7's bf16
    kernels and no f32 ones in the attentive_fashion run."""
    import glob
    import pickle
    import shutil

    from fashionvisualexpl_tpu_torch.cli.train_rec import train

    root = CLI_DIR / "bf16"
    shutil.rmtree(root, ignore_errors=True)
    N = BF16_CLI_N
    t0 = time.perf_counter()
    write_reference_dataset(np, root / "af", N, N)
    write_af_features(np, root / "af", N, AF_HW)
    write_reference_dataset(np, root / "comp", N, N)
    write_comp_features(np, root / "comp", N)
    out = dict(write_s=time.perf_counter() - t0)
    launches = {}
    for rec, dataset, extra, patterns in (
        ("attentive_fashion", "af", ("--batch_eval", str(AF_CLI_BATCH_EVAL), "--edge_hw",
                                     str(AF_HW), str(AF_HW)),
         ("recs-1-*.tsv", "best-recs-*.tsv", "att-recs-1-*.tsv", "best-att-recs-*.tsv")),
        ("comp_vbpr", "comp", ("--embed_d", str(COMP_EMBED_D)),
         ("recs-1-*.tsv", "best-recs-*.tsv")),
    ):
        results = root / f"results-{rec}"
        zero_counts(E)  # this run starts here
        t1 = time.perf_counter()
        train(["--rec", rec, "--dataset", dataset, "--data_root", str(root), "--results_root",
               str(results), "--embed_k", str(EMBED_K), "--top_k", str(CLI_K),
               "--compute_dtype", "bfloat16", "--epochs", "1",
               "--batch_size", "1024", *extra])
        train_s = time.perf_counter() - t1
        run = bf16_counts(E)  # ... and ends here
        if rec == "attentive_fashion" and not (
                run["edge_tower_fwd_bf16"] and run["edge_tower_bwd_bf16"]
                and not run["edge_tower_fwd"] and not run["edge_tower_bwd"]):
            fail(f"{rec} bf16 cli: K7 launches {run}")
        rdir = results / "rec_results" / dataset / rec
        files = sorted(os.path.basename(p) for p in glob.glob(str(rdir / "*")))
        for pattern in patterns:
            paths = glob.glob(str(rdir / pattern))
            if len(paths) != 1:
                fail(f"{rec} bf16 cli: {pattern} matched {paths}")
            table = read_tsv(np, paths[0], 6 if "att" in pattern else 3)
            if len(table) != N * CLI_K:
                fail(f"{rec} bf16 cli {pattern}: {len(table)} rows, expected {N * CLI_K}")
        kinds = sorted({f.split("-")[0] for f in files})
        want_kinds = ["att", "best", "log", "recs", "results"] if rec == "attentive_fashion" \
            else ["best", "log", "recs", "results"]
        if kinds != want_kinds or len(files) != len(patterns) + 2:
            fail(f"{rec} bf16 cli: wrote {files}")
        (pkl,) = glob.glob(str(rdir / "results-metrics-*.pkl"))
        with open(pkl, "rb") as f:
            per_epoch = pickle.load(f)
        vals = np.array([v for m in per_epoch.values() for v in m.values()])
        if sorted(per_epoch) != [1] or not (
                np.isfinite(vals).all() and (vals >= 0).all() and (vals <= 1).all()):
            fail(f"{rec} bf16 cli: metrics not finite in [0, 1]: {per_epoch}")
        launches[rec] = run
        out[rec] = dict(train_s=train_s, files=files, metrics=per_epoch[1])
        print(f"{rec} bf16 cli ({N} x {N}): train_rec {train_s!r} s; launches {run}; files "
              f"{files}; metrics {per_epoch[1]}")
    shutil.rmtree(root, ignore_errors=True)
    return launches, out


def bf16_phase(torch, np, E, G, S, tower_rows, f32):
    """The bf16 towers: K7's bf16 kernels, the steps, the CLI (above).
    Returns (the main path's launches, summary)."""
    phase_t0 = time.perf_counter()
    rows = tower_bf16_phase(torch, E, tower_rows)
    t1 = time.perf_counter()
    steps = bf16_train_phase(torch, np, E, G, S, f32)
    t2 = time.perf_counter()
    cli_launches, cli = bf16_cli_phase(torch, np, E)
    t3 = time.perf_counter()
    summary = dict(kernels=rows, steps=steps, cli=cli, s=t3 - phase_t0, kernels_s=t1 - phase_t0,
                   steps_s=t2 - t1, cli_s=t3 - t2)
    print(f"bf16 phase: {summary['s']!r} s (kernels {summary['kernels_s']!r}, steps "
          f"{summary['steps_s']!r}, cli {summary['cli_s']!r})")
    launches = dict(steps["af_generic"]["launches"], packed=steps["af_packed"]["launches"],
                    streamed=steps["streamed"]["launches"], cli=cli_launches)
    return launches, summary


# --- multi-device: ranks sharing the one card ------------------------------

MESH_DIR = ROOT / "build" / "chip_smoke_mesh"
MESH_STEPS = 3  # training steps compared against one device
MESH_CLI_B = 8192  # the CLI runs' batch (cut: phase 11 trains at 256)
MESH_NCCL_N = 100_000  # the nccl rank's catalog, at full width (cut)
MESH_SERVE_REPS = {8: 10, 64: 10, 1024: 3, 4096: 2}
MESH_TIMEOUT_S = {"serve_eval": 240, "train": 300, "cli": 300, "nccl": 120}


def resnet_flops(blocks, hw: int, with_head: bool = False) -> float:
    """Operations of one hw x hw image through the ResNet (2 a multiply-add):
    every conv at its output size; the fc head's product ``with_head``."""
    h = (hw - 1) // 2 + 1  # the stem, 7x7 / 2, pad 3
    ops = 2.0 * h * h * 64 * 3 * 49
    h = (h - 1) // 2 + 1  # max pool 3x3 / 2, pad 1
    in_c = 64
    for s, (n_blocks, out_c) in enumerate(zip(blocks, (256, 512, 1024, 2048))):
        mid = out_c // 4
        for b in range(n_blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            ho = (h - 1) // stride + 1
            ops += 2.0 * (h * h * in_c * mid + ho * ho * (mid * mid * 9 + mid * out_c))
            if b == 0:
                ops += 2.0 * ho * ho * in_c * out_c  # the projection
            h, in_c = ho, out_c
    return ops + (2.0 * 2048 * 1000 if with_head else 0.0)


def vgg19_flops(hw: int, output_layer: str) -> float:
    """Operations of one hw x hw image through VGG19 up to output_layer."""
    from fashionvisualexpl_tpu_torch.vision.backbones import VGG19_CFG

    h, in_c, ops = hw, 3, 0.0
    for s, stage in enumerate(VGG19_CFG):
        for c in stage:
            ops += 2.0 * h * h * in_c * c * 9
            in_c = c
        h = -(-h // 2)
        if output_layer == f"block{s + 1}_pool":
            return ops
    for name, fan_in, fan_out in (("fc1", h * h * 512, 4096), ("fc2", 4096, 4096),
                                  ("predictions", 4096, 1000)):
        ops += 2.0 * fan_in * fan_out
        if output_layer == name:
            break
    return ops


def vision_close(torch, label, got, want) -> float:
    """Max |got - want| relative to max |want|, after failing beyond
    VISION_RTOL * (|want| + max |want|)."""
    got, want = got.double().cpu(), want.double()
    scale = float(want.abs().max())
    err = (got - want).abs()
    if not bool((err <= VISION_RTOL * (want.abs() + scale)).all()):
        fail(f"{label}: the card's output leaves the CPU route's by "
             f"{float(err.max()) / scale!r} of its largest value")
    return float(err.max()) / scale


def vision_backbone_phase(torch):
    """The three backbones at 224x224 on the card, f32 under fp32_math, at
    the CLI's batches: ms a batch, images/s, peak memory, the share of the
    f32 peak (operations counted from the layer shapes), each output held
    against the CPU route on VISION_CHECK images."""
    from fashionvisualexpl_tpu_torch.vision.backbones import (
        RESNET50_BLOCKS,
        RESNET152_BLOCKS,
        VGG19,
        ResNet,
    )
    from fashionvisualexpl_tpu_torch.vision.extractors import IMAGENET_MEAN, IMAGENET_STD

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(51)
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)
    hw = VISION_HW
    specs = (
        ("ResNet50", lambda **kw: ResNet(RESNET50_BLOCKS, **kw), (
            ("avg_pool", lambda n, x: n.apply(x), resnet_flops(RESNET50_BLOCKS, hw), (2048,)),
            ("spatial_features", lambda n, x: n.spatial_features(x),
             resnet_flops(RESNET50_BLOCKS, hw), (7, 7, 2048)))),
        ("ResNet152", lambda **kw: ResNet(RESNET152_BLOCKS, **kw), (
            ("avg_pool", lambda n, x: n.apply(x), resnet_flops(RESNET152_BLOCKS, hw), (2048,)),)),
        ("VGG19", lambda **kw: VGG19(input_hw=(hw, hw), **kw), (
            ("fc2", lambda n, x: n.apply(x, output_layer="fc2"), vgg19_flops(hw, "fc2"),
             (4096,)),
            ("block5_pool", lambda n, x: n.apply(x, output_layer="block5_pool"),
             vgg19_flops(hw, "block5_pool"), (7, 7, 512)))),
    )
    rows = {}
    for name, build, outputs in specs:
        net = build(device=dev, generator=g)
        cpu = build(device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
        weight_bytes = sum(v.numel() * 4 for v in net.state_dict().values())
        for B in VISION_BATCHES:
            x = (torch.rand(B, hw, hw, 3, device=dev, generator=g) - mean) / std
            for label, fn, ops, shape in outputs:
                key = f"{name} {label} B={B}"
                with torch.inference_mode():
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    out = fn(net, x)
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated()
                    if tuple(out.shape) != (B, *shape) or not bool(torch.isfinite(out).all()):
                        fail(f"{key}: output {tuple(out.shape)}, expected {(B, *shape)} finite")
                    rel = None
                    if B == VISION_BATCHES[0]:
                        rel = vision_close(torch, key, out[:VISION_CHECK],
                                           fn(cpu, x[:VISION_CHECK].cpu()))
                    del out
                    ms = cuda_ms(torch, lambda: fn(net, x), 3 if B > 64 else 5)
                bytes_ = x.numel() * 4 + weight_bytes + B * math.prod(shape) * 4
                bound, by = bound_ms(bytes_, ops * B, PEAK_F32_FLOPS)
                rows[key] = dict(
                    ms=ms, images_per_s=B * 1e3 / ms, gflop_per_image=ops / 1e9,
                    tflops=ops * B / ms / 1e9, bound_ms=bound, bound_by=by,
                    peak_share=bound / ms, peak_gib=peak / 2**30,
                    peak_above_gib=(peak - base) / 2**30, cpu_rel_err=rel)
                r = rows[key]
                print(f"vision {key}: {ms!r} ms a batch, {r['images_per_s']!r} images/s, "
                      f"{r['tflops']!r} TFLOP/s ({r['gflop_per_image']!r} GFLOP an image; "
                      f"{r['peak_share']!r} of the f32 peak, bound {bound!r} ms), peak "
                      f"{r['peak_gib']!r} GiB ({r['peak_above_gib']!r} above the weights "
                      f"and input)" + ("" if rel is None else
                                       f"; the CPU route on {VISION_CHECK} images within "
                                       f"{rel!r} of its largest value"))
            del x
        del net, cpu
        torch.cuda.empty_cache()
    return rows


def write_item_images(np, d: Path, n: int, hw: int, seed: int) -> None:
    """n item images ``0.jpg`` ... of hw x hw: smooth colour fields (an 8x8
    random grid upsampled) under a little noise, JPEG quality 90."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        grid = Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
        img = np.asarray(grid.resize((hw, hw), Image.BILINEAR), np.int16)
        img = img + rng.integers(-8, 9, img.shape, dtype=np.int16)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(d / f"{i}.jpg", quality=90)


def vision_phase(torch, np, counts, segmax):
    """(a) the backbones at full width; (b) ``extract_features`` from the
    command line on VISION_IMAGES images written here; (c) ``train_rec
    --rec vbpr`` on the features it extracted."""
    import csv
    import glob
    import pickle
    import shutil

    from fashionvisualexpl_tpu_torch.cli.extract_features import extract
    from fashionvisualexpl_tpu_torch.cli.train_rec import train
    from fashionvisualexpl_tpu_torch.core.config import Paths
    from fashionvisualexpl_tpu_torch.vision.backbones import VGG19
    from fashionvisualexpl_tpu_torch.vision.dataset import ImageFolderDataset
    from fashionvisualexpl_tpu_torch.vision.extractors import CnnFeatureExtractor, preprocess

    phase_t0 = time.perf_counter()
    print(f"vision: card {card_line()}")
    backbones = vision_backbone_phase(torch)
    backbone_s = time.perf_counter() - phase_t0

    shutil.rmtree(VISION_DIR, ignore_errors=True)
    ds, n = "vision", VISION_IMAGES
    paths = Paths(root=str(VISION_DIR), results_root=str(VISION_DIR / "results"))
    t0 = time.perf_counter()
    write_item_images(np, Path(paths.images(ds)), n, VISION_IMG_HW, seed=23)
    write_reference_dataset(np, Path(paths.data_dir(ds)), n, n)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    timing = extract(["--dataset", ds, "--data_root", str(VISION_DIR), "--cnn_model", "VGG19",
                      "--output_layer", "fc2", "--batch", str(VISION_CLI_B), "--resize",
                      str(VISION_HW), "--skip_low"])
    extract_s = time.perf_counter() - t0
    phases = {k: v["total_s"] for k, v in timing.items()}
    host_s = phases["decode"] + phases["preprocess"] + phases["write"]
    card_s = phases["extract_feature"] + phases["classify"]
    feats = np.load(paths.cnn_features(ds, "VGG19", "fc2"))
    split = sorted(os.listdir(paths.cnn_features_split_dir(ds, "VGG19", "fc2")))
    with open(paths.classes_csv(ds, "VGG19"), newline="") as f:
        table = list(csv.reader(f))
    onehot = np.load(paths.class_features(ds))
    per_item = os.listdir(paths.class_features_dir(ds))
    if (feats.shape != (n, 4096) or not np.isfinite(feats).all() or len(split) != n
            or table[0] != ["ImageID", "ClassStr", "ClassNum", "Prob"] or len(table) != n + 1
            or [r[0] for r in table[1:]] != [str(i) for i in range(n)]
            or onehot.shape[0] != n or onehot.dtype != np.int64
            or not (onehot.sum(axis=1) == 1).all() or len(per_item) != n):
        fail(f"extract_features: features {feats.shape}, {len(split)} split files, CSV "
             f"{len(table)} rows, one-hots {onehot.shape} {onehot.dtype}, {len(per_item)} "
             f"per item")
    # the CLI's weights are the extractor's default draw (seed 0 on the
    # card): two images through the CPU route on a copy of them
    ref = CnnFeatureExtractor(output_layer="fc2", model_name="VGG19")
    cpu = VGG19(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in ref.net.state_dict().items()})
    del ref
    images = ImageFolderDataset(paths.images(ds), resize=(VISION_HW, VISION_HW))
    x = torch.from_numpy(preprocess(np.stack([images[i][0] for i in range(VISION_CHECK)])))
    with torch.inference_mode():
        want = cpu.apply(x, output_layer="fc2")
        logits = cpu.apply(x, output_layer="predictions")
    rel = vision_close(torch, "extract_features", torch.from_numpy(feats[:VISION_CHECK]), want)
    if [int(r[2]) for r in table[1:VISION_CHECK + 1]] != logits.argmax(dim=1).tolist():
        fail("extract_features: the CSV's classes are not the CPU route's")
    del cpu
    cli = dict(images=n, image_hw=VISION_IMG_HW, batch=VISION_CLI_B, write_s=write_s,
               wall_s=extract_s, phases_s=phases, host_s=host_s, card_s=card_s,
               host_share=host_s / extract_s, card_share=card_s / extract_s,
               images_per_s=n / extract_s, classes=int(onehot.shape[1]), cpu_rel_err=rel)
    print(f"extract_features VGG19 fc2 on {n} images of {VISION_IMG_HW}x{VISION_IMG_HW}, "
          f"--batch {VISION_CLI_B}: {extract_s!r} s wall ({n / extract_s!r} images/s); by "
          f"phase {phases}; the host (decode + resize, preprocess, writes) {host_s!r} s = "
          f"{host_s / extract_s!r}, the card's two passes a batch {card_s!r} s = "
          f"{card_s / extract_s!r}; {onehot.shape[1]} classes; rows 0-1 within {rel!r} of "
          f"the CPU route (card {card_line()})")

    # (c) train_rec --rec vbpr on what was extracted: the main path's K3
    # launches are the dumps'
    results = VISION_DIR / "results"
    counts.counts_kernel.launches = 0
    segmax.segmax_scores.launches = 0  # main path starts here
    t0 = time.perf_counter()
    train(["--rec", "vbpr", "--dataset", ds, "--data_root", str(VISION_DIR),
           "--results_root", str(results), "--cnn_model", "VGG19", "--output_layer", "fc2",
           "--epochs", "1", "--streaming_eval", "--top_k", str(CLI_K)])
    train_s = time.perf_counter() - t0
    launches = {"counts": counts.counts_kernel.launches,
                "segmax_scores": segmax.segmax_scores.launches}  # main path ends here
    if not launches["segmax_scores"]:
        fail(f"train_rec --rec vbpr on the extracted features did not launch K3: {launches}")
    rdir = results / "rec_results" / ds / "vbpr"
    rows = {}
    for pattern in ("recs-1-*.tsv", "best-recs-*.tsv"):
        (path,) = glob.glob(str(rdir / pattern))
        rows[pattern] = len(read_tsv(np, path, 3))
        if rows[pattern] != n * CLI_K:
            fail(f"vision train_rec {pattern}: {rows[pattern]} rows, expected {n * CLI_K}")
    (pkl,) = glob.glob(str(rdir / "results-metrics-*.pkl"))
    with open(pkl, "rb") as f:
        per_epoch = pickle.load(f)
    vals = np.array([v for m in per_epoch.values() for v in m.values()])
    if sorted(per_epoch) != [1] or not (
            np.isfinite(vals).all() and (vals >= 0).all() and (vals <= 1).all()):
        fail(f"vision train_rec: metrics not finite in [0, 1] for epoch 1: {per_epoch}")
    trained = dict(train_s=train_s, launches=launches, rows=rows, metrics=per_epoch[1])
    total_s = time.perf_counter() - phase_t0
    print(f"train_rec --rec vbpr --cnn_model VGG19 --output_layer fc2 on the extracted "
          f"features ({n} x {n}, 1 epoch): {train_s!r} s; launches {launches} (K2 takes "
          f"catalogs from 16,384 items); rows {rows}; metrics {per_epoch[1]}; vision phase "
          f"{total_s!r} s (backbones {backbone_s!r} s)")
    shutil.rmtree(VISION_DIR, ignore_errors=True)
    return launches, dict(backbones=backbones, extract_features=cli, train_rec=trained,
                          backbone_s=backbone_s, s=total_s)


def mesh_eval_data(data) -> None:
    """The evaluation phase's Interactions, pickled for the evaluating
    ranks (building them takes the host ~35 s; loading them a few)."""
    import pickle
    import shutil

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    with open(MESH_DIR / "eval_data.pkl", "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"mesh: the evaluation Interactions pickled in {time.perf_counter() - t0!r} s")


def mesh_spawn(job: str, world: int, backend: str = "gloo"):
    """Run ``job`` on ``world`` ranks of this script (``--mesh-rank``), all
    on cuda:0; each rank forms its group over a file in MESH_DIR and writes
    MESH_DIR/<job>.r<rank>.json.  Every rank is killed at the job's time
    limit; a rank that fails fails the phase.  Returns the ranks' outputs."""
    rdv = MESH_DIR / f"{job}.rdv"
    rdv.unlink(missing_ok=True)
    logs = [MESH_DIR / f"{job}.r{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--mesh-rank", job, str(r),
                 str(world), backend], stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT)))
    t0 = time.perf_counter()
    deadline = t0 + MESH_TIMEOUT_S[job]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        text = log.read_text()
        for line in text.splitlines():
            print(f"  [{job} rank {r}] {line}")
        if p.returncode:
            fail(f"mesh {job}: rank {r} exited {p.returncode}")
    print(f"mesh {job}: {world} ranks on one card, {time.perf_counter() - t0!r} s")
    return [json.loads((MESH_DIR / f"{job}.r{r}.json").read_text()) for r in range(world)]


def mesh_rank_main(argv) -> int:
    """One rank of a multi-device job (``mesh_spawn``)."""
    job, rank, world, backend = argv[0], int(argv[1]), int(argv[2]), argv[3]
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    rdv = f"file://{MESH_DIR / f'{job}.rdv'}"
    if world > 1:
        from fashionvisualexpl_tpu_torch.parallel.multihost import initialize_from_env

        initialize_from_env(rdv, world, rank, backend=backend, timeout_s=180)
    else:  # a one-rank group: the collectives still run (nccl)
        import datetime

        dist.init_process_group(backend, init_method=rdv, world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=120))
    out = {"serve_eval": mesh_serve_eval_rank, "train": mesh_train_rank,
           "nccl": mesh_nccl_rank}[job](torch, np, rank)
    from fashionvisualexpl_tpu_torch.core.mesh import staged_bytes

    out["staged_bytes"] = dict(staged_bytes)
    (MESH_DIR / f"{job}.r{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def mesh_serve_setup(torch, np, n=U_FULL):
    """serve_phase's model, history and query batches (the same seeds) over
    n users x n items."""
    from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF

    g = torch.Generator(device="cuda").manual_seed(0)
    model = BPRMF(n, n, embed_k=EMBED_K, generator=g)
    with torch.no_grad():
        model.Bi.normal_(0.0, 2e-5, generator=g)
    rng = np.random.default_rng(0)
    padded = rng.integers(0, n, (n, HIST_P), dtype=np.int32)
    counts = rng.integers(0, HIST_P + 1, n).astype(np.int32)
    batches = {B: rng.choice(n, B, replace=False) for B in BUCKETS}
    data = types.SimpleNamespace(num_users=n, num_items=n)
    return model, data, (padded, counts), batches


def mesh_serve_eval_rank(torch, np, rank):
    """RecServer over a (1, 2) mesh at serve_phase's size, then
    FactoredEvaluator over it at eval_phase's; rank 0 also answers on one
    device and checks."""
    from fashionvisualexpl_tpu_torch.core.mesh import make_mesh
    from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator
    from fashionvisualexpl_tpu_torch.ops import counts as K2
    from fashionvisualexpl_tpu_torch.ops import segmax as K3
    from fashionvisualexpl_tpu_torch.serve import RecServer

    mesh = make_mesh(1, 2)
    model, data, history, batches = mesh_serve_setup(torch, np)
    kw = dict(k=K_TOP, seg=SEG, oversample=OVERSAMPLE, item_block=ITEM_BLOCK, history=history)
    srv = RecServer(model, data, mesh=mesh, **kw)
    t0 = time.perf_counter()
    srv.refresh()
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    serving, served, launches, routes = serve_buckets(np, K3, srv, batches, MESH_SERVE_REPS,
                                                      f"mesh serve rank {rank}")
    out = {"serve": {str(B): r for B, r in serving.items()}, "k3_launches": launches,
           "k3_routes": routes, "refresh_s": refresh_s,
           "local_items": srv._local_padded}
    del srv
    torch.cuda.empty_cache()
    if rank == 0:  # one device on the same weights, and the fp32 oracle
        one = RecServer(model, data, **kw)
        one.refresh()
        for B, users in batches.items():
            ids, vals = one.query(users)
            if not np.array_equal(served[B][0], ids):
                fail(f"mesh serve B={B}: ids differ from the single-device server")
            if not np.allclose(served[B][1], vals, rtol=1e-6, atol=0.0):
                fail(f"mesh serve B={B}: values differ from the single-device server")
        want = oracle_topk(torch, model, batches[64], *history, K_TOP)
        check_served(np, "mesh serve B=64 (2 ranks) vs the fp32 oracle", *served[64], *want)
        del one
    del model
    torch.cuda.empty_cache()

    import pickle

    t0 = time.perf_counter()
    with open(MESH_DIR / "eval_data.pkl", "rb") as f:
        edata = pickle.load(f)
    host_s = time.perf_counter() - t0
    model = quantized_bprmf(torch, EVAL_U, EVAL_I, seed=10)
    ev = FactoredEvaluator(model, edata, k=EVAL_K, user_block=EVAL_BLOCK, counts_impl="kernel",
                           mesh=mesh)
    torch.cuda.synchronize()
    K2.counts_kernel.launches = 0  # the sharded evaluation starts here
    t0 = time.perf_counter()
    metrics = ev.evaluate(None, None)
    evaluate_s = time.perf_counter() - t0
    k2 = K2.counts_kernel.launches  # ... and ends here
    want_launches = 2 * -(-EVAL_U // EVAL_BLOCK)
    if k2 != want_launches:
        fail(f"mesh eval rank {rank}: {k2} K2 launches, expected {want_launches}")
    # the first user block's per-user metrics, sharded and whole
    uf, iv, ib = ev._factors(None)
    ids = torch.arange(EVAL_BLOCK, device="cuda")
    blk = ev._eval_block("test", uf[ids], iv, ib, ids, ev._shard(iv, ib))
    out["eval"] = dict(metrics=metrics, evaluate_s=evaluate_s, host_s=host_s,
                       k2_launches=k2, bucket_widths=ev._bucket_w)
    if rank == 0:  # against the evaluation phase's metrics
        one = FactoredEvaluator(model, edata, k=EVAL_K, user_block=EVAL_BLOCK,
                                counts_impl="kernel")
        want = json.loads((MESH_DIR / "eval_ref.json").read_text())
        if json.loads(json.dumps(metrics)) != want:
            fail(f"mesh eval: metrics {metrics} differ from one device's {want}")
        whole = one._eval_block("test", uf[ids], iv, ib, ids)
        if not all(torch.equal(a, b) for a, b in zip(blk, whole)):
            fail("mesh eval: the first block's per-user metrics differ from one device")
        print(f"mesh eval: metrics equal to one device's {metrics}")
    return out


def mesh_train_rank(torch, np, rank):
    """BPRMF at 1M x 500k, batch 8192, over a (2, 2) mesh: MESH_STEPS
    generic steps, packed steps (fp32 and bf16 moments) and the steps of
    BPRMF's specialized engines (the sparse one through K6, the packed one
    with 1-D tau through K4 and K5), each rank's launches counted; rank 0
    also runs them on one device from the same state and triples and
    checks."""
    from fashionvisualexpl_tpu_torch.core.mesh import make_mesh
    from fashionvisualexpl_tpu_torch.core.train_state import (
        apply_gradients,
        create_train_state,
        tf_parity_adam,
    )
    from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF
    from fashionvisualexpl_tpu_torch.ops import gather as G
    from fashionvisualexpl_tpu_torch.ops import row_scatter as S
    from fashionvisualexpl_tpu_torch.parallel import fast_spmd, spmd
    from fashionvisualexpl_tpu_torch.train import packed_generic as PG

    mesh = make_mesh(2, 2)
    g = torch.Generator(device="cuda").manual_seed(12)
    triples = [torch.randint(n, (MESH_STEPS, TRAIN_B), device="cuda", generator=g)
               for n in (TRAIN_U, TRAIN_I, TRAIN_I)]

    def model_():
        return BPRMF(TRAIN_U, TRAIN_I, embed_k=EMBED_K,
                     generator=torch.Generator(device="cuda").manual_seed(7))

    checker = mesh.axis_index("data") == 0  # data row 0 gathers for rank 0's checks

    def whole(model, tensors, rows):
        return {k: spmd.unshard_rows(v, mesh, rows[k]) for k, v in tensors.items()}

    out = {}
    # generic: collective lookup, data-summed grads, local Adam
    model = model_()
    rows = {k: v.shape[0] for k, v in model.named_parameters()}
    sp, _ = spmd.shard_params(model, dict(model.named_parameters()), {}, mesh)
    spmd.load_tensors(model, sp)
    tx = tf_parity_adam(TRAIN_LR)
    state = create_train_state(dict(model.named_parameters()), tx)
    step = spmd.make_spmd_train_step(model, mesh, tx, TRAIN_REG)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(MESH_STEPS):
        state, loss = step(state, None, *(t[s] for t in triples))
        losses.append(float(loss))
    out["generic"] = dict(losses=losses, ms_per_step=1e3 * (time.perf_counter() - t0)
                          / MESH_STEPS)
    sharded = checker and types.SimpleNamespace(
        params=whole(model, state.params, rows),
        opt_state=types.SimpleNamespace(mu=whole(model, state.opt_state.mu, rows),
                                        nu=whole(model, state.opt_state.nu, rows)))
    del model, state, sp
    if rank == 0:
        ref = model_()
        rstate = create_train_state(dict(ref.named_parameters()), tx)
        for s in range(MESH_STEPS):
            u, p, n = (t[s] for t in triples)
            with torch.enable_grad():
                loss = ref.loss(u, p, n, TRAIN_REG)
                grads = torch.autograd.grad(loss, list(rstate.params.values()))
            rstate = apply_gradients(rstate, dict(zip(rstate.params, grads)), tx)
            if not abs(float(loss) - losses[s]) <= 1e-5 * abs(float(loss)):
                fail(f"mesh train generic step {s}: loss {losses[s]!r} vs one device "
                     f"{float(loss)!r}")
        err, amplified = route_check(torch, "mesh train generic (2, 2) vs one device",
                                     sharded, rstate, MESH_STEPS, 2 * TRAIN_LR * MESH_STEPS)
        out["generic"].update(max_abs_err=err, amplified=amplified)
        del ref, rstate
    del sharded
    torch.cuda.empty_cache()

    # packed: K4 row reads and K5 row writes on every rank
    for md, catchup in (("float32", False), ("bfloat16", True)):
        model = model_()
        packed = PG.pack_generic_state(model, dict(model.named_parameters()), moment_dtype=md)
        st = fast_spmd.shard_generic_packed_state(packed, mesh)
        step = fast_spmd.make_generic_packed_spmd_step(model, mesh, TRAIN_LR, TRAIN_REG,
                                                       moment_dtype=md, lazy_catchup=catchup)
        losses = []
        G.gather_rows.launches = S.scatter_rows_set.launches = 0  # sharded steps start
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(MESH_STEPS):
            st, loss = step(st, ({}, tuple(t[s] for t in triples), None))
            losses.append(float(loss))
        ms = 1e3 * (time.perf_counter() - t0) / MESH_STEPS
        k4, k5 = G.gather_rows.launches, S.scatter_rows_set.launches  # ... and end
        if k4 != 4 * MESH_STEPS or k5 != 2 * MESH_STEPS:
            fail(f"mesh train packed {md} rank {rank}: {k4} K4 and {k5} K5 launches, "
                 f"expected {4 * MESH_STEPS} and {2 * MESH_STEPS}")
        out[md] = dict(losses=losses, ms_per_step=ms, k4_launches=k4, k5_launches=k5,
                       shard_rows=[st.user_pmv.shape[0], st.item_pmv.shape[0]])
        got = checker and fast_spmd.unshard_generic_packed_state(st, mesh, TRAIN_U, TRAIN_I)
        del st
        if rank == 0:
            one = PG.make_generic_packed_step(model, TRAIN_LR, TRAIN_REG, moment_dtype=md,
                                              lazy_catchup=catchup)
            for s in range(MESH_STEPS):
                packed, loss = one(packed, ({}, tuple(t[s] for t in triples), None))
                if not abs(float(loss) - losses[s]) <= 1e-5 * abs(float(loss)):
                    fail(f"mesh train packed {md} step {s}: loss {losses[s]!r} vs one "
                         f"device {float(loss)!r}")
            err, beyond = packed_route_check(torch, PG, f"mesh train packed {md} (2, 2)",
                                             got, packed, model.packed_spec(), md,
                                             MESH_STEPS, TRAIN_LR)
            out[md].update(max_abs_err=err, beyond=beyond)
        del model, packed, got
        torch.cuda.empty_cache()

    # BPRMF's specialized engines: the sparse step (K6 sweeps) and the
    # packed step with 1-D tau (K4 reads, K5 writes)
    from fashionvisualexpl_tpu_torch.ops import adam as A
    from fashionvisualexpl_tpu_torch.train import fast as FT
    from fashionvisualexpl_tpu_torch.train import packed as P

    engines = {
        "fast": (FT.init_fast_state, fast_spmd.shard_fast_state, fast_spmd.unshard_fast_state,
                 fast_spmd.make_fast_spmd_step,
                 lambda m: FT.make_fast_bprmf_step(m, TRAIN_LR, TRAIN_REG, fused_adam=True)),
        "specialized": (P.pack_bprmf_state, fast_spmd.shard_packed_state,
                        fast_spmd.unshard_packed_state, fast_spmd.make_packed_spmd_step,
                        lambda m: P.make_packed_step(m, TRAIN_LR, TRAIN_REG))}
    for engine, (init, shard, unshard, make_step, make_one) in engines.items():
        model = model_()
        whole = init({k: v.detach() for k, v in model.named_parameters()})
        st = shard(whole, mesh)
        step = make_step(model, mesh, TRAIN_LR, TRAIN_REG)
        losses = []
        A.fused_adam_sweep.launches = 0
        G.gather_rows.launches = S.scatter_rows_set.launches = 0  # sharded steps start
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(MESH_STEPS):
            st, loss = step(st, tuple(t[s] for t in triples))
            losses.append(float(loss))
        ms = 1e3 * (time.perf_counter() - t0) / MESH_STEPS
        counted = dict(k4_launches=G.gather_rows.launches,
                       k5_launches=S.scatter_rows_set.launches,
                       k6_launches=A.fused_adam_sweep.launches)  # ... and end
        want = (dict(k4_launches=0, k5_launches=0, k6_launches=3 * MESH_STEPS)
                if engine == "fast" else
                dict(k4_launches=4 * MESH_STEPS, k5_launches=2 * MESH_STEPS, k6_launches=0))
        if counted != want:
            fail(f"mesh train {engine} rank {rank}: launches {counted}, expected {want}")
        out[engine] = dict(losses=losses, ms_per_step=ms, **counted)
        got = checker and unshard(st, mesh)
        del st
        if rank == 0:
            one = make_one(model)
            for s in range(MESH_STEPS):
                whole, loss = one(whole, tuple(t[s] for t in triples))
                if not abs(float(loss) - losses[s]) <= 1e-5 * abs(float(loss)):
                    fail(f"mesh train {engine} step {s}: loss {losses[s]!r} vs one device "
                         f"{float(loss)!r}")
            label = f"mesh train {engine} (2, 2) vs one device"
            if engine == "fast":
                err, n = route_check(torch, label, *(types.SimpleNamespace(
                    params=x.params, opt_state=types.SimpleNamespace(mu=x.mu, nu=x.nu))
                    for x in (got, whole)), MESH_STEPS, 2 * TRAIN_LR * MESH_STEPS)
            else:
                err, n = packed_route_check(torch, PG, label, as_generic(torch, PG, got),
                                            as_generic(torch, PG, whole), model.packed_spec(),
                                            "float32", MESH_STEPS, TRAIN_LR)
            out[engine].update(max_abs_err=err, beyond=n)
        del model, whole, got
        torch.cuda.empty_cache()
    print(f"mesh train rank {rank}: {out}")
    return out


def mesh_nccl_rank(torch, np, rank):
    """One rank on nccl: the sharded server's query over MESH_NCCL_N users
    and items at K=128, its all-gather through a one-rank nccl
    communicator, against one device."""
    from fashionvisualexpl_tpu_torch.core.mesh import make_mesh
    from fashionvisualexpl_tpu_torch.ops import segmax as K3
    from fashionvisualexpl_tpu_torch.serve import RecServer

    mesh = make_mesh(1, 1)
    if mesh.backend != "nccl":
        fail(f"mesh nccl: the group's backend is {mesh.backend}")
    model, data, history, batches = mesh_serve_setup(torch, np, MESH_NCCL_N)
    kw = dict(k=K_TOP, seg=SEG, oversample=OVERSAMPLE, item_block=ITEM_BLOCK, history=history)
    srv = RecServer(model, data, mesh=mesh, **kw)
    srv.refresh()
    K3.segmax_scores.launches = 0
    got = {B: srv.query(batches[B]) for B in (8, 64)}
    launches = K3.segmax_scores.launches
    del srv
    one = RecServer(model, data, **kw)
    one.refresh()
    for B, (ids, vals) in got.items():
        want = one.query(batches[B])
        if not (np.array_equal(ids, want[0]) and np.array_equal(vals, want[1])):
            fail(f"mesh nccl B={B}: the nccl mesh's answer differs from one device")
    return {"k3_launches": launches, "backend": mesh.backend}


def mesh_cli(np):
    """``torchrun --nproc_per_node=4 ... train_rec --mesh_data 2 --mesh_model
    2`` on cli_phase's dataset, against cli_phase's single-device run: the
    file set, the metrics, and serve_rec on one device from the primary's
    checkpoint."""
    import glob
    import pickle
    import re

    from fashionvisualexpl_tpu_torch.cli.serve_rec import serve

    from fashionvisualexpl_tpu_torch.cli.train_rec import train

    write_reference_dataset(np, MESH_DIR / "cli")
    results = MESH_DIR / "mesh_results"
    common = ["--rec", "bprmf", "--dataset", "cli", "--data_root", str(MESH_DIR),
              "--embed_k", str(EMBED_K), "--top_k", str(CLI_K)]
    flags = ["--streaming_eval", "--epochs", "2", "--verbose", "1",
             "--batch_size", str(MESH_CLI_B)]
    t0 = time.perf_counter()
    train(common + flags + ["--results_root", str(MESH_DIR / "results")])
    one_s = time.perf_counter() - t0
    env = dict(os.environ, OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=4",
         "-m", "fashionvisualexpl_tpu_torch.cli.train_rec", *common, *flags,
         "--results_root", str(results), "--mesh_data", "2", "--mesh_model", "2"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=MESH_TIMEOUT_S["cli"])
    train_s = time.perf_counter() - t0
    (MESH_DIR / "cli.log").write_text(run.stdout + run.stderr)
    if run.returncode:
        print(run.stdout[-3000:] + run.stderr[-3000:])
        fail(f"mesh cli: torchrun exited {run.returncode}")

    def files(base):
        out = {}
        for path in glob.glob(str(base / "**" / "*"), recursive=True):
            rel = os.path.relpath(path, base)
            if os.path.isfile(path) and "rec_model_weights" not in rel:
                out[re.sub(r"best-recs-\d+-", "best-recs-E-", rel)] = path
        for path in glob.glob(str(base / "rec_model_weights" / "*" / "*" / "*" / "*")):
            out[os.path.relpath(path, base)] = path
        return out

    mesh_files, one_files = files(results), files(MESH_DIR / "results")
    if sorted(mesh_files) != sorted(one_files):
        fail(f"mesh cli: files {sorted(mesh_files)} != one device's {sorted(one_files)}")
    (got,) = [p for n, p in mesh_files.items() if n.endswith(".pkl")]
    (want,) = [p for n, p in one_files.items() if n.endswith(".pkl")]
    got, want = (pickle.load(open(p, "rb")) for p in (got, want))
    if sorted(got) != sorted(want) != [1, 2]:
        fail(f"mesh cli: metric epochs {sorted(got)} vs {sorted(want)}")
    for e in want:
        for k, v in want[e].items():
            if not abs(got[e][k] - v) <= 2e-4 + 2e-3 * abs(v):  # tests/test_golden.py's
                fail(f"mesh cli epoch {e} {k}: {got[e][k]!r} vs one device {v!r}")
    (ckpt,) = glob.glob(str(results / "rec_model_weights" / "cli" / "bprmf" / "ckpt-*"))
    (best,) = glob.glob(str(results / "rec_results" / "cli" / "bprmf" / "best-recs-*"))
    users = [u * (CLI_U // CLI_SERVE_USERS) for u in range(CLI_SERVE_USERS)]
    served = MESH_DIR / "served.tsv"
    serve(common + ["--results_root", str(results), "--ckpt", ckpt, "--users",
                    ",".join(map(str, users)), "--output", str(served)])
    dumped = {}
    with open(best) as f:
        for line in f:
            u, i, _ = line.split("\t")
            dumped.setdefault(int(u), []).append(int(i))
    rows = [line.split("\t") for line in served.read_text().strip().split("\n")]
    for u in users:
        if [int(r[1]) for r in rows if int(r[0]) == u] != dumped[u]:
            fail(f"mesh cli: serve_rec on one device from the mesh checkpoint differs from "
                 f"the best dump for user {u}")
    print(f"mesh cli: torchrun 4 ranks {train_s!r} s (one device {one_s!r} s); the "
          f"single-device file set; metrics {got[2]}; serve_rec from its checkpoint on one "
          f"device equals the best dump")
    return dict(train_s=train_s, one_device_s=one_s, metrics=got[2])


def mesh_phase(torch, np, eval_metrics):
    """The multi-device phase: every rank on the one card (gloo; the ranks
    share it, so no time here is a multi-card figure).  ``eval_metrics``:
    the evaluation phase's, which the sharded evaluation must equal."""
    import shutil

    (MESH_DIR / "eval_ref.json").write_text(json.dumps(eval_metrics))
    phase_start(torch)  # the card's memory to the ranks
    t0 = time.perf_counter()
    serve_eval = mesh_spawn("serve_eval", 2)
    train = mesh_spawn("train", 4)
    cli = mesh_cli(np)
    nccl = mesh_spawn("nccl", 1, backend="nccl")
    out = {
        "layout": "ranks sharing one H100 over gloo (nccl: one rank)",
        "serve_2_ranks": {r: o["serve"] for r, o in enumerate(serve_eval)},
        "eval_2_ranks": serve_eval[0]["eval"],
        "train_4_ranks": {md: {k: v for k, v in train[0][md].items()}
                          for md in ("generic", "float32", "bfloat16", "fast", "specialized")},
        "cli_4_ranks": cli,
        "staged_bytes": {job: [o["staged_bytes"] for o in outs] for job, outs in
                         (("serve_eval", serve_eval), ("train", train), ("nccl", nccl))},
        "phase_s": time.perf_counter() - t0,
    }
    launches = {
        "segmax_scores": [o["k3_launches"] for o in serve_eval],
        "segmax_scores_nccl": nccl[0]["k3_launches"],
        "counts": [o["eval"]["k2_launches"] for o in serve_eval],
        "gather_rows": {md: [o[md]["k4_launches"] for o in train]
                        for md in ("float32", "bfloat16", "specialized")},
        "scatter_rows_set": {md: [o[md]["k5_launches"] for o in train]
                             for md in ("float32", "bfloat16", "specialized")},
        "adam_sweep": [o["fast"]["k6_launches"] for o in train],
    }
    if not all(launches["segmax_scores"]) or not all(launches["counts"]):
        fail(f"mesh: a rank launched no K3 or K2: {launches}")
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    print(f"mesh phase: {out['phase_s']!r} s")
    return launches, out


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
    ptxas = {}
    for name, log in cuda_build.build_logs.items():
        built = cuda_build.build_seconds.get(name)
        print(f"  nvcc {name}: " + (f"{built!r} s" if built is not None else "built before"))
        ptxas[name] = cuda_build.ptxas_report(log)
        for row in ptxas[name]:
            print(f"  nvcc {name}: {row}")
        for line in log.splitlines():
            if "warning" in line:
                print(f"  nvcc {name}: {line.strip()}")

    native = native_phase(np)
    rows = kernel_phase(torch, segmax)
    rows["build_s"] = cuda_build.build_seconds.get("segmax")
    rows["ptxas"] = ptxas["segmax"]
    serve, launches = serve_phase(torch, np, segmax)
    train_rows = train_kernel_phase(torch, bpr, adam)
    train_launches, train = train_phase(torch, np, bpr, adam)
    fitted = fit_phase(torch, np, bpr, adam)
    eval_items = make_eval_items(np, EVAL_U, EVAL_I, EVAL_TRAIN + 2, seed=0)
    counts_row = eval_kernel_phase(torch, np, counts, topk, eval_items)
    eval_data, host_s = eval_interactions(np, eval_items)
    att_items = eval_items[:ATT_U].copy()
    del eval_items
    mesh_eval_data(eval_data)
    eval_launches, evaluated = eval_phase(torch, np, counts, eval_data, host_s)
    att_launches, att = attention_dump_phase(torch, np, segmax, att_items)
    vbpr_launches, vbpr = vbpr_phase(torch, np, counts, segmax, G, S, eval_data)
    del eval_data
    vis_cli_launches, vis_cli = visual_cli_phase(torch, np, counts, segmax, G, S)
    cli_launches, cli = cli_phase(torch, np, counts, segmax)
    tower_rows = tower_kernel_phase(torch, E)
    af_launches, af_train = af_train_phase(torch, np, E)
    af_cli_launches, af_cli = af_path_phase(torch, np, E)
    streamed_launches, streamed = streamed_phase(torch, np, E)
    streamed_cli_launches, streamed_cli = streamed_cli_phase(torch, np, E)
    row_rows = row_kernel_phase(torch, G, S)
    packed_launches, packed = packed_train_phase(torch, np, G, S)
    spec_launches, specialized = specialized_phase(torch, np, G, S)
    af_packed_launches, af_packed = af_packed_phase(torch, np, G, S, E)
    packed_cli_launches, packed_cli = packed_cli_phase(torch, np, counts, segmax, G, S)
    acf_cli_launches, acf, acf_rows = acf_phase(torch, np, counts, segmax, G, S)
    comp_cli_launches, comp = comp_vbpr_phase(torch, np, counts, segmax, topk, G, S)
    bf16_launches, bf16 = bf16_phase(torch, np, E, G, S, tower_rows, dict(
        af_train=af_train, af_packed=af_packed, streamed=streamed, comp=comp))
    vision_launches, vision = vision_phase(torch, np, counts, segmax)
    mesh_launches, mesh = mesh_phase(torch, np, evaluated["metrics"])

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
        "d148": rows["d148"],
        "vbpr_launches": vbpr_launches["segmax_scores"],
        "vbpr_routes": vbpr_launches["segmax_routes"],
        "visual_cli_launches": {k: v["segmax_scores"] for k, v in vis_cli_launches.items()},
        "visual_cli_routes": {k: v["segmax_routes"] for k, v in vis_cli_launches.items()},
        "acf_launches": acf["serve"]["launches"],
        "acf_routes": acf["serve"]["routes"],
        "acf_cli_launches": {k: v["segmax_scores"] for k, v in acf_cli_launches.items()},
        "d208": comp["kernels"]["segmax_scores"],
        "comp_vbpr_launches": comp["serve"]["launches"],
        "comp_vbpr_routes": comp["serve"]["routes"],
        "comp_vbpr_cli_launches": {k: v["segmax_scores"] for k, v in comp_cli_launches.items()},
        "mesh_launches_by_rank": mesh_launches["segmax_scores"],
        "mesh_nccl_launches": mesh_launches["segmax_scores_nccl"],
        "attention_dump_launches": att_launches,
        "vision_cli_launches": vision_launches["segmax_scores"],
        "build_s": rows["build_s"],
        "ptxas": rows["ptxas"],
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
    kernels[-1]["mesh_fast_launches_by_rank"] = mesh_launches["adam_sweep"]
    kernels.append({
        "name": "counts", "route": "cuda",
        "source": "fashionvisualexpl_tpu_torch/ops/csrc/counts.cu",
        "replaces": "fashionvisualexpl_tpu/ops/counts.py:31",
        "launches": eval_launches, **counts_row,
        "cli_launches": cli_launches["counts"],
        "vbpr_launches": vbpr_launches["counts"],
        "visual_cli_launches": {k: v["counts"] for k, v in vis_cli_launches.items()},
        "acf_launches": acf["launches"],
        "d208": comp["kernels"]["counts"],
        "comp_vbpr_launches": comp["launches"],
        "comp_vbpr_cli_launches": {k: v["counts"] for k, v in comp_cli_launches.items()},
        "mesh_launches_by_rank": mesh_launches["counts"],
        "vision_cli_launches": vision_launches["counts"],
    })
    for name, line in (("edge_tower_fwd", 114), ("edge_tower_bwd", 127)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fashionvisualexpl_tpu_torch/ops/csrc/edge_tower.cu",
            "replaces": f"fashionvisualexpl_tpu/ops/edge_tower.py:{line}",
            "launches": af_launches[name], **tower_rows[name],
            "cli_launches": af_cli_launches[name],
            "streamed_launches": streamed_launches[name],
            "streamed_cli_launches": streamed_cli_launches[name],
        })
    for name, line in (("edge_tower_fwd", 114), ("edge_tower_bwd", 127)):
        kernels.append({
            "name": f"{name}_bf16", "route": "cuda",
            "source": "fashionvisualexpl_tpu_torch/ops/csrc/edge_tower.cu",
            "replaces": f"fashionvisualexpl_tpu/ops/edge_tower.py:{line}",
            "launches": bf16_launches[f"{name}_bf16"], **bf16["kernels"][name],
            "packed_launches": bf16_launches["packed"][f"{name}_bf16"],
            "streamed_launches": bf16_launches["streamed"][f"{name}_bf16"],
            "cli_launches": bf16_launches["cli"]["attentive_fashion"][f"{name}_bf16"],
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
            "fused": {label: r[name] for label, r in row_rows["fused"].items()},
            "vbpr_launches": vbpr_launches[name],
            "visual_cli_launches": {k: v[name] for k, v in vis_cli_launches.items()},
            "acf_launches": acf["packed"]["launches"][name],
            "acf_fused_launches": acf["fused"]["launches"][name],
            "acf_cli_launches": {k: v[name] for k, v in acf_cli_launches.items()},
            "acf_grid": acf_rows[name],
            "comp_vbpr_launches": comp["packed"]["launches"][name],
            "comp_vbpr_grid": comp["kernels"][name],
            "comp_vbpr_cli_launches": {k: v[name] for k, v in comp_cli_launches.items()},
            "mesh_launches_by_rank": mesh_launches[name],
            "specialized_launches": {k: v[name] for k, v in spec_launches.items()},
        })
    for kernel, kind, tag in ((kernels[-2], "gather", "k4"), (kernels[-1], "scatter", "k5")):
        kernel.update(
            routes=packed[f"{kind}_routes"], af_routes=af_packed[f"{kind}_routes"],
            cli_routes=packed_cli[f"{kind}_routes"],
            vbpr_routes=vbpr["packed"][f"{kind}_routes"],
            visual_cli_routes={k: v[f"{kind}_routes"] for k, v in vis_cli_launches.items()},
            acf_routes=acf["packed"][f"{kind}_routes"],
            acf_fused_routes=acf["fused"][f"{kind}_routes"],
            comp_vbpr_routes=comp["packed"][f"{kind}_routes"],
            specialized_routes={k: specialized[k][f"{kind}_routes"]
                                for k in ("bprmf", "vbpr", "grad_fashion")},
            step_share={k: p["profile"][f"{tag}_share"] for k, p in (
                ("packed", packed), ("af_packed", af_packed), ("vbpr_packed", vbpr["packed"]),
                ("acf_packed", acf["packed"]), ("acf_fused", acf["fused"]),
                ("comp_vbpr_packed", comp["packed"]))})
        if not all(kernel["step_share"].values()):
            fail(f"{kernel['name']}: no share of a packed step's device time "
                 f"{kernel['step_share']}: the profile's kernel names are out of date")
    print(json.dumps({"serve": {str(b): r for b, r in serve.items()}}))
    print(json.dumps({"train": train, "fit": fitted}))
    print(json.dumps({"eval": evaluated, "cli": cli}))
    print(json.dumps({"af_train": af_train, "af_cli": af_cli}))
    print(json.dumps({"native": native, "streamed": streamed, "streamed_cli": streamed_cli}))
    print(json.dumps({"packed": packed, "af_packed": af_packed, "packed_cli": packed_cli}))
    print(json.dumps({"specialized": specialized, "attention_dump": att}))
    print(json.dumps({"vbpr": vbpr, "visual_cli": vis_cli}))
    print(json.dumps({"acf": acf}))
    print(json.dumps({"comp_vbpr": comp}))
    print(json.dumps({"bf16": bf16}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"vision": vision}))
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(sys.argv[2:]))
    sys.exit(main())
