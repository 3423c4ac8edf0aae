"""Training CLI (port of ``fashionvisualexpl_tpu/cli/train_rec.py``) — the
reference's train_rec.py surface (src/train_rec.py:17-93).

Same flags with the same names and defaults, plus ``--device`` (default the
CUDA card, which the run needs unless ``--device cpu`` is given); the same
regularization-sweep outer loop re-creating data and model per reg value
(train_rec.py:60-89); the same results and weights layout and file names:
``log-<tag>.jsonl``, ``recs-<E>-<tag>.tsv``, ``best-recs-<best>-<tag>.tsv``,
``results-metrics-<tag>.pkl`` and the checkpoint directory ``ckpt-<tag>``.
The checkpoints are the port's own (``core/checkpoint.py``), not Orbax.

Registered here: ``bprmf``; ``vbpr`` (the CNN features of ``--cnn_model``
/ ``--output_layer``); ``grad_fashion`` (color histograms and the edge
features; after the plain dumps the gradient-attribution dumps
``grads-<E>-<tag>.tsv`` and ``best-grads-<best>-<tag>.tsv``); and
``attentive_fashion`` (color histograms, class one-hots and the edge tiffs
at ``--edge_hw``; the edge tower K7 on the card; after the plain dumps the
attention dumps ``att-recs-<E>-<tag>.tsv`` and
``best-att-recs-<best>-<tag>.tsv``).  A model without ``factored_eval`` is
evaluated by the dense ``Evaluator`` even with ``--streaming_eval``, as in
the JAX package.  ``--train_path packed`` trains every one of them on the
packed LazyAdam engine (``--moment_dtype``, ``--row_align``,
``--lazy_catchup`` and, for vbpr, grad_fashion and acf, ``--fused_frozen``
honoured); ``acf`` (the per-item spatial CNN maps under
``cnn_features_split_dir``, ``--max_user_pos``, ``--acf_exact_eval``,
``--acf_exact_train`` on the generic path, ``--compute_dtype``; factored at
D = embed_k); and ``comp_vbpr`` (the families of ``--activated_components``
mixed by ``--weight_components``: the CNN features of ``--cnn_model`` /
``--output_layer``, the color histograms, the edge tiffs at ``--edge_hw``
through the trainable CNN, the texture features of ``--cnn_model``;
factored at D = embed_k + embed_d per active family).  ``--streamed``
(attentive_fashion only) keeps the modality inputs on the host: the edge
tiffs become one ``edges_stack.npy`` beside them (built by
``build_edge_stack_npy`` when missing), read as a memmap, and
``fit_streamed`` (``train/streamed.py``) streams each batch's rows to the
card; evaluation and the dumps encode the catalog in host blocks.
``--compute_dtype bfloat16`` for attentive_fashion and comp_vbpr raises
``NotImplementedError`` naming its ROADMAP item by heading.

``--mesh_data D --mesh_model M`` trains over a (data, model) mesh of D * M
ranks launched by ``torchrun`` (``parallel/multihost.py``; nccl when each
rank has a card of its own, gloo when they share one): the tables
row-sharded over ``model``, the batch over ``data`` (``Trainer``'s mesh
paths).  The evaluator is built without a mesh, as in the JAX package: the
primary evaluates the gathered tables.  Only the primary (rank 0) writes
the logs, checkpoints (single-device layout: ``serve_rec`` restores them
on one device), metrics and dumps, so the file set is the single-device
run's.

Usage:
  python -m fashionvisualexpl_tpu_torch.cli.train_rec --rec bprmf \
      --dataset amazon_baby --epochs 200 --streaming_eval
  torchrun --nproc_per_node=4 -m fashionvisualexpl_tpu_torch.cli.train_rec \
      --rec bprmf --streaming_eval --mesh_data 2 --mesh_model 2
"""

from __future__ import annotations

import argparse
import os

def _bool_flag(s: str) -> bool:
    """Strict 0/1/true/false parser — a typo like 'no' or 'off' must be a
    loud argparse error, not a silent True."""
    low = s.lower()
    if low in ("1", "true"):
        return True
    if low in ("0", "false"):
        return False
    raise argparse.ArgumentTypeError(f"expected 0/1/true/false, got {s!r}")


def build_parser(description="Run train of the Recommender Model."):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--best_metric", type=str, default="ndcg")
    p.add_argument("--dataset", nargs="?", default="amazon_baby")
    p.add_argument("--rec", nargs="?", default="attentive_fashion")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--top_k", type=int, default=20)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--verbose", type=int, default=-1,
                   help="checkpoint every N epochs (-1 disables)")
    p.add_argument("--batch_eval", type=int, default=128,
                   help="eval-time item-image encoding batch for "
                        "attentive_fashion (the reference consumes it at "
                        "AttentiveFashion.py:338-343)")
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--validation", type=lambda s: s not in ("0", "False", "false"),
                   default=True)
    p.add_argument("--restore_epochs", type=int, default=1)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint (works, unlike "
                        "the reference's --restore_epochs)")
    p.add_argument("--list_of_regs", nargs="+", type=float, default=[0.0])
    p.add_argument("--layers_component", nargs="+", type=int, default=[64, 1])
    p.add_argument("--layers_item", nargs="+", type=int, default=[64, 1])
    p.add_argument("--attention_layers", nargs="+", type=int, default=[64, 1])
    p.add_argument("--cnn_model", nargs="?", default="vgg19")
    p.add_argument("--edge_hw", nargs=2, type=int, default=[224, 224],
                   help="edge-image size fed to the trainable towers "
                        "(attentive_fashion / comp_vbpr); the reference "
                        "hardcodes 224x224 (dataset.py:199)")
    p.add_argument("--output_layer", nargs="?", default="fc2")
    p.add_argument("--embed_k", type=int, default=128)
    p.add_argument("--embed_d", type=int, default=20)
    p.add_argument("--embed_color", type=int, default=32)
    p.add_argument("--embed_edges", type=int, default=32)
    p.add_argument("--reg", type=float, default=0.0)
    p.add_argument("--activated_components", nargs="+", type=int,
                   default=[1, 1, 1, 1],
                   help="comp_vbpr family toggles: semantic color edges "
                        "texture (reference CompVBPR.py:33)")
    p.add_argument("--weight_components", nargs="+", type=float,
                   default=[0.25, 0.25, 0.25, 0.25],
                   help="comp_vbpr family mix weights (CompVBPR.py:34)")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--results_root", type=str, default="results")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_user_block", type=int, default=2048)
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="compute dtype for the trainable encoder towers "
                        "(attentive_fashion / comp_vbpr: only float32 "
                        "runs so far, in full f32 on the card; bfloat16: "
                        "ROADMAP: bf16 encoder towers) and acf's attention "
                        "einsums (both run)")
    p.add_argument("--edge_tower", choices=["auto", "fused", "xla", "s2d"],
                   default="auto",
                   help="attentive_fashion conv->pool->GAP tower impl: "
                        "fused = the CUDA edge-tower kernel "
                        "(ops/edge_tower.py), xla = the plain PyTorch "
                        "tower, s2d = the same function on a "
                        "space-to-depth layout (ops/s2d_conv.py, plain "
                        "PyTorch), auto = the kernel on the card for even "
                        "image sizes")
    p.add_argument("--streaming_eval", action="store_true",
                   help="use the blocked streaming evaluator (factored models)")
    p.add_argument("--streamed", action="store_true",
                   help="attentive_fashion only: keep the modality inputs "
                        "on the host (the edge stack as a memmap) and "
                        "stream each batch's rows to the card through a "
                        "prefetch thread, the native row gather and pinned "
                        "buffers (train/streamed.py) — for catalogs whose "
                        "edge stack outgrows the card.  Builds or reads "
                        "the single-file edges_stack.npy next to the edge "
                        "tiffs")
    p.add_argument("--fused_frozen", type=_bool_flag, default=True,
                   help="packed path: fold frozen per-item feature columns "
                        "into the packed item rows (halves row gathers per "
                        "step; costs one extra HBM copy of those tables — "
                        "pass 0 when the feature matrix doesn't fit twice)")
    p.add_argument("--train_path", choices=["generic", "packed"],
                   default="generic",
                   help="packed = packed-state rows + LazyAdam "
                        "(train/packed_generic.py): BPRMF and "
                        "attentive_fashion on one device, and vbpr, "
                        "grad_fashion and acf with their frozen features in the "
                        "item rows (--fused_frozen; acf's positive sets as "
                        "extra item rows), comp_vbpr with its CNN as a dense "
                        "group; the same engine runs sharded on a mesh "
                        "(--mesh_data / --mesh_model).  Not faster on the port so far: on an NVIDIA "
                        "H100 80GB HBM3 at 700 W a packed attentive_fashion "
                        "step took 27.1 ms against 14.8 ms generic "
                        "(PERF.md)")
    p.add_argument("--moment_dtype",
                   choices=["float32", "bfloat16", "float8"],
                   default="float32",
                   help="packed path: Adam moment storage.  bfloat16 packs "
                        "m,v as two bf16 halves of one fp32 column — rows "
                        "shrink 3W+1 -> 2W+1 (1/3 less scatter traffic, "
                        "~8-bit moment mantissas).  float8 packs m and "
                        "sqrt(v) as four e5m2 codes per column — rows "
                        "shrink to ~1.5W+1 (~2-bit moment mantissas).  "
                        "bfloat16 also on a mesh; float8 on one device only")
    p.add_argument("--row_align", type=int, default=1,
                   help="packed path capacity mode: pad packed-row widths "
                        "to this multiple (the JAX package's capacity "
                        "mode; on the port it only adds dead columns, "
                        "which the step carries untouched; 1 = off)")
    p.add_argument("--lazy_catchup", type=_bool_flag, default=True,
                   help="packed path: apply the closed-form momentum tail "
                        "of skipped steps on touch (dense-Adam-like "
                        "convergence at touched-rows-only cost; "
                        "throughput-free).  Pass 0 for plain LazyAdam")
    p.add_argument("--bootstrap", action="store_true",
                   help="with-replacement triple sampling (original-BPR "
                        "bootstrap) instead of the epoch permutation")
    p.add_argument("--sampling", choices=["user_perm", "pair_perm"],
                   default="user_perm",
                   help="no-replacement epoch ordering: user_perm = the "
                        "reference's exact scheme (shuffle users, visit "
                        "positives in stored order); pair_perm = permute "
                        "the full interaction list")
    p.add_argument("--max_user_pos", type=int, default=64,
                   help="acf: training-time cap on per-user positives "
                        "(subsampled beyond it; the reference attends over "
                        "all, ACF.py:169-179)")
    p.add_argument("--acf_exact_eval", action="store_true",
                   help="acf: attend over EVERY positive at evaluation "
                        "(chunked online-softmax scan; reference-exact "
                        "eval profiles regardless of --max_user_pos)")
    p.add_argument("--acf_exact_train", action="store_true",
                   help="acf: attend over EVERY positive during TRAINING "
                        "too (reference ACF.py:169-179,201-207 semantics; "
                        "gradients through the chunked scan).  Generic "
                        "train path only")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="data-parallel mesh axis size")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="table-row-sharding mesh axis size")
    p.add_argument("--device", type=str, default=None,
                   help="where the run computes: default the CUDA card "
                        "(raises without one); 'cpu' runs the plain PyTorch "
                        "versions of the kernels (tests)")
    return p


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def validate_args(args):
    """Reject invalid flag COMBINATIONS before any data loads.

    Without this, e.g. `--acf_exact_train --train_path packed` survives
    argument parsing, loads the dataset, and only then dies inside
    ACF.packed_spec() (round-3 verdict: validate combos up front)."""
    errors = []
    if args.rec == "acf" and args.acf_exact_train and args.train_path == "packed":
        errors.append(
            "--acf_exact_train requires --train_path generic: the packed "
            "engine's extra-item-rows path is built on the per-user "
            "positive cap that exact training removes"
        )
    if args.streamed:
        if args.rec != "attentive_fashion":
            errors.append(
                "--streamed supports attentive_fashion only (the one model "
                "whose modality stack can exceed HBM)"
            )
        if args.train_path != "generic":
            errors.append(
                "--streamed uses its own host-prefetch train loop "
                "(train/streamed.py); --train_path packed cannot be honored"
            )
        if args.mesh_data * args.mesh_model > 1:
            errors.append(
                "--streamed is single-device (the host prefetcher feeds one "
                "chip); drop --mesh_data/--mesh_model"
            )
    if args.moment_dtype == "float8" and args.mesh_data * args.mesh_model > 1:
        errors.append(
            "--moment_dtype float8 is single-device only (the sharded "
            "packed engine's column groups assume a uniform per-column "
            "moment width) — use bfloat16 over the mesh"
        )
    if args.rec == "comp_vbpr":
        if len(args.activated_components) != 4:
            errors.append(
                "--activated_components takes exactly 4 toggles "
                "(semantic color edges texture, reference CompVBPR.py:33)"
            )
        if len(args.weight_components) != 4:
            errors.append(
                "--weight_components takes exactly 4 weights "
                "(reference CompVBPR.py:34)"
            )
    if args.rec == "acf":
        if args.layers_component and args.layers_component[-1] != 1:
            errors.append("last --layers_component width must be 1")
        if args.layers_item and args.layers_item[-1] != 1:
            errors.append("last --layers_item width must be 1")
    if errors:
        raise SystemExit("invalid flags:\n  - " + "\n  - ".join(errors))


def check_ported(args) -> None:
    """Raise NotImplementedError for the options of later slices, before any
    data loads."""
    if args.rec in ("attentive_fashion", "comp_vbpr") and args.compute_dtype == "bfloat16":
        raise NotImplementedError(
            "--compute_dtype bfloat16 (bf16 towers and a bf16 edge-tower "
            "kernel) is not ported yet (ROADMAP: bf16 encoder towers)"
        )


def open_edge_stack(paths, ds: str, num_items: int, hw):
    """The read-only memmap of ``paths.edges_stack(ds)``, written from the
    edge tiffs first when it is missing; a stack of another shape
    raises."""
    import numpy as np

    from fashionvisualexpl_tpu_torch.data.pipeline import build_edge_stack_npy

    stack = paths.edges_stack(ds)
    if not os.path.exists(stack):
        build_edge_stack_npy(paths.edges_dir(ds), stack, num_items, hw=hw)
    edges = np.load(stack, mmap_mode="r")
    if edges.shape != (num_items, *hw, 1) or edges.dtype != np.float32:
        raise ValueError(f"{stack} holds {edges.dtype}{edges.shape}, expected float32"
                         f"{(num_items, *hw, 1)}: remove it to rebuild it at --edge_hw")
    return edges


def build_model(args, data, cfg):
    """Model registry (reference train_rec.py:75-86): ``bprmf``, ``vbpr``,
    ``grad_fashion``, ``attentive_fashion``, ``comp_vbpr`` and ``acf`` on
    ``args.device``."""
    from fashionvisualexpl_tpu_torch.data import features as F

    paths, ds = cfg.paths, args.dataset
    if args.rec == "bprmf":
        from fashionvisualexpl_tpu_torch.models.bprmf import BPRMF

        return BPRMF(data.num_users, data.num_items, embed_k=args.embed_k,
                     device=args.device)
    if args.rec == "vbpr":
        from fashionvisualexpl_tpu_torch.models.vbpr import VBPR

        feats = F.load_cnn_features(paths, ds, args.cnn_model, args.output_layer)
        return VBPR(data.num_users, data.num_items, feats, embed_k=args.embed_k,
                    embed_d=args.embed_d, device=args.device)
    if args.rec == "grad_fashion":
        from fashionvisualexpl_tpu_torch.models.grad_fashion import GradFashion

        return GradFashion(
            data.num_users, data.num_items, F.load_color_histograms(paths, ds),
            F.load_edge_features(paths, ds, args.cnn_model, args.output_layer),
            embed_k=args.embed_k, embed_d=args.embed_d, embed_color=args.embed_color,
            embed_edges=args.embed_edges, device=args.device,
        )
    if args.rec == "attentive_fashion":
        from fashionvisualexpl_tpu_torch.models.attentive_fashion import (
            AttentiveFashion,
        )

        hw = tuple(args.edge_hw)
        if args.streamed:
            edges = open_edge_stack(paths, ds, data.num_items, hw)
        else:
            from fashionvisualexpl_tpu_torch.data.pipeline import load_edge_image_stack

            edges = load_edge_image_stack(paths.edges_dir(ds), data.num_items, hw=hw)
        return AttentiveFashion(
            data.num_users, data.num_items, F.load_color_histograms(paths, ds),
            edges, F.load_class_onehot(paths, ds), embed_k=args.embed_k,
            attention_layers=tuple(args.attention_layers),
            compute_dtype=args.compute_dtype, host_features=args.streamed,
            # --batch_eval: eval-time item-image encoding batch (the
            # reference consumes it at AttentiveFashion.py:338-343)
            batch_eval=args.batch_eval, edge_tower=args.edge_tower,
            device=args.device,
        )
    if args.rec == "comp_vbpr":
        from fashionvisualexpl_tpu_torch.data.pipeline import load_edge_image_stack
        from fashionvisualexpl_tpu_torch.models.comp_vbpr import CompVBPR

        act = tuple(bool(a) for a in args.activated_components)
        sem = (F.load_cnn_features(paths, ds, args.cnn_model, args.output_layer)
               if act[0] else None)
        color = F.load_color_histograms(paths, ds) if act[1] else None
        edges = (load_edge_image_stack(paths.edges_dir(ds), data.num_items,
                                       hw=tuple(args.edge_hw)) if act[2] else None)
        tex = F.load_texture_features(paths, ds, args.cnn_model) if act[3] else None
        return CompVBPR(
            data.num_users, data.num_items, sem, color, edges, tex, embed_k=args.embed_k,
            embed_d=args.embed_d, activated_components=act,
            weight_components=tuple(args.weight_components),
            compute_dtype=args.compute_dtype, device=args.device,
        )
    if args.rec == "acf":
        from fashionvisualexpl_tpu_torch.data.pipeline import load_spatial_feature_stack
        from fashionvisualexpl_tpu_torch.models.acf import ACF

        spat = load_spatial_feature_stack(
            paths.cnn_features_split_dir(ds, args.cnn_model, args.output_layer),
            data.num_items,
        )
        return ACF(
            data.num_users, data.num_items, spat, data, embed_k=args.embed_k,
            layers_component=tuple(args.layers_component),
            layers_item=tuple(args.layers_item), max_user_pos=args.max_user_pos,
            exact_eval=args.acf_exact_eval, exact_train=args.acf_exact_train,
            compute_dtype=args.compute_dtype, device=args.device,
        )
    raise NotImplementedError("Not implemented or unknown Recommender Model.")


def init_mesh_ranks(args) -> bool:
    """Join the torchrun process group when a mesh is asked for (True when
    this call formed it); refuse a mesh that is not the world size."""
    if args.mesh_data * args.mesh_model <= 1:
        return False
    import torch.distributed as dist

    from fashionvisualexpl_tpu_torch.parallel.multihost import initialize_from_env

    formed = not dist.is_initialized() and initialize_from_env()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != args.mesh_data * args.mesh_model:
        raise SystemExit(
            f"--mesh_data {args.mesh_data} x --mesh_model {args.mesh_model} needs "
            f"{args.mesh_data * args.mesh_model} ranks, the process group has {world}: "
            f"launch with torchrun --nproc_per_node={args.mesh_data * args.mesh_model}")
    return formed


def train(argv=None):
    args = parse_args(argv)
    validate_args(args)
    check_ported(args)
    formed = init_mesh_ranks(args)
    try:
        _train(args)
    finally:
        if formed:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args):

    from fashionvisualexpl_tpu_torch.core.config import (
        MeshConfig,
        Paths,
        TrainConfig,
    )
    from fashionvisualexpl_tpu_torch.data.interactions import Interactions
    from fashionvisualexpl_tpu_torch.eval.evaluator import Evaluator
    from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator
    from fashionvisualexpl_tpu_torch.parallel.multihost import is_primary
    from fashionvisualexpl_tpu_torch.train.trainer import fit
    from fashionvisualexpl_tpu_torch.utils.io import JsonlLogger, ensure_dir, save_obj

    primary = is_primary()  # over a mesh rank 0 alone writes files and prints
    paths = Paths(root=args.data_root, results_root=args.results_root)
    results_dir = ensure_dir(paths.results_dir(args.dataset, args.rec))
    weight_dir = ensure_dir(paths.weight_dir(args.dataset, args.rec))

    for it, current_reg in enumerate(args.list_of_regs):
        print("-" * 68)
        print(
            "ITERATION %d/%d WITH REGULARIZATION: %f"
            % (it + 1, len(args.list_of_regs), current_reg)
        )
        cfg = TrainConfig(
            dataset=args.dataset, rec=args.rec, batch_size=args.batch_size,
            top_k=args.top_k, epochs=args.epochs, verbose=args.verbose,
            batch_eval=args.batch_eval, lr=args.lr,
            validation=args.validation, reg=current_reg,
            best_metric=args.best_metric, seed=args.seed, paths=paths,
            mesh=MeshConfig(data=args.mesh_data, model=args.mesh_model),
            train_path=args.train_path, bootstrap=args.bootstrap,
            sampling=args.sampling, fused_frozen=args.fused_frozen,
            moment_dtype=args.moment_dtype, lazy_catchup=args.lazy_catchup,
            row_align=args.row_align,
        )
        data = Interactions.load(cfg)

        print(f"Training {args.rec} on {args.dataset}")
        if primary:
            print("Parameters:")
            for k, v in sorted(vars(args).items()):
                print(f"\t- {k} = {v}")
            print()

        model = build_model(args, data, cfg)
        if args.streaming_eval and hasattr(model, "factored_eval"):
            # the streaming evaluator also writes the recommendation dumps:
            # the dense Evaluator would allocate the [U, I] train mask the
            # streaming path exists to avoid
            evaluator = FactoredEvaluator(
                model, data, k=cfg.top_k, user_block=args.eval_user_block
            )
        else:
            evaluator = Evaluator(
                model, data, k=cfg.top_k, user_block=args.eval_user_block
            )

        run_tag = (
            f"batch_{cfg.batch_size}-K_{args.embed_k}-lr_{cfg.lr}-reg_{cfg.reg}"
        )
        logger = (JsonlLogger(os.path.join(results_dir, f"log-{run_tag}.jsonl"))
                  if primary else None)
        run_kw = dict(evaluator=evaluator, log=logger.log if primary else None,
                      ckpt_dir=os.path.join(weight_dir, f"ckpt-{run_tag}"),
                      resume=args.resume)
        if args.streamed:
            # rec, train_path and mesh already checked by validate_args
            from fashionvisualexpl_tpu_torch.train.streamed import (
                ArrayFeatureStore,
                fit_streamed,
            )

            store = ArrayFeatureStore(model._color, model._edges, model._class)
            state, frozen, results, extra = fit_streamed(model, data, cfg, store, **run_kw)
        else:
            state, frozen, results, extra = fit(model, data, cfg, **run_kw)
        if not primary:  # the mesh's model and state are whole on every rank
            continue
        logger.close()

        # dumps in the reference layout (BPRMF.py:167-184); the best params
        # are a copy, scored without writing them into the model
        last_epoch = cfg.epochs
        evaluator.store_recommendation(
            state.params, frozen,
            os.path.join(results_dir, f"recs-{last_epoch}-{run_tag}.tsv"),
        )
        save_obj(results, os.path.join(results_dir, f"results-metrics-{run_tag}"))
        best_epoch = extra["best_epoch"]
        print(f"Store Best Model at Epoch {best_epoch}")
        evaluator.store_recommendation(
            extra["best_params"], frozen,
            os.path.join(results_dir, f"best-recs-{best_epoch}-{run_tag}.tsv"),
        )
        if args.rec == "grad_fashion":
            # the reference dumps grads for both the last epoch
            # (GradFashion.py:236-240) and the best model (:255-258); here
            # each dump has its own name, as in the JAX package
            def grads_fn(p, f, users, items):
                return model.feature_attributions_block(users, items, params=p)

            for params, name in (
                (state.params, f"grads-{last_epoch}-{run_tag}.tsv"),
                (extra["best_params"], f"best-grads-{best_epoch}-{run_tag}.tsv"),
            ):
                evaluator.store_recommendation_grads(
                    params, frozen, os.path.join(results_dir, name),
                    batch_grads_fn=grads_fn,
                )
        if args.rec == "attentive_fashion":
            # the reference dumps attention-augmented recs for both the final
            # epoch (AttentiveFashion.py:308) and the best model (:320); here
            # each dump has its own name, as in the JAX package
            def attention_fn(p, f, ids, ctx):
                return model.attention_weights(ids, ctx, params=p)

            for params, name in (
                (state.params, f"att-recs-{last_epoch}-{run_tag}.tsv"),
                (extra["best_params"], f"best-att-recs-{best_epoch}-{run_tag}.tsv"),
            ):
                evaluator.store_recommendation_attention(
                    params, frozen, os.path.join(results_dir, name),
                    attention_fn=attention_fn,
                )
        print("END REGULARIZATION")
        print("-" * 68)


if __name__ == "__main__":
    train()
