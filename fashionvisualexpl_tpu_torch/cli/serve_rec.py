"""Serving CLI (port of ``fashionvisualexpl_tpu/cli/serve_rec.py``): load the
best params of a ``train_rec`` checkpoint and answer top-k queries with the
port's ``RecServer``: BPRMF, VBPR, GradFashion, CompVBPR and ACF through
its three stages (stage 1 by the segmax kernel K3 on the card; VBPR and
GradFashion factored at D = embed_k + embed_d, CompVBPR at embed_k +
embed_d per active family, every item's edge image encoded once at
refresh, their frozen features loaded as ``train_rec`` loads them; ACF at
D = embed_k, every user's attentive profile computed at refresh), AttentiveFashion through the direct path
(the items encoded once at refresh, by the edge-tower kernel K7 on the
card).

Build the index once, then answer user queries: from a file of user ids,
for the whole user base, or interactively from stdin.  Takes every
``train_rec`` flag (``--device`` included) plus the ones below.

Usage:
  python -m fashionvisualexpl_tpu_torch.cli.serve_rec --rec bprmf \\
      --dataset amazon_baby \\
      --ckpt results/rec_model_weights/amazon_baby/bprmf/ckpt-batch_256-K_128-lr_0.001-reg_0.0 \\
      --users all --output recs.tsv [--quantized]
"""

from __future__ import annotations

import os
import sys
import time


def parse_args(argv=None):
    from fashionvisualexpl_tpu_torch.cli.train_rec import build_parser

    p = build_parser(description="Serve top-k recommendations from a checkpoint.")
    p.add_argument("--ckpt", type=str, required=True,
                   help="checkpoint directory written by train_rec "
                        "(restores its best-validation params)")
    p.add_argument("--users", type=str, default="all",
                   help="'all', a comma-separated id list, a file with one "
                        "user id per line, or '-' for interactive stdin")
    p.add_argument("--output", type=str, default="-",
                   help="output TSV path ('-' = stdout); rows are "
                        "user\\titem\\tscore, the store_recommendation format")
    p.add_argument("--quantized", action="store_true",
                   help="int8 candidate generation + exact fp32 rescoring")
    p.add_argument("--oversample", type=int, default=4)
    p.add_argument("--item_block", type=int, default=8192)
    p.add_argument("--query_batch", type=int, default=1024)
    return p.parse_args(argv)


def _user_ids(spec: str, num_users: int):
    import numpy as np

    if spec == "all":
        return np.arange(num_users, dtype=np.int32)
    if os.path.exists(spec):
        # a file path wins over inline-id parsing, so an id-file named
        # e.g. "123" stays readable
        with open(spec) as f:
            return np.asarray([int(line) for line in f if line.strip()], np.int32)
    if "," in spec or spec.isdigit():
        return np.asarray([int(x) for x in spec.split(",") if x], np.int32)
    raise FileNotFoundError(
        f"--users {spec!r}: not a file, not 'all', '-', "
        "a user id, or a comma-separated id list"
    )


def serve(argv=None):
    args = parse_args(argv)

    from fashionvisualexpl_tpu_torch.cli.train_rec import build_model
    from fashionvisualexpl_tpu_torch.core.checkpoint import CheckpointManager
    from fashionvisualexpl_tpu_torch.core.config import MeshConfig, Paths, TrainConfig
    from fashionvisualexpl_tpu_torch.data.interactions import Interactions
    from fashionvisualexpl_tpu_torch.serve import RecServer

    paths = Paths(root=args.data_root, results_root=args.results_root)
    cfg = TrainConfig(
        dataset=args.dataset, rec=args.rec, batch_size=args.batch_size,
        top_k=args.top_k, lr=args.lr, reg=args.reg, seed=args.seed,
        paths=paths, mesh=MeshConfig(data=1, model=1),
    )
    data = Interactions.load(cfg)
    model = build_model(args, data, cfg)
    # the best params, copied into the model's own parameters
    params = CheckpointManager(args.ckpt).restore_best(dict(model.named_parameters()))

    srv = RecServer(
        model, data, k=args.top_k, item_block=args.item_block,
        quantized=args.quantized, oversample=args.oversample,
        max_batch=args.query_batch, device=model.device,
    )
    t0 = time.time()
    srv.refresh(params)
    route = ("direct" if not hasattr(model, "factored_eval")
             else "int8+rescore" if args.quantized else "exact")
    print(f"index built in {time.time() - t0:.2f}s "
          f"({data.num_users} users x {data.num_items} items, {route} path)",
          file=sys.stderr)

    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        if args.users == "-":
            print("enter a user id per line (EOF to quit):", file=sys.stderr)
            for line in sys.stdin:
                line = line.strip()
                if not line:
                    continue
                u = int(line)
                t0 = time.time()
                recs = srv.query_user(u)
                dt = (time.time() - t0) * 1e3
                for item, score in recs:
                    out.write(f"{u}\t{item}\t{score}\n")
                out.flush()
                print(f"[{dt:.1f} ms]", file=sys.stderr)
            return

        user_ids = _user_ids(args.users, data.num_users)
        t0 = time.time()
        ids, vals = srv.query(user_ids)
        dt = time.time() - t0
        for row, u in enumerate(user_ids):
            for item, score in zip(ids[row], vals[row]):
                out.write(f"{u}\t{item}\t{score}\n")
        print(
            f"served {user_ids.size} queries in {dt:.3f}s "
            f"({user_ids.size / max(dt, 1e-9):.0f} QPS)",
            file=sys.stderr,
        )
    finally:
        if out is not sys.stdout:
            out.close()


if __name__ == "__main__":
    serve()
