"""Scenarios the ranks of ``tests/torch_mesh_ranks.py`` run: each takes
(mesh, inputs, json config, workdir) and returns the arrays its test
compares.  Params arrive flattened (``p.<name>``, dotted names for nested
groups), the model's frozen inputs as ``f.<name>``; whole tables leave the
ranks gathered (``unshard_rows``), so every rank reports the same arrays.
Imports no JAX."""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from fashionvisualexpl_tpu_torch.core.config import MeshConfig, TrainConfig
from fashionvisualexpl_tpu_torch.core.mesh import MODEL_AXIS
from fashionvisualexpl_tpu_torch.core.train_state import create_train_state, tf_parity_adam
from fashionvisualexpl_tpu_torch.data.interactions import synthetic_interactions
from fashionvisualexpl_tpu_torch.parallel import fast_spmd, spmd


def _t(x):
    return torch.from_numpy(np.array(x))


def _group(inp, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in inp.items() if k.startswith(prefix)}


def _data(cfg):
    d = cfg["data"]
    if d.get("uniform"):  # sorted lists of one length: derived pairs apply
        from fashionvisualexpl_tpu_torch.data.interactions import Interactions

        rng = np.random.default_rng(d["seed"])
        training = [sorted(rng.choice(d["I"], size=d["ipu"], replace=False).tolist())
                    for _ in range(d["U"])]
        test = [[int(rng.integers(d["I"]))] for _ in range(d["U"])]
        return Interactions.from_lists(training, test, d["I"])
    return synthetic_interactions(d["U"], d["I"], interactions_per_user=d["ipu"],
                                  seed=d["seed"])


def build_model(cfg, inp):
    """The port model of ``cfg["model"]`` over the JAX params and inputs."""
    from fashionvisualexpl_tpu_torch.models import convert

    kind, params, f = cfg["model"], _group(inp, "p."), _group(inp, "f.")
    kw = cfg.get("model_kw", {})
    if kind == "bprmf":
        return convert.bprmf_from_jax(params, device="cpu")
    if kind == "vbpr":
        return convert.vbpr_from_jax(params, f["F"], device="cpu")
    if kind == "grad_fashion":
        return convert.grad_fashion_from_jax(params, f["Fc"], f["Fe"], device="cpu")
    if kind == "acf":
        return convert.acf_from_jax(params, f["Fspat"], _data(cfg), device="cpu", **kw)
    if kind == "attentive_fashion":
        jm = SimpleNamespace(host_features=False, **kw)
        return convert.attentive_fashion_from_jax(jm, params, f, device="cpu")
    if kind == "comp_vbpr":
        return convert.comp_vbpr_from_jax(params, f.get("Fs"), f.get("Fc"), f.get("Fe_img"),
                                          f.get("Ft"), device="cpu", **kw)
    raise ValueError(kind)


def _whole(model, tensors, rows, mesh):
    sharded = set(model.row_sharded_params())
    return {k: spmd.unshard_rows(v, mesh, rows[k]) if k in sharded else v
            for k, v in tensors.items()}


# --- parallel/spmd.py ------------------------------------------------------


def take(mesh, inp, cfg, wd):
    """collective_take forward and backward on a 2-D and a 4-D table."""
    out = {}
    for tag in ("2d", "4d"):
        table = _t(inp[f"table{tag}"])
        shard = spmd.row_shard(table, mesh).requires_grad_()
        got = spmd.collective_take(("T",), mesh)("T", shard, _t(inp[f"ids{tag}"]))
        (g,) = torch.autograd.grad((got * _t(inp[f"w{tag}"])).sum(), shard)
        out[f"fwd{tag}"] = got
        out[f"grad{tag}"] = spmd.unshard_rows(g, mesh, table.shape[0])
    return out


def model_steps(mesh, inp, cfg, wd):
    """``make_spmd_train_step`` over the given global batches."""
    model = build_model(cfg, inp)
    params, frozen = dict(model.named_parameters()), dict(model.named_buffers())
    rows = {k: v.shape[0] for k, v in {**params, **frozen}.items()}
    sp, sf = spmd.shard_params(model, params, frozen, mesh)
    spmd.load_tensors(model, {**sp, **sf})
    tx = tf_parity_adam(cfg["lr"])
    state = create_train_state(dict(model.named_parameters()), tx)
    step = spmd.make_spmd_train_step(model, mesh, tx, cfg["reg"])
    losses = []
    for u, p, n in zip(inp["users"], inp["pos"], inp["neg"]):
        state, loss = step(state, None, _t(u), _t(p), _t(n))
        losses.append(float(loss))
    out = {"losses": np.array(losses)}
    out.update({f"p.{k}": v for k, v in _whole(model, state.params, rows, mesh).items()})
    return out


def _trainer(mesh, inp, cfg, extra_cfg=()):
    from fashionvisualexpl_tpu_torch.train.trainer import Trainer

    model = build_model(cfg, inp)
    if "cnn_dropout" in cfg:
        model.cnn.dropout_rate = cfg["cnn_dropout"]
    tcfg = TrainConfig(mesh=MeshConfig(*mesh.shape.values()), **cfg["train"],
                       **dict(extra_cfg))
    return Trainer(model, _data(cfg), tcfg)


def trainer_steps(mesh, inp, cfg, wd):
    """``Trainer`` over the mesh (generic or packed) fed the JAX sampler's
    triples of each epoch (``t<e>.users`` ...)."""
    trainer = _trainer(mesh, inp, cfg)
    state, frozen = trainer.init_state()
    losses = []
    for e in range(cfg["epochs"]):
        triples = tuple(_t(inp[f"t{e}.{k}"]) for k in ("users", "pos", "neg"))
        state, loss = trainer.run_steps(state, frozen, triples, step_key=e)
        losses.append(float(loss))
    out = {"losses": np.array(losses)}
    out.update({f"p.{k}": v for k, v in trainer.gather_params(state).items()})
    if trainer._packed_step is not None:
        whole = trainer.gather_state(state).inner
        out.update(user_pmv=whole.user_pmv, item_pmv=whole.item_pmv)
        out["shard_rows"] = np.array([state.inner.user_pmv.shape[0],
                                      state.inner.item_pmv.shape[0]])
    return out


def fit_run(mesh, inp, cfg, wd):
    """``fit`` over the mesh with a checkpoint directory and an evaluator
    without a mesh (the CLI's), then a resumed run of more epochs."""
    from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator
    from fashionvisualexpl_tpu_torch.train.trainer import fit

    out = {}
    ckpt = os.path.join(wd, cfg["ckpt"])
    for tag, epochs, resume in (("a", cfg["epochs"], False),
                                ("b", cfg["epochs"] + 1, True)):
        model = build_model(cfg, inp)
        data = _data(cfg)
        tcfg = TrainConfig(mesh=MeshConfig(*mesh.shape.values()), epochs=epochs,
                           **cfg["train"])
        ev = FactoredEvaluator(model, data, k=tcfg.top_k, user_block=16)
        state, frozen, results, extra = fit(model, data, tcfg, evaluator=ev, seed=cfg["seed"],
                                            ckpt_dir=ckpt, resume=resume)
        out[f"{tag}.losses"] = np.array([h.loss for h in extra["history"]])
        out[f"{tag}.best_epoch"] = np.array(extra["best_epoch"])
        out[f"{tag}.metrics"] = np.array([[results[e][k] for k in sorted(results[e])]
                                          for e in sorted(results)])
        for k, v in state.params.items():
            out[f"{tag}.p.{k}"] = v
        for k, v in extra["best_params"].items():
            out[f"{tag}.best.{k}"] = v
        # the model ends whole, in the single-device layout
        out[f"{tag}.model_rows"] = np.array([t.shape[0] for t in model.parameters()])
    return out


# --- parallel/fast_spmd.py -------------------------------------------------


def packed_refusals(mesh, inp, cfg, wd):
    """float8 moments refused over a mesh; a batch that does not split
    over ``data`` refused."""
    model = build_model(cfg, inp)
    out = {}
    try:
        fast_spmd.make_generic_packed_spmd_step(model, mesh, 0.01, 0.0, moment_dtype="float8")
        out["float8"] = np.array(0)
    except ValueError as e:
        out["float8"] = np.array("single-device only" in str(e))
    try:
        fast_spmd.make_generic_packed_spmd_epoch_fn(
            model, mesh, 0.01, 0.0, 8, 1, mesh.shape["data"] * 4 + 1)
        out["batch"] = np.array(mesh.shape["data"] == 1)
    except ValueError as e:
        out["batch"] = np.array("not divisible by data axis" in str(e))
    return out


def packed_epochs(mesh, inp, cfg, wd):
    """``make_generic_packed_spmd_epoch_fn`` from ``shard_generic_packed_state``
    over a few epochs, with the sampler's own draws (``derived`` drops the
    pair list); returns the whole rows and the losses."""
    from fashionvisualexpl_tpu_torch.train.packed_generic import pack_generic_state

    model = build_model(cfg, inp)
    data = _data(cfg)
    whole = pack_generic_state(model, dict(model.named_parameters()),
                               moment_dtype=cfg["moment_dtype"])
    state = fast_spmd.shard_generic_packed_state(whole, mesh)
    frozen = dict(model.named_buffers())
    epoch = fast_spmd.make_generic_packed_spmd_epoch_fn(
        model, mesh, 0.01, 0.01, data.num_items, data.steps_per_epoch(cfg["batch"]),
        cfg["batch"], moment_dtype=cfg["moment_dtype"])
    if cfg.get("derived"):
        from fashionvisualexpl_tpu_torch.data.sampler import derived_pairs_ok

        assert derived_pairs_ok(data.train_pairs, data.padded_pos)
    pairs = None if cfg.get("derived") else torch.as_tensor(data.train_pairs)
    losses = []
    for e in range(cfg["epochs"]):
        state, loss = epoch(state, frozen, 100 + e, pairs, torch.as_tensor(data.padded_pos),
                            torch.as_tensor(data.pos_counts))
        losses.append(float(loss))
    whole = fast_spmd.unshard_generic_packed_state(state, mesh, data.num_users,
                                                   data.num_items)
    return {"losses": np.array(losses), "user_pmv": whole.user_pmv,
            "item_pmv": whole.item_pmv}


# --- eval/factored.py and serve/engine.py ----------------------------------


def _item_shard(mesh, iv, ib):
    """This rank's rows of the catalog padded to the model-axis multiple,
    the pad rows with -inf bias."""
    m = mesh.shape[MODEL_AXIS]
    rows = -(-iv.shape[0] // m)
    pad = rows * m - iv.shape[0]
    ivp = torch.nn.functional.pad(iv, (0, 0, 0, pad))
    ibp = torch.nn.functional.pad(ib, (0, pad), value=float("-inf"))
    lo = mesh.axis_index(MODEL_AXIS) * rows
    return ivp[lo:lo + rows].contiguous(), ibp[lo:lo + rows].contiguous()


def sharded_counts(mesh, inp, cfg, wd):
    """``sharded_streaming_counts`` (each engine) on the 1/64-grid inputs
    and ``sharded_streaming_topk_and_counts`` on the Gaussian ones (``g_``),
    on this rank's rows of the padded catalog."""
    from fashionvisualexpl_tpu_torch.eval import factored

    ref, banned = _t(inp["ref"]), _t(inp["banned"])
    ivl, ibl = _item_shard(mesh, _t(inp["iv"]), _t(inp["ib"]))
    out = {}
    for impl in ("mask", "bucketed", "kernel"):
        out[impl] = factored.sharded_streaming_counts(
            mesh, _t(inp["uf"]), ivl, ibl, ref, banned, cfg["block"], impl=impl,
            bucket_width=cfg["width"])
    ivg, ibg = _item_shard(mesh, _t(inp["g_iv"]), _t(inp["g_ib"]))
    v, i, c = factored.sharded_streaming_topk_and_counts(
        mesh, _t(inp["g_uf"]), ivg, ibg, cfg["k"], ref, banned, cfg["block"])
    out.update(topk_vals=v, topk_ids=i, topk_counts=c)
    return out


def sharded_evaluate(mesh, inp, cfg, wd):
    """``FactoredEvaluator(mesh=...)`` for each engine: the metrics and the
    top-k rows of the dumps."""
    from fashionvisualexpl_tpu_torch.eval.factored import FactoredEvaluator

    model = build_model(cfg, inp)
    data = _data(cfg)
    out = {}
    for impl in ("mask", "bucketed", "kernel"):
        ev = FactoredEvaluator(model, data, k=cfg["k"], user_block=cfg["user_block"],
                               mesh=mesh, counts_impl=impl)
        rec = ev.evaluate(None, None)
        out[f"{impl}.keys"] = np.array(sorted(rec))
        out[f"{impl}.vals"] = np.array([rec[k] for k in sorted(rec)])
    _, ids, vals = ev._topk_rows(None, None)
    out.update(dump_ids=ids, dump_vals=vals)
    return out


def sharded_serve(mesh, inp, cfg, wd):
    """``RecServer(mesh=...)`` answering the given batches."""
    from fashionvisualexpl_tpu_torch.serve import RecServer

    model = build_model(cfg, inp)
    data = _data(cfg)
    srv = RecServer(model, data, device="cpu", mesh=mesh, **cfg.get("server", {}))
    srv.refresh()
    out = {}
    for j, users in enumerate(cfg["batches"]):
        ids, vals = srv.query(np.array(users))
        out[f"ids{j}"], out[f"vals{j}"] = ids, vals
    return out


# --- parallel/multihost.py and the CLI --------------------------------------


def vbpr_epoch(mesh, inp, cfg, wd):
    """One sharded VBPR epoch (``make_spmd_epoch_fn``) from the given
    params: the loss."""
    model = build_model(cfg, inp)
    data = _data(cfg)
    params, frozen = dict(model.named_parameters()), dict(model.named_buffers())
    sp, sf = spmd.shard_params(model, params, frozen, mesh)
    spmd.load_tensors(model, {**sp, **sf})
    tx = tf_parity_adam(0.001)
    state = create_train_state(dict(model.named_parameters()), tx)
    epoch = spmd.make_spmd_epoch_fn(model, mesh, tx, 0.01, data.num_items, 2, 16)
    state, loss = epoch(state, None, 0, torch.as_tensor(data.train_pairs),
                        torch.as_tensor(data.padded_pos), torch.as_tensor(data.pos_counts))
    return {"loss": np.array(float(loss))}


def cli_run(mesh, inp, cfg, wd):
    """``train_rec`` with ``--mesh_data / --mesh_model`` in this rank's
    (already formed) process group."""
    from fashionvisualexpl_tpu_torch.cli import train_rec

    train_rec.train(cfg["argv"])
    return {"done": np.array(1)}
