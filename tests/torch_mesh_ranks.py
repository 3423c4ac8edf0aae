"""The rank side of the port's sharded-path tests (``tests/test_torch_*``
files that hold ``parallel/``, ``core/mesh.py`` and the ``mesh`` paths
against the JAX package).

A test process writes each scenario's inputs to ``WORKDIR/<name>.in.npz``
(and ``<name>.json``) and calls ``spawn_many``: one fresh interpreter per rank
runs this file, forms a gloo group over ``file://WORKDIR/rdv`` (no TCP
port, so the tests are safe under pytest-xdist), builds the (data, model)
mesh, runs every scenario of the manifest in order and writes
``WORKDIR/<name>.r<rank>.npz``.  The scenarios are the functions of
``tests/torch_mesh_scenarios.py`` (a scenario's ``fn`` in its json, else
its name).  The ranks import no JAX.  ``spawn_many`` kills
every rank when its timeout runs out.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn_many(jobs, timeout: float = 240.0, init: str = "direct"):
    """Run the scenarios of several meshes, all ranks started together:
    ``jobs`` maps a (data, model) mesh shape to (workdir, scenario names);
    returns a mesh shape -> {name: [outputs by rank]} mapping.
    ``init="env"`` forms each group through
    ``parallel/multihost.py::initialize_from_env`` (a one-rank mesh then
    forms none)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = []  # (shape, rank, process, log)
    for (d, m), (workdir, names) in jobs.items():
        os.makedirs(workdir, exist_ok=True)
        with open(os.path.join(workdir, "manifest.json"), "w") as f:
            json.dump({"mesh": [d, m], "scenarios": list(names), "init": init}, f)
        rdv = os.path.join(workdir, "rdv")
        if os.path.exists(rdv):
            os.remove(rdv)
        for r in range(d * m):
            log = os.path.join(workdir, f"rank{r}.log")
            with open(log, "w") as out:
                procs.append(((d, m), r, subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), str(r), str(d * m), workdir],
                    env=env, stdout=out, stderr=subprocess.STDOUT), log))
    deadline = time.time() + timeout
    try:
        for _, _, p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for _, _, p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for _, _, p, _ in procs):
        raise RuntimeError("a rank failed or timed out:\n" + "\n".join(
            f"--- mesh {shape} rank {r} (rc {p.returncode}) ---\n{open(log).read()[-4000:]}"
            for shape, r, p, log in procs if p.returncode))
    return {shape: {name: [dict(np.load(os.path.join(wd, f"{name}.r{r}.npz"),
                                        allow_pickle=False))
                           for r in range(shape[0] * shape[1])] for name in names}
            for shape, (wd, names) in jobs.items()}


def write_inputs(workdir: str, name: str, cfg=None, **arrays) -> None:
    os.makedirs(workdir, exist_ok=True)
    np.savez(os.path.join(workdir, f"{name}.in.npz"), **arrays)
    with open(os.path.join(workdir, f"{name}.json"), "w") as f:
        json.dump(cfg or {}, f)


# --- the rank side ---------------------------------------------------------


def _np(t):
    import torch

    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _main(rank: int, world: int, workdir: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, _REPO)
    import torch_mesh_scenarios as scenarios
    from fashionvisualexpl_tpu_torch.core.mesh import make_mesh

    with open(os.path.join(workdir, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["init"] == "env":
        from fashionvisualexpl_tpu_torch.parallel.multihost import initialize_from_env

        formed = initialize_from_env(f"file://{workdir}/rdv", world, rank, backend="gloo",
                                     timeout_s=60)
        assert formed == (world > 1)
    else:
        dist.init_process_group("gloo", init_method=f"file://{workdir}/rdv", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=60))
    d, m = manifest["mesh"]
    mesh = make_mesh(d, m, device="cpu")
    for name in manifest["scenarios"]:
        inp = dict(np.load(os.path.join(workdir, f"{name}.in.npz"), allow_pickle=False))
        with open(os.path.join(workdir, f"{name}.json")) as f:
            cfg = json.load(f)
        try:
            out = getattr(scenarios, cfg.get("fn", name))(mesh, inp, cfg, workdir)
        except Exception:
            traceback.print_exc()
            sys.stdout.flush()
            os._exit(1)
        np.savez(os.path.join(workdir, f"{name}.r{rank}.npz"),
                 **{k: _np(v) for k, v in out.items()})
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
