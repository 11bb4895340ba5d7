"""Checkpoint / resume (SURVEY §5).

The reference checkpoints informally: hyperparameter vectors appended to
CSVs per replan (reference/PhysicalExperimentCode/
GraceExplorationExperiments_MFEGP.py:412-417), GPy model pickles, and
planner graph dumps ``graphNodes{n}.txt``/``graphEdges{n}.txt``
(reference/GraceRIGV3.py:877-906) with an unimplemented resume stub
(``cplan``, reference/GraceRIGV3.py:1364-1365).

Here checkpointing is explicit and complete: one ``ExplorationCheckpoint``
struct carrying (model hyps + data, RNG key, budget state, planner graph),
serialized with orbax when available and a plain-npz fallback otherwise.
The reference's graph text artifacts remain writable through
``planning.rig.RIGPlanner.node_loc_dict``/``edge_dict`` for
cross-comparison tooling.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class ModelCheckpoint:
    """Everything needed to resurrect a GP/MFGP/NIGP at fixed hyps —
    mirrors what the reference's plot scripts rebuild models from
    (reference/MFplottingData.py:17,58-60: hyp CSV + data pointer)."""

    kind: str  # "gp" | "mfgp" | "nigp"
    kernel: str
    param_array: np.ndarray
    X: np.ndarray
    y: np.ndarray
    fid: Optional[np.ndarray] = None  # mfgp only
    extra: dict = field(default_factory=dict)

    def restore(self, jitter: float = 1e-6):
        if self.kind == "gp":
            from mfgp_jax.models.gp import GP

            m = GP(self.X, self.y, kernel=self.kernel, jitter=jitter)
            m.set_param_array(self.param_array)
            return m
        if self.kind == "mfgp":
            from mfgp_jax.models.mfgp import MFGP

            m = MFGP(self.X, self.fid, self.y, kernel=self.kernel,
                     n_fidelities=int(self.extra.get("n_fidelities", 3)),
                     jitter=jitter)
            m.set_param_array(self.param_array)
            return m
        if self.kind == "nigp":
            from mfgp_jax.models.nigp import NIGP

            m = NIGP()
            D = self.X.shape[1]
            v = np.asarray(self.param_array)
            # artifact layout [sigma_x (D), sigma_f, sigma_y, ls (D)]
            # (reference/NIGP.py:188-189)
            m.sigma_x_ = v[:D]
            m.sigma_f_ = float(v[D])
            m.sigma_y_ = float(v[D + 1])
            m.lengthscales_ = v[D + 2 :]
            import jax.numpy as jnp

            m.X_train_ = jnp.asarray(self.X)
            m.y_train_ = jnp.asarray(self.y).reshape(-1)
            m.noise_diag_train_ = None
            return m
        raise ValueError(f"unknown model kind {self.kind!r}")


def capture_model(model) -> ModelCheckpoint:
    from mfgp_jax.models.gp import GP
    from mfgp_jax.models.mfgp import MFGP
    from mfgp_jax.models.nigp import NIGP

    if isinstance(model, MFGP):
        return ModelCheckpoint("mfgp", model.kernel,
                               np.asarray(model.param_array),
                               np.asarray(model.X), np.asarray(model.y),
                               fid=np.asarray(model.fid),
                               extra={"n_fidelities": model.n_fidelities})
    if isinstance(model, GP):
        return ModelCheckpoint("gp", model.kernel,
                               np.asarray(model.param_array),
                               np.asarray(model.X), np.asarray(model.y))
    if isinstance(model, NIGP):
        return ModelCheckpoint("nigp", "rbf", model.get_params(),
                               np.asarray(model.X_train_),
                               np.asarray(model.y_train_))
    raise TypeError(type(model))


@dataclass
class ExplorationCheckpoint:
    """Full closed-loop-run state (the reference never had this; resume was
    a stub). rng_key is the raw key data; planner graph is the JSON-able
    node/edge dict pair from RIGPlanner."""

    plan_num: int
    t_now: float
    planned_budget: float
    x0: np.ndarray
    model: ModelCheckpoint
    data_rows: np.ndarray  # accumulated GPData-schema rows
    rng_state: dict  # np.random.Generator bit generator state
    jax_key_data: np.ndarray
    graph_nodes: dict = field(default_factory=dict)
    graph_edges: dict = field(default_factory=dict)


def _to_npz_dict(ck: ExplorationCheckpoint) -> dict:
    flat = {
        "plan_num": np.asarray(ck.plan_num),
        "t_now": np.asarray(ck.t_now),
        "planned_budget": np.asarray(ck.planned_budget),
        "x0": np.asarray(ck.x0),
        "data_rows": np.asarray(ck.data_rows),
        "jax_key_data": np.asarray(ck.jax_key_data),
        "model_kind": np.asarray(ck.model.kind),
        "model_kernel": np.asarray(ck.model.kernel),
        "model_params": np.asarray(ck.model.param_array),
        "model_X": np.asarray(ck.model.X),
        "model_y": np.asarray(ck.model.y),
        "meta_json": np.asarray(json.dumps({
            "rng_state": _jsonify(ck.rng_state),
            "graph_nodes": ck.graph_nodes,
            "graph_edges": ck.graph_edges,
            "model_extra": ck.model.extra,
        })),
    }
    if ck.model.fid is not None:
        flat["model_fid"] = np.asarray(ck.model.fid)
    return flat


def _jsonify(o):
    if isinstance(o, dict):
        return {k: _jsonify(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_jsonify(v) for v in o]
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    return o


def save_checkpoint(path: str, ck: ExplorationCheckpoint,
                    backend: str = "npz"):
    """Write a checkpoint.

    ``backend="npz"``: single-file .npz (atomic rename) — the default,
    dependency-free. ``backend="orbax"``: an orbax PyTree checkpoint
    directory ``<path>.orbax`` (tensor data via orbax's async-capable
    TypeHandlers; the JSON-able meta rides alongside as ``meta.json``) —
    the production choice for large states on multi-host filesystems.
    """
    if backend == "orbax":
        flat = _to_npz_dict(ck)
        meta_json = str(flat.pop("meta_json"))
        strings = {"model_kind": str(flat.pop("model_kind")),
                   "model_kernel": str(flat.pop("model_kernel"))}
        import orbax.checkpoint as ocp

        target = os.path.abspath(path) + ".orbax"
        tree_dir = os.path.join(target, "tree")
        if os.path.exists(tree_dir):
            import shutil

            shutil.rmtree(tree_dir)
        os.makedirs(target, exist_ok=True)
        ocp.PyTreeCheckpointer().save(tree_dir, dict(flat))
        with open(os.path.join(target, "meta.json"), "w") as f:
            json.dump({"meta_json": meta_json, **strings}, f)
        return
    if backend != "npz":
        raise ValueError(backend)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_to_npz_dict(ck))
    os.replace(tmp, path if path.endswith(".npz") else path + ".npz")


def _from_flat(z, meta, kind: str, kernel: str) -> ExplorationCheckpoint:
    model = ModelCheckpoint(
        kind=kind, kernel=kernel,
        param_array=np.asarray(z["model_params"]), X=np.asarray(z["model_X"]),
        y=np.asarray(z["model_y"]),
        fid=np.asarray(z["model_fid"]) if "model_fid" in z else None,
        extra=meta.get("model_extra", {}),
    )
    return ExplorationCheckpoint(
        plan_num=int(z["plan_num"]), t_now=float(z["t_now"]),
        planned_budget=float(z["planned_budget"]), x0=np.asarray(z["x0"]),
        model=model, data_rows=np.asarray(z["data_rows"]),
        rng_state=meta["rng_state"],
        jax_key_data=np.asarray(z["jax_key_data"]),
        graph_nodes=meta.get("graph_nodes", {}),
        graph_edges=meta.get("graph_edges", {}),
    )


def load_checkpoint(path: str) -> ExplorationCheckpoint:
    """Load a checkpoint, autodetecting the backend (.orbax dir or .npz).

    When BOTH artifacts exist for the same path, the most recently written
    one wins (a later default-backend save must not be shadowed by an old
    orbax directory).
    """
    orbax_dir = (path if path.endswith(".orbax") else path + ".orbax")
    npz_path = path if path.endswith(".npz") else path + ".npz"
    if os.path.isdir(orbax_dir) and os.path.exists(npz_path):
        if os.path.getmtime(npz_path) > os.path.getmtime(orbax_dir):
            orbax_dir = ""  # npz is newer
    if orbax_dir and os.path.isdir(orbax_dir):
        import orbax.checkpoint as ocp

        z = ocp.PyTreeCheckpointer().restore(
            os.path.join(orbax_dir, "tree"))
        with open(os.path.join(orbax_dir, "meta.json")) as f:
            side = json.load(f)
        meta = json.loads(side["meta_json"])
        return _from_flat(z, meta, side["model_kind"], side["model_kernel"])
    if not path.endswith(".npz"):
        path = path + ".npz"
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta_json"]))
    return _from_flat(z, meta, str(z["model_kind"]), str(z["model_kernel"]))


def save_hyp_history(path: str, param_array, plan_num: int):
    """Append a hyp row per replan — the reference's ``emuGP.csv`` pattern
    (reference/PhysicalExperimentCode/
    GraceExplorationExperiments_MFEGP.py:412-417)."""
    row = np.concatenate([[float(plan_num)], np.asarray(param_array,
                                                        np.float64)])
    with open(path, "a") as f:
        np.savetxt(f, row.reshape(1, -1), delimiter=",")
