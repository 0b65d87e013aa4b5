"""The ranks of the port's sharding tests: module-level functions that
``repro_torch.launch.mesh.spawn_world`` can start in fresh processes (a
spawned child imports its target by module path).  Imports neither JAX
nor the reference, so a rank starts in a few seconds.

A case is a plain dict, so it pickles: ``ds`` the FEMNIST-like generator's
arguments (or, with ``lm``, the Sent140-like generator's plus
``test_rows``, and ``lm`` the architecture id and dtype of the
``from_model`` local step: ``lm_federation`` and ``lm_step``), ``cfg`` the
``ServerConfig`` fields (``faults`` as
``FaultModel`` arguments), and optionally ``init`` (numpy params),
``device_draws`` (per round a dict of numpy arrays), ``data_draws`` (per
round the [K, ...] minibatch draws), ``fault_draws`` (per round a dict),
``telemetry``, ``rounds`` and ``resume_at`` (kill at that round with a
checkpoint under ``ckpt``, resume in a fresh server).
"""
import json

import numpy as np
import torch

from repro_torch.core.server import FedSAEServer, ServerConfig
from repro_torch.data.federated import make_femnist_like
from repro_torch.faults import FaultModel
from repro_torch.tree import tree_items


def flat_params(params) -> dict:
    """A params tree as ``{"/"-joined key path: numpy array}`` (a flat
    dict keeps its keys)."""
    return {k: v.detach().cpu().numpy() for k, v in tree_items(params)}


def lm_federation(test_rows: int, **kw):
    """The Sent140-like federation with its test split cut to its first
    ``test_rows`` rows (the LM's eval runs over the whole split)."""
    from repro_torch.data.federated import (FederatedDataset,
                                            make_sent140_like)
    ds = make_sent140_like(**kw)
    return FederatedDataset(ds.name, ds.clients_x, ds.clients_y,
                            ds.test_x[:test_rows], ds.test_y[:test_rows],
                            ds.n_classes, task="text")


def lm_step(arch: str, dtype: str):
    """The ``from_model`` local step of ``arch``'s smoke config in
    ``dtype``."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import from_model
    return from_model(get_config(arch, smoke=True).replace(dtype=dtype))


def summary(srv) -> dict:
    """A finished server's state as host values.  ``residual`` is this
    rank's rows; ``records`` drop the wall times."""
    recs = []
    for r in srv._records.records:
        d = json.loads(r.to_json())          # NaN -> None: comparable
        d.pop("wall_time_s")
        recs.append(d)
    return {"cohorts": np.stack(srv.cohorts), "budgets": np.stack(srv.budgets),
            "L": srv.L.copy(), "H": srv.H.copy(), "theta": srv.theta.copy(),
            "values": srv.values.v.copy(),
            "params": flat_params(srv.params),
            "residual": (None if srv.residual is None
                         else srv.residual.cpu().numpy()),
            "history": {k: np.asarray(v) for k, v in srv.history.items()},
            "records": recs, "host_syncs": srv.host_syncs}


def _server(case):
    cfg = dict(case["cfg"])
    if cfg.get("faults") is not None:
        cfg["faults"] = FaultModel(**cfg["faults"])
    kw = {}
    if case.get("device_draws") is not None:
        rows = case["device_draws"]
        kw["device_draws"] = lambda t: rows[t]
    if case.get("data_draws") is not None:
        data = case["data_draws"]
        kw["data_draws"] = lambda t, ids, n: data[t]
    if case.get("fault_draws") is not None:
        faults = case["fault_draws"]
        kw["fault_draws"] = lambda t: faults[t]
    if case.get("lm") is not None:
        ds, kw["model"] = (lm_federation(**case["ds"]),
                           lm_step(*case["lm"]))
    else:
        ds = make_femnist_like(**case["ds"])
    return FedSAEServer(ds, cfg=ServerConfig(device="cpu", **cfg),
                        init_params=case.get("init"),
                        telemetry=case.get("telemetry"), **kw)


def run_case(case) -> dict:
    """One case on this rank: the straight run, or the killed and resumed
    one."""
    rounds = case.get("rounds")
    if case.get("resume_at") is None:
        srv = _server(case)
        srv.run(rounds=rounds)
        return summary(srv)
    _server(case).run(rounds=case["resume_at"], checkpoint_dir=case["ckpt"])
    srv = _server(case)
    srv.run(rounds=rounds, checkpoint_dir=case["ckpt"], resume=True)
    out = summary(srv)
    # the file: the whole server's residual, [S, C, P]
    from repro_torch.checkpoint import latest_checkpoint
    from repro_torch.checkpoint.store import load_checkpoint
    tree, _, _ = load_checkpoint(latest_checkpoint(case["ckpt"]))
    if "residual" in tree:
        out["saved_residual"] = tree["residual"].numpy()
    return out


def run_cases(rank: int, cases) -> dict:
    """Every case in turn on this rank (one spawned world serves a whole
    test module), after one all-gather and one all-reduce of
    ``[rank, rank]``."""
    from repro_torch.launch.mesh import all_gather_1d, all_reduce_sum
    x = torch.full((2,), float(rank))
    return {"collectives": (all_gather_1d(x), all_reduce_sum(x)),
            "cases": [run_case(case) for case in cases]}
