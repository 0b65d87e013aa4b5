"""FedSAE rounds of MCLR clients on the port's scan driver
(``FedSAEServer`` with ``driver="scan"``: one CUDA-graph replay a round,
one host pull of a block's stats), back to back.

Set-up makes the federation (its data and the clients' heterogeneity,
from the cell's ``federation_seed``: every seed trains the same clients,
so the seed does not change how much work a round holds), and the initial
model and a pool of round draws from the seed; builds one server; drives
it through the checked rounds (one ``run`` call each, so each round's
params can be read) and a warm-up that measures the round rate; sizes the
window from that rate so that it lasts about ``--seconds``; and hands the
same server to the window, one ``run`` call.  The rate is all the
window's rounds over all its time.

Every round's draws (the heterogeneity normals ``z``, the Gumbel noise
``g`` and the data uniforms ``u``) come from the benchmark through the
server's ``device_draws=`` seam, the n-th call taking the pool's row n mod
its size; the reference gets the same rows.  After the window the server
is freed and the plain reference (``reference/fedsae_mclr.py``) follows
the checked rounds from the same initial model and draws.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np

from fedbench import data
from fedbench.outcome import Job, Outcome
from fedbench.reference import compare
from fedbench.reference.fedsae_mclr import FedSAEReference, max_iters_of

F32_TINY = float(np.finfo(np.float32).tiny)


class DrawFeed:
    """``device_draws``: the n-th call returns the pool's row n mod its
    size (the server asks once per round, in order)."""

    def __init__(self, pool: Dict[str, np.ndarray]):
        self.pool = pool
        self.size = len(next(iter(pool.values())))
        self.calls = 0

    def row(self, i: int) -> Dict[str, np.ndarray]:
        return {k: v[i % self.size] for k, v in self.pool.items()}

    def __call__(self, t: int) -> Dict[str, np.ndarray]:
        out = self.row(self.calls)
        self.calls += 1
        return out


def draw_pool(seed: int, rounds: int, n_clients: int, K: int, max_iters: int,
              B: int, max_n: int, sampling: str) -> Dict[str, np.ndarray]:
    """``rounds`` rounds of draws, float32: z [N] standard normals, g [N]
    Gumbel noise, u ([K, max_iters, B] iid, [K, max_n] shuffle)
    uniforms in [0, 1)."""
    rng = np.random.default_rng([seed, 0xFED])
    z = rng.standard_normal((rounds, n_clients), dtype=np.float32)
    ug = np.maximum(rng.random((rounds, n_clients), dtype=np.float32),
                    np.float32(F32_TINY))
    g = (-np.log(-np.log(ug))).astype(np.float32)
    shape = (K, max_iters, B) if sampling == "iid" else (K, max_n)
    u = rng.random((rounds,) + shape, dtype=np.float32)
    return {"z": z, "g": g, "u": u}


def server_settings(cfg: Dict, traffic: Dict) -> Dict:
    """The server's settings: the configuration's, with the cell's
    sampling rule."""
    return dict(cfg["server"], sampling=traffic["sampling"])


def setup(job: Job):
    """(federation, initial params on the device, draw feed, server)."""
    import torch
    from repro_torch.core.server import (ComputeConfig, FedSAEServer,
                                         ServerConfig)
    from repro_torch.data.federated import FederatedDataset

    cfg, traffic = job.cell.config, job.cell.traffic
    fed = data.femnist_like(seed=traffic["federation_seed"],
                            **cfg["dataset"])
    s = server_settings(cfg, traffic)
    dev = torch.device(job.device)
    gen = torch.Generator(dev).manual_seed(job.seed)
    d, C = fed.clients_x[0].shape[1], fed.n_classes
    p0 = {"w": torch.randn((d, C), generator=gen, device=dev)
          * cfg["init_std"],
          "b": torch.zeros((C,), device=dev)}
    max_n = int(fed.sizes.max())
    pool = draw_pool(job.seed, traffic["draw_pool"], len(fed.clients_y),
                     s["n_selected"], max_iters_of(s, max_n),
                     s["batch_size"], max_n, s["sampling"])
    feed = DrawFeed(pool)
    scfg = ServerConfig(
        algo=s["algo"], n_selected=s["n_selected"], lr=s["lr"],
        batch_size=s["batch_size"], h_cap=s["h_cap"], U=s["U"],
        init_pair=tuple(s["init_pair"]), fixed_epochs=s["fixed_epochs"],
        sampling=s["sampling"], eval_every=traffic["eval_every"],
        seed=traffic["federation_seed"], device=job.device,
        compute=ComputeConfig(driver="scan",
                              block_size=traffic["block_size"]))
    ds = FederatedDataset("femnist", fed.clients_x, fed.clients_y,
                          fed.test_x, fed.test_y, fed.n_classes)
    server = FedSAEServer(ds, cfg=scfg,
                          init_params={k: v.cpu().numpy()
                                       for k, v in p0.items()},
                          device_draws=feed)
    return fed, p0, feed, server


def checked_rounds(server, n: int) -> List[Dict]:
    """The first ``n`` rounds, one ``run`` call each: what each produced."""
    out = []
    for _ in range(n):
        server.run(rounds=1)
        h = server.history
        out.append({"ids": np.asarray(server.cohorts[-1]),
                    "n_iters": np.asarray(server.budgets[-1]),
                    "train_loss": h["train_loss"][-1],
                    "test_loss": h["test_loss"][-1],
                    "params": {k: v.detach().clone()
                               for k, v in server.params.items()}})
    return out


def reference_rounds(job: Job, fed, p0, feed: DrawFeed, n: int,
                     precision: str = "float32", fault: str = "") -> List:
    """The reference's first ``n`` rounds on the same inputs."""
    s = server_settings(job.cell.config, job.cell.traffic)
    ref = FedSAEReference(fed.clients_x, fed.clients_y, fed.test_x,
                          fed.test_y, fed.n_classes, s,
                          job.cell.traffic["federation_seed"], job.device,
                          precision=precision, fault=fault)
    params, out = dict(p0), []
    for r in range(n):
        rec = ref.round(params, feed.row(r))
        params = rec["params"]
        out.append(rec)
    return out


def _norms(params, p0) -> Dict[str, float]:
    return {k: float((params[k].double() - p0[k].double()).norm())
            for k in p0}


def readings(prog: List[Dict], ref: List[Dict], p0) -> Dict[str, float]:
    """The numbers compared: exact cohorts and budgets; the rounds' train
    and test losses; the first round's update and the whole change, by the
    worst leaf."""
    mismatch = sum(int(not (np.array_equal(a["ids"], b["ids"])
                            and np.array_equal(a["n_iters"], b["n_iters"])))
                   for a, b in zip(prog, ref))
    first_ref = _norms(ref[0]["params"], p0)
    leaves = compare.moving_leaves(first_ref)
    return {
        "plan_mismatches": float(mismatch),
        "train_loss_gap": max(compare.rel_gap(a["train_loss"],
                                              b["train_loss"])
                              for a, b in zip(prog, ref)),
        "test_loss_gap": max(compare.rel_gap(a["test_loss"], b["test_loss"])
                             for a, b in zip(prog, ref)),
        "first_update_gap": compare.worst_leaf_gap(
            _norms(prog[0]["params"], p0), first_ref, leaves),
        "change_gap": compare.worst_leaf_gap(
            _norms(prog[-1]["params"], p0), _norms(ref[-1]["params"], p0),
            leaves),
    }


def control(job: Job, modes, precision: str):
    """Readings for the limits: ``"program"`` (the program against the
    reference), ``"control"`` (the reference at ``precision`` in the
    program's place) and ``"fault:<name>"`` (the reference with that
    fault planted), each on this job's seed."""
    import torch
    fed, p0, feed, server = setup(job)
    n = job.cell.traffic["check_rounds"]
    prog = checked_rounds(server, n) if "program" in modes else None
    del server
    gc.collect()
    if job.device == "cuda":
        torch.cuda.empty_cache()
    ref = reference_rounds(job, fed, p0, feed, n)
    out = {}
    for mode in modes:
        if mode == "program":
            other = prog
        elif mode == "control":
            other = reference_rounds(job, fed, p0, feed, n, precision)
        else:
            other = reference_rounds(job, fed, p0, feed, n,
                                     fault=mode.split(":", 1)[1])
        out[mode] = readings(other, ref, p0)
    return out


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(job: Job) -> Outcome:
    import torch
    from fedbench.trace import traced

    traffic = job.cell.traffic
    dev = torch.device(job.device)
    fed, p0, feed, server = setup(job)
    job.lap("server built")
    prog = checked_rounds(server, traffic["check_rounds"])
    job.lap("checked rounds run")
    block = traffic["block_size"]
    _sync(torch, dev)
    t0 = time.perf_counter()
    server.run(rounds=traffic["warm_rounds"])
    _sync(torch, dev)
    rate = traffic["warm_rounds"] / (time.perf_counter() - t0)
    R = block * max(1, math.ceil(rate * job.seconds / block))
    setup_s = time.perf_counter() - job.t_start
    n_rec, syncs, n_b = (len(server.wall_times), server.host_syncs,
                         len(server.budgets))

    def window(rounds):
        server.run(rounds=rounds)
        _sync(torch, dev)

    t0 = time.perf_counter()
    window(R)
    elapsed = time.perf_counter() - t0
    hist = server.history
    loss = np.asarray(hist["train_loss"][n_rec:], np.float64)
    dropout = np.asarray(hist["dropout"][n_rec:], np.float64)
    s = server_settings(job.cell.config, traffic)
    counters = {"rounds": R, "window_s": elapsed,
                "host_syncs": server.host_syncs - syncs,
                "executed_iters": int(np.sum(server.budgets[n_b:])),
                "K": s["n_selected"], "max_n": server.packed.max_n,
                "max_iters": server.max_iters, "B": s["batch_size"],
                "feat": fed.clients_x[0].shape[1], "C": fed.n_classes}
    tr = None
    if job.trace:
        n_b = len(server.budgets)
        _, tr = traced(torch, lambda: window(traffic["trace_rounds"]), dev)
        counters.update(traced_rounds=traffic["trace_rounds"],
                        traced_budgets=np.stack(server.budgets[n_b:]))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del server
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    job.lap("window closed")
    ref = reference_rounds(job, fed, p0, feed, traffic["check_rounds"])
    job.lap("reference run")
    return Outcome(
        cell=job.cell,
        end_to_end={"rounds_per_s": R / elapsed, "setup_s": setup_s},
        counters=counters, readings=readings(prog, ref, p0),
        attempted=R,
        failed=int(np.sum(~np.isfinite(loss) & (dropout < 1.0))),
        memory_peak_bytes=int(peak), trace=tr)
