"""Cross-silo FedSAE-Ira training a full-width Mamba-1 language model on
the port's silo path (``SiloFedSAE.run_round``: each silo's local SGD
steps through the model in turn, then FedAvg), rounds back to back.

Set-up makes the weights on the card from the seed (one normal draw of
every random leaf, scaled leaf by leaf, in float32, the type the program
trains them in) and hands them to the program as its model's init; makes
the silo sizes and a pool of rounds' token rows (the silos' token streams)
from the seed; and drives the one ``SiloFedSAE`` through the checked
rounds, which also warm up every shape.  The window then runs rounds until
``--seconds`` have passed; its rate counts the tokens of every local step
the silos ran.  After the window the program is freed and the plain
reference (``reference/mamba_lm.py``) follows the checked rounds from the
same weights, sizes and tokens.

The silos' budgets come from the program's own heterogeneity draws,
seeded by the cell's ``het_seed`` and not by ``--seed``: with two silos
the budgets decide most of a round's work, so every seed runs the same
sequence of budgets on its own weights and tokens.  ``SiloFedSAE`` has no
seam to inject those draws, so the reference draws them again from the
same seed with its own copy of the heterogeneity model.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict, List

import numpy as np

from fedbench import data
from fedbench.outcome import Job, Outcome
from fedbench.reference import compare
from fedbench.reference.mamba_lm import MIXER, SiloReference


def sizes_of(cfg: Dict) -> Dict[str, int]:
    """The model's sizes from the configuration's published keys."""
    d = cfg["hidden_size"]
    return {"d": d, "di": cfg["intermediate_size"], "N": cfg["state_size"],
            "K": cfg["conv_kernel"], "V": cfg["vocab_size"],
            "dtr": cfg["time_step_rank"], "G": cfg["num_hidden_layers"],
            "eps": cfg["layer_norm_epsilon"]}


def make_weights(seed: int, cfg: Dict, device) -> Dict:
    """The model's float32 weights in the program's layout: one normal
    draw for every random leaf (views of one buffer), each scaled by its
    fan-in's inverse square root (the embedding by 1), the norms 1, the
    biases 0, A_log = log(1 .. N) and D = 1."""
    import torch
    s = sizes_of(cfg)
    d, di, N, K, V, dtr, G = (s[k] for k in ("d", "di", "N", "K", "V",
                                              "dtr", "G"))
    shapes = [("tok", (V, d), 1.0), ("unembed", (d, V), d ** -0.5),
              ("in_proj", (G, d, 2 * di), d ** -0.5),
              ("conv_w", (G, K, di), K ** -0.5),
              ("x_proj", (G, di, dtr + 2 * N), di ** -0.5),
              ("dt_proj", (G, dtr, di), dtr ** -0.5),
              ("out_proj", (G, di, d), di ** -0.5)]
    total = sum(math.prod(shape) for _, shape, _ in shapes)
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    leaf, at = {}, 0
    for name, shape, scale in shapes:
        n = math.prod(shape)
        leaf[name] = flat[at:at + n].view(shape).mul_(scale)
        at += n
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.arange(1, N + 1, **f32))
    mixer = {k: leaf[k] for k in ("in_proj", "conv_w", "x_proj", "dt_proj",
                                  "out_proj")}
    mixer.update(conv_b=torch.zeros((G, di), **f32),
                 dt_bias=torch.zeros((G, di), **f32),
                 A_log=a_log.expand(G, di, N).contiguous(),
                 D=torch.ones((G, di), **f32),
                 norm=torch.ones((G, d), **f32))
    return {"embeddings": {"tok": leaf["tok"], "unembed": leaf["unembed"],
                           "final_norm": torch.ones((d,), **f32)},
            "blocks": {"pos0": {"mixer": {k: mixer[k] for k in MIXER}}}}


def leaf_rows(params) -> Dict[str, object]:
    """Every layer's row of every leaf, by name."""
    out = dict(params["embeddings"])
    for k, v in params["blocks"]["pos0"]["mixer"].items():
        for g in range(v.shape[0]):
            out[f"{k}.{g}"] = v[g]
    return out


#: coordinates of a leaf row kept to compare changes by their difference
SAMPLE = 65536


def changes(rows, p0, samples: bool = False) -> Dict[str, Dict]:
    """Each leaf row's change from ``p0`` (``rows`` a ``leaf_rows`` or a
    ``reference_rows`` dict): its norm, and with ``samples`` the change at
    every ceil(n / SAMPLE)-th coordinate, on the host."""
    base = leaf_rows(p0)
    norms, sample = {}, {}
    for k in base:
        delta = rows[k] - base[k]
        norms[k] = float(delta.norm())
        if samples:
            flat = delta.reshape(-1)
            sample[k] = flat[::max(1, -(-flat.numel() // SAMPLE))].cpu()
    return {"norms": norms, "sample": sample}


def reference_layout(params):
    """The program's layout as the reference's (views, no copy)."""
    mixer = params["blocks"]["pos0"]["mixer"]
    G = mixer["in_proj"].shape[0]
    return {"embeddings": dict(params["embeddings"]),
            "layers": [{k: mixer[k][g] for k in MIXER} for g in range(G)]}


def reference_rows(ref_params) -> Dict[str, object]:
    """The reference's params by the names of ``leaf_rows``."""
    out = dict(ref_params["embeddings"])
    for g, layer in enumerate(ref_params["layers"]):
        out.update({f"{k}.{g}": v for k, v in layer.items()})
    return out


def traffic_pool(seed: int, cfg: Dict, traffic: Dict):
    """(silo sizes [K], ``pool`` rounds of token rows [K, max_steps, B,
    S]) from the seed.  The labels are the tokens, as the silo CLI's
    batches have them."""
    ri = np.random.default_rng([seed, 0x5110])
    fl = cfg["federation"]
    sizes = ri.integers(100, 1000, fl["silos"])
    rounds = [data.silo_tokens(ri, cfg["vocab_size"], fl["silos"],
                               fl["max_steps"], traffic["rows"],
                               traffic["seq_len"])
              for _ in range(traffic["token_pool"])]
    return sizes, rounds


def program_config(cfg: Dict):
    """The program's ArchConfig at the configuration's sizes."""
    from repro_torch.configs import get_config
    s = sizes_of(cfg)
    return get_config(cfg["arch_id"]).replace(
        n_layers=s["G"], d_model=s["d"], vocab_size=s["V"],
        ssm_state=s["N"], ssm_expand=s["di"] // s["d"], ssm_conv=s["K"],
        ssm_dt_rank=s["dtr"], norm_eps=s["eps"], dtype=cfg["compute_dtype"],
        param_dtype=cfg["param_dtype"], remat=cfg["remat"])


def setup(job: Job):
    """(silo sizes, token pool, the SiloFedSAE holding the seed's
    weights)."""
    from repro_torch.core.silo import SiloFedSAE
    from repro_torch.models.api import build_model

    cfg, traffic = job.cell.config, job.cell.traffic
    fl = cfg["federation"]
    sizes, pool = traffic_pool(job.seed, cfg, traffic)
    model = build_model(program_config(cfg))
    model = dataclasses.replace(
        model, init=lambda gen: make_weights(job.seed, cfg, job.device))
    silo = SiloFedSAE(model, fl["silos"], lr=fl["lr"],
                      max_steps=fl["max_steps"], U=fl["U"],
                      seed=traffic["het_seed"], device=job.device)
    return sizes, pool, silo


def batch(tokens):
    return {"tokens": tokens, "labels": tokens}


def checked_rounds(job: Job, silo, sizes, pool, n: int,
                   samples: bool = False) -> Dict:
    """The first ``n`` rounds: each round's n_steps and loss, the first
    round's change and the change after the ``n``-th, leaf row by row."""
    import torch
    out = {"n_steps": [], "loss": []}
    p0 = silo.params
    for r in range(n):
        stats = silo.run_round(batch(pool[r]), sizes)
        out["n_steps"].append(np.asarray(silo.last_n_steps))
        out["loss"].append(stats["loss"][-1])
        if r == 0:
            out["first"] = changes(leaf_rows(silo.params), p0, samples)
            del p0
            gc.collect()
            if job.device == "cuda":
                torch.cuda.empty_cache()
    p0 = make_weights(job.seed, job.cell.config, job.device)
    out["change"] = changes(leaf_rows(silo.params), p0, samples)
    return out


def reference_rounds(job: Job, sizes, pool, n: int,
                     precision: str = "float32", fault: str = "",
                     samples: bool = False) -> Dict:
    """The reference's first ``n`` rounds from the seed's weights."""
    cfg = job.cell.config
    s, fl = sizes_of(cfg), cfg["federation"]
    ref = SiloReference(
        {"d_inner": s["di"], "state": s["N"], "dt_rank": s["dtr"],
         "eps": s["eps"], "loss_chunk": cfg["loss_chunk"]},
        fl["silos"], job.cell.traffic["het_seed"], sizes, fl["lr"],
        fl["max_steps"], fl["U"], precision=precision, fault=fault)
    import torch
    params = reference_layout(make_weights(job.seed, cfg, job.device))
    out = {"n_steps": [], "loss": []}
    for r in range(n):
        tok = torch.as_tensor(pool[r], device=job.device)
        params, losses, n_steps = ref.round(params, tok, tok)
        out["n_steps"].append(n_steps)
        out["loss"].append(float(np.mean(losses)))
        if r == 0:
            out["first"] = changes(reference_rows(params),
                                   make_weights(job.seed, cfg, job.device),
                                   samples)
    out["change"] = changes(reference_rows(params),
                            make_weights(job.seed, cfg, job.device), samples)
    return out


def readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers the cell compares: exact budgets; the first round's
    loss; and the change of the leaf rows after the first round and after
    the last, by the gap of norms of the median row, of the median row of
    the widest kind (``compare.kind_gap``) and of the widest row."""
    out = {
        "plan_mismatches": float(sum(
            int(not np.array_equal(a, b))
            for a, b in zip(prog["n_steps"], ref["n_steps"]))),
        "first_loss_gap": compare.rel_gap(prog["loss"][0], ref["loss"][0]),
    }
    leaves = compare.moving_leaves(ref["first"]["norms"])
    for key, name in (("first", "first_update"), ("change", "change")):
        p, r = prog[key]["norms"], ref[key]["norms"]
        out[name + "_median_gap"] = compare.median_leaf_gap(p, r, leaves)
        out[name + "_kind_gap"] = compare.kind_gap(p, r, leaves)
        out[name + "_worst_gap"] = compare.worst_leaf_gap(p, r, leaves)
    return out


def observed(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Numbers the cell does not compare, read for the limits (samples
    taken): the later rounds' losses, and the median row's difference of
    changes over the reference's change."""
    out = {"loss_gap": max(compare.rel_gap(a, b)
                           for a, b in zip(prog["loss"], ref["loss"]))}
    leaves = compare.moving_leaves(ref["first"]["norms"])
    for key, name in (("first", "first_update"), ("change", "change")):
        out[name + "_median_diff"] = compare.median_leaf_diff(
            prog[key]["sample"], ref[key]["sample"], leaves)
    return out


def worst_rows(prog: Dict, ref: Dict, key: str, top: int = 5):
    """The leaf rows with the widest differences of ``key`` ("first",
    "change"): [name, program norm, reference norm, gap of norms,
    difference over the reference's change]."""
    p, r = prog[key], ref[key]
    med = float(np.median(list(r["norms"].values())))
    rows = [[k, p["norms"][k], r["norms"][k],
             abs(p["norms"][k] - r["norms"][k]) / max(r["norms"][k], med),
             compare.diff(p["sample"][k], r["sample"][k])]
            for k in r["norms"]]
    return sorted(rows, key=lambda x: -x[4])[:top]


def control(job: Job, modes, precision: str):
    """Readings for the limits: ``"program"`` (the program against the
    reference), ``"control"`` (the reference at ``precision`` in the
    program's place) and ``"fault:<name>"`` (the reference with that
    fault planted), each on this job's seed; with the widest leaf rows of
    each under ``"<mode>.rows"``."""
    import torch
    sizes, pool, silo = setup(job)
    n = job.cell.traffic["check_rounds"]
    prog = (checked_rounds(job, silo, sizes, pool, n, samples=True)
            if "program" in modes else None)
    del silo
    gc.collect()
    if job.device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference_rounds(job, sizes, pool, n, samples=True)
    out = {"reference_s": time.perf_counter() - t0,
           "reference.norms": {k: ref[k]["norms"]
                               for k in ("first", "change")},
           "reference.loss": ref["loss"]}
    for mode in modes:
        if mode == "program":
            other = prog
        elif mode == "control":
            other = reference_rounds(job, sizes, pool, n, precision,
                                     samples=True)
        else:
            other = reference_rounds(job, sizes, pool, n,
                                     fault=mode.split(":", 1)[1],
                                     samples=True)
        out[mode] = dict(readings(other, ref), **observed(other, ref))
        out[mode + ".rows"] = {k: worst_rows(other, ref, k)
                               for k in ("first", "change")}
        out[mode + ".norms"] = {k: other[k]["norms"]
                                for k in ("first", "change")}
        out[mode + ".loss"] = other["loss"]
    return out


def run(job: Job) -> Outcome:
    import torch
    from fedbench.trace import traced
    from repro_torch.tree import tree_leaves

    cfg, traffic = job.cell.config, job.cell.traffic
    dev = torch.device(job.device)
    cuda = dev.type == "cuda"
    sizes, pool, silo = setup(job)
    job.lap("silos built")
    n_check = traffic["check_rounds"]
    prog = checked_rounds(job, silo, sizes, pool, n_check)
    job.lap("checked rounds run")
    n_params = sum(t.numel() for t in tree_leaves(silo.params))
    row_tokens = traffic["rows"] * traffic["seq_len"]
    setup_s = time.perf_counter() - job.t_start
    done: List[Dict] = []

    def rounds(until):
        r = n_check + len(done)
        while not until(len(done)):
            stats = silo.run_round(batch(pool[r % len(pool)]), sizes)
            done.append({"steps": int(np.sum(silo.last_n_steps)),
                         "loss": stats["loss"][-1]})
            r += 1

    t0 = time.perf_counter()
    rounds(lambda k: time.perf_counter() - t0 >= job.seconds)
    elapsed = time.perf_counter() - t0
    steps = sum(d["steps"] for d in done)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    s = sizes_of(cfg)
    counters = {"rounds": len(done), "steps": steps,
                "tokens": steps * row_tokens, "window_s": elapsed,
                "n_params": n_params, "rows": traffic["rows"],
                "S": traffic["seq_len"], "d": s["d"], "di": s["di"],
                "N": s["N"], "V": s["V"], "loss_chunk": cfg["loss_chunk"]}
    window = list(done)
    tr = None
    if job.trace:
        n_done = len(done)
        _, tr = traced(torch, lambda: rounds(
            lambda k: k - n_done >= traffic["trace_rounds"]), dev)
        counters["traced_rounds"] = len(done) - n_done
    del silo
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    job.lap("window closed")
    ref = reference_rounds(job, sizes, pool, n_check)
    job.lap("reference run")
    return Outcome(
        cell=job.cell,
        end_to_end={"train_tokens_per_s": steps * row_tokens / elapsed,
                    "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
        counters=counters, readings=readings(prog, ref),
        attempted=len(window),
        failed=sum(1 for d in window if not math.isfinite(d["loss"])),
        memory_peak_bytes=int(peak), trace=tr)
