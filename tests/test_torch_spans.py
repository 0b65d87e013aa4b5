"""The port's host spans (``repro_torch.obs.profiling``'s ``SPAN_*``) on
the CPU, under ``warm_profile``.

- The scan driver: one ``fed.block`` span a block, its children nested
  inside it in the order they run (the injected inputs, their upload, the
  rounds, the stats pull, the eval where one is due, the records, the
  checkpoint where one is written); ``fed.block.eval`` once for each of
  ``host_syncs`` beyond one a block; one ``fed.history`` span, the view
  ``run`` returns.
- The silo path: one ``fed.local_step`` span for each local step the
  silos ran (``sum(last_n_steps)``), each holding its forward, backward
  and update in that order; and the same spans on the LM lanes' masked
  walk (``_train_in_place`` with ``active``), one for each slot walked.
- The spans change nothing: params and history bitwise, and
  ``host_syncs`` equal, with the profiler on and off (``SiloFedSAE`` has
  no ``host_syncs``: its params and stats are compared).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import RoundEngine
from repro_torch.core.heterogeneity import HeterogeneitySim
from repro_torch.core.server import (ComputeConfig, FedSAEServer,
                                     ServerConfig)
from repro_torch.core.silo import SiloFedSAE
from repro_torch.data.federated import make_femnist_like
from repro_torch.models.api import build_model
from repro_torch.obs import profiling, warm_profile
from repro_torch.tree import tree_leaves
from torch_cases import one_torch_thread  # noqa: F401

BLOCK_CHILDREN = (profiling.SPAN_BLOCK_INPUTS, profiling.SPAN_BLOCK_CAPTURE,
                  profiling.SPAN_BLOCK_UPLOAD, profiling.SPAN_BLOCK_REPLAY,
                  profiling.SPAN_BLOCK_PULL, profiling.SPAN_BLOCK_EVAL,
                  profiling.SPAN_BLOCK_RECORDS,
                  profiling.SPAN_BLOCK_CHECKPOINT)
STEP_CHILDREN = (profiling.SPAN_LOCAL_STEP_FORWARD,
                 profiling.SPAN_LOCAL_STEP_BACKWARD,
                 profiling.SPAN_LOCAL_STEP_UPDATE)


def _spans(prof, names):
    """(name, start, end) of the profile's ranges called one of
    ``names``, in order of start (µs)."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name in names),
                  key=lambda s: (s[1], -s[2]))


def _children(parents, spans):
    """The names of ``spans`` inside each of ``parents``, in order; every
    span lies inside exactly one parent."""
    out = [[] for _ in parents]
    for name, s, e in spans:
        inside = [i for i, (_, a, b) in enumerate(parents)
                  if a <= s and e <= b]
        assert len(inside) == 1, (name, s, e)
        out[inside[0]].append(name)
    return out


def _records(srv):
    out = []
    for r in srv._records.records:
        d = json.loads(r.to_json())
        d.pop("wall_time_s")
        out.append(d)
    return out


def _scan_server():
    ds = make_femnist_like(n_clients=24, total=1400, dim=16, max_size=60)
    cfg = ServerConfig(algo="ira", n_selected=8, rounds=12, h_cap=4.0,
                       sampling="iid", eval_every=8, device="cpu",
                       compute=ComputeConfig(driver="scan", block_size=4))
    return FedSAEServer(ds, cfg=cfg,
                        het=HeterogeneitySim(ds.n_clients, seed=0))


def test_scan_driver_spans_each_block_and_its_parts(tmp_path):
    off = _scan_server()
    off.run(checkpoint_dir=str(tmp_path / "off"))
    on = _scan_server()
    with warm_profile() as prof:
        on.run(checkpoint_dir=str(tmp_path / "on"))
    blocks = _spans(prof, {profiling.SPAN_BLOCK})
    assert len(blocks) == 3                     # 12 rounds, blocks of 4
    # evals at the blocks of rounds 0 and 8 (the last): none in between
    assert on.host_syncs == off.host_syncs == len(blocks) + 2
    kids = _children(blocks, _spans(prof, set(BLOCK_CHILDREN)))
    plain = [profiling.SPAN_BLOCK_INPUTS, profiling.SPAN_BLOCK_UPLOAD,
             profiling.SPAN_BLOCK_REPLAY, profiling.SPAN_BLOCK_PULL]
    ev, rec = profiling.SPAN_BLOCK_EVAL, profiling.SPAN_BLOCK_RECORDS
    assert kids == [plain + [ev, rec], plain + [rec],
                    plain + [ev, rec, profiling.SPAN_BLOCK_CHECKPOINT]]
    assert sum(k.count(ev) for k in kids) == on.host_syncs - len(blocks)
    # the history view the run returns, after the last block
    (hist,) = _spans(prof, {profiling.SPAN_HISTORY})
    assert hist[1] >= blocks[-1][2]
    for a, b in zip(tree_leaves(on.params), tree_leaves(off.params)):
        assert torch.equal(a, b)
    assert _records(on) == _records(off)
    np.testing.assert_array_equal(np.stack(on.budgets),
                                  np.stack(off.budgets))


def _silo():
    cfg = get_config("llama3.2-3b", smoke=True)
    fed = SiloFedSAE(build_model(cfg), n_silos=2, lr=5e-3, max_steps=4,
                     device="cpu")
    ri = np.random.default_rng(0)
    toks = np.stack([ri.integers(0, cfg.vocab_size, (4, 2, 32))
                     for _ in range(2)]).astype(np.int32)
    return fed, {"tokens": toks, "labels": toks}


def _silo_rounds(fed, batch, n=2):
    steps = 0
    for _ in range(n):
        fed.run_round(batch, np.array([100, 500]))
        steps += int(np.sum(fed.last_n_steps))
    return steps


def test_silo_spans_each_local_step_and_its_parts():
    off, batch = _silo()
    _silo_rounds(off, batch)
    on, _ = _silo()
    with warm_profile() as prof:
        steps = _silo_rounds(on, batch)
    assert steps > 0
    local = _spans(prof, {profiling.SPAN_LOCAL_STEP})
    assert len(local) == steps
    assert _children(local, _spans(prof, set(STEP_CHILDREN))) == (
        [list(STEP_CHILDREN)] * steps)
    silos = _spans(prof, {profiling.STAGE_LOCAL_SGD})
    assert sum(len(k) for k in _children(silos, local)) == steps
    for a, b in zip(tree_leaves(on.params), tree_leaves(off.params)):
        assert torch.equal(a, b)
    assert on.stats == off.stats


@pytest.mark.parametrize("profiled", [False, True])
def test_masked_walk_spans_every_slot(profiled):
    """``_train_in_place`` with ``active`` (the LM lanes' device walk):
    a span for every slot, and a masked slot changes nothing."""
    eng = RoundEngine(lr=0.1)
    gen = torch.Generator().manual_seed(0)
    w0 = torch.randn((4, 2), generator=gen)
    xs = torch.randn((3, 5, 4), generator=gen)

    def loss(p, b):
        return torch.mean((b @ p["w"]) ** 2)

    def walk(active):
        p = {"w": w0.clone()}
        total = eng._train_in_place(loss, lambda t: t, p, p,
                                    lambda i: xs[i], 3, active=active)
        return p["w"], total

    masked = torch.tensor([True, False, True])
    if profiled:
        with warm_profile() as prof:
            w, total = walk(masked)
        local = _spans(prof, {profiling.SPAN_LOCAL_STEP})
        assert len(local) == 3
        assert _children(local, _spans(prof, set(STEP_CHILDREN))) == (
            [list(STEP_CHILDREN)] * 3)
    else:
        w, total = walk(masked)
    ref_w, ref_total = w0.clone(), torch.zeros(())
    for i in (0, 2):
        p = ref_w.clone().requires_grad_(True)
        step_loss = loss({"w": p}, xs[i])
        (g,) = torch.autograd.grad(step_loss, p)
        ref_w = ref_w - g * 0.1
        ref_total = ref_total + step_loss.detach()
    assert torch.equal(w, ref_w)
    assert torch.equal(total, ref_total)
