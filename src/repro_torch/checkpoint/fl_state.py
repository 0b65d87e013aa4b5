"""Whole-server crash-recovery checkpoints, the port's counterpart of
``repro/checkpoint/fl_state.py``.

A checkpoint captures everything a :class:`repro_torch.core.server.
FedSAEServer` needs to continue bitwise: resuming from round t gives the
params, history state and telemetry trace of the uninterrupted run.

  tensors   the params, the Ira/Fassa history (L/H/theta, float64, so the
            host driver's numpy math round-trips exactly), the
            ValueTracker values, the quarantine counters (int32), the
            compression error-feedback residual (when the upload
            transform carries one) and the state of the torch generator
            the minibatch draws come from (``get_state()``; on the card
            a CUDA generator's), and with the device rng streams the
            selection generator's too
  metadata  the next round index, the numpy generators' states (selection
            and ``HeterogeneitySim``: PCG64 holds a 128-bit word, stored
            as JSON as the reference does), every RoundRecord emitted so
            far (``to_json`` lines: float ``repr`` keeps e.g. the carried
            prev_acc bit-exact), the executed cohorts and their budgets

The generators are restored from their saved states, never rebuilt from
their seeds: their states after t rounds are what make the resumed draws
the uninterrupted run's.  The scan driver checkpoints at block
boundaries, with its device carry synced back first.  The fault stream
needs no state: it is drawn from ``(fault seed, t)`` every round.

Under client-axis sharding (``mesh_shards=S``) the checkpoint is still
the whole server's, as the reference's: every rank all-gathers the
residual into ``[S, C, P]``, rank 0 alone writes the file (every other
piece of state is replicated), and the ranks wait for it; on restore
every rank reads the file and keeps its own row of the residual.

Files are ``ckpt_<round>.pt`` under a caller-chosen directory, written
atomically (``checkpoint.store``); ``restore_server_state`` loads the
latest.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.store import load_checkpoint, save_checkpoint
from repro_torch.obs.schema import RoundRecord
from repro_torch.obs.sinks import RingBufferSink
from repro_torch.tree import tree_map

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.pt$")


def checkpoint_path(directory: str, next_round: int) -> str:
    return os.path.join(directory, f"ckpt_{next_round:08d}.pt")


def list_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """Sorted [(next_round, path)] for every checkpoint in ``directory``."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def latest_checkpoint(directory: str) -> Optional[str]:
    ckpts = list_checkpoints(directory)
    return ckpts[-1][1] if ckpts else None


def _server_tensors(server) -> Dict:
    tree = {
        "params": server.params,
        "L": np.asarray(server.L, np.float64),
        "H": np.asarray(server.H, np.float64),
        "theta": np.asarray(server.theta, np.float64),
        "values": np.asarray(server.values.v, np.float64),
        "q_fail": np.asarray(server.q_fail, np.int32),
        "q_try": np.asarray(server.q_try, np.int32),
        "q_susp": np.asarray(server.q_susp, np.int32),
        "data_gen": server.data_gen.get_state(),
    }
    if server.rng_impl == "device":
        tree["sel_gen"] = server.sel_gen.get_state()
    if server.residual is not None:
        tree["residual"] = server.residual
    return tree


def save_server_state(server, directory: str, next_round: int) -> str:
    """Checkpoint ``server`` so a fresh process can continue at
    ``next_round``.  Returns the written path."""
    metadata: Dict = {
        "round": int(next_round),
        "rng_impl": server.rng_impl,
        "records": [r.to_json() for r in server._records.records],
        "cohorts": [np.asarray(c).tolist() for c in server.cohorts],
        "budgets": [np.asarray(b).tolist() for b in server.budgets],
        "sel_rng_state": json.dumps(server.sel_rng.bit_generator.state),
        "het_rng_state": json.dumps(server.het._rng.bit_generator.state),
    }
    path = checkpoint_path(directory, next_round)
    tree = _server_tensors(server)
    if server.group is not None and server.residual is not None:
        from repro_torch.launch.mesh import all_gather_1d
        tree["residual"] = all_gather_1d(server.residual)   # [S, C, P]
    if server.rank == 0:
        save_checkpoint(path, tree, step=int(next_round), metadata=metadata)
    if server.group is not None:
        import torch.distributed as dist
        dist.barrier()        # the file exists on return, on every rank
    return path


def restore_server_state(server, directory: str) -> int:
    """Restore ``server`` from the latest checkpoint in ``directory``.

    Returns the next round index to execute.  The server must have been
    constructed with the same config, dataset and model as the
    checkpointing run (the tree restore checks the tensor names; the
    semantics are the caller's, as with any checkpoint format).
    """
    path = latest_checkpoint(directory)
    if path is None:
        raise FileNotFoundError(
            f"no ckpt_*.pt checkpoint found in {directory!r}")
    tree, _, metadata = load_checkpoint(path, like=_server_tensors(server))
    if metadata.get("rng_impl") != server.rng_impl:
        raise ValueError(
            f"checkpoint was taken with rng_impl="
            f"{metadata.get('rng_impl')!r} but this server runs "
            f"{server.rng_impl!r}")
    dev = server.device
    server.params = tree_map(lambda t: t.to(dev), tree["params"])
    server.L = tree["L"].numpy()
    server.H = tree["H"].numpy()
    server.theta = tree["theta"].numpy()
    server.values.v = tree["values"].numpy()
    server.q_fail = tree["q_fail"].numpy()
    server.q_try = tree["q_try"].numpy()
    server.q_susp = tree["q_susp"].numpy()
    server.data_gen.set_state(tree["data_gen"])
    if server.rng_impl == "device":
        server.sel_gen.set_state(tree["sel_gen"])
    if server.residual is not None:
        residual = tree["residual"]
        if server.group is not None:          # [S, C, P]: this rank's rows
            residual = residual[server.rank]
        server.residual = residual.to(dev)
    server.sel_rng.bit_generator.state = json.loads(
        metadata["sel_rng_state"])
    server.het._rng.bit_generator.state = json.loads(
        metadata["het_rng_state"])
    # replay the telemetry trace into the ring buffer only: the external
    # sink is the caller's (fl_train reopens its JSONL in append mode)
    server._records = RingBufferSink()
    for line in metadata["records"]:
        server._records.emit(RoundRecord.from_json(line))
    server.cohorts = [np.asarray(c, np.int64) for c in metadata["cohorts"]]
    server.budgets = [np.asarray(b, np.int32)
                      for b in metadata.get("budgets", [])]
    return int(metadata["round"])
