"""The client-axis data group: the port's counterpart of the reference's
``make_data_mesh`` (``repro/launch/mesh.py``).

The reference runs one process over an S-device JAX mesh under
``shard_map``.  The port runs one process per shard in a
``torch.distributed`` default process group of world size S: NCCL on
CUDA (one rank per card), gloo on the CPU.  The caller creates the group
(``fl_train``, the tests, ``chip_smoke.py``; ``spawn_world`` starts a
world of ranks and does it for them); the server reads its rank and world
from it and never creates one of its own.

The round needs two collectives, each a plain function here: an
all-gather of a 1-D tensor (the selection's candidates, the checkpoint's
residual) and a SUM all-reduce (the ownership-masked rebuild of the
cohort's stack).  Both run under CUDA-graph capture on an NCCL group.

    # two gloo ranks on the CPU, each running fn(rank, *args):
    results = spawn_world(fn, 2, backend="gloo", device="cpu", args=(...))
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import warnings
from typing import Callable, List, NamedTuple, Sequence

import torch
import torch.distributed as dist

#: a rank that dies fails its peers' collectives after this long instead
#: of hanging them
GROUP_TIMEOUT_S = 60.0


class DataGroup(NamedTuple):
    """This process's place in the client-axis group."""
    rank: int
    world: int
    device: torch.device


def make_data_group(n_shards: int, device=None) -> DataGroup:
    """(rank, world, device) of this process in the default process group,
    which must exist and have world size ``n_shards``.  ``device`` is the
    server's: a CUDA device becomes this process's current card."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"mesh_shards={n_shards} needs a torch.distributed default "
            f"process group of world size {n_shards} (one process per "
            f"shard): start the ranks with repro_torch.launch.mesh."
            f"spawn_world or torchrun")
    world = dist.get_world_size()
    if world != n_shards:
        raise ValueError(
            f"mesh_shards={n_shards} but the process group has {world} "
            f"ranks; start {n_shards} ranks")
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return DataGroup(dist.get_rank(), world, dev)


def all_gather_1d(x: torch.Tensor) -> torch.Tensor:
    """[world, *x.shape]: every rank's ``x``, in rank order."""
    x = x.contiguous()
    out = torch.empty((dist.get_world_size() * x.numel(),), dtype=x.dtype,
                      device=x.device)
    with warnings.catch_warnings():
        # torch 2.13 renames it all_gather_single; the card's 2.11 has
        # only this name
        warnings.filterwarnings("ignore", message=".*all_gather_into_tensor")
        dist.all_gather_into_tensor(out, x.reshape(-1))
    return out.reshape((-1,) + tuple(x.shape))


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of every rank's ``x`` (a new tensor)."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def _rank_main(rank: int, fn: Callable, n: int, backend: str, device: str,
               store: str, out_dir: str, args: Sequence):
    """One spawned rank: join the group, run ``fn(rank, *args)``, save its
    result for the parent, leave the group."""
    torch.set_num_threads(1)
    if device == "cuda" and backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_world(fn: Callable, n: int, backend: str = "gloo",
                device: str = "cpu", args: Sequence = ()) -> List:
    """Run ``fn(rank, *args)`` in ``n`` fresh processes joined in one
    default process group (``file://`` store under a temp directory) and
    return their results, rank by rank (each must be ``torch.save``-able).
    ``fn`` must be importable by the children: a module-level function.
    With ``backend="nccl"`` rank r takes card ``r % device_count``.  A
    rank that raises makes this raise; the others fail their next
    collective within ``GROUP_TIMEOUT_S``."""
    if backend == "nccl" and device != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    try:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, n, backend, device,
                              os.path.join(tmp, "store"), tmp, tuple(args)),
            nprocs=n, join=True)
        # our own children's files: full unpickling is safe here
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
