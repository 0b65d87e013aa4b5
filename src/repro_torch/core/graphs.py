"""Device-resident rounds: the state and the block loop of the port's
device drivers (``rng_impl="device"`` on the host driver, and
``driver="scan"``), the dispatch counterpart of the reference's one jitted
``lax.scan`` block.

``RoundProgram`` keeps the server's carry (params, L/H/theta, values, the
quarantine counters, the error-feedback residual) in device buffers and
runs one round of ``RoundEngine.make_device_round`` in place on them: the
round reads its index ``t`` from a 0-d int32 device tensor and round t's
injected inputs (the fault draws, and any draws that replace the
generators') from row ``i`` of static ``[block_size, ...]`` buffers,
writes the new carry back with ``copy_``, packs its stats into row ``i``
of a static ``[block_size, W]`` float32 buffer, and advances ``t`` and
``i`` on the device.  So a block of rounds needs one host pull, the stats
buffer's, and nothing in it depends on the host.

On a CUDA device the scan driver captures that round once with
``torch.cuda.CUDAGraph`` and replays it once per round of every block
(``graphed=True``).  Before the capture one round runs eagerly on a side
stream (the warm-up: it builds the kernels, the library handles and the
caching allocator's blocks) on a copy of the state, which is then put back,
generators included, so every round of the run is a replay.  The custom
generators are registered with the graph, so each replay draws the next
Philox offsets: a replayed round draws the bits the same round draws
eagerly.  A capture that fails raises; there is no eager fallback on the
card.  On the CPU, which has no graphs, the same round runs eagerly.

What a replay does not repeat: the Python side of the round.  The kernel
wrappers' launch counters and the ``stage()`` profiler ranges run once, at
capture.  ``launches`` reports each FL and LM kernel's real launches (the
warm-up's plus replays times the launches one capture recorded), and a
trace of replays shows the kernels without their stage ranges.  A round
whose local step is an LM (an architecture id) captures its lanes' K x
``max_iters`` forward and backward passes, autograd included.

A sharded round (``group=``, a ``launch.mesh.DataGroup``) holds
collectives.  On an NCCL group they are captured with the round; one
warm-up all-reduce before the capture creates the communicator, so the
capture only records.
"""
from __future__ import annotations

import contextlib
import ctypes
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import (fed_compress, fed_gather, fed_local_sgd,
                                 fed_local_sgd_dense, flash_attention,
                                 fused_xent, selective_scan)
from repro_torch.tree import tree_leaves, tree_map

#: the FL kernels' wrappers, whose launches a captured round records
FL_KERNELS = {
    "fed_cohort_gather": fed_gather.fed_cohort_gather,
    "fed_local_sgd_mclr": fed_local_sgd.fed_local_sgd_mclr,
    "fed_local_sgd_dense": fed_local_sgd_dense.fed_local_sgd_dense,
    "fed_compress_topk_q8": fed_compress.fed_compress_topk_q8,
}
#: ... and the LM kernels' (an architecture id as the local step), whose
#: tensor-core launches a captured round records apart
LM_KERNELS = {
    "flash_attention_fwd": flash_attention.flash_attention_fwd,
    "flash_attention_bwd": flash_attention.flash_attention_bwd,
    "fused_softmax_xent_fwd": fused_xent.fused_softmax_xent_fwd,
    "fused_softmax_xent_bwd": fused_xent.fused_softmax_xent_bwd,
    "selective_scan_fwd": selective_scan.selective_scan_fwd,
    "selective_scan_bwd": selective_scan.selective_scan_bwd,
}

#: stats fields unpacked as integers (ids and counts are exact in float32:
#: fewer than 2**24 clients and iterations)
INT_STATS = {"ids": np.int64, "n_iters": np.int32,
             "client_uploaded": np.int32}


def _kernel_counts() -> Dict[str, int]:
    return {k: fn.launches
            for k, fn in {**FL_KERNELS, **LM_KERNELS}.items()}


def _tensor_core_counts() -> Dict[str, int]:
    return {k: fn.tensor_core_launches for k, fn in LM_KERNELS.items()
            if hasattr(fn, "tensor_core_launches")}


def _diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


class StatsLayout:
    """A round's stats dict <-> one float32 row: each field flattened in
    the order of the first dict seen."""

    def __init__(self, stats: Dict):
        self.fields = [(k, tuple(v.shape)) for k, v in stats.items()]
        self.width = sum(int(np.prod(s)) for _, s in self.fields)

    def pack(self, stats: Dict) -> torch.Tensor:
        return torch.cat([stats[k].reshape(-1).to(torch.float32)
                          for k, _ in self.fields])

    def unpack(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        """[b, W] float32 -> per-field [b, ...] arrays."""
        out, at = {}, 0
        for k, shape in self.fields:
            n = int(np.prod(shape))
            v = rows[:, at:at + n].reshape((rows.shape[0],) + shape)
            out[k] = v.astype(INT_STATS[k]) if k in INT_STATS else v
            at += n
        return out


def graph_node_count(graph) -> int:
    """The captured graph's node count (``cuGraphGetNodes`` on the kept
    ``cudaGraph_t``)."""
    lib = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    code = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                               ctypes.byref(n))
    if code != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {code}")
    return int(n.value)


class RoundProgram:
    """One device round over persistent buffers (see the module docstring).

    one_round   ``RoundEngine.make_device_round``'s function
    carry       the initial carry (copied into the program's buffers)
    block_size  rows of the stats and input buffers
    graphed     capture and replay the round (CUDA devices only)
    generators  the device generators the round draws from (registered
                with the graph)
    group       the data group of a sharded round (None: replicated)
    """

    def __init__(self, one_round: Callable, carry: Dict, block_size: int,
                 device, graphed: bool = False, generators=(), group=None):
        self.one_round = one_round
        self.device = torch.device(device)
        if graphed and self.device.type != "cuda":
            raise ValueError("a graphed round program needs a CUDA device")
        self.graphed = graphed
        self.group = group
        self.block_size = int(block_size)
        self.generators = tuple(generators)
        self.carry = tree_map(lambda v: v.clone(), carry)
        self.t = torch.zeros((), dtype=torch.int32, device=self.device)
        self.row = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self.inputs: Dict[str, torch.Tensor] = {}
        self.layout: Optional[StatsLayout] = None
        self.stats: Optional[torch.Tensor] = None
        self.graph = None
        self.replays = 0
        self.nodes: Optional[int] = None
        self.capture_ms = 0.0
        self.warmup_launches = {k: 0 for k in _kernel_counts()}
        self.per_replay = dict(self.warmup_launches)
        #: the flash and cross-entropy launches among those that took the
        #: tensor cores, one capture's
        self.per_replay_tensor_core = {k: 0 for k in _tensor_core_counts()}

    # -- state ----------------------------------------------------------
    def load(self, carry: Dict):
        """Copy ``carry`` into the program's buffers."""
        for dst, src in zip(tree_leaves(self.carry), tree_leaves(carry)):
            dst.copy_(src)

    def _snapshot(self):
        """The state the warm-up round changes, copied to the host: a
        device copy of a full-width LM's params would not fit beside the
        round (14.4 GB at Llama-3.2-3B)."""
        return ([v.to("cpu", copy=True) for v in tree_leaves(self.carry)]
                + [self.t.to("cpu", copy=True), self.row.to("cpu", copy=True)],
                [g.get_state() for g in self.generators])

    def _restore(self, snap):
        tensors, gens = snap
        for dst, src in zip(tree_leaves(self.carry) + [self.t, self.row],
                            tensors):
            dst.copy_(src)
        for g, s in zip(self.generators, gens):
            g.set_state(s)

    # -- blocks ---------------------------------------------------------
    def begin_block(self, t0: int, inputs: Dict[str, np.ndarray]):
        """Set the round index to ``t0`` and the row to 0, and copy the
        block's injected inputs ([b, ...] host arrays) into the static
        buffers (pinned and asynchronous on a CUDA device: no sync)."""
        cuda = self.device.type == "cuda"
        for name, arr in inputs.items():
            src = torch.from_numpy(np.ascontiguousarray(arr))
            buf = self.inputs.get(name)
            if buf is None:
                buf = self.inputs[name] = torch.zeros(
                    (self.block_size,) + tuple(src.shape[1:]),
                    dtype=src.dtype, device=self.device)
            if cuda:
                src = src.pin_memory()
            buf[:src.shape[0]].copy_(src, non_blocking=cuda)
        self.t.fill_(int(t0))
        self.row.zero_()

    def _step(self):
        """One round in place: read row ``row`` of the inputs, write the
        new carry and the stats row, advance ``t`` and ``row``."""
        row_in = {k: b.index_select(0, self.row)[0]
                  for k, b in self.inputs.items()}
        new, stats = self.one_round(self.carry, self.t, row_in)
        for dst, src in zip(tree_leaves(self.carry), tree_leaves(new)):
            if dst is not src:
                dst.copy_(src)
        if self.layout is None:
            self.layout = StatsLayout(stats)
            self.stats = torch.zeros((self.block_size, self.layout.width),
                                     dtype=torch.float32, device=self.device)
        self.stats.index_copy_(0, self.row, self.layout.pack(stats)[None])
        self.t.add_(1)
        self.row.add_(1)

    def capture(self):
        """Warm up one round on a side stream on a copy of the state, put
        the state back, and capture one round (graphed programs; call it
        after ``begin_block``, outside any sync check: capture itself
        synchronizes)."""
        if not self.graphed or self.graph is not None:
            return
        if self.group is not None:
            # the communicator is created by its first collective: make
            # it now, so that the capture records the round's only
            from repro_torch.launch.mesh import all_reduce_sum
            all_reduce_sum(torch.zeros(1, device=self.device))
        snap = self._snapshot()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        before = _kernel_counts()
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.warmup_launches = _diff(_kernel_counts(), before)
        self._restore(snap)
        del snap
        torch.cuda.synchronize(self.device)
        # the capture allocates from the graph's own pool, which cannot
        # take the blocks the warm-up left cached
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph(keep_graph=True)   # to count its nodes
        for g in self.generators:
            graph.register_generator_state(g)
        t0 = time.perf_counter()
        before, tc_before = _kernel_counts(), _tensor_core_counts()
        with torch.cuda.graph(graph):
            self._step()
        self.per_replay = _diff(_kernel_counts(), before)
        self.per_replay_tensor_core = _diff(_tensor_core_counts(), tc_before)
        self.nodes = graph_node_count(graph)
        graph.instantiate()
        torch.cuda.synchronize(self.device)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.graph = graph

    def run(self, b: int):
        """``b`` rounds from the current row: graph replays on a graphed
        program, eager rounds otherwise."""
        if self.graphed and self.graph is None:
            raise RuntimeError("capture() the round before running a block")
        for _ in range(b):
            if self.graphed:
                self.graph.replay()
                self.replays += 1
            else:
                self._step()

    def pull(self, b: int) -> Dict[str, np.ndarray]:
        """The block's stats rows, unpacked (the block's one host read)."""
        return self.layout.unpack(self.stats[:b].cpu().numpy())

    def launches(self) -> Dict[str, int]:
        """Real kernel launches of a graphed program (the FL and the LM
        kernels'): the warm-up's, then ``per_replay`` for each replay."""
        return {k: self.warmup_launches[k] + self.replays * v
                for k, v in self.per_replay.items()}


@contextlib.contextmanager
def sync_checked(device):
    """Inside, any synchronizing CUDA call raises
    (``torch.cuda.set_sync_debug_mode("error")``) on a CUDA device; the
    previous mode comes back on exit.  A no-op on the CPU."""
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
