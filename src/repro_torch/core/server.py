"""FedSAE server on the host driver: the training loop of the paper's Fig. 2.

Per round the server (1) draws every client's affordable workload and
selects a cohort (AL during the first ``al_rounds``, then the configured
strategy), (2) predicts each participant's task pair with Ira/Fassa (or
applies a baseline's fixed workload), (3) runs the packed round on the
device — gather, masked budgeted local SGD, the optional upload transform,
aggregation — and (4) updates
the history and the training values from the uploaded losses.  Baselines:
FedAvg (fixed workload, stragglers upload nothing), FedProx (ideal partial
work) and an oracle skyline.

Two drivers run that loop (``ServerConfig.driver``), as in the reference:

  host  (default) one Python iteration per round.  With the default
        ``rng_impl`` ("" = "numpy") everything but step (3) is numpy
        float64 on the host, copied from the reference's host driver, so
        the port reproduces selection, workloads, budgets and L/H/theta
        bit for bit from the same seeds; only the model init and the
        minibatch draws come from torch generators, and ``init_params=``
        and ``data_draws=`` replace them so a test can replay the
        reference's threefry draws.  With ``rng_impl="device"`` the whole
        server step runs on the device instead, one round at a time
        (``RoundEngine.make_device_round``: the float32 twins of
        prediction, Gumbel-top-k selection and the workload draws), with
        one host pull of the round's stats: arithmetically the scan
        driver's round.
  scan  the fast path: the same device round over blocks of
        ``block_size`` rounds, with one host pull of the block's stats
        (``host_syncs`` == blocks + evals) and the test-set eval at most
        once a block, at block ends where ``eval_every`` made a round due.
        On a CUDA device the round is captured once as a CUDA graph and
        replayed once a round, with no host read inside a block
        (``core.graphs``: any synchronizing call there raises); on the
        CPU it runs eagerly.  The scan driver requires the device streams.

The device streams are the port's own: torch generators on the server's
device, one seeded from ``selection_seed`` for the heterogeneity normals
and the selection's Gumbel noise (drawn in that order each round), and the
minibatch generator seeded from ``seed``.  So a scan run is bitwise the
host driver's run with ``rng_impl="device"`` and the same seeds, never
the numpy host driver's.  ``device_draws(t) -> (z, g)`` or ``(z, g, u)``
replaces round t's normals ``z`` [N], Gumbel noise ``g`` [N] and data
uniforms ``u`` ([K, max_iters, B] iid, [K, max_n] shuffle); a dict with
those keys may also give ``E`` [N], the affordable workloads themselves,
in place of ``z``.  It is the seam the parity tests replay the
reference's draws through, and the one that works inside a graph
(``data_draws=`` reads the cohort on the host and is refused by the scan
driver on a CUDA device).

With ``upload_compress="topk_q8"`` every uploading client's delta is
top-k sparsified and int8 quantised with error feedback
(``core.compression``); the server keeps the [N, P] float32 residual on
its device and replaces it with each round's output.

``ServerConfig`` has every field of the reference's, each at the
reference's default.  ``backend`` takes "xla" and "pallas" and both run the
same code: the port dispatches by device (the hand-written kernels on a
CUDA tensor, their plain versions on the CPU), not by backend; so do
``fused_generic=True`` and ``False`` (the device round walks every budget
slot masked either way).  Every aggregator of the reference's registry
runs, with ``trim_ratio``, ``agg_weighted`` and ``n_byzantine`` passed to
it as the reference passes them.  The grouped sub-configs ``compute=``
(``ComputeConfig``), ``comm=`` (``CommConfig``) and ``robustness=``
(``RobustnessConfig``) reconcile with their flat twins as the
reference's do: a group sets the flat fields it owns, conflicting
explicit values raise, and a flat grouped field given without its group
warns (``DeprecationWarning``).

Client-axis sharding (``mesh_shards=S``): one process per shard in a
``torch.distributed`` default process group of world size S, which the
caller creates (``launch.mesh.spawn_world``, ``fl_train --shards``,
torchrun); the server raises without one, as the reference's
``make_data_mesh`` does.  Every rank builds the same server from the same
seeds and runs the same host algebra, so L/H/theta, the values and the
history stay replicated; it holds only its own block of clients
(``PackedClients.shard``) and, under compression, its own ``[C, P]``
residual rows, and the round trains only the cohort slots it owns
(``RoundEngine.make_packed_round(mesh=)``).  Only rank 0 emits into the
sink, prints progress and writes checkpoints.  ``cohort_capacity``
("full", "auto" or an int; sharded only) compacts each rank's owned
slots into a dense lane block: an overflowed slot goes through the crash
branch with E~ = 0, is counted in ``overflowed`` (and ``dropped``) and,
with telemetry, the records carry each shard's ``lane_occupancy``.  On
the card the ranks take one card each over NCCL and the scan driver
captures the round's collectives in its graph; gloo (the CPU's backend,
or two ranks on one card) runs the host drivers only.
``prefetch="double_buffer"`` is accepted and refused where the
reference refuses it (an unknown mode; the scan driver on a mesh), and
runs the same single-round program as ``prefetch="off"``: the reference's
prefetch reorders the same operations into the same bits, and on the
card a round's prepare cannot overlap the previous round's execute,
whose values it reads.

Failure handling, as in the reference: every failure the server
tolerates funnels into the zero-budget crash branch of the Ira/Fassa
history update.  ``cfg.faults`` (a ``faults.FaultModel``) reshapes the
affordable-workload draw before selection (diurnal off-duty clients get
E = 0, Pareto-slowed ones E / slowdown), drops clients mid-round
(``dropout_prob``) and corrupts uploads.  A screened corrupt mode
(nan/inf/explode) trains with its real budget and transmits garbage,
while the history observes a crash; the upload screen (``upload_screen``,
on by default whenever faults are set) rejects the garbage before the
aggregator, so the run's params, history, cohorts and residuals are
bitwise its ``corrupt="crash"`` twin's.  ``sign_flip`` passes the screen
and is left to the robust aggregators.  Quarantine
(``quarantine_threshold > 0``; the screen and the device streams
required) suspends repeat offenders from selection through the device
Gumbel-top-k's eligibility mask.  The fault draws are the port's own host
stream (``faults.inject``); ``fault_draws=`` replaces them (the device
drivers copy a block's draws to the device once, before it).
``run(checkpoint_dir=, checkpoint_every=, resume=)`` writes atomic
whole-server checkpoints and resumes from the latest bitwise
(``repro_torch.checkpoint``); the scan driver checkpoints at block
boundaries.

Telemetry (``repro_torch.obs``), as in the reference: every executed
round becomes a :class:`~repro_torch.obs.schema.RoundRecord`, built by
``record_from_row`` and emitted by ``_emit_round`` into an internal
``RingBufferSink`` (``history`` and ``wall_times`` are views over it) and
into the caller's ``sink=`` (e.g. a ``JsonlSink``).  A sink switches
telemetry on unless ``telemetry=False``; then each record also carries the
per-client upload outcomes, the upload-byte ledger and the loss and
workload histograms, computed in numpy from the losses the round has
already pulled (the device drivers compute them on the device, into the
stats the round or block pulls anyway), so ``host_syncs`` (device-to-host
pulls) and the run's bits are the same with telemetry on or off.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.fl_state import (restore_server_state,
                                             save_server_state)
from repro_torch.convert import params_from_reference
from repro_torch.core import compression as comp
from repro_torch.core import prediction as pred
from repro_torch.core.aggregation import get_aggregator
from repro_torch.core.engine import BACKENDS, RoundEngine
from repro_torch.core.graphs import RoundProgram, sync_checked
from repro_torch.core.heterogeneity import HeterogeneitySim
from repro_torch.core.rounds import make_eval_fn
from repro_torch.core.selection import (ValueTracker, cohort_overflow,
                                        get_selection, resolve_capacity,
                                        select_active)
from repro_torch.data.federated import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_data_group
from repro_torch.faults.inject import (apply_availability_stragglers,
                                       block_fault_draws, round_fault_draws)
from repro_torch.models.fl_models import resolve_local_step
from repro_torch.obs.profiling import (
    SPAN_BLOCK, SPAN_BLOCK_CAPTURE, SPAN_BLOCK_CHECKPOINT, SPAN_BLOCK_EVAL,
    SPAN_BLOCK_INPUTS, SPAN_BLOCK_PULL, SPAN_BLOCK_RECORDS, SPAN_BLOCK_REPLAY,
    SPAN_BLOCK_UPLOAD, SPAN_HISTORY, stage)
from repro_torch.obs.schema import (HISTORY_KEYS, LOSS_HIST_BINS,
                                    LOSS_HIST_MAX, WORKLOAD_HIST_BINS,
                                    RoundRecord, histogram_counts,
                                    record_from_row,
                                    records_from_block_stats)
from repro_torch.obs.sinks import NullSink, RingBufferSink, Sink
from repro_torch.tree import tree_map

ALGOS = ("ira", "fassa", "fedavg", "fedprox", "oracle")
DRIVERS = ("host", "scan")
RNG_IMPLS = ("numpy", "device")
PREFETCH_MODES = ("off", "double_buffer")

UPLOAD_SCREENS = ("auto", "on", "off")


@dataclasses.dataclass
class ComputeConfig:
    """How the round executes: driver, backend, mesh and lane budget."""
    backend: str = "xla"         # xla | pallas
    driver: str = "host"         # host | scan
    block_size: int = 16         # rounds per device block (driver="scan")
    rng_impl: str = ""           # "" auto | numpy | device
    mesh_shards: int = 0         # 0 = replicated clients
    cohort_capacity: object = "full"
    prefetch: str = "off"        # off | double_buffer (runs the off
                                 # program: the same bits)
    fused_generic: bool = True   # True and False run the same walk


@dataclasses.dataclass
class CommConfig:
    """What crosses the wire: the upload-transform stage."""
    upload_compress: str = "none"   # none | topk_q8
    topk_frac: float = 0.1


@dataclasses.dataclass
class RobustnessConfig:
    """Fault injection and the defenses in front of aggregation."""
    faults: object = None           # Optional[repro_torch.faults.FaultModel]
    upload_screen: str = "auto"     # auto | on | off
    screen_norm_bound: float = 1e4
    quarantine_threshold: float = 0.0
    quarantine_rounds: int = 16
    quarantine_min_tries: int = 3


# grouped sub-config -> the flat ServerConfig fields it owns (the flat
# spellings stay accepted; see ServerConfig.__post_init__)
_CONFIG_GROUPS = {
    "compute": ComputeConfig,
    "comm": CommConfig,
    "robustness": RobustnessConfig,
}


@dataclasses.dataclass
class ServerConfig:
    algo: str = "ira"            # ira | fassa | fedavg | fedprox | oracle
    n_selected: int = 10         # K
    lr: float = 0.03
    batch_size: int = 10
    rounds: int = 100
    fixed_epochs: float = 15.0   # FedAvg/FedProx assigned workload E
    h_cap: float = 24.0          # cap on predicted H (bounds the budget)
    init_pair: tuple = (1.0, 2.0)
    U: float = 10.0              # Ira inverse-ratio increment
    alpha: float = 0.95          # Fassa EMA smoothing
    gamma1: float = 3.0
    gamma2: float = 1.0
    al_rounds: int = 0           # use AL selection for the first n rounds
    beta: float = 0.01           # AL softmax scale
    prox_mu: float = 0.1         # FedProx proximal weight
    aggregator: str = "fedavg"   # core.aggregation.AGGREGATORS
    selection: str = "random"    # post-AL strategy (core.selection)
    sampling: str = "shuffle"    # shuffle (paper default) | iid (fused
                                 # MCLR / MLP local-SGD kernels)
    backend: str = "xla"         # xla | pallas: the same code either way
                                 # (kernels on a CUDA device, their plain
                                 # versions on the CPU)
    seed: int = 0
    selection_seed: int = 1234   # fixed across frameworks (paper §IV-A)
    eval_every: int = 1
    model: object = None         # None | "mclr" | "mlp" | "lstm" | an
                                 # arch id (its smoke config as a causal
                                 # LM: models.api.from_model) | a
                                 # LocalStep
    upload_compress: str = "none"  # none | topk_q8 (top-k + int8 with
                                   # error feedback: core.compression)
    topk_frac: float = 0.1       # kept-coordinate fraction for "topk_q8"
    device: Optional[str] = None  # None = cuda; "cpu" on request
    trim_ratio: float = 0.1      # trimmed_mean: fraction trimmed per end
    agg_weighted: bool = False   # robust aggregators weight by n_k
    n_byzantine: int = 0         # krum / bulyan: assumed byzantine uploads
    faults: object = None        # None | faults.FaultModel: diurnal
                                 # availability, Pareto stragglers, seeded
                                 # dropouts and corrupted uploads
    upload_screen: str = "auto"  # finite/norm screen before aggregation:
                                 # "auto" = on iff faults is set, "on",
                                 # "off" (faults.screen)
    screen_norm_bound: float = 1e4  # reject uploads whose delta l2 norm
                                    # exceeds this (and non-finite ones)
    quarantine_threshold: float = 0.0  # suspend clients whose screened-
                                       # failure rate exceeds this (0 =
                                       # off; needs the screen and the
                                       # device rng streams)
    quarantine_rounds: int = 16
    quarantine_min_tries: int = 3
    driver: str = "host"         # host | scan (blocks of block_size rounds,
                                 # one stats pull a block)
    block_size: int = 16
    rng_impl: str = ""           # "" auto (numpy on host, device on scan)
                                 # | numpy | device
    fused_generic: bool = True   # True and False run the same walk
    mesh_shards: int = 0         # client-axis shards: one process each in
                                 # the torch.distributed default group
    cohort_capacity: object = "full"  # per-shard lanes: "full" (masked
                                      # K lanes), "auto" or an int
    prefetch: str = "off"        # off | double_buffer (scan driver)
    # grouped sub-configs (``None`` = derive from the flat fields above).
    # Passing a group sets its flat twins; passing a flat grouped kwarg
    # without the group still works but warns.
    compute: Optional[ComputeConfig] = None
    comm: Optional[CommConfig] = None
    robustness: Optional[RobustnessConfig] = None

    def __post_init__(self):
        """Reconcile the grouped sub-configs with their flat twins, rule for
        rule as the reference:

          * group given, flat at its default          -> group value
          * group given, flat explicitly set          -> flat value iff the
            group left that field at ITS default (a ``dataclasses.replace``
            on the flat spelling keeps working); conflicting explicit
            values raise
          * group omitted, flat explicitly set        -> flat value, with a
            ``DeprecationWarning`` steering callers to the group
          * neither                                   -> shared default

        Afterwards the groups are rebuilt from the final flat values, so
        ``cfg.compute.driver`` and ``cfg.driver`` never disagree."""
        import warnings

        for group_name, group_cls in _CONFIG_GROUPS.items():
            group = getattr(self, group_name)
            deprecated = []
            for f in dataclasses.fields(group_cls):
                flat = getattr(self, f.name)
                flat_set = not _cfg_eq(flat, f.default)
                if group is not None:
                    gval = getattr(group, f.name)
                    gset = not _cfg_eq(gval, f.default)
                    if flat_set and gset and not _cfg_eq(flat, gval):
                        raise ValueError(
                            f"ServerConfig: {f.name}={flat!r} conflicts "
                            f"with {group_name}.{f.name}={gval!r} — set it "
                            "in one place")
                    if not flat_set:
                        object.__setattr__(self, f.name, gval)
                elif flat_set:
                    deprecated.append(f.name)
            if deprecated:
                warnings.warn(
                    f"flat ServerConfig kwarg(s) {deprecated} are "
                    f"deprecated; group them in {group_name}="
                    f"{group_cls.__name__}(...)",
                    DeprecationWarning, stacklevel=3)
            object.__setattr__(self, group_name, group_cls(**{
                f.name: getattr(self, f.name)
                for f in dataclasses.fields(group_cls)}))
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; choose "
                             f"from {BACKENDS}")
        if self.algo not in ALGOS:
            raise ValueError(f"unknown algo {self.algo!r}; choose from "
                             f"{ALGOS}")


def _cfg_eq(a, b) -> bool:
    """Identity-tolerant equality for config values (FaultModel instances
    may not define __eq__; None-vs-None and is-comparison cover them)."""
    if a is b:
        return True
    try:
        return bool(a == b)
    except Exception:
        return False


def _aggregator_kwargs(cfg: ServerConfig) -> Dict:
    """The keyword arguments ``cfg.aggregator`` takes from the config, as
    the reference's server passes them."""
    if cfg.aggregator == "trimmed_mean":
        return dict(trim_ratio=cfg.trim_ratio, weighted=cfg.agg_weighted)
    if cfg.aggregator == "fedprox":
        return dict(prox_mu=cfg.prox_mu)
    if cfg.aggregator in ("median", "geometric_median"):
        return dict(weighted=cfg.agg_weighted)
    if cfg.aggregator in ("krum", "bulyan"):
        return dict(n_byzantine=cfg.n_byzantine, weighted=cfg.agg_weighted)
    return {}


class FedSAEServer:
    """The FedSAE training loop on the host driver.

    ``init_params`` (a dict of numpy arrays, e.g. the reference's init)
    replaces the torch init.  ``data_draws(t, ids, n)``, given round t's
    numpy cohort and sample counts, returns that round's minibatch draws
    (idx [K, max_iters, B] for iid, u [K, max_n] for shuffle) in place of
    the device generator's.  ``fault_draws(t)`` returns round t's fault
    draws as ``faults.round_fault_draws`` does (``slowdown`` float32 [N],
    ``dropout`` and ``corrupt`` bool [N], each None when its axis is off)
    in place of the port's fault stream.  ``device_draws(t)`` returns
    round t's ``(z, g)``, ``(z, g, u)`` or a dict of them (``E`` in
    place of ``z``), numpy float32, in place of the device streams' (see
    the module docstring).  ``sink`` receives every
    round's record; ``telemetry`` (default: on iff a sink is given) adds
    the extras."""

    def __init__(self, dataset: FederatedDataset, model=None,
                 cfg: Optional[ServerConfig] = None,
                 het: Optional[HeterogeneitySim] = None,
                 init_params=None,
                 data_draws: Optional[Callable] = None,
                 sink: Optional[Sink] = None,
                 telemetry: Optional[bool] = None,
                 fault_draws: Optional[Callable] = None,
                 device_draws: Optional[Callable] = None):
        cfg = cfg if cfg is not None else ServerConfig()
        if cfg.driver not in DRIVERS:
            raise ValueError(
                f"unknown driver {cfg.driver!r}; choose from {DRIVERS}")
        self.rng_impl = cfg.rng_impl or (
            "device" if cfg.driver == "scan" else "numpy")
        if self.rng_impl not in RNG_IMPLS:
            raise ValueError(f"unknown rng_impl {cfg.rng_impl!r}; choose "
                             f"from {RNG_IMPLS}")
        if cfg.driver == "scan" and self.rng_impl != "device":
            raise ValueError("driver='scan' requires the device rng streams")
        # "auto" turns the upload screen on exactly when a fault model is
        # configured, so fault-free runs keep the plain round
        if cfg.upload_screen not in UPLOAD_SCREENS:
            raise ValueError(
                f"unknown upload_screen {cfg.upload_screen!r}; choose "
                f"from {UPLOAD_SCREENS}")
        self.screening = cfg.upload_screen == "on" or (
            cfg.upload_screen == "auto" and cfg.faults is not None)
        self._quarantine = float(cfg.quarantine_threshold or 0.0) > 0.0
        if self._quarantine:
            if not self.screening:
                raise ValueError(
                    "quarantine_threshold > 0 requires the upload screen "
                    "(it counts screened failures) — set upload_screen="
                    "'on' or configure faults")
            if self.rng_impl != "device":
                raise ValueError(
                    "quarantine needs the device rng streams (eligibility "
                    "masks thread through the device Gumbel-top-k); set "
                    "rng_impl='device'")
            if cfg.mesh_shards:
                raise ValueError(
                    "quarantine is not supported on a sharded mesh — run "
                    "it on the replicated drivers")
        if cfg.prefetch not in PREFETCH_MODES:
            raise ValueError(f"unknown prefetch mode {cfg.prefetch!r}; "
                             f"choose from {PREFETCH_MODES}")
        if cfg.driver == "scan" and cfg.prefetch != "off" and \
                cfg.mesh_shards:
            raise ValueError(
                "prefetch=\"double_buffer\" is not supported on a sharded "
                "mesh yet (the prepared bundle would need per-shard "
                "carries through shard_map; run prefetch on the "
                "replicated scan driver)")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        # the client-axis group (None: replicated); its rank alone writes
        self.group = (make_data_group(cfg.mesh_shards, self.device)
                      if cfg.mesh_shards else None)
        self.rank = 0 if self.group is None else self.group.rank
        if self.group is not None:
            self.device = self.group.device
        self.graphed = cfg.driver == "scan" and self.device.type == "cuda"
        if self.graphed and self.group is not None and \
                torch.distributed.get_backend() != "nccl":
            raise ValueError(
                f"the scan driver captures the round, collectives included, "
                f"as a CUDA graph, and a "
                f"{torch.distributed.get_backend()} group's collectives "
                f"cannot be captured: use the nccl backend (one rank a "
                f"card) or driver='host' with rng_impl='device'")
        if self.graphed and data_draws is not None:
            raise ValueError(
                "data_draws= reads the cohort on the host, which a captured "
                "scan round cannot; inject the data uniforms through "
                "device_draws=")
        self.ds = dataset
        self.model = resolve_local_step(
            model if model is not None else cfg.model, dataset)
        self.het = het or HeterogeneitySim(dataset.n_clients, seed=cfg.seed)
        N = dataset.n_clients
        self.L = np.full(N, cfg.init_pair[0], np.float64)
        self.H = np.full(N, cfg.init_pair[1], np.float64)
        self.theta = np.full(N, 0.5 * sum(cfg.init_pair), np.float64)
        self.values = ValueTracker(N, dataset.sizes.astype(np.float64))
        # reliability quarantine counters (host mirrors; the device drivers
        # carry them on the device and sync them back with the history)
        self.q_fail = np.zeros(N, np.int32)
        self.q_try = np.zeros(N, np.int32)
        self.q_susp = np.zeros(N, np.int32)
        self.sel_rng = np.random.default_rng(cfg.selection_seed)
        self.data_gen = torch.Generator(self.device).manual_seed(cfg.seed)
        # the device streams' selection + heterogeneity generator
        self.sel_gen = torch.Generator(self.device).manual_seed(
            cfg.selection_seed)
        self.data_draws = data_draws
        self.fault_draws = fault_draws
        self.device_draws = device_draws
        # per-client diurnal phase offsets (seeded, drawn once)
        self._phases = (cfg.faults.phases(N) if cfg.faults is not None
                        else None)
        self.params = (
            self.model.init_params(
                torch.Generator(self.device).manual_seed(cfg.seed + 7))
            if init_params is None
            else params_from_reference(init_params, self.device))

        self.sizes = dataset.sizes
        self.max_n = int(self.sizes.max())
        tau_max = math.ceil(self.max_n / cfg.batch_size)
        budget = max(cfg.h_cap, cfg.fixed_epochs)
        self.max_iters = int(math.ceil(budget * tau_max))
        if self.group is None:
            self.packed = dataset.packed(self.max_n, device=self.device)
            self.sizes_dev = self.packed.lengths
        else:
            whole = dataset.packed(self.max_n, shards=cfg.mesh_shards)
            self.packed = whole.shard(self.rank, self.device)
            # the [S * C] global client lengths, ghost rows 0: replicated
            self.sizes_dev = whole.lengths.reshape(-1).to(self.device)
        # per-shard executed lanes (None: the masked full-K mode)
        self.capacity = resolve_capacity(cfg.cohort_capacity,
                                         cfg.n_selected, cfg.mesh_shards)
        self.test_x = torch.from_numpy(dataset.test_x).to(self.device)
        self.test_y = torch.from_numpy(dataset.test_y).to(self.device)

        self.engine = RoundEngine(
            lr=cfg.lr, aggregator=get_aggregator(cfg.aggregator,
                                                 **_aggregator_kwargs(cfg)),
            prox_mu=cfg.prox_mu if cfg.algo == "fedprox" else None,
            compress=cfg.upload_compress, topk_frac=cfg.topk_frac,
            faults=cfg.faults,
            screen_norm=cfg.screen_norm_bound if self.screening else None)
        # error-feedback state: one [P] float32 row per client (None when
        # the upload transform is off); sharded, this rank's C clients'
        n_params = comp.n_params_of(self.params)
        n_rows = (dataset.n_clients if self.group is None
                  else self.packed.clients_per_shard)
        self.residual = (
            torch.zeros((n_rows, n_params), dtype=torch.float32,
                        device=self.device)
            if self.engine.compressing else None)
        self.bytes_per_client = comp.upload_bytes_per_client(
            n_params, cfg.upload_compress, cfg.topk_frac)
        self.dense_bytes_per_client = comp.upload_bytes_per_client(
            n_params, "none")
        self.round_fn = self.engine.make_packed_round(
            self.model, cfg.batch_size, self.max_iters, self.packed.max_n,
            sampling=cfg.sampling, mesh=self.group, capacity=self.capacity,
            sizes=self.sizes_dev)
        self.select_fn = get_selection(cfg.selection)
        self.eval_fn = make_eval_fn(self.model)
        self.block_size = max(1, int(cfg.block_size))
        self.program: Optional[RoundProgram] = None   # the device round
        self.cohorts: List[np.ndarray] = []
        self.budgets: List[np.ndarray] = []   # [K] n_iters per round
        self.telemetry = (bool(telemetry) if telemetry is not None
                          else sink is not None)
        # rank 0 alone emits: every rank keeps the same records
        self.sink: Sink = (sink if sink is not None and self.rank == 0
                           else NullSink())
        self._records = RingBufferSink()
        self.host_syncs = 0                   # device->host pulls

    # ------------------------------------------------------------------
    @property
    def history(self) -> Dict[str, List[float]]:
        """Dict of lists keyed by ``HISTORY_KEYS`` (in that order), one
        entry per recorded round, NaN where a round has no value: a view
        over the records."""
        recs = self._records.records
        return {k: [getattr(r, k) for r in recs] for k in HISTORY_KEYS}

    @property
    def wall_times(self) -> List[float]:
        """Seconds per ``run()`` round, eval included (the records'
        ``wall_time_s``)."""
        return [r.wall_time_s for r in self._records.records]

    def _emit_round(self, record: RoundRecord):
        """Every executed round flows through here."""
        self._records.emit(record)
        self.sink.emit(record)

    def _lane_occupancy(self, ids) -> Optional[List[float]]:
        """Each shard's executed-lane occupancy for the cohort ``ids``
        (host side, from the already-pulled cohort): owned slots over K,
        or kept slots over the capacity.  None when replicated."""
        if self.group is None:
            return None
        S = self.cfg.mesh_shards
        counts = np.bincount(np.asarray(ids)
                             // self.packed.clients_per_shard,
                             minlength=S)[:S]
        if self.capacity is not None:
            return (np.minimum(counts, self.capacity)
                    / float(self.capacity)).tolist()
        return (counts / float(self.cfg.n_selected)).tolist()

    def _progress_line(self, tag: str, label: str, rec: RoundRecord,
                       overflowed: float) -> str:
        """The progress line of both drivers; ``overflowed=`` with a
        capacity."""
        ovf = ("" if self.capacity is None
               else f" overflowed={overflowed:.0f}")
        return (f"[{tag}] {label} acc={rec.acc:.3f} "
                f"dropout={rec.dropout:.2f} "
                f"loss={rec.train_loss:.3f}{ovf}")

    # ------------------------------------------------------------------
    def _workloads(self, ids: np.ndarray, E_true: np.ndarray):
        """Per-participant uploaded epochs + history update. Returns
        (e_eff, outcome, assigned)."""
        cfg = self.cfg
        if cfg.algo == "oracle":
            # skyline: the server knows E~ in advance and assigns exactly
            # the affordable workload (upper bound for any predictor)
            e_eff = np.minimum(E_true, cfg.h_cap)
            outcome = np.where(e_eff > 0, pred.COMPLETED_H, pred.DROPPED)
            assigned = e_eff.copy()
        elif cfg.algo == "fedavg":
            ok = E_true >= cfg.fixed_epochs
            e_eff = np.where(ok, cfg.fixed_epochs, 0.0)
            outcome = np.where(ok, pred.COMPLETED_H, pred.DROPPED)
            assigned = np.full(len(ids), cfg.fixed_epochs)
        elif cfg.algo == "fedprox":
            e_eff = np.minimum(E_true, cfg.fixed_epochs)
            outcome = np.where(E_true >= cfg.fixed_epochs, pred.COMPLETED_H,
                               np.where(e_eff > 0, pred.COMPLETED_L,
                                        pred.DROPPED))
            assigned = np.full(len(ids), cfg.fixed_epochs)
        else:
            L, H = self.L[ids], self.H[ids]
            assigned = H.copy()
            e_eff = pred.uploaded_epochs(L, H, E_true)
            if cfg.algo == "ira":
                L2, H2, outcome = pred.ira_predict(L, H, E_true, U=cfg.U,
                                                   h_cap=cfg.h_cap)
            else:
                L2, H2, outcome = pred.fassa_predict(
                    L, H, E_true, self.theta[ids], cfg.gamma1, cfg.gamma2,
                    h_cap=cfg.h_cap)
                self.theta[ids] = pred.fassa_threshold(
                    self.theta[ids], E_true, cfg.alpha)
            self.L[ids], self.H[ids] = L2, H2
        return e_eff, outcome, assigned

    def _round_fault_draws(self, t: int) -> Optional[Dict]:
        """Round t's fault draws (None without a fault model)."""
        fm = self.cfg.faults
        if fm is None:
            return None
        if self.fault_draws is not None:
            return self.fault_draws(t)
        return round_fault_draws(fm, t, self.ds.n_clients)

    def _draw_round_inputs(self, t: int, fd: Optional[Dict] = None):
        """(E_true_all [N], ids [K]) for round t from the numpy streams,
        shaped by round t's fault draws ``fd``."""
        cfg = self.cfg
        E_true_all = self.het.sample_round()
        if cfg.faults is not None:
            # the float64 twin of the reference's device adjustment
            E_true_all = apply_availability_stragglers(
                cfg.faults, self._phases, t, E_true_all, fd["slowdown"])
        if t < cfg.al_rounds:
            ids = select_active(self.sel_rng, self.values.v, cfg.n_selected,
                                cfg.beta)
        else:
            ids = self.select_fn(self.sel_rng, self.values.v,
                                 self.ds.n_clients, cfg.n_selected, cfg.beta)
        return E_true_all, ids

    # ------------------------------------------------------------------
    # the device drivers: the server step on the device (core.graphs)
    # ------------------------------------------------------------------
    def device_state(self) -> Dict:
        """The device round's carry, built from the host-side state
        (float32 history and values, int32 quarantine counters)."""
        dev, f32 = self.device, torch.float32
        state = {
            "params": self.params,
            "L": torch.as_tensor(self.L).to(dev, f32),
            "H": torch.as_tensor(self.H).to(dev, f32),
            "theta": torch.as_tensor(self.theta).to(dev, f32),
            "values": torch.as_tensor(self.values.v).to(dev, f32),
        }
        if self._quarantine:
            for name in ("q_fail", "q_try", "q_susp"):
                state[name] = torch.as_tensor(
                    getattr(self, name)).to(dev, torch.int32)
        if self.residual is not None:
            state["residual"] = self.residual
        return state

    def _absorb_state(self, state: Dict):
        """Copy the device carry back into the host-side state (float64
        containers hold the float32 values exactly)."""
        self.params = None      # free the old copy before the clone
        self.params = tree_map(torch.clone, state["params"])
        for name in ("L", "H", "theta"):
            setattr(self, name, state[name].cpu().numpy().astype(np.float64))
        self.values.v = state["values"].cpu().numpy().astype(np.float64)
        if self._quarantine:
            for name in ("q_fail", "q_try", "q_susp"):
                setattr(self, name, state[name].cpu().numpy())
        if self.residual is not None:
            self.residual = state["residual"].clone()

    def _program_loaded(self) -> RoundProgram:
        """The device round program, built on first use, its carry loaded
        from the host-side state."""
        if self.program is None:
            cfg = self.cfg
            mu, sigma = self.het.device_params(self.device)
            phases = (None if self._phases is None
                      else torch.as_tensor(self._phases).to(self.device))
            one_round = self.engine.make_device_round(
                self.model, cfg.batch_size, self.max_iters, self.packed, cfg,
                mu=mu, sigma=sigma, sel_gen=self.sel_gen,
                data_gen=self.data_gen, phases=phases,
                telemetry=self.telemetry, data_draws=self.data_draws,
                mesh=self.group, capacity=self.capacity,
                sizes=self.sizes_dev)
            self.program = RoundProgram(
                one_round, self.device_state(),
                self.block_size if self.cfg.driver == "scan" else 1,
                self.device, graphed=self.graphed,
                generators=(self.sel_gen, self.data_gen), group=self.group)
        else:
            self.program.load(self.device_state())
        return self.program

    def _block_inputs(self, t0: int, b: int) -> Dict[str, np.ndarray]:
        """Rounds t0 .. t0 + b - 1's injected inputs, stacked: the fault
        draws and ``device_draws``'s (z, g[, u])."""
        out = {}
        if self.cfg.faults is not None:
            out.update(block_fault_draws(self.cfg.faults, t0, b,
                                         self.ds.n_clients,
                                         self.fault_draws))
        if self.device_draws is not None:
            rows = [self.device_draws(t) for t in range(t0, t0 + b)]
            rows = [r if isinstance(r, dict) else dict(zip("zgu", r))
                    for r in rows]
            for name in rows[0]:
                out[name] = np.stack([np.asarray(r[name], np.float32)
                                      for r in rows])
        return out

    def _take_block(self, stats: Dict, t0: int, b: int):
        """Records (acc and test_loss left for the caller), cohorts and
        budgets of a pulled block of stats."""
        self.cohorts.extend(np.asarray(stats["ids"]))
        self.budgets.extend(np.asarray(stats["n_iters"]))
        recs = records_from_block_stats(stats, t0, b)
        if self.telemetry and self.group is not None:
            for rec, ids in zip(recs, stats["ids"]):
                rec.lane_occupancy = self._lane_occupancy(ids)
        return recs

    def _device_round(self, t: int) -> RoundRecord:
        """Round t on the device, eagerly (the host driver with
        ``rng_impl="device"``): one pull of its stats."""
        prog = self.program
        prog.begin_block(t, self._block_inputs(t, 1))
        prog.run(1)
        stats = prog.pull(1)
        self.host_syncs += 1
        return self._take_block(stats, t, 1)[0]

    def _scan_block(self, prog: RoundProgram, t0: int, b: int, T: int,
                    verbose: bool, checkpoint_dir: Optional[str],
                    checkpoint_every: int) -> int:
        """Rounds t0 .. t0 + b - 1 of the scan driver, each part of the
        block's host work in its span; returns the next round."""
        cfg = self.cfg
        start = time.perf_counter()
        with stage(SPAN_BLOCK_INPUTS):
            inputs = self._block_inputs(t0, b)
        if prog.graphed and prog.graph is None:
            with stage(SPAN_BLOCK_CAPTURE):
                prog.begin_block(t0, inputs)
                prog.capture()                # synchronizes: outside
        with sync_checked(self.device):       # no host read in a block
            with stage(SPAN_BLOCK_UPLOAD):
                prog.begin_block(t0, inputs)
            with stage(SPAN_BLOCK_REPLAY):
                prog.run(b)
        with stage(SPAN_BLOCK_PULL):
            stats = prog.pull(b)              # the block's one host pull
        self.host_syncs += 1
        prev = self._records.last
        prev_acc = prev.acc if prev is not None else float("nan")
        acc, tl = prev_acc, float("nan")
        if (t0 + b == T) or any((t0 + i) % cfg.eval_every == 0
                                for i in range(b)):
            with stage(SPAN_BLOCK_EVAL):
                acc, tl = self.eval_fn(prog.carry["params"], self.test_x,
                                       self.test_y)
                acc, tl = float(acc), float(tl)
            self.host_syncs += 1              # ...plus the eval readback
        # the records carry the eval's accuracy, so they follow it
        with stage(SPAN_BLOCK_RECORDS):
            recs = self._take_block(stats, t0, b)
            wall = time.perf_counter() - start
            for i, rec in enumerate(recs):
                last = i == b - 1
                rec.acc = acc if last else prev_acc
                rec.test_loss = tl if last else float("nan")
                rec.wall_time_s = wall / b
                self._emit_round(rec)
            if verbose:
                print(self._progress_line(
                    f"{cfg.algo}/scan", f"rounds {t0:3d}-{t0 + b - 1:3d}",
                    recs[-1], float(np.sum(stats["overflowed"]))))
        t0 += b
        if checkpoint_dir and (
                (checkpoint_every > 0 and t0 % checkpoint_every == 0)
                or t0 == T):
            # block boundaries only: align checkpoint_every with
            # block_size for a resumed run's eval cadence to match
            with stage(SPAN_BLOCK_CHECKPOINT):
                self._absorb_state(prog.carry)
                save_server_state(self, checkpoint_dir, t0)
        return t0

    def _run_scan(self, T: int, verbose: bool, t_start: int,
                  checkpoint_dir: Optional[str], checkpoint_every: int):
        """The scan driver: blocks of ``block_size`` rounds, one stats pull
        a block, the eval at block ends where a round was due."""
        prog = self._program_loaded()
        t0 = t_start
        while t0 < T:
            b = min(self.block_size, T - t0)
            with stage(SPAN_BLOCK):
                t0 = self._scan_block(prog, t0, b, T, verbose,
                                      checkpoint_dir, checkpoint_every)
        self._absorb_state(prog.carry)

    # ------------------------------------------------------------------
    def run_round(self, t: int) -> Dict:
        """Round t on the host driver; returns its stats row.  With
        ``rng_impl="device"`` the round runs on the device and the
        host-side state is synced back after it."""
        if self.rng_impl == "device":
            self._program_loaded()
            rec = self._device_round(t)
            self._absorb_state(self.program.carry)
            row = dataclasses.asdict(rec)
            row["n_iters"] = self.budgets[-1]
            return row
        cfg = self.cfg
        fm = cfg.faults
        fd = self._round_fault_draws(t)
        E_true_all, ids = self._draw_round_inputs(t, fd)
        E_true = E_true_all[ids]
        # capacity overflow: the slots the per-shard lane budget drops
        # never run, E~ = 0 takes them through the crash branch
        ovf = (np.zeros(len(ids), bool) if self.capacity is None
               else cohort_overflow(ids, self.packed.clients_per_shard,
                                    self.capacity).numpy())
        # seeded mid-round dropouts zero the workload; screened corruption
        # modes zero the OBSERVED workload, so Ira/Fassa evolves bitwise
        # like the crash-twin run, while the faulty client still trains
        # with the un-demoted budget (the garbage it would transmit)
        E_run = np.where(ovf, 0.0, E_true)
        if fm is not None and fm.dropout_prob > 0.0:
            E_run = np.where(np.asarray(fd["dropout"])[ids], 0.0, E_run)
        corrupt = (np.asarray(fd["corrupt"], bool)[ids]
                   if fm is not None and fm.corrupts else None)
        demote = fm is not None and fm.demotes
        E_obs = np.where(corrupt, 0.0, E_run) if demote else E_run
        if demote and self.engine.injecting:
            snap = (self.L.copy(), self.H.copy(), self.theta.copy())
            e_eff, outcome, assigned = self._workloads(ids, E_obs)
            new_hist = (self.L, self.H, self.theta)
            self.L, self.H, self.theta = snap
            e_train = self._workloads(ids, E_run)[0]
            self.L, self.H, self.theta = new_hist
        else:
            e_eff, outcome, assigned = self._workloads(ids, E_obs)
            e_train = e_eff

        # only the [K] cohort ids and budgets cross to the device; the
        # packed federation was uploaded once at construction
        n = np.minimum(self.sizes[ids], self.max_n)
        tau = np.ceil(n / cfg.batch_size)
        n_iters = np.minimum(np.round(e_train * tau), self.max_iters)
        draws = (None if self.data_draws is None
                 else self.data_draws(t, np.asarray(ids), n))
        pk = self.packed
        out = self.round_fn(
            self.params, pk.x, pk.y, pk.offsets, pk.lengths,
            torch.as_tensor(np.asarray(ids), device=self.device),
            torch.as_tensor(n_iters.astype(np.int32), device=self.device),
            gen=self.data_gen, draws=draws, residual=self.residual,
            corrupt=(torch.as_tensor(corrupt, device=self.device)
                     if self.engine.injecting else None))
        self.params, losses = out[0], out[1]
        if self.residual is not None:
            self.residual = out[3]
        bad = None
        if self.screening:
            bad = out[-1].numpy()         # read by the screen itself
            self.host_syncs += 1
        losses = losses.cpu().numpy()     # the per-round host sync
        self.host_syncs += 1
        uploaders = n_iters > 0
        if demote and self.engine.injecting:
            # the observed upload set: screened rows count as crashes
            uploaders = uploaders & ~corrupt
        self.cohorts.append(np.asarray(ids))
        self.budgets.append(n_iters.astype(np.int32))
        if uploaders.any():
            self.values.update(ids[uploaders], losses[uploaders])
        stats = {
            "round": t,
            "ids": np.asarray(ids),
            "losses": losses,
            "n_iters": n_iters,
            "dropout": float((outcome == pred.DROPPED).mean()),
            "dropped": float((outcome == pred.DROPPED).sum()),
            "overflowed": float(ovf.sum()),
            "train_loss": float(losses[uploaders].mean()) if uploaders.any()
            else float("nan"),
            "assigned": float(np.mean(assigned)),
            "uploaded": float(np.mean(e_eff)),
            "true_workload": float(np.mean(E_true)),
        }
        if self.screening:
            stats["screened"] = float(bad.sum())
        if self.telemetry:
            # the reference host driver's extras: the byte ledger and the
            # float32 histograms, from the already-pulled losses
            upf = uploaders.astype(np.float32)
            n_up = float(upf.sum())
            stats["client_uploaded"] = uploaders.astype(np.int32)
            stats["upload_bytes"] = n_up * self.bytes_per_client
            stats["dense_upload_bytes"] = n_up * self.dense_bytes_per_client
            stats["loss_hist"] = histogram_counts(
                losses, upf, 0.0, LOSS_HIST_MAX, LOSS_HIST_BINS)
            stats["workload_hist"] = histogram_counts(
                e_eff, upf, 0.0, cfg.h_cap, WORKLOAD_HIST_BINS)
            occ = self._lane_occupancy(ids)
            if occ is not None:
                stats["lane_occupancy"] = occ
        return stats

    def run(self, rounds: Optional[int] = None, verbose: bool = False,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            resume: bool = False):
        """Run the rounds and return the history (dict of lists keyed by
        ``HISTORY_KEYS``, NaN where a round has no value).  Each round's
        host wall time, eval included, is its record's ``wall_time_s``.

        With ``checkpoint_dir`` an atomic whole-server checkpoint is
        written after every ``checkpoint_every``-th round and after the
        last (``checkpoint_every=0``: the last only); ``resume=True``
        first restores the latest checkpoint there, and the resumed run's
        params, history state and records are bitwise the uninterrupted
        run's."""
        T = rounds or self.cfg.rounds
        t_start = 0
        verbose = verbose and self.rank == 0
        if resume:
            if not checkpoint_dir:
                raise ValueError("resume=True requires checkpoint_dir")
            t_start = restore_server_state(self, checkpoint_dir)
        if self.cfg.driver == "scan":
            self._run_scan(T, verbose, t_start, checkpoint_dir,
                           int(checkpoint_every))
        else:
            self._run_host(T, verbose, t_start, checkpoint_dir,
                           int(checkpoint_every))
        # a view over every record so far, built anew on each call
        with stage(SPAN_HISTORY):
            return self.history

    def _run_host(self, T: int, verbose: bool, t_start: int,
                  checkpoint_dir: Optional[str], checkpoint_every: int):
        """The host driver: one Python iteration a round."""
        device = self.rng_impl == "device"
        prog = self._program_loaded() if device else None
        for t in range(t_start, T):
            start = time.perf_counter()
            if device:
                rec = self._device_round(t)
                params = prog.carry["params"]
            else:
                rec = record_from_row(t, self.run_round(t))
                params = self.params
            if t % self.cfg.eval_every == 0 or t == T - 1:
                acc, tl = self.eval_fn(params, self.test_x, self.test_y)
                rec.acc, rec.test_loss = float(acc), float(tl)
            else:
                prev = self._records.last
                rec.acc = prev.acc if prev is not None else float("nan")
                rec.test_loss = float("nan")
            rec.wall_time_s = time.perf_counter() - start
            self._emit_round(rec)
            if verbose and (t % 10 == 0 or t == T - 1):
                print(self._progress_line(self.cfg.algo, f"round {t:3d}",
                                          rec, rec.overflowed))
            if checkpoint_dir and (
                    (checkpoint_every > 0
                     and (t + 1) % checkpoint_every == 0) or t + 1 == T):
                if device:
                    self._absorb_state(prog.carry)
                save_server_state(self, checkpoint_dir, t + 1)
        if device:
            self._absorb_state(prog.carry)
