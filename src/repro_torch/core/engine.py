"""RoundEngine — the packed federated round of the port.

A round is the reference's four-stage pipeline:

    gather -> masked budgeted local SGD -> upload transform -> aggregate

  1. GATHER      the cohort's [K, max_n] windows out of the packed
                 federation, always through ``kernels.ops.fed_cohort_gather``
                 (the Hopper kernel on a CUDA tensor);
  2. LOCAL SGD   heterogeneous budgets: client k updates for its first
                 ``n_iters_k`` slots.  MCLR and the MLP with
                 ``sampling="iid"`` go through their fused kernels
                 (``kernels.ops.fed_local_sgd_mclr`` / ``_dense``); an LM
                 step (``kind="lm"``, an architecture id) trains the lanes
                 one after another in place in their rows of one [K, ...]
                 stack (``_lane_sgd``: its kernel ops cannot be batched by
                 ``vmap``); every other step or sampling takes the plain
                 path below, which differentiates ``LocalStep.loss`` with
                 ``torch.func`` and batches the clients with ``vmap``;
  3. UPLOAD      with ``compress="topk_q8"`` each uploading client's delta
                 plus its error-feedback residual is top-k sparsified and
                 int8 quantised (``core.compression``, through
                 ``kernels.ops.fed_compress_topk_q8``); the server
                 aggregates the dense reconstruction and the quantisation
                 error becomes the client's next residual.  Off, the stage
                 does nothing;
  4. AGGREGATE   the pluggable aggregator over the [K, ...] stack, weighted
                 by sample counts of clients that trained >= 1 step.

The error-feedback residual is per-client state, a [N, P] float32 tensor
the caller owns: a compressing round function takes it as ``residual=``
and returns the updated one as its fourth output.  Uploading rows are the
clients with ``n_iters > 0``; every other row keeps its residual bit for
bit.

The clients' minibatch draws come from a ``torch.Generator`` on the
device: ``iid`` draws ``idx [K, max_iters, B]`` uniform in
``[0, max(n_k, 1))``, ``shuffle`` draws ``u [K, max_n]`` uniform for the
epoch permutation.  Torch cannot reproduce the reference's threefry bits,
so the round function takes ``draws=`` to replace them: that is how the
parity tests replay the reference's batches.

The plain path stops its loop at the cohort's largest budget rather than
at ``max_iters``: a slot past every budget is ``p - lr * 0 * g``, an
identity update whenever the gradient is finite, so the result is the
same for finite data and the round costs one host read of the budgets.
A device round (``make_packed_round(device_round=True)``, the device
drivers') reads nothing on the host: it walks all ``max_iters`` slots
masked, the reference scan's own semantics, and screens on the device.
The LM lanes stop each at its own budget on the host driver, and on the
device drivers walk every slot with ``torch.where(active, p - lr * g, p)``
(a masked slot's gradient never reaches the params, so a non-finite one
cannot turn them NaN as the reference's ``p - lr * active * g`` would).

Faults and the upload screen, as in the reference.  An engine built with
an injecting ``faults`` (corrupt "nan", "inf", "sign_flip" or "explode")
takes ``corrupt=`` ([K] bool) in its round function and overwrites those
uploading rows with the mode's garbage at the upload seam: before the
upload transform for sign_flip and explode under compression (the client
compresses and transmits the garbage), after the reconstruction
otherwise (nan and inf never transmit).  An engine built with
``screen_norm`` screens every stack before every aggregator
(``faults.screen_uploads``): a rejected row gets weight 0 and the global
params' value, exactly a crashed client's row, and the round function
returns the [K] bool verdicts ``bad`` (a CPU tensor, read once a round) as
its last output.  An exploded upload the screen rejects also keeps its
error-feedback residual row bit for bit, as its crash twin does.

The cross-silo round (``make_stream_round``) trains each silo on its own
pre-batched stream of arbitrary batch trees (the decoder LMs through
``core.silo.SiloFedSAE``) and aggregates through the same ``_finish``
stage, screen included.

Each stage runs inside its profiler range (``obs.profiling.stage``:
``fed.gather``, ``fed.local_sgd``, ``fed.upload_transform``,
``fed.aggregate``), so a captured trace shows every kernel launch inside
its stage.  The ranges wrap the ``vmap``-ed calls, never the functions
``torch.func`` transforms.

``make_device_round`` is the whole server step of the device drivers,
the counterpart of the reference's ``make_one_round``: prepare (the
normal and Gumbel draws, workload shaping by the fault draws, Gumbel-top-k
selection under the eligibility mask, dropouts and corrupt demotion, the
float32 Ira/Fassa update, budgets), then execute (the device round, the
uploaded set, the value update, the round's float32 stats with the
telemetry extras, the screened counts and quarantine).  It reads nothing
on the host, so ``core.graphs.RoundProgram`` runs it in place on device
buffers, eagerly or replayed from a CUDA graph.

Client-axis sharding (``mesh=``, a ``launch.mesh.DataGroup``): one
process per shard, each holding its own block of clients
(``PackedClients.shard``) and, under compression, its own ``[C, P]``
error-feedback rows.  Every rank runs the same round on the same
replicated cohort and budgets; it gathers and trains only the cohort
slots it owns, from its own arrays at shard-local offsets: all K lanes
with the non-owned budgets zeroed (``capacity=None``, the masked mode), or
only a dense ``[capacity]`` lane block (``selection.compact_lane_map``),
the overflowed slots' budgets zeroed.  The ``[K, ...]`` stack and the
losses are then rebuilt by one SUM all-reduce in which every slot is
nonzero on exactly one rank (``x + 0 == x``: bitwise the replicated
stack), and aggregation runs replicated, so every aggregator stays
pluggable.  Selection needs no collective: the scores are replicated, so
every rank's ``select_cohort_device`` returns the same cohort, the one the
reference's local top-k, all-gather and merge return
(``selection.select_cohort_sharded``).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.core import compression as comp
from repro_torch.core import prediction as pred
from repro_torch.core.aggregation import FedAvg
from repro_torch.core.heterogeneity import sample_workloads_device
from repro_torch.core.selection import (cohort_overflow, compact_lane_map,
                                        gumbel_noise, select_cohort_device,
                                        value_update_device)
from repro_torch.faults.inject import (apply_availability_stragglers_device,
                                       inject_upload_faults)
from repro_torch.faults.screen import (eligibility, quarantine_update,
                                       screen_uploads, screen_uploads_device)
from repro_torch.kernels import ops as kops
from repro_torch.models.fl_models import as_local_step
from repro_torch.obs.profiling import (
    SPAN_LOCAL_STEP, SPAN_LOCAL_STEP_BACKWARD, SPAN_LOCAL_STEP_FORWARD,
    SPAN_LOCAL_STEP_UPDATE, STAGE_AGGREGATE, STAGE_GATHER, STAGE_LOCAL_SGD,
    STAGE_UPLOAD, stage)
from repro_torch.obs.schema import (LOSS_HIST_BINS, LOSS_HIST_MAX,
                                    WORKLOAD_HIST_BINS)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

SAMPLINGS = ("shuffle", "iid")
BACKENDS = ("xla", "pallas")


def budget_iters(e_eff, n, batch_size: int, max_iters: int):
    """n_iters_k = min(round(e_eff_k * ceil(n_k / B)), max_iters), in
    float32 as the reference's traceable twin (round half to even)."""
    n = torch.as_tensor(n).to(torch.float32)
    tau = torch.ceil(n / torch.full_like(n, float(batch_size)))
    e = torch.as_tensor(e_eff).to(torch.float32)
    return torch.clamp(torch.round(e * tau), max=max_iters).to(torch.int32)


def iid_indices(gen: torch.Generator, n, max_iters: int, batch_size: int):
    """idx [K, max_iters, B] int32, uniform in [0, max(n_k, 1))."""
    return iid_indices_from(torch.rand((n.shape[0], max_iters, batch_size),
                                       generator=gen, device=n.device), n)


def iid_indices_from(u, n):
    """idx int32 shaped as ``u`` [K, ...], from float32 uniforms in [0, 1):
    min(floor(u * max(n_k, 1)), max(n_k, 1) - 1)."""
    nk = torch.clamp(n.long(), min=1).view((-1,) + (1,) * (u.dim() - 1))
    return torch.minimum((u * nk).long(), nk - 1).to(torch.int32)


def _device_hist(x, w, lo: float, hi: float, bins: int):
    """float32 fixed-bin histogram on the device, the twin of
    ``obs.schema.histogram_counts``: clip into [lo, hi), bin =
    floor((x - lo) / (hi - lo) * bins), weights summed per bin."""
    f = np.float32
    top = float(f(hi) - f(hi - lo) * f(1e-6))
    x = torch.clamp(torch.as_tensor(x).to(torch.float32), min=float(f(lo)),
                    max=top)
    width = torch.full_like(x, float(f(hi - lo)))
    idx = torch.floor((x - float(f(lo))) / width * float(f(bins))).long()
    return torch.zeros(bins, dtype=torch.float32, device=x.device).index_add_(
        0, idx, torch.as_tensor(w).to(torch.float32))


def _mean(x):
    """Sum over the [K] axis divided by K, tensor by tensor."""
    s = x.to(torch.float32).sum()
    return s / torch.full_like(s, float(x.shape[0]))


def _shuffle_walk(u, mask, nk_safe, max_iters: int, batch_size: int):
    """The shuffle rule's batch indices idx [K, max_iters, B]: each
    client's epoch permutation (``u`` [K, max_n] its sort keys, padded rows
    last) walked modulo n_k."""
    K = u.shape[0]
    perm = torch.argsort(u + (1.0 - mask) * 1e9, dim=1, stable=True)
    walk = (torch.arange(max_iters * batch_size, device=u.device)
            .reshape(1, max_iters, batch_size) % nk_safe[:, None, None])
    return torch.gather(perm, 1, walk.reshape(K, -1)).reshape(
        K, max_iters, batch_size)


def _rows(x, idx):
    """x [K, M, ...], idx [K, B] -> x[k, idx[k]] as [K, B, ...]."""
    kk = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[kk, idx.long()]


class RoundEngine:
    """Executor of the packed round with pluggable aggregation.

    lr         local-SGD learning rate
    aggregator callable from ``repro_torch.core.aggregation`` (FedAvg)
    prox_mu    proximal weight of every local objective; defaults to the
               aggregator's own ``prox_mu`` (FedProx carries it)
    compress   upload transform, "none" | "topk_q8"; with "topk_q8" the
               round function takes and returns the error-feedback residual
    topk_frac  kept-coordinate fraction for "topk_q8"
               (k = ceil(topk_frac * n_params))
    faults     optional ``faults.FaultModel``; an injecting one makes the
               packed round take ``corrupt=`` (see the module docstring)
    screen_norm
               the upload screen's delta l2 bound (None: no screen); a
               screening round function returns ``bad`` last
    donate     the reference's buffer donation under ``jax.jit``; torch has
               no counterpart, so it is kept and does nothing
    backend    "xla" | "pallas", validated as the reference does; it selects
               nothing: the port routes every kernel by device
    fused_generic
               the reference's fused generic iid walk; the port runs one
               walk either way (its values are the unfused walk's)
    """

    def __init__(self, lr: float, aggregator=None,
                 prox_mu: Optional[float] = None, donate: bool = True,
                 backend: str = "xla", compress: str = "none",
                 topk_frac: float = 0.1, faults=None,
                 screen_norm: Optional[float] = None,
                 fused_generic: bool = True):
        self.lr = float(lr)
        self.donate = bool(donate)
        self.backend = self._resolve_backend(backend)
        self.fused_generic = bool(fused_generic)
        self.aggregator = aggregator if aggregator is not None else FedAvg()
        self.prox_mu = float(prox_mu if prox_mu is not None
                             else getattr(self.aggregator, "prox_mu", 0.0))
        self.compress = comp.check_compress(compress)
        self.topk_frac = float(topk_frac)
        comp.resolve_k(self.topk_frac, 1)   # validate the fraction eagerly
        self.faults = faults
        self.screen_norm = None if screen_norm is None else float(screen_norm)
        self.screening = self.screen_norm is not None
        self.injecting = faults is not None and faults.injects
        # where the garbage goes in: delta-shaped modes (sign_flip,
        # explode) corrupt what the client compresses and transmits, so
        # under compression they go in before the upload transform (after
        # it a non-transmitting row is exactly ``global``); nan/inf
        # garbage never transmits and corrupts the reconstructed stack
        self._inject_pre = (self.injecting and self.compressing
                            and faults.corrupt in ("sign_flip", "explode"))
        self._inject_post = self.injecting and not self._inject_pre
        # a screened transmitting mode (explode) must not leak into the
        # error-feedback state: the residual row of a detected upload keeps
        # its pre-round bits, exactly like the crash twin's
        self._block_residual = (self._inject_pre
                                and faults.corrupt == "explode")

    @property
    def compressing(self) -> bool:
        return self.compress != "none"

    def _resolve_backend(self, backend: Optional[str]) -> str:
        backend = getattr(self, "backend", "xla") if backend is None \
            else backend
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; choose from {BACKENDS}")
        return backend

    def _prox(self, loss, params, global_params):
        if not self.prox_mu:
            return loss
        sq = sum(torch.sum((a - b) ** 2) for a, b in zip(
            tree_leaves(params), tree_leaves(global_params)))
        return loss + 0.5 * self.prox_mu * sq

    def _train_in_place(self, loss_fn, views, params, global_params,
                        batch_at: Callable, steps: int, active=None):
        """``steps`` SGD steps on ``params`` (views of one row of a [K, ...]
        stack, updated in place), step i on ``batch_at(i)``; the silo
        round's and the LM lanes' local step.  ``views`` cuts the params
        into the autograd leaves the step trains (``LocalStep.leaf_views``)
        and each step takes their gradients with ``torch.autograd.grad``
        (a leaf the loss does not read, as a VLM's ``modality_proj`` on a
        token-only batch, gets zeros, as under ``jax.grad``).
        Without ``active`` every step updates (the compacted walk: the
        caller passes the lane's own budget); with it, a [steps] bool
        device tensor, step i updates through ``torch.where(active[i], p -
        lr * g, p)`` and its loss counts only if active (the device walk:
        no host read, and a masked step's gradient never reaches the
        params).  Under FedProx the objective carries the proximal term
        anchored at ``global_params``.  Returns the sum of the counted
        step losses (0-d float32)."""
        tree = views(params)
        leaves = tree_leaves(tree)
        anchor = views(global_params) if self.prox_mu else None
        total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            try:
                for i in range(steps):
                    with stage(SPAN_LOCAL_STEP):
                        total = self._local_step(loss_fn, tree, leaves,
                                                 anchor, batch_at(i), total,
                                                 None if active is None
                                                 else active[i])
            finally:
                for p in leaves:
                    p.requires_grad_(False)
        return total

    def _local_step(self, loss_fn, tree, leaves, anchor, batch, total,
                    active):
        """One SGD step of ``_train_in_place`` on ``leaves`` (the autograd
        leaves of ``tree``), its forward, backward and update each in its
        span; returns ``total`` plus the step's counted loss.  ``active``
        (a 0-d bool device tensor, or None for a step that always updates)
        masks the update and the loss."""
        with stage(SPAN_LOCAL_STEP_FORWARD):
            loss = self._prox(loss_fn(tree, batch), tree, anchor)
        with stage(SPAN_LOCAL_STEP_BACKWARD):
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        lr = self.lr
        with stage(SPAN_LOCAL_STEP_UPDATE), torch.no_grad():
            if active is None:
                for p, g in zip(leaves, grads):
                    p.sub_(g.to(p.dtype) * lr)
                return total + loss.detach()
            # where(a, p - lr * g, p) through one temporary a leaf (a
            # full-width LM's largest leaf is 1.6 GB)
            for p, g in zip(leaves, grads):
                t = g.to(p.dtype) * lr
                torch.where(active, torch.sub(p, t, out=t), p, out=p)
            return total + torch.where(active, loss.detach(), 0.0)

    def _lane_sgd(self, model, global_params, x, y, mask, n_iters, idx,
                  bmask, sampling: str, walk_all: bool, max_iters: int):
        """The LM steps' local training: the cohort's lanes trained one
        after another, in place in their rows of one preallocated [K, ...]
        stack (``_train_in_place``), so a round holds the global params,
        the stack and one lane's gradients.  The LM's kernel ops (flash
        attention, the selective scan, the fused cross-entropy) launch
        through ``ctypes`` on their tensors' pointers and cannot be batched
        by ``vmap``.

        Lane k's slot i takes rows ``idx[k, i]`` of its shard, masked by
        ``bmask[k]`` (and by the padding mask under shuffle).  The numpy
        host driver stops each lane at its own budget (one host read of
        ``n_iters``); ``walk_all`` walks all ``max_iters`` slots of every
        lane masked.  Returns (params_k, losses [K]): the loss is the mean
        over executed slots (iid) or a post-training pass over the lane's
        whole shard (shuffle)."""
        views = getattr(model, "leaf_views", None) or (lambda p: p)
        K = n_iters.shape[0]
        stack = tree_map(lambda g: torch.empty(
            (K,) + tuple(g.shape), dtype=g.dtype, device=g.device),
            global_params)
        steps = (None if walk_all else
                 [min(int(v), max_iters) for v in n_iters.tolist()])
        slots = torch.arange(max_iters, device=x.device)
        losses = []
        for k in range(K):
            row = tree_map(lambda t: t[k], stack)
            for dst, src in zip(tree_leaves(row), tree_leaves(global_params)):
                dst.copy_(src)

            def batch_at(i, k=k):
                rows = idx[k, i]
                m = bmask[k] if sampling == "iid" else mask[k][rows] * bmask[k]
                return {"x": x[k][rows], "y": y[k][rows], "mask": m}

            if walk_all:
                total = self._train_in_place(
                    model.loss, views, row, global_params, batch_at,
                    max_iters, active=slots < n_iters[k])
                count = torch.clamp(n_iters[k].to(torch.float32), min=1.0)
            else:
                total = self._train_in_place(
                    model.loss, views, row, global_params, batch_at,
                    steps[k])
                count = max(steps[k], 1)
            losses.append(total / count if sampling == "iid" else
                          model.loss(row, {"x": x[k], "y": y[k],
                                           "mask": mask[k]}))
        return stack, torch.stack(losses)

    # ------------------------------------------------------------------
    @staticmethod
    def _cohort_gather(max_n: int) -> Callable:
        """gather(flat_x, flat_y, offs [K], n [K]) -> (x [K, max_n, ...],
        y [K, max_n], mask [K, max_n]) through the kernel op."""
        def gather(flat_x, flat_y, offs, n):
            return kops.fed_cohort_gather(flat_x, flat_y, offs, n, max_n)
        return gather

    def _sgd_loop(self, model, global_params, batch_at, n_iters,
                  n_steps: int):
        """The plain budgeted loop, clients batched by ``vmap``: slot i
        updates client k iff i < n_iters_k.  Returns (params_k, losses
        [n_steps, K])."""
        def loss_fn(p, batch):
            return self._prox(model.loss(p, batch), p, global_params)

        vgrad = vmap(grad_and_value(loss_fn))
        K = n_iters.shape[0]
        params = {k: v.expand((K,) + tuple(v.shape)).clone()
                  for k, v in global_params.items()}
        losses = []
        for i in range(n_steps):
            g, loss = vgrad(params, batch_at(i))
            step = self.lr * (i < n_iters).to(torch.float32)
            params = {k: p - step.view((K,) + (1,) * (p.dim() - 1)) * g[k]
                      for k, p in params.items()}
            losses.append(loss)
        return params, losses

    def _local_sgd(self, model, batch_size: int, max_iters: int,
                   sampling: str = "shuffle",
                   walk_all: bool = False) -> Callable:
        """local_train(global_params, x, y, mask, n, n_iters, draws) ->
        (params_k, losses [K]).

        shuffle  one random epoch permutation per round (``draws`` = its
                 sort keys u [K, max_n]); batches walk it modulo n_k and
                 the reported loss is a post-training pass over the full
                 local shard.
        iid      uniform minibatches with replacement (``draws`` = idx
                 [K, max_iters, B]); the reported loss is the mean
                 minibatch loss over executed iterations.

        The loop stops at the largest budget (one host read), or walks
        all ``max_iters`` slots masked with ``walk_all``.
        """
        if sampling not in SAMPLINGS:
            raise ValueError(f"unknown sampling {sampling!r}")
        B = batch_size
        lm = getattr(model, "kind", None) == "lm"

        def local_train(global_params, x, y, mask, n, n_iters, draws):
            K = n.shape[0]
            dev = x.device
            nk_safe = torch.clamp(n.long(), min=1)
            bmask = (torch.arange(B, device=dev)[None, :]
                     < nk_safe[:, None]).to(torch.float32)
            if lm:
                idx = draws.long() if sampling == "iid" else \
                    _shuffle_walk(draws, mask, nk_safe, max_iters, B)
                return self._lane_sgd(model, global_params, x, y, mask,
                                      n_iters, idx, bmask, sampling,
                                      walk_all, max_iters)
            n_steps = (max_iters if walk_all else
                       min(max_iters, int(n_iters.max())) if K else 0)
            if sampling == "iid":
                idx = draws.long()

                def batch_at(i):
                    return {"x": _rows(x, idx[:, i]),
                            "y": _rows(y, idx[:, i]), "mask": bmask}

                params, losses = self._sgd_loop(model, global_params,
                                                batch_at, n_iters, n_steps)
                msk = (torch.arange(n_steps, device=dev)[:, None]
                       < n_iters.long()[None, :]).to(torch.float32)
                total = ((torch.stack(losses) * msk).sum(0) if n_steps
                         else torch.zeros(K, device=dev))
                return params, total / torch.clamp(msk.sum(0), min=1.0)

            idx = _shuffle_walk(draws, mask, nk_safe, max_iters, B)

            def batch_at(i):
                return {"x": _rows(x, idx[:, i]), "y": _rows(y, idx[:, i]),
                        "mask": _rows(mask, idx[:, i]) * bmask}

            params, _ = self._sgd_loop(model, global_params, batch_at,
                                       n_iters, n_steps)
            final = vmap(model.loss)(params, {"x": x, "y": y, "mask": mask})
            return params, final

        return local_train

    def _fused_sgd(self, model, global_params, x, y, n, n_iters, idx):
        """Budgeted local SGD through the fused kernel for ``model.kind``:
        the MCLR kernel or the dense two-layer MLP kernel."""
        kind = getattr(model, "kind", None)
        idx = idx.to(torch.int32).contiguous()
        n, n_iters = n.to(torch.int32), n_iters.to(torch.int32)
        if kind == "mlp":
            gp = global_params
            w1_k, b1_k, w2_k, b2_k, losses = kops.fed_local_sgd_dense(
                x, y, idx, gp["w1"], gp["b1"], gp["w2"], gp["b2"], n,
                n_iters, lr=self.lr, prox_mu=self.prox_mu)
            return {"w1": w1_k, "b1": b1_k, "w2": w2_k, "b2": b2_k}, losses
        if kind != "mclr":
            raise ValueError(
                f"no fused local-SGD kernel for step kind {kind!r}")
        w_k, b_k, losses = kops.fed_local_sgd_mclr(
            x, y, idx, global_params["w"], global_params["b"], n, n_iters,
            lr=self.lr, prox_mu=self.prox_mu)
        return {"w": w_k, "b": b_k}, losses

    @staticmethod
    def _upload_weights(n, n_iters):
        """A client contributes its sample count iff it trained >= 1 step."""
        return n.to(torch.float32) * (n_iters > 0).to(torch.float32)

    def _finish(self, global_params, params_k, weights,
                on_device: bool = False):
        """Stage 4: screen (when on) and aggregate.

        ``weights`` is the [K] f32 aggregation-weight vector (0 = no
        upload): the packed rounds build it with ``_upload_weights``, the
        stream round takes its caller's.  Returns ``(new_global,
        uploaded_any, bad)``, ``bad`` the [K] bool CPU tensor of rejected
        rows (None when the screen is off).  A rejected row reaches the
        aggregator as a crashed client's: weight 0 and the global params'
        value (written into ``params_k`` in place).  ``on_device`` screens
        without a host read (``screen_uploads_device``: a new stack, and
        ``bad`` on the device)."""
        with stage(STAGE_AGGREGATE):
            bad = None
            if self.screening:
                screen = screen_uploads_device if on_device \
                    else screen_uploads
                params_k, weights, bad = screen(
                    global_params, params_k, weights, self.screen_norm)
            new_global = self.aggregator(params_k, global_params, weights)
            return new_global, weights.sum() > 0, bad

    def _inject_faults(self, global_params, params_k, corrupt, uploading):
        """Overwrite the ``corrupt & uploading`` rows of the stacked upload
        with the configured garbage.  Rows that uploaded nothing are never
        corrupted: they carry the exact crash-branch value and weight 0,
        so garbage in them would dodge the weight-gated screen and poison
        the distance-based aggregators."""
        fm = self.faults
        with stage(STAGE_UPLOAD):
            return inject_upload_faults(params_k, global_params,
                                        corrupt & uploading, fm.corrupt,
                                        fm.explode_factor)

    def _upload_transform(self, global_params, params_k, residual_rows,
                          uploaded):
        """Stage 3: compress the trained stack's deltas against
        ``residual_rows`` [K, P] and reconstruct them densely.
        ``uploaded`` rows transmit; the rest reconstruct to exactly
        ``global`` and keep their residual bit for bit."""
        with stage(STAGE_UPLOAD):
            k = comp.resolve_k(self.topk_frac,
                               comp.n_params_of(global_params))
            rec, new_rows, _ = comp.apply_upload_compress(
                global_params, params_k, residual_rows, uploaded, k)
            return rec, new_rows

    def _finish_round(self, global_params, params_k, losses, n, n_iters,
                      ids, residual=None, corrupt=None,
                      on_device: bool = False):
        """Stages 3 and 4: fault injection at the upload seam (an
        injecting engine), the upload transform with error feedback
        (compressing), then screen and aggregate.  Returns (new_global,
        losses, any_up), then the updated [N, P] residual when compressing
        (a new tensor: the caller's is not written), then ``bad`` when
        screening."""
        uploading = n_iters > 0
        weights = self._upload_weights(n, n_iters)
        if self.compressing:
            transmit = uploading
            rows = residual[ids]
            if self._inject_pre:      # sign_flip/explode: the client
                params_k = self._inject_faults(  # transmits the garbage
                    global_params, params_k, corrupt, uploading)
            elif self.injecting:      # nan/inf garbage never transmits
                transmit = uploading & ~corrupt
            params_k, new_rows = self._upload_transform(
                global_params, params_k, rows, transmit)
            if self._block_residual:  # a detected explode keeps its row
                new_rows = torch.where(corrupt[:, None], rows, new_rows)
            residual = residual.index_copy(0, ids, new_rows)  # ids distinct
        if self._inject_post:
            params_k = self._inject_faults(global_params, params_k, corrupt,
                                           uploading)
        new_global, any_up, bad = self._finish(global_params, params_k,
                                               weights, on_device)
        out = (new_global, losses, any_up)
        if self.compressing:
            out = out + (residual,)
        if self.screening:
            out = out + (bad,)
        return out

    @staticmethod
    def _drawer(sampling: str, batch_size: int, max_iters: int,
                max_n: int) -> Callable:
        """draw(gen, n, dev): the cohort's minibatch draws from ``gen``:
        idx [K, max_iters, B] iid, the permutation keys u [K, max_n]
        shuffle."""
        def draw(gen, n, dev):
            if gen is None:
                raise ValueError("pass gen= or draws=")
            if sampling == "iid":
                return iid_indices(gen, n, max_iters, batch_size)
            return torch.rand((n.shape[0], max_n), generator=gen, device=dev)
        return draw

    def _trainer(self, model, batch_size: int, max_iters: int,
                 sampling: str, walk_all: bool = False) -> Callable:
        """train(global_params, x, y, mask, n, n_iters, draws) -> (params_k,
        losses [K]) inside the local-SGD stage: the fused kernel for an
        eligible step (``kops.fused_sgd_eligible``), else ``_local_sgd``."""
        if sampling not in SAMPLINGS:
            raise ValueError(f"unknown sampling {sampling!r}")
        fuse_sgd = kops.fused_sgd_eligible(model, sampling)
        local_train = None if fuse_sgd else self._local_sgd(
            model, batch_size, max_iters, sampling, walk_all=walk_all)

        def train(global_params, x, y, mask, n, n_iters, draws):
            with stage(STAGE_LOCAL_SGD):
                if fuse_sgd:
                    return self._fused_sgd(model, global_params, x, y, n,
                                           n_iters, draws)
                return local_train(global_params, x, y, mask, n, n_iters,
                                   draws)
        return train

    # ------------------------------------------------------------------
    def make_padded_round(self, model, batch_size: int, max_iters: int,
                          sampling: str = "shuffle",
                          backend: Optional[str] = None) -> Callable:
        """The seed interface's round over host-stacked padded arrays.

        round_fn(global_params, x, y, mask, n, n_iters, gen=None,
                 draws=None) -> (new_global_params, client_losses [K],
                                 uploaded_any)
          x: [K, max_n, ...] padded client data;  mask: [K, max_n]
          n: [K] true sample counts;  n_iters: [K] masked local-SGD budget

        The arrays may be numpy or tensors; they go to the global params'
        device.  The minibatch draws come from ``gen`` or are ``draws``
        (idx [K, max_iters, B] iid, u [K, max_n] shuffle), as in the
        packed round.  ``model`` goes through ``as_local_step``; an iid
        MCLR or MLP step trains through its fused kernel.  Compression,
        fault injection and the screen need the packed round."""
        if self.compressing:
            raise ValueError(
                "upload compression needs the packed client axis for "
                "residual state; the padded seed round does not support "
                "it — use make_packed_round/make_segment_fn")
        if self.injecting or self.screening:
            raise ValueError(
                "fault injection / upload screening are packed-round "
                "features; the padded seed round does not support them — "
                "use make_packed_round/make_segment_fn")
        model = as_local_step(model)
        self._resolve_backend(backend)
        train = self._trainer(model, batch_size, max_iters, sampling)

        @torch.no_grad()
        def round_fn(global_params, x, y, mask, n, n_iters, gen=None,
                     draws=None):
            dev = tree_leaves(global_params)[0].device
            x, y, mask, n, n_iters = (torch.as_tensor(a, device=dev)
                                      for a in (x, y, mask, n, n_iters))
            if draws is None:
                draws = self._drawer(sampling, batch_size, max_iters,
                                     x.shape[1])(gen, n, dev)
            elif not torch.is_tensor(draws):
                draws = torch.from_numpy(np.array(draws)).to(dev)
            params_k, losses = train(global_params, x, y, mask, n, n_iters,
                                     draws)
            new_global, any_up, _ = self._finish(
                global_params, params_k, self._upload_weights(n, n_iters))
            return new_global, losses, any_up

        return round_fn

    # ------------------------------------------------------------------
    def make_packed_round(self, model, batch_size: int, max_iters: int,
                          max_n: int, sampling: str = "shuffle",
                          device_round: bool = False, mesh=None,
                          capacity: Optional[int] = None,
                          sizes=None) -> Callable:
        """Device-resident round over the packed federation.

        round_fn(global_params, flat_x, flat_y, offsets, lengths, ids,
                 n_iters, gen=None, draws=None, residual=None,
                 corrupt=None)
            -> (new_global_params, client_losses [K], uploaded_any
                [, new_residual][, bad])

        ``ids``/``n_iters`` are the [K] cohort and its budgets on the
        device; ``gen`` is the ``torch.Generator`` the minibatch draws come
        from, unless ``draws`` supplies them (idx [K, max_iters, B] int for
        iid, u [K, max_n] float32 for shuffle).  A compressing engine needs
        ``residual`` ([N, P] float32, the whole federation's error-feedback
        rows) and returns the updated one.  An injecting engine needs
        ``corrupt`` ([K] bool on the device); a screening one returns the
        rejected rows ``bad`` ([K] bool, CPU) last.

        ``device_round`` reads nothing on the host: the plain walk runs
        all ``max_iters`` slots masked and ``bad`` stays on the device.

        ``mesh`` (a ``launch.mesh.DataGroup``) makes the round sharded
        (see the module docstring): ``flat_x``, ``flat_y``, ``offsets``
        and ``lengths`` are then this rank's block (``PackedClients.
        shard``), ``residual`` its ``[C, P]`` rows, ``sizes`` the [S * C]
        global client lengths (ghost-padded), and ``capacity`` (a resolved
        lane count, ``selection.resolve_capacity``; None = the masked
        mode) compacts the owned slots; the overflowed slots' budgets are
        zeroed before the round and in the aggregation weights.  The
        minibatch draws are the full cohort's on every rank, each lane
        taking its slot's."""
        if sampling not in SAMPLINGS:
            raise ValueError(f"unknown sampling {sampling!r}")
        model = as_local_step(model)
        if mesh is None and capacity is not None:
            raise ValueError(
                "capacity compaction requires a sharded mesh; pass mesh= "
                "or leave capacity=None for the replicated round")
        train = self._trainer(model, batch_size, max_iters, sampling,
                              walk_all=device_round)
        draw = self._drawer(sampling, batch_size, max_iters, max_n)
        gather = self._cohort_gather(max_n)

        if mesh is not None:
            return self._sharded_round_fn(
                max_n, gather, draw, train, device_round, mesh, capacity,
                sizes)

        @torch.no_grad()
        def round_fn(global_params, flat_x, flat_y, offsets, lengths, ids,
                     n_iters, gen=None, draws=None, residual=None,
                     corrupt=None):
            if self.compressing and residual is None:
                raise ValueError("a compressing round needs residual=")
            if self.injecting and corrupt is None:
                raise ValueError("an injecting round needs corrupt=")
            ids = ids.long()
            n = torch.clamp(lengths[ids], max=max_n)
            with stage(STAGE_GATHER):
                x, y, mask = gather(flat_x, flat_y, offsets[ids], n)
            if draws is None:
                draws = draw(gen, n, x.device)
            elif not torch.is_tensor(draws):
                draws = torch.from_numpy(np.array(draws)).to(x.device)
            params_k, losses = train(global_params, x, y, mask, n, n_iters,
                                     draws)
            return self._finish_round(global_params, params_k, losses, n,
                                      n_iters, ids, residual, corrupt,
                                      on_device=device_round)

        return round_fn

    def _sharded_round_fn(self, max_n: int, gather, draw, train,
                          device_round: bool, mesh,
                          capacity: Optional[int], sizes) -> Callable:
        """The sharded packed round (``make_packed_round(mesh=)``): this
        rank's lanes gathered and trained from its own block, compressed
        against its own residual rows, the stack rebuilt by one SUM
        all-reduce, then the replicated upload faults, screen and
        aggregation of ``_finish``."""
        from repro_torch.launch.mesh import all_reduce_sum
        if sizes is None:
            raise ValueError("a sharded round needs sizes=, the [S * C] "
                             "global client lengths")
        rank = int(mesh.rank)

        @torch.no_grad()
        def round_fn(global_params, flat_x, flat_y, offsets, lengths, ids,
                     n_iters, gen=None, draws=None, residual=None,
                     corrupt=None):
            if self.compressing and residual is None:
                raise ValueError("a compressing round needs residual=")
            if self.injecting and corrupt is None:
                raise ValueError("an injecting round needs corrupt=")
            C = offsets.shape[0]
            if sizes.shape[0] != mesh.world * C:
                raise ValueError(
                    f"{sizes.shape[0]} global client lengths for a layout "
                    f"of {mesh.world} shards of {C}: build it with packed("
                    f"shards={mesh.world})")
            ids = ids.long()
            K = ids.shape[0]
            dev = flat_x.device
            if capacity is not None:
                n_iters = torch.where(cohort_overflow(ids, C, capacity),
                                      torch.zeros_like(n_iters), n_iters)
            # the full cohort's draws on every rank (the same bits as the
            # replicated round), each lane taking its slot's
            n_all = torch.clamp(sizes[ids], max=max_n)
            if draws is None:
                draws = draw(gen, n_all, dev)
            elif not torch.is_tensor(draws):
                draws = torch.from_numpy(np.array(draws)).to(dev)
            if capacity is None:          # all K lanes, non-owned ones idle
                slot = torch.arange(K, device=dev)
                valid = (ids // C) == rank
                lane_map = torch.where(valid, slot, K)
            else:                         # the dense [capacity] lane block
                lane_map = compact_lane_map(ids, C, rank, capacity)
                valid = lane_map < K
                slot = torch.where(valid, lane_map, 0)
            local = torch.where(valid, ids[slot] % C, 0)
            n = torch.where(valid, torch.clamp(lengths[local], max=max_n), 0)
            iters = torch.where(valid, n_iters[slot],
                                torch.zeros_like(n_iters[slot]))
            with stage(STAGE_GATHER):
                x, y, mask = gather(flat_x, flat_y, offsets[local], n)
            params_k, losses = train(global_params, x, y, mask, n, iters,
                                     draws[slot])
            if self.compressing:
                params_k, residual = self._shard_upload(
                    global_params, params_k, residual, local, valid, iters,
                    None if corrupt is None else corrupt[slot])
            # lane results back to their [K] slots (the sentinel row K
            # takes the idle lanes), then the ownership-masked rebuild: one
            # SUM all-reduce of [K, P + 1] in which each slot is nonzero on
            # one rank only
            leaves = tree_leaves(params_k)
            flat = torch.cat([p.reshape(p.shape[0], -1) for p in leaves]
                             + [losses.reshape(-1, 1).to(torch.float32)], 1)
            flat = torch.zeros((K + 1, flat.shape[1]), dtype=flat.dtype,
                               device=dev).index_copy(0, lane_map, flat)[:K]
            parts = torch.split(all_reduce_sum(flat),
                                [p[0].numel() for p in leaves] + [1], 1)
            params_k = tree_unflatten(params_k, [
                q.reshape((K,) + tuple(p.shape[1:])).contiguous()
                for p, q in zip(leaves, parts)])
            losses = parts[-1][:, 0].contiguous()
            if self._inject_post:
                params_k = self._inject_faults(global_params, params_k,
                                               corrupt, n_iters > 0)
            new_global, any_up, bad = self._finish(
                global_params, params_k, self._upload_weights(n_all, n_iters),
                device_round)
            out = (new_global, losses, any_up)
            if self.compressing:
                out = out + (residual,)
            if self.screening:
                out = out + (bad,)
            return out

        return round_fn

    def _shard_upload(self, global_params, params_k, residual, local, valid,
                      iters, corrupt_lane):
        """Stage 3 on one rank's lanes: each executing lane compresses its
        delta against the residual row of the client it serves (``local``)
        and the updated rows scatter back, the idle and non-transmitting
        lanes into a sentinel row C (cohort ids are distinct, so writers
        never collide).  Fault injection at the seam as in
        ``_finish_round``."""
        uploaded = valid & (iters > 0)
        keep = uploaded
        if corrupt_lane is not None:
            if self._inject_pre:      # sign_flip/explode: transmitted
                params_k = self._inject_faults(global_params, params_k,
                                               corrupt_lane, uploaded)
                if self._block_residual:
                    keep = uploaded & ~corrupt_lane
            else:                     # nan/inf never transmits
                uploaded = uploaded & ~corrupt_lane
                keep = uploaded
        params_k, new_rows = self._upload_transform(
            global_params, params_k, residual[local], uploaded)
        C = residual.shape[0]
        rows = torch.where(keep, local, C)
        ext = torch.cat([residual, residual.new_zeros((1,) +
                                                      residual.shape[1:])])
        return params_k, ext.index_copy(0, rows, new_rows)[:C]

    # ------------------------------------------------------------------
    def make_device_round(self, model, batch_size: int, max_iters: int,
                          packed, cfg, *, mu, sigma, sel_gen, data_gen,
                          phases=None, telemetry: bool = False,
                          data_draws: Optional[Callable] = None, mesh=None,
                          capacity: Optional[int] = None,
                          sizes=None) -> Callable:
        """The whole server step of the device drivers, on the device.

        one_round(carry, t, inputs) -> (carry', stats)

        ``carry`` is a dict of device tensors: ``params``; ``L``, ``H``,
        ``theta`` and ``values`` float32 [N]; ``q_fail``, ``q_try`` and
        ``q_susp`` int32 [N] under quarantine; ``residual`` [N, P] float32
        when compressing.  ``t`` is the round index (an int or a 0-d
        int32 device tensor).  ``inputs`` holds round t's injected values,
        each absent when not injected: ``z`` (the standard normals) or
        ``E`` (the affordable workloads themselves) and ``g`` (the Gumbel
        noise) [N], ``u`` the data uniforms ([K, max_iters, B] iid, [K,
        max_n] shuffle), and the fault draws ``slowdown`` float32 [N],
        ``dropout`` and ``corrupt`` bool [N].

        Each round draws, in this order, the normal [N] and the uniform
        [N] of the Gumbel noise from ``sel_gen``, then the data uniforms
        from ``data_gen``: so the host driver with ``rng_impl="device"``
        and the scan driver draw the same bits.  ``data_draws(t, ids, n)``
        (host arrays; it reads the cohort on the host) replaces the data
        draws on an eager driver.

        ``stats`` are the round's device tensors: ``ids`` and ``n_iters``
        [K]; float32 ``dropout``, ``dropped``, ``overflowed``,
        ``train_loss``, ``assigned``, ``uploaded``, ``true_workload``;
        ``screened`` with the screen, ``quarantined`` under quarantine;
        with ``telemetry`` the extras ``client_uploaded`` [K],
        ``upload_bytes``, ``dense_upload_bytes``, ``loss_hist`` and
        ``workload_hist``.  ``prepare`` and ``execute`` are exported as
        attributes: ``one_round`` is ``execute(*prepare(carry, t,
        inputs))``.

        ``mesh`` (a ``launch.mesh.DataGroup``) shards the round:
        ``packed`` is this rank's block, ``sizes`` the [S * C] global
        client lengths, ``carry["residual"]`` this rank's [C, P] rows, and
        ``capacity`` the resolved lane count (None: the masked mode).  Every
        rank selects the same cohort from the replicated scores; an
        overflowed slot's E~ is forced to 0 before the workload update
        (the crash branch), and ``overflowed`` counts them.  The server
        refuses quarantine on a mesh."""
        fm = self.faults
        sampling = cfg.sampling
        K, algo = int(cfg.n_selected), cfg.algo
        max_n = packed.max_n
        sizes = packed.lengths if sizes is None else sizes
        wl = dict(U=cfg.U, alpha=cfg.alpha, gamma1=cfg.gamma1,
                  gamma2=cfg.gamma2, h_cap=cfg.h_cap,
                  fixed_epochs=cfg.fixed_epochs)
        al_rounds = int(cfg.al_rounds)
        q_threshold = float(cfg.quarantine_threshold or 0.0)
        quarantine = q_threshold > 0.0
        demote = fm is not None and fm.demotes
        round_fn = self.make_packed_round(model, batch_size, max_iters,
                                          max_n, sampling=sampling,
                                          device_round=True, mesh=mesh,
                                          capacity=capacity, sizes=sizes)
        N = int(mu.shape[0])

        def prepare(carry, t, inputs):
            E_all = inputs.get("E")
            if E_all is None:
                z = inputs.get("z")
                if z is None:
                    z = torch.randn((N,), generator=sel_gen,
                                    device=mu.device)
                E_all = sample_workloads_device(z, mu, sigma)
            g = inputs.get("g")
            if g is None:
                g = gumbel_noise(torch.rand((N,), generator=sel_gen,
                                            device=mu.device))
            if fm is not None:
                E_all = apply_availability_stragglers_device(
                    fm, phases, t, E_all, inputs.get("slowdown"))
            use_al = (t < al_rounds) if al_rounds else False
            elig = eligibility(carry["q_susp"], t) if quarantine else None
            ids = select_cohort_device(g, carry["values"], K, cfg.selection,
                                       cfg.beta, use_al=use_al, elig=elig)
            E_true = E_all[ids]
            ovf = (None if capacity is None else
                   cohort_overflow(ids, packed.clients_per_shard, capacity))
            E_run = E_true if ovf is None else torch.where(ovf, 0.0, E_true)
            if fm is not None and fm.dropout_prob > 0.0:
                E_run = torch.where(inputs["dropout"][ids], 0.0, E_run)
            corrupt = (inputs["corrupt"][ids]
                       if fm is not None and fm.corrupts else None)
            E_obs = torch.where(corrupt, 0.0, E_run) if demote else E_run
            L, H, theta = carry["L"], carry["H"], carry["theta"]
            e_eff, outcome, assigned, L2, H2, th2 = \
                pred.workload_update_device(algo, L, H, theta, ids, E_obs,
                                            **wl)
            e_train = e_eff
            if demote and self.injecting:
                # the faulty client trains with the un-demoted budget and
                # transmits garbage (ids distinct: every other row's e_eff
                # is the observed call's)
                e_train = pred.workload_update_device(
                    algo, L, H, theta, ids, E_run, **wl)[0]
            n = torch.clamp(sizes[ids], max=max_n)
            n_iters = budget_iters(e_train, n, batch_size, max_iters)
            pf = {"t": t, "ids": ids, "n": n, "n_iters": n_iters,
                  "outcome": outcome, "assigned": assigned, "e_eff": e_eff,
                  "E_true": E_true, "corrupt": corrupt, "ovf": ovf,
                  "u": inputs.get("u")}
            return dict(carry, L=L2, H=H2, theta=th2), pf

        def execute(carry, pf):
            ids, n, n_iters = pf["ids"], pf["n"], pf["n_iters"]
            corrupt, draws = pf["corrupt"], pf["u"]
            if draws is not None and sampling == "iid":
                draws = iid_indices_from(draws, n)
            elif draws is None and data_draws is not None:
                draws = data_draws(int(pf["t"]), ids.cpu().numpy(),
                                   n.cpu().numpy())
            out = round_fn(carry["params"], packed.x, packed.y,
                           packed.offsets, packed.lengths, ids, n_iters,
                           gen=data_gen, draws=draws,
                           residual=carry.get("residual"),
                           corrupt=corrupt if self.injecting else None)
            losses = out[1]
            new = dict(carry, params=out[0])
            if self.compressing:
                new["residual"] = out[3]
            bad = out[-1] if self.screening else None
            uploaded = n_iters > 0
            if demote and self.injecting:
                # the observed upload set: screened rows count as crashes
                uploaded = uploaded & ~corrupt
            new["values"] = value_update_device(carry["values"], sizes, ids,
                                                losses, uploaded)
            upf = uploaded.to(torch.float32)
            n_up = upf.sum()
            dropped = (pf["outcome"] == pred.DROPPED).to(torch.float32)
            stats = {
                "ids": ids, "n_iters": n_iters,
                "dropout": _mean(dropped), "dropped": dropped.sum(),
                "overflowed": (torch.zeros_like(n_up) if pf["ovf"] is None
                               else pf["ovf"].to(torch.float32).sum()),
                "train_loss": torch.where(
                    n_up > 0, (losses * upf).sum() / torch.clamp(n_up,
                                                                 min=1.0),
                    float("nan")),
                "assigned": _mean(pf["assigned"]),
                "uploaded": _mean(pf["e_eff"]),
                "true_workload": _mean(pf["E_true"]),
            }
            if telemetry:
                P = comp.n_params_of(carry["params"])
                bpc = comp.upload_bytes_per_client(P, self.compress,
                                                   self.topk_frac)
                dense_bpc = comp.upload_bytes_per_client(P, "none")
                stats["client_uploaded"] = uploaded.to(torch.int32)
                stats["upload_bytes"] = n_up * float(np.float32(bpc))
                stats["dense_upload_bytes"] = n_up * float(
                    np.float32(dense_bpc))
                stats["loss_hist"] = _device_hist(
                    losses, upf, 0.0, LOSS_HIST_MAX, LOSS_HIST_BINS)
                stats["workload_hist"] = _device_hist(
                    pf["e_eff"], upf, 0.0, wl["h_cap"], WORKLOAD_HIST_BINS)
            if self.screening:
                stats["screened"] = bad.to(torch.float32).sum()
            if quarantine:
                qf, qt, qs, n_susp = quarantine_update(
                    carry["q_fail"], carry["q_try"], carry["q_susp"], ids,
                    n_iters > 0, bad, pf["t"], q_threshold,
                    int(cfg.quarantine_rounds),
                    int(cfg.quarantine_min_tries))
                new.update(q_fail=qf, q_try=qt, q_susp=qs)
                stats["quarantined"] = n_susp.to(torch.float32)
            return new, stats

        @torch.no_grad()
        def one_round(carry, t, inputs):
            return execute(*prepare(carry, t, inputs))

        one_round.prepare = prepare
        one_round.execute = execute
        return one_round

    # ------------------------------------------------------------------
    def make_stream_round(self, loss_fn, max_steps: int) -> Callable:
        """Cross-silo round over pre-batched per-silo streams.

        ``loss_fn`` is a bare ``loss(params, batch)`` callable or a
        ``LocalStep`` (its ``loss``; its ``leaf_views``, if any, cuts the
        params into the autograd leaves each silo trains).

        round_fn(global_params, batches, n_steps, weights) ->
            (new_global_params, silo_mean_losses [K][, bad])
          batches: tree of tensors with leading axes [K, max_steps, ...]
          n_steps: [K] int local-step budgets (read on the host)
          weights: [K] f32 tensor of aggregation weights (0 = no upload)
          bad:     [K] bool CPU tensor of screened rows (with
                   ``screen_norm`` only)

        The silos train one after another (the reference ``vmap``s them),
        each for exactly its own ``n_steps`` steps: the compacted
        semantics, equal to the reference's masked ``p - lr * active * g``
        for finite gradients.  The reported loss of a silo is the mean over
        its executed steps (0 if none).  Each silo's params live in its row
        of one preallocated [K, ...] stack and are updated in place under
        ``torch.no_grad``, so a round holds the global params, the stack
        and one silo's gradients.  Aggregation runs through ``_finish``,
        the upload screen included (it screens the stack leaf row by leaf
        row and sanitizes in place, so it adds no second stack); under
        FedProx each local objective carries the proximal term.
        """
        if self.compressing:
            raise ValueError(
                "upload compression needs the packed client axis for "
                "residual state; the cross-silo stream round does not "
                "support it")
        if self.injecting:
            raise ValueError(
                "fault injection targets the packed client-axis rounds; "
                "the cross-silo stream round does not support it")
        views = getattr(loss_fn, "leaf_views", None) or (lambda p: p)
        if not callable(loss_fn):
            loss_fn = as_local_step(loss_fn).loss

        def train_silo(params, global_params, silo_batches, steps: int):
            """``steps`` SGD steps on ``params`` (views of the silo's stack
            row, updated in place); returns the mean loss."""
            total = self._train_in_place(
                loss_fn, views, params, global_params,
                lambda i: tree_map(lambda b: b[i], silo_batches), steps)
            return total / max(steps, 1)

        def round_fn(global_params, batches, n_steps, weights):
            steps = [min(int(v), max_steps) for v in n_steps]
            K = len(steps)
            leaves = tree_leaves(global_params)
            dev = leaves[0].device
            stack = tree_map(lambda g: torch.empty(
                (K,) + tuple(g.shape), dtype=g.dtype, device=g.device),
                global_params)
            losses = torch.zeros((K,), dtype=torch.float32, device=dev)
            for k in range(K):
                row = tree_map(lambda t: t[k], stack)
                with torch.no_grad():
                    for dst, src in zip(tree_leaves(row), leaves):
                        dst.copy_(src)
                with stage(STAGE_LOCAL_SGD):
                    losses[k] = train_silo(
                        row, global_params,
                        tree_map(lambda b: b[k], batches), steps[k])
            with torch.no_grad():
                new_global, _, bad = self._finish(
                    global_params, stack, weights.to(dev, torch.float32))
            if self.screening:
                return new_global, losses, bad
            return new_global, losses

        # one silo's local training alone (params updated in place), for a
        # caller that times or profiles a step
        round_fn.train_silo = train_silo
        return round_fn
