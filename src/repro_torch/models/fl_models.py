"""Local-step models for the port's round engine.

The engine's model seam is ``LocalStep``: ``init_params(generator)``
builds a params dict of tensors in the reference's layout (MCLR:
``{"w": [d, C], "b": [C]}``, logits ``x @ w + b``), ``loss(params,
batch)`` maps params plus a padded batch (``x``/``y`` plus a 0/1 ``mask``
over padded rows) to a masked-mean scalar, and ``kind`` names families the
kernel layer has a fused implementation for.  The engine differentiates
``loss`` with ``torch.func`` and maps the SGD update over the dict.

This package ports MCLR, the paper's convex model, the two-layer tanh
MLP and the LSTM sentiment classifier (Sent140); ``models.api.from_model``
adapts the decoder LMs (``kind="lm"``), which train through the silo
round (``RoundEngine.make_stream_round``) and, as every client's local
step, through the packed round, lane by lane in place
(``RoundEngine._local_sgd``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from repro_torch.tree import tree_items, tree_leaves, tree_map, tree_unflatten


def mclr_init(generator: torch.Generator, n_features: int, n_classes: int,
              device: Optional[torch.device] = None):
    """N(0, 0.01^2) weights and zero bias, drawn from ``generator`` (which
    must live on ``device``).  Torch cannot reproduce the reference's
    threefry init; parity runs hand the reference's params in instead
    (``repro_torch.convert.params_from_reference``)."""
    w = torch.randn((n_features, n_classes), generator=generator,
                    device=device) * 0.01
    return {"w": w, "b": torch.zeros((n_classes,), device=device)}


def mclr_logits(params, x):
    return x @ params["w"] + params["b"]


def mclr_loss(params, batch):
    return _masked_nll(mclr_logits(params, batch["x"]), batch)


def mclr_accuracy(params, batch):
    return _masked_accuracy(mclr_logits(params, batch["x"]), batch)


def _masked_nll(logits, batch):
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["y"].long()[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _masked_accuracy(logits, batch):
    pred = torch.argmax(logits, dim=-1)
    hit = (pred == batch["y"].long()).to(torch.float32)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(hit)
    return (hit * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def mlp_init(generator: torch.Generator, n_features: int, hidden: int,
             n_classes: int, device: Optional[torch.device] = None):
    """N(0, 1/fan_in) weights and zero biases, drawn from ``generator``
    (which must live on ``device``), in the reference's insertion order
    w1, b1, w2, b2."""
    w1 = torch.randn((n_features, hidden), generator=generator,
                     device=device) * n_features ** -0.5
    w2 = torch.randn((hidden, n_classes), generator=generator,
                     device=device) * hidden ** -0.5
    return {"w1": w1, "b1": torch.zeros((hidden,), device=device),
            "w2": w2, "b2": torch.zeros((n_classes,), device=device)}


def mlp_logits(params, x):
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def mlp_loss(params, batch):
    return _masked_nll(mlp_logits(params, batch["x"]), batch)


def mlp_accuracy(params, batch):
    return _masked_accuracy(mlp_logits(params, batch["x"]), batch)


def lstm_init(generator: torch.Generator, vocab: int, embed: int = 32,
              hidden: int = 64, n_classes: int = 2,
              device: Optional[torch.device] = None):
    """N(0, 0.1^2) embeddings, N(0, 1/fan_in) weights and zero biases,
    drawn from ``generator`` (which must live on ``device``) in the
    reference's insertion order emb, wx, wh, b, w_out, b_out."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    return {"emb": normal(vocab, embed) * 0.1,
            "wx": normal(embed, 4 * hidden) * embed ** -0.5,
            "wh": normal(hidden, 4 * hidden) * hidden ** -0.5,
            "b": torch.zeros((4 * hidden,), device=device),
            "w_out": normal(hidden, n_classes) * hidden ** -0.5,
            "b_out": torch.zeros((n_classes,), device=device)}


def lstm_logits(params, tokens):
    """tokens: [B, S] integer -> [B, n_classes].  The reference scans the
    cell over the S tokens with ``lax.scan``; here it is a Python loop, a
    plain function of tensors (so ``torch.func`` batches and
    differentiates it).  The gates split z in the order i, f, g, o, with a
    forget bias of +1."""
    B, S = tokens.shape
    hidden = params["wh"].shape[0]
    # F.embedding, not params["emb"][tokens]: its backward is the dense
    # embedding backward (sorted on CUDA), where indexing would scatter
    # through index_put_(accumulate=True)
    emb = F.embedding(tokens.long(), params["emb"])       # [B, S, E]
    h = torch.zeros((B, hidden), dtype=emb.dtype, device=emb.device)
    c = torch.zeros((B, hidden), dtype=emb.dtype, device=emb.device)
    for t in range(S):
        z = emb[:, t] @ params["wx"] + h @ params["wh"] + params["b"]
        i, f, g, o = torch.split(z, hidden, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return h @ params["w_out"] + params["b_out"]


def lstm_loss(params, batch):
    return _masked_nll(lstm_logits(params, batch["x"]), batch)


def lstm_accuracy(params, batch):
    return _masked_accuracy(lstm_logits(params, batch["x"]), batch)


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is the meta device: an init that draws
    on its generator's device builds shapes only, with no storage."""

    @property
    def device(self):
        return torch.device("meta")


class LocalStep:
    """The model protocol ``RoundEngine`` consumes.

    * ``init_params(generator)`` — build the params tree of tensors on the
      generator's device (``init`` is its alias, as in the reference).
    * ``loss(params, batch)`` — masked-mean scalar loss; the engine takes
      its gradient with ``torch.func`` and applies the SGD update.
    * ``accuracy(params, batch)`` — optional; only evaluation uses it.
    * ``kind`` — the family tag the kernel layer dispatches on
      (``repro_torch.kernels.ops.fused_sgd_eligible``).
    * ``name`` — a label (``make_mclr`` etc. set theirs).
    * ``leaf_views`` — optional: maps a params tree to the tree ``loss``
      reads, with leaves cut into the views that the silo round trains as
      separate autograd leaves (the LM's per-layer rows of its stacked
      blocks, ``decoder.layer_views``).

    ``loss_and_grad`` and ``local_sgd_step`` are derived helpers;
    ``param_treedef`` and ``n_params`` read the params' structure from an
    init on the meta device (no storage), or from one CPU init when the
    step's init does not build on its generator's device.
    """

    def __init__(self, init_params, loss, accuracy=None, kind=None,
                 name=None, leaf_views=None):
        self.init_params = init_params
        self.init = init_params
        self.loss = loss
        self.accuracy = accuracy
        self.kind = kind
        self.name = name
        self.leaf_views = leaf_views

    def loss_and_grad(self, params, batch):
        """(loss, gradient tree of ``params``' structure), by autograd on
        detached leaves (``torch.func`` cannot take an LM's remat
        checkpoints); a leaf the loss does not read gets zeros."""
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = self.loss(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return loss.detach(), tree_unflatten(params, list(grads))

    def local_sgd_step(self, params, batch, lr):
        """One SGD step: (params - lr * grad, the loss before it)."""
        loss, grads = self.loss_and_grad(params, batch)
        return tree_map(lambda p, g: p - lr * g, params, grads), loss

    def _shapes(self, generator=None):
        if generator is not None:
            return self.init_params(generator)
        try:
            return self.init_params(_MetaGenerator())
        except (RuntimeError, NotImplementedError, TypeError):
            return self.init_params(torch.Generator("cpu").manual_seed(0))

    def param_treedef(self, generator=None):
        """The params' key paths in the port's flatten order
        (``repro_torch.tree``: dict keys sorted), the order the ``[K, P]``
        upload contract (``core.compression``) relies on."""
        return tuple(path for path, _ in tree_items(self._shapes(generator)))

    def n_params(self, generator=None) -> int:
        return sum(int(v.numel()) for v in
                   tree_leaves(self._shapes(generator)))


class FLModel(LocalStep):
    """The init/loss/accuracy triple as a thin ``LocalStep`` subclass, the
    reference's facade: every ``make_mclr``/``make_mlp``/``make_lstm``
    model is one."""

    def __init__(self, init, loss, accuracy, kind=None):
        super().__init__(init_params=init, loss=loss, accuracy=accuracy,
                         kind=kind)


def as_local_step(obj) -> LocalStep:
    """Coerce engine inputs to the ``LocalStep`` seam: a ``LocalStep`` is
    returned unchanged (identity), any object with a callable ``loss`` and
    a callable ``init_params`` or ``init`` is wrapped (its ``accuracy``,
    ``kind`` and ``name`` carried), anything else raises a ``TypeError``."""
    if isinstance(obj, LocalStep):
        return obj
    loss = getattr(obj, "loss", None)
    init = getattr(obj, "init_params", None) or getattr(obj, "init", None)
    if callable(loss) and callable(init):
        return LocalStep(init_params=init, loss=loss,
                         accuracy=getattr(obj, "accuracy", None),
                         kind=getattr(obj, "kind", None),
                         name=getattr(obj, "name", None))
    raise TypeError(
        f"cannot interpret {obj!r} as a LocalStep: need callable "
        "loss(params, batch) and init_params(rng)/init(rng)")


def _named(step: FLModel, name: str) -> FLModel:
    step.name = name
    return step


def make_mclr(n_features: int, n_classes: int) -> FLModel:
    return _named(FLModel(
        init=lambda gen: mclr_init(gen, n_features, n_classes, gen.device),
        loss=mclr_loss, accuracy=mclr_accuracy, kind="mclr"), "mclr")


def make_mlp(n_features: int, n_classes: int, hidden: int = 64) -> FLModel:
    return _named(FLModel(
        init=lambda gen: mlp_init(gen, n_features, hidden, n_classes,
                                  gen.device),
        loss=mlp_loss, accuracy=mlp_accuracy, kind="mlp"), "mlp")


def make_lstm(vocab: int, n_classes: int = 2, embed: int = 32,
              hidden: int = 64) -> FLModel:
    """The Sent140 LSTM.  It has no ``kind``: no fused local-SGD kernel
    exists for it, so the engine trains it on the plain ``torch.func``
    path, as the reference trains it through ``jax.grad``."""
    return _named(FLModel(
        init=lambda gen: lstm_init(gen, vocab, embed, hidden, n_classes,
                                   gen.device),
        loss=lstm_loss, accuracy=lstm_accuracy), "lstm")


#: the built-in steps ``resolve_local_step`` builds by name
LOCAL_STEPS = ("mclr", "mlp", "lstm")


def _dataset_dims(dataset):
    """(n_features, n_classes, vocab): vocab is the largest token of the
    clients' shards plus 1 for a text dataset (the test split is not
    read, as in the reference), else None."""
    x0 = dataset.clients_x[0]
    n_features = int(x0.shape[-1]) if x0.ndim > 1 else 1
    vocab = None
    if getattr(dataset, "task", "classification") == "text":
        vocab = int(max(int(x.max()) for x in dataset.clients_x)) + 1
    return n_features, int(dataset.n_classes), vocab


def resolve_local_step(spec, dataset) -> LocalStep:
    """Resolve a model spec to a ``LocalStep`` sized for ``dataset``.

    ``spec`` may be ``None`` (the dataset default: lstm for a text
    dataset, mclr otherwise), a name from ``LOCAL_STEPS``, an arch id
    known to ``repro_torch.configs.get_config`` (its smoke config,
    wrapped by ``models.api.from_model`` as a causal LM over the clients'
    tokens; an encoder-decoder id raises its ``ValueError``), or any other
    object, which ``as_local_step`` takes (a ``LocalStep`` returned
    unchanged: a full-width ``from_model`` step goes in this way; a
    duck-typed model wrapped; anything else a ``TypeError``)."""
    if spec is not None and not isinstance(spec, str):
        return as_local_step(spec)
    n_features, n_classes, vocab = _dataset_dims(dataset)
    text = vocab is not None
    if spec is None:
        spec = "lstm" if text else "mclr"
    if spec == "mclr":
        return make_mclr(n_features, n_classes)
    if spec == "mlp":
        return make_mlp(n_features, n_classes)
    if spec == "lstm":
        if not text:
            raise ValueError("model='lstm' needs a text (token) dataset")
        return make_lstm(vocab)
    # arch id -> smoke config -> causal-LM LocalStep (lazy import: keeps
    # fl_models free of the arch modules)
    from repro_torch.configs import get_config
    from repro_torch.models.api import from_model

    cfg = get_config(spec, smoke=True)
    if not text:
        raise ValueError(
            f"model={spec!r} is a token-sequence architecture; use a text "
            "dataset (e.g. sent140)")
    if cfg.vocab_size < vocab:
        raise ValueError(
            f"arch vocab {cfg.vocab_size} < dataset vocab {vocab}")
    return from_model(cfg)
