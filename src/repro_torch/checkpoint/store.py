"""Tensor checkpoints on ``torch.save``, the port's counterpart of the
reference's ``repro/checkpoint/msgpack_ckpt.py`` (which needs msgpack,
absent from the card's machine).

A tree of tensors or numpy arrays (nested dicts and lists) is flattened
to ``{"/"-joined key path: CPU tensor}`` and saved with the step and the
metadata, the metadata as one JSON string.  Loading goes through
``torch.load(weights_only=True)``, which restores tensors, strings and
numbers and unpickles nothing else.  Leaves come back as CPU tensors in
their saved dtypes (float64 history, int32 counters, a generator's uint8
state).

Writes are atomic: the payload is serialized in memory first (a value
that cannot be saved fails before any file is touched), then written to
a ``mkstemp`` file in the target directory, flushed, ``fsync``-ed and
``os.replace``-d over the target.  A failed write leaves the previous
checkpoint intact and no temp file behind.

The format is the port's own: a reference checkpoint does not load here,
nor the other way round.
"""
from __future__ import annotations

import io
import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _key_paths(tree, prefix=()):
    """(key path, leaf) pairs of a nested dict/list tree, dict keys in
    sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _key_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _key_paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _as_cpu_tensor(leaf) -> torch.Tensor:
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu").contiguous().clone()
    return torch.from_numpy(np.array(leaf, copy=True))


def _rebuild(like, tensors, prefix=()):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], tensors, prefix + (str(k),))
                for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, tensors, prefix + (str(i),))
                          for i, v in enumerate(like))
    key = "/".join(prefix)
    if key not in tensors:
        raise KeyError(f"checkpoint missing tensor {key!r}")
    return tensors[key]


def save_checkpoint(path: str, tree, step: int = 0,
                    metadata: Optional[Dict] = None) -> None:
    """Write ``tree`` (tensors or arrays at the leaves), ``step`` and the
    JSON-able ``metadata`` to ``path``, atomically."""
    payload = {"step": int(step),
               "metadata": json.dumps(metadata or {}, allow_nan=False),
               "tensors": {k: _as_cpu_tensor(v)
                           for k, v in _key_paths(tree)}}
    buf = io.BytesIO()
    torch.save(payload, buf)
    blob = buf.getvalue()
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            # the rename is only as durable as the data behind it: fsync
            # the temp file so a crash right after os.replace cannot leave
            # a named but empty checkpoint
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, like=None) -> Tuple[Any, int, Dict]:
    """Returns (tree, step, metadata).  With ``like`` the tree takes its
    structure (a missing leaf raises KeyError); without, it is the flat
    ``{key path: tensor}`` dict.  Leaves are CPU tensors in their saved
    dtypes."""
    with open(path, "rb") as f:
        payload = torch.load(f, map_location="cpu", weights_only=True)
    tensors = payload["tensors"]
    meta = json.loads(payload["metadata"])
    if like is None:
        return tensors, payload["step"], meta
    return _rebuild(like, tensors), payload["step"], meta
