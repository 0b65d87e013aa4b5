"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``: the port
runs on the GPU unless the caller asks for the CPU (the tests do).  With no
GPU and no explicit CPU request it raises instead of quietly running on the
host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> cuda.  A CUDA device also pins float32 matmuls and
    convolutions to full float32: the port's parity tolerances (2e-5 for
    local SGD) are float32 tolerances, and TF32 keeps only ~3 decimal
    digits, so it is switched off explicitly rather than left to defaults."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
