"""The reference's arithmetic precisions: float32 as stated, the
precisions one step below, which the controls run in, and bfloat16, a
witness of what the program's own compute type alone does to a number.

Each lower precision is emulated by rounding the operands of every matrix
product, so that it reads the same on any device: ``tf32`` rounds float32
to TF32's 10-bit mantissa (round to nearest, ties to even), ``fp8`` scales
each operand by its largest magnitude into float8 e4m3's range and rounds
it there, ``bf16`` rounds to bfloat16 (round to nearest, ties to even).
The product itself accumulates in float32.  Under autograd the
gradient reaching a rounded operand is rounded too, as the backward
products of such training take it: to TF32, or to float8 e5m2 (scaled
the same way), the format fp8 training keeps gradients in, or to
bfloat16.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float32", "tf32", "bf16", "fp8")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), as float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(bits, 13), 1)
    bits = torch.bitwise_and(bits + 0x0FFF + lsb, ~0x1FFF)
    return bits.view(torch.float32)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bfloat16 value, as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def fp8_round(x: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """float32 -> float8 (e4m3 unless ``fmt`` says otherwise) with one
    scale for the tensor (its largest magnitude at the format's largest
    finite value), back in float32."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = amax / torch.finfo(fmt).max
    return (x / scale).to(fmt).to(torch.float32) * scale


class _Rounded(torch.autograd.Function):
    """Round forward by ``fwd``, and the gradient backward by ``bwd``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def _e5m2(g):
    return fp8_round(g, torch.float8_e5m2)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A matrix product's operand in ``precision``."""
    if precision == "float32":
        return x
    if precision == "tf32":
        return _Rounded.apply(x, tf32_round, tf32_round)
    if precision == "bf16":
        return _Rounded.apply(x, bf16_round, bf16_round)
    if precision == "fp8":
        return _Rounded.apply(x, fp8_round, _e5m2)
    raise ValueError(f"unknown precision {precision!r}; choose from "
                     f"{PRECISIONS}")


def matmul(a, b, precision: str = "float32"):
    """``a @ b`` with both operands in ``precision``, float32 sums."""
    return operand(a, precision) @ operand(b, precision)


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32 on the card, restored on exit."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
