"""Rounding to a precision and back to float32.

A product of two operands rounded to bf16 or fp8 and summed in float32 is
what a tensor core computes with those operand types and f32 accumulation;
the float32 products run with TF32 off (``exact_matmuls``). fp8 (e4m3)
scales each tensor by its largest magnitude first, as a per-tensor-scaled
fp8 product does.
"""

from __future__ import annotations

from typing import Callable

import torch

FP8_MAX = 448.0   # the largest finite float8_e4m3fn


def float32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def bfloat16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def float8_e4m3(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    amax = torch.amax(torch.abs(x))
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


ROUND = {"float32": float32, "bfloat16": bfloat16, "float8_e4m3": float8_e4m3}
# the type a stage computes in where it computes in one type throughout (the env step)
DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the next precision below each (the control's)
BELOW = {"float32": "bfloat16", "bfloat16": "float8_e4m3"}


def rounder(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return ROUND[name]


def exact_matmuls():
    """float32 products in float32 (TF32 off), as a float32 reference needs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
