"""The arithmetic precisions the reference can run its products in.

``float32`` is the precision the configurations state.  ``tf32`` is the
control: the nearest precision below it, as a tensor-core GEMM in TF32
would compute the vertex stage, each operand of a product rounded to
TF32's 10-bit mantissa and the sum kept in float32.  A comparison that
passes the control is too loose to catch that change.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float32", "tf32")


def check(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
    return precision


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as a product's operand: unchanged in float32, rounded to the
    nearest TF32 value (ties to even) in tf32."""
    x = x.to(torch.float32)
    if check(precision) == "float32":
        return x
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (0xFFF + ((bits >> 13) & 1))) & ~0x1FFF
    return bits.view(torch.float32)


def combine_columns(m: torch.Tensor, v: torch.Tensor, precision: str) -> torch.Tensor:
    """``m @ v`` per row as the fixed-order sum over columns of
    elementwise products, ((v0 m_i0 + v1 m_i1) + v2 m_i2) + v3 m_i3, for
    (R, C) ``m`` and (N, C) ``v``: the order the program's vertex
    transform states, so that a vertex's bits do not hang on a GEMM's
    summation order."""
    m, v = operand(m, precision), operand(v, precision)
    out = m[:, 0] * v[:, 0:1]
    for j in range(1, v.shape[-1]):
        out = out + m[:, j] * v[:, j : j + 1]
    return out


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """(R, K) @ (K, C) with float32 accumulation over rounded operands."""
    a, b = operand(a, precision), operand(b, precision)
    return torch.matmul(a, b)
