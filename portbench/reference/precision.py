"""The products the references compute with: plain float32 (TF32 off), or
the control's float8, the precision just below the bfloat16 the
configurations state.

The float8 products round both operands to e4m3 with one scale per tensor
(its largest magnitude at e4m3's largest, 448), and in the backward the
incoming gradient to e5m2 the same way (largest 57344), as float8 training
does; each product is then taken in float32 on the rounded values.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32 while the block runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def round_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn, largest: float = E4M3_MAX):
    """``x`` rounded to ``dtype`` under one scale for the whole tensor."""
    scale = largest / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g, torch.float8_e5m2, E5M2_MAX)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class _Fp8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride):
        qx, qw = round_fp8(x), round_fp8(w)
        ctx.save_for_backward(qx, qw)
        ctx.stride = stride
        return F.conv2d(qx, qw, None, stride)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = round_fp8(g, torch.float8_e5m2, E5M2_MAX)
        gx = torch.nn.grad.conv2d_input(qx.shape, qw, qg, ctx.stride)
        gw = torch.nn.grad.conv2d_weight(qx, qw.shape, qg, ctx.stride)
        return gx, gw, None


class Products:
    """``matmul(a, b)`` (same batch dimensions, or ``b`` 2-D) and
    ``conv(x, w, stride)`` (unpadded) in the precision ``name``:
    ``"float32"`` or ``"float8"``."""

    def __init__(self, name: str):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def matmul(self, a, b):
        if self.name == "float32":
            return a @ b
        return _Fp8Matmul.apply(a, b)

    def conv(self, x, w, stride):
        if self.name == "float32":
            return F.conv2d(x, w, None, stride)
        return _Fp8Conv.apply(x, w, stride)
