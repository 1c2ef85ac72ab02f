"""The flax layers the image models are built from, with flax's semantics in
PyTorch: ``Conv``, ``Dense``, ``BatchNorm``, ``max_pool`` and ``avg_pool``.

Activations are NCHW tensors held in ``channels_last`` memory (cuDNN's
natural layout for 16-bit convolutions on Hopper): a model takes the JAX
package's NHWC batch and ``permute(0, 3, 1, 2)``s it, which is that layout
at no copy.  Parameters are float32 master weights cast to the layer's
compute type at use, as flax's ``dtype=`` does.

Where flax and torch differ:

- ``SAME`` padding.  For stride s and window k the total pad of a side of
  length n is ``max((ceil(n/s) - 1)·s + k - n, 0)``, the low side gets
  ``total // 2`` and the high side the rest (``same_pads``).  torch's
  symmetric ``padding=`` is right only when the two are equal; otherwise the
  input is padded explicitly (zeros for a conv, -inf for a max pool).
- ``BatchNorm`` momentum is flax's, the weight of the *old* running value
  (0.9 is torch's 0.1); the running variance takes the *biased* batch
  variance, where torch's takes the unbiased one; statistics are float32
  whatever the input type, and the output is the layer's ``dtype``.
- flax's ``avg_pool`` divides by the whole window, pad cells included.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# flax's lecun_normal: a normal truncated at ±2 std, its std divided by the
# std of the standard normal truncated there so the result has 1/sqrt(fan_in)
_TRUNC_STD = 0.87962566103423978


def same_pads(size: int, window: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``SAME`` padding of one spatial side: ``(low, high)``."""
    total = max((math.ceil(size / stride) - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pads(padding: str, hw, window, strides) -> tuple[tuple[int, int], ...]:
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return tuple(same_pads(n, k, s) for n, k, s in zip(hw, window, strides))


def _pad_input(x, pads, value: float = 0.0):
    """``(x, symmetric padding)``: ``x`` padded explicitly where a side's two
    pads differ, else unchanged with the pads for the op's ``padding=``."""
    (lh, hh), (lw, hw) = pads
    if lh == hh and lw == hw:
        return x, (lh, lw)
    return F.pad(x, (lw, hw, lh, hh), value=value), (0, 0)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal`` in place: fan_in is everything but the output
    axis (``in·kh·kw`` for a conv kernel ``[out, in, kh, kw]``)."""
    std = (weight[0].numel() ** -0.5) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


class Conv(nn.Module):
    """``flax.linen.Conv`` on NCHW: kernel ``[out, in, kh, kw]`` in
    ``channels_last`` memory, ``SAME`` or ``VALID`` padding, computed in
    ``dtype``."""

    def __init__(self, in_features: int, features: int, kernel: tuple,
                 strides: tuple = (1, 1), padding: str = "SAME",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.padding, self.dtype = padding, dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, *self.kernel)
                                   .to(memory_format=torch.channels_last))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        pads = _pads(self.padding, x.shape[-2:], self.kernel, self.strides)
        x, padding = _pad_input(x, pads)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.strides, padding)


class Dense(nn.Module):
    """``flax.linen.Dense``: kernel ``[out, in]``, computed in ``dtype``."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the channel axis of NCHW.

    ``momentum`` is flax's (the old running value's weight).  In training
    mode the batch statistics are float32 and the running averages move as
    flax moves them: ``m·old + (1-m)·batch``, with the biased batch variance.
    PyTorch's fused batch norm (cuDNN on the card) moves ``running_var``
    with the unbiased one, so it moves a copy and a C-length correction
    follows: ``moved·(n-1)/n + m·old/n`` is flax's value, n the count per
    channel.
    The output is ``dtype``; an input narrower than ``dtype`` is widened
    first, since flax normalises in float32 and rounds only the output.
    """

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.weight = nn.Parameter(torch.ones(features))   # flax's scale
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype.itemsize < self.dtype.itemsize:
            x = x.to(self.dtype)
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                             self.bias, False, 0.0, self.epsilon)
            return y.to(self.dtype)
        # the op moves a copy of running_var (autograd keeps what the op was
        # given, so it must not change after the call); the buffer, still
        # the old value, then takes flax's average
        moved = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, moved, self.weight, self.bias,
                         True, 1.0 - self.momentum, self.epsilon)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.mul_(self.momentum / n).add_(moved, alpha=(n - 1) / n)
        return y.to(self.dtype)


def max_pool(x: torch.Tensor, window: tuple, strides: tuple,
             padding: str = "VALID") -> torch.Tensor:
    """``flax.linen.max_pool``: ``SAME`` pads with -inf."""
    pads = _pads(padding, x.shape[-2:], window, strides)
    x, pad = _pad_input(x, pads, value=float("-inf"))
    return F.max_pool2d(x, window, strides, pad)


def avg_pool(x: torch.Tensor, window: tuple, strides: tuple,
             padding: str = "VALID") -> torch.Tensor:
    """``flax.linen.avg_pool``: the sum over the window divided by its size,
    pad cells included."""
    pads = _pads(padding, x.shape[-2:], window, strides)
    x, pad = _pad_input(x, pads)
    return F.avg_pool2d(x, window, strides, pad, count_include_pad=True)


def init_flax_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initialisers for every ``Conv``/``Dense`` of ``model``, drawn
    from ``generator``: ``lecun_normal`` kernels and zero biases
    (``BatchNorm`` starts at scale 1, bias 0, mean 0, var 1 by
    construction)."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (Conv, Dense)):
                lecun_normal_(module.weight, generator)
                if module.bias is not None:
                    module.bias.zero_()
    return model


def cast_matrices_(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Serving's cast-once-at-load: the kernels of every ``Conv``/``Dense``
    that computes in ``dtype`` are stored in it (the cast at each use is
    then a no-op); norm parameters and float32 layers stay float32."""
    for module in model.modules():
        if isinstance(module, (Conv, Dense)) and module.dtype == dtype:
            module.weight.data = module.weight.data.to(dtype)
            if module.bias is not None:
                module.bias.data = module.bias.data.to(dtype)
    return model
