"""The plain ResNet-50 of the ``resnet50-imagenet`` configuration, in float32
(TF32 off) or in the control's float8 products, trained as the
configuration states: batch statistics in training mode, the running
averages moved, a softmax cross-entropy plus an L2 term.

Written from the published description (arXiv:1512.03385, Table 1; the
bottleneck with its stride on the 3x3, "v1.5") and the conventions of the
JAX original's flax layers, which the configuration states and the
reference writes out itself:

- ``SAME`` padding as XLA pads it: a side of length n under a window k and
  stride s gets ``max((ceil(n/s) - 1)·s + k - n, 0)`` in all, the low side
  the half rounded down; max pooling pads with -inf.
- Batch norm's momentum is the old running value's weight,
  ``m·old + (1 - m)·batch``, with the biased batch variance.
- The L2 term is ``weight_decay / 2 · Σ w²`` over the convolution and dense
  kernels only.

Parameter names: ``conv_init.weight``, ``bn_init.{weight,bias}``,
``BottleneckBlock_{i}.Conv_{j}.weight``, ``BottleneckBlock_{i}.BatchNorm_{j}.
{weight,bias}`` (j = 3: the projection), ``head.{weight,bias}``; buffers
``….running_mean`` and ``….running_var``.  Kernels ``[out, in, kh, kw]``;
images NHWC.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import train
from portbench.reference.precision import Products, exact_float32


def blocks(cfg: dict) -> list:
    """``(name, in_channels, filters, stride)`` of every bottleneck block."""
    out, c, i = [], cfg["width"], 0
    for stage, size in enumerate(cfg["stage_sizes"]):
        for block in range(size):
            filters = cfg["width"] * 2 ** stage
            out.append((f"BottleneckBlock_{i}", c, filters,
                        2 if stage > 0 and block == 0 else 1))
            c, i = filters * 4, i + 1
    return out


def _conv_spec(name, c_in, c_out, k):
    return (name + ".weight", (c_out, c_in, k, k), (c_in * k * k) ** -0.5)


def _bn_spec(name, c, scale="ones"):
    return [(name + ".weight", (c,), scale), (name + ".bias", (c,), "zeros")]


def param_spec(cfg: dict) -> list:
    """Parameters ``(name, shape, init)``: kernels normal of std
    ``1/sqrt(fan_in)``, batch-norm scales ones and biases zeros, but each
    block's last scale zeros (the residual branch starts closed, as the
    JAX original and Goyal et al., arXiv:1706.02677, start it)."""
    w = cfg["width"]
    spec = [_conv_spec("conv_init", 3, w, 7), *_bn_spec("bn_init", w)]
    for name, c_in, f, stride in blocks(cfg):
        spec += [_conv_spec(f"{name}.Conv_0", c_in, f, 1), *_bn_spec(f"{name}.BatchNorm_0", f),
                 _conv_spec(f"{name}.Conv_1", f, f, 3), *_bn_spec(f"{name}.BatchNorm_1", f),
                 _conv_spec(f"{name}.Conv_2", f, 4 * f, 1),
                 *_bn_spec(f"{name}.BatchNorm_2", 4 * f, "zeros")]
        if stride != 1 or c_in != 4 * f:
            spec += [_conv_spec(f"{name}.Conv_3", c_in, 4 * f, 1),
                     *_bn_spec(f"{name}.BatchNorm_3", 4 * f)]
    c = 4 * w * 2 ** (len(cfg["stage_sizes"]) - 1)
    spec += [("head.weight", (cfg["num_classes"], c), c ** -0.5),
             ("head.bias", (cfg["num_classes"],), "zeros")]
    return spec


def buffer_spec(cfg: dict) -> list:
    """The running averages: means zeros, variances ones."""
    out = []
    for name, shape, init in param_spec(cfg):
        if name.endswith(".bias") and not name.startswith("head"):
            stem = name[:-len(".bias")]
            out += [(stem + ".running_mean", shape, "zeros"),
                    (stem + ".running_var", shape, "ones")]
    return out


def same_pads(size: int, window: int, stride: int) -> tuple[int, int]:
    total = max((math.ceil(size / stride) - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, window, stride, value=0.0):
    (lh, hh), (lw, hw) = (same_pads(n, window, stride) for n in x.shape[-2:])
    return F.pad(x, (lw, hw, lh, hh), value=value)


class ResNet50:
    """The plain model over parameter and buffer dicts, in ``precision``."""

    def __init__(self, cfg: dict, precision: str = "float32"):
        self.cfg = cfg
        self.products = Products(precision)

    def conv(self, x, w, stride):
        k = w.shape[-1]
        return self.products.conv(_pad_same(x, k, stride), w, stride)

    def bn(self, x, w, buf, name):
        """Training-mode batch norm over N, H, W, moving ``buf`` in place."""
        mean = x.mean(dim=(0, 2, 3))
        var = x.square().mean(dim=(0, 2, 3)) - mean.square()
        m, eps = self.cfg["bn_momentum"], self.cfg["bn_epsilon"]
        with torch.no_grad():
            buf[name + ".running_mean"].mul_(m).add_(mean, alpha=1 - m)
            buf[name + ".running_var"].mul_(m).add_(var, alpha=1 - m)
        inv = torch.rsqrt(var + eps) * w[name + ".weight"]
        return ((x - mean[None, :, None, None]) * inv[None, :, None, None]
                + w[name + ".bias"][None, :, None, None])

    def forward(self, w, buf, images):
        x = images.permute(0, 3, 1, 2)                                   # NCHW
        x = F.relu(self.bn(self.conv(x, w["conv_init.weight"], 2), w, buf, "bn_init"))
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        for name, c_in, f, stride in blocks(self.cfg):
            y = F.relu(self.bn(self.conv(x, w[f"{name}.Conv_0.weight"], 1), w, buf,
                               f"{name}.BatchNorm_0"))
            y = F.relu(self.bn(self.conv(y, w[f"{name}.Conv_1.weight"], stride), w, buf,
                               f"{name}.BatchNorm_1"))
            y = self.bn(self.conv(y, w[f"{name}.Conv_2.weight"], 1), w, buf,
                        f"{name}.BatchNorm_2")
            if f"{name}.Conv_3.weight" in w:
                x = self.bn(self.conv(x, w[f"{name}.Conv_3.weight"], stride), w, buf,
                            f"{name}.BatchNorm_3")
            x = F.relu(x + y)
        pooled = x.mean(dim=(2, 3))
        return self.products.matmul(pooled, w["head.weight"].t()) + w["head.bias"]

    def loss(self, w, buf, batch):
        logits = self.forward(w, buf, batch["image"])
        ce = F.cross_entropy(logits, batch["label"].long())
        l2 = sum(p.square().sum() for n, p in w.items()
                 if n.endswith(".weight") and p.dim() > 1)
        return ce + self.cfg["weight_decay"] * 0.5 * l2


def readings(cfg: dict, weights: dict, buffers: dict, batches: list, optimizer: dict,
             precision: str = "float32") -> dict:
    """``train.readings`` of the plain ResNet-50 on ``batches``."""
    model = ResNet50(cfg, precision)
    with exact_float32():
        return train.readings(model.loss, weights, buffers, batches, optimizer)
