"""Inception-v3 (``{"model": "inception_v3"}``) — counterpart of
``tensorflowonspark_tpu/models/inception.py``, the model of BASELINE
config 5 (streaming inference).

The v3 topology: a ``VALID`` stem, 3x InceptionA, B, 4x InceptionC, D,
2x InceptionE, global average pool, head.  Every conv is a ``ConvBN``: a
bias-free conv in ``compute_dtype`` (bfloat16 by default), then a float32
``BatchNorm`` (momentum 0.9997, eps 1e-3) and relu.  The pooling branches
average over 3x3 ``SAME`` windows counting the pad cells, as flax's
``avg_pool`` does.  Submodules carry flax's names (``ConvBN_4``,
``InceptionC_2``, ``head``) so ``convert.py`` maps a JAX variables tree
leaf by leaf.  Any input of 75 px or more works (fully convolutional up to
the pool); the reference's is 299.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.models import layers
from tensorflowonspark_torch.models.registry import register


class ConvBN(nn.Module):
    def __init__(self, in_features: int, features: int, kernel: tuple,
                 strides: tuple = (1, 1), padding: str = "SAME",
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.Conv_0 = layers.Conv(in_features, features, kernel, strides, padding,
                                  use_bias=False, dtype=compute_dtype)
        self.BatchNorm_0 = layers.BatchNorm(features, momentum=0.9997, epsilon=1e-3,
                                            dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class _Block(nn.Module):
    """A block of ``ConvBN``s named ``ConvBN_<i>`` in flax's call order."""

    def __init__(self, compute_dtype):
        super().__init__()
        self.compute_dtype, self.n = compute_dtype, 0

    def cb(self, in_features, features, kernel, strides=(1, 1), padding="SAME"):
        m = ConvBN(in_features, features, kernel, strides, padding, self.compute_dtype)
        setattr(self, f"ConvBN_{self.n}", m)
        self.n += 1
        return m


def _avg_pool_same(x):
    return layers.avg_pool(x, (3, 3), (1, 1), "SAME")


def _max_pool_valid(x):
    return layers.max_pool(x, (3, 3), (2, 2), "VALID")


class InceptionA(_Block):
    def __init__(self, c: int, pool_features: int, compute_dtype=torch.bfloat16):
        super().__init__(compute_dtype)
        self.b1 = [self.cb(c, 64, (1, 1))]
        self.b5 = [self.cb(c, 48, (1, 1)), self.cb(48, 64, (5, 5))]
        self.b3 = [self.cb(c, 64, (1, 1)), self.cb(64, 96, (3, 3)), self.cb(96, 96, (3, 3))]
        self.bp = [self.cb(c, pool_features, (1, 1))]
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b5, x), _chain(self.b3, x),
                          _chain(self.bp, _avg_pool_same(x))], dim=1)


class InceptionB(_Block):
    def __init__(self, c: int, compute_dtype=torch.bfloat16):
        super().__init__(compute_dtype)
        self.b3 = [self.cb(c, 384, (3, 3), (2, 2), "VALID")]
        self.bd = [self.cb(c, 64, (1, 1)), self.cb(64, 96, (3, 3)),
                   self.cb(96, 96, (3, 3), (2, 2), "VALID")]
        self.out_features = 384 + 96 + c

    def forward(self, x):
        return torch.cat([_chain(self.b3, x), _chain(self.bd, x), _max_pool_valid(x)],
                         dim=1)


class InceptionC(_Block):
    def __init__(self, c: int, c7: int, compute_dtype=torch.bfloat16):
        super().__init__(compute_dtype)
        self.b1 = [self.cb(c, 192, (1, 1))]
        self.b7 = [self.cb(c, c7, (1, 1)), self.cb(c7, c7, (1, 7)), self.cb(c7, 192, (7, 1))]
        self.bd = [self.cb(c, c7, (1, 1)), self.cb(c7, c7, (7, 1)), self.cb(c7, c7, (1, 7)),
                   self.cb(c7, c7, (7, 1)), self.cb(c7, 192, (1, 7))]
        self.bp = [self.cb(c, 192, (1, 1))]
        self.out_features = 4 * 192

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b7, x), _chain(self.bd, x),
                          _chain(self.bp, _avg_pool_same(x))], dim=1)


class InceptionD(_Block):
    def __init__(self, c: int, compute_dtype=torch.bfloat16):
        super().__init__(compute_dtype)
        self.b3 = [self.cb(c, 192, (1, 1)), self.cb(192, 320, (3, 3), (2, 2), "VALID")]
        self.b7 = [self.cb(c, 192, (1, 1)), self.cb(192, 192, (1, 7)),
                   self.cb(192, 192, (7, 1)), self.cb(192, 192, (3, 3), (2, 2), "VALID")]
        self.out_features = 320 + 192 + c

    def forward(self, x):
        return torch.cat([_chain(self.b3, x), _chain(self.b7, x), _max_pool_valid(x)],
                         dim=1)


class InceptionE(_Block):
    def __init__(self, c: int, compute_dtype=torch.bfloat16):
        super().__init__(compute_dtype)
        self.b1 = [self.cb(c, 320, (1, 1))]
        self.b3 = [self.cb(c, 384, (1, 1))]
        self.b3_split = [self.cb(384, 384, (1, 3)), self.cb(384, 384, (3, 1))]
        self.bd = [self.cb(c, 448, (1, 1)), self.cb(448, 384, (3, 3))]
        self.bd_split = [self.cb(384, 384, (1, 3)), self.cb(384, 384, (3, 1))]
        self.bp = [self.cb(c, 192, (1, 1))]
        self.out_features = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x):
        b3, bd = _chain(self.b3, x), _chain(self.bd, x)
        return torch.cat([_chain(self.b1, x), *(m(b3) for m in self.b3_split),
                          *(m(bd) for m in self.bd_split),
                          _chain(self.bp, _avg_pool_same(x))], dim=1)


def _chain(mods, x):
    for m in mods:
        x = m(x)
    return x


class InceptionV3(_Block):
    """Between the ``ConvBN``s the activations are float32 (the BN's output
    type); each conv casts its input to ``compute_dtype``."""

    def __init__(self, num_classes: int = 1000, compute_dtype=torch.bfloat16):
        super().__init__(compute_dtype)
        self.num_classes = num_classes
        self.stem = [self.cb(3, 32, (3, 3), (2, 2), "VALID"),
                     self.cb(32, 32, (3, 3), padding="VALID"), self.cb(32, 64, (3, 3))]
        self.stem2 = [self.cb(64, 80, (1, 1), padding="VALID"),
                      self.cb(80, 192, (3, 3), padding="VALID")]
        plan = [(InceptionA, (32,)), (InceptionA, (64,)), (InceptionA, (64,)),
                (InceptionB, ()), *[(InceptionC, (c7,)) for c7 in (128, 160, 160, 192)],
                (InceptionD, ()), (InceptionE, ()), (InceptionE, ())]
        c, counts, self.block_names = 192, {}, []
        for kind, extra in plan:
            name = f"{kind.__name__}_{counts.setdefault(kind, 0)}"
            counts[kind] += 1
            block = kind(c, *extra, compute_dtype=compute_dtype)
            setattr(self, name, block)
            self.block_names.append(name)
            c = block.out_features
        self.head = layers.Dense(c, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)   # NCHW, channels_last
        x = _max_pool_valid(_chain(self.stem, x))
        x = _max_pool_valid(_chain(self.stem2, x))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.head(x.mean(dim=(2, 3)))

    def init_weights(self, generator: torch.Generator) -> "InceptionV3":
        return layers.init_flax_(self, generator)

    def cast_matrices_(self) -> "InceptionV3":
        return layers.cast_matrices_(self, self.compute_dtype)


@register("inception_v3")
def build_inception_v3(config: dict) -> InceptionV3:
    return InceptionV3(
        num_classes=config.get("num_classes", 1000),
        compute_dtype=torch.bfloat16 if config.get("bf16", True) else torch.float32,
    )


def synthetic_images(n: int, image_size: int = 299, seed: int = 0) -> list[np.ndarray]:
    """Deterministic synthetic images (the JAX package's, image for image)."""
    rng = np.random.RandomState(seed)
    return [rng.rand(image_size, image_size, 3).astype(np.float32) for _ in range(n)]
