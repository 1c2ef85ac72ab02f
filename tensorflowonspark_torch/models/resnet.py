"""ResNet family (ResNet-50 flagship) — counterpart of
``tensorflowonspark_tpu/models/resnet.py``, the model of BASELINE config 3.

Bottleneck v1.5 blocks (the stride on the 3x3), flax's ``SAME`` padding
(the 7x7/2 stem pads (2, 3) at 224 px, the 3x3/2 convs (0, 1), the 3x3/2
max pool (0, 1) with -inf), flax-semantics ``BatchNorm`` (momentum 0.9,
eps 1e-5; float32 statistics, ``norm_dtype`` output), and bfloat16
compute over float32 master weights by default.  Submodules carry flax's
names (``conv_init``, ``bn_init``, ``BottleneckBlock_7``, ``Conv_3``,
``BatchNorm_3``, ``head``), so ``convert.py`` maps a JAX variables tree
leaf by leaf.  The batch is NHWC ``[B, H, W, 3]``; inside, activations are
NCHW in ``channels_last`` memory (``models/layers.py``).

Training mode (``model.train()``) normalises with the batch statistics and
moves the running averages, as flax's ``train=True`` with
``mutable=["batch_stats"]``; ``model.eval()`` is ``train=False``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.models import layers
from tensorflowonspark_torch.models.registry import register
from tensorflowonspark_torch.parallel.dp import accuracy, cross_entropy_loss

_STEM_CHANNELS = {"imagenet": 3, "cifar": 3, "space_to_depth": 12}


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with a projection shortcut where the
    shape changes; the last BN scale starts at zero."""

    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 compute_dtype=torch.bfloat16, norm_dtype=torch.bfloat16):
        super().__init__()
        conv = partial(layers.Conv, use_bias=False, dtype=compute_dtype)
        norm = partial(layers.BatchNorm, momentum=0.9, epsilon=1e-5, dtype=norm_dtype)
        out = filters * 4
        self.Conv_0, self.BatchNorm_0 = conv(in_features, filters, (1, 1)), norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3), (strides, strides))
        self.BatchNorm_1 = norm(filters)
        self.Conv_2, self.BatchNorm_2 = conv(filters, out, (1, 1)), norm(out)
        nn.init.zeros_(self.BatchNorm_2.weight)
        self.project = strides != 1 or in_features != out
        if self.project:
            self.Conv_3 = conv(in_features, out, (1, 1), (strides, strides))
            self.BatchNorm_3 = norm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.project:
            residual = self.BatchNorm_3(self.Conv_3(residual))
        return F.relu(residual + y.to(residual.dtype))


class ResNet(nn.Module):
    """``stem``: "imagenet" (7x7/2 conv + 3x3/2 max pool, 224 px inputs),
    "cifar" (3x3/1 conv, no pool, 32 px) or "space_to_depth" (2x2 blocks
    stacked into 12 channels, a 4x4/1 conv, then the pool; the same output
    shape as "imagenet", weights not interchangeable with it)."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), num_classes: int = 1000,
                 width: int = 64, compute_dtype=torch.bfloat16,
                 norm_dtype=torch.bfloat16, stem: str = "imagenet"):
        super().__init__()
        if stem not in _STEM_CHANNELS:
            raise ValueError(f"unknown stem {stem!r}; one of {sorted(_STEM_CHANNELS)}")
        self.stem, self.compute_dtype = stem, compute_dtype
        kernel, strides = {"imagenet": ((7, 7), (2, 2)), "cifar": ((3, 3), (1, 1)),
                           "space_to_depth": ((4, 4), (1, 1))}[stem]
        self.conv_init = layers.Conv(_STEM_CHANNELS[stem], width, kernel, strides,
                                     use_bias=False, dtype=compute_dtype)
        self.bn_init = layers.BatchNorm(width, momentum=0.9, epsilon=1e-5,
                                        dtype=norm_dtype)
        c, i = width, 0
        for stage, size in enumerate(stage_sizes):
            for block in range(size):
                strides = 2 if stage > 0 and block == 0 else 1
                filters = width * 2 ** stage
                setattr(self, f"BottleneckBlock_{i}",
                        BottleneckBlock(c, filters, strides, compute_dtype, norm_dtype))
                c, i = filters * 4, i + 1
        self.n_blocks = i
        self.head = layers.Dense(c, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stem == "space_to_depth":
            n, h, w, c = x.shape
            x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(n, h // 2, w // 2, 4 * c)
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)   # NCHW, channels_last
        x = F.relu(self.bn_init(self.conv_init(x)))
        if self.stem != "cifar":
            x = layers.max_pool(x, (3, 3), (2, 2), "SAME")
        for i in range(self.n_blocks):
            x = getattr(self, f"BottleneckBlock_{i}")(x)
        return self.head(x.mean(dim=(2, 3)))              # global average pool

    def init_weights(self, generator: torch.Generator) -> "ResNet":
        """flax's initialisers (``layers.init_flax_``), the last BN scale of
        each block kept at zero."""
        return layers.init_flax_(self, generator)

    def cast_matrices_(self) -> "ResNet":
        return layers.cast_matrices_(self, self.compute_dtype)


def _dtypes(config: dict) -> dict:
    bf16 = config.get("bf16", True)
    return {
        "compute_dtype": torch.bfloat16 if bf16 else torch.float32,
        "norm_dtype": torch.bfloat16 if bf16 and config.get("bf16_norm", True)
                      else torch.float32,
    }


@register("resnet50")
def build_resnet50(config: dict) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3),
                  num_classes=config.get("num_classes", 1000),
                  width=config.get("width", 64),
                  stem=config.get("stem", "imagenet"), **_dtypes(config))


@register("resnet18")
def build_resnet18(config: dict) -> ResNet:
    """Smaller sibling for tests (the same code path, 4x fewer blocks)."""
    return ResNet(stage_sizes=(2, 2, 2, 2),
                  num_classes=config.get("num_classes", 1000),
                  width=config.get("width", 64), **_dtypes(config))


@register("resnet_cifar")
def build_resnet_cifar(config: dict) -> ResNet:
    """CIFAR-size ResNet (bottleneck, 3x3 stem, no max pool); ``depth_blocks``
    n gives 9n+2 layers (default n=3, ResNet-29)."""
    n = config.get("depth_blocks", 3)
    return ResNet(stage_sizes=(n, n, n),
                  num_classes=config.get("num_classes", 10),
                  width=config.get("width", 16), stem="cifar", **_dtypes(config))


def make_loss_fn(model: ResNet, weight_decay: float = 1e-4):
    """``loss_fn(model, batch) -> (loss, {"accuracy"})`` for
    ``parallel.dp.make_bn_train_step``: cross-entropy plus
    ``weight_decay/2 · Σ p²`` over the conv and dense kernels only (the
    parameters with ndim > 1; no decay on BN scales and biases).  Run in
    training mode, the forward moves the BN running averages."""

    def loss_fn(model, batch):
        logits = model(batch["image"])
        loss = cross_entropy_loss(logits, batch["label"])
        # the kernels as the layers use them: whole under fsdp, where the
        # parameters are this rank's blocks
        l2 = sum(m.weight.square().sum() for m in model.modules()
                 if isinstance(m, (layers.Conv, layers.Dense)))
        return (loss + weight_decay * 0.5 * l2,
                {"accuracy": accuracy(logits, batch["label"])})

    return loss_fn


def synthetic_imagenet(n: int, image_size: int = 224, num_classes: int = 1000,
                       seed: int = 0) -> list[tuple[np.ndarray, int]]:
    """Deterministic synthetic images (the JAX package's, sample for sample)."""
    rng = np.random.RandomState(seed)
    return [(rng.rand(image_size, image_size, 3).astype(np.float32), int(i % num_classes))
            for i in range(n)]


def batch_to_arrays(items: list) -> dict:
    images = np.stack([np.asarray(img, np.float32) for img, _ in items])
    labels = np.asarray([l for _, l in items], np.int32)
    return {"image": images, "label": labels}
