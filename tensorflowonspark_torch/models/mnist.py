"""MNIST CNN (``{"model": "mnist_cnn"}``) — counterpart of
``tensorflowonspark_tpu/models/mnist.py``, the model of BASELINE configs 1
and 2.

3x3 ``SAME`` convs with bias, each followed by relu and a 2x2/2 max pool,
then a relu Dense and a float32 head.  ``bf16`` computes the convs and the
hidden Dense in bfloat16 over float32 master weights.  The input is the
JAX package's NHWC batch ``[B, 28, 28, 1]``; the activations are flattened
in NHWC order before the first Dense, as flax flattens them, so the JAX
package's ``Dense_0`` kernel loads with a plain transpose.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.models import layers
from tensorflowonspark_torch.models.registry import register
from tensorflowonspark_torch.parallel.dp import accuracy, cross_entropy_loss


class MnistCNN(nn.Module):
    def __init__(self, num_classes: int = 10, features: tuple = (32, 64),
                 dense: int = 256, compute_dtype: torch.dtype = torch.float32,
                 image_shape: tuple = (28, 28, 1)):
        super().__init__()
        self.compute_dtype = compute_dtype
        h, w, c = image_shape
        for i, feat in enumerate(features):
            setattr(self, f"Conv_{i}", layers.Conv(c, feat, (3, 3), dtype=compute_dtype))
            c, h, w = feat, h // 2, w // 2
        self.n_convs = len(features)
        self.Dense_0 = layers.Dense(h * w * c, dense, dtype=compute_dtype)
        self.Dense_1 = layers.Dense(dense, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)                    # NHWC -> NCHW, channels_last
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
            x = layers.max_pool(x, (2, 2), (2, 2))
        x = x.permute(0, 2, 3, 1).flatten(1)          # flax's NHWC flatten
        return self.Dense_1(F.relu(self.Dense_0(x)))

    def init_weights(self, generator: torch.Generator) -> "MnistCNN":
        return layers.init_flax_(self, generator)

    def cast_matrices_(self) -> "MnistCNN":
        return layers.cast_matrices_(self, self.compute_dtype)


@register("mnist_cnn")
def build_mnist(config: dict) -> MnistCNN:
    return MnistCNN(
        num_classes=config.get("num_classes", 10),
        features=tuple(config.get("features", (32, 64))),
        dense=config.get("dense", 256),
        compute_dtype=torch.bfloat16 if config.get("bf16") else torch.float32,
    )


def make_loss_fn(model: MnistCNN):
    """``loss_fn(model, batch) -> (loss, {"accuracy"})`` for
    ``parallel.dp.make_train_step``."""

    def loss_fn(model, batch):
        logits = model(batch["image"])
        return (cross_entropy_loss(logits, batch["label"]),
                {"accuracy": accuracy(logits, batch["label"])})

    return loss_fn


def synthetic_mnist(n: int, seed: int = 0) -> list[tuple[np.ndarray, int]]:
    """Deterministic learnable synthetic digits: class k lights up stripe k
    (the JAX package's, sample for sample)."""
    rng = np.random.RandomState(seed)
    samples = []
    for i in range(n):
        label = i % 10
        img = rng.rand(28, 28, 1).astype(np.float32) * 0.1
        img[label * 2 : label * 2 + 2, :, 0] += 1.0
        samples.append((img, label))
    return samples


def batch_to_arrays(items: list) -> dict:
    """A list of ``(image, label)`` samples as a batch dict of numpy arrays."""
    images = np.stack([np.asarray(i, np.float32).reshape(28, 28, 1) for i, _ in items])
    labels = np.asarray([l for _, l in items], np.int32)
    return {"image": images, "label": labels}
