"""Shared helpers of the image-model parity tests (``tests/test_torch_mnist.py``,
``test_torch_resnet.py``, ``test_torch_inception.py``): JAX variables of a
flax image model, filled from a seeded numpy generator.

The shapes come from ``jax.eval_shape`` of the model's own init, which
compiles nothing; the values are non-trivial everywhere (kernels of scale
1/sqrt(fan_in), BN scales near 1, biases, running means and variances away
from 0 and 1), so a transposed kernel, a swapped statistic or a misnamed
layer cannot hide.  JAX's own ``init`` of the deep nets compiles for tens
of seconds on the CPU; the values it would draw matter to neither side.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def random_variables(model, image_shape: tuple, seed: int = 0, **init_kwargs) -> dict:
    shapes = jax.eval_shape(
        lambda r: model.init(r, jnp.zeros((1, *image_shape), jnp.float32), **init_kwargs),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.2 * rng.randn(*shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*shape)).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)      # bias, mean

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def images(n: int, size: int, channels: int = 3, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).rand(n, size, size, channels).astype(np.float32)
