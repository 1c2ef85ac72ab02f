"""Model registry: name → builder, so exported bundles can be re-instantiated
for inference from their JSON config alone — counterpart of
``tensorflowonspark_tpu/models/registry.py``."""

from __future__ import annotations

import importlib
import logging
from typing import Callable

import torch

logger = logging.getLogger(__name__)

_REGISTRY: dict[str, Callable] = {}
_FAMILIES = ("transformer", "linear", "mnist", "resnet", "inception")


def register(name: str):
    def deco(builder: Callable):
        _REGISTRY[name] = builder
        return builder

    return deco


def build(config: dict) -> torch.nn.Module:
    """Instantiate a model from a bundle config ``{"model": name, ...}``."""
    name = config.get("model")
    if name not in _REGISTRY:
        # model modules self-register on import
        for mod in _FAMILIES:
            importlib.import_module(f"tensorflowonspark_torch.models.{mod}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](config)


def build_apply(config: dict, device=None) -> Callable:
    """Build ``apply(variables, x) -> tensor`` for a bundle config.

    ``variables`` is the bundle's tree in the JAX package's layout (flax
    names, numpy arrays): a bare param tree, or ``{"params": ...}`` with
    ``"batch_stats"`` beside it for the BN families (``convert.py`` maps
    the whole tree, running statistics included).  Its first call with a
    given tree converts it and loads it onto ``device`` — once, casting the
    matrices to the compute type there (``cast_matrices_``, so the model's
    cast at each use is a no-op) — and later calls with the same tree reuse
    the loaded weights.  The model runs in ``eval()`` (BatchNorm on its
    running statistics, the JAX ``train=False``) under
    ``torch.inference_mode()``; ``x`` may be numpy or a tensor, and the
    image families take it NHWC, as the JAX package does.  The loaded
    module is ``apply.model`` (the decode path, ``greedy_generate``, takes
    it).

    ``device`` defaults to ``cuda`` and raises when there is no card.
    """
    from tensorflowonspark_torch.convert import flax_to_torch
    from tensorflowonspark_torch.gpu_info import default_device

    dev = default_device(device)
    with torch.device("meta"):
        model = build(config).cast_matrices_()
    model = model.to_empty(device=dev).eval()
    loaded: list = [None]  # the tree whose weights the model holds

    def apply_fn(variables, x):
        if loaded[0] is not variables:
            model.load_state_dict(flax_to_torch(variables, config), strict=True)
            loaded[0] = variables
        with torch.inference_mode():
            return model(torch.as_tensor(x, device=dev))

    apply_fn.model = model
    return apply_fn
