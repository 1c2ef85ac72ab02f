"""Minimal dense model (``{"model": "linear"}``) — counterpart of
``tensorflowonspark_tpu/models/linear.py``, used by the serving tests,
where the model under the gateway must cost microseconds.

``y = x @ w + b`` in float32.  The bundle holds the JAX package's plain
``{"w": [in_dim, out_dim], "b": [out_dim]}`` tree; ``convert.py`` maps it
to this module's ``weight`` ``[out_dim, in_dim]`` and ``bias``.
"""

from __future__ import annotations

import torch

from tensorflowonspark_torch.models.registry import register


class Linear(torch.nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        self.in_dim = int(config.get("in_dim", 16))
        self.out_dim = int(config.get("out_dim", self.in_dim))
        self.weight = torch.nn.Parameter(torch.empty(self.out_dim, self.in_dim))
        self.bias = torch.nn.Parameter(torch.empty(self.out_dim))

    def cast_matrices_(self) -> "Linear":
        """Serving's cast-once-at-load: the model computes in float32."""
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.linear(x.float(), self.weight, self.bias)


@register("linear")
def build_linear(config: dict) -> Linear:
    return Linear(config)
