"""Serving: the node-side replica loop (the gateway comes with the cluster layer)."""

from tensorflowonspark_torch.serving.loop import serving_loop  # noqa: F401
