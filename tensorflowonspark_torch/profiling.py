"""Profiling/tracing — ``torch.profiler`` traces viewable in TensorBoard.

Counterpart of ``tensorflowonspark_tpu/profiling.py``.  Reference
(SURVEY.md §5.1): no in-repo profiler; observability is the TensorBoard
subprocess TFoS spawns and whatever users write in ``map_fun``.  The port
keeps that surface and backs it with ``torch.profiler``: ``trace`` writes a
Chrome-trace JSON (``<host>_<pid>.<time>.pt.trace.json``) into ``log_dir``,
the file TensorBoard's PyTorch profiler plugin reads and ``chrome://tracing``
or Perfetto open.

Surfaces:
- ``trace(log_dir)`` — context manager around a region (e.g. N train
  steps); the CPU activity always, the CUDA activity when a card exists;
- ``profile_steps(log_dir, step_fn, warmup, steps)`` — trace a step-loop
  window, the standard "skip the first kernel builds, profile steady state"
  recipe;
- ``annotate(name)`` — named sub-region (``torch.profiler.record_function``,
  a row of its own in the viewer);
- ``server(port)`` — the JAX package's on-demand profiler server has no
  ``torch.profiler`` counterpart: it raises, naming what to use instead.
"""

from __future__ import annotations

import contextlib
import logging
import os

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str, *, create_perfetto_link: bool = False):
    """Trace everything inside the block into ``log_dir`` (TensorBoard
    profile plugin format).  Safe on CPU-only test hosts.  Yields the
    ``torch.profiler.profile`` object (``key_averages()``, ``events()``)
    beside the file; ``create_perfetto_link`` is accepted for the JAX
    signature and ignored (the trace file opens in Perfetto as it is)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    del create_perfetto_link
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """Named trace region: ``with annotate('train_step'): ...``."""
    import torch

    return torch.profiler.record_function(name)


def profile_steps(log_dir: str, step_fn, *, warmup: int = 2, steps: int = 5):
    """Run ``step_fn()`` ``warmup`` times untraced (kernel builds, caches),
    then ``steps`` times inside a trace.  Returns the last step's result."""
    result = None
    for _ in range(warmup):
        result = step_fn()
    with trace(log_dir):
        for i in range(steps):
            with annotate(f"step_{i}"):
                result = step_fn()
    return result


def server(port: int = 9012):
    """The JAX package starts ``jax.profiler.start_server(port)`` here, the
    target of ``tensorboard capture``.  ``torch.profiler`` has no such
    server, so this raises instead of returning something that captures
    nothing."""
    raise NotImplementedError(
        f"profiling.server({port}): torch.profiler has no on-demand capture "
        "server; wrap the region in profiling.trace(log_dir) or use "
        "profiling.profile_steps(log_dir, step_fn), and open the trace "
        "with TensorBoard's PyTorch profiler plugin or Perfetto")
