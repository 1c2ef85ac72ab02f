"""CUDA device discovery — the counterpart of ``tensorflowonspark_tpu/tpu_info.py``.

- ``is_gpu_available()`` answers whether this process can use a CUDA card;
- ``device_summary()`` reports what it sees (from ``torch.cuda``, plus the
  card's name and power limit as ``nvidia-smi`` gives them: a card set
  below its maximum power runs slower under load, so every measurement
  carries the limit beside it);
- ``default_device(device)`` resolves an entry point's ``device`` argument.
  The port's entry points run on the card unless the caller asks for the
  CPU, and raise when the card is wanted and absent: nothing carries on on
  the CPU by itself.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys


def is_gpu_available() -> bool:
    import torch

    return torch.cuda.is_available()


def _no_card_without_torch() -> bool:
    """True when no CUDA device can be visible to this process and torch is
    not loaded yet: ``CUDA_VISIBLE_DEVICES`` hides every card, or the host
    has no NVIDIA driver (no ``/dev/nvidiactl``).  The summary is then known
    without paying torch's import — a control-plane node (and every CPU
    test node) registers at once, as the JAX package's nodes skip jax's."""
    if "torch" in sys.modules:
        return False
    if os.environ.get("CUDA_VISIBLE_DEVICES", None) in ("", "-1"):
        return True
    return not os.path.exists("/dev/nvidiactl")


def nvidia_smi_name_power() -> list[str]:
    """One ``"<name>, <power limit>"`` line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them; empty when there is no ``nvidia-smi``."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return []
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def device_summary() -> dict:
    """What this process sees, in the shape of ``tpu_info.device_summary``."""
    if _no_card_without_torch():
        return {"platform": "cpu", "device_kind": "cpu", "num_devices": 0,
                "coords": [], "process_index": 0,
                "nvidia_smi": nvidia_smi_name_power()}
    import torch

    if not torch.cuda.is_available():
        return {"platform": "cpu", "device_kind": "cpu", "num_devices": 0,
                "coords": [], "process_index": _process_index(),
                "nvidia_smi": []}
    n = torch.cuda.device_count()
    return {
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(0),
        "num_devices": n,
        "coords": [[i] for i in range(n)],
        "process_index": _process_index(),
        "nvidia_smi": nvidia_smi_name_power(),
    }


def _process_index() -> int:
    """This process's rank in the torch.distributed world (0 outside one):
    what ``jax.process_index()`` gives the JAX package's summary."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def default_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Raises when a CUDA device is asked for and
    this process has none."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
