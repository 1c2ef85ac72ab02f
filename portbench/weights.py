"""Weights made by the benchmark from the seed, on the device, in a few large
calls: one normal draw for every random leaf, then one scale for each
group of leaves that share a standard deviation.  The same seed gives the
same tensors on the same device, so the program's copy and the
reference's are made apart and agree bit for bit.

A spec is a list of ``(name, shape, init)``: ``init`` a standard deviation
(a float, for a zero-mean normal), ``"ones"`` or ``"zeros"``.
"""

from __future__ import annotations

import math


def make(spec: list, seed: int, device) -> dict:
    """``{name: float32 tensor}`` for ``spec``, from ``seed`` on ``device``."""
    import torch

    random = [(n, s, i) for n, s, i in spec if not isinstance(i, str)]
    total = sum(math.prod(s) for _, s, _ in random)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at, by_std = {}, 0, {}
    for name, shape, init in spec:
        if isinstance(init, str):
            fill = {"ones": torch.ones, "zeros": torch.zeros}[init]
            out[name] = fill(shape, device=device, dtype=torch.float32)
            continue
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
        by_std.setdefault(float(init), []).append(out[name])
    for std, leaves in by_std.items():
        torch._foreach_mul_(leaves, std)
    return out
