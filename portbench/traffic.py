"""The one generator of the benchmark's traffic.  A mix is a data file,
``portbench/mixes/<name>.json``, whose ``kind`` picks how its rows are made;
every size and rate comes from the file, and every row from ``--seed``.

``token_rows``: a pool of ``pool_batches`` distinct batches of ``batch`` rows
of ``seq_len`` token ids, cycled.  Each row is the Zipf stream of
``examples_torch/llm/train_lm.py:synthetic_ids`` (``zipf(a) % vocab``),
frozen here, drawn from a ``numpy`` generator seeded with the run's seed
(any non-negative whole number; ``RandomState`` would stop at 2**32).

``images``: a pool of ``pool_batches`` distinct batches of ``batch``
``image_size``-pixel NHWC float32 images in [0, 1) and their labels, made
on the device by a ``torch.Generator`` in one call each.
"""

from __future__ import annotations

import numpy as np


def synthetic_ids(batch: int, seq_len: int, vocab: int, rng: np.random.Generator,
                  zipf_a: float = 1.5) -> np.ndarray:
    """Zipf-ish token stream: enough structure for the loss to move."""
    base = rng.zipf(zipf_a, size=(batch, seq_len)).astype("int64")
    return (base % vocab).astype("int32")


def token_pool(mix: dict, vocab: int, seed: int) -> list[np.ndarray]:
    """``mix["pool_batches"]`` batches ``[batch, seq_len]`` int32, batch
    ``i`` the same for every caller with this seed."""
    rng = np.random.default_rng([int(seed), 0x7A1F])
    return [synthetic_ids(mix["batch"], mix["seq_len"], vocab, rng, mix["zipf_a"])
            for _ in range(mix["pool_batches"])]


def image_pool(mix: dict, num_classes: int, seed: int, device) -> list[dict]:
    """``mix["pool_batches"]`` batches ``{"image": [B, H, W, 3] f32, "label":
    [B] int32}`` made on ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x1A6E5)
    b, size, n = mix["batch"], mix["image_size"], mix["pool_batches"]
    images = torch.rand((n, b, size, size, 3), generator=gen, device=device)
    labels = torch.randint(0, num_classes, (n, b), generator=gen, device=device,
                           dtype=torch.int64).to(torch.int32)
    return [{"image": images[i], "label": labels[i]} for i in range(n)]


def generate(mix: dict, config: dict, seed: int, device):
    """The mix's pool, by its ``kind``."""
    if mix["kind"] == "token_rows":
        return token_pool(mix, config["vocab_size"], seed)
    if mix["kind"] == "images":
        return image_pool(mix, config["num_classes"], seed, device)
    raise ValueError(f"unknown traffic kind {mix['kind']!r}")
