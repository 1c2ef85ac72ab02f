"""Wide-and-deep for Criteo-style CTR data (``{"model": "wide_deep"}`` and
``{"model": "wide_deep_dense"}``) — counterpart of
``tensorflowonspark_tpu/models/wide_deep.py``, the model of BASELINE
config 4.

One ``[B, 13 + 26]`` float feature matrix per batch: 13 numeric columns and
26 categorical ids, hashed mod ``vocab_size`` into disjoint per-column id
ranges of ONE fused table (``26 * vocab_size`` rows).  The wide path is a
per-id scalar weight summed over the 26 columns plus a float32 linear layer
on the numeric columns; the deep path is the id embeddings and the numeric
columns through a relu MLP computed in ``compute_dtype`` (bfloat16 by the
registry default) over float32 master weights, with a float32 head.

Where a port goes wrong:

- Ids.  The JAX model casts the float id columns to int32 as XLA does, by
  saturation (NaN → 0, anything at or beyond ±2³¹ → the int32 limit), then
  takes a FLOOR mod (``jnp.mod``: -1 → vocab - 1).  ``_flat_ids`` does the
  same with ``torch.remainder`` (``torch.fmod`` would keep the sign) and an
  explicit clamp (a float → int cast out of range is undefined in C++ and
  differs between the CPU and the card).  The numpy ``flat_categorical_ids``
  of the sharded path casts to int64 instead, as the JAX package's does, so
  the two id schemes part for ids at or beyond 2³¹ (real Criteo hex
  categories reach 2³²) — exactly as they part in the JAX package.
- The table gradient of ``WideDeep`` is DENSE, as the VJP of ``jnp.take``
  is: ``F.embedding`` (not ``sparse=True``) scatters into a zero table of
  full size, and the optimizer then updates every row.
- Memory: the default ``vocab_size=100_003`` allocates ``2,600,078 x 16``
  float32 embeddings (166 MB) plus the wide column (10 MB), and Adagrad's
  accumulator doubles it.  Take ``vocab_size`` from the model config.

``WideDeepDense`` is everything but the tables: it consumes the
``[B, 26, embed_dim + 1]`` fused rows (``[embedding | wide weight]``) a
sharded-table lookup gathered (``embedding/table.py``), term for term the
same math, with the same parameter names.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.models import layers
from tensorflowonspark_torch.models.registry import register

NUM_NUMERIC = 13
NUM_CATEGORICAL = 26

# XLA's saturating float -> int32 cast, done in int64 where it is exact
_I32_MAX = 2**31 - 1
_I32_SPAN = float(2**31)


def _flat_ids(x: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """``[B, 39]`` features → ``[B, 26]`` int64 fused-table ids, as the JAX
    model computes them in-graph: ``mod(int32(x), vocab) + column offset``."""
    cat = torch.nan_to_num(x[:, NUM_NUMERIC:].float(), nan=0.0)
    cat = cat.clamp(-_I32_SPAN, _I32_SPAN).to(torch.int64).clamp(max=_I32_MAX)
    offsets = torch.arange(NUM_CATEGORICAL, device=x.device,
                           dtype=torch.int64) * vocab_size
    return torch.remainder(cat, vocab_size) + offsets


class _DeepHead(nn.Module):
    """The layers ``WideDeep`` and ``WideDeepDense`` share, under flax's
    names: ``wide_numeric``, ``Dense_i`` and ``deep_head``."""

    def __init__(self, embed_dim: int, hidden: Sequence[int],
                 compute_dtype: torch.dtype):
        super().__init__()
        self.embed_dim, self.hidden = embed_dim, tuple(hidden)
        self.compute_dtype = compute_dtype
        self.wide_numeric = layers.Dense(NUM_NUMERIC, 1)
        width = NUM_CATEGORICAL * embed_dim + NUM_NUMERIC
        for i, h in enumerate(self.hidden):
            setattr(self, f"Dense_{i}", layers.Dense(width, h, dtype=compute_dtype))
            width = h
        self.deep_head = layers.Dense(width, 1)

    def _logits(self, x: torch.Tensor, wide: torch.Tensor,
                emb: torch.Tensor) -> torch.Tensor:
        """``wide`` [B, 1] float32 summed table weights, ``emb`` [B, 26, D]."""
        numeric = x[:, :NUM_NUMERIC]
        wide = wide + self.wide_numeric(numeric.float())
        deep = torch.cat([emb.flatten(1).to(self.compute_dtype),
                          numeric.to(self.compute_dtype)], dim=-1)
        for i in range(len(self.hidden)):
            deep = F.relu(getattr(self, f"Dense_{i}")(deep))
        return (wide + self.deep_head(deep))[:, 0]

    def cast_matrices_(self):
        return layers.cast_matrices_(self, self.compute_dtype)


class WideDeep(_DeepHead):
    def __init__(self, vocab_size: int = 100_003, embed_dim: int = 16,
                 hidden: Sequence[int] = (256, 128, 64),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(embed_dim, hidden, compute_dtype)
        self.vocab_size = vocab_size
        rows = NUM_CATEGORICAL * vocab_size
        self.wide_weights = nn.Parameter(torch.zeros(rows, 1))
        self.embeddings = nn.Parameter(torch.empty(rows, embed_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 39] float32; cols 0..12 numeric, 13..38 categorical ids.
        Returns [B] logits."""
        ids = _flat_ids(x, self.vocab_size)
        wide = F.embedding(ids, self.wide_weights)[..., 0].sum(dim=1, keepdim=True)
        return self._logits(x, wide, F.embedding(ids, self.embeddings))

    def init_weights(self, generator: torch.Generator) -> "WideDeep":
        """flax's initialisers drawn from ``generator``: embeddings
        normal(0.01), a zero wide column, ``lecun_normal`` Dense kernels and
        zero biases."""
        layers.init_flax_(self, generator)
        with torch.no_grad():
            self.embeddings.normal_(0.0, 0.01, generator=generator)
            self.wide_weights.zero_()
        return self


class WideDeepDense(_DeepHead):
    """The dense half of wide-and-deep: everything except the tables, which
    live outside the module in the sharded embedding tier."""

    def __init__(self, vocab_size: int = 100_003, embed_dim: int = 16,
                 hidden: Sequence[int] = (256, 128, 64),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(embed_dim, hidden, compute_dtype)
        self.vocab_size = vocab_size  # id-space checks and export config only

    def forward(self, x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """x: [B, 39] raw features; rows: [B, 26, embed_dim + 1] gathered
        fused-table rows (last column = wide weight).  Returns [B] logits."""
        wide = rows[..., -1].float().sum(dim=1, keepdim=True)
        return self._logits(x, wide, rows[..., :self.embed_dim])

    def init_weights(self, generator: torch.Generator) -> "WideDeepDense":
        return layers.init_flax_(self, generator)


def _dtype(config: dict) -> torch.dtype:
    return torch.bfloat16 if config.get("bf16", True) else torch.float32


@register("wide_deep")
def build_wide_deep(config: dict) -> WideDeep:
    return WideDeep(vocab_size=config.get("vocab_size", 100_003),
                    embed_dim=config.get("embed_dim", 16),
                    hidden=tuple(config.get("hidden", (256, 128, 64))),
                    compute_dtype=_dtype(config))


@register("wide_deep_dense")
def build_wide_deep_dense(config: dict) -> WideDeepDense:
    return WideDeepDense(vocab_size=config.get("vocab_size", 100_003),
                         embed_dim=config.get("embed_dim", 16),
                         hidden=tuple(config.get("hidden", (256, 128, 64))),
                         compute_dtype=_dtype(config))


def table_total_rows(config: dict) -> int:
    """Fused-table row count for a wide_deep config (26 disjoint column
    id spaces)."""
    return NUM_CATEGORICAL * int(config.get("vocab_size", 100_003))


def flat_categorical_ids(features: np.ndarray, vocab_size: int) -> np.ndarray:
    """[B, 39] raw features -> [B, 26] int64 fused-table ids (the JAX
    package's numpy scheme for the sharded tier: an int64 cast, then the
    same mod and per-column offset)."""
    cat = np.mod(features[:, NUM_NUMERIC:].astype(np.int64), vocab_size)
    offsets = np.arange(NUM_CATEGORICAL, dtype=np.int64) * vocab_size
    return cat + offsets[None, :]


def init_params(model: WideDeep, generator: torch.Generator) -> WideDeep:
    """The JAX ``init_params``: the model's weights drawn from
    ``generator`` (the parameters live in the module)."""
    return model.init_weights(generator)


def init_dense_params(model: WideDeepDense,
                      generator: torch.Generator) -> WideDeepDense:
    return model.init_weights(generator)


def _loss_and_aux(logits: torch.Tensor, labels) -> tuple[torch.Tensor, dict]:
    """optax's ``sigmoid_binary_cross_entropy`` mean, and the accuracy."""
    labels = torch.as_tensor(labels, device=logits.device).float()
    loss = F.binary_cross_entropy_with_logits(logits.float(), labels,
                                              reduction="none").mean()
    preds = (logits > 0).float()
    return loss, {"accuracy": (preds == labels).float().mean()}


def make_loss_fn(model: WideDeep):
    """``loss_fn(model, batch) -> (loss, {"accuracy"})`` for
    ``parallel.dp.make_train_step``: binary cross-entropy on {0,1} click
    labels."""

    def loss_fn(model, batch):
        return _loss_and_aux(model(batch["features"]), batch["label"])

    return loss_fn


def make_sharded_grad_fn(model: WideDeepDense):
    """``grad_fn(model, rows, batch) -> ((loss, aux), (dense_g, row_g))``.

    ``dense_g`` is the ``{name: grad}`` dict of the module's parameters and
    ``row_g`` the gradient with respect to the gathered fused rows, per
    POSITION ([B, 26, D+1], float32);
    ``ShardedTable.apply_gradients`` dedups and scatter-adds it back to the
    owning shards.  ``rows`` and the batch's leaves may be numpy; they are
    moved to the module's device.  No ``.grad`` is written.
    """

    def grad_fn(model, rows, batch):
        dev = next(model.parameters()).device
        rows = torch.as_tensor(rows, dtype=torch.float32,
                               device=dev).detach().requires_grad_(True)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        logits = model(torch.as_tensor(batch["features"], device=dev), rows)
        loss, aux = _loss_and_aux(logits, batch["label"])
        grads = torch.autograd.grad(loss, [p for _, p in named] + [rows])
        dense = {n: g for (n, _), g in zip(named, grads[:-1])}
        return ((loss.detach(), {k: v.detach() for k, v in aux.items()}),
                (dense, grads[-1]))

    return grad_fn


def synthetic_criteo(n: int, seed: int = 0) -> list[dict]:
    """Learnable synthetic CTR rows: label correlates with numeric col 0 and
    categorical col 13 parity (the JAX package's, row for row)."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        numeric = rng.rand(NUM_NUMERIC).astype(np.float32)
        cat = rng.randint(0, 1000, NUM_CATEGORICAL).astype(np.float32)
        label = int((numeric[0] + (cat[0] % 2) * 0.5) > 0.75)
        rows.append({"features": np.concatenate([numeric, cat]), "label": label})
    return rows


def batch_to_arrays(items: list) -> dict:
    """(features, label) tuples or row dicts -> batch arrays."""
    if isinstance(items[0], dict):
        feats = np.stack([np.asarray(r["features"], np.float32) for r in items])
        labels = np.asarray([r["label"] for r in items], np.int32)
    else:
        feats = np.stack([np.asarray(f, np.float32) for f, _ in items])
        labels = np.asarray([l for _, l in items], np.int32)
    return {"features": feats, "label": labels}
