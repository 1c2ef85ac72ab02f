"""Decoder-only transformer LM — counterpart of
``tensorflowonspark_tpu/models/transformer.py`` (its non-decode forward).

Pre-norm RMSNorm + RoPE + SwiGLU, f32 master weights with bf16 compute: the
matrices are cast to the compute type once, when the weights are loaded
(``models/registry.build_apply``); the norm scales stay f32, norms and RoPE
run in f32, and the logits come back in f32 — the JAX package's recipe.

Attention goes through ``ops.attention.flash_attention`` (the Hopper kernel
on a CUDA tensor, its plain version on a CPU tensor) for ``attn_impl`` in
``auto``/``pallas``/``pallas_interpret``; ``xla`` selects the plain
``blockwise_attention`` and ``reference`` the dense ``mha_reference``.
Parameter names follow the flax module names (``convert.py`` maps them).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.models.registry import register
from tensorflowonspark_torch.ops.attention import (
    blockwise_attention,
    flash_attention,
    mha_reference,
)

_ATTN = {
    "auto": flash_attention,
    "pallas": flash_attention,
    "pallas_interpret": flash_attention,
    "xla": blockwise_attention,
    "reference": mha_reference,
}


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotary embedding (half-split), ``x: [B, S, H, D]``, ``positions: [S]``."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32, device=x.device)
                      / half)
    angles = positions[:, None].float() * freqs[None, :]          # [S, half]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def forward(self, x):
        x32 = x.float()
        norm = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_head: int,
                 rope_theta: float = 10000.0, attn_impl: str = "auto",
                 compute_dtype=torch.bfloat16):
        super().__init__()
        if attn_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn_impl={attn_impl!r} (sequence parallelism) is not ported "
                "yet: ROADMAP.md queue 1 (e), MoE and parallel/*")
        if attn_impl not in _ATTN:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.n_heads, self.d_head = n_heads, d_head
        self.rope_theta = rope_theta
        self.attend = _ATTN[attn_impl]
        width = n_heads * d_head
        linear = lambda i, o: nn.Linear(i, o, bias=False, dtype=compute_dtype)  # noqa: E731
        self.q_proj = linear(d_model, width)
        self.k_proj = linear(d_model, width)
        self.v_proj = linear(d_model, width)
        self.o_proj = linear(width, d_model)

    def forward(self, x):
        b, s, _ = x.shape
        shape = (b, s, self.n_heads, self.d_head)
        q = self.q_proj(x).view(shape)
        k = self.k_proj(x).view(shape)
        v = self.v_proj(x).view(shape)
        positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, self.rope_theta)
        k = apply_rope(k, positions, self.rope_theta)
        out = self.attend(q, k, v, causal=True)
        return self.o_proj(out.reshape(b, s, -1))


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, compute_dtype=torch.bfloat16):
        super().__init__()
        self.gate_proj = nn.Linear(d_model, d_ff, bias=False, dtype=compute_dtype)
        self.up_proj = nn.Linear(d_model, d_ff, bias=False, dtype=compute_dtype)
        self.down_proj = nn.Linear(d_ff, d_model, bias=False, dtype=compute_dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_head: int, d_ff: int,
                 rope_theta: float = 10000.0, attn_impl: str = "auto",
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.attn_norm = RMSNorm(d_model)
        self.attn = Attention(d_model, n_heads, d_head, rope_theta, attn_impl,
                              compute_dtype)
        self.mlp_norm = RMSNorm(d_model)
        self.mlp = SwiGLU(d_model, d_ff, compute_dtype)

    def forward(self, x):
        x = x + self.attn(self.attn_norm(x))
        return x + self.mlp(self.mlp_norm(x))


class Transformer(nn.Module):
    """Decoder-only LM.  ``forward(input_ids: [B, S]) -> logits [B, S, V]`` (f32)."""

    def __init__(self, vocab_size: int, d_model: int, n_layers: int,
                 n_heads: int, d_head: int = 0, d_ff: int = 0,
                 n_experts: int = 0, rope_theta: float = 10000.0,
                 attn_impl: str = "auto", compute_dtype=torch.bfloat16,
                 decode: bool = False):
        super().__init__()
        if n_experts:
            raise NotImplementedError(
                "n_experts > 0 (MoE) is not ported yet: ROADMAP.md queue 1 (e), "
                "MoE and parallel/*")
        if decode:
            raise NotImplementedError(
                "decode=True (KV-cache decode) is not ported yet: ROADMAP.md "
                "queue 1 (b), the KV-cache decode path and greedy_generate")
        dh = d_head or d_model // n_heads
        dff = d_ff or 4 * d_model
        self.embed = nn.Embedding(vocab_size, d_model, dtype=compute_dtype)
        self.blocks = nn.ModuleList(
            Block(d_model, n_heads, dh, dff, rope_theta, attn_impl, compute_dtype)
            for _ in range(n_layers))
        self.final_norm = RMSNorm(d_model)
        self.lm_head = nn.Linear(d_model, vocab_size, bias=False,
                                 dtype=compute_dtype)

    def forward(self, input_ids):
        x = self.embed(input_ids)
        for block in self.blocks:
            x = block(x)
        return self.lm_head(self.final_norm(x)).float()


@register("transformer")
def build_transformer(config: dict) -> Transformer:
    return Transformer(
        vocab_size=int(config.get("vocab_size", 32000)),
        d_model=int(config.get("d_model", 512)),
        n_layers=int(config.get("n_layers", 4)),
        n_heads=int(config.get("n_heads", 8)),
        d_head=int(config.get("d_head", 0)),
        d_ff=int(config.get("d_ff", 0)),
        n_experts=int(config.get("n_experts", 0)),
        rope_theta=float(config.get("rope_theta", 10000.0)),
        attn_impl=config.get("attn_impl", "auto"),
        compute_dtype=torch.bfloat16 if config.get("bf16", True) else torch.float32,
        decode=bool(config.get("decode", False)),
    )


def pad_batch(token_lists, seq_len: int, pad_id: int = 0):
    """Ragged token lists → ``{"input_ids": [B,S], "loss_mask": [B,S]}``
    (numpy).  The mask marks real tokens; longer sequences are truncated."""
    b = len(token_lists)
    ids = np.full((b, seq_len), pad_id, np.int32)
    mask = np.zeros((b, seq_len), np.float32)
    for i, toks in enumerate(token_lists):
        n = min(len(toks), seq_len)
        ids[i, :n] = np.asarray(toks[:n], np.int32)
        mask[i, :n] = 1.0
    return {"input_ids": ids, "loss_mask": mask}


def pack_batch(token_lists, seq_len: int, eos_id: int, pad_id: int = 0,
               n_rows: int | None = None):
    """Greedy first-fit sequence packing (numpy), each document terminated
    by ``eos_id``; documents longer than a row are split across rows.
    ``n_rows`` fixes the batch dimension (short packs get all-masked rows; a
    pack that needs more rows raises).  Tokens may attend across document
    boundaries within a row."""
    rows: list[list[int]] = []
    for toks in token_lists:
        doc = list(toks) + [eos_id]
        placed = False
        for row in rows:
            if len(row) + len(doc) <= seq_len:
                row.extend(doc)
                placed = True
                break
        if not placed:
            while len(doc) > seq_len:
                rows.append(doc[:seq_len])
                doc = doc[seq_len:]
            if doc:
                rows.append(doc)
    if n_rows is not None:
        if len(rows) > n_rows:
            raise ValueError(
                f"pack needs {len(rows)} rows of {seq_len} but n_rows={n_rows}; "
                "raise n_rows or feed fewer tokens per pack")
        rows.extend([] for _ in range(n_rows - len(rows)))
    b = len(rows)
    ids = np.full((b, seq_len), pad_id, np.int32)
    mask = np.zeros((b, seq_len), np.float32)
    for i, row in enumerate(rows):
        ids[i, : len(row)] = np.asarray(row, np.int32)
        mask[i, : len(row)] = 1.0
    return {"input_ids": ids, "loss_mask": mask}
