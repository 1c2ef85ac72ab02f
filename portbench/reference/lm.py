"""The plain decoder-only LM of the ``deepseek-llm-7b`` configuration, in
float32 (TF32 off) or in the control's float8 products: token embedding,
pre-norm blocks of RMSNorm, multi-head attention with rotary embedding
(half-split, as Llama and DeepSeek LLM rotate), a SwiGLU MLP, then RMSNorm,
an untied head and the mean next-token cross-entropy.  No biases.

Written from the published description (arXiv:2401.02954, the Llama
architecture), not from the program.  It fits the card at the timed sizes
by recomputing: each block is checkpointed, attention runs one batch row at
a time (each row checkpointed; the full causal score matrix of a row in
float32), and the loss over blocks of rows.

Parameter names: ``embed.weight``, ``blocks.{i}.attn_norm.scale``,
``blocks.{i}.attn.{q,k,v,o}_proj.weight``, ``blocks.{i}.mlp_norm.scale``,
``blocks.{i}.mlp.{gate,up,down}_proj.weight``, ``final_norm.scale`` and
``lm_head.weight``; matrices ``[out, in]``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import train
from portbench.reference.precision import Products, exact_float32

LOSS_ROWS = 2048  # rows of the head's product and the loss taken at once


def param_spec(cfg: dict) -> list:
    """``(name, shape, init)`` of every parameter, matrices and the
    embedding drawn at ``initializer_range``, norm scales ones."""
    d, v, f = cfg["hidden_size"], cfg["vocab_size"], cfg["intermediate_size"]
    width = cfg["num_attention_heads"] * cfg["head_dim"]
    std = cfg["initializer_range"]
    spec = [("embed.weight", (v, d), std)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"blocks.{i}."
        spec += [(p + "attn_norm.scale", (d,), "ones"),
                 (p + "attn.q_proj.weight", (width, d), std),
                 (p + "attn.k_proj.weight", (width, d), std),
                 (p + "attn.v_proj.weight", (width, d), std),
                 (p + "attn.o_proj.weight", (d, width), std),
                 (p + "mlp_norm.scale", (d,), "ones"),
                 (p + "mlp.gate_proj.weight", (f, d), std),
                 (p + "mlp.up_proj.weight", (f, d), std),
                 (p + "mlp.down_proj.weight", (d, f), std)]
    spec += [("final_norm.scale", (d,), "ones"), ("lm_head.weight", (v, d), std)]
    return spec


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """Rotate ``x [B, S, H, D]`` by position: the first half of each head
    against the second."""
    s, half = x.shape[1], x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angle = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    cos, sin = angle.cos()[None, :, None, :], angle.sin()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class LM:
    """The plain model over a parameter dict, in ``precision``."""

    def __init__(self, cfg: dict, precision: str = "float32"):
        self.cfg = cfg
        self.mm = Products(precision).matmul

    def linear(self, x, w):
        lead = x.shape[:-1]
        return self.mm(x.reshape(-1, x.shape[-1]), w.t()).view(*lead, w.shape[0])

    def _attend_row(self, q, k, v):
        """One batch row, ``[S, H, D]`` each: causal softmax attention."""
        s, d = q.shape[0], q.shape[-1]
        qh, kh, vh = (t.transpose(0, 1) for t in (q, k, v))          # [H, S, D]
        scores = self.mm(qh, kh.transpose(-1, -2)) / math.sqrt(d)    # [H, S, S]
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        p = torch.softmax(torch.where(keep, scores, float("-inf")), dim=-1)
        return self.mm(p, vh).transpose(0, 1)

    def block(self, x, w, i):
        cfg, p = self.cfg, f"blocks.{i}."
        b, s, _ = x.shape
        heads = (b, s, cfg["num_attention_heads"], cfg["head_dim"])
        h = rms_norm(x, w[p + "attn_norm.scale"], cfg["rms_norm_eps"])
        q = rope(self.linear(h, w[p + "attn.q_proj.weight"]).view(heads), cfg["rope_theta"])
        k = rope(self.linear(h, w[p + "attn.k_proj.weight"]).view(heads), cfg["rope_theta"])
        v = self.linear(h, w[p + "attn.v_proj.weight"]).view(heads)
        o = torch.stack([checkpoint(self._attend_row, q[r], k[r], v[r], use_reentrant=False)
                         for r in range(b)])
        x = x + self.linear(o.reshape(b, s, -1), w[p + "attn.o_proj.weight"])
        h = rms_norm(x, w[p + "mlp_norm.scale"], cfg["rms_norm_eps"])
        gate = self.linear(h, w[p + "mlp.gate_proj.weight"])
        up = self.linear(h, w[p + "mlp.up_proj.weight"])
        return x + self.linear(F.silu(gate) * up, w[p + "mlp.down_proj.weight"])

    def _nll_sum(self, h, targets, head):
        return F.cross_entropy(self.mm(h, head.t()), targets, reduction="sum")

    def loss(self, w, ids):
        """Mean cross-entropy of each next token over ``ids [B, S]``."""
        x = w["embed.weight"][ids.long()]
        for i in range(self.cfg["num_hidden_layers"]):
            x = checkpoint(self.block, x, w, i, use_reentrant=False)
        x = rms_norm(x, w["final_norm.scale"], self.cfg["rms_norm_eps"])
        h = x[:, :-1].reshape(-1, x.shape[-1])
        targets = ids[:, 1:].reshape(-1).long()
        total = sum(checkpoint(self._nll_sum, h[r:r + LOSS_ROWS], targets[r:r + LOSS_ROWS],
                               w["lm_head.weight"], use_reentrant=False)
                    for r in range(0, h.shape[0], LOSS_ROWS))
        return total / h.shape[0]


def readings(cfg: dict, weights: dict, batches: list, optimizer: dict,
             precision: str = "float32") -> dict:
    """``train.readings`` of the plain LM on ``batches`` (``[B, S]`` ids)."""
    model = LM(cfg, precision)
    with exact_float32():
        return train.readings(lambda w, _, ids: model.loss(w, ids), weights, {},
                              batches, optimizer)
