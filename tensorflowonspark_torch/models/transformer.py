"""Decoder-only transformer LM — counterpart of
``tensorflowonspark_tpu/models/transformer.py``.

Pre-norm RMSNorm + RoPE + SwiGLU, f32 master weights with bf16 compute, the
JAX package's recipe: the parameters are f32 (flax's ``param_dtype``) and
each matrix is cast to the compute type where it is used, so training's
gradients are f32 with respect to f32 weights.  Serving casts the matrices
once, at load (``cast_matrices_``, called by ``models/registry.build_apply``),
which makes the cast at use a no-op.  Norm scales stay f32, norms and RoPE
run in f32, and the logits come back in f32.

Attention goes through ``ops.attention.flash_attention`` (the Hopper kernel
on a CUDA tensor, its plain version on a CPU tensor; under autograd its
recompute backward) for ``attn_impl`` in ``auto``/``pallas``/
``pallas_interpret``; ``xla`` selects the plain ``blockwise_attention`` and
``reference`` the dense ``mha_reference``.  Passing a ``KVCache`` to
``forward`` selects the decode path (``Attention._decode_step``: plain
einsum attention over the cache, as in the JAX package).  Parameter names
follow the flax module names (``convert.py`` maps them).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tensorflowonspark_torch.models.registry import register
from tensorflowonspark_torch.ops.attention import (
    NEG_INF,
    blockwise_attention,
    flash_attention,
    mha_reference,
)
from tensorflowonspark_torch.ops.xent import blockwise_cross_entropy

_ATTN = {
    "auto": flash_attention,
    "pallas": flash_attention,
    "pallas_interpret": flash_attention,
    "xla": blockwise_attention,
    "reference": mha_reference,
}
# flax's lecun_normal: a normal truncated at ±2 std, its std divided by the
# std of the standard normal truncated there so the result has 1/sqrt(fan_in)
_TRUNC_STD = 0.87962566103423978


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


class Dense(nn.Linear):
    """Bias-free ``nn.Linear`` whose weight is cast to ``compute_dtype`` at
    each use (flax ``Dense(dtype=...)``)."""

    def __init__(self, d_in: int, d_out: int, compute_dtype):
        super().__init__(d_in, d_out, bias=False)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))


class Embed(nn.Embedding):
    """``nn.Embedding`` whose rows come out in ``compute_dtype``."""

    def __init__(self, vocab: int, dim: int, compute_dtype):
        super().__init__(vocab, dim)
        self.compute_dtype = compute_dtype

    def forward(self, ids):
        return F.embedding(ids, self.weight).to(self.compute_dtype)


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
        self.compute_dtype = compute_dtype
        self.attend = _ATTN[attn_impl]
        width = n_heads * d_head
        self.q_proj = Dense(d_model, width, compute_dtype)
        self.k_proj = Dense(d_model, width, compute_dtype)
        self.v_proj = Dense(d_model, width, compute_dtype)
        self.o_proj = Dense(width, d_model, compute_dtype)

    def forward(self, x, kv=None):
        b, s, _ = x.shape
        shape = (b, s, self.n_heads, self.d_head)
        q = self.q_proj(x).view(shape)
        k = self.k_proj(x).view(shape)
        v = self.v_proj(x).view(shape)
        if kv is not None:
            return self._decode_step(q, k, v, *kv)
        positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, self.rope_theta)
        k = apply_rope(k, positions, self.rope_theta)
        out = self.attend(q, k, v, causal=True)
        return self.o_proj(out.reshape(b, s, -1))

    def _decode_step(self, q, k, v, cache_k, cache_v, cur: int):
        """``s`` tokens through the static ``[B, L, H, D]`` cache: writes
        slots ``[cur, cur + s)`` in place and attends each query to every
        slot up to its own position.  One code path for both phases: the
        prefill (the whole prompt in one call) and one-token steps."""
        b, s = q.shape[:2]
        pos = cur + torch.arange(s, device=q.device)  # RoPE positions of the slab
        q = apply_rope(q, pos, self.rope_theta)
        k = apply_rope(k, pos, self.rope_theta)
        cache_k[:, cur:cur + s] = k
        cache_v[:, cur:cur + s] = v
        # slots past cur + s are masked for every query: leave them out
        keys, values = cache_k[:, :cur + s].float(), cache_v[:, :cur + s].float()
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), keys) / math.sqrt(self.d_head)
        keep = torch.arange(cur + s, device=q.device)[None, :] <= pos[:, None]
        logits = torch.where(keep, logits, NEG_INF)
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), values)
        return self.o_proj(out.to(self.compute_dtype).reshape(b, s, -1))


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, compute_dtype=torch.bfloat16):
        super().__init__()
        self.gate_proj = Dense(d_model, d_ff, compute_dtype)
        self.up_proj = Dense(d_model, d_ff, compute_dtype)
        self.down_proj = Dense(d_ff, d_model, compute_dtype)

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

    def forward(self, x, kv=None):
        x = x + self.attn(self.attn_norm(x), kv)
        return x + self.mlp(self.mlp_norm(x))


@dataclasses.dataclass
class KVCache:
    """The decode path's state, passed to ``Transformer.forward`` and
    returned from it: per layer a static ``[B, L, H, D]`` key and value
    buffer in the compute type, and ``index``, the next free slot.  A
    forward writes the buffers in place and advances ``index``."""

    k: list
    v: list
    index: int = 0

    @classmethod
    def empty(cls, model: "Transformer", batch: int, max_len: int, device=None):
        shape = (batch, max_len, model.n_heads, model.d_head)
        dev = device if device is not None else model.embed.weight.device

        def buf():
            return torch.zeros(shape, dtype=model.compute_dtype, device=dev)

        return cls([buf() for _ in model.blocks], [buf() for _ in model.blocks])

    @property
    def max_len(self) -> int:
        return self.k[0].shape[1]


class Transformer(nn.Module):
    """Decoder-only LM.  ``forward(input_ids: [B, S]) -> logits [B, S, V]``
    (f32); ``return_hidden=True`` gives the final-norm hidden states instead
    (the lm_head product then goes into a blockwise loss, ``ops/xent.py``);
    ``forward(ids, cache)`` runs the decode path and returns
    ``(logits, cache)``.

    ``remat`` recomputes each block's activations in the backward
    (``torch.utils.checkpoint``, the JAX package's ``nn.remat``).
    Parameters are created f32 with torch's default init; ``init_weights``
    draws flax's distributions from a ``torch.Generator``."""

    def __init__(self, vocab_size: int, d_model: int, n_layers: int,
                 n_heads: int, d_head: int = 0, d_ff: int = 0,
                 n_experts: int = 0, rope_theta: float = 10000.0,
                 attn_impl: str = "auto", compute_dtype=torch.bfloat16,
                 remat: bool = False):
        super().__init__()
        if n_experts:
            raise NotImplementedError(
                "n_experts > 0 (MoE) is not ported yet: ROADMAP.md queue 1 (e), "
                "MoE and parallel/*")
        self.n_heads = n_heads
        self.d_head = d_head or d_model // n_heads
        self.compute_dtype = compute_dtype
        self.remat = remat
        dff = d_ff or 4 * d_model
        self.embed = Embed(vocab_size, d_model, compute_dtype)
        self.blocks = nn.ModuleList(
            Block(d_model, n_heads, self.d_head, dff, rope_theta, attn_impl,
                  compute_dtype)
            for _ in range(n_layers))
        self.final_norm = RMSNorm(d_model)
        self.lm_head = Dense(d_model, vocab_size, compute_dtype)

    def forward(self, input_ids, cache: KVCache | None = None, *,
                return_hidden: bool = False):
        x = self.embed(input_ids)
        if cache is not None:
            s = input_ids.shape[1]
            if cache.index + s > cache.max_len:
                raise ValueError(f"cache holds {cache.max_len} positions; "
                                 f"{cache.index} used, {s} more asked")
            for i, block in enumerate(self.blocks):
                x = block(x, (cache.k[i], cache.v[i], cache.index))
            cache.index += s
        else:
            remat = self.remat and torch.is_grad_enabled()
            for block in self.blocks:
                x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        x = self.final_norm(x)
        out = x if return_hidden else self.lm_head(x).float()
        return out if cache is None else (out, cache)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Transformer":
        """flax's initialisers, drawn from ``generator`` (on the weights'
        device): ``Dense``/``DenseGeneral`` kernels ``lecun_normal`` (std
        1/sqrt(fan_in), fan_in = H·Dh for ``o_proj``), ``Embed`` a normal of
        std 1/sqrt(d_model), norm scales 1."""
        for module in self.modules():
            if isinstance(module, Dense):
                std = module.weight.shape[1] ** -0.5 / _TRUNC_STD
                nn.init.trunc_normal_(module.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
            elif isinstance(module, Embed):
                module.weight.normal_(0.0, module.weight.shape[1] ** -0.5,
                                      generator=generator)
            elif isinstance(module, RMSNorm):
                module.scale.fill_(1.0)
        return self

    def cast_matrices_(self) -> "Transformer":
        """Cast the matrices (not the norm scales) to the compute type in
        place: serving's cast-once-at-load."""
        for module in self.modules():
            if isinstance(module, (Dense, Embed)):
                module.to(self.compute_dtype)
        return self


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
        remat=bool(config.get("remat", False)),
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


def _pick(logits, temperature: float, top_k: int, generator):
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    scaled = logits.float() / temperature
    if top_k:
        kth = scaled.topk(top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled >= kth, scaled, -torch.inf)
    return torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                             generator=generator)[:, 0]


def greedy_generate(model: Transformer, prompt_ids, max_new_tokens: int,
                    max_decode_len: int = 0, temperature: float = 0.0,
                    top_k: int = 0, seed: int = 0,
                    eos_id: int | None = None, pad_id: int = 0) -> np.ndarray:
    """Autoregressive decoding through a static ``KVCache``.

    ``prompt_ids: [B, S]`` → ``[B, S + max_new_tokens]`` int32 (numpy), on
    the device of ``model``'s weights: one prefill forward over the whole
    prompt, then one-token steps.  ``temperature == 0`` is greedy argmax;
    ``> 0`` samples from ``softmax(logits / temperature)``, optionally cut
    to the ``top_k`` most likely tokens, from a ``torch.Generator`` seeded
    with ``seed`` (deterministic per seed; not JAX's bits).  ``eos_id``: a
    row that emits it keeps its EOS and gets ``pad_id`` from then on, and
    the loop ends once every row has finished (so the width may be less).
    """
    prompt = np.asarray(prompt_ids, dtype=np.int32)
    b, s = prompt.shape
    total = max_decode_len or (s + max_new_tokens)
    if total < s + max_new_tokens:
        raise ValueError(f"max_decode_len {total} < prompt {s} + new {max_new_tokens}")
    dev = model.embed.weight.device
    cache = KVCache.empty(model, b, total, device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    tokens = [prompt[:, i] for i in range(s)]
    finished = np.zeros((b,), bool)
    with torch.inference_mode():
        logits, cache = model(torch.from_numpy(prompt).to(dev), cache)
        for _ in range(max_new_tokens):
            nxt = _pick(logits[:, -1], temperature, top_k, generator)
            nxt = nxt.cpu().numpy().astype(np.int32)
            if eos_id is not None:
                nxt = np.where(finished, pad_id, nxt).astype(np.int32)
                finished |= nxt == eos_id
            tokens.append(nxt)
            if eos_id is not None and finished.all():
                break
            logits, cache = model(torch.from_numpy(nxt[:, None]).to(dev), cache)
    return np.stack(tokens, axis=1)


def make_loss_fn(model: Transformer, aux_loss_coef: float = 0.01,
                 vocab_chunk: int = 0, router_z_coef: float = 1e-3):
    """Next-token LM loss ``loss_fn(model, batch) -> (total, metrics)``;
    ``model`` takes the place of the JAX package's ``params``.  Batch:
    ``{"input_ids": [B, S]}`` (targets are the inputs shifted left), and an
    optional ``"loss_mask"`` ``[B, S]`` over which the loss is averaged.

    ``vocab_chunk > 0`` fuses the lm_head product into
    ``blockwise_cross_entropy``: the ``[B, S, V]`` logits are never made.
    ``metrics`` holds ``lm_loss``, ``aux_loss`` and ``router_z_loss``; the
    two MoE terms (weighted by ``aux_loss_coef`` and ``router_z_coef``) are
    zero until MoE is ported (ROADMAP.md queue 1 (e))."""
    if not isinstance(model, Transformer):
        raise TypeError(f"make_loss_fn takes a Transformer, got {type(model).__name__}")

    def _reduce(nll, batch):
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=nll.device)[:, 1:].float()
            loss = (nll * mask).sum() / mask.sum().clamp(min=1.0)
        else:
            loss = nll.mean()
        aux = z = nll.new_zeros(())  # MoE's load-balance and router-z sums
        total = loss + aux_loss_coef * aux + router_z_coef * z
        return total, {"lm_loss": loss, "aux_loss": aux, "router_z_loss": z}

    def loss_fn(m: Transformer, batch):
        ids = torch.as_tensor(batch["input_ids"], device=m.embed.weight.device)
        targets = ids[:, 1:].long()
        if vocab_chunk:
            h = m(ids, return_hidden=True)
            b, s, d = h.shape
            kernel = m.lm_head.weight.to(h.dtype).t()              # [D, V]
            nll = blockwise_cross_entropy(h[:, :-1].reshape(b * (s - 1), d),
                                          kernel, targets.reshape(-1),
                                          chunk=vocab_chunk)
            return _reduce(nll.view(b, s - 1), batch)
        logits = m(ids)[:, :-1]
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              targets.reshape(-1), reduction="none")
        return _reduce(nll.view(targets.shape), batch)

    return loss_fn
