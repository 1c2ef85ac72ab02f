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

``n_experts > 0`` replaces each block's SwiGLU by ``parallel.ep.MoEMLP``
(top-``moe_top_k`` routing); its two auxiliary losses come back through
``forward(..., aux_loss={})`` (the JAX package's ``aux_loss`` collection),
and ``make_loss_fn`` weights them.  Under a mesh (``mesh=``, and the
parameters cut by ``parallel.tp.shard_model``) the layers issue the
collectives of their sharding: heads, the MLP's ``F`` and the vocab over
``tp`` (Megatron), experts over ``ep``, the MoE routing the global batch
as the JAX package does (``parallel/ep.py``); with ``attn_impl`` ``ring`` or
``ulysses`` the sequence is split over ``sp`` at the embedding, RoPE takes
the global positions, attention goes round the ``sp`` group
(``parallel/sp.py``) and the logits are gathered whole again (the loss
takes each rank's own block of them).
"""

from __future__ import annotations

import dataclasses
import functools
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
from tensorflowonspark_torch.parallel import mesh as meshlib
from tensorflowonspark_torch.parallel.ep import MoEMLP
from tensorflowonspark_torch.parallel.sp import sequence_parallel_attention
from tensorflowonspark_torch.parallel.tp import P, constrain, copy_to, gather_from, reduce_from

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
    """``nn.Embedding`` whose rows come out in ``compute_dtype``.  Under
    ``tp`` it holds a block of the vocab: ids outside it give zero rows and
    the blocks' rows are summed over ``tp``."""

    tp_group = None  # set by parallel.tp.shard_model

    def __init__(self, vocab: int, dim: int, compute_dtype):
        super().__init__(vocab, dim)
        self.compute_dtype = compute_dtype

    def forward(self, ids):
        if self.tp_group is None:
            return F.embedding(ids, self.weight).to(self.compute_dtype)
        import torch.distributed as dist

        rows = self.weight.shape[0]
        local = ids.long() - dist.get_rank(self.tp_group) * rows
        inside = (local >= 0) & (local < rows)
        x = F.embedding(torch.where(inside, local, 0), self.weight)
        x = torch.where(inside[..., None], x, 0.0)
        return reduce_from(x, self.tp_group).to(self.compute_dtype)


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
    """Under ``tp`` the projections hold this rank's heads (the q/k/v rows,
    the o_proj columns): the input's gradient is summed over ``tp`` and
    the output's partial sums too."""

    tp_group = None  # set by parallel.tp.shard_model

    def __init__(self, d_model: int, n_heads: int, d_head: int,
                 rope_theta: float = 10000.0, attn_impl: str = "auto",
                 compute_dtype=torch.bfloat16, mesh=None):
        super().__init__()
        if attn_impl in ("ring", "ulysses"):
            if mesh is None:
                raise ValueError("ring/ulysses attention needs mesh=")
            self.attend = functools.partial(sequence_parallel_attention, mesh,
                                            impl=attn_impl)
        elif attn_impl in _ATTN:
            self.attend = _ATTN[attn_impl]
        else:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.n_heads, self.d_head = n_heads, d_head
        self.rope_theta = rope_theta
        self.compute_dtype = compute_dtype
        # this rank's block of the sequence (its first token's global
        # position is sp_index · S_local)
        self.sp_index = (meshlib.axis_index(mesh, "sp")
                         if attn_impl in ("ring", "ulysses") else 0)
        width = n_heads * d_head
        self.q_proj = Dense(d_model, width, compute_dtype)
        self.k_proj = Dense(d_model, width, compute_dtype)
        self.v_proj = Dense(d_model, width, compute_dtype)
        self.o_proj = Dense(width, d_model, compute_dtype)

    def local_heads(self) -> int:
        return self.q_proj.weight.shape[0] // self.d_head

    def forward(self, x, kv=None):
        b, s, _ = x.shape
        x = copy_to(x, self.tp_group)
        shape = (b, s, self.local_heads(), self.d_head)
        q = self.q_proj(x).view(shape)
        k = self.k_proj(x).view(shape)
        v = self.v_proj(x).view(shape)
        if kv is not None:
            return self._decode_step(q, k, v, *kv)
        positions = self.sp_index * s + torch.arange(s, device=x.device)
        q = apply_rope(q, positions, self.rope_theta)
        k = apply_rope(k, positions, self.rope_theta)
        out = self.attend(q, k, v, causal=True)
        return reduce_from(self.o_proj(out.reshape(b, s, -1)), self.tp_group)

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
        return reduce_from(self.o_proj(out.to(self.compute_dtype).reshape(b, s, -1)),
                           self.tp_group)


class SwiGLU(nn.Module):
    """Under ``tp``: gate/up column-parallel, down row-parallel."""

    tp_group = None  # set by parallel.tp.shard_model

    def __init__(self, d_model: int, d_ff: int, compute_dtype=torch.bfloat16):
        super().__init__()
        self.gate_proj = Dense(d_model, d_ff, compute_dtype)
        self.up_proj = Dense(d_model, d_ff, compute_dtype)
        self.down_proj = Dense(d_ff, d_model, compute_dtype)

    def forward(self, x):
        x = copy_to(x, self.tp_group)
        return reduce_from(self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x)),
                           self.tp_group)


class Block(nn.Module):
    """Pre-norm attention and FFN; ``forward`` returns ``(x, aux)``, with
    ``aux`` the MoE's auxiliary losses (``None`` for a dense block)."""

    def __init__(self, d_model: int, n_heads: int, d_head: int, d_ff: int,
                 rope_theta: float = 10000.0, attn_impl: str = "auto",
                 compute_dtype=torch.bfloat16, n_experts: int = 0,
                 moe_top_k: int = 2, mesh=None):
        super().__init__()
        self.attn_norm = RMSNorm(d_model)
        self.attn = Attention(d_model, n_heads, d_head, rope_theta, attn_impl,
                              compute_dtype, mesh)
        self.mlp_norm = RMSNorm(d_model)
        if n_experts:
            # under a mesh the MoE routes the global batch (its token group)
            self.moe = MoEMLP(d_model, d_ff, n_experts, moe_top_k,
                              compute_dtype=compute_dtype, mesh=mesh,
                              seq_parallel=attn_impl in ("ring", "ulysses"))
        else:
            self.mlp = SwiGLU(d_model, d_ff, compute_dtype)

    def forward(self, x, kv=None):
        x = x + self.attn(self.attn_norm(x), kv)
        h = self.mlp_norm(x)
        if not hasattr(self, "moe"):
            return x + self.mlp(h), None
        y, aux = self.moe(h)
        return x + y, aux


class Stage(nn.Module):
    """Consecutive dense blocks as one pipeline stage (``parallel/pp.py``):
    ``forward(x) -> x``.  Its parameter names are the model's
    (``blocks.{j}.…``), so ``torch.func.functional_call`` runs it with any
    stage's slice of the stage-stacked tree."""

    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        for block in self.blocks:
            x, _ = block(x)
        return x


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
        # this rank's heads under tp
        shape = (batch, max_len, model.blocks[0].attn.local_heads(), model.d_head)
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
    draws flax's distributions from a ``torch.Generator``.

    ``aux_loss``: a dict that ``forward`` fills with the MoE blocks'
    auxiliary losses, ``{"load_balance": [one per block], "router_z":
    [...]}`` (block outputs, so a remat recompute adds nothing).  Under
    ``mesh`` with ``sp > 1`` (``attn_impl`` ``ring``/``ulysses``) a rank
    takes its rows' whole sequence and returns whole logits
    (``gather_seq=False``: its own block of the sequence, as the loss
    takes them); the vocab split over ``tp`` is gathered."""

    tp_group = None  # set by parallel.tp.shard_model (the lm_head's vocab split)

    def __init__(self, vocab_size: int, d_model: int, n_layers: int,
                 n_heads: int, d_head: int = 0, d_ff: int = 0,
                 n_experts: int = 0, moe_top_k: int = 2,
                 rope_theta: float = 10000.0, attn_impl: str = "auto",
                 mesh=None, compute_dtype=torch.bfloat16, remat: bool = False):
        super().__init__()
        self.n_heads = n_heads
        self.d_head = d_head or d_model // n_heads
        self.n_experts = n_experts
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.mesh = mesh
        self.seq_parallel = attn_impl in ("ring", "ulysses")
        if meshlib.axis_size(mesh, "sp") > 1 and not self.seq_parallel:
            raise ValueError("a mesh with sp > 1 needs attn_impl ring or ulysses")
        self.sp_group = meshlib.group(mesh, "sp") if self.seq_parallel else None
        dff = d_ff or 4 * d_model
        self.embed = Embed(vocab_size, d_model, compute_dtype)
        self.blocks = nn.ModuleList(
            Block(d_model, n_heads, self.d_head, dff, rope_theta, attn_impl,
                  compute_dtype, n_experts, moe_top_k, mesh)
            for _ in range(n_layers))
        self.final_norm = RMSNorm(d_model)
        self.lm_head = Dense(d_model, vocab_size, compute_dtype)

    def forward(self, input_ids, cache: KVCache | None = None, *,
                return_hidden: bool = False, aux_loss: dict | None = None,
                gather_seq: bool = True):
        terms = []
        if cache is not None:
            if self.sp_group is not None:
                raise ValueError("the decode path does not split the sequence "
                                 "(sp > 1)")
            x = self.embed(input_ids)
            s = input_ids.shape[1]
            if cache.index + s > cache.max_len:
                raise ValueError(f"cache holds {cache.max_len} positions; "
                                 f"{cache.index} used, {s} more asked")
            for i, block in enumerate(self.blocks):
                x, aux = block(x, (cache.k[i], cache.v[i], cache.index))
                terms.append(aux)
            cache.index += s
        else:
            x = self.embed(constrain(input_ids, P(None, "sp"), self.mesh)
                           if self.sp_group is not None else input_ids)
            remat = self.remat and torch.is_grad_enabled()
            for block in self.blocks:
                x, aux = (checkpoint(block, x, use_reentrant=False) if remat
                          else block(x))
                terms.append(aux)
        if aux_loss is not None:
            for aux in terms:
                for key, value in (aux or {}).items():
                    aux_loss.setdefault(key, []).append(value)
        x = self.final_norm(x)
        if return_hidden:
            out = gather_from(x, 1, self.sp_group)
        else:
            logits = self.lm_head(copy_to(x, self.tp_group)).float()
            out = gather_from(logits, -1, self.tp_group)
            if gather_seq:
                out = gather_from(out, 1, self.sp_group)
        return out if cache is None else (out, cache)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Transformer":
        """flax's initialisers, drawn from ``generator`` (on the weights'
        device): ``Dense``/``DenseGeneral`` kernels ``lecun_normal`` (std
        1/sqrt(fan_in), fan_in = H·Dh for ``o_proj``), ``Embed`` a normal of
        std 1/sqrt(d_model), norm scales 1; the MoE's as
        ``MoEMLP.init_weights``."""
        for module in self.modules():
            if isinstance(module, MoEMLP):
                module.init_weights(generator)
            elif isinstance(module, Dense):
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
        """Cast the matrices (not the norm scales, not the MoE's f32
        router) to the compute type in place: serving's cast-once-at-load."""
        for module in self.modules():
            if isinstance(module, (Dense, Embed)):
                module.to(self.compute_dtype)
            elif isinstance(module, MoEMLP):
                module.cast_experts_()
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
        moe_top_k=int(config.get("moe_top_k", 2)),
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
    ``blockwise_cross_entropy``: the ``[B, S, V]`` logits are never made
    (not under ``tp`` or ``sp``, whose logits are split).  Under ``sp``
    each rank takes the logits of its own block of the sequence, and the
    nll sums are added over ``sp`` (``_seq_sharded``).  ``metrics``
    holds ``lm_loss``, ``aux_loss`` and ``router_z_loss``: the MoE blocks'
    ``load_balance`` terms summed (weighted by ``aux_loss_coef``) and their
    ``router_z`` terms summed (by ``router_z_coef``), zero for a dense
    model."""
    if not isinstance(model, Transformer):
        raise TypeError(f"make_loss_fn takes a Transformer, got {type(model).__name__}")
    if vocab_chunk and (model.tp_group is not None or model.sp_group is not None):
        raise ValueError("vocab_chunk fuses an unsplit lm_head; under tp or sp "
                         "use the dense loss")

    def _reduce(nll, batch, collected):
        """``nll`` [B, S-1], or already the lm loss (a scalar)."""
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=nll.device)[:, 1:].float()
            loss = (nll * mask).sum() / mask.sum().clamp(min=1.0)
        else:
            loss = nll.mean()  # a scalar is its own mean
        zero = nll.new_zeros(())
        aux = sum(collected.get("load_balance", []), zero)
        z = sum(collected.get("router_z", []), zero)
        total = loss + aux_loss_coef * aux + router_z_coef * z
        return total, {"lm_loss": loss, "aux_loss": aux, "router_z_loss": z}

    def loss_fn(m: Transformer, batch):
        ids = torch.as_tensor(batch["input_ids"], device=m.embed.weight.device)
        targets = ids[:, 1:].long()
        collected: dict = {}
        if vocab_chunk:
            h = m(ids, return_hidden=True, aux_loss=collected)
            b, s, d = h.shape
            kernel = m.lm_head.weight.to(h.dtype).t()              # [D, V]
            nll = blockwise_cross_entropy(h[:, :-1].reshape(b * (s - 1), d),
                                          kernel, targets.reshape(-1),
                                          chunk=vocab_chunk)
            return _reduce(nll.view(b, s - 1), batch, collected)
        if m.sp_group is not None:
            return _seq_sharded(m, ids, batch, collected)
        logits = m(ids, aux_loss=collected)[:, :-1]
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              targets.reshape(-1), reduction="none")
        return _reduce(nll.view(targets.shape), batch, collected)

    def _seq_sharded(m, ids, batch, collected):
        """Under ``sp``: the logits of this rank's block of the sequence
        only, its positions' nll summed over ``sp`` (each rank's gradient
        is its own positions', which the train step sums over ``sp``)
        and divided by the global count."""
        import torch.distributed as dist

        logits = m(ids, aux_loss=collected, gather_seq=False)
        s_loc = logits.shape[1]
        start = dist.get_rank(m.sp_group) * s_loc
        targets = ids[:, start + 1:start + s_loc + 1].long()  # the last position has none
        n_t = targets.shape[1]
        nll = F.cross_entropy(logits[:, :n_t].reshape(-1, logits.shape[-1]),
                              targets.reshape(-1), reduction="none").view(targets.shape)
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=nll.device)[:, 1:].float()
            count = mask.sum().clamp(min=1.0)
            nll = nll * mask[:, start:start + n_t]
        else:
            count = ids.shape[0] * (ids.shape[1] - 1)
        loss = reduce_from(nll.sum(), m.sp_group) / count
        return _reduce(loss, {}, collected)

    return loss_fn


def pipeline_parts(model: Transformer, n_stages: int) -> tuple:
    """``model`` cut for ``parallel/pp.py`` as the JAX package's
    ``_train_pipelined`` cuts it: ``n_layers / n_stages`` dense blocks a
    stage, the embedding and the head outside the pipe.  Returns
    ``(stage_fn, stacked, head, embedding)``: ``stage_fn`` runs a ``Stage``
    of the model's first blocks through ``functional_call`` with any
    stage's parameters; ``stacked`` is ``{"blocks.{j}.…": [n_stages, …]}``,
    ``head`` ``{"final_norm.scale", "lm_head.weight"}`` and ``embedding``
    the table, all detached copies of the model's parameters."""
    from tensorflowonspark_torch.parallel.pp import module_stage_fn, stack_stages

    n_layers = len(model.blocks)
    if model.n_experts or n_layers % n_stages:
        raise ValueError(f"a pipeline cuts {n_layers} dense blocks into {n_stages} "
                         "equal stages")
    per = n_layers // n_stages
    stacked = stack_stages([
        {f"blocks.{j}.{name}": p.detach()
         for j in range(per) for name, p in model.blocks[i * per + j].named_parameters()}
        for i in range(n_stages)])
    head = {"final_norm.scale": model.final_norm.scale.detach().clone(),
            "lm_head.weight": model.lm_head.weight.detach().clone()}
    return (module_stage_fn(Stage(model.blocks[:per])), stacked, head,
            model.embed.weight.detach().clone())


def pipeline_head_loss(model: Transformer, vocab_chunk: int = 0):
    """The pipelined LM's ``loss_fn(head, h, ids)`` for ``pipeline_1f1b``:
    the final norm, the lm_head and the mean next-token cross-entropy of
    one microbatch (``blockwise_cross_entropy`` with ``vocab_chunk``), as
    ``make_loss_fn`` computes it on the whole model."""
    from torch.func import functional_call

    dtype = model.compute_dtype

    def loss_fn(head, h, ids):
        final = functional_call(model.final_norm, {"scale": head["final_norm.scale"]}, (h,))
        targets = ids[:, 1:].long().reshape(-1)
        kernel = head["lm_head.weight"].to(dtype)
        if vocab_chunk:
            d = final.shape[-1]
            return blockwise_cross_entropy(final[:, :-1].reshape(-1, d),
                                           kernel.to(final.dtype).t(), targets,
                                           chunk=vocab_chunk).mean()
        logits = F.linear(final.to(dtype), kernel).float()[:, :-1]
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets)

    return loss_fn
