"""Blockwise (vocab-chunked) softmax cross-entropy for large-vocab LM heads —
counterpart of ``tensorflowonspark_tpu/ops/xent.py``.

The dense loss materialises ``[N, V]`` f32 logits for the forward and again
for their gradient.  This op never holds more than ``[N, chunk]``: the head
product, an online log-sum-exp and the softmax-minus-one-hot backward run
over vocabulary chunks, and the backward recomputes each chunk's logits from
the saved ``(hidden, kernel, targets, lse)`` instead of saving them.

The chunk products are plain ``torch.matmul`` in f32 (the operands are
widened, so a bf16 product is exact before its f32 accumulation, as
``preferred_element_type=float32`` gives it in the JAX package).  The last
chunk is simply narrower when ``chunk`` does not divide V: no column is
padded, so none needs masking.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _chunks(vocab: int, chunk: int):
    return [(c, min(c + chunk, vocab)) for c in range(0, vocab, chunk)]


def blockwise_cross_entropy(hidden: torch.Tensor, kernel: torch.Tensor,
                            targets: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Per-token ``-log softmax(hidden @ kernel)[target]`` without the
    ``[N, V]`` logits.

    ``hidden``: ``[N, D]`` (any float type); ``kernel``: ``[D, V]`` (the
    JAX layout; the port's ``lm_head.weight.t()`` is a view of it);
    ``targets``: ``[N]`` ids in ``[0, V)``.  Returns ``[N]`` f32
    negative log-likelihoods."""
    chunk = min(int(chunk), kernel.shape[1])
    return BlockwiseCrossEntropy.apply(hidden, kernel, targets, chunk)


class BlockwiseCrossEntropy(torch.autograd.Function):
    """The ``custom_vjp`` ``_blockwise_xent`` of the JAX package
    (``xent.py:70-142``)."""

    @staticmethod
    def forward(ctx, hidden, kernel, targets, chunk):
        h = hidden.float()
        n = h.shape[0]
        m = torch.full((n,), NEG_INF, dtype=torch.float32, device=h.device)
        s = torch.zeros((n,), dtype=torch.float32, device=h.device)
        tgt = torch.full((n,), NEG_INF, dtype=torch.float32, device=h.device)
        for c0, c1 in _chunks(kernel.shape[1], chunk):
            logits = h @ kernel[:, c0:c1].float()                  # [N, c]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            local = targets - c0
            inside = (local >= 0) & (local < c1 - c0)
            picked = logits.gather(
                1, local.clamp(0, c1 - c0 - 1)[:, None].long())[:, 0]
            tgt = torch.where(inside, picked, tgt)
            m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(hidden, kernel, targets, lse)
        ctx.chunk = chunk
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        hidden, kernel, targets, lse = ctx.saved_tensors
        h = hidden.float()
        g = g.float()[:, None]
        dh = torch.zeros_like(h)
        dw = torch.empty(kernel.shape, dtype=torch.float32, device=h.device)
        for c0, c1 in _chunks(kernel.shape[1], ctx.chunk):
            w = kernel[:, c0:c1].float()
            # d nll / d logits = softmax - onehot(target), times the
            # incoming per-token cotangent
            dlogits = torch.exp(h @ w - lse[:, None])
            local = (targets - c0).long()
            inside = ((local >= 0) & (local < c1 - c0)).float()
            dlogits.scatter_add_(1, local.clamp(0, c1 - c0 - 1)[:, None],
                                 -inside[:, None])
            dlogits *= g
            dh += dlogits @ w.t()
            dw[:, c0:c1] = h.t() @ dlogits
        return dh.to(hidden.dtype), dw.to(kernel.dtype), None, None
