"""The yardstick's arithmetic: the card's peaks, the work of a training step
and of the attention kernels, counted from shapes alone.

Frozen here so that every version of the program is held to the same
numbers: the peaks and the attention bounds as ``chip_smoke.py`` counts
them (``PEAK_*``, ``live_pairs``, ``attention_bound``, ``bwd_timing``'s five
products), the LM step's model FLOPs as its ``model_flops`` counts them,
and ResNet-50's forward FLOPs as its ``conv_dense_flops`` counts them, here
by a walk over the published shapes instead of hooks on the program's
layers.  Nothing in this module imports the program.
"""

from __future__ import annotations

import math

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16/fp16 tensor-core rate
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth


def live_pairs(sq: int, sk: int, causal: bool, kv_offset: int = 0) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, i - kv_offset + 1)) for i in range(sq))


def attention_fwd_bound_s(b: int, sq: int, sk: int, h: int, d: int, causal: bool,
                          itemsize: int, peak: float = PEAK_BF16_FLOPS,
                          kv_offset: int = 0) -> tuple[float, str]:
    """``(seconds, bound_by)`` of one attention forward: the larger of its
    two products (Q·Kᵀ and P·V) over the live pairs at ``peak`` and the
    time to move q, k, v, O (``itemsize`` bytes each) and the f32 lse."""
    flops = 2 * d * 2 * b * h * live_pairs(sq, sk, causal, kv_offset)
    nbytes = (2 * b * sq * h * d + 2 * b * sk * h * d) * itemsize + b * sq * h * 4
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_bwd_bound_s(b: int, s: int, h: int, d: int, causal: bool,
                          itemsize: int, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """``(seconds, bound_by)`` of one attention backward: five products
    (S = Q·Kᵀ again, dP = dO·Vᵀ, dV = Pᵀ·dO, dQ = dS·K, dK = dSᵀ·Q; 2.5 times
    the forward's operations) over the live pairs at ``peak``, or reading
    q, k, v, dO and lse and writing dq, dk, dv."""
    flops = 10 * d * b * h * live_pairs(s, s, causal, 0)
    nbytes = 7 * b * s * h * d * itemsize + b * s * h * 4
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def lm_params(vocab: int, d_model: int, n_layers: int, n_heads: int, d_head: int,
              d_ff: int) -> dict:
    """Parameter counts of the decoder-only LM (pre-norm RMSNorm, MHA with as
    many KV heads as heads, SwiGLU, no biases, untied head)."""
    width = n_heads * d_head
    block = 4 * d_model * width + 3 * d_model * d_ff + 2 * d_model
    return {"embedding": vocab * d_model, "block": block, "blocks": n_layers * block,
            "final_norm": d_model, "lm_head": vocab * d_model}


def lm_attention_flops(batch: int, seq: int, n_heads: int, d_head: int,
                       n_layers: int) -> float:
    """Attention's model FLOPs of a train step: 3 × (forward's 4·Dh per live
    pair per head), the backward counted as twice the forward."""
    return 3.0 * 4 * batch * n_heads * d_head * live_pairs(seq, seq, True, 0) * n_layers


def lm_step_flops(vocab: int, d_model: int, n_layers: int, n_heads: int, d_head: int,
                  d_ff: int, batch: int, seq: int) -> tuple[float, str]:
    """Model FLOPs of one LM train step and the formula: 6 × (non-embedding
    parameters + lm_head) × tokens + 12 × B × H × Dh × causal pairs ×
    layers."""
    p = lm_params(vocab, d_model, n_layers, n_heads, d_head, d_ff)
    params = p["blocks"] + p["final_norm"] + p["lm_head"]
    pairs = live_pairs(seq, seq, True, 0)
    attn = lm_attention_flops(batch, seq, n_heads, d_head, n_layers)
    formula = (f"6 x {params} (non-embedding params + lm_head) x {batch * seq} tokens "
               f"+ 12 x B {batch} x H {n_heads} x Dh {d_head} x {pairs} causal pairs x "
               f"{n_layers} layers")
    return 6.0 * params * batch * seq + attn, formula


def same_out(size: int, stride: int) -> int:
    """Output side of a ``SAME``-padded window of stride ``stride``."""
    return math.ceil(size / stride)


def resnet_forward_flops(image_size: int = 224, num_classes: int = 1000,
                         width: int = 64, stage_sizes=(3, 4, 6, 3)) -> tuple[float, int]:
    """Forward FLOPs of one image through a bottleneck (v1.5) ResNet with the
    ImageNet stem, 2 per multiply-add of every convolution and the dense
    head (batch norm, pooling and activations not counted), and the number
    of layers counted."""
    flops, layers = 0, 0

    def conv(out_hw: int, c_in: int, c_out: int, k: int) -> None:
        nonlocal flops, layers
        flops += 2 * out_hw * out_hw * c_out * c_in * k * k
        layers += 1

    hw = same_out(image_size, 2)
    conv(hw, 3, width, 7)
    hw = same_out(hw, 2)                       # 3x3/2 max pool
    c = width
    for stage, size in enumerate(stage_sizes):
        for block in range(size):
            stride = 2 if stage > 0 and block == 0 else 1
            filters = width * 2 ** stage
            out_hw = same_out(hw, stride)
            conv(hw, c, filters, 1)
            conv(out_hw, filters, filters, 3)
            conv(out_hw, filters, filters * 4, 1)
            if stride != 1 or c != filters * 4:
                conv(out_hw, c, filters * 4, 1)
            c, hw = filters * 4, out_hw
    flops += 2 * c * num_classes
    return float(flops), layers + 1
