"""Custom ops: hand-written Hopper kernels for the hot paths, beside their
plain PyTorch versions."""

from tensorflowonspark_torch.ops.attention import (  # noqa: F401
    FlashAttention,
    blockwise_attention,
    chunk_attention,
    flash_attention,
    flash_attention_fwd,
    merge_attention,
    mha_reference,
)
from tensorflowonspark_torch.ops.xent import blockwise_cross_entropy  # noqa: F401
