"""The Hopper flash-attention kernel against its plain PyTorch version, on
the card.  No JAX here, so the file runs on the machine with the card:

    python -m pytest tests/test_torch_cuda.py

Without a CUDA device every test skips (the kernel has no CPU mode).
"""

import pytest
import torch

from tensorflowonspark_torch.ops import attention as ta

# (b, sq, sk, h, d, causal, kv_offset, dtype)
GPU_CASES = {
    "serving_shape": (4, 2048, 2048, 8, 128, True, 0, torch.bfloat16),
    "ragged_20_52": (2, 20, 52, 3, 128, False, 0, torch.bfloat16),
    "ragged_20_52_causal": (2, 20, 52, 3, 64, True, 0, torch.float16),
    "kv_offset_masked_rows": (1, 100, 70, 2, 64, True, 37, torch.bfloat16),
    "head_dim_64": (2, 300, 300, 4, 64, True, 0, torch.bfloat16),
}


@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_cuda_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, sq, sk, h, d, causal, off, dtype = GPU_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda").to(dtype)
               for s in (sq, sk, sk))
    o, lse = ta.flash_attention_fwd(q, k, v, causal=causal, kv_offset=off,
                                    impl="kernel")
    po, pl = ta.chunk_attention(q, k, v, causal=causal, kv_offset=off)
    torch.cuda.synchronize()
    # P is rounded to the input type for the P·V product on the tensor cores
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    # the plain version rounds its logits to the input type before the softmax
    torch.testing.assert_close(lse, pl, atol=1e-2, rtol=1e-2)
