"""The attention kernels (the Hopper ``wgmma`` kernel for bf16/fp16 on its
tiles of 32 to 256 columns and above 256 on its wide route, the 3xTF32
``wgmma`` kernel for f32 on its tiles of 32 to 128 columns and above 128 on
its wide route; every route at the real head dim, split-KV on small grids)
against their plain PyTorch version, on the card, and the backward kernels
(``csrc/flash_attn_bwd.cu``, bf16/fp16 up to D=128, and
``csrc/flash_attn_bwd_tf32.cu``, f32 as 3xTF32 up to D=128, behind
``tos::flash_attn_bwd``) against theirs (``flash_attn_bwd_reference``).
No JAX here, so the file runs on the machine with the card:

    python -m pytest tests/test_torch_cuda.py

Without a CUDA device every test skips (the kernel has no CPU mode).
"""

import pytest
import torch

from tensorflowonspark_torch.ops import attention as ta
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

# (b, sq, sk, h, d, causal, kv_offset, dtype, packed): `packed` makes q, k, v
# strided views of one [B, S, 3, H, D] tensor (needs sq == sk).
GPU_CASES = {
    "serving_shape": (4, 2048, 2048, 8, 128, True, 0, torch.bfloat16, False),
    "ragged_20_52": (2, 20, 52, 3, 128, False, 0, torch.bfloat16, False),
    "ragged_20_52_causal": (2, 20, 52, 3, 64, True, 0, torch.float16, False),
    "kv_offset_masked_rows": (1, 100, 70, 2, 64, True, 37, torch.bfloat16, False),
    "head_dim_64": (2, 300, 300, 4, 64, True, 0, torch.bfloat16, False),
    "ragged_200_330": (2, 200, 330, 3, 128, False, 0, torch.bfloat16, False),
    "ragged_200_330_causal": (2, 200, 330, 3, 128, True, 0, torch.bfloat16, False),
    "sq_1": (2, 1, 300, 4, 128, False, 0, torch.bfloat16, False),
    "sq_1_causal_decode": (2, 1, 517, 4, 64, True, -516, torch.float16, False),
    "kv_offset_129": (1, 256, 384, 2, 128, True, 129, torch.bfloat16, False),
    "noncausal_64_1000": (2, 64, 1000, 2, 128, False, 0, torch.bfloat16, False),
    "head_dim_64_fp16": (4, 2048, 2048, 16, 64, True, 0, torch.float16, False),
    "packed_qkv_view": (2, 300, 300, 4, 128, True, 0, torch.bfloat16, True),
    "packed_qkv_view_d64": (2, 200, 200, 3, 64, False, 0, torch.float16, True),
    # rows 0..63 (the first consumer's half of the tile) see no key at all
    "consumer_half_masked": (1, 128, 128, 4, 128, True, 64, torch.bfloat16, False),
}


def make_inputs(b, sq, sk, h, d, dtype, packed, gen):
    if packed:
        qkv = torch.randn((b, sq, 3, h, d), generator=gen, device="cuda").to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return tuple(torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
                 for s in (sq, sk, sk))


@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_cuda_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, sq, sk, h, d, causal, off, dtype, packed = GPU_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = make_inputs(b, sq, sk, h, d, dtype, packed, g)
    if packed:  # read in place through the views' strides, not copied
        assert ta._kernel_operand(q) is q
    o, lse = ta.flash_attention_fwd(q, k, v, causal=causal, kv_offset=off,
                                    impl="kernel")
    po, pl = ta.chunk_attention(q, k, v, causal=causal, kv_offset=off)
    torch.cuda.synchronize()
    # P is rounded to the input type for the P·V product on the tensor cores
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    # the plain version rounds its logits to the input type before the softmax
    torch.testing.assert_close(lse, pl, atol=1e-2, rtol=1e-2)
    assert torch.isfinite(o).all()
    masked = pl <= ta.NEG_INF / 2  # fully masked rows: exactly 0 and NEG_INF
    assert (lse[masked] == ta.NEG_INF).all() and (o[masked] == 0).all()
    if case == "consumer_half_masked":
        assert masked[:, :64].all() and not masked[:, 64:].any()


# (b, sq, sk, h, d, causal, kv_offset, dtype, packed) for the routes other
# than bf16/fp16 at 64 and 128: bf16/fp16 on the wgmma kernel's other tiles
# (32, 96, 192, 256) and between them, bf16/fp16 above 256 (its wide
# route), f32 up to 128 (the 3xTF32 kernel's tiles) and f32 above 128 (its
# wide route), all at the real head dim (TMA zero-fills a tile's columns
# past it); a head dim whose rows are not whole 16 bytes is padded to them
GENERIC_CASES = {
    "f32_serving_shape": (4, 2048, 2048, 8, 128, True, 0, torch.float32, False),
    "f32_d64_ragged_kv_offset": (2, 100, 170, 3, 64, True, 37, torch.float32, False),
    "f32_d33_noncausal": (2, 70, 45, 2, 33, False, 0, torch.float32, False),
    "f32_d256_decode": (2, 1, 517, 4, 256, True, -516, torch.float32, False),
    "f32_packed_d80": (2, 130, 130, 3, 80, True, 0, torch.float32, True),
    "f32_ragged_200_330": (2, 200, 330, 3, 128, False, 0, torch.float32, False),
    "f32_kv_offset_masked_rows": (1, 100, 70, 2, 128, True, 37, torch.float32, False),
    "f32_kv_offset_negative": (1, 64, 192, 2, 128, True, -64, torch.float32, False),
    "f32_sq_1_decode": (2, 1, 517, 4, 128, True, -516, torch.float32, False),
    "f32_packed_qkv_view": (2, 300, 300, 4, 128, True, 0, torch.float32, True),
    # the first 64-row tile (the TF32 kernel's whole CTA) sees no key
    "f32_first_tile_masked": (1, 128, 128, 4, 128, True, 64, torch.float32, False),
    "f32_d160_generic": (1, 130, 200, 2, 160, True, 3, torch.float32, False),
    # the shape of chip_smoke.py's head-dim-256 f32 train step
    "f32_d256_train_step_shape": (2, 2048, 2048, 4, 256, True, 0, torch.float32, False),
    "bf16_d256": (2, 300, 300, 4, 256, True, 0, torch.bfloat16, False),
    "fp16_d200_ragged": (2, 77, 140, 2, 200, False, 0, torch.float16, False),
    "bf16_d256_ragged_noncausal": (2, 200, 330, 3, 256, False, 0, torch.bfloat16, False),
    "bf16_d256_kv_offset_masked_rows": (1, 100, 70, 2, 256, True, 37, torch.bfloat16, False),
    "bf16_d256_kv_offset_negative": (1, 64, 192, 2, 256, True, -64, torch.bfloat16, False),
    "fp16_d256_sq_1_decode": (2, 1, 517, 4, 256, True, -516, torch.float16, False),
    "bf16_d256_packed_qkv_view": (2, 300, 300, 2, 256, True, 0, torch.bfloat16, True),
    "bf16_d256_consumer_half_masked": (1, 128, 128, 4, 256, True, 64, torch.bfloat16, False),
    "bf16_d160_padded": (2, 150, 150, 2, 160, True, 0, torch.bfloat16, False),
    "fp16_d192_padded": (1, 90, 130, 2, 192, True, 5, torch.float16, False),
    "bf16_d32_padded": (2, 300, 300, 4, 32, True, 0, torch.bfloat16, False),
    "bf16_d96_padded": (2, 200, 330, 3, 96, True, 0, torch.bfloat16, False),
    "fp16_d80_padded_masked_rows": (1, 100, 70, 2, 80, True, 37, torch.float16, False),
    # the tiles at the real head dim: 8, 32, 40, 80, 96, 160, 192 and 224 in
    # bf16/fp16 and f32 up to 128; ragged keys, offsets (a negative one),
    # one-row decodes, packed views read in place, a masked consumer half
    "bf16_d8_ragged": (2, 70, 45, 3, 8, False, 0, torch.bfloat16, False),
    "fp16_d8_decode": (2, 1, 517, 2, 8, True, -516, torch.float16, False),
    "f32_d8_ragged_kv_offset": (2, 70, 45, 3, 8, True, 5, torch.float32, False),
    "bf16_d32_kv_offset_masked_rows": (1, 100, 70, 2, 32, True, 37, torch.bfloat16, False),
    "fp16_d32_packed_qkv_view": (2, 300, 300, 3, 32, True, 0, torch.float16, True),
    "f32_d32_ragged_noncausal": (2, 200, 330, 3, 32, False, 0, torch.float32, False),
    "f32_d32_decode": (2, 1, 517, 4, 32, True, -516, torch.float32, False),
    "bf16_d32_consumer_half_masked": (1, 128, 128, 4, 32, True, 64, torch.bfloat16, False),
    "bf16_d40_ragged_causal": (2, 200, 330, 2, 40, True, 0, torch.bfloat16, False),
    "f32_d40_packed_qkv_view": (2, 130, 130, 3, 40, True, 0, torch.float32, True),
    "fp16_d40_kv_offset_negative": (1, 64, 192, 2, 40, True, -64, torch.float16, False),
    "bf16_d80_decode": (2, 1, 517, 4, 80, True, -516, torch.bfloat16, False),
    "f32_d80_kv_offset": (1, 100, 170, 2, 80, True, 37, torch.float32, False),
    "fp16_d96_ragged_noncausal": (2, 200, 330, 3, 96, False, 0, torch.float16, False),
    "bf16_d96_packed_qkv_view": (2, 300, 300, 3, 96, True, 0, torch.bfloat16, True),
    "f32_d96_kv_offset_negative": (1, 64, 192, 2, 96, True, -64, torch.float32, False),
    "f32_d96_first_tile_masked": (1, 128, 128, 4, 96, True, 64, torch.float32, False),
    "bf16_d160_decode": (2, 1, 517, 2, 160, True, -516, torch.bfloat16, False),
    "fp16_d160_kv_offset": (1, 100, 170, 2, 160, True, 37, torch.float16, False),
    "bf16_d192_ragged_noncausal": (2, 200, 330, 2, 192, False, 0, torch.bfloat16, False),
    "fp16_d192_packed_qkv_view": (2, 300, 300, 2, 192, True, 0, torch.float16, True),
    "bf16_d192_consumer_half_masked": (1, 128, 128, 2, 192, True, 64, torch.bfloat16, False),
    "bf16_d224_kv_offset_negative": (1, 64, 192, 2, 224, True, -64, torch.bfloat16, False),
    "fp16_d224_decode": (2, 1, 517, 2, 224, True, -516, torch.float16, False),
    # the wide routes at the real head dim: f32 and bf16/fp16 at 320, 384,
    # 448 and 512
    "f32_d320": (2, 200, 330, 2, 320, True, 5, torch.float32, False),
    "f32_d384_ragged_noncausal": (1, 100, 150, 2, 384, False, 0, torch.float32, False),
    "f32_d448_padded_kv_offset_negative": (1, 64, 192, 2, 448, True, -64,
                                           torch.float32, False),
    "f32_d320_decode": (2, 1, 517, 2, 320, True, -516, torch.float32, False),
    "f32_d512_noncausal": (1, 150, 230, 2, 512, False, 0, torch.float32, False),
    "f32_d512_decode": (2, 1, 300, 2, 512, True, -299, torch.float32, False),
    "f32_d256_first_tile_masked": (1, 128, 128, 2, 256, True, 64, torch.float32, False),
    "bf16_d320_ragged_noncausal": (2, 200, 330, 2, 320, False, 0, torch.bfloat16, False),
    "fp16_d320_kv_offset_negative": (1, 64, 192, 2, 320, True, -64, torch.float16, False),
    "bf16_d384_causal": (2, 300, 300, 2, 384, True, 0, torch.bfloat16, False),
    "fp16_d448_padded": (1, 90, 130, 2, 448, True, 5, torch.float16, False),
    "bf16_d512_kv_offset_masked_rows": (1, 100, 70, 2, 512, True, 37, torch.bfloat16, False),
    "fp16_d512_sq_1_decode": (2, 1, 517, 2, 512, True, -516, torch.float16, False),
    "bf16_d512_packed_qkv_view": (2, 300, 300, 2, 512, True, 0, torch.bfloat16, True),
    "bf16_d512_consumer_half_masked": (1, 128, 128, 2, 512, True, 64, torch.bfloat16, False),
    # head dims that are not multiples of 64 (the last box part zeros), a
    # packed view read in place at D=320, one-row decodes whose later key
    # ranges see only masked keys (split-KV), and heads above 512 (column
    # groups; bf16 in two contraction passes)
    "bf16_d264": (2, 150, 190, 2, 264, True, 3, torch.bfloat16, False),
    "f32_d132": (2, 100, 170, 2, 132, True, 5, torch.float32, False),
    "bf16_d320_packed_qkv_view_split": (2, 200, 200, 2, 320, True, 0, torch.bfloat16, True),
    "bf16_d512_sq_1_masked_split": (2, 1, 517, 2, 512, True, -300, torch.bfloat16, False),
    "f32_d320_sq_1_masked_split": (2, 1, 517, 2, 320, True, -300, torch.float32, False),
    "fp16_d1000_ragged": (1, 70, 90, 1, 1000, False, 0, torch.float16, False),
    "f32_d600_causal": (1, 70, 90, 1, 600, True, 0, torch.float32, False),
    # causal grids of one wave (128 CTAs): the longer tiles' keys in two
    # ranges, merged by the combine, the shorter tiles written directly
    "bf16_d320_causal_one_wave": (2, 2048, 2048, 2, 320, True, 0, torch.bfloat16, False),
    "f32_d512_causal_one_wave": (2, 1024, 1024, 4, 512, True, 0, torch.float32, False),
}


def run_routed(q, k, v, causal, off):
    """The kernel path and the plain version on the same inputs (the plain
    version in full f32, no TF32), checking that exactly the kernel
    ``_route`` names launched, once."""
    route, _ = ta._route(q.dtype, q.shape[-1])
    before = dict(ta.LAUNCHES)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        o, lse = ta.flash_attention_fwd(q, k, v, causal=causal, kv_offset=off,
                                        impl="kernel")
        po, pl = ta.chunk_attention(q, k, v, causal=causal, kv_offset=off)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for n, count in ta.LAUNCHES.items():
        assert count - before[n] == int(n == route), (n, route)
    return o, lse, po, pl


@pytest.mark.parametrize("case", sorted(GENERIC_CASES))
def test_cuda_generic_and_padded_paths_match_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, sq, sk, h, d, causal, off, dtype, packed = GENERIC_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = make_inputs(b, sq, sk, h, d, dtype, packed, g)
    if packed and ta._route(dtype, d)[1] == d:  # read in place, not copied
        assert ta._kernel_operand(q) is q
    # f32 at every head dim on the 3xTF32 kernel, bf16/fp16 on the wgmma one
    assert ta._route(dtype, d)[0] == ("flash_attn_fwd_tf32" if dtype == torch.float32
                                      else "flash_attn_fwd")
    o, lse, po, pl = run_routed(q, k, v, causal, off)
    assert o.shape == q.shape and o.dtype == dtype
    if dtype == torch.float32:
        # 3xTF32 products are good to about 2^-20 relative, against f32
        # einsums summed in other orders
        torch.testing.assert_close(o, po, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(lse, pl, atol=1e-4, rtol=1e-4)
    else:  # the plain version's logits and the output round to the input type
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(lse, pl, atol=1e-2, rtol=1e-2)
    masked = pl <= ta.NEG_INF / 2
    assert (lse[masked] == ta.NEG_INF).all() and (o[masked] == 0).all()
    assert torch.isfinite(o).all()
    if case.endswith(("consumer_half_masked", "first_tile_masked")):
        assert masked[:, :64].all() and not masked[:, 64:].any()


def test_cuda_tf32_kernel_on_low_bit_heavy_inputs():
    """f32 inputs whose low 13 mantissa bits are all set: the 3xTF32 kernel
    reads K's hi part as the raw f32 and relies on the tensor cores reading
    only its upper 19 bits; if they rounded instead, the split would be off
    by up to 2^-11 relative and the 1e-4 gate would fail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = ((torch.randn((2, 300, 3, 128), generator=g, device="cuda")
                .view(torch.int32) | 0x1FFF).view(torch.float32) for _ in range(3))
    o, lse, po, pl = run_routed(q, k, v, True, 0)
    torch.testing.assert_close(o, po, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, pl, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bad", ["float64", "k_on_the_cpu", "mixed_types"])
def test_cuda_kernel_raises_on_what_it_does_not_take(bad):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dtype = torch.float64 if bad == "float64" else torch.bfloat16
    q = torch.zeros((1, 8, 2, 64), device="cuda", dtype=dtype)
    k = q.half() if bad == "mixed_types" else q.cpu() if bad == "k_on_the_cpu" else q
    with pytest.raises(ValueError, match="CUDA" if bad == "k_on_the_cpu" else None):
        ta.flash_attention_fwd(q, k, q, impl="kernel")


# (b, s, sk, h, d, causal, kv_offset): the training shape first
GRAD_CASES = {
    "training_shape": (8, 2048, 2048, 8, 128, True, 0),
    "ragged_300_d64": (2, 300, 300, 4, 64, True, 0),
    "kv_offset_noncausal_cross": (1, 100, 700, 2, 128, False, 0),
    "kv_offset_masked_rows": (1, 200, 150, 2, 128, True, 37),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_cuda_attention_grads_kernel_forward_vs_plain_forward(case):
    """FlashAttention (kernel forward, backward kernels) on bf16 inputs
    against autograd through the plain blockwise forward on the same
    inputs in f32 (TF32 off: the exact gradient of those inputs), on the
    card.  The plain side runs in f32 because the two sides no longer
    share a backward: each rounds dS to bf16 at its own place (the
    kernels as a product operand, a bf16 plain forward in its logits'
    einsum backward), and two such roundings of a large term on a short
    causal row differ by about 1e-2 in rare elements."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, s, sk, h, d, causal, off = GRAD_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = make_inputs(b, s, sk, h, d, torch.bfloat16, False, g)
    cot = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
    grads, outs = [], []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for attend in (ta.flash_attention, ta.blockwise_attention):
            kernel = attend is ta.flash_attention
            leaves = [(x if kernel else x.float()).detach().clone().requires_grad_()
                      for x in (q, k, v)]
            before = dict(ta.LAUNCHES)
            out = attend(*leaves, causal=causal, kv_offset=off)
            assert ta.LAUNCHES["flash_attn_fwd"] - before["flash_attn_fwd"] == int(kernel)
            out.backward(cot if kernel else cot.float())
            # the backward kernel once, and no forward launch in the backward
            assert {n: c - before[n] for n, c in ta.LAUNCHES.items()} == {
                "flash_attn_fwd": int(kernel), "flash_attn_fwd_tf32": 0,
                "flash_attn_bwd": int(kernel), "flash_attn_bwd_tf32": 0}
            outs.append(out.float())
            grads.append([x.grad.float() for x in leaves])
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(outs[0], outs[1], atol=2e-2, rtol=2e-2)
    # the backward kernels (P and dS rounded to bf16 as product operands,
    # the gradients stored in bf16) against the f32 gradients
    for got, want in zip(*grads):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("remat", [False, True])
def test_cuda_train_step_launches_per_layer(remat):
    """One train step launches the kernel once per layer; with remat the
    backward re-runs each block's forward, so twice per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from tensorflowonspark_torch.models import transformer as tfm
    from tensorflowonspark_torch.parallel import dp

    with torch.device("cuda"):
        model = tfm.Transformer(vocab_size=512, d_model=256, n_layers=3, n_heads=2,
                                remat=remat)
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    opt = dp.adamw(model.parameters(), 1e-3)
    step = dp.make_train_step(tfm.make_loss_fn(model), opt)
    ids = torch.randint(0, 512, (2, 256), device="cuda")
    before = dict(ta.LAUNCHES)
    _, metrics = step(dp.TrainState.create(model, opt), {"input_ids": ids})
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"])
    # the backward kernel once per layer, remat or not
    assert {n: c - before[n] for n, c in ta.LAUNCHES.items()} == {
        "flash_attn_fwd": 3 * (2 if remat else 1), "flash_attn_fwd_tf32": 0,
        "flash_attn_bwd": 3, "flash_attn_bwd_tf32": 0}


def _bn_step(device, weights, batch, config):
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.parallel import dp

    with torch.device(device):
        model = resnet.build_resnet_cifar(config)
    model.load_state_dict(weights)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, nesterov=True)
    grads = {}
    update = opt.step

    def capture_then_update():  # the foreach SGD changes .grad in place
        grads.update({n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()})
        return update()

    opt.step = capture_then_update
    step = dp.make_bn_train_step(resnet.make_loss_fn(model), opt)
    _, metrics = step(dp.BNTrainState.create(model, opt), batch)
    return (metrics["loss"].item(), grads,
            {k: v.cpu() for k, v in model.state_dict().items()})


@pytest.mark.parametrize("tf32", [False, True])
def test_cuda_bn_train_step_matches_cpu(tf32):
    """One BN train step of an f32 ``resnet_cifar`` from the same weights on
    the card and on the CPU (``chip_smoke.py``'s ``BN_*_TOL`` state the
    reasons).  With cuDNN's TF32 off every gradient is held per parameter
    (1e-3 relative L2), the loss to 1e-5; with TF32 on (PyTorch's default)
    the loss to 2e-3 and the gradients as one vector to 2e-2, since a
    gradient that mostly cancels (a bias feeding a train-mode BN) keeps
    TF32's 2^-11 of its terms.  The gradients are copied before the update:
    the foreach SGD on the card adds the Nesterov term to them in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from tensorflowonspark_torch.models import resnet

    config = {"model": "resnet_cifar", "depth_blocks": 1, "width": 16, "bf16": False}
    rng = np.random.RandomState(0)
    batch = {"image": rng.rand(32, 32, 32, 3).astype(np.float32),
             "label": (np.arange(32) % 10).astype(np.int32)}
    weights = resnet.build_resnet_cifar(config).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    cpu = _bn_step("cpu", weights, batch, config)
    previous = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        card = _bn_step("cuda", weights, batch, config)
    finally:
        torch.backends.cudnn.allow_tf32 = previous

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    assert abs(card[0] - cpu[0]) <= (2e-3 if tf32 else 1e-5) * abs(cpu[0])
    if tf32:
        names = list(cpu[1])
        assert rel(torch.cat([card[1][n].flatten() for n in names]),
                   torch.cat([cpu[1][n].flatten() for n in names])) <= 2e-2
    else:
        for name, g in cpu[1].items():
            assert rel(card[1][name], g) <= 1e-3, name


@pytest.mark.parametrize("model_name,size", [("resnet50", 64), ("inception_v3", 75),
                                             ("mnist_cnn", 28)])
def test_cuda_bf16_image_forward_close_to_cpu_f32(model_name, size):
    """The serving forward of each image family in bf16 on the card against
    the f32 model on the CPU, the same random-init bundle: within 5% of the
    largest logit (the bf16 bound of the CPU parity tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.models.registry import build, build_apply

    channels = 1 if model_name == "mnist_cnn" else 3
    config = {"model": model_name, "num_classes": 10, "bf16": True}
    model = build({**config, "bf16": False}).init_weights(torch.Generator().manual_seed(0))
    variables = torch_to_flax(model.state_dict(), config=config)
    x = np.random.RandomState(0).rand(4, size, size, channels).astype(np.float32)
    got = build_apply(config)(variables, x).float().cpu()
    want = build_apply({**config, "bf16": False}, device="cpu")(variables, x)
    assert got.shape == want.shape == (4, 10)
    assert (got - want).abs().max() <= 0.05 * want.abs().max()


def test_cuda_wide_deep_step_matches_cpu():
    """One optax-Adagrad step of a small f32 wide-and-deep (vocab 1009,
    embed 4, hidden (8, 4)) from the same weights on the card and on the
    CPU: the loss to 1e-5, every gradient and updated parameter to 1e-5
    relative L2.  PyTorch leaves TF32 off for matmuls by default
    (``torch.backends.cuda.matmul.allow_tf32``), and this test asserts it:
    the MLP runs in full f32 on both sides; the card's embedding backward
    sums duplicate ids in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from tensorflowonspark_torch.models import wide_deep
    from tensorflowonspark_torch.optim import Adagrad
    from tensorflowonspark_torch.parallel import dp as tdp

    assert not torch.backends.cuda.matmul.allow_tf32
    config = {"model": "wide_deep", "vocab_size": 1009, "embed_dim": 4,
              "hidden": [8, 4], "bf16": False}
    weights = wide_deep.build_wide_deep(config).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    batch = wide_deep.batch_to_arrays(wide_deep.synthetic_criteo(64, seed=1))

    def one_step(device):
        model = wide_deep.build_wide_deep(config)
        model.load_state_dict(weights)
        model.to(device)
        opt = Adagrad(model.parameters(), 0.01)
        grads = {}

        def keep(g):
            grads.update({n: t.detach().cpu().clone() for n, t in g.items()})
            return g

        step = tdp.make_train_step(wide_deep.make_loss_fn(model), opt,
                                   cross_host_grad_fn=keep)
        _, metrics = step(tdp.TrainState.create(model, opt), batch)
        return (metrics["loss"].item(), grads,
                {k: v.cpu() for k, v in model.state_dict().items()})

    cpu, card = one_step("cpu"), one_step("cuda")

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    assert abs(card[0] - cpu[0]) <= 1e-5 * abs(cpu[0])
    for name in cpu[1]:
        assert rel(card[1][name], cpu[1][name]) <= 1e-5, name
        assert rel(card[2][name], cpu[2][name]) <= 1e-5, name


def test_cuda_all_reduce_tree_returns_cuda_tensors():
    """``all_reduce_tree`` hands back each CUDA leaf as a CUDA tensor in
    its own dtype (the train step assigns them to ``p.grad``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch_mapfuns  # pytest puts tests/ on the path

    with torch_mapfuns.world1_group() as group:
        tree = {"w": torch.arange(6.0, device="cuda").reshape(2, 3),
                "h": torch.ones(5, device="cuda", dtype=torch.bfloat16),
                "cpu": torch.zeros(2)}
        out = group.all_reduce_tree(tree)
    assert out["w"].device.type == "cuda" and out["w"].dtype == torch.float32
    assert out["h"].device.type == "cuda" and out["h"].dtype == torch.bfloat16
    assert out["cpu"].device.type == "cpu"
    torch.testing.assert_close(out["w"], tree["w"], rtol=0, atol=0)


@pytest.mark.parametrize("n,k,e,cap", [(8192, 2, 8, 2560), (16384, 2, 8, 5120),
                                       (4096, 2, 8, 600), (333, 1, 4, 40)])
def test_cuda_moe_dispatch_matches_cpu(n, k, e, cap):
    """``_sorted_dispatch`` on the card gives the CPU's slots, source tokens,
    gates and keep flags exactly, at the MoE slice's shapes (n = B·S at
    B=4 and 8, S=2048; capacity 2560 and 5120) and with forced overflow."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tensorflowonspark_torch.parallel import ep

    g = torch.Generator().manual_seed(n + cap)
    logits = torch.randn((n, e), generator=g) * 2
    # a few exact ties too: rows of equal logits
    logits[: n // 16] = 0.0
    top_p, top_idx = ep.top_k(torch.softmax(logits, -1), k)
    want = ep._sorted_dispatch(top_idx, top_p, cap, e)
    # the card's own top-k picks the same experts (its softmax may differ
    # from the CPU's in the last bit, never across a tie: ties are exact)
    _, cuda_idx = ep.top_k(torch.softmax(logits.cuda(), -1), k)
    torch.testing.assert_close(cuda_idx.cpu(), top_idx, rtol=0, atol=0)
    got = ep._sorted_dispatch(top_idx.cuda(), top_p.cuda(), cap, e)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0)


@pytest.mark.parametrize("off", [0, -64, 64])
def test_cuda_lse_gradient_matches_plain_version(off):
    """The kernel's autograd function carries the lse cotangent: gradients
    of a loss on O and lse (a ring hop's use of them) against autograd of
    the plain ``chunk_attention``, including a fully masked chunk (off 64
    at S=64) and a chunk of the past (off -64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((2, 64, 4, 128), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    g_o = torch.randn((2, 64, 4, 128), generator=g, device="cuda").to(torch.bfloat16)
    g_l = torch.randn((2, 64, 4), generator=g, device="cuda")
    grads = []
    for fn in (ta.flash_attention_fwd, ta.chunk_attention):
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        o, lse = fn(*xs, causal=True, kv_offset=off)
        before = ta.LAUNCHES["flash_attn_bwd"]
        ((o.float() * g_o.float()).sum() + (lse.clamp(min=-1e4) * g_l).sum()).backward()
        launched = ta.LAUNCHES["flash_attn_bwd"] - before
        assert launched == int(fn is ta.flash_attention_fwd)
        grads.append([x.grad.float() for x in xs])
    # the kernel's forward rounds P and O to bf16 where the plain one keeps
    # f32, and its backward rounds P and dS to bf16 as product operands:
    # 2% relative L2
    for a, b in zip(*grads):
        assert (a - b).norm().item() <= 2e-2 * b.norm().item() + 1e-6


# (b, sq, sk, h, d, causal, kv_offset, dtype, packed, cotangents): the
# backward kernels' cases (chip_smoke.py's BWD_CASES): every tile (32, 64,
# 96, 128) and a head dim between two (80), a head dim of part 16-byte rows
# (36, padded to 40) at a ragged non-causal shape, masked rows at a
# kv_offset, a negative offset, a cotangent on lse alone and on out alone,
# packed q/k/v views read in place, fp16; and the same for f32 (the 3xTF32
# kernels; D 34 padded to 36)
BWD_CASES = {
    "d32": (2, 300, 300, 4, 32, True, 0, torch.bfloat16, False, "out+lse"),
    "d64": (2, 300, 300, 4, 64, True, 0, torch.bfloat16, False, "out+lse"),
    "d96": (2, 300, 300, 4, 96, True, 0, torch.bfloat16, False, "out+lse"),
    "d128": (2, 300, 300, 4, 128, True, 0, torch.bfloat16, False, "out+lse"),
    "d80_between_tiles": (2, 200, 200, 4, 80, True, 0, torch.bfloat16, False, "out"),
    "d36_ragged_20_52_noncausal": (2, 20, 52, 4, 36, False, 0, torch.bfloat16, False, "out"),
    "kv_offset_37_masked_rows": (1, 100, 70, 4, 128, True, 37, torch.bfloat16, False,
                                 "out+lse"),
    "kv_offset_negative": (1, 64, 192, 4, 128, True, -64, torch.bfloat16, False, "out"),
    "lse_cotangent_only": (2, 130, 170, 4, 64, True, 5, torch.bfloat16, False, "lse"),
    "out_cotangent_only": (2, 130, 170, 4, 128, False, 0, torch.bfloat16, False, "out"),
    "packed_qkv_view": (2, 300, 300, 4, 128, True, 0, torch.bfloat16, True, "out"),
    "fp16_d64": (2, 200, 330, 4, 64, True, 37, torch.float16, False, "out+lse"),
    "f32_d32": (2, 300, 300, 4, 32, True, 0, torch.float32, False, "out+lse"),
    "f32_d64": (2, 300, 300, 4, 64, True, 0, torch.float32, False, "out+lse"),
    "f32_d96": (2, 300, 300, 4, 96, True, 0, torch.float32, False, "out+lse"),
    "f32_d128": (2, 300, 300, 4, 128, True, 0, torch.float32, False, "out+lse"),
    "f32_d80_between_tiles": (2, 200, 200, 4, 80, True, 0, torch.float32, False, "out"),
    "f32_d34_ragged_20_52_noncausal": (2, 20, 52, 4, 34, False, 0, torch.float32, False,
                                       "out"),
    "f32_kv_offset_37_masked_rows": (1, 100, 70, 4, 128, True, 37, torch.float32, False,
                                     "out+lse"),
    "f32_kv_offset_negative": (1, 64, 192, 4, 128, True, -64, torch.float32, False, "out"),
    "f32_lse_cotangent_only": (2, 130, 170, 4, 64, True, 5, torch.float32, False, "lse"),
    "f32_out_cotangent_only": (2, 130, 170, 4, 128, False, 0, torch.float32, False, "out"),
    "f32_packed_qkv_view": (2, 300, 300, 4, 128, True, 0, torch.float32, True, "out"),
    # the f32 walks' rings wrap more than once (7 loop tiles of 32 rows on
    # 2 stages each side) and end on a partial tile
    "f32_ragged_200_330_kv_offset_5": (2, 200, 330, 4, 128, True, 5, torch.float32, False,
                                       "out+lse"),
}
# per gradient, relative L2 against the plain version on the same inputs:
# the kernels round P and dS to the input type as product operands and
# store the gradients in it (2^-9 relative in bf16), the plain version
# keeps f32 throughout
BWD_REL_TOL = 2e-2
# f32: the 3xTF32 products are good to about 2^-20 relative (x = hi + lo,
# the lo·lo term dropped), the plain version's einsums are f32 summed in
# another order; one TF32 pass (2^-11) would miss it
BWD_F32_REL_TOL = 1e-4


def bwd_inputs(b, sq, sk, h, d, causal, off, dtype, packed, cotangents, gen):
    """q, k, v, the kernel forward's lse, and the cotangents."""
    q, k, v = make_inputs(b, sq, sk, h, d, dtype, packed, gen)
    _, lse = ta.flash_attn_fwd_cuda(q, k, v, causal=causal, kv_offset=off)
    g_out = (torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
             if "out" in cotangents else None)
    g_lse = (torch.randn(lse.shape, generator=gen, device="cuda")
             if "lse" in cotangents else None)
    return q, k, v, lse, g_out, g_lse


def rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_cuda_bwd_kernel_matches_plain_version(case):
    """``tos::flash_attn_bwd`` on CUDA tensors launches the backward
    kernels of its route once (no forward kernel) and equals
    ``flash_attn_bwd_reference`` on the same q, k, v, lse and cotangents
    within ``BWD_REL_TOL`` per gradient (f32: ``BWD_F32_REL_TOL``); a fully
    masked row's dq is exactly 0, every gradient finite, contiguous, in the
    input type."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, sq, sk, h, d, causal, off, dtype, packed, cot = BWD_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, lse, g_out, g_lse = bwd_inputs(b, sq, sk, h, d, causal, off, dtype, packed,
                                            cot, g)
    if packed:
        assert ta._kernel_operand(q) is q
    route = "flash_attn_bwd_tf32" if dtype == torch.float32 else "flash_attn_bwd"
    assert ta._bwd_route(dtype, d)[0] == route
    tol = BWD_F32_REL_TOL if dtype == torch.float32 else BWD_REL_TOL
    before = dict(ta.LAUNCHES)
    got = torch.ops.tos.flash_attn_bwd(q, k, v, lse, g_out, g_lse, causal, None, off)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in ta.LAUNCHES.items()} == {
        n: int(n == route) for n in ta.LAUNCHES}
    want = ta.flash_attn_bwd_reference(q, k, v, lse, g_out, g_lse, causal=causal,
                                       kv_offset=off)
    for name, x, y, ref in zip("qkv", got, want, (q, k, v)):
        assert x.shape == ref.shape and x.dtype == dtype and x.is_contiguous(), name
        assert torch.isfinite(x).all(), name
        assert rel_l2(x, y) <= tol, (name, rel_l2(x, y))
    masked = lse <= ta.NEG_INF / 2
    assert (got[0][masked] == 0).all()
    if case.endswith("kv_offset_37_masked_rows"):
        assert masked.any()


def test_cuda_bwd_kernel_is_deterministic():
    """dQ has a kernel of its own (no atomics): two calls on the same inputs
    give the same gradients bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(5)
    args = bwd_inputs(2, 512, 512, 4, 128, True, 0, torch.bfloat16, False, "out+lse", g)
    first = torch.ops.tos.flash_attn_bwd(*args, True, None, 0)
    second = torch.ops.tos.flash_attn_bwd(*args, True, None, 0)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_cuda_bwd_kernel_dq_exact_when_keys_share_a_large_component():
    """Keys and values sharing a large common component (as a trained LM's
    do): the kernels' Δ is the f32 sum of P ∘ dP, so dq does not see the
    component, within ``BWD_REL_TOL`` of the f32 gradient of the same bf16
    inputs (FA2's Δ from the bf16 O would be off by about 13%)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(7)
    common = 4 * torch.randn((1, 1, 4, 128), generator=g, device="cuda")
    q, k, v, g_out = ((torch.randn((2, 512, 4, 128), generator=g, device="cuda") + c)
                      .bfloat16() for c in (0, common, common, 0))
    _, lse = ta.flash_attn_fwd_cuda(q, k, v, causal=True)
    got = torch.ops.tos.flash_attn_bwd(q, k, v, lse, g_out, None, True, None, 0)
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ta.blockwise_attention(*leaves, causal=True).backward(g_out.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for x, want in zip(got, leaves):
        assert rel_l2(x, want.grad) <= BWD_REL_TOL


def test_cuda_bwd_tf32_kernel_is_deterministic():
    """The f32 kernels too (dQ apart, no atomics): two calls on the same
    inputs give the same gradients bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(9)
    args = bwd_inputs(2, 512, 512, 4, 128, True, 0, torch.float32, False, "out+lse", g)
    first = torch.ops.tos.flash_attn_bwd(*args, True, None, 0)
    second = torch.ops.tos.flash_attn_bwd(*args, True, None, 0)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_cuda_bwd_tf32_kernel_dq_exact_when_keys_share_a_large_component():
    """The f32 twin of the test above: keys and values sharing a large
    common component, f32 inputs; the 3xTF32 kernels' exact Δ keeps dq
    (and dk, dv) within ``BWD_F32_REL_TOL`` of the f32 gradient (TF32 off)
    of the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(10)
    common = 4 * torch.randn((1, 1, 4, 128), generator=g, device="cuda")
    q, k, v, g_out = (torch.randn((2, 512, 4, 128), generator=g, device="cuda") + c
                      for c in (0, common, common, 0))
    _, lse = ta.flash_attn_fwd_cuda(q, k, v, causal=True)
    before = ta.LAUNCHES["flash_attn_bwd_tf32"]
    got = torch.ops.tos.flash_attn_bwd(q, k, v, lse, g_out, None, True, None, 0)
    assert ta.LAUNCHES["flash_attn_bwd_tf32"] == before + 1
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ta.blockwise_attention(*leaves, causal=True).backward(g_out)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for x, want in zip(got, leaves):
        assert rel_l2(x, want.grad) <= BWD_F32_REL_TOL


def test_cuda_bwd_tf32_kernel_at_the_f32_lm_step_shape():
    """The f32 kernels at the f32 LM step's shape (B=2 S=2048 H=8 D=128,
    causal): one launch, and dq, dk, dv within ``BWD_F32_REL_TOL`` of
    ``flash_attn_bwd_reference`` on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(12)
    args = bwd_inputs(2, 2048, 2048, 8, 128, True, 0, torch.float32, False, "out", g)
    before = dict(ta.LAUNCHES)
    got = torch.ops.tos.flash_attn_bwd(*args, True, None, 0)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in ta.LAUNCHES.items()} == {
        n: int(n == "flash_attn_bwd_tf32") for n in ta.LAUNCHES}
    want = ta.flash_attn_bwd_reference(*args, causal=True)
    for name, x, y in zip("qkv", got, want):
        assert torch.isfinite(x).all(), name
        assert rel_l2(x, y) <= BWD_F32_REL_TOL, (name, rel_l2(x, y))


def test_cuda_bwd_tf32_kernel_first_call_from_a_fresh_thread():
    """The f32 backward called first on a thread that has made no CUDA call
    of its own (autograd's device thread runs the backward so): the same
    gradients, bit for bit, as the same call on this thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import threading

    g = torch.Generator(device="cuda").manual_seed(11)
    args = bwd_inputs(1, 200, 150, 2, 128, True, 37, torch.float32, False, "out", g)
    got, errors = {}, []

    def run():
        try:
            got["bwd"] = torch.ops.tos.flash_attn_bwd(*args, True, None, 37)
            torch.cuda.synchronize()
        except Exception as e:  # re-raised on the test's thread
            errors.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
    if errors:
        raise errors[0]
    want = torch.ops.tos.flash_attn_bwd(*args, True, None, 37)
    for x, y in zip(got["bwd"], want):
        assert torch.equal(x, y)


def test_cuda_kernels_launch_from_a_fresh_thread():
    """The forward and the backward kernels called first on a thread that
    has made no CUDA call of its own (autograd's device thread runs the
    backward so): the tensor maps' driver call needs the device's context
    current on that thread, and the kernels bind it; the results equal
    those of the same calls on this thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import threading

    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, lse, g_out, _ = bwd_inputs(1, 200, 150, 2, 128, True, 37, torch.bfloat16,
                                        False, "out", g)
    got, errors = {}, []

    def run():
        try:
            got["fwd"] = ta.flash_attn_fwd_cuda(q, k, v, causal=True, kv_offset=37)
            got["bwd"] = torch.ops.tos.flash_attn_bwd(q, k, v, lse, g_out, None, True, None,
                                                      37)
            torch.cuda.synchronize()
        except Exception as e:  # re-raised on the test's thread
            errors.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
    if errors:
        raise errors[0]
    want_fwd = ta.flash_attn_fwd_cuda(q, k, v, causal=True, kv_offset=37)
    want_bwd = torch.ops.tos.flash_attn_bwd(q, k, v, lse, g_out, None, True, None, 37)
    for x, y in zip((*got["fwd"], *got["bwd"]), (*want_fwd, *want_bwd)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 160), (torch.bfloat16, 192),
                                     (torch.float16, 256)])
def test_cuda_bwd_route_sends_f32_and_wide_heads_to_the_recompute(dtype, d):
    """Heads above 128, f32 or bf16/fp16, take the recompute VJP through
    ``blockwise_attention`` by ``_bwd_route`` alone: a FlashAttention
    backward launches no backward kernel, and the kernel wrapper itself
    refuses them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (x.requires_grad_() for x in make_inputs(1, 70, 70, 2, d, dtype, False, g))
    assert ta._bwd_route(dtype, d) == ("recompute", d)
    out = ta.flash_attention(q, k, v, causal=True)
    before = {n: ta.LAUNCHES[n] for n in ta.BWD_KERNELS}
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert {n: ta.LAUNCHES[n] for n in ta.BWD_KERNELS} == before
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))
    with pytest.raises(ValueError, match="backward kernels"):
        ta.flash_attn_bwd_cuda(q.detach(), k.detach(), v.detach(),
                               torch.zeros(out.shape[:3], device="cuda"), None, None)


def test_cuda_pp_one_process_1f1b_matches_plain_attention():
    """The 1F1B schedule with every stage in one process, on the card (2
    stages of 1 block, narrow, bf16): a forward and a recompute of each
    block per microbatch launch the kernel (2 · 2 layers · 2 microbatches),
    and the loss, the stage, head and input gradients agree with the same
    pipeline over plain attention (``attn_impl="xla"``): loss within 1e-2,
    each gradient within 5% (relative L2), the bounds ``chip_smoke.py``
    holds one step to."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from tensorflowonspark_torch.models import transformer as tfm
    from tensorflowonspark_torch.parallel import pp

    ids = torch.randint(0, 128, (4, 256), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))

    def run(attn_impl):
        with torch.device("cuda"):
            model = tfm.Transformer(vocab_size=128, d_model=128, n_layers=2, n_heads=2,
                                    attn_impl=attn_impl)
        model.init_weights(torch.Generator(device="cuda").manual_seed(0))
        stage_fn, stacked, head, emb = tfm.pipeline_parts(model, 2)
        x = torch.nn.functional.embedding(ids, emb).to(model.compute_dtype)
        before = ta.LAUNCHES["flash_attn_fwd"]
        loss, grads, head_grads, dx = pp.pipeline_1f1b(
            stage_fn, stacked, x, tfm.pipeline_head_loss(model), mesh=None, n_microbatches=2,
            targets=ids, head_params=head, with_input_grad=True)
        torch.cuda.synchronize()
        return loss, {**grads, **head_grads, "dx": dx}, ta.LAUNCHES["flash_attn_fwd"] - before

    loss, grads, launches = run("auto")
    plain_loss, plain_grads, plain_launches = run("xla")
    assert (launches, plain_launches) == (2 * 2 * 2, 0)
    assert torch.isfinite(loss) and abs(loss.item() - plain_loss.item()) <= 1e-2 * abs(plain_loss.item())
    for name, want in plain_grads.items():
        err = (grads[name].float() - want.float()).norm() / want.float().norm()
        assert err <= 0.05, (name, err.item())


def test_cuda_device_prefetch_from_a_live_ingest_feed(tmp_path, monkeypatch):
    """``ingest.device_prefetch`` onto the card from a live ``IngestFeed``
    under ``TOS_INGEST_ZEROCOPY=debug`` (a record view kept past its batch
    would fail when the feed retires the batch), depth 2, 4 batches whose
    leaves alias the shard buffer: the tensors on the card equal the host
    records, and the H2D copy runs on the side stream — held behind a spin
    there, it has not finished when the call returns, the consumer's stream
    waits on it, and what the consumer computes is still right."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from tensorflowonspark_torch import tfrecord
    from tensorflowonspark_torch.feeding import FeedQueues
    from tensorflowonspark_torch.ingest import IngestFeed, device_prefetch
    from tensorflowonspark_torch.marker import EndOfFeed, EndPartition

    monkeypatch.setenv("TOS_INGEST_ZEROCOPY", "debug")
    records = [np.arange(64, dtype=np.float32) + 1000 * i for i in range(16)]
    queues = FeedQueues(("input",))
    for s in range(2):
        path = str(tmp_path / f"part-{s:05d}")
        tfrecord.write_records(path, [r.tobytes() for r in records[8 * s:8 * s + 8]])
        queues.get_queue("input").put(path)
        queues.get_queue("input").put(EndPartition(key=(0, s)))
    queues.get_queue("input").put(EndOfFeed())
    feed = IngestFeed(queues, readers=1)

    def views():
        while not feed.should_stop():
            batch = feed.next_batch(4)
            if batch:
                assert all(type(r) is memoryview for r in batch)
                yield tuple(np.frombuffer(r, np.float32) for r in batch)

    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(int(2e9))  # about a second of SM clock
    batches = device_prefetch(views(), depth=2, device="cuda", stream=side)
    first = next(batches)
    pending = torch.cuda.Event()
    pending.record()
    assert not pending.query() and not side.query()
    total = first[0].sum()  # queued on the consumer's stream, after the copy
    got = [first, *batches]
    assert len(got) == 4 and all(t.is_cuda for b in got for t in b)
    assert total.item() == float(records[0].sum())
    torch.cuda.synchronize()
    flat = [t.cpu().numpy() for b in got for t in b]
    assert sorted(int(a[0]) for a in flat) == [1000 * i for i in range(16)]
    for a in flat:
        np.testing.assert_array_equal(a, records[int(a[0]) // 1000])


def test_cuda_export_program_scores_like_build_apply(tmp_path):
    """``checkpoint.export_program`` on the card: a small MNIST CNN exported
    with a dynamic batch scores batches of 1 and 3 as ``build_apply`` does
    on the same weights (same process, same settings: within 1e-5 of the
    largest logit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from tensorflowonspark_torch.checkpoint import export_program
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.models import mnist
    from tensorflowonspark_torch.models.registry import build_apply

    config = {"model": "mnist_cnn", "num_classes": 10, "features": [4, 8], "dense": 16}
    model = mnist.build_mnist(config)
    model.init_weights(torch.Generator().manual_seed(0))
    params = torch_to_flax(model.state_dict(), config=config)
    export_program(str(tmp_path), params, config, (28, 28, 1), device="cuda")
    program = torch.export.load(str(tmp_path / "model.pt2")).module()
    apply = build_apply(config, "cuda")
    for b in (1, 3):
        x = np.random.RandomState(b).rand(b, 28, 28, 1).astype(np.float32)
        with torch.no_grad():
            got = program(torch.from_numpy(x).cuda())
        want = apply(params, x)
        assert got.device.type == "cuda"
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.parametrize("bf16", [True, False])
def test_cuda_export_program_exports_the_lm_through_the_kernel(tmp_path, bf16):
    """On the card the LM's forward reaches the attention kernels through
    ``tos::flash_attn_fwd``: ``export_program`` exports a small LM (head
    dim 128, 2 layers) with a dynamic batch, the graph holds one op call a
    layer, ``program.json`` names the route, and the program scores
    batches 1 and 3 as ``build_apply`` does on the same weights, launching
    the named kernel once a layer (bf16 within 2e-2 of the largest logit,
    f32 within 1e-4: the same kernels and aten ops, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    import numpy as np

    from tensorflowonspark_torch.checkpoint import export_program
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.models import transformer
    from tensorflowonspark_torch.models.registry import build_apply

    config = {"model": "transformer", "vocab_size": 64, "d_model": 256, "n_layers": 2,
              "n_heads": 2, "bf16": bf16}
    model = transformer.build_transformer(config)
    model.init_weights(torch.Generator().manual_seed(0))
    params = torch_to_flax(model.state_dict(), n_heads=2, config=config)
    before = dict(ta.LAUNCHES)
    export_program(str(tmp_path), params, config, (64,), input_dtype=np.int32,
                   device="cuda")
    assert ta.LAUNCHES == before  # the trace ran the fake implementation
    kernel, padded = ta._route(torch.bfloat16 if bf16 else torch.float32, 128)
    meta = json.loads((tmp_path / "program.json").read_text())
    assert meta["ops"] == ["tos::flash_attn_fwd"] and meta["device"] == "cuda"
    assert meta["op_routes"]["tos::flash_attn_fwd"] == [
        {"kernel": kernel, "padded_head_dim": padded, "nodes": 2}]
    exported = torch.export.load(str(tmp_path / "model.pt2"))
    assert sum(n.target is torch.ops.tos.flash_attn_fwd.default
               for n in exported.graph.nodes) == 2
    program = exported.module()
    apply = build_apply(config, "cuda")
    tol = 2e-2 if bf16 else 1e-4
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for b in (1, 3):
            ids = np.random.RandomState(b).randint(0, 64, (b, 64)).astype(np.int32)
            before = dict(ta.LAUNCHES)
            with torch.no_grad():
                got = program(torch.from_numpy(ids).cuda())
            torch.cuda.synchronize()
            assert {n: c - before[n] for n, c in ta.LAUNCHES.items()} == {
                n: 2 * (n == kernel) for n in ta.LAUNCHES}
            want = apply(params, ids)
            assert got.device.type == "cuda" and got.shape == (b, 64, 64)
            rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
            assert rel <= tol, rel
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


OP_CASES = {
    # (b, sq, sk, h, d, causal, kv_offset, dtype)
    "bf16_serving_heads": (2, 300, 300, 8, 128, True, 0, torch.bfloat16),
    "bf16_d32_padded": (2, 130, 170, 3, 32, False, 0, torch.bfloat16),
    "bf16_d96": (2, 130, 170, 3, 96, True, 5, torch.bfloat16),
    "f32_d36": (2, 70, 45, 2, 36, False, 0, torch.float32),
    "fp16_kv_offset": (1, 100, 70, 2, 64, True, 37, torch.float16),
    "f32_d128": (2, 200, 330, 3, 128, True, 5, torch.float32),
    "f32_d33_padded": (2, 70, 45, 2, 33, False, 0, torch.float32),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_cuda_flash_op_matches_plain_version(case):
    """``torch.ops.tos.flash_attn_fwd`` on CUDA tensors launches the kernel
    ``_route`` names, once, and equals the plain version at the kernel
    gates (O 2e-2 and lse 1e-2 in bf16/fp16, both 1e-4 in f32); a padded
    head dim comes back contiguous.  ``opcheck`` passes on the card too
    (the fake implementation's strides against the kernel's output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, sq, sk, h, d, causal, off, dtype = OP_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = make_inputs(b, sq, sk, h, d, dtype, False, g)
    route, _ = ta._route(dtype, d)
    before = dict(ta.LAUNCHES)
    o, lse = torch.ops.tos.flash_attn_fwd(q, k, v, causal, None, off)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in ta.LAUNCHES.items()} == {
        n: int(n == route) for n in ta.LAUNCHES}
    assert o.shape == q.shape and o.dtype == dtype and o.is_contiguous()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        po, pl = ta.chunk_attention(q, k, v, causal=causal, kv_offset=off)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if dtype == torch.float32:
        torch.testing.assert_close(o, po, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(lse, pl, atol=1e-4, rtol=1e-4)
    else:
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(lse, pl, atol=1e-2, rtol=1e-2)
    result = torch.library.opcheck(torch.ops.tos.flash_attn_fwd.default,
                                   (q, k, v, causal, None, off),
                                   atol=1e-4 if dtype == torch.float32 else 2e-2,
                                   rtol=1e-4 if dtype == torch.float32 else 2e-2)
    assert set(result.values()) == {"SUCCESS"}, result


def test_cuda_padded_out_needs_the_copy_for_opcheck():
    """Why ``tos::flash_attn_fwd``'s CUDA implementation returns
    ``out.contiguous()``: an op with the same fake implementation that
    returns ``flash_attn_fwd_cuda``'s ``out`` as it comes fails
    ``opcheck``'s fake-tensor check where the head dim is padded (bf16
    D=33 runs at 40, whole 16-byte rows: ``out`` is a slice of the padded O,
    the fake one is contiguous), and passes where it is not (D=32 on its
    tile, D=128, and D=320 on the bf16 wide route: O is written at the real
    head dim and no copy is made)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")

    @torch.library.custom_op(
        "tos_test::flash_view", mutates_args=(), device_types="cuda",
        schema="(Tensor q, Tensor k, Tensor v, bool causal, float? sm_scale, "
               "int kv_offset) -> (Tensor, Tensor)")
    def flash_view(q, k, v, causal, sm_scale, kv_offset):
        return ta.flash_attn_fwd_cuda(q, k, v, causal=causal, sm_scale=sm_scale,
                                      kv_offset=kv_offset)

    flash_view.register_fake(ta._flash_attn_fwd_op_fake)
    g = torch.Generator(device="cuda").manual_seed(4)
    # D=320 is the wide route at the real head dim: no pad, no slice
    for d, passes in ((33, False), (32, True), (128, True), (320, True)):
        q, k, v = make_inputs(2, 130, 130, 3, d, torch.bfloat16, False, g)
        args = (q, k, v, True, None, 0)
        assert flash_view(*args)[0].is_contiguous() == passes
        result = torch.library.opcheck(torch.ops.tos_test.flash_view.default, args,
                                       raise_exception=False, atol=2e-2, rtol=2e-2)
        assert (result["test_faketensor"] == "SUCCESS") == passes, result
        assert set(torch.library.opcheck(torch.ops.tos.flash_attn_fwd.default, args,
                                         atol=2e-2, rtol=2e-2).values()) == {"SUCCESS"}


# (b, sq, sk, h, d, causal, kv_offset, dtype): the D=320 shapes chip_smoke.py
# times, on the two wide routes; both split their keys (a combine follows)
CENSUS_CASES = {
    "bf16_d320": (2, 200, 330, 2, 320, False, 0, torch.bfloat16),
    "f32_d320": (2, 200, 330, 2, 320, True, 5, torch.float32),
}


@pytest.mark.parametrize("case", sorted(CENSUS_CASES))
def test_cuda_wide_route_call_pads_nothing_and_launches_one_kernel(case):
    """One ``flash_attn_fwd_cuda`` call on a wide route at a head dim of
    whole 16-byte rows, under ``torch.profiler``: no ``aten::constant_pad_nd``
    and no copy of q, k or v; on the card one attention kernel, at most one
    combine kernel (here exactly one: the grid is small, so the keys are
    split) and, for f32, V's transpose, and nothing else; one count in
    ``LAUNCHES``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    b, sq, sk, h, d, causal, off, dtype = CENSUS_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = make_inputs(b, sq, sk, h, d, dtype, False, g)
    route, run_d = ta._route(dtype, d)
    assert run_d == d and ta._wide_splits(route, b, h, sq, sk, d, causal, off,
                                          sm_count=ta._sm_count(q.device)) > 1
    ta.flash_attn_fwd_cuda(q, k, v, causal=causal, kv_offset=off)  # builds
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session without its device records is taken again
        before = dict(ta.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            o, lse = ta.flash_attn_fwd_cuda(q, k, v, causal=causal, kv_offset=off)
            torch.cuda.synchronize()
        assert {n: c - before[n] for n, c in ta.LAUNCHES.items()} == {
            n: int(n == route) for n in ta.LAUNCHES}
        kernels = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
        if kernels:
            break
    assert o.is_contiguous() and o.shape == q.shape
    names = [e.name for e in prof.events()]
    for op in ("aten::constant_pad_nd", "aten::pad", "aten::copy_", "aten::clone"):
        assert op not in names, (op, names)
    attention = [n for n in kernels if "flash_fwd" in n]
    combine = [n for n in kernels if "combine_splits" in n]
    prepass = [n for n in kernels if "transpose_v" in n]
    assert len(attention) == 1 and len(combine) == 1, kernels
    assert len(prepass) == int(dtype == torch.float32), kernels
    assert len(kernels) == len(attention) + len(combine) + len(prepass), kernels
    po, pl = ta.chunk_attention(q, k, v, causal=causal, kv_offset=off)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(o.float(), po.float(), **tol)


# (b, sq, sk, h, d, causal, kv_offset, dtype): the tiles at the real head
# dim, at the shapes chip_smoke.py times (the example LM's D=32 in both
# types, bf16 D=96 and D=192) and one between two tiles (bf16 D=40 on the
# 64 tile, f32 D=36 on the 64 tile)
TILE_CENSUS_CASES = {
    "bf16_d32": (4, 512, 512, 8, 32, True, 0, torch.bfloat16),
    "f32_d32": (2, 512, 512, 8, 32, True, 0, torch.float32),
    "bf16_d96": (2, 300, 300, 8, 96, True, 0, torch.bfloat16),
    "f32_d96": (2, 300, 300, 4, 96, False, 0, torch.float32),
    "bf16_d192": (2, 300, 300, 4, 192, True, 0, torch.bfloat16),
    "bf16_d40": (2, 130, 170, 3, 40, True, 5, torch.bfloat16),
    "f32_d36": (2, 130, 170, 3, 36, True, 5, torch.float32),
}


@pytest.mark.parametrize("case", sorted(TILE_CENSUS_CASES))
def test_cuda_tile_route_call_pads_nothing_and_launches_one_kernel(case):
    """One call on a tile route (a head dim up to 256 in bf16/fp16, up to 128
    in f32) at a head dim of whole 16-byte rows, under ``torch.profiler``,
    through ``flash_attn_fwd_cuda`` and through ``tos::flash_attn_fwd``: no
    pad, copy, clone, contiguous or slice on the host; on the card one
    attention kernel (and, for f32, its K/V pre-pass) and nothing else; one
    count in ``LAUNCHES``; O at the real head dim, contiguous, equal to the
    plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    b, sq, sk, h, d, causal, off, dtype = TILE_CENSUS_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = make_inputs(b, sq, sk, h, d, dtype, False, g)
    route, run_d = ta._route(dtype, d)
    assert run_d == d <= ta._HEAD_DIMS[route][-1]
    calls = {"wrapper": lambda: ta.flash_attn_fwd_cuda(q, k, v, causal=causal, kv_offset=off),
             "op": lambda: torch.ops.tos.flash_attn_fwd(q, k, v, causal, None, off)}
    for how, call in calls.items():
        call()  # builds
        torch.cuda.synchronize()
        for _ in range(3):  # a profiler session without its device records is taken again
            before = dict(ta.LAUNCHES)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                o, lse = call()
                torch.cuda.synchronize()
            assert {n: c - before[n] for n, c in ta.LAUNCHES.items()} == {
                n: int(n == route) for n in ta.LAUNCHES}, how
            kernels = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
            if kernels:
                break
        names = [e.name for e in prof.events()]
        for op in ("aten::constant_pad_nd", "aten::pad", "aten::copy_", "aten::clone",
                   "aten::contiguous", "aten::slice"):
            assert op not in names, (how, op, names)
        attention = [n for n in kernels if "flash_fwd" in n]
        prepass = [n for n in kernels if "split_kv" in n]
        assert len(attention) == 1, (how, kernels)
        assert len(prepass) == int(dtype == torch.float32), (how, kernels)
        assert len(kernels) == len(attention) + len(prepass), (how, kernels)
        assert o.is_contiguous() and o.shape == q.shape and o.dtype == dtype
    po, pl = ta.chunk_attention(q, k, v, causal=causal, kv_offset=off)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(o.float(), po.float(), **tol)
