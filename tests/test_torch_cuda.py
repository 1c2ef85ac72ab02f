"""The attention kernels (the Hopper ``wgmma`` kernel for bf16/fp16 at head
dims up to 256 with its zero-padded path and above 256 on its wide route,
the 3xTF32 ``wgmma`` kernel for f32 up to 128 and above 128 on its wide
route) against their plain PyTorch version, on the card.  No JAX here, so the file runs on the machine with the card:

    python -m pytest tests/test_torch_cuda.py

Without a CUDA device every test skips (the kernel has no CPU mode).
"""

import pytest
import torch

from tensorflowonspark_torch.ops import attention as ta

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
# than bf16/fp16 at 64 and 128: bf16/fp16 at 129-256 (the wgmma kernel at
# D=256, zero-padded), bf16/fp16 below 128 (padded to 64 or 128), bf16/fp16
# above 256 (the wgmma kernel's wide route, slices of 256), f32 up to 128
# (the 3xTF32 kernel, padded to 64 or 128) and f32 above 128 (its wide
# route, padded to a multiple of 128, slices of 256)
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
    # the wide routes, slices of 256: f32 and bf16/fp16 at 320 (padded to
    # 384), 384 (256 + 128), 448 (padded to 512) and 512
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
    if packed and d in ta.KERNEL_HEAD_DIMS + (512,):  # read in place, not copied
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
    """FlashAttention (kernel forward, recompute backward) against autograd
    through the plain blockwise forward, bf16 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, s, sk, h, d, causal, off = GRAD_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = make_inputs(b, s, sk, h, d, torch.bfloat16, False, g)
    cot = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
    grads, outs = [], []
    for attend in (ta.flash_attention, ta.blockwise_attention):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        before = ta.LAUNCHES["flash_attn_fwd"]
        out = attend(*leaves, causal=causal, kv_offset=off)
        launched = ta.LAUNCHES["flash_attn_fwd"] - before
        assert launched == (1 if attend is ta.flash_attention else 0)
        out.backward(cot)
        assert ta.LAUNCHES["flash_attn_fwd"] - before == launched  # none in backward
        outs.append(out.float())
        grads.append([x.grad.float() for x in leaves])
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0], outs[1], atol=2e-2, rtol=2e-2)
    # both backwards are the same recompute of the same q, k, v and cotangent
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
    before = ta.LAUNCHES["flash_attn_fwd"]
    _, metrics = step(dp.TrainState.create(model, opt), {"input_ids": ids})
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"])
    assert ta.LAUNCHES["flash_attn_fwd"] - before == 3 * (2 if remat else 1)


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
