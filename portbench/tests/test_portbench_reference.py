"""The plain references against the port at tiny sizes, both in float32, on
weights and batches the test makes; and the frozen arithmetic's hand
counts at the cells' shapes."""

from __future__ import annotations

import pytest
import torch

from portbench import roofline, traffic, weights
from portbench.entries import image_train, lm_train
from portbench.reference import lm as reference_lm
from portbench.reference import resnet50 as reference_resnet
from portbench.tests.tiny import MIXES, TINY_LM, TINY_RESNET

SEED = 2**31 + 101


def test_lm_reference_matches_the_port():
    from tensorflowonspark_torch.models import transformer as tfm

    cfg = TINY_LM
    w = weights.make(reference_lm.param_spec(cfg), SEED, "cpu")
    model = tfm.build_transformer(lm_train.model_config(cfg))
    named = dict(model.named_parameters())
    with torch.no_grad():
        for n, t in w.items():
            named[n].copy_(t)
    ids = torch.from_numpy(traffic.generate(MIXES["tiny-zipf"], cfg, SEED, "cpu")[0])
    loss, _ = tfm.make_loss_fn(model)(model, {"input_ids": ids})
    loss.backward()
    params = {n: t.clone().requires_grad_() for n, t in w.items()}
    ref = reference_lm.LM(cfg).loss(params, ids)
    grads = torch.autograd.grad(ref, list(params.values()))
    assert loss.item() == pytest.approx(ref.item(), rel=1e-6)
    for (name, p), g in zip(params.items(), grads):
        torch.testing.assert_close(named[name].grad, g, rtol=1e-4, atol=1e-7)


def test_resnet_reference_matches_the_port():
    from tensorflowonspark_torch.models import resnet

    cfg = TINY_RESNET
    w = weights.make(reference_resnet.param_spec(cfg), SEED, "cpu")
    buf = weights.make(reference_resnet.buffer_spec(cfg), SEED + 1, "cpu")
    model = resnet.build_resnet50(image_train.model_config(cfg)).train()
    named = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    with torch.no_grad():
        for n, t in {**w, **buf}.items():
            named[n].copy_(t)
    batch = traffic.generate(MIXES["tiny-images"], cfg, SEED, "cpu")[0]
    loss, _ = resnet.make_loss_fn(model, weight_decay=cfg["weight_decay"])(model, batch)
    loss.backward()
    params = {n: t.clone().requires_grad_() for n, t in w.items()}
    moving = {n: t.clone() for n, t in buf.items()}
    ref = reference_resnet.ResNet50(cfg).loss(params, moving, batch)
    grads = torch.autograd.grad(ref, list(params.values()))
    assert loss.item() == pytest.approx(ref.item(), rel=1e-5)
    # batch norm over a tiny batch magnifies float32 rounding in the
    # gradients of the norm layers; the kernels' gradients agree closer
    for (name, p), g in zip(params.items(), grads):
        assert named[name].grad.norm().item() == pytest.approx(g.norm().item(), rel=2e-3,
                                                               abs=1e-6), name
    for name, t in moving.items():
        torch.testing.assert_close(named[name], t, rtol=1e-5, atol=1e-6)


def test_the_hand_counts_at_the_cells_shapes():
    flops, _ = roofline.lm_step_flops(102400, 4096, 4, 32, 128, 11008, 4, 4096)
    assert flops == pytest.approx(1.274e14, rel=1e-3)
    fwd, by = roofline.attention_fwd_bound_s(4, 4096, 4096, 32, 128, True, 2)
    assert (fwd * 1e3, by) == (pytest.approx(0.556, rel=1e-3), "operations")
    bwd, _ = roofline.attention_bwd_bound_s(4, 4096, 32, 128, True, 2)
    assert bwd == pytest.approx(2.5 * fwd, rel=1e-6)
    assert roofline.lm_attention_flops(4, 4096, 32, 128, 4) == pytest.approx(6.60e12, rel=1e-3)
    assert roofline.lm_attention_flops(16, 1024, 32, 128, 4) == pytest.approx(1.65e12, rel=1e-3)
    params = roofline.lm_params(102400, 4096, 4, 32, 128, 11008)
    total = params["embedding"] + params["blocks"] + params["final_norm"] + params["lm_head"]
    assert total == pytest.approx(1.649e9, rel=1e-3)


def test_the_resnet_count_holds_against_the_ports_layers():
    """The shape walk against every ``Conv`` and ``Dense`` the port's
    ResNet-50 runs, counted from their outputs as ``chip_smoke.py``'s
    ``conv_dense_flops`` counts them."""
    from tensorflowonspark_torch.models import layers, resnet

    model = resnet.build_resnet50({"num_classes": 1000, "bf16": False}).eval()
    counted = []

    def hook(module, inputs, out):
        fan_in = module.weight[0].numel() if isinstance(module, layers.Conv) \
            else module.weight.shape[1]
        counted.append(2 * out.numel() * fan_in)

    for m in model.modules():
        if isinstance(m, (layers.Conv, layers.Dense)):
            m.register_forward_hook(hook)
    with torch.inference_mode():
        model(torch.zeros(1, 64, 64, 3))
    flops, n = roofline.resnet_forward_flops(64, 1000)
    assert (sum(counted), len(counted)) == (flops, n)
    assert roofline.resnet_forward_flops()[0] == pytest.approx(8.178e9, rel=1e-3)


def test_weights_and_traffic_follow_the_seed():
    spec = reference_lm.param_spec(TINY_LM)
    a, b = weights.make(spec, SEED, "cpu"), weights.make(spec, SEED, "cpu")
    c = weights.make(spec, SEED + 1, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed.weight"], c["embed.weight"])
    assert a["embed.weight"].std().item() == pytest.approx(0.02, rel=0.05)
    pool = traffic.generate(MIXES["tiny-zipf"], TINY_LM, SEED, "cpu")
    again = traffic.generate(MIXES["tiny-zipf"], TINY_LM, SEED, "cpu")
    rows = {r.tobytes() for batch in pool for r in batch}
    assert len(rows) == sum(len(batch) for batch in pool)  # every row differs
    assert all((x == y).all() for x, y in zip(pool, again))
    assert max(int(batch.max()) for batch in pool) < TINY_LM["vocab_size"]
