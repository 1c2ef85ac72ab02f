"""Port ``Transformer`` against the JAX package's (``attn_impl=
"pallas_interpret"``, so the JAX side runs its Pallas kernel), weights moved
through ``convert.py``; plus the converter's round trip and the options
``build_transformer`` refuses.  The decode path is held against JAX in
``tests/test_torch_decode.py``."""

import jax
import numpy as np
import pytest
import torch

from tensorflowonspark_torch import convert
from tensorflowonspark_torch.models import registry as treg
from tensorflowonspark_torch.models import transformer as ttfm
from tensorflowonspark_tpu.models import transformer as jtfm
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

SMALL = {"model": "transformer", "vocab_size": 64, "d_model": 32,
         "n_layers": 2, "n_heads": 4, "attn_impl": "pallas_interpret"}
SEQ = 40


def _ids(b=2, seed=0):
    return np.random.RandomState(seed).randint(0, 64, (b, SEQ)).astype(np.int32)


def _jax_params(cfg, seed=0):
    model = jtfm.build_transformer(cfg)
    params = model.init(jax.random.PRNGKey(seed), _ids(1))["params"]
    # random norm scales too, so a transposed/misnamed scale cannot hide
    rng = np.random.RandomState(seed + 1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (np.asarray(x) * (1 + 0.1 * rng.randn(*x.shape))).astype(np.float32)
        if "scale" in str(p[-1]) else np.asarray(x), params)
    return model, params


def _port_logits(cfg, params, ids):
    apply = treg.build_apply(cfg, device="cpu")
    return apply(params, ids).numpy()


def test_f32_logits_match_jax_pallas_interpret():
    cfg = {**SMALL, "bf16": False}
    model, params = _jax_params(cfg)
    ids = _ids()
    ref = np.asarray(model.apply({"params": params}, ids))
    out = _port_logits(cfg, params, ids)
    assert out.shape == (2, SEQ, 64) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_bf16_logits_close_to_jax():
    cfg = {**SMALL, "bf16": True}
    model, params = _jax_params(cfg)
    ids = _ids()
    ref = np.asarray(model.apply({"params": params}, ids))
    out = _port_logits(cfg, params, ids)
    assert out.dtype == np.float32
    # both sides compute in bf16 (8 mantissa bits) but round at different
    # places over 2 layers: hold the error to 5% of the logits' scale
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=0.05 * scale, rtol=0)
    assert np.mean(out.argmax(-1) == ref.argmax(-1)) > 0.9


@pytest.mark.parametrize("impl", ["xla", "reference"])
def test_plain_attention_impls_match_auto(impl):
    cfg = {**SMALL, "bf16": False}
    _, params = _jax_params(cfg)
    ids = _ids()
    base = _port_logits({**cfg, "attn_impl": "auto"}, params, ids)
    np.testing.assert_allclose(_port_logits({**cfg, "attn_impl": impl}, params, ids),
                               base, atol=1e-5, rtol=1e-5)


def test_convert_round_trip():
    _, params = _jax_params({**SMALL, "bf16": False})
    state = convert.flax_to_torch(params)
    assert state["blocks.0.attn.q_proj.weight"].shape == (32, 32)
    assert state["lm_head.weight"].shape == (64, 32)
    back = convert.torch_to_flax(state, n_heads=4)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    # and the port's own module accepts exactly these keys
    model = ttfm.build_transformer({**SMALL, "bf16": False})
    model.load_state_dict(state, strict=True)


def test_rope_and_rmsnorm_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 10, 3, 8).astype(np.float32)
    pos = np.arange(10)
    np.testing.assert_allclose(
        ttfm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jtfm.apply_rope(x, pos)), atol=1e-6, rtol=1e-6)
    h = rng.randn(4, 16).astype(np.float32)
    scale = rng.randn(16).astype(np.float32)
    ref = jtfm.RMSNorm().apply({"params": {"scale": scale}}, h)
    norm = ttfm.RMSNorm(16)
    norm.scale.data = torch.from_numpy(scale)
    np.testing.assert_allclose(norm(torch.from_numpy(h)).detach().numpy(),
                               np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_pad_and_pack_batch_match_jax():
    docs = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11]]
    for fn in ("pad_batch",):
        a, b = getattr(ttfm, fn)(docs, 6), getattr(jtfm, fn)(docs, 6)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    a = ttfm.pack_batch(docs, 6, eos_id=0, n_rows=4)
    b = jtfm.pack_batch(docs, 6, eos_id=0, n_rows=4)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


# MoE and sequence parallelism are ported (tests/test_torch_moe.py and
# tests/test_torch_parallel.py); what build_transformer still refuses is what
# the JAX package refuses: top-2 routing over one expert, and ring or
# Ulysses attention without a mesh.  The ids are the cases' old names.
@pytest.mark.parametrize("cfg,match", [
    ({"n_experts": 1}, "top_k 2"),
    ({"attn_impl": "ring"}, "needs mesh="),
    ({"attn_impl": "ulysses"}, "needs mesh="),
], ids=["cfg0-MoE", "cfg1-sequence parallelism", "cfg2-sequence parallelism"])
def test_unported_options_raise_not_implemented(cfg, match):
    with pytest.raises(ValueError, match=match):
        ttfm.build_transformer({**SMALL, **cfg})


def test_build_apply_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        treg.build_apply(SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        treg.build_apply(SMALL, device="cuda")


def test_training_holds_f32_masters_and_serving_casts_once():
    cfg = {**SMALL, "bf16": True, "attn_impl": "auto"}
    _, params = _jax_params(cfg)
    model = ttfm.build_transformer(cfg)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    model.load_state_dict(convert.flax_to_torch(params))
    apply = treg.build_apply(cfg, device="cpu")
    served = apply(params, _ids())
    dtypes = {n: p.dtype for n, p in apply.model.named_parameters()}
    assert dtypes["blocks.0.attn.q_proj.weight"] == torch.bfloat16
    assert dtypes["embed.weight"] == dtypes["lm_head.weight"] == torch.bfloat16
    assert dtypes["final_norm.scale"] == dtypes["blocks.1.mlp_norm.scale"] == torch.float32
    # the cast at each use gives the very values the cast at load gives
    with torch.inference_mode():
        trained = model.eval()(torch.from_numpy(_ids()))
    torch.testing.assert_close(trained, served, rtol=0, atol=0)
