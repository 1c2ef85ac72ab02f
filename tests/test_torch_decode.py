"""The port's KV-cache decode path against the JAX package's — restating
``tests/test_lm_decode.py``: cached logits equal the full forward at every
position, greedy tokens equal JAX ``greedy_generate`` token for token, the
chunked prefill equals per-token prefill, EOS stops rows, sampling is valid
and seeded; plus the loss masking of padded and packed batches.  f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_torch import convert
from tensorflowonspark_torch.models import transformer as ttfm
from tensorflowonspark_tpu.models import transformer as jtfm
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

CFG = {"model": "transformer", "vocab_size": 29, "d_model": 16, "n_layers": 2,
       "n_heads": 2, "bf16": False, "attn_impl": "xla"}
TOL = dict(rtol=2e-4, atol=2e-4)  # f32; cached einsum vs blockwise forward


@pytest.fixture(scope="module")
def lm():
    jmodel = jtfm.Transformer(vocab_size=29, d_model=16, n_layers=2, n_heads=2,
                              attn_impl="xla", compute_dtype=jnp.float32)
    ids = np.random.RandomState(3).randint(0, 29, (2, 10)).astype(np.int32)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), ids)["params"])
    tmodel = ttfm.build_transformer(CFG)
    tmodel.load_state_dict(convert.flax_to_torch(params), strict=True)
    return jmodel, params, tmodel.eval(), ids


def _full(tmodel, ids):
    with torch.inference_mode():
        return tmodel(torch.from_numpy(np.asarray(ids))).numpy()


def test_decode_cache_matches_full_forward(lm):
    jmodel, params, tmodel, ids = lm
    full = _full(tmodel, ids)
    np.testing.assert_allclose(full, np.asarray(jmodel.apply({"params": params}, ids)),
                               **TOL)
    cache = ttfm.KVCache.empty(tmodel, 2, ids.shape[1])
    with torch.inference_mode():
        for i in range(ids.shape[1]):
            logits, cache = tmodel(torch.from_numpy(ids[:, i:i + 1]), cache)
            np.testing.assert_allclose(logits[:, 0].numpy(), full[:, i], **TOL)
    assert cache.index == ids.shape[1]
    assert cache.k[0].shape == (2, 10, 2, 8) and cache.k[0].dtype == torch.float32


def test_greedy_generate_matches_jax_token_for_token(lm):
    jmodel, params, tmodel, ids = lm
    prompt = ids[:, :4]
    out = ttfm.greedy_generate(tmodel, prompt, max_new_tokens=5)
    ref = jtfm.greedy_generate(jmodel, params, jnp.asarray(prompt), max_new_tokens=5)
    assert out.shape == (2, 9) and out.dtype == np.int32
    np.testing.assert_array_equal(out, np.asarray(ref))
    # and it is the teacher-forced argmax chain of the full model
    full = _full(tmodel, out)
    for t in range(4, 9):
        np.testing.assert_array_equal(full[:, t - 1].argmax(-1), out[:, t])


def test_chunked_prefill_matches_per_token_prefill(lm):
    _, _, tmodel, ids = lm
    prompt = torch.from_numpy(ids[:, :7])
    L = ids.shape[1]
    per_token, cache1 = [], ttfm.KVCache.empty(tmodel, 2, L)
    with torch.inference_mode():
        for i in range(7):
            logits, cache1 = tmodel(prompt[:, i:i + 1], cache1)
            per_token.append(logits[:, 0].numpy())
        chunk_logits, cache2 = tmodel(prompt, ttfm.KVCache.empty(tmodel, 2, L))
    for i in range(7):
        np.testing.assert_allclose(chunk_logits[:, i].numpy(), per_token[i],
                                   rtol=2e-5, atol=2e-5)
    assert cache1.index == cache2.index == 7
    for a, b in zip(cache1.k + cache1.v, cache2.k + cache2.v):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-5)
    out = ttfm.greedy_generate(tmodel, ids[:, :7], max_new_tokens=3, max_decode_len=L)
    np.testing.assert_array_equal(_full(tmodel, out[:, :7])[:, -1].argmax(-1), out[:, 7])


def test_eos_early_stop_pads_and_truncates(lm):
    _, _, tmodel, ids = lm
    prompt = ids[:, :3]
    base = ttfm.greedy_generate(tmodel, prompt, max_new_tokens=6)
    eos = int(base[0, 3])  # row 0 "finishes" at its first new token
    out = ttfm.greedy_generate(tmodel, prompt, max_new_tokens=6, eos_id=eos,
                               pad_id=0, max_decode_len=9)
    assert out.shape[1] <= base.shape[1]
    for r in range(out.shape[0]):
        gen = out[r, 3:]
        hits = np.where(gen == eos)[0]
        end = hits[0] + 1 if len(hits) else len(gen)
        np.testing.assert_array_equal(gen[:end], base[r, 3:3 + end])
        assert (gen[end:] == 0).all()
    assert out[0, 3] == eos and (out[0, 4:] == 0).all()


def test_sampled_generation_valid_and_deterministic(lm):
    _, _, tmodel, ids = lm
    kw = dict(max_new_tokens=6, temperature=0.8, top_k=5, seed=11)
    a = ttfm.greedy_generate(tmodel, ids[:, :3], **kw)
    b = ttfm.greedy_generate(tmodel, ids[:, :3], **kw)
    np.testing.assert_array_equal(a, b)               # deterministic per seed
    assert a.shape == (2, 9) and ((a >= 0) & (a < 29)).all()
    # top_k=1 sampling is the greedy chain
    np.testing.assert_array_equal(
        ttfm.greedy_generate(tmodel, ids[:, :3], max_new_tokens=6, temperature=0.8,
                             top_k=1, seed=3),
        ttfm.greedy_generate(tmodel, ids[:, :3], max_new_tokens=6))


def test_cache_overflow_and_short_decode_len_raise(lm):
    _, _, tmodel, ids = lm
    with pytest.raises(ValueError, match="max_decode_len"):
        ttfm.greedy_generate(tmodel, ids[:, :4], max_new_tokens=5, max_decode_len=6)
    cache = ttfm.KVCache.empty(tmodel, 2, 3)
    with torch.inference_mode(), pytest.raises(ValueError, match="cache holds 3"):
        tmodel(torch.from_numpy(ids[:, :4]), cache)


def test_pad_batch_masks_padding_out_of_loss(lm):
    jmodel, params, tmodel, _ = lm
    batch = ttfm.pad_batch([[1, 2, 3, 4, 5, 6], [7, 8]], seq_len=6)
    loss_fn = ttfm.make_loss_fn(tmodel)
    with torch.no_grad():
        masked, _ = loss_fn(tmodel, batch)
        poisoned = dict(batch, input_ids=batch["input_ids"].copy())
        poisoned["input_ids"][1, 3:] = 9
        repoisoned, _ = loss_fn(tmodel, poisoned)
    assert repoisoned.item() == pytest.approx(masked.item(), rel=1e-6)
    ref, _ = jtfm.make_loss_fn(jmodel)(params, batch)
    assert masked.item() == pytest.approx(float(ref), rel=1e-5)


def test_pack_batch_runs_through_the_loss(lm):
    jmodel, params, tmodel, _ = lm
    docs = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10, 11, 12, 13, 14], [15]]
    batch = ttfm.pack_batch(docs, seq_len=8, eos_id=28, pad_id=0, n_rows=4)
    with torch.no_grad():
        loss, _ = ttfm.make_loss_fn(tmodel)(tmodel, batch)
    ref, _ = jtfm.make_loss_fn(jmodel)(params, batch)
    assert np.isfinite(loss.item())
    assert loss.item() == pytest.approx(float(ref), rel=1e-5)
