"""Port ``blockwise_cross_entropy`` (``tensorflowonspark_torch.ops.xent``)
against the JAX package's (``tensorflowonspark_tpu/ops/xent.py``): forward
and gradients, chunks that divide V and chunks that do not (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tensorflowonspark_torch.ops.xent import blockwise_cross_entropy
from tensorflowonspark_tpu.ops import xent as jxent
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

N, D, V = 24, 16, 50
FWD_TOL = dict(rtol=1e-5, atol=1e-5)  # f32, the same chunk sums
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)  # f32, products summed in other orders


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, D).astype(np.float32),
            (rng.randn(D, V) * 0.3).astype(np.float32),
            rng.randint(0, V, (N,)).astype(np.int32))


@pytest.mark.parametrize("chunk", [16, 50, 64, 7, 10])
def test_forward_matches_jax(chunk):
    h, w, t = _data()
    ref = jxent.blockwise_cross_entropy(jnp.asarray(h), jnp.asarray(w),
                                        jnp.asarray(t), chunk=chunk)
    got = blockwise_cross_entropy(torch.from_numpy(h), torch.from_numpy(w),
                                  torch.from_numpy(t), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)
    dense = F.cross_entropy(torch.from_numpy(h @ w), torch.from_numpy(t).long(),
                            reduction="none")
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **FWD_TOL)


@pytest.mark.parametrize("chunk", [10, 16])  # divides V = 50, and does not
def test_grads_match_jax(chunk):
    h, w, t = _data(1)
    g = np.random.RandomState(2).rand(N).astype(np.float32)  # per-token cotangent
    jh, jw = jax.grad(lambda h_, w_: (jxent.blockwise_cross_entropy(
        h_, w_, jnp.asarray(t), chunk=chunk) * g).sum(), argnums=(0, 1))(
            jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    (blockwise_cross_entropy(th, tw, torch.from_numpy(t), chunk=chunk)
     * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jh), **GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw), **GRAD_TOL)


def test_bf16_inputs_give_f32_loss_and_input_typed_grads():
    h, w, t = _data(3)
    th = torch.from_numpy(h).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).bfloat16().requires_grad_()
    nll = blockwise_cross_entropy(th, tw, torch.from_numpy(t), chunk=16)
    assert nll.dtype == torch.float32
    nll.mean().backward()
    assert th.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.bfloat16
    # the products run on the widened bf16 values: exact f32 of those inputs
    ref = F.cross_entropy(th.detach().float() @ tw.detach().float(),
                          torch.from_numpy(t).long(), reduction="none")
    np.testing.assert_allclose(nll.detach().numpy(), ref.numpy(), **FWD_TOL)
