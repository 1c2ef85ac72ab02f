"""The port's MNIST CNN (``tensorflowonspark_torch/models/mnist.py``) against
the JAX package's on the CPU at a narrow width (features (4, 8), dense 16):
the same JAX-initialised weights, moved through ``convert.py``, and the same
seeded inputs through both.

Tolerances: float32 on both sides agrees to float32 rounding summed in other
orders: rtol 1e-5 with atol 1e-6 for parameters (of order 0.1) over 5 SGD
steps, and atol 1e-5 for logits (of order 1, each a sum over hundreds of
products, so a logit near 0 keeps the absolute error of its terms); bfloat16 compute rounds at different places on each side and is
held to 2% of the largest logit.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_torch import checkpoint as tckpt
from tensorflowonspark_torch import convert
from tensorflowonspark_torch.models import mnist as tmnist
from tensorflowonspark_torch.models import registry as treg
from tensorflowonspark_torch.parallel import dp as tdp
from tensorflowonspark_tpu import checkpoint as jckpt
from tensorflowonspark_tpu.models import mnist as jmnist
from tensorflowonspark_tpu.models import registry as jreg
from tensorflowonspark_tpu.parallel import dp as jdp

SMALL = {"model": "mnist_cnn", "num_classes": 10, "features": [4, 8], "dense": 16}
TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_params(config, seed=0):
    model = jmnist.build_mnist(config)
    return model, jax.device_get(jmnist.init_params(model, jax.random.PRNGKey(seed)))


def _batch(n=16, seed=0):
    return jmnist.batch_to_arrays(jmnist.synthetic_mnist(n, seed=seed))


def test_f32_logits_match_jax():
    model, params = _jax_params(SMALL)
    x = _batch()["image"]
    ref = np.asarray(model.apply({"params": params}, x))
    out = treg.build_apply(SMALL, device="cpu")(params, x)
    assert out.shape == (16, 10) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **LOGIT_TOL)


def test_bf16_logits_close_to_jax():
    config = {**SMALL, "bf16": True}
    model, params = _jax_params(config)
    x = _batch()["image"]
    ref = np.asarray(model.apply({"params": params}, x))
    out = treg.build_apply(config, device="cpu")(params, x)
    assert out.dtype == torch.float32                    # the head is float32
    assert np.abs(out.numpy() - ref).max() <= 0.02 * np.abs(ref).max()


def test_sgd_momentum_trajectory_matches_optax():
    """5 steps of ``make_train_step`` with ``torch.optim.SGD(momentum=0.9)``
    against the JAX step with ``optax.sgd(0.05, momentum=0.9)``, the params
    compared after every step."""
    jmodel, params = _jax_params(SMALL)
    jopt = optax.sgd(0.05, momentum=0.9)
    jstate = jdp.TrainState.create(params, jopt)
    jstep = jdp.make_train_step(jmnist.make_loss_fn(jmodel), jopt, donate=False)

    model = tmnist.build_mnist(SMALL)
    model.load_state_dict(convert.flax_to_torch(params, SMALL), strict=True)
    opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    state = tdp.TrainState.create(model, opt)
    step = tdp.make_train_step(tmnist.make_loss_fn(model), opt)
    for i in range(5):
        batch = _batch(16, seed=i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["accuracy"].item(), float(jm["accuracy"]))
        got = convert.torch_to_flax(model.state_dict(), config=SMALL)["params"]
        for path, want in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
            leaf = got
            for k in path:
                leaf = leaf[k.key]
            np.testing.assert_allclose(leaf, np.asarray(want), **TOL,
                                       err_msg=f"step {i + 1} {jax.tree_util.keystr(path)}")


def test_converter_round_trip_is_exact():
    _, params = _jax_params(SMALL)
    state = convert.flax_to_torch(params, SMALL)
    assert set(state) == {"Conv_0.weight", "Conv_0.bias", "Conv_1.weight", "Conv_1.bias",
                          "Dense_0.weight", "Dense_0.bias", "Dense_1.weight", "Dense_1.bias"}
    assert state["Conv_1.weight"].shape == (8, 4, 3, 3)
    assert state["Dense_0.weight"].shape == (16, 7 * 7 * 8)
    back = convert.torch_to_flax(state, config=SMALL)
    assert set(back) == {"params"}                       # no BN, no batch_stats
    flat = jax.tree_util.tree_flatten_with_path(back["params"])[0]
    assert len(flat) == len(jax.tree.leaves(params))
    for path, leaf in flat:
        want = params
        for k in path:
            want = want[k.key]
        np.testing.assert_array_equal(leaf, want)
        assert leaf.dtype == np.float32


def test_flatten_is_nhwc_order():
    """The first Dense sees the activations flattened in NHWC order, as flax
    flattens them: one nonzero row of its kernel picks one (h, w, c)."""
    _, params = _jax_params(SMALL)
    params = jax.tree.map(np.array, params)
    params["Dense_0"]["kernel"][:] = 0
    h, w, c = 3, 5, 6
    params["Dense_0"]["kernel"][(h * 7 + w) * 8 + c, 0] = 1.0
    model = tmnist.build_mnist(SMALL)
    model.load_state_dict(convert.flax_to_torch(params, SMALL))
    seen = {}
    model.Conv_1.register_forward_hook(lambda m, i, o: seen.update(act=o))
    model.Dense_0.register_forward_hook(lambda m, i, o: seen.update(dense=o))
    model(torch.from_numpy(_batch(2)["image"]))
    pooled = torch.nn.functional.max_pool2d(torch.relu(seen["act"]), 2, 2)
    want = pooled[:, c, h, w] + model.Dense_0.bias[0]
    torch.testing.assert_close(seen["dense"][:, 0], want)


def test_init_is_flax_init():
    """``init_weights``: lecun_normal kernels, zero biases, from a seeded
    generator (the same seed, the same weights)."""
    model = tmnist.build_mnist({"model": "mnist_cnn"})
    model.init_weights(torch.Generator().manual_seed(0))
    w = model.Dense_0.weight                               # [256, 3136]
    std = w.shape[1] ** -0.5
    assert abs(w.std().item() / std - 1) < 0.01
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978
    assert all(torch.count_nonzero(m.bias) == 0
               for m in (model.Conv_0, model.Conv_1, model.Dense_0, model.Dense_1))
    again = tmnist.build_mnist({"model": "mnist_cnn"}).init_weights(
        torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.state_dict(), model.state_dict(), rtol=0, atol=0)
    shapes = jax.eval_shape(lambda r: jmnist.init_params(jmnist.build_mnist({}), r),
                            jax.random.PRNGKey(0))
    assert sum(p.numel() for p in model.parameters()) == \
        sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


@pytest.mark.parametrize("bf16", [False, True])
def test_port_bundle_argmax_in_jax_build_apply(tmp_path, bf16):
    """A port-trained MNIST model exported through ``torch_to_flax`` gives
    the JAX ``build_apply`` the same argmax as the port's ``build_apply``."""
    config = {**SMALL, "bf16": bf16}
    model = tmnist.build_mnist(config).init_weights(torch.Generator().manual_seed(3))
    opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    step = tdp.make_train_step(tmnist.make_loss_fn(model), opt)
    state = tdp.TrainState.create(model, opt)
    for i in range(10):
        state, _ = step(state, _batch(32, seed=i))
    tckpt.export_bundle(str(tmp_path / "b"), convert.torch_to_flax(
        model.state_dict(), config=config), config)
    x = _batch(40, seed=99)["image"]
    jvars, jcfg = jckpt.load_bundle(str(tmp_path / "b"))
    ref = np.asarray(jreg.build_apply(jcfg)(jvars, x))
    pvars, pcfg = tckpt.load_bundle(str(tmp_path / "b"))
    out = treg.build_apply(pcfg, device="cpu")(pvars, x).numpy()
    if not bf16:
        np.testing.assert_allclose(out, ref, **LOGIT_TOL)
    # in bf16 each side may be off by the stated 2% of the largest logit, so
    # a row is decided where its top two logits are further apart than twice that
    top2 = np.sort(ref, axis=-1)[:, -2:]
    margin = 0.04 * np.abs(ref).max() if bf16 else 0.0
    decided = (top2[:, 1] - top2[:, 0]) > margin
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(out.argmax(-1)[decided], ref.argmax(-1)[decided])
