"""The port's wide-and-deep (``tensorflowonspark_torch/models/wide_deep.py``)
and its optax Adagrad (``tensorflowonspark_torch/optim.py``) against the
JAX package's on the CPU at a narrow width (vocab 1009, embed 4, hidden
(8, 4)): the same JAX-initialised weights, moved through ``convert.py``,
and the same seeded inputs through both.

Tolerances: float32 on both sides agrees to float32 rounding summed in other
orders: logits at rtol 1e-5 / atol 1e-6 (of order 0.1), parameters after
each Adagrad step at rtol 1e-5 / atol 1e-7 (an update is lr times a ratio
near ±1, so the parameters move by 1e-2 and keep six digits), gradients at
rtol 1e-5 / atol 1e-8 (of order 1e-3, the row gradients 1e-4).  bfloat16
compute rounds at different places on each side (torch adds the bias
inside the matmul's single rounding, XLA after it) and is held to 2% of the
largest logit.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_torch import checkpoint as tckpt
from tensorflowonspark_torch import convert
from tensorflowonspark_torch import optim as toptim
from tensorflowonspark_torch.models import registry as treg
from tensorflowonspark_torch.models import wide_deep as twd
from tensorflowonspark_torch.parallel import dp as tdp
from tensorflowonspark_tpu import checkpoint as jckpt
from tensorflowonspark_tpu.models import registry as jreg
from tensorflowonspark_tpu.models import wide_deep as jwd
from tensorflowonspark_tpu.parallel import dp as jdp
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

SMALL = {"model": "wide_deep", "vocab_size": 1009, "embed_dim": 4,
         "hidden": [8, 4], "bf16": False}
DENSE = {**SMALL, "model": "wide_deep_dense"}
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(rtol=1e-5, atol=1e-8)


def _jax_params(config, seed=0):
    if config["model"] == "wide_deep":
        model = jwd.build_wide_deep(config)
        return model, jax.device_get(jwd.init_params(model, jax.random.PRNGKey(seed)))
    model = jwd.build_wide_deep_dense(config)
    return model, jax.device_get(jwd.init_dense_params(model, jax.random.PRNGKey(seed)))


def _batch(n=16, seed=0):
    return jwd.batch_to_arrays(jwd.synthetic_criteo(n, seed=seed))


def _torch_model(config, params):
    model = treg.build(config)
    model.load_state_dict(convert.flax_to_torch(params, config), strict=True)
    return model


def _rows(n=16, dim=5, seed=0):
    return np.random.RandomState(seed).normal(0, 0.1, (n, 26, dim)).astype(np.float32)


def test_f32_forward_matches_jax():
    model, params = _jax_params(SMALL)
    x = _batch()["features"]
    ref = np.asarray(model.apply({"params": params}, x))
    out = treg.build_apply(SMALL, device="cpu")(params, x)
    assert out.shape == (16,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **LOGIT_TOL)


def test_dense_f32_forward_matches_jax():
    model, params = _jax_params(DENSE)
    x, rows = _batch()["features"], _rows()
    ref = np.asarray(model.apply({"params": params}, x, rows))
    out = _torch_model(DENSE, params)(torch.from_numpy(x), torch.from_numpy(rows))
    np.testing.assert_allclose(out.detach().numpy(), ref, **LOGIT_TOL)


@pytest.mark.parametrize("config", [SMALL, DENSE], ids=["wide_deep", "dense"])
def test_bf16_forward_close_to_jax(config):
    config = {**config, "bf16": True}
    model, params = _jax_params(config)
    x, rows = _batch()["features"], _rows()
    args = (x,) if config["model"] == "wide_deep" else (x, rows)
    ref = np.asarray(model.apply({"params": params}, *args))
    tmodel = _torch_model(config, params)
    with torch.no_grad():
        out = tmodel(*[torch.from_numpy(a) for a in args])
    assert out.dtype == torch.float32                    # the head is float32
    assert np.abs(out.numpy() - ref).max() <= 0.02 * np.abs(ref).max()


def test_ids_negative_beyond_vocab_and_int32_saturation():
    """Negative ids take the floor mod (-1 -> vocab - 1), ids >= vocab wrap,
    and ids at or beyond 2^31 (real Criteo hex categories reach 2^32)
    saturate to the int32 limit before the mod, as XLA's cast does on the
    CPU; NaN casts to 0.  The logits then agree too, through the tables."""
    _, params = _jax_params(SMALL)
    x = _batch(12)["features"].copy()
    odd = np.array([-1.0, -5.7, 1009.0, 2017.5, 2**31, 2**32, 4e9, -3e9,
                    1e20, np.nan, np.inf, 2147483520.0], np.float32)
    x[:, 13] = odd
    x[:, 20] = odd[::-1]
    cat = np.asarray(jnp.mod(jnp.asarray(x[:, 13:]).astype(jnp.int32), 1009))
    assert cat[:, 0].tolist() == [1008, 1004, 0, 1008, 695, 695, 695, 313,
                                  695, 0, 695, 568]
    ids = twd._flat_ids(torch.from_numpy(x), 1009)
    expect = cat + np.arange(26) * 1009
    np.testing.assert_array_equal(ids.numpy(), expect)
    # the sharded tier's numpy ids cast to int64, as the JAX package's do:
    # the two schemes agree below 2^31 only (column 7 holds the reversed
    # list, so rows 0-3 are below 2^31 in every other column)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # numpy's NaN/inf cast
        np_ids = twd.flat_categorical_ids(x, 1009)
        np.testing.assert_array_equal(np_ids, jwd.flat_categorical_ids(x, 1009))
    small = [c for c in range(26) if c != 7]
    np.testing.assert_array_equal(np_ids[:4, small], expect[:4, small])
    assert np_ids[4, 0] == 2**31 % 1009 != expect[4, 0]  # 696 against 695
    # the JAX package's own paths are jitted (build_apply, the train step),
    # so the cast is XLA's; an eager apply on a numpy batch would take
    # numpy's cast instead (INT_MIN out of range on x86)
    ref = np.asarray(jreg.build_apply(SMALL)(params, x))
    out = treg.build_apply(SMALL, device="cpu")(params, x)
    np.testing.assert_allclose(out.numpy(), ref, **LOGIT_TOL)


def test_adagrad_trajectory_matches_optax():
    """5 steps of ``make_train_step`` with the port's ``optim.Adagrad``
    against the JAX step with ``optax.adagrad(0.01)``, the parameters (the
    tables too, whose gradient is dense) compared after every step."""
    jmodel, params = _jax_params(SMALL)
    jopt = optax.adagrad(0.01)
    jstate = jdp.TrainState.create(params, jopt)
    jstep = jdp.make_train_step(jwd.make_loss_fn(jmodel), jopt, donate=False)

    model = _torch_model(SMALL, params)
    opt = toptim.Adagrad(model.parameters(), lr=0.01)
    state = tdp.TrainState.create(model, opt)
    step = tdp.make_train_step(twd.make_loss_fn(model), opt)
    for i in range(5):
        batch = _batch(16, seed=i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        got = convert.torch_to_flax(model.state_dict(), config=SMALL)
        want = jax.device_get(jstate.params)
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            key = "/".join(p.key for p in path)
            node = got
            for p in path:
                node = node[p.key]
            np.testing.assert_allclose(node, leaf, err_msg=key, **PARAM_TOL)
    assert state.step == 5


def test_adagrad_is_not_torch_adagrad():
    """The three differences the module docstring names, on one step."""
    p = torch.nn.Parameter(torch.tensor([1.0, 2.0, 3.0]))
    opt = toptim.Adagrad([p], lr=1.0)
    p.grad = torch.tensor([2.0, 0.0, -1.0])
    opt.step()
    g = np.array([2.0, 0.0, -1.0], np.float32)
    want = np.array([1.0, 2.0, 3.0], np.float32) - g / np.sqrt(g * g + 0.1 + 1e-7)
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6)
    # a zero accumulator gives a zero update, not a division by eps
    q = torch.nn.Parameter(torch.tensor([1.0]))
    opt0 = toptim.Adagrad([q], lr=1.0, initial_accumulator_value=0.0)
    q.grad = torch.tensor([0.0])
    opt0.step()
    assert q.item() == 1.0
    assert set(opt.state_dict()["state"][0]) == {"sum_of_squares"}


def test_sharded_grad_fn_matches_jax():
    jmodel, params = _jax_params(DENSE)
    batch, rows = _batch(), _rows()
    (jloss, jaux), (jdg, jrg) = jwd.make_sharded_grad_fn(jmodel)(params, rows, batch)
    model = _torch_model(DENSE, params)
    (loss, aux), (dg, rg) = twd.make_sharded_grad_fn(model)(model, rows, batch)
    assert all(p.grad is None for p in model.parameters())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    assert aux["accuracy"].item() == float(jaux["accuracy"])
    assert rg.shape == (16, 26, 5) and rg.dtype == torch.float32
    np.testing.assert_allclose(rg.numpy(), np.asarray(jrg), **GRAD_TOL)
    got = convert.torch_to_flax(dg, config=DENSE)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax.device_get(jdg)):
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, leaf, **GRAD_TOL)


@pytest.mark.parametrize("config", [SMALL, DENSE], ids=["wide_deep", "dense"])
def test_convert_round_trip_is_exact(config):
    _, params = _jax_params(config)
    back = convert.torch_to_flax(convert.flax_to_torch(params, config), config=config)
    flat_a = jckpt._flatten_tree(params)
    flat_b = jckpt._flatten_tree(back)
    assert sorted(flat_a) == sorted(flat_b)
    for k in flat_a:
        np.testing.assert_array_equal(flat_b[k], flat_a[k], err_msg=k)


def test_port_bundle_scores_the_same_in_jax(tmp_path):
    """A bundle the port exports after training loads in the JAX
    ``build_apply`` and scores as the port does."""
    _, params = _jax_params(SMALL)
    model = _torch_model(SMALL, params)
    opt = toptim.Adagrad(model.parameters(), lr=0.01)
    step = tdp.make_train_step(twd.make_loss_fn(model), opt)
    state = tdp.TrainState.create(model, opt)
    for i in range(2):
        state, _ = step(state, _batch(16, seed=i))
    export = str(tmp_path / "bundle")
    tckpt.export_bundle(export, convert.torch_to_flax(model.state_dict(), config=SMALL),
                        SMALL)
    jparams, jconfig = jckpt.load_bundle(export)
    x = _batch(8, seed=9)["features"]
    ref = np.asarray(jreg.build_apply(jconfig)(jparams, x))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **LOGIT_TOL)


def test_default_config_param_count_matches_jax():
    """At the published width (vocab 100_003, embed 16, hidden (256, 128,
    64)) the port has the JAX init's parameters, counted from shapes alone
    (``jax.eval_shape`` and the meta device allocate nothing)."""
    config = {"model": "wide_deep"}
    jmodel = jwd.build_wide_deep(config)
    shapes = jax.eval_shape(lambda key: jwd.init_params(jmodel, key),
                            jax.random.PRNGKey(0))
    jcount = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        model = treg.build(config)
    assert sum(p.numel() for p in model.parameters()) == jcount
    assert model.embeddings.shape == (2_600_078, 16)
    assert model.vocab_size == 100_003


def test_registry_and_numpy_helpers():
    assert twd.table_total_rows(DENSE) == 26 * 1009
    rows = twd.synthetic_criteo(5, seed=3)
    jrows = jwd.synthetic_criteo(5, seed=3)
    for a, b in zip(rows, jrows):
        np.testing.assert_array_equal(a["features"], b["features"])
        assert a["label"] == b["label"]
    b1, b2 = twd.batch_to_arrays(rows), jwd.batch_to_arrays(jrows)
    np.testing.assert_array_equal(b1["features"], b2["features"])
    np.testing.assert_array_equal(b1["label"], b2["label"])
    model = treg.build({"model": "wide_deep_dense", "vocab_size": 97, "embed_dim": 4})
    assert isinstance(model, twd.WideDeepDense)
    assert model.vocab_size == 97 and model.embed_dim == 4


def test_torch_init_draws_flax_initialisers():
    model = twd.build_wide_deep({**SMALL, "vocab_size": 4001})
    twd.init_params(model, torch.Generator().manual_seed(0))
    assert torch.count_nonzero(model.wide_weights) == 0
    assert abs(model.embeddings.std().item() - 0.01) < 5e-4
    assert torch.count_nonzero(model.Dense_0.bias) == 0
    w = model.Dense_0.weight                             # lecun_normal, fan_in 117
    assert abs(w.std().item() - 117 ** -0.5) < 0.2 * 117 ** -0.5
