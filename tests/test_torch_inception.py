"""The port's Inception-v3 (``tensorflowonspark_torch/models/inception.py``)
against the JAX package's on the CPU at the smallest legal input (75 px,
``tests/test_inception.py``), 10 classes, the same seeded variables moved
through ``convert.py``.

Tolerances: float32 on both sides agrees to float32 rounding summed in other
orders over 94 convs (rtol 1e-4, atol 1e-5 on logits of order 0.1-1);
bfloat16 convs round at different places on each side and are held to 5%
of the largest logit; the train-mode forward's docstring states its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tensorflowonspark_torch import convert
from tensorflowonspark_torch.models import inception as tinc
from tensorflowonspark_torch.models import registry as treg
from tensorflowonspark_tpu.models import inception as jinc
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

from tests.torch_image_refs import images, random_variables

F32 = {"model": "inception_v3", "num_classes": 10, "bf16": False}
TOL = dict(rtol=1e-4, atol=1e-5)


def _jax(config):
    model = jinc.build_inception_v3(config)
    return model, random_variables(model, (75, 75, 3), train=True)


def test_f32_eval_logits_match_jax():
    model, variables = _jax(F32)
    x = images(2, 75)
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x))
    out = treg.build_apply(F32, device="cpu")(variables, x)
    assert out.shape == (2, 10) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_bf16_eval_logits_close_to_jax():
    config = {**F32, "bf16": True}
    model, variables = _jax(config)
    x = images(2, 75)
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x))
    out = treg.build_apply(config, device="cpu")(variables, x).numpy()
    assert np.abs(out - ref).max() <= 0.05 * np.abs(ref).max()


def test_train_mode_forward_moves_stats_as_flax():
    """Train mode: the batch statistics normalise, and every running mean and
    (biased) variance moves with momentum 0.9997, eps 1e-3 (rtol 1e-5, and
    atol 1e-6: 0.0003 of batch statistics that carry the drift below).

    The logits are held to 2% of the largest: from InceptionB on, each
    channel's batch statistics at 75 px come from 4-36 values, and dividing
    by their spread amplifies float32 rounding block by block (the two sides
    part by 4e-5 after the stem and by 0.3% of the largest logit at the
    head).  Each BN's own arithmetic is held to float32 rounding in
    ``tests/test_torch_resnet.py::test_batchnorm_train_matches_flax``."""
    model, variables = _jax(F32)
    x = images(4, 75, seed=1)
    ref, mutated = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    port = tinc.build_inception_v3(F32)
    port.load_state_dict(convert.flax_to_torch(variables, F32), strict=True)
    with torch.no_grad():
        out = port.train()(torch.from_numpy(x)).numpy()
    assert np.abs(out - np.asarray(ref)).max() <= 0.02 * np.abs(ref).max()
    got = convert.torch_to_flax(port.state_dict(), config=F32)["batch_stats"]
    flat = jax.tree_util.tree_flatten_with_path(mutated["batch_stats"])[0]
    assert len(flat) == 2 * 94
    for path, want in flat:
        leaf = got
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf, np.asarray(want), rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_registry_builds_it_with_the_jax_variables():
    """``{"model": "inception_v3"}`` builds through the registry, and at 1000
    classes every JAX variable has a port tensor of its shape under the
    converter's name (shapes from ``jax.eval_shape``)."""
    assert treg.build({"model": "inception_v3", "num_classes": 7}).num_classes == 7
    shapes = jax.eval_shape(
        lambda r: jinc.InceptionV3().init(r, jnp.zeros((1, 75, 75, 3)), train=True),
        jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    state = convert.flax_to_torch(zeros, {"model": "inception_v3"})
    with torch.device("meta"):
        model = treg.build({"model": "inception_v3"})
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert model.head.weight.shape == (1000, 2048)
