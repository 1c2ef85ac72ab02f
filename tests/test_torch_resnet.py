"""The port's ResNet family (``tensorflowonspark_torch/models/resnet.py``), its
flax-semantics layers (``models/layers.py``) and the BN train step against
the JAX package on the CPU, weights moved through ``convert.py``.

Tolerances: where both sides compute in float32, outputs agree to float32
rounding summed in other orders (rtol 1e-4, atol 1e-5 over a dozen convs
and the BN statistics); a bfloat16 BN output is held to one bfloat16 step
(2^-7 relative); the train-step trajectory is compared in float64 (its
docstring says why).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_torch import checkpoint as tckpt
from tensorflowonspark_torch import convert
from tensorflowonspark_torch.models import layers
from tensorflowonspark_torch.models import registry as treg
from tensorflowonspark_torch.models import resnet as tres
from tensorflowonspark_torch.parallel import dp as tdp
from tensorflowonspark_tpu import checkpoint as jckpt
from tensorflowonspark_tpu.models import registry as jreg
from tensorflowonspark_tpu.models import resnet as jres
from tensorflowonspark_tpu.parallel import dp as jdp
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

from tests.torch_image_refs import images, random_variables

F32_TOL = dict(rtol=1e-4, atol=1e-5)
CIFAR = {"model": "resnet_cifar", "depth_blocks": 1, "width": 8, "bf16": False}


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


# -- flax SAME padding --------------------------------------------------------


@pytest.mark.parametrize("size", [7, 8, 15, 16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("window", [3, 4, 7])
def test_same_conv_matches_flax(size, stride, window):
    """A ``SAME`` conv over an H x (H+1) input: the helper's (low, high)
    pads put every window where flax's does, odd and even sides."""
    x = images(2, size, 2, seed=size)[:, :, :size - 1 + (size % 2), :]
    conv = fnn.Conv(3, (window, window), strides=(stride, stride), padding="SAME",
                    use_bias=False)
    params = conv.init(jax.random.PRNGKey(window), x)
    ref = np.asarray(conv.apply(params, x))
    port = layers.Conv(2, 3, (window, window), (stride, stride), use_bias=False)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(
            np.array(params["params"]["kernel"]).transpose(3, 2, 0, 1)))
        out = port(_nchw(x))
    assert out.shape == (2, 3, *ref.shape[1:3])
    np.testing.assert_allclose(_nhwc(out), ref, **F32_TOL)


@pytest.mark.parametrize("size", [7, 8, 112])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("window", [2, 3])
def test_same_max_pool_matches_flax(size, stride, window):
    """``SAME`` max pool pads with -inf (an all-negative input shows a zero
    pad); 112 is ResNet-50's stem pool at 224 px, pads (0, 1)."""
    x = images(2, size, 3, seed=size) - 2.0
    ref = np.asarray(fnn.max_pool(x, (window, window), strides=(stride, stride),
                                  padding="SAME"))
    out = layers.max_pool(_nchw(x), (window, window), (stride, stride), "SAME")
    np.testing.assert_array_equal(_nhwc(out), ref)


@pytest.mark.parametrize("size", [7, 8])
def test_same_avg_pool_counts_pad_cells(size):
    x = images(2, size, 3, seed=size)
    ref = np.asarray(fnn.avg_pool(x, (3, 3), strides=(1, 1), padding="SAME"))
    out = layers.avg_pool(_nchw(x), (3, 3), (1, 1), "SAME")
    np.testing.assert_allclose(_nhwc(out), ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("size,window,stride,pads", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (112, 3, 2, (0, 1)),
    (56, 1, 2, (0, 0)), (17, 7, 1, (3, 3)), (32, 4, 1, (1, 2))])
def test_same_pads_of_the_models(size, window, stride, pads):
    """The pads the ResNet-50 and Inception-v3 layers get: the 7x7/2 stem
    (2, 3), the 3x3/2 convs and pool (0, 1), the 1x1/2 shortcut 0, the
    stride-1 1x7/7x1 symmetric, space_to_depth's 4x4/1 (1, 2)."""
    assert layers.same_pads(size, window, stride) == pads


# -- flax BatchNorm -----------------------------------------------------------


@pytest.mark.parametrize("momentum,epsilon,in_dtype,dtype", [
    (0.9, 1e-5, "float32", "float32"),      # ResNet f32
    (0.9, 1e-5, "bfloat16", "bfloat16"),    # ResNet bf16: bf16 in and out
    (0.9997, 1e-3, "bfloat16", "float32"),  # Inception: bf16 conv, f32 BN
])
def test_batchnorm_train_matches_flax(momentum, epsilon, in_dtype, dtype):
    """Train mode: output, and running mean / biased running variance moved
    with flax's momentum, statistics in float32 whatever the input type."""
    rng = np.random.RandomState(0)
    x = (2.0 * rng.randn(4, 5, 6, 3) + 1.0).astype(np.float32)
    scale, bias = 1 + 0.1 * rng.randn(3), 0.1 * rng.randn(3)
    mean0, var0 = 0.1 * rng.randn(3), 0.5 + rng.rand(3)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    variables = {"params": {"scale": f32(scale), "bias": f32(bias)},
                 "batch_stats": {"mean": f32(mean0), "var": f32(var0)}}
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum, epsilon=epsilon,
                       dtype=getattr(jnp, dtype))
    ref, mutated = bn.apply(variables, jnp.asarray(x, getattr(jnp, in_dtype)),
                            mutable=["batch_stats"])
    port = layers.BatchNorm(3, momentum, epsilon, dtype=getattr(torch, dtype))
    state = convert.flax_to_torch(
        {"params": {"m": variables["params"]}, "batch_stats": {"m": variables["batch_stats"]}},
        {"model": "resnet_cifar"})
    port.load_state_dict({k.removeprefix("m."): v for k, v in state.items()}, strict=True)
    out = port.train()(_nchw(x).to(getattr(torch, in_dtype)))
    assert out.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else dict(rtol=2.0 ** -7, atol=2.0 ** -7)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref, np.float32), **tol)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(), stats["mean"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(), stats["var"], rtol=1e-6, atol=1e-7)


# -- ResNet forward, eval mode -------------------------------------------------


@pytest.mark.parametrize("config,size", [
    (CIFAR, 32),
    ({"model": "resnet50", "width": 8, "num_classes": 10, "bf16": False}, 64),
    ({"model": "resnet50", "width": 8, "num_classes": 10, "bf16": False,
      "stem": "space_to_depth"}, 64),
], ids=["resnet_cifar", "resnet50_64px", "space_to_depth"])
def test_eval_logits_match_jax(config, size):
    """Eval mode with non-trivial ``batch_stats``: the cifar stem; the
    ResNet-50 topology at width 8 and 64 px (the 7x7/2 stem's (2, 3) pad,
    the -inf pool pad, the stride-2 3x3 and shortcut convs); and the
    space_to_depth stem."""
    model = jreg.build(config)
    variables = random_variables(model, (size, size, 3), train=True)
    x = images(2, size)
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x))
    out = treg.build_apply(config, device="cpu")(variables, x)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)


def test_bf16_logits_close_to_jax():
    """bf16 compute and bf16 BN output (ResNet's default): both sides round
    at different places over 4 blocks; held to 5% of the largest logit."""
    config = {**CIFAR, "bf16": True}
    model = jreg.build(config)
    variables = random_variables(model, (32, 32, 3), train=True)
    x = images(2, 32)
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x))
    out = treg.build_apply(config, device="cpu")(variables, x).numpy()
    assert np.abs(out - ref).max() <= 0.05 * np.abs(ref).max()


# -- the BN train step ---------------------------------------------------------


def test_bn_train_step_trajectory_matches_jax():
    """3 ``make_bn_train_step`` steps of ``resnet_cifar`` (one block per
    stage, width 8, 32 px) against the JAX step with ``optax.sgd(0.1,
    momentum=0.9, nesterov=True)`` and L2 1e-4: loss, params and
    ``batch_stats`` after each step.

    Both sides run the convs and BatchNorm in float64.  In float32 the JAX
    reference's own gradients stray 0.4-1% (relative L2) from float64
    ones at these statistics, where the port's stay within 1e-5: flax takes
    the batch variance as E[x²] - E[x]², which cancels.  float64 leaves the
    arithmetic under test, and both still compute the head and the softmax
    in float32 (flax's ``dtype=jnp.float32``), which rounds every gradient
    at float32's 2^-24 of the logits' scale: they agree to rtol 1e-5, atol
    1e-8."""
    stages = dict(stage_sizes=(1, 1, 1), num_classes=10, width=8, stem="cifar")
    jmodel = jres.ResNet(**stages, compute_dtype=jnp.float64, norm_dtype=jnp.float64)
    variables = jax.tree.map(lambda a: a.astype(np.float64),
                             random_variables(jmodel, (32, 32, 3), train=True))
    batch = {"image": images(8, 32, seed=3).astype(np.float64),
             "label": np.arange(8, dtype=np.int32) % 10}

    model = tres.ResNet(**stages, compute_dtype=torch.float64,
                        norm_dtype=torch.float64).double()
    model.load_state_dict(convert.flax_to_torch(variables, CIFAR), strict=True)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, nesterov=True)
    state = tdp.BNTrainState.create(model, opt)
    step = tdp.make_bn_train_step(tres.make_loss_fn(model, weight_decay=1e-4), opt)
    with jax.enable_x64(True):
        jopt = optax.sgd(0.1, momentum=0.9, nesterov=True)
        jstate = jdp.BNTrainState.create(variables["params"], variables["batch_stats"], jopt)
        jstep = jdp.make_bn_train_step(jres.make_loss_fn(jmodel, weight_decay=1e-4), jopt,
                                       donate=False)
        for i in range(3):
            jstate, jm = jstep(jstate, batch)
            state, m = step(state, batch)
            assert state.step == i + 1 and model.training
            np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-6)
            got = convert.torch_to_flax(model.state_dict(), config=CIFAR)
            want = {"params": jstate.params, "batch_stats": jstate.batch_stats}
            flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
            flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
            assert len(flat_got) == len(flat_want)
            for path, leaf in flat_got:
                np.testing.assert_allclose(
                    leaf, np.asarray(flat_want[path]), rtol=1e-5, atol=1e-8,
                    err_msg=f"step {i + 1} {jax.tree_util.keystr(path)}")


def test_bn_train_state_round_trips_running_stats(tmp_path):
    """``BNTrainState.tree()`` carries the running statistics (module
    buffers) and the momentum through ``checkpoint.py``."""
    model = tres.build_resnet_cifar(CIFAR).init_weights(torch.Generator().manual_seed(0))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, nesterov=True)
    state = tdp.BNTrainState.create(model, opt)
    step = tdp.make_bn_train_step(tres.make_loss_fn(model), opt)
    batch = {"image": images(4, 32), "label": np.arange(4, dtype=np.int32)}
    state, _ = step(state, batch)
    tckpt.save_checkpoint(str(tmp_path / "step_1"), state.tree())
    fresh = tres.build_resnet_cifar(CIFAR)
    fopt = torch.optim.SGD(fresh.parameters(), lr=0.1, momentum=0.9, nesterov=True)
    restored = tdp.BNTrainState.create(fresh, fopt).restore(
        tckpt.restore_checkpoint(str(tmp_path / "step_1")))
    assert restored.step == 1
    want = model.state_dict()
    assert any(k.endswith("running_var") for k in want)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    state, m1 = step(state, batch)
    restored, m2 = tdp.make_bn_train_step(tres.make_loss_fn(fresh), fopt)(restored, batch)
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=0, atol=0)


# -- the model's construction ---------------------------------------------------


def test_resnet50_parameter_count_matches_jax():
    """ResNet-50 at 1000 classes: every JAX variable has a port tensor of
    the same size under the converter's name (shapes from
    ``jax.eval_shape``, which compiles nothing)."""
    jmodel = jres.build_resnet50({"num_classes": 1000})
    shapes = jax.eval_shape(
        lambda r: jmodel.init(r, jnp.zeros((1, 64, 64, 3)), train=True), jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
    with torch.device("meta"):
        model = tres.build_resnet50({"num_classes": 1000})
    assert sum(p.numel() for p in model.parameters()) == n_jax == 25_557_032
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    state = convert.flax_to_torch(zeros, {"model": "resnet50"})
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_init_is_flax_init():
    """``init_weights``: lecun_normal kernels (std 1/sqrt(fan_in), cut at
    2 std), zero biases, BN scales 1 except each block's last, which is 0."""
    model = tres.build_resnet50({"num_classes": 1000}).init_weights(
        torch.Generator().manual_seed(0))
    w = model.BottleneckBlock_13.Conv_1.weight                  # [512, 512, 3, 3]
    std = (512 * 9) ** -0.5
    assert abs(w.std().item() / std - 1) < 0.01
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978
    assert torch.count_nonzero(model.head.bias) == 0
    for i in range(model.n_blocks):
        block = getattr(model, f"BottleneckBlock_{i}")
        assert torch.count_nonzero(block.BatchNorm_2.weight) == 0
        assert torch.all(block.BatchNorm_0.weight == 1)
    assert model.BottleneckBlock_0.project and not model.BottleneckBlock_1.project
    assert model.conv_init.weight.is_contiguous(memory_format=torch.channels_last)


def test_l2_only_on_kernels():
    """``make_loss_fn`` adds ``wd/2 · Σ p²`` over the parameters with ndim > 1
    only: BN scales and biases get no decay."""
    model = tres.build_resnet_cifar(CIFAR).init_weights(torch.Generator().manual_seed(0))
    batch = {"image": torch.from_numpy(images(4, 32)),
             "label": torch.arange(4, dtype=torch.int32)}
    grads = {}
    losses = {}
    for wd in (0.0, 0.5):
        model.zero_grad()
        loss, _ = tres.make_loss_fn(model, weight_decay=wd)(model.eval(), batch)
        loss.backward()
        losses[wd] = loss.item()
        grads[wd] = {n: p.grad.clone() for n, p in model.named_parameters()}
    l2 = sum(p.square().sum().item() for p in model.parameters() if p.ndim > 1)
    assert losses[0.5] - losses[0.0] == pytest.approx(0.25 * l2, rel=1e-5)
    for n, p in model.named_parameters():
        delta = grads[0.5][n] - grads[0.0][n]
        want = 0.5 * p.detach() if p.ndim > 1 else torch.zeros_like(p)
        torch.testing.assert_close(delta, want, rtol=1e-4, atol=1e-6)


# -- bundles --------------------------------------------------------------------


def test_port_bn_bundle_loads_in_jax(tmp_path):
    """A trained port ``resnet_cifar`` exported through ``torch_to_flax``
    (``{"params", "batch_stats"}``) gives the JAX ``build_apply`` the same
    logits and argmax as the port's."""
    model = tres.build_resnet_cifar(CIFAR).init_weights(torch.Generator().manual_seed(1))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    step = tdp.make_bn_train_step(tres.make_loss_fn(model), opt)
    batch = {"image": images(8, 32, seed=5), "label": np.arange(8, dtype=np.int32) % 10}
    state = tdp.BNTrainState.create(model, opt)
    for _ in range(2):
        state, _ = step(state, batch)
    variables = convert.torch_to_flax(model.state_dict(), config=CIFAR)
    assert set(variables) == {"params", "batch_stats"}
    tckpt.export_bundle(str(tmp_path / "b"), variables, CIFAR)
    jvars, jcfg = jckpt.load_bundle(str(tmp_path / "b"))
    x = images(6, 32, seed=7)
    ref = np.asarray(jreg.build_apply(jcfg)(jvars, x))
    pvars, pcfg = tckpt.load_bundle(str(tmp_path / "b"))
    out = treg.build_apply(pcfg, device="cpu")(pvars, x).numpy()
    np.testing.assert_allclose(out, ref, **F32_TOL)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
    back = convert.flax_to_torch(variables, CIFAR)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
