"""LM training on the port against the JAX package: the loss and every
parameter's gradient (``make_loss_fn``: dense, ``vocab_chunk``,
``loss_mask``), remat, gradient accumulation, the ``cross_host_grad_fn``
hook, five-step AdamW and SGD trajectories against optax, flax's
initialisers, ``make_batch_iterator``, the train→serve bundle and
``examples_torch/llm/train_lm.py``.  f32 throughout; tolerances beside each
check."""

import importlib.util
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_torch import convert
from tensorflowonspark_torch.checkpoint import export_bundle, load_bundle
from tensorflowonspark_torch.feeding import DataFeed, FeedQueues, IteratorFeed
from tensorflowonspark_torch.marker import EndOfFeed, EndPartition
from tensorflowonspark_torch.models import registry as treg
from tensorflowonspark_torch.models import transformer as ttfm
from tensorflowonspark_torch.parallel import dp as tdp
from tensorflowonspark_tpu.models import transformer as jtfm
from tensorflowonspark_tpu.parallel import dp as jdp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {"model": "transformer", "vocab_size": 37, "d_model": 16, "n_layers": 2,
       "n_heads": 2, "bf16": False, "attn_impl": "pallas_interpret"}
B, S = 4, 12
# f32 on both sides; sums run in other orders (and the JAX side's attention
# backward in blocks of 16 against the port's 512)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _ids(seed=1):
    return np.random.RandomState(seed).randint(0, 37, (B, S)).astype(np.int32)


def _setup(cfg=CFG, seed=0):
    jmodel = jtfm.build_transformer(cfg)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(seed), _ids())["params"])
    tmodel = ttfm.build_transformer(cfg)
    tmodel.load_state_dict(convert.flax_to_torch(params), strict=True)
    return jmodel, params, tmodel


def _tree_close(port_tree, jax_tree, **tol):
    flat_j = jax.tree_util.tree_leaves_with_path(jax_tree)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(port_tree))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_allclose(flat_t[path], np.asarray(leaf), err_msg=str(path),
                                   **tol)


def _grads(model):
    return convert.torch_to_flax({n: p.grad for n, p in model.named_parameters()},
                                 n_heads=CFG["n_heads"])


def _params(model):
    return convert.torch_to_flax(model.state_dict(), n_heads=CFG["n_heads"])


def _batch(masked: bool):
    batch = {"input_ids": _ids()}
    if masked:
        mask = np.ones((B, S), np.float32)
        mask[1, 5:] = 0.0
        mask[3, 2:] = 0.0
        batch["loss_mask"] = mask
    return batch


@pytest.mark.parametrize("vocab_chunk", [0, 16])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_jax(vocab_chunk, masked):
    jmodel, params, tmodel = _setup()
    batch = _batch(masked)
    jloss_fn = jtfm.make_loss_fn(jmodel, vocab_chunk=vocab_chunk)
    (jtotal, jmetrics), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    total, metrics = ttfm.make_loss_fn(tmodel, vocab_chunk=vocab_chunk)(tmodel, batch)
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtotal), **LOSS_TOL)
    for key in ("lm_loss", "aux_loss", "router_z_loss"):
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]),
                                   **LOSS_TOL)
    _tree_close(_grads(tmodel), jgrads, **GRAD_TOL)


def test_remat_gives_the_same_loss_and_grads():
    _, params, plain = _setup()
    remat = ttfm.build_transformer({**CFG, "remat": True})
    assert remat.remat
    remat.load_state_dict(plain.state_dict())
    out = []
    for model in (plain, remat):
        loss, _ = ttfm.make_loss_fn(model)(model, _batch(True))
        loss.backward()
        out.append((loss.item(), _grads(model)))
    # the recompute runs the same operations on the same inputs
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    _tree_close(out[1][1], out[0][1], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_five_step_trajectory_matches_optax(opt):
    lr = 1e-2
    jmodel, params, tmodel = _setup()
    jopt = optax.adamw(lr) if opt == "adamw" else optax.sgd(lr)
    jstate = jdp.TrainState.create(params, jopt)
    jstep = jdp.make_train_step(jtfm.make_loss_fn(jmodel), jopt, donate=False)
    topt = (tdp.adamw(tmodel.parameters(), lr) if opt == "adamw"
            else torch.optim.SGD(tmodel.parameters(), lr=lr))
    tstate = tdp.TrainState.create(tmodel, topt)
    tstep = tdp.make_train_step(ttfm.make_loss_fn(tmodel), topt)
    for i in range(5):
        batch = {"input_ids": _ids(seed=10 + i)}
        jstate, jm = jstep(jstate, {"input_ids": jnp.asarray(batch["input_ids"])})
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    assert tstate.step == 5 and int(jstate.step) == 5
    # five f32 updates of size ~lr: rounding differences stay ~1e-6
    _tree_close(_params(tmodel), jstate.params, rtol=1e-4, atol=1e-5)


def test_accum_steps_equals_full_batch_under_sgd():
    _, _, full = _setup()
    _, _, accum = _setup()
    batch = {"input_ids": _ids()}  # no mask: each microbatch mean weighs alike
    states = []
    for model, steps in ((full, 1), (accum, 4)):
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        step = tdp.make_train_step(ttfm.make_loss_fn(model), opt, accum_steps=steps)
        state, metrics = step(tdp.TrainState.create(model, opt), batch)
        states.append((metrics["loss"].item(), _params(model)))
    assert states[1][0] == pytest.approx(states[0][0], rel=1e-5)
    _tree_close(states[1][1], states[0][1], rtol=1e-5, atol=1e-7)
    opt = torch.optim.SGD(accum.parameters(), lr=0.1)
    step = tdp.make_train_step(ttfm.make_loss_fn(accum), opt, accum_steps=3)
    with pytest.raises(ValueError, match="accum_steps=3"):
        step(tdp.TrainState.create(accum, opt), batch)


def test_cross_host_grad_fn_runs_between_backward_and_update():
    _, _, model = _setup()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    seen = {}

    def hook(grads):
        seen.update({n: g.clone() for n, g in grads.items()})
        # params are untouched when the hook runs: the update comes after
        for n, p in model.named_parameters():
            assert torch.equal(p, before[n])
        return {n: 2 * g for n, g in grads.items()}

    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = tdp.make_train_step(ttfm.make_loss_fn(model), opt, cross_host_grad_fn=hook)
    step(tdp.TrainState.create(model, opt), {"input_ids": _ids()})
    assert set(seen) == set(before)
    for n, p in model.named_parameters():  # the hook's gradients were applied
        torch.testing.assert_close(p.detach(), before[n] - 0.1 * 2 * seen[n])


def test_init_matches_flax_names_shapes_and_std():
    cfg = {"model": "transformer", "vocab_size": 512, "d_model": 64,
           "n_layers": 2, "n_heads": 4, "bf16": False}
    jparams = jtfm.build_transformer(cfg).init(
        jax.random.PRNGKey(0), np.zeros((1, 4), np.int32))["params"]
    model = ttfm.build_transformer(cfg).init_weights(torch.Generator().manual_seed(0))
    tparams = convert.torch_to_flax(model.state_dict(), n_heads=4)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tparams))
    assert sorted(map(str, flat_t)) == sorted(str(p) for p, _ in flat_j)
    for path, leaf in flat_j:
        leaf = np.asarray(leaf)
        assert flat_t[path].shape == leaf.shape and flat_t[path].dtype == np.float32
        if "scale" in str(path):
            assert (flat_t[path] == 1).all()
        else:  # 4096+ draws each: the std estimates sit within ~1.1% (1 sigma)
            assert np.std(flat_t[path]) == pytest.approx(np.std(leaf), rel=0.05), path
            assert np.abs(flat_t[path]).max() <= 2.0 * np.std(leaf) / 0.8796 * 1.05 \
                or "embed" in str(path)  # lecun_normal is truncated at 2 std


def test_trained_model_serves_through_a_bundle(tmp_path):
    _, _, model = _setup({**CFG, "attn_impl": "auto"})
    opt = tdp.adamw(model.parameters(), 1e-2)
    step = tdp.make_train_step(ttfm.make_loss_fn(model), opt)
    state = tdp.TrainState.create(model, opt)
    for _ in range(2):
        state, _ = step(state, {"input_ids": _ids()})
    cfg = {**CFG, "attn_impl": "auto"}
    export_bundle(str(tmp_path), _params(model), cfg)
    params, loaded_cfg = load_bundle(str(tmp_path))
    served = treg.build_apply(loaded_cfg, device="cpu")(params, _ids(7))
    with torch.inference_mode():
        ref = model.eval()(torch.from_numpy(_ids(7)))
    torch.testing.assert_close(served, ref, rtol=0, atol=0)


def test_adamw_is_optax_adamw():
    opt = tdp.adamw([torch.nn.Parameter(torch.zeros(3))], 3e-4)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == \
        (3e-4, (0.9, 0.999), 1e-8, 1e-4)


# -- make_batch_iterator: tests/test_parallel_dp.py:110-175 on the port ------

def feed_with(items, batch_markers=True):
    queues = FeedQueues()
    q = queues.get_queue("input")
    for it in items:
        q.put(it)
    if batch_markers:
        q.put(EndPartition())
    q.put(EndOfFeed())
    return DataFeed(queues)


def test_batch_iterator_pads_final_batch():
    feed = feed_with(list(range(10)))
    batches = list(tdp.make_batch_iterator(feed, 4, to_arrays=np.asarray))
    assert [(b.shape[0], n) for b, n in batches] == [(4, 4), (4, 4), (4, 2)]
    assert batches[-1][0].tolist() == [8, 9, 9, 9]  # padded with last sample


def test_batch_iterator_max_steps_caps_and_terminates_feed():
    feed = feed_with(list(range(100)))
    batches = list(tdp.make_batch_iterator(feed, 4, to_arrays=np.asarray,
                                           max_steps=3))
    assert len(batches) == 3 and all(n == 4 for _, n in batches)
    assert feed.should_stop()
    assert feed.queues.get("state") == "terminating"  # drained upstream
    got = list(tdp.make_batch_iterator(IteratorFeed(iter(range(50))), 5,
                                       to_arrays=np.asarray, max_steps=2))
    assert len(got) == 2
    got = list(tdp.make_batch_iterator(IteratorFeed(iter(range(6))), 4,
                                       to_arrays=np.asarray, max_steps=99))
    assert [n for _, n in got] == [4, 2]


def test_batch_iterator_prefetch_matches_sync():
    sync = list(tdp.make_batch_iterator(feed_with(list(range(23))), 4,
                                        to_arrays=np.asarray, prefetch=0))
    pre = list(tdp.make_batch_iterator(feed_with(list(range(23))), 4,
                                       to_arrays=np.asarray, prefetch=3))
    assert [n for _, n in sync] == [n for _, n in pre]
    for (a, _), (b, _) in zip(sync, pre):
        np.testing.assert_array_equal(a, b)


def test_batch_iterator_prefetch_propagates_errors():
    def bad_to_arrays(xs):
        raise ValueError("conversion exploded")

    it = tdp.make_batch_iterator(feed_with([1, 2, 3]), 2, to_arrays=bad_to_arrays)
    with pytest.raises(ValueError, match="conversion exploded"):
        list(it)


def test_batch_iterator_prefetch_abandoned_consumer_unblocks():
    before = threading.active_count()
    it = tdp.make_batch_iterator(feed_with(list(range(100))), 2,
                                 to_arrays=np.asarray, prefetch=1)
    next(it)
    it.close()  # GeneratorExit -> stop flag -> producer exits
    deadline = time.monotonic() + 10.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "prefetch thread leaked"


@pytest.mark.parametrize("kwargs,exc,match", [
    ({"mesh": object()}, NotImplementedError, "queue 1 \\(e\\)"),
    ({"lockstep": True}, ValueError, "requires ctx"),
])
def test_batch_iterator_refuses_what_it_cannot_do(kwargs, exc, match):
    with pytest.raises(exc, match=match):
        next(tdp.make_batch_iterator(feed_with([1, 2]), 2, np.asarray,
                                     prefetch=0, **kwargs))


def test_streamed_training_over_a_data_feed():
    """The TFoS map_fun pattern with ctx=None: rows streamed through a
    DataFeed, batched by make_batch_iterator, trained step by step."""
    _, _, model = _setup({**CFG, "attn_impl": "auto"})
    rows = [r for _ in range(3) for r in _ids()]  # one batch, three times
    opt = tdp.adamw(model.parameters(), 3e-2)
    step = tdp.make_train_step(ttfm.make_loss_fn(model), opt)
    state = tdp.TrainState.create(model, opt)
    losses = []
    for batch, n in tdp.make_batch_iterator(
            feed_with(rows), B, lambda xs: {"input_ids": torch.from_numpy(np.stack(xs))}):
        assert n == B
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    assert len(losses) == 3 and state.step == 3
    assert losses[-1] < losses[0]


# -- examples_torch/llm/train_lm.py ------------------------------------------

def _train_lm():
    path = os.path.join(REPO, "examples_torch", "llm", "train_lm.py")
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TINY = ["--vocab-size", "64", "--d-model", "32", "--n-layers", "2",
        "--n-heads", "4", "--seq-len", "16", "--batch", "4"]


def test_train_lm_example_runs_on_cpu(capsys):
    out = _train_lm().main(TINY + ["--device", "cpu", "--steps", "2",
                                   "--generate", "3"])
    text = capsys.readouterr().out
    assert "step 0: loss=" in text and "step 2: loss=" in text and "tokens/sec" in text
    assert np.isfinite(out["loss"]) and out["generated"].shape == (1, 11)


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--sp", "2"], ["--ep", "2"],
                                  ["--pp", "2"], ["--n-experts", "4"],
                                  ["--profile-dir", "x"]])
def test_train_lm_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        _train_lm().main(TINY + ["--device", "cpu"] + flag)


def test_train_lm_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        _train_lm().main(TINY + ["--steps", "1"])


def test_train_lm_f32_on_the_card_raises(monkeypatch):
    """An explicit ``--device cuda`` f32 run at a head dim over 256 (320,
    on the 3xTF32 kernel's wide route) on a machine without a card raises
    where torch first touches CUDA: it neither refuses the head dim up
    front nor falls back to the CPU.  (A card would train it.)"""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would train")
    from tensorflowonspark_torch import gpu_info

    # past the device check, so that the run reaches torch's CUDA init
    monkeypatch.setattr(gpu_info, "default_device", lambda d: torch.device(d))
    wide = ["--d-model", "640", "--n-heads", "2"]  # the later flags win
    # torch built without CUDA raises AssertionError("Torch not compiled
    # with CUDA enabled") from torch.cuda._lazy_init; a CUDA build without
    # a card raises RuntimeError there
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        _train_lm().main(TINY + wide + ["--device", "cuda", "--steps", "1"])


def test_train_lm_takes_a_head_dim_over_256_on_cpu():
    """Head dims over 256 (320 here) train: the run no longer refuses them."""
    wide = ["--d-model", "640", "--n-heads", "2", "--n-layers", "1"]
    out = _train_lm().main(TINY + wide + ["--device", "cpu", "--steps", "2"])
    assert np.isfinite(out["loss"])


def test_cross_entropy_loss_and_accuracy_match_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(6, 5).astype(np.float32)
    labels = rng.randint(0, 5, (6,)).astype(np.int32)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    assert tdp.cross_entropy_loss(tl, tlab).item() == pytest.approx(
        float(jdp.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))), rel=1e-6)
    assert tdp.accuracy(tl, tlab).item() == pytest.approx(
        float(jdp.accuracy(jnp.asarray(logits), jnp.asarray(labels))))
    evaluate = tdp.make_eval_step(lambda x: x * 2)
    assert evaluate(tl).is_inference()
