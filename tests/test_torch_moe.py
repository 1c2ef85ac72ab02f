"""The port's MoE (``tensorflowonspark_torch.parallel.ep``) and the MoE
transformer against the JAX package's: the sort dispatch's slots bit for
bit, ``MoEMLP`` forward and gradients with both dispatches, capacity drops,
the auxiliary losses with and without remat, the MoE LM's logits, loss and
gradients with converted weights, decode, and a served MoE bundle.  f32
unless a test says otherwise; tolerances beside each."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_torch import convert
from tensorflowonspark_torch.models import registry as treg
from tensorflowonspark_torch.models import transformer as ttfm
from tensorflowonspark_torch.parallel import ep as tep
from tensorflowonspark_tpu.models import transformer as jtfm
from tensorflowonspark_tpu.parallel import ep as jep
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

OUT_TOL = dict(atol=2e-5, rtol=2e-5)   # f32 forward, the JAX parallel tests' bound
GRAD_TOL = dict(atol=1e-6, rtol=2e-4)  # f32 gradients summed in other orders
CFG = {"model": "transformer", "vocab_size": 64, "d_model": 32, "n_layers": 2,
       "n_heads": 4, "bf16": False, "n_experts": 4, "attn_impl": "xla"}


def _ids(b=4, s=16, seed=0):
    return np.random.RandomState(seed).randint(0, 64, (b, s)).astype(np.int32)


# -- the dispatch -------------------------------------------------------------

DISPATCH_CASES = {
    # (n, k, e, capacity, ties): ample, tight and forced-overflow capacities
    "n12_k2_e4_ample": (12, 2, 4, 8, False),
    "n12_k2_e4_overflow": (12, 2, 4, 2, False),
    "n64_k2_e8_c20": (64, 2, 8, 20, False),
    "n64_k1_e8_c1": (64, 1, 8, 1, False),
    "n33_k3_e5_c7": (33, 3, 5, 7, False),
    "n40_k2_e4_ties": (40, 2, 4, 6, True),
    "n256_k2_e8_c80": (256, 2, 8, 80, False),
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_sorted_dispatch_matches_jax_bit_for_bit(case):
    """Same ``top_idx``/``top_p`` in, the same slots, source tokens, gates
    and keep flags out, exactly, overflow included (and with the top-k
    indices of a router whose probabilities tie exactly)."""
    n, k, e, cap, ties = DISPATCH_CASES[case]
    rng = np.random.RandomState(n + k + e + cap)
    if ties:  # a zero router: every probability 1/e, top-k by index order
        probs = np.full((n, e), 1.0 / e, np.float32)
        top_p, top_idx = jax.lax.top_k(jnp.asarray(probs), k)
        top_p, top_idx = np.asarray(top_p), np.asarray(top_idx)
    else:
        top_idx = np.stack([rng.choice(e, k, replace=False) for _ in range(n)]).astype(np.int32)
        top_p = rng.rand(n, k).astype(np.float32)
    want = jep._sorted_dispatch(jnp.asarray(top_idx), jnp.asarray(top_p), cap, e)
    got = tep._sorted_dispatch(torch.from_numpy(top_idx), torch.from_numpy(top_p), cap, e)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if cap * e < n * k:
        assert not bool(np.asarray(want[3]).all())  # some pairs dropped


@pytest.mark.parametrize("ties", [False, True])
def test_top_k_orders_ties_as_jax(ties):
    """``torch.topk`` promises no order among equal values; the port's
    stable descending sort puts the lower index first, as ``jax.lax.top_k``."""
    rng = np.random.RandomState(2)
    probs = (np.round(rng.rand(50, 8) * 3) / 3 if ties else rng.rand(50, 8)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = tep.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- MoEMLP -------------------------------------------------------------------

def _layers(dispatch, **kw):
    kwargs = dict(d_model=8, d_ff=16, n_experts=4, top_k=2, capacity_factor=1.25)
    kwargs.update(kw)
    jlayer = jep.MoEMLP(**kwargs, compute_dtype=jnp.float32, dispatch=dispatch)
    tlayer = tep.MoEMLP(**kwargs, compute_dtype=torch.float32, dispatch=dispatch)
    return jlayer, tlayer


def _load(tlayer, params):
    tlayer.load_state_dict({
        "router.weight": torch.from_numpy(np.asarray(params["router"]["kernel"]).T.copy()),
        **{n: torch.from_numpy(np.asarray(params[n]))
           for n in ("experts_gate", "experts_up", "experts_down")}})
    return tlayer


@pytest.mark.parametrize("dispatch", ["sort", "einsum"])
@pytest.mark.parametrize("cap_factor", [1.25, 0.4])
def test_moe_mlp_forward_and_aux_match_jax(dispatch, cap_factor):
    jlayer, tlayer = _layers(dispatch, capacity_factor=cap_factor)
    x = np.random.RandomState(7).randn(2, 12, 8).astype(np.float32)
    params = jlayer.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    y, upd = jlayer.apply({"params": params}, jnp.asarray(x), mutable=["aux_loss"])
    ty, aux = _load(tlayer, params)(torch.from_numpy(x))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), **OUT_TOL)
    for name in ("load_balance", "router_z"):
        np.testing.assert_allclose(aux[name].item(),
                                   float(upd["aux_loss"][name][0]), rtol=1e-6)


@pytest.mark.parametrize("dispatch", ["sort", "einsum"])
def test_moe_mlp_grads_match_jax(dispatch):
    jlayer, tlayer = _layers(dispatch, n_experts=2)
    x = np.random.RandomState(3).randn(1, 10, 8).astype(np.float32)
    params = jlayer.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]

    def jloss(p, xx):
        y = jlayer.apply({"params": p}, xx, mutable=["aux_loss"])[0]
        return jnp.sum(y * y)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    _load(tlayer, params)
    tx = torch.from_numpy(x).requires_grad_()
    y, _ = tlayer(tx)
    (y * y).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    np.testing.assert_allclose(tlayer.router.weight.grad.numpy().T,
                               np.asarray(jg["router"]["kernel"]), **GRAD_TOL)
    for n in ("experts_gate", "experts_up", "experts_down"):
        np.testing.assert_allclose(getattr(tlayer, n).grad.numpy(), np.asarray(jg[n]),
                                   **GRAD_TOL)


def test_sort_dispatch_equals_einsum_in_the_port():
    """The port's two dispatches agree with each other (the JAX package's
    own parity test), overflow included."""
    for cap in (1.25, 0.4):
        _, ts = _layers("sort", capacity_factor=cap)
        _, te = _layers("einsum", capacity_factor=cap)
        ts.init_weights(torch.Generator().manual_seed(0))
        te.load_state_dict(ts.state_dict())
        x = torch.from_numpy(np.random.RandomState(7).randn(2, 12, 8).astype(np.float32))
        np.testing.assert_allclose(ts(x)[0].detach().numpy(), te(x)[0].detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def _record_routing(layer) -> list:
    """Each call's ``top_idx``, from a forward hook on the router (the f32
    logits of the routed tokens)."""
    seen: list = []
    layer.router.register_forward_hook(
        lambda mod, args, logits: seen.append(tep.top_k(torch.softmax(logits, -1),
                                                        layer.top_k)[1]))
    return seen


def test_moe_capacity_drops_overflow():
    """capacity_factor 0.1: ceil(16 · 0.1 · 1 / 2) = 1 slot per expert, so at
    most 2 tokens pass; the rest come out zero, and the dropped pairs are
    the JAX package's."""
    jlayer, tlayer = _layers("sort", n_experts=2, top_k=1, capacity_factor=0.1)
    x = np.random.RandomState(0).randn(2, 8, 8).astype(np.float32)
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    y = np.asarray(jlayer.apply({"params": params}, jnp.asarray(x), mutable=["aux_loss"])[0])
    routing = _record_routing(tlayer)
    ty = _load(tlayer, params)(torch.from_numpy(x))[0].detach().numpy()
    assert np.isfinite(ty).all()
    nonzero = int(np.any(ty.reshape(16, 8) != 0, axis=-1).sum())
    assert nonzero <= 2
    np.testing.assert_array_equal(np.any(ty != 0, -1), np.any(y != 0, -1))
    top_idx = routing[-1]
    _, _, _, keep = tep._sorted_dispatch(top_idx, torch.ones(top_idx.shape), 1, 2)
    assert int((~keep).sum()) == 16 - nonzero


def test_moe_replay_routes_by_the_given_experts(monkeypatch):
    """``replay`` pins the routing: a layer fed another input but the first
    call's ``top_idx`` uses those experts (its gates its own probabilities
    there), which is how the card's kernel path is held against plain
    attention at one routing."""
    _, layer = _layers("sort")
    layer.init_weights(torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 12, 8).astype(np.float32))
    routing = _record_routing(layer)
    y, _ = layer(x)
    top_idx = routing[-1]
    layer.replay = top_idx
    y2, _ = layer(x)
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    used = []
    dispatch = tep._sorted_dispatch
    monkeypatch.setattr(tep, "_sorted_dispatch",
                        lambda idx, *args: used.append(idx) or dispatch(idx, *args))
    layer(x + 0.5)
    torch.testing.assert_close(used[-1], top_idx, rtol=0, atol=0)


def test_moe_mlp_refuses_top_k_above_experts():
    with pytest.raises(ValueError, match="top_k"):
        tep.MoEMLP(8, 16, n_experts=1, top_k=2)


# -- the MoE transformer ------------------------------------------------------

@pytest.fixture(scope="module")
def moe_lm():
    jmodel = jtfm.build_transformer(CFG)
    ids = _ids()
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), ids)["params"])
    tmodel = ttfm.build_transformer(CFG)
    tmodel.load_state_dict(convert.flax_to_torch(params), strict=True)
    return jmodel, params, tmodel


def test_moe_lm_logits_and_aux_match_jax(moe_lm):
    jmodel, params, tmodel = moe_lm
    ids = _ids()
    ref, upd = jmodel.apply({"params": params}, ids, mutable=["aux_loss"])
    aux: dict = {}
    with torch.no_grad():
        out = tmodel(torch.from_numpy(ids), aux_loss=aux).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **OUT_TOL)
    for i in range(CFG["n_layers"]):
        jaux = upd["aux_loss"][f"block_{i}"]["moe"]
        for name in ("load_balance", "router_z"):
            np.testing.assert_allclose(aux[name][i].item(), float(jaux[name][0]), rtol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_loss_and_grads_match_jax_with_and_without_remat(moe_lm, remat):
    """``make_loss_fn`` sums the blocks' aux losses once, remat or not (a
    recomputed block adds nothing), and its loss, metrics and gradients
    equal the JAX loss's (whose remat sibling the JAX package pins in
    ``test_moe_aux_losses_survive_remat``)."""
    jmodel, params, tmodel = moe_lm
    ids = _ids(seed=11)
    (jtotal, jm), jg = jax.value_and_grad(jtfm.make_loss_fn(jmodel), has_aux=True)(
        params, {"input_ids": jnp.asarray(ids)})
    tmodel.remat = remat
    try:
        tmodel.zero_grad(set_to_none=True)
        total, metrics = ttfm.make_loss_fn(tmodel)(tmodel, {"input_ids": ids})
        total.backward()
    finally:
        tmodel.remat = False
    assert float(jm["aux_loss"]) > 0.1 and float(jm["router_z_loss"]) > 0.0
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for key in ("lm_loss", "aux_loss", "router_z_loss"):
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), rtol=1e-5)
    want = convert.flax_to_torch(jax.tree.map(np.asarray, jg))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **GRAD_TOL,
                                   err_msg=name)


def test_moe_bf16_logits_close_to_jax():
    cfg = {**CFG, "bf16": True}
    jmodel = jtfm.build_transformer(cfg)
    ids = _ids()
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(4), ids)["params"])
    ref = np.asarray(jmodel.apply({"params": params}, ids, mutable=["aux_loss"])[0])
    out = treg.build_apply(cfg, device="cpu")(params, ids).numpy()
    # bf16 compute on both sides, rounded at different places over 2 layers
    # (the router stays f32 on both): 5% of the largest logit
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=0.05 * scale, rtol=0)
    assert np.mean(out.argmax(-1) == ref.argmax(-1)) > 0.9


def test_moe_convert_round_trip_and_serving_cast(moe_lm):
    _, params, tmodel = moe_lm
    back = convert.torch_to_flax(tmodel.state_dict(), CFG["n_heads"])
    assert set(back["block_0"]) == {"attn", "attn_norm", "mlp_norm", "moe"}
    jax.tree.map(np.testing.assert_array_equal, back, params)
    model = treg.build_apply({**CFG, "bf16": True}, device="cpu")
    model(params, _ids(b=1))
    moe = model.model.blocks[0].moe
    assert moe.router.weight.dtype == torch.float32  # routing stays f32
    assert moe.experts_up.dtype == torch.bfloat16    # cast once at load


def test_moe_init_matches_flax_fans():
    """flax's lecun_normal counts the expert axis in an [E, in, out]
    stack's fan-in; the port draws the same stds."""
    tmodel = ttfm.build_transformer({**CFG, "d_model": 64, "n_experts": 8})
    tmodel.init_weights(torch.Generator().manual_seed(0))
    moe = tmodel.blocks[0].moe
    for p, fan_in in ((moe.experts_gate, 8 * 64), (moe.experts_down, 8 * 256),
                      (moe.router.weight, 64)):
        assert abs(p.std().item() * fan_in ** 0.5 - 1.0) < 0.05


def test_moe_decode_matches_jax_greedy(moe_lm):
    """Decode with MoE routes each call's tokens (a one-token step at
    n = B), as the JAX package does: greedy tokens equal its own."""
    jmodel, params, tmodel = moe_lm
    prompt = _ids(b=2, s=6, seed=5)
    want = jtfm.greedy_generate(jmodel, params, jnp.asarray(prompt), max_new_tokens=5)
    got = ttfm.greedy_generate(tmodel.eval(), prompt, max_new_tokens=5)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_served_moe_bundle_matches_jax_on_the_padded_batch(tmp_path):
    """A MoE bundle through the port's ``serving_loop``: a partial batch is
    padded with copies of its last row (the pad rows take expert capacity),
    and the served logits equal the JAX apply on that padded batch."""
    from tensorflowonspark_torch import telemetry
    from tensorflowonspark_torch.feeding import DataFeed, FeedQueues
    from tensorflowonspark_torch.marker import EndOfFeed, EndPartition, ResultChunk
    from tensorflowonspark_torch.serving.loop import serving_loop
    from tensorflowonspark_tpu import checkpoint as jckpt

    jmodel = jtfm.build_transformer(CFG)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(6), _ids())["params"])
    export = str(tmp_path / "moe")
    jckpt.export_bundle(export, params, CFG)
    rows = [r for r in _ids(b=3, s=16, seed=9)]
    queues = FeedQueues(capacity=64)
    q = queues.get_queue("input")
    for r in rows:
        q.put(r)
    q.put(EndPartition())
    q.put(EndOfFeed())

    class Ctx:
        executor_id, num_executors = 0, 1
        metrics = telemetry.get_registry()

        def get_data_feed(self, train_mode=True):
            return DataFeed(queues, train_mode=train_mode, poll_interval=0.05)

    serving_loop({"export_dir": export, "max_batch": 4, "device": "cpu"}, Ctx())
    out = []
    oq = queues.get_queue("output")
    while not oq.empty():
        got = oq.get()
        out.extend(got.items if isinstance(got, ResultChunk) else [got])
    assert len(out) == 3
    padded = np.stack(rows + [rows[-1]])
    ref = np.asarray(jmodel.apply({"params": params}, padded, mutable=["aux_loss"])[0])
    np.testing.assert_allclose(np.stack(out), ref[:3], **OUT_TOL)


def test_chip_smoke_moe_and_ring_phases_run_on_cpu(monkeypatch, tmp_path):
    """``chip_smoke.py``'s three phases of this slice, shrunk to a few
    layers and narrow widths, on the CPU (no kernel: 0 launches expected):
    the MoE bundle served with its checks (the plain-attention logits, the
    capacity drops of both paths), the MoE train step with its checks, and
    the ring's hop loop with its gradients."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "WORK_DIR", str(tmp_path))
    monkeypatch.setattr(cs, "MOE_CONFIG", {**CFG, "bf16": True, "attn_impl": "auto",
                                           "moe_top_k": 2})
    monkeypatch.setattr(cs, "SEQ_LEN", 16)
    monkeypatch.setattr(cs, "MOE_TRAIN_BATCH", 4)
    monkeypatch.setattr(cs, "MOE_WARMUP", 1)
    monkeypatch.setattr(cs, "MOE_TIMED", 3)
    monkeypatch.setattr(cs, "RING_SHAPE", (2, 32, 2, 16))
    served = cs.phase_moe_slice(0, "cpu", device="cpu")
    assert served["launches"] == 0 and len(served["drops"]) == 3
    trained = cs.phase_moe_train(0, "cpu", device="cpu")
    assert trained["loss"][-1] < trained["loss"][0] and trained["aux_loss"][0] > 0
    ring = cs.phase_ring_hops(0, "cpu", device="cpu")
    assert ring["launches"] == 0 and ring["grad_rel_err"] < cs.GRAD_REL_TOL
