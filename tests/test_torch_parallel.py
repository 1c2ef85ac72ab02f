"""The port's device mesh, tensor / sequence / expert parallelism and the
train step over a mesh (``tensorflowonspark_torch.parallel.{mesh,tp,sp,
ep,dp}``) against the JAX package's.

First the parts that need no world: ``make_mesh``'s reshape rule and its
errors, ``pick_shard_dim``, the tp rule table against ``convert.py``,
shardings and placements, and ring attention's hop loop over every shard in
one process (what ``chip_smoke.py`` drives on the card).  Then ONE gloo
world of 4 CPU ranks for the whole module (``tests/torch_parallel_worker.py``
runs every multi-rank case in it), restating at 4 ranks
``tests/test_transformer_parallel.py`` (tp2×dp2, tp2×fsdp2, the tp=4
decode, the ring model at sp4, MoE at ep4 and at dp2×sp2, the descending train steps),
``tests/test_parallel_sp.py`` (at sp4 instead of sp8) and two of
``tests/test_parallel_dp.py``.  f32; outputs to 2e-5 as in the JAX tests,
gradients to the JAX tests' 1e-4."""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_torch import convert
from tensorflowonspark_torch.parallel import mesh as tmesh
from tensorflowonspark_torch.parallel import sp as tsp
from tensorflowonspark_torch.parallel import tp as ttp
from tensorflowonspark_tpu.models import transformer as jtfm
from tensorflowonspark_tpu.ops import attention as jatt
from tensorflowonspark_tpu.parallel import mesh as jmesh
from tensorflowonspark_tpu.parallel import tp as jtp

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
OUT_TOL = dict(atol=2e-5, rtol=2e-5)
ATT_TOL = dict(atol=1e-5, rtol=1e-5)   # tests/test_parallel_sp.py's
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)  # its gradient bound
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, bf16=False)


def ids16():
    return np.random.RandomState(0).randint(0, 64, (4, 16)).astype(np.int32)


def ids32():
    return np.random.RandomState(1).randint(0, 64, (4, 32)).astype(np.int32)


def global_qkv(b=4, s=64, h=4, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))


def jax_model(**over):
    model = jtfm.build_transformer({**CFG, **over})
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids16()))["params"]
    return model, jax.tree.map(np.asarray, params)


def decode_ids():
    return np.random.RandomState(0).randint(0, 32, (2, 8)).astype(np.int32)


def decode_model():
    """``test_tp_sharded_decode_matches_unsharded``'s LM and params."""
    model = jtfm.Transformer(vocab_size=32, d_model=16, n_layers=2, n_heads=4,
                             attn_impl="xla", compute_dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(decode_ids()))["params"]
    return model, jax.tree.map(np.asarray, params)


def fake_mesh(rank=0, **axes):
    """A ``DeviceMesh`` over ``axes`` seen from ``rank``, with no process
    group (for the helpers that read only its shape and coordinate)."""
    from torch.distributed.device_mesh import DeviceMesh

    sizes = tmesh._axis_sizes(axes, int(np.prod(list(axes.values()))))
    grid = torch.arange(int(np.prod(list(sizes.values())))).reshape(
        [sizes[a] for a in tmesh.AXES])
    return DeviceMesh("cpu", grid, mesh_dim_names=tmesh.AXES,
                      _init_backend=False, _rank=rank)


# -- no world ----------------------------------------------------------------

WILDCARDS = [{}, {"dp": -1, "tp": 2}, {"tp": 2, "fsdp": 2, "dp": 2}, {"sp": -1},
             {"dp": 2, "sp": 4}, {"ep": 4, "dp": -1}, {"pp": 8}]


@pytest.mark.parametrize("axes", WILDCARDS, ids=[str(a) for a in WILDCARDS])
def test_make_mesh_reshape_rule_matches_jax(axes):
    want = dict(zip(jmesh.AXES, jmesh.make_mesh(jax.devices("cpu"), **axes).devices.shape))
    assert tmesh._axis_sizes(axes, 8) == want


ERRORS = [{"xx": 2}, {"dp": -1, "tp": -1}, {"dp": -1, "tp": 3}, {"tp": 2, "dp": 2}]


@pytest.mark.parametrize("axes", ERRORS, ids=[str(a) for a in ERRORS])
def test_make_mesh_errors_match_jax(axes):
    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh(jax.devices("cpu"), **axes)
    with pytest.raises(ValueError) as terr:
        tmesh._axis_sizes(axes, 8)
    assert str(terr.value) == str(jerr.value)


def test_make_mesh_without_a_process_group_is_this_process_alone():
    mesh = tmesh.make_mesh("cpu", dp=-1)
    assert tmesh.spec(mesh) == tmesh.MeshSpec()
    assert mesh.mesh_dim_names == tmesh.AXES and tmesh.device_of(mesh).type == "cpu"
    assert tmesh.group(mesh, "dp", "sp") is None and not tmesh.is_multiprocess(mesh)
    with pytest.raises(ValueError, match="device count 1"):
        tmesh.make_mesh("cpu", tp=2)
    batch = tmesh.shard_batch(mesh, {"x": np.ones((3, 2), np.float32)})
    assert isinstance(batch["x"], torch.Tensor) and batch["x"].shape == (3, 2)


def test_make_mesh_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()


@pytest.mark.parametrize("shape,n,taken", [((8, 6), 2, ()), ((3, 5), 2, ()),
                                           ((4, 12, 16), 4, (2,)), ((6, 6), 3, (0,)),
                                           ((), 2, ()), ((2,), 4, ())])
def test_pick_shard_dim_matches_jax(shape, n, taken):
    assert tmesh.pick_shard_dim(shape, n, taken) == jmesh.pick_shard_dim(shape, n, taken)


def test_rule_table_restates_the_jax_rules():
    assert [(pat, tuple(spec)) for pat, spec, _, _ in ttp.RULE_TABLE] == \
        [(pat, tuple(spec)) for pat, spec in jtp.TRANSFORMER_TP_RULES]


@pytest.mark.parametrize("n_experts", [0, 4])
@pytest.mark.parametrize("axis", ["tp", "ep"])
def test_rule_table_matches_convert(axis, n_experts):
    """For every leaf a JAX rule splits over ``axis``, mark each element
    with the index of its block (2 blocks); after ``convert.flax_to_torch``
    the port's rule must split the port's tensor so that block i holds
    only i — the two rules cut the same elements."""
    _, params = jax_model(n_experts=n_experts)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    marked = {}
    for path, leaf in flat:
        name = "/".join(str(p.key) for p in path)
        spec = next((s for pat, s in jtp.TRANSFORMER_TP_RULES
                     if re.search(pat, name)), ())
        dim = next((d for d, e in enumerate(spec) if e == axis), None)
        shape = [1] * leaf.ndim
        if dim is not None:
            shape[dim] = leaf.shape[dim]
        block = (np.arange(leaf.shape[dim]) * 2 // leaf.shape[dim]
                 if dim is not None else np.zeros(1))
        marked[name] = np.broadcast_to(block.reshape(shape), leaf.shape).astype(np.float32) \
            if dim is not None else np.full(leaf.shape, -1.0, np.float32)
    tree = {}
    for name, value in marked.items():
        node = tree
        *head, last = name.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    state = convert.flax_to_torch(tree)
    shardings = ttp.rule_shardings(fake_mesh(**{axis: 2}), state, ttp.TRANSFORMER_TP_RULES)
    split = 0
    for key, t in state.items():
        dims = [d for d in range(t.dim()) if axis in shardings[key].axes_of(d)]
        if not dims:
            assert (t == -1).all(), f"{key}: the JAX rule splits it over {axis}, the port's not"
            continue
        split += 1
        for i, block in enumerate(t.chunk(2, dim=dims[0])):
            assert (block == i).all(), f"{key}: block {i} of the port's split"
    assert split > 0 or (axis == "ep" and not n_experts)  # a dense LM has no experts


def test_compose_fsdp_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = fake_mesh(fsdp=2, tp=2)
    tree = {"blocks.0.attn.q_proj.weight": torch.zeros(32, 16),
            "blocks.0.attn.o_proj.weight": torch.zeros(16, 32),
            "final_norm.scale": torch.zeros(16), "odd": torch.zeros(3)}
    s = ttp.compose_fsdp(mesh, tree, ttp.rule_shardings(mesh, tree, ttp.TRANSFORMER_TP_RULES))
    assert tuple(s["blocks.0.attn.q_proj.weight"].spec) == ("tp", "fsdp")
    assert tuple(s["blocks.0.attn.o_proj.weight"].spec) == ("fsdp", "tp")
    assert tuple(s["final_norm.scale"].spec) == ("fsdp",)
    assert tuple(s["odd"].spec) == ()
    assert s["blocks.0.attn.q_proj.weight"].placements == [
        Replicate(), Shard(1), Shard(0), Replicate(), Replicate(), Replicate()]
    assert tmesh.batch_sharding(mesh, 1).placements[:2] == [Shard(0), Shard(0)]
    assert tmesh.fsdp_shardings(mesh, tree)["blocks.0.attn.q_proj.weight"].spec == \
        tmesh.P("fsdp", None)


def test_local_shard_and_constrain():
    x = torch.arange(4 * 8 * 2).reshape(4, 8, 2)
    assert ttp.constrain(x, tmesh.P(None, "sp"), None) is x
    mesh = fake_mesh(rank=3, dp=2, sp=2)  # coordinate dp 1, sp 1
    out = ttp.constrain(x, tmesh.P(("dp", "fsdp"), "sp", None), mesh)
    torch.testing.assert_close(out, x[:, 4:])  # the batch axes are skipped
    s = tmesh.Sharding(mesh, tmesh.P("dp", "sp"))
    torch.testing.assert_close(tmesh.local_shard(x, s), x[2:, 4:])


@pytest.mark.parametrize("causal", [True, False])
def test_ring_hops_in_one_process_match_dense_and_grads(causal):
    """The hop loop over four sequence shards held in one process (as
    ``chip_smoke.py`` drives it on one card): O and lse against the JAX
    dense reference, and the gradients of a loss on O and lse, which flow
    through every hop's ``lse``."""
    q, k, v = global_qkv(b=2, s=32, h=2, d=8, seed=3)
    ref = np.asarray(jatt.mha_reference(*map(jnp.asarray, (q, k, v)), causal=causal))
    n = 4
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    qs, ks, vs = (t.chunk(n, dim=1) for t in (tq, tk, tv))
    outs, lses = [], []
    for i in range(n):
        o, lse = tsp.ring_hops(qs[i], lambda h, i=i: (ks[(i - h) % n], vs[(i - h) % n]),
                               i, n, causal=causal)
        outs.append(o)
        lses.append(lse)
    out, lse = torch.cat(outs, 1), torch.cat(lses, 1)
    np.testing.assert_allclose(out.detach().numpy(), ref, **ATT_TOL)
    _, jlse = jatt.chunk_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), **ATT_TOL)
    g = np.random.RandomState(4).randn(*q.shape).astype(np.float32)

    def jloss(q, k, v):
        o, l = jatt.chunk_attention(q, k, v, causal=causal)
        return (o * g).sum() + l.sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ((out * torch.from_numpy(g)).sum() + lse.sum()).backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL)


# -- one gloo world of 4 ranks for the module ---------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Weights converted from the JAX package's params, then the 4 ranks of
    ``tests/torch_parallel_worker.py``; returns ``(outputs, errors)`` by
    case name, rank 0's outputs and every rank's errors."""
    work = tmp_path_factory.mktemp("world")
    for name, over in (("dense", {}), ("moe", {"n_experts": 4})):
        _, params = jax_model(**over)
        torch.save(convert.flax_to_torch(params), work / f"{name}.pt")
    _, params = decode_model()
    torch.save(convert.flax_to_torch(params), work / "decode.pt")
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_parallel_worker.py"),
         "--rank", str(r), "--world", str(WORLD), "--port", str(port), "--dir", str(work)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errors: dict = {}
    outs = []
    for r in range(WORLD):
        path = work / f"errors{r}.json"
        if not path.exists():
            pytest.fail(f"rank {r} wrote no results:\n{logs[r][-3000:]}")
        for case, tb in json.loads(path.read_text()).items():
            errors.setdefault(case, f"rank {r}:\n{tb}")
        outs.append(dict(np.load(work / f"rank{r}.npz")))
    return outs, errors


def got(world, case, key, rank=0):
    outs, errors = world
    if case in errors:
        pytest.fail(errors[case])
    return outs[rank][f"{case}/{key}"]


def _jax_grads(model, params, ids):
    (total, metrics), grads = jax.value_and_grad(jtfm.make_loss_fn(model), has_aux=True)(
        params, {"input_ids": jnp.asarray(ids)})
    return float(total), metrics, convert.flax_to_torch(jax.tree.map(np.asarray, grads))


def _assert_grads(world, case, want):
    for name, w in want.items():
        np.testing.assert_allclose(got(world, case, f"grad/{name}"), w.numpy(),
                                   atol=1e-6, rtol=2e-4, err_msg=name)


def test_tp_sharded_matches_replicated(world):
    """tp2 × dp2: heads, MLP and vocab split over tp, rows over dp."""
    model, params = jax_model()
    ref = np.asarray(model.apply({"params": params}, ids16()))
    for r in range(WORLD):  # rank r sits at dp r // 2, tp r % 2
        np.testing.assert_allclose(got(world, "tp2_dp2", "logits", r),
                                   ref[(r // 2) * 2:][:2], **OUT_TOL)
    assert int(got(world, "tp2_dp2", "q_rows")) == 32 // 2  # half the heads


def test_tp_sharded_decode_matches_unsharded(world):
    """Model-parallel serving (``tests/test_transformer_parallel.py``'s,
    slow there): ``greedy_generate`` with the heads, MLP and vocab split
    over tp=4 emits exactly the unsharded tokens — the port's on one rank
    and the JAX package's — on every rank, a 5-token prompt and 4 new."""
    model, params = decode_model()
    base = np.asarray(jtfm.greedy_generate(model, params, jnp.asarray(decode_ids()[:, :5]),
                                           max_new_tokens=4))
    for r in range(WORLD):
        np.testing.assert_array_equal(got(world, "tp4_decode", "tokens", r), base)
        np.testing.assert_array_equal(got(world, "tp4_decode", "unsharded", r), base)
    assert int(got(world, "tp4_decode", "q_rows")) == 16 // 4  # one head a rank


def test_tp_fsdp_composition(world):
    """tp2 × fsdp2: the forward, and one SGD step (fsdp gathers, the
    gradients summed back over fsdp) equal to the single-device step."""
    model, params = jax_model()
    ids = ids16()
    ref = np.asarray(model.apply({"params": params}, ids))
    for r in range(WORLD):
        np.testing.assert_allclose(got(world, "tp2_fsdp2", "logits", r),
                                   ref[(r // 2) * 2:][:2], **OUT_TOL)
    # the embedding [V, D]: V over tp, then D (the largest free dim) over fsdp
    assert tuple(got(world, "tp2_fsdp2", "emb_local_shape")) == (64 // 2, 32 // 2)
    opt = optax.sgd(0.1)
    loss_fn = jtfm.make_loss_fn(model)
    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, {"input_ids": jnp.asarray(ids)})
    updates, _ = opt.update(grads, opt.init(params), params)
    want = convert.flax_to_torch(jax.tree.map(np.asarray, optax.apply_updates(params, updates)))
    np.testing.assert_allclose(float(got(world, "tp2_fsdp2", "loss")), float(loss), rtol=1e-5)
    for name, w in want.items():
        np.testing.assert_allclose(got(world, "tp2_fsdp2", f"param/{name}"), w.numpy(),
                                   **OUT_TOL, err_msg=name)


def test_ring_attention_model_matches_flash_model(world):
    """sp4: the sequence split at the embedding, RoPE at global positions,
    attention round the ring; logits, loss and the gradients (summed over
    sp) against the JAX model with plain attention."""
    model, params = jax_model(attn_impl="xla")
    ref = np.asarray(model.apply({"params": params}, ids32()))
    for r in range(WORLD):
        np.testing.assert_allclose(got(world, "ring_model_sp4", "logits", r), ref, **OUT_TOL)
    total, _, want = _jax_grads(model, params, ids32())
    np.testing.assert_allclose(float(got(world, "ring_model_sp4", "loss")), total, rtol=1e-5)
    _assert_grads(world, "ring_model_sp4", want)


def test_ring_model_loss_mask_matches_jax(world):
    """sp4 with a ragged ``loss_mask``: each rank's nll over its own block
    of the sequence, summed over sp and divided by the global count."""
    model, params = jax_model(attn_impl="xla")
    mask = (np.arange(32)[None, :] < 32 - 5 * np.arange(4)[:, None]).astype(np.float32)
    (total, _), grads = jax.value_and_grad(jtfm.make_loss_fn(model), has_aux=True)(
        params, {"input_ids": jnp.asarray(ids32()), "loss_mask": jnp.asarray(mask)})
    np.testing.assert_allclose(float(got(world, "ring_model_sp4_masked", "loss")),
                               float(total), rtol=1e-5)
    _assert_grads(world, "ring_model_sp4_masked",
                  convert.flax_to_torch(jax.tree.map(np.asarray, grads)))


def test_ulysses_model_matches_flash_model(world):
    model, params = jax_model(attn_impl="xla")
    ref = np.asarray(model.apply({"params": params}, ids32()))
    np.testing.assert_allclose(got(world, "ulysses_model_sp4", "logits", 3), ref, **OUT_TOL)


def test_moe_ep_sharded_matches_replicated(world):
    """ep4: one expert per rank, every rank routing the same tokens;
    logits, the loss and its aux terms, and the gradients."""
    model, params = jax_model(n_experts=4)
    ref = np.asarray(model.apply({"params": params}, ids16(), mutable=["aux_loss"])[0])
    for r in range(WORLD):
        np.testing.assert_allclose(got(world, "moe_ep4", "logits", r), ref, **OUT_TOL)
    assert int(got(world, "moe_ep4", "experts_local")) == 1
    total, metrics, want = _jax_grads(model, params, ids16())
    for key in ("lm_loss", "aux_loss", "router_z_loss"):
        np.testing.assert_allclose(float(got(world, "moe_ep4", f"metric/{key}")),
                                   float(metrics[key]), rtol=1e-5)
    _assert_grads(world, "moe_ep4", want)


def test_moe_under_sp2_ep2_matches_jax(world):
    """sp2 × ep2 with ring attention: the MoE routes the whole sequence
    (gathered over sp), so loss, aux terms and gradients equal JAX's."""
    model, params = jax_model(n_experts=4)
    total, metrics, want = _jax_grads(model, params, ids16())
    for key in ("loss", "lm_loss", "aux_loss", "router_z_loss"):
        np.testing.assert_allclose(float(got(world, "moe_sp2_ep2", f"metric/{key}")),
                                   float(metrics.get(key, total)), rtol=1e-5)
    _assert_grads(world, "moe_sp2_ep2", want)


def test_train_step_descends(world):
    """dp4, Adam 1e-2, 5 steps on the tiled batch: the loss falls, and
    follows the JAX single-device trajectory."""
    losses = got(world, "train_descends_dp4", "losses")
    assert int(got(world, "train_descends_dp4", "steps")) == 5
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, _jax_adam_losses(), rtol=1e-4)


def test_moe_under_dp2_sp2_matches_jax(world):
    """dp2 × sp2 with ring attention: the MoE gathers the rows over dp and
    the sequence over sp and routes the global batch as one group, each
    rank running the experts on its quarter of the capacity slots; logits,
    loss, aux terms and gradients equal JAX's."""
    model, params = jax_model(n_experts=4)
    ref = np.asarray(model.apply({"params": params}, ids16(), mutable=["aux_loss"])[0])
    for r in range(WORLD):  # rank r sits at dp r // 2, sp r % 2: whole logits of its rows
        np.testing.assert_allclose(got(world, "moe_dp2_sp2", "logits", r),
                                   ref[(r // 2) * 2:][:2], **OUT_TOL)
    total, metrics, want = _jax_grads(model, params, ids16())
    for key in ("loss", "lm_loss", "aux_loss", "router_z_loss"):
        np.testing.assert_allclose(float(got(world, "moe_dp2_sp2", f"metric/{key}")),
                                   float(metrics.get(key, total)), rtol=1e-5)
    _assert_grads(world, "moe_dp2_sp2", want)


def _jax_adam_losses(n_experts=0):
    """The JAX single-device trajectory: Adam 1e-2, 5 steps on the tiled
    batch."""
    model, params = jax_model(n_experts=n_experts)
    opt = optax.adam(1e-2)
    state = opt.init(params)
    loss_fn = jtfm.make_loss_fn(model)
    batch = {"input_ids": jnp.asarray(np.tile(ids16(), (2, 1)))}
    want = []
    for _ in range(5):
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(params, batch)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))
    return want


def test_moe_train_step_descends(world):
    """dp4 MoE: the global batch routed as one group, so the loss falls and
    follows the JAX single-device trajectory."""
    losses = got(world, "moe_train_descends_dp4", "losses")
    assert int(got(world, "moe_train_descends_dp4", "steps")) == 5
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, _jax_adam_losses(n_experts=4), rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_dense(world, causal):
    q, k, v = global_qkv()
    ref = np.asarray(jatt.mha_reference(*map(jnp.asarray, (q, k, v)), causal=causal))
    np.testing.assert_allclose(got(world, f"ring_attention_{causal}", "out"), ref, **ATT_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_attention_matches_dense(world, causal):
    q, k, v = global_qkv()
    ref = np.asarray(jatt.mha_reference(*map(jnp.asarray, (q, k, v)), causal=causal))
    np.testing.assert_allclose(got(world, f"ulysses_attention_{causal}", "out"), ref,
                               **ATT_TOL)


def test_ring_attention_sp4(world):
    q, k, v = global_qkv(b=2)
    ref = np.asarray(jatt.mha_reference(*map(jnp.asarray, (q, k, v)), causal=True))
    np.testing.assert_allclose(got(world, "ring_attention_sp4_b2", "out"), ref, **ATT_TOL)


def test_ring_attention_grads_match_dense(world):
    q, k, v = global_qkv(b=2, s=32, h=2, d=8)
    want = jax.grad(lambda q, k, v: jnp.sum(jatt.mha_reference(q, k, v, causal=True) ** 2),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for name, w in zip("qkv", want):
        np.testing.assert_allclose(got(world, "ring_attention_grads", name), np.asarray(w),
                                   **GRAD_TOL)


def test_ring_attention_with_sharded_inputs(world):
    """Through ``sequence_parallel_attention(mesh, ...)`` on each rank's
    block, as a model calls it."""
    q, k, v = global_qkv()
    ref = np.asarray(jatt.mha_reference(*map(jnp.asarray, (q, k, v)), causal=True))
    np.testing.assert_allclose(got(world, "ring_attention_via_mesh", "out"), ref, **ATT_TOL)


def test_batch_is_actually_sharded_over_dp(world):
    """Each rank's batch is its own 4 of the 16 rows (16 rows / 4 ranks)."""
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    for r in range(WORLD):
        assert got(world, "batch_sharded_dp4", "local", r).shape == (4, 3)
        np.testing.assert_array_equal(got(world, "batch_sharded_dp4", "local", r),
                                      x[r * 4:(r + 1) * 4])
        assert int(got(world, "batch_sharded_dp4", "n", r)) == 4
    np.testing.assert_array_equal(got(world, "batch_sharded_dp4", "whole"), x)


def test_gradient_matches_single_device(world):
    """The dp4 step equals the single-device step over the whole batch."""
    params = {"w": jnp.zeros((4,)), "b": jnp.zeros(())}

    def loss_fn(p, batch):
        return jnp.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)

    x = np.random.RandomState(1).randn(16, 4).astype(np.float32)
    y = np.ones((16,), np.float32)
    loss, g = jax.value_and_grad(loss_fn)(params, {"x": x, "y": y})
    for r in range(WORLD):
        np.testing.assert_allclose(got(world, "linreg_dp4", "w", r),
                                   np.asarray(params["w"] - 0.1 * g["w"]), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(got(world, "linreg_dp4", "b", r)),
                                   float(params["b"] - 0.1 * g["b"]), rtol=1e-4, atol=1e-6)
    assert float(got(world, "linreg_dp4", "loss")) == pytest.approx(float(loss), rel=1e-4)
