"""The port's pipeline parallelism (``tensorflowonspark_torch.parallel.pp``)
and ``train_lm.py --pp`` against the JAX package's.

First the parts that need no world: ``stack_stages``/``stage_shardings``,
the 1F1B tick table against the schedule's formula, and the one-process
driver (every stage in this process, as one card runs it) against the
JAX package's sequential ``jax.grad``.  Then ONE gloo world of 4 CPU ranks
for the module (``tests/torch_pp_worker.py`` runs every multi-rank case in
it), restating each test of ``tests/test_parallel_pp.py`` at ``pp=4`` or
``dp=2 × pp=2`` (the JAX tests' meshes take 8 devices), with that file's
tolerances: 1e-5, gpipe gradients 1e-4, transformer blocks 2e-5, the bf16
wire 0.05 / 0.1.  The references are the JAX sequential models' and, where
a pipeline result itself is compared, the JAX ``gpipe``/``pipeline_1f1b``
on the simulated CPU devices.  Finally ``train_lm.py --pp 2`` end to end
under ``torchrun``.  ``tests/test_distributed.py``'s two-process 1F1B over
DCN is this world: the port's ranks are processes."""

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
from tensorflowonspark_torch.models import transformer as ttfm
from tensorflowonspark_torch.parallel import mesh as tmesh
from tensorflowonspark_torch.parallel import pp as tpp
from tensorflowonspark_tpu.models import transformer as jtfm
from tensorflowonspark_tpu.parallel import mesh as jmesh
from tensorflowonspark_tpu.parallel import pp as jpp
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
TOL = dict(atol=1e-5, rtol=1e-5)
GPIPE_GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
BLOCK_TOL = dict(atol=2e-5, rtol=2e-5)


def jstage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def tstage_fn(params, x):
    return torch.tanh(x.to(params["w"].dtype) @ params["w"] + params["b"])


def make_stages(n_stages, d, seed=0):
    """``tests/test_parallel_pp.py``'s stages, as numpy."""
    rng = np.random.RandomState(seed)
    return [{"w": (rng.randn(d, d) * 0.5).astype(np.float32),
             "b": (rng.randn(d) * 0.1).astype(np.float32)} for _ in range(n_stages)]


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def seq_grads(trees, x, loss_of_out, with_x=False):
    """``jax.grad`` of the sequential model over the stacked params (and
    ``x``): ``(loss, grads as numpy [n_stages, …][, dx])``."""
    stacked = jpp.stack_stages([jax.tree.map(jnp.asarray, t) for t in trees])

    def loss(p, xx):
        out = xx
        for i in range(len(trees)):
            out = jstage_fn(jax.tree.map(lambda a: a[i], p), out)
        return loss_of_out(out)

    val, (g, dx) = jax.value_and_grad(loss, argnums=(0, 1))(stacked, jnp.asarray(x))
    g = jax.tree.map(np.asarray, g)
    return (float(val), g, np.asarray(dx)) if with_x else (float(val), g)


def fake_mesh(rank=0, **axes):
    """A ``DeviceMesh`` over ``axes`` seen from ``rank``, with no process
    group (for the helpers that read only its shape and coordinate)."""
    from torch.distributed.device_mesh import DeviceMesh

    sizes = tmesh._axis_sizes(axes, int(np.prod(list(axes.values()))))
    grid = torch.arange(int(np.prod(list(sizes.values())))).reshape(
        [sizes[a] for a in tmesh.AXES])
    mesh = DeviceMesh("cpu", grid, mesh_dim_names=tmesh.AXES,
                      _init_backend=False, _rank=rank)
    mesh.tos_device = torch.device("cpu")
    return mesh


# -- no world ----------------------------------------------------------------

def test_stack_stages_and_stage_shardings_match_jax():
    """The stage-stacked layout and its placement: the same stack as the
    JAX package's, ``P("pp", None, …)`` per leaf, and a rank of a pp4 mesh
    keeping its own stage (leading dim 1)."""
    trees = make_stages(4, 8)
    jstacked = jpp.stack_stages([jax.tree.map(jnp.asarray, t) for t in trees])
    tstacked = tpp.stack_stages([{k: torch.from_numpy(v) for k, v in t.items()} for t in trees])
    for k in ("w", "b"):
        np.testing.assert_array_equal(tstacked[k].numpy(), np.asarray(jstacked[k]))
    nested = tpp.stack_stages([{"a": {"w": torch.ones(2)}}, {"a": {"w": torch.zeros(2)}}])
    assert nested["a"]["w"].shape == (2, 2)
    jspecs = jpp.stage_shardings(jmesh.make_mesh(jax.devices()[:4], pp=4), jstacked)
    for r in range(4):
        mesh = fake_mesh(rank=r, pp=4)
        shardings = tpp.stage_shardings(mesh, tstacked)
        for k in ("w", "b"):
            assert tuple(shardings[k].spec) == tuple(jspecs[k].spec)
        placed = tmesh.shard_tree(mesh, tstacked, shardings)
        for k in ("w", "b"):
            torch.testing.assert_close(placed[k], tstacked[k][r:r + 1], rtol=0, atol=0)
    from torch.distributed.tensor import Replicate, Shard

    assert shardings["w"].placements == [Replicate()] * 5 + [Shard(0)]
    with pytest.raises(ValueError, match="use stack_stages"):
        tpp.pipeline_1f1b(tstage_fn, {"w": tstacked["w"], "b": tstacked["b"][:3]},
                          torch.zeros(4, 8), lambda y: y.sum(), mesh=None, n_microbatches=2)
    with pytest.raises(ValueError, match="not divisible by n_microbatches"):
        tpp.gpipe(tstage_fn, tstacked, torch.zeros(6, 8), mesh=None, n_microbatches=4)


@pytest.mark.parametrize("s,m", [(2, 1), (2, 4), (3, 5), (4, 2), (4, 6)])
def test_1f1b_tick_table_matches_the_schedule(s, m):
    """Which stage runs which microbatch at which tick: forward ``k`` of
    stage ``i`` at ``t = i + 2k``, backward ``k`` at ``t = 2s - 1 - i +
    2k`` (``tensorflowonspark_tpu/parallel/pp.py:158-162``), over ``2(m +
    s) - 2`` ticks, the last backward at ``2(m + s) - 3``; every
    microbatch passes each stage once each way, and the result is still the
    sequential one."""
    d = 3
    trees = [{"w": torch.eye(d) * (1.0 + 0.1 * i), "i": torch.tensor(float(i))}
             for i in range(s)]
    stacked = tpp.stack_stages(trees)
    xs = torch.arange(m, dtype=torch.float32)[:, None, None].expand(m, 1, d).reshape(m, d)
    log, tick = [], [0]

    def stage_fn(p, x):
        i = int(p["i"])
        k = int(round(float(x[0, 0].detach()) / np.prod([1.0 + 0.1 * j for j in range(i)])))
        log.append((i, "bwd" if torch.is_grad_enabled() else "fwd", k, tick[0]))
        return x @ p["w"]

    stages = [tpp._Stage1F1B(stage_fn, tpp._stage(stacked, i), i, s, m, tpp._micro(xs, m),
                             None, lambda y: y.sum(), None, True) for i in range(s)]
    local = tpp._local_wires(stages)

    def wires(sends):
        tick[0] += 1
        return local(sends)

    tpp._run_ticks(stages, 2 * (m + s) - 2, wires)
    want = sorted([(i, "fwd", k, i + 2 * k) for i in range(s) for k in range(m)]
                  + [(i, "bwd", k, 2 * s - 1 - i + 2 * k) for i in range(s) for k in range(m)])
    assert sorted(log) == want
    assert max(t for *_, t in log) == 2 * (m + s) - 3 == tick[0] - 1
    scale = float(np.prod([1.0 + 0.1 * i for i in range(s)]))
    np.testing.assert_allclose(float(sum(st.loss_acc for st in stages)),
                               scale * d * float(xs.sum()) / d, rtol=1e-6)


@pytest.mark.parametrize("m", [6, 2])
def test_one_process_1f1b_matches_sequential_jax(m):
    """Every stage in one process (the card's driver) against ``jax.grad``
    of the sequential model: loss, stage grads and ``dx``, in steady state
    (m > s) and warm-up dominated (m < s)."""
    s, d, batch = 4, 8, 12
    trees = make_stages(s, d)
    x, y = randn(6, batch, d), randn(7, batch, d)
    l_seq, g_seq, dx_seq = seq_grads(trees, x, lambda o: jnp.mean((o - y) ** 2), with_x=True)
    stacked = tpp.stack_stages([{k: torch.from_numpy(v) for k, v in t.items()} for t in trees])
    loss, grads, dx = tpp.pipeline_1f1b(
        tstage_fn, stacked, torch.from_numpy(x), lambda o, t: ((o - t) ** 2).mean(),
        mesh=tmesh.make_mesh("cpu"), n_microbatches=m, targets=torch.from_numpy(y),
        with_input_grad=True)
    np.testing.assert_allclose(float(loss), l_seq, rtol=1e-5)
    for k in ("w", "b"):
        assert grads[k].shape == (s,) + trees[0][k].shape
        np.testing.assert_allclose(grads[k].numpy(), g_seq[k], **TOL)
    np.testing.assert_allclose(dx.numpy(), dx_seq, **TOL)


def jax_lm(n_layers=4, **over):
    cfg = dict(vocab_size=32, d_model=16, n_layers=n_layers, n_heads=4, bf16=False, **over)
    model = jtfm.build_transformer({**cfg, "attn_impl": "xla"})
    ids = np.random.RandomState(0).randint(0, 32, (8, 6)).astype(np.int32)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"])
    return cfg, model, params, ids


@pytest.mark.parametrize("vocab_chunk", [0, 8])
def test_pipelined_lm_matches_jax_full_model_grads(vocab_chunk):
    """``train_lm.PipelinedLM`` in one process (2 stages of 2 blocks, 4
    microbatches; kernel attention routing, the plain version on the CPU)
    against ``jax.grad`` of the JAX package's whole-model LM loss: the
    loss, every block's gradient, the head's and the embedding's (from
    ``dx``), dense and with the blockwise head."""
    from examples_torch.llm.train_lm import PipelinedLM

    cfg, jmodel, params, ids = jax_lm()
    (l_ref, _), g_ref = jax.value_and_grad(jtfm.make_loss_fn(jmodel, vocab_chunk=vocab_chunk),
                                           has_aux=True)(params, {"input_ids": jnp.asarray(ids)})
    g_ref = convert.flax_to_torch(jax.tree.map(np.asarray, g_ref))
    model = ttfm.build_transformer({**cfg, "attn_impl": "auto"})
    model.load_state_dict(convert.flax_to_torch(params))
    lm = PipelinedLM(model, tmesh.make_mesh("cpu"), 2, 4, vocab_chunk=vocab_chunk)
    loss, grads = lm.loss_and_grads(torch.from_numpy(ids))
    np.testing.assert_allclose(float(loss), float(l_ref), rtol=1e-5)
    for name, g in grads["stages"].items():
        _, j, rest = name.split(".", 2)
        for i in range(2):
            np.testing.assert_allclose(g[i].numpy(), g_ref[f"blocks.{2 * i + int(j)}.{rest}"].numpy(),
                                       **BLOCK_TOL, err_msg=f"stage {i} {name}")
    for name, g in grads["head"].items():
        np.testing.assert_allclose(g.numpy(), g_ref[name].numpy(), **BLOCK_TOL, err_msg=name)
    np.testing.assert_allclose(grads["embed"].numpy(), g_ref["embed.weight"].numpy(), **BLOCK_TOL)


def test_stages_to_torch_matches_flax_to_torch():
    """``convert.stages_to_torch`` of the JAX ``stack_stages`` tree is
    ``flax_to_torch``'s blocks, stacked by stage."""
    _, _, params, _ = jax_lm()
    whole = convert.flax_to_torch(params)
    stacked = convert.stages_to_torch(jax_stacked(params))
    assert len(stacked) == 9 * 2  # 9 leaves a block, 2 blocks a stage
    for name, t in stacked.items():
        _, j, rest = name.split(".", 2)
        for i in range(2):
            torch.testing.assert_close(t[i], whole[f"blocks.{2 * i + int(j)}.{rest}"],
                                       rtol=0, atol=0)


def jax_stacked(params, n_stages=2, per_stage=2):
    """The JAX tests' stage-stacked tree of blocks (stacked twice)."""
    def stage_tree(i):
        return jax.tree.map(lambda *xs: np.stack(xs),
                            *(params[f"block_{i * per_stage + j}"] for j in range(per_stage)))

    return jax.tree.map(np.asarray, jpp.stack_stages([stage_tree(i) for i in range(n_stages)]))


# -- one gloo world of 4 ranks for the module ---------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _block_refs():
    """The JAX tests' transformer (4 layers, 2 stages × 2 blocks), its
    head loss and references."""
    import flax.linen as nn

    _, model, params, ids = jax_lm()
    tgt = np.random.RandomState(1).randint(0, 32, (8, 6)).astype(np.int32)
    embed = nn.Embed(32, 16, dtype=jnp.float32)
    h_in = embed.apply({"params": params["embed"]}, ids)

    def head_loss(h, tgt_mb):
        final = jtfm.RMSNorm().apply({"params": params["final_norm"]}, h)
        logits = nn.Dense(32, use_bias=False).apply(
            {"params": params["lm_head"]}, final).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, tgt_mb[..., None], axis=-1))

    block = jtfm.Block(n_heads=4, d_head=4, d_ff=64, attn_impl="xla", compute_dtype=jnp.float32)

    def pipe_stage(p, x):
        for j in range(2):
            x = block.apply({"params": jax.tree.map(lambda a: a[j], p)}, x)
        return x

    return model, params, ids, tgt, h_in, head_loss, pipe_stage


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The transformer's weights converted from the JAX package's params,
    then the 4 ranks of ``tests/torch_pp_worker.py``; returns ``(outputs by
    rank, errors by case)``."""
    work = tmp_path_factory.mktemp("pp_world")
    model, params, ids, tgt, *_ = _block_refs()
    ref = np.asarray(model.apply({"params": params}, ids))
    torch.save({"stacked": convert.stages_to_torch(jax_stacked(params)),
                "head": {"final_norm.scale": torch.tensor(params["final_norm"]["scale"]),
                         "lm_head.weight": torch.from_numpy(
                             np.ascontiguousarray(params["lm_head"]["kernel"].T))},
                "embed": torch.tensor(params["embed"]["embedding"]),
                "ids": torch.from_numpy(ids), "tgt": torch.from_numpy(tgt),
                "logit_tgt": torch.from_numpy(randn(1, *ref.shape))}, work / "blocks.pt")
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_pp_worker.py"),
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
    base = re.sub(r"_m\d+$", "", case)
    if base in errors:
        pytest.fail(errors[base])
    return outs[rank][f"{case}/{key}"]


# pp=4: rank r is stage r; dp=2 × pp=2: rank r is dp row r // 2, stage r % 2
def dp2_pp2(r):
    return r // 2, r % 2


def jsequential(trees, x):
    out = jnp.asarray(x)
    for t in trees:
        out = jstage_fn(jax.tree.map(jnp.asarray, t), out)
    return np.asarray(out)


def test_gpipe_matches_sequential(world):
    """pp=4 over 16 rows in 4 microbatches, and dp=2 × pp=2 (each dp row
    its 8 rows), against the sequential model; the latter also against the
    JAX package's ``gpipe`` on a pp2 × dp2 mesh of CPU devices."""
    x = randn(1, 16, 8)
    ref = jsequential(make_stages(4, 8), x)
    for r in range(WORLD):
        np.testing.assert_allclose(got(world, "gpipe_pp4", "out", r), ref, **TOL)
    trees = make_stages(2, 8)
    ref2 = jsequential(trees, x)
    jout = np.asarray(jpp.gpipe(jstage_fn, jpp.stack_stages(
        [jax.tree.map(jnp.asarray, t) for t in trees]), jnp.asarray(x),
        mesh=jmesh.make_mesh(jax.devices()[:4], pp=2, dp=2), n_microbatches=4))
    for r in range(WORLD):
        row, _ = dp2_pp2(r)
        out = got(world, "gpipe_pp2_dp2", "out", r)
        np.testing.assert_allclose(out, ref2[row * 8:][:8], **TOL)
        np.testing.assert_allclose(out, jout[row * 8:][:8], **TOL)


def test_gpipe_microbatch_count_independent(world):
    ref = jsequential(make_stages(4, 4), randn(2, 24, 4))
    for m in (2, 4, 8, 12):
        for r in range(WORLD):
            np.testing.assert_allclose(got(world, "gpipe_microbatches", f"m{m}", r), ref, **TOL)


def test_gpipe_with_params_placed_by_stage_shardings(world):
    """The counterpart of ``test_gpipe_under_jit_with_sharded_params``: each
    rank holds only its stage (leading dim 1), as ``stage_shardings``
    places it."""
    trees = make_stages(4, 8)
    ref = jsequential(trees, randn(3, 8, 8))
    for r in range(WORLD):
        assert tuple(got(world, "gpipe_placed", "local_shape", r)) == (1, 8, 8)
        np.testing.assert_array_equal(got(world, "gpipe_placed", "local_w", r), trees[r]["w"])
        np.testing.assert_allclose(got(world, "gpipe_placed", "out", r), ref, **TOL)


def test_gpipe_gradients_descend(world):
    """10 Adam steps (lr 1e-2) of each stage through the pipeline: the loss
    falls by 10%, along the JAX package's trajectory (``optax.adam``
    through ``jax.grad`` of the sequential model)."""
    losses = got(world, "gpipe_descend", "losses")
    assert losses[-1] < losses[0] * 0.9
    trees = make_stages(4, 8)
    x, y = randn(4, 16, 8), randn(5, 16, 8)
    params = jpp.stack_stages([jax.tree.map(jnp.asarray, t) for t in trees])

    def loss(p):
        out = jnp.asarray(x)
        for i in range(4):
            out = jstage_fn(jax.tree.map(lambda a: a[i], p), out)
        return jnp.mean((out - y) ** 2)

    opt = optax.adam(1e-2)
    state = opt.init(params)
    want = []
    for _ in range(10):
        val, g = jax.value_and_grad(loss)(params)
        want.append(float(val))
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    np.testing.assert_allclose(losses, want, rtol=1e-4)


def test_gpipe_gradients_match_sequential(world):
    trees = make_stages(4, 8)
    x = randn(4, 8, 8)
    _, g_seq = seq_grads(trees, x, lambda o: jnp.sum(o ** 2))
    for r in range(WORLD):
        for k in ("w", "b"):
            np.testing.assert_allclose(got(world, "gpipe_grads", f"grad/{k}", r), g_seq[k][r],
                                       **GPIPE_GRAD_TOL)
        assert float(got(world, "gpipe_grads", "others", r)) == 0.0  # only its own stage


@pytest.mark.parametrize("m", [6, 2])
def test_1f1b_loss_and_grads_match_sequential(world, m):
    """Steady state (m > s) and warm-up dominated (m < s) at pp=4, against
    the sequential model and the JAX package's ``pipeline_1f1b``."""
    trees = make_stages(4, 8)
    x, y = randn(6, 12, 8), randn(7, 12, 8)
    l_seq, g_seq = seq_grads(trees, x, lambda o: jnp.mean((o - y) ** 2))
    jloss, jgrads = jpp.pipeline_1f1b(
        jstage_fn, jpp.stack_stages([jax.tree.map(jnp.asarray, t) for t in trees]),
        jnp.asarray(x), lambda o, t: jnp.mean((o - t) ** 2),
        mesh=jmesh.make_mesh(jax.devices()[:4], pp=4), n_microbatches=m, targets=jnp.asarray(y))
    case = f"f1b_pp4_m{m}"
    for r in range(WORLD):
        np.testing.assert_allclose(float(got(world, case, "loss", r)), l_seq, rtol=1e-5)
        np.testing.assert_allclose(float(got(world, case, "loss", r)), float(jloss), rtol=1e-5)
        assert int(got(world, case, "grad_lead", r)) == 1
        for k in ("w", "b"):
            np.testing.assert_allclose(got(world, case, f"grad/{k}", r), g_seq[k][r], **TOL)
            np.testing.assert_allclose(got(world, case, f"grad/{k}", r),
                                       np.asarray(jgrads[k])[r], **TOL)


def test_1f1b_composes_with_dp(world):
    """dp=2 × pp=2: each dp row pipelines its rows; the averaged loss and
    grads equal the sequential model's over the whole batch, and ``dx`` is
    ``d(dp-averaged loss)/dx`` (the 1/dp normalisation)."""
    trees = make_stages(2, 8, seed=21)
    x, y = randn(22, 16, 8), randn(23, 16, 8)
    l_seq, g_seq, dx_seq = seq_grads(trees, x, lambda o: jnp.mean((o - y) ** 2), with_x=True)
    for r in range(WORLD):
        row, stage = dp2_pp2(r)
        np.testing.assert_allclose(float(got(world, "f1b_dp", "loss", r)), l_seq, rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(got(world, "f1b_dp", f"grad/{k}", r), g_seq[k][stage], **TOL)
        np.testing.assert_allclose(got(world, "f1b_dp", "dx", r), dx_seq[row * 8:][:8], atol=1e-5)


def test_1f1b_bf16_activation_wire(world):
    """bf16 ``x``: the forward wire rides bf16 and the gradient wire f32
    (the dtypes every rank handed to its sends), and the loss and grads sit
    near the f32 sequential reference at bf16's tolerance."""
    assert set(got(world, "f1b_bf16", "wires")) == {"torch.bfloat16", "torch.float32"}
    trees = make_stages(4, 8, seed=31)
    y = randn(33, 16, 8)
    l_seq, g_seq = seq_grads(trees, randn(32, 16, 8), lambda o: jnp.mean((o - y) ** 2))
    for r in range(WORLD):
        np.testing.assert_allclose(float(got(world, "f1b_bf16", "loss", r)), l_seq, rtol=0.05)
        for k in ("w", "b"):
            np.testing.assert_allclose(got(world, "f1b_bf16", f"grad/{k}", r), g_seq[k][r],
                                       atol=0.05, rtol=0.1)


def test_1f1b_without_targets(world):
    """``loss_fn`` sees only the final activations: the mean over
    microbatches of per-microbatch sums (microbatches of 2 rows, as the JAX
    test's), averaged over the dp rows."""
    trees = make_stages(2, 4, seed=3)
    l_seq, g_seq = seq_grads(trees, randn(8, 8, 4), lambda o: jnp.sum(o ** 2) / 4)
    for r in range(WORLD):
        _, stage = dp2_pp2(r)
        np.testing.assert_allclose(float(got(world, "f1b_no_targets", "loss", r)), l_seq,
                                   rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(got(world, "f1b_no_targets", f"grad/{k}", r),
                                       g_seq[k][stage], **TOL)


def test_1f1b_transformer_blocks_match_sequential(world):
    """Transformer ``Block``s as stages (2 × 2 blocks, kernel-routed
    attention, the plain version on the CPU), the head folded into
    ``loss_fn``: loss and block gradients against ``jax.grad`` of the JAX
    package's sequential decomposition (``attn_impl="xla"``)."""
    _, params, _, tgt, h_in, head_loss, pipe_stage = _block_refs()
    stacked = jpp.stack_stages([jax.tree.map(lambda *xs: jnp.stack(xs), *(
        params[f"block_{i * 2 + j}"] for j in range(2))) for i in range(2)])

    def seq_loss(s):
        h = h_in
        for i in range(2):
            h = pipe_stage(jax.tree.map(lambda a: a[i], s), h)
        return head_loss(h, tgt)

    l_seq, g_seq = jax.value_and_grad(seq_loss)(stacked)
    g_seq = convert.stages_to_torch(jax.tree.map(np.asarray, g_seq))
    for r in range(WORLD):
        _, stage = dp2_pp2(r)
        np.testing.assert_allclose(float(got(world, "f1b_blocks", "loss", r)), float(l_seq),
                                   rtol=1e-5)
        for name, g in g_seq.items():
            np.testing.assert_allclose(got(world, "f1b_blocks", f"grad/{name}", r),
                                       g[stage].numpy(), **BLOCK_TOL, err_msg=name)


def test_1f1b_full_model_head_and_input_grads(world):
    """The head outside the pipe trains through ``head_params`` and the
    embedding through ``dx``: every parameter of the full model gets the
    sequential gradient."""
    s, d, batch = 2, 6, 8
    rng = np.random.RandomState(12)
    trees = make_stages(s, d, seed=12)
    head = {"w_out": jnp.asarray(rng.randn(d, 3) * 0.5, jnp.float32)}
    emb = jnp.asarray(rng.randn(5, d) * 0.5, jnp.float32)
    ids = jnp.asarray(rng.randint(0, 5, (batch,)), jnp.int32)
    tgt = jnp.asarray(rng.randint(0, 3, (batch,)), jnp.int32)
    stacked = jpp.stack_stages([jax.tree.map(jnp.asarray, t) for t in trees])

    def seq_loss(stages, hp, e):
        h = e[ids]
        for i in range(s):
            h = jstage_fn(jax.tree.map(lambda a: a[i], stages), h)
        logp = jax.nn.log_softmax(h @ hp["w_out"])
        return -jnp.mean(jnp.take_along_axis(logp, tgt[:, None], axis=1))

    l_ref = float(seq_loss(stacked, head, emb))
    gs, gh, ge = jax.grad(seq_loss, argnums=(0, 1, 2))(stacked, head, emb)
    for r in range(WORLD):
        _, stage = dp2_pp2(r)
        np.testing.assert_allclose(float(got(world, "f1b_full_model", "loss", r)), l_ref,
                                   rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(got(world, "f1b_full_model", f"grad/{k}", r),
                                       np.asarray(gs[k])[stage], atol=1e-5)
        np.testing.assert_allclose(got(world, "f1b_full_model", "head", r),
                                   np.asarray(gh["w_out"]), atol=1e-5)
        np.testing.assert_allclose(got(world, "f1b_full_model", "emb", r), np.asarray(ge),
                                   atol=1e-5)


def test_gpipe_transformer_blocks_match_sequential(world):
    """Transformer ``Block``s as gpipe stages, embedding and head outside
    the pipe: the JAX package's whole-model logits, and gradients reaching
    every block's parameters."""
    model, params, ids, *_ = _block_refs()
    ref = np.asarray(model.apply({"params": params}, ids))
    for r in range(WORLD):
        row, _ = dp2_pp2(r)
        np.testing.assert_allclose(got(world, "gpipe_blocks", "logits", r), ref[row * 4:][:4],
                                   **BLOCK_TOL)
        norms = got(world, "gpipe_blocks", "norms", r)
        assert len(norms) == 18 and (norms > 0).all(), norms


# -- train_lm.py --pp end to end ----------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--vocab-chunk", "128", "--bf16"]],
                         ids=["dense", "fused-bf16"])
def test_train_lm_pp_example_end_to_end(extra):
    """``train_lm.py --pp 2`` over 2 gloo ranks trains a pipelined LM: the
    loss descends by 10% over 5 steps (stages, head and embedding all
    updated through the 1F1B grads)."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-port", str(_free_port()),
         str(REPO / "examples_torch" / "llm" / "train_lm.py"), "--device", "cpu",
         "--pp", "2", "--n-layers", "4", "--d-model", "64", "--n-heads", "4",
         "--seq-len", "128", "--batch", "16", "--steps", "5", "--vocab-size", "256"] + extra,
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    losses = [float(v) for v in re.findall(r"loss=([0-9.]+)", proc.stdout)]
    assert len(losses) == 2, proc.stdout
    assert losses[1] < losses[0] * 0.9, proc.stdout


def test_chip_smoke_pp_and_sharded_scoring_phases_run_on_cpu(monkeypatch, tmp_path):
    """``chip_smoke.py``'s two phases of this slice, shrunk to 4 layers of
    width 32 and 16 tokens, on the CPU (no kernel: 0 launches expected):
    the pipelined step against the sequential one and against plain
    attention, its f32 run, and sharded against task scoring of an LM
    bundle through one-node clusters."""
    import chip_smoke as cs
    from tensorflowonspark_torch.checkpoint import export_bundle

    cfg = {"model": "transformer", "vocab_size": 64, "d_model": 32, "n_layers": 4,
           "n_heads": 4, "bf16": True, "attn_impl": "auto"}
    monkeypatch.setattr(cs, "WORK_DIR", str(tmp_path))
    monkeypatch.setattr(cs, "LM_CONFIG", cfg)
    monkeypatch.setattr(cs, "SEQ_LEN", 16)
    export_bundle(str(tmp_path / "lm_bundle"), cs.make_lm_params(cfg, 0), cfg)
    pp = cs.phase_pp(0, "cpu", device="cpu")
    assert pp["launches"] == 0 and pp["bubble"] == 3 / 7
    assert max(pp["grad_rel_err"].values()) < cs.GRAD_REL_TOL
    assert max(pp["f32"]["grad_rel_err"].values()) < cs.PP_F32_TOL
    scoring = cs.phase_sharded_scoring(0, "cpu", device="cpu")
    assert scoring["launches"] == 0 and set(scoring) == {"sharded", "task", "launches"}
