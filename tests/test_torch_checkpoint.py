"""The port's training checkpoints (``tensorflowonspark_torch.checkpoint``),
restating ``tests/test_checkpoint.py``: round trip, keep-newest, a
``hopsfs://`` model_dir, async commit-and-restore, async keep-newest, and a
full-state resume — held against the JAX package's ``optax.sgd`` run on the
same numpy batches — plus what the commit by rename guarantees."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_torch import checkpoint as ckpt
from tensorflowonspark_torch.parallel import dp
from tensorflowonspark_torch.utils.paths import register_fs_root
from tensorflowonspark_tpu.parallel import dp as jdp
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate


def tree():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": np.ones((), np.float32), "step": 3}


def test_save_restore_roundtrip(tmp_path):
    path = str(tmp_path / "c1")
    ckpt.save_checkpoint(path, tree())
    out = ckpt.restore_checkpoint(path)
    torch.testing.assert_close(out["w"], tree()["w"])
    assert isinstance(out["b"], np.ndarray) and out["b"] == 1.0
    assert out["step"] == 3
    # restore against a target of the same structure passes the checks
    assert ckpt.restore_checkpoint(path, tree())["step"] == 3


@pytest.mark.parametrize("async_save", [False, True])
def test_manager_keeps_newest(tmp_path, async_save):
    """The keep-K window, with synchronous saves and with async ones (where
    it must count the save still in flight)."""
    mgr = ckpt.CheckpointManager(str(tmp_path / "m"), max_to_keep=2,
                                 async_save=async_save)
    for s in [1, 5, 9]:
        mgr.save(s, {"s": torch.tensor(s)})
    mgr.wait()
    assert sorted(os.listdir(tmp_path / "m")) == ["step_5", "step_9"]
    restored, step = mgr.restore_latest()
    assert step == 9 and int(restored["s"]) == 9


def test_hdfs_scheme(tmp_path):
    register_fs_root("hopsfs", str(tmp_path))
    mgr = ckpt.CheckpointManager("hopsfs://nn/models/x")
    mgr.save(3, tree())
    restored, step = mgr.restore_latest()
    assert step == 3
    assert ckpt.latest_step_dir("hopsfs://nn/models/x") == "hopsfs://nn/models/x/step_3"
    assert os.path.isdir(tmp_path / "models" / "x" / "step_3")


def test_async_save_commits_and_restores_a_snapshot(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "a"), async_save=True)
    state = tree()
    mgr.save(7, state)
    state["w"].add_(100.0)  # the train loop goes on updating its tensors
    # restore_latest must first wait for the in-flight commit
    restored, step = mgr.restore_latest()
    assert step == 7
    torch.testing.assert_close(restored["w"], tree()["w"])


def test_shape_mismatch_raises_naming_the_checkpoint(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "s"), async_save=False)
    mgr.save(1, {"w": torch.zeros(4, 3), "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape") as err:
        mgr.restore_latest({"w": torch.zeros(4, 2), "b": torch.zeros(3)})
    assert "step_1" in str(err.value)
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore_latest({"w": torch.zeros(4, 3)})


KILLED_SAVE = """
import os, sys, torch
from tensorflowonspark_torch import checkpoint as ckpt
mgr = ckpt.CheckpointManager(sys.argv[1], async_save=sys.argv[2] == "async")
mgr.save(1, {"w": torch.ones(3)})
mgr.wait()
os.replace = lambda src, dst: os._exit(9)  # the process dies before the commit
mgr.save(2, {"w": torch.zeros(3)})
mgr.wait()
"""


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_save_killed_before_commit_leaves_no_step_dir(tmp_path, mode):
    """A process killed between writing a checkpoint and its commit rename
    leaves its temporary directory behind, and no ``step_N``: the newest
    committed checkpoint is still the latest one."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model_dir = str(tmp_path / "k")
    res = subprocess.run([sys.executable, "-c", KILLED_SAVE, model_dir, mode],
                         cwd=root, capture_output=True, text=True, timeout=120)
    assert res.returncode == 9, res.stderr
    left = sorted(os.listdir(model_dir))
    assert "step_1" in left and "step_2" not in left
    assert any(n.startswith(".step_2.tmp") for n in left), left  # the torn write
    assert ckpt.latest_step_dir(model_dir).endswith("step_1")
    restored, step = ckpt.CheckpointManager(model_dir).restore_latest()
    assert step == 1 and torch.equal(restored["w"], torch.ones(3))


def test_async_writer_error_is_raised_by_wait(tmp_path, monkeypatch):
    mgr = ckpt.CheckpointManager(str(tmp_path / "e"), async_save=True)

    def refused(src, dst):
        raise OSError("disk refused the commit")

    monkeypatch.setattr(ckpt.os, "replace", refused)
    mgr.save(1, tree())
    with pytest.raises(RuntimeError, match="disk refused the commit"):
        mgr.wait()
    monkeypatch.undo()
    mgr.wait()  # raised once, then cleared
    assert ckpt.latest_step_dir(str(tmp_path / "e")) is None
    mgr.save(2, tree())
    assert mgr.restore_latest()[1] == 2


def _batches():
    rng = np.random.RandomState(0)
    return [{"x": rng.rand(8, 4).astype(np.float32),
             "y": rng.rand(8, 1).astype(np.float32)} for _ in range(10)]


def _loss_fn(model, batch):
    pred = model(batch["x"])
    return torch.mean((pred - batch["y"]) ** 2), {}


def _fresh_state():
    model = torch.nn.Linear(4, 1, bias=False)
    with torch.no_grad():
        model.weight.fill_(1.0)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    return dp.TrainState.create(model, optimizer)


def _run(state, batches):
    step = dp.make_train_step(_loss_fn, state.optimizer)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return state, losses


def test_full_state_resume_matches_uninterrupted(tmp_path):
    """A restart from a full-train-state checkpoint (params + optimizer
    state + step) continues the exact loss trajectory of an uninterrupted
    run — momentum survives — and that trajectory is JAX's
    ``optax.sgd(0.1, momentum=0.9)`` on the same batches.  A params-only
    restore does not continue it."""
    batches = _batches()
    _, losses_a = _run(_fresh_state(), batches)

    # the JAX package's step on the same numpy batches
    def jloss(params, batch):
        return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2), {}

    jstate = jdp.TrainState.create({"w": jnp.ones((4, 1), jnp.float32)},
                                   optax.sgd(0.1, momentum=0.9))
    jstep = jdp.make_train_step(jloss, optax.sgd(0.1, momentum=0.9), donate=False)
    jlosses = []
    for b in batches:
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, b))
        jlosses.append(float(m["loss"]))
    np.testing.assert_allclose(losses_a, jlosses, rtol=1e-5)

    # 5 steps, full-state save, "process death", restore, 5 more
    mgr = ckpt.CheckpointManager(str(tmp_path / "resume"))
    state_b, _ = _run(_fresh_state(), batches[:5])
    mgr.save(state_b.step, state_b.tree())
    mgr.wait()
    del state_b
    fresh = _fresh_state()
    restored, step = ckpt.CheckpointManager(str(tmp_path / "resume")).restore_latest(
        fresh.tree())
    assert step == 5
    resumed = fresh.restore(restored)
    assert resumed.step == 5
    _, losses_b = _run(resumed, batches[5:])
    np.testing.assert_allclose(losses_b, losses_a[5:], rtol=1e-5)

    # params-only restore loses momentum: the trajectory measurably diverges
    partial = _fresh_state()
    partial.model.load_state_dict(restored["model"])
    _, losses_c = _run(partial, batches[5:])
    assert not np.allclose(losses_c, losses_a[5:], rtol=1e-5)


# -- exported programs (the JAX package's export_stablehlo) -----------------

def test_program_export_consumable_without_package(tmp_path):
    """``tests/test_checkpoint.py``'s StableHLO interop test against
    ``export_program``: the JAX package's MNIST weights (``init_params``)
    exported as a ``torch.export`` program reload and score in a process
    that imports neither package, equal to the JAX ``model.apply`` within
    1e-5, at batch sizes 1 and 5 through one dynamic-batch program."""
    import subprocess
    import sys

    from tensorflowonspark_tpu.models import mnist as jmnist

    config = {"model": "mnist_cnn", "num_classes": 10, "features": [4, 8],
              "dense": 16}
    model = jmnist.build_mnist(config)
    params = jmnist.init_params(model, jax.random.PRNGKey(0))
    ckpt.export_program(str(tmp_path), jax.device_get(params), config,
                        input_shape=(28, 28, 1), device="cpu")
    meta = json.loads((tmp_path / "program.json").read_text())
    assert meta == {"model_config": config, "device": "cpu", "input_shape": [28, 28, 1],
                    "input_dtype": "float32", "batch_polymorphic": True,
                    "ops": [], "op_module": None, "op_routes": {}}

    x = np.random.RandomState(0).rand(5, 28, 28, 1).astype(np.float32)
    expected = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    np.save(tmp_path / "x.npy", x)
    consumer = (
        "import sys, numpy as np, torch\n"
        "def ours():\n"
        "    return [m for m in sys.modules if m.startswith(('tensorflowonspark', 'jax'))]\n"
        "assert not ours(), ours()\n"
        f"prog = torch.export.load(r'{tmp_path}/model.pt2').module()\n"
        f"x = torch.from_numpy(np.load(r'{tmp_path}/x.npy'))\n"
        "with torch.no_grad():\n"
        "    one, five = prog(x[:1]), prog(x)\n"
        "assert not ours(), ours()\n"
        f"np.save(r'{tmp_path}/one.npy', one.numpy())\n"
        f"np.save(r'{tmp_path}/five.npy', five.numpy())\n"
    )
    subprocess.run([sys.executable, "-c", consumer], check=True, timeout=180,
                   cwd=str(tmp_path))
    np.testing.assert_allclose(np.load(tmp_path / "five.npy"), expected, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.load(tmp_path / "one.npy"), expected[:1],
                               rtol=1e-5, atol=1e-5)


def _random_state(model, seed):
    """Every parameter and persistent buffer of ``model`` drawn from a seed
    (running variances positive)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if not t.is_floating_point():
                continue
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)


def _family_input(name, b):
    rng = np.random.RandomState(b)
    if name == "transformer":
        return rng.randint(0, 64, (b, 16)).astype(np.int32)
    if name == "wide_deep":
        from tensorflowonspark_torch.models import wide_deep as twd

        return twd.batch_to_arrays(twd.synthetic_criteo(b, seed=b))["features"]
    shape = {"linear": (6,), "mnist_cnn": (28, 28, 1), "resnet_cifar": (32, 32, 3),
             "inception_v3": (75, 75, 3)}[name]
    return rng.rand(b, *shape).astype(np.float32)


FAMILIES = {
    "transformer": {"model": "transformer", "vocab_size": 64, "d_model": 32,
                    "n_layers": 2, "n_heads": 4, "bf16": False},
    "linear": {"model": "linear", "in_dim": 6, "out_dim": 3},
    "mnist_cnn": {"model": "mnist_cnn", "num_classes": 10, "features": [4, 8], "dense": 16},
    "resnet_cifar": {"model": "resnet_cifar", "depth_blocks": 1, "width": 8,
                     "num_classes": 10, "bf16": False},
    "inception_v3": {"model": "inception_v3", "num_classes": 10, "bf16": False},
    "wide_deep": {"model": "wide_deep", "vocab_size": 1009, "embed_dim": 4,
                  "hidden": [8, 4], "bf16": False},
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_every_family_exports_on_the_cpu(tmp_path, name):
    """On the CPU every family exports through its plain path (the LM's
    attention included), and the program's outputs at batch sizes 2 and 3
    equal ``build_apply``'s on the same weights (f32, 1e-5)."""
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.models import registry

    config = FAMILIES[name]
    model = registry.build(config)
    _random_state(model, 0)
    params = torch_to_flax(model.state_dict(), n_heads=config.get("n_heads"), config=config)
    x2 = _family_input(name, 2)
    ckpt.export_program(str(tmp_path), params, config, input_shape=x2.shape[1:],
                        input_dtype=x2.dtype, device="cpu")
    program = torch.export.load(str(tmp_path / "model.pt2")).module()
    apply = registry.build_apply(config, device="cpu")
    for x in (x2, _family_input(name, 3)):
        with torch.no_grad():
            got = program(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), apply(params, x).numpy(),
                                   rtol=1e-5, atol=1e-5)


LM = FAMILIES["transformer"]
MOE = {**LM, "n_experts": 4, "moe_top_k": 2}
# the MoE LM against the JAX package's fixed-batch artifact: f32 sums in
# other orders through two layers (tests/test_torch_moe.py's bound)
MOE_TOL = dict(atol=2e-5, rtol=2e-5)


def _jax_lm(config, seed, ids):
    from tensorflowonspark_tpu.models import transformer as jtfm

    jmodel = jtfm.build_transformer(config)
    return jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed), ids)["params"])


def _jax_program(tmp_path, params, config, input_shape, batch_polymorphic=True):
    """``export_stablehlo``'s artifact on the CPU, deserialized."""
    from jax import export as jexport

    from tensorflowonspark_tpu import checkpoint as jckpt

    path = str(tmp_path / "stablehlo")
    jckpt.export_stablehlo(path, params, config, input_shape, input_dtype=jnp.int32,
                           batch_polymorphic=batch_polymorphic, platforms=("cpu",))
    with open(os.path.join(path, "model.stablehlo"), "rb") as f:
        return jexport.deserialize(f.read())


def _op_calls(path) -> int:
    program = torch.export.load(os.path.join(path, "model.pt2"))
    return sum(n.target is torch.ops.tos.flash_attn_fwd.default
               for n in program.graph.nodes)


def test_lm_program_calls_the_op_and_scores_like_jax_in_a_fresh_process(tmp_path):
    """The tiny f32 LM exported on the CPU with a dynamic batch: its graph
    calls ``tos::flash_attn_fwd`` once per layer, ``program.json`` names the
    op, its module and the route the card would take (f32 at head dim 8:
    the 3xTF32 kernel at 64), and a fresh process that imports only torch,
    numpy and that module scores batches 2 and 3 as the JAX package's
    ``export_stablehlo`` artifact does on the same weights (f32, 1e-5)."""
    import subprocess
    import sys

    ids = np.random.RandomState(0).randint(0, 64, (3, 16)).astype(np.int32)
    params = _jax_lm(LM, 0, ids)
    out = str(tmp_path / "program")
    ckpt.export_program(out, params, LM, input_shape=(16,), input_dtype=np.int32,
                        device="cpu")
    meta = json.loads((tmp_path / "program" / "program.json").read_text())
    assert meta["batch_polymorphic"] is True and meta["ops"] == ["tos::flash_attn_fwd"]
    assert meta["op_module"] == "tensorflowonspark_torch.ops.attention"
    assert meta["op_routes"] == {"tos::flash_attn_fwd": [
        {"kernel": "flash_attn_fwd_tf32", "padded_head_dim": 8, "nodes": LM["n_layers"]}]}
    assert _op_calls(out) == LM["n_layers"]

    np.save(tmp_path / "ids.npy", ids)
    consumer = (
        "import importlib, json, sys, numpy as np, torch\n"
        f"meta = json.load(open(r'{out}/program.json'))\n"
        "importlib.import_module(meta['op_module'])\n"
        "assert not [m for m in sys.modules if m.startswith(('jax', 'tensorflowonspark_tpu'))]\n"
        f"prog = torch.export.load(r'{out}/model.pt2').module()\n"
        f"ids = torch.from_numpy(np.load(r'{tmp_path}/ids.npy'))\n"
        "with torch.no_grad():\n"
        "    two, three = prog(ids[:2]), prog(ids)\n"
        f"np.savez(r'{tmp_path}/got.npz', two=two.numpy(), three=three.numpy())\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", consumer], check=True, timeout=180,
                   cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": repo})
    want = np.asarray(_jax_program(tmp_path, params, LM, (16,)).call(jnp.asarray(ids)))
    got = np.load(tmp_path / "got.npz")
    np.testing.assert_allclose(got["three"], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["two"], want[:2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bf16, kernel", [(False, "flash_attn_fwd_tf32"),
                                          (True, "flash_attn_fwd")])
def test_program_json_names_the_route_at_the_exported_type(tmp_path, bf16, kernel):
    """``program.json`` records ``ops.attention._route`` at the exported
    type and head dim: the bf16 LM at head dim 8 runs the wgmma kernel at
    8, the f32 LM the 3xTF32 kernel at 8 (each on its 32-column tile, no
    padding); the program equals
    ``build_apply`` on the same weights (bf16 exactly: same ops, one
    process)."""
    from tensorflowonspark_torch.models import registry
    from tensorflowonspark_torch.ops import attention

    config = {**LM, "bf16": bf16}
    ids = np.random.RandomState(1).randint(0, 64, (2, 16)).astype(np.int32)
    params = _jax_lm(LM, 1, ids)
    ckpt.export_program(str(tmp_path), params, config, input_shape=(16,),
                        input_dtype=np.int32, device="cpu")
    meta = json.loads((tmp_path / "program.json").read_text())
    assert attention._route(torch.bfloat16 if bf16 else torch.float32, 8) == (kernel, 8)
    assert meta["op_routes"]["tos::flash_attn_fwd"] == [
        {"kernel": kernel, "padded_head_dim": 8, "nodes": LM["n_layers"]}]
    program = torch.export.load(str(tmp_path / "model.pt2")).module()
    with torch.no_grad():
        got = program(torch.from_numpy(ids))
    want = registry.build_apply(config, device="cpu")(params, ids)
    torch.testing.assert_close(got, want, rtol=0 if bf16 else 1e-5, atol=0 if bf16 else 1e-5)


def test_moe_fixed_batch_program_equals_jax_fixed_batch_artifact(tmp_path):
    """The fault this repairs: the MoE LM's expert capacity
    (``ceil(1.25 · tokens / experts)``) needs a concrete batch, so the JAX
    package exports it with ``batch_polymorphic=False``; the port's
    ``export_program`` now takes the same flag.  The fixed-batch program
    (``input_shape`` is the whole ``[3, 16]``) equals JAX's fixed-batch
    artifact on the same weights within ``MOE_TOL``, and ``program.json``
    records ``batch_polymorphic: false``."""
    ids = np.random.RandomState(2).randint(0, 64, (3, 16)).astype(np.int32)
    params = _jax_lm(MOE, 2, ids)
    ckpt.export_program(str(tmp_path / "moe"), params, MOE, input_shape=(3, 16),
                        input_dtype=np.int32, device="cpu", batch_polymorphic=False)
    meta = json.loads((tmp_path / "moe" / "program.json").read_text())
    assert meta["batch_polymorphic"] is False and meta["input_shape"] == [3, 16]
    assert meta["ops"] == ["tos::flash_attn_fwd"] and _op_calls(tmp_path / "moe") == 2
    program = torch.export.load(str(tmp_path / "moe" / "model.pt2")).module()
    with torch.no_grad():
        got = program(torch.from_numpy(ids)).numpy()
    want = np.asarray(_jax_program(tmp_path, params, MOE, (3, 16),
                                   batch_polymorphic=False).call(jnp.asarray(ids)))
    assert got.shape == (3, 16, 64)
    np.testing.assert_allclose(got, want, **MOE_TOL)


def test_moe_batch_polymorphic_export_raises_as_jax_does(tmp_path):
    """With a symbolic batch the MoE's capacity cannot be computed: JAX's
    ``export_stablehlo`` raises ``ConcretizationTypeError`` and the port's
    ``export_program`` raises too (the batch is pinned by the capacity's
    guard), writing no program."""
    ids = np.random.RandomState(3).randint(0, 64, (2, 16)).astype(np.int32)
    params = _jax_lm(MOE, 3, ids)
    with pytest.raises(jax.errors.ConcretizationTypeError):
        _jax_program(tmp_path, params, MOE, (16,))
    with pytest.raises(RuntimeError, match=r"Constraints violated \(batch\)"):
        ckpt.export_program(str(tmp_path / "moe"), params, MOE, input_shape=(16,),
                            input_dtype=np.int32, device="cpu")
    assert not (tmp_path / "moe" / "model.pt2").exists()


def test_moe_fixed_batch_program_refuses_another_batch(tmp_path):
    """A fixed-batch program takes only its batch: at another batch size
    the loaded program's input guard raises instead of scoring rows whose
    expert capacity it was not traced for."""
    ids = np.random.RandomState(4).randint(0, 64, (3, 16)).astype(np.int32)
    params = _jax_lm(MOE, 4, ids)
    ckpt.export_program(str(tmp_path), params, MOE, input_shape=(3, 16),
                        input_dtype=np.int32, device="cpu", batch_polymorphic=False)
    program = torch.export.load(str(tmp_path / "model.pt2")).module()
    with torch.no_grad():
        assert program(torch.from_numpy(ids)).shape == (3, 16, 64)
        for b in (2, 4):
            with pytest.raises(AssertionError, match="size"):
                program(torch.from_numpy(np.resize(ids, (b, 16))))


def test_chip_smoke_lm_export_sub_step_runs_on_cpu(monkeypatch, tmp_path):
    """``chip_smoke.py``'s LM programs shrunk onto the CPU: the bf16 LM with
    a dynamic batch, the f32 LM and the fixed-batch MoE LM exported, each
    ``program.json`` naming the op's route, and one fresh consumer process
    scoring all three with n_layers op nodes a graph, 0 launches (no card)
    and logits equal to ``build_apply``'s."""
    import chip_smoke as cs

    lm = {**LM, "vocab_size": 256, "d_model": 64, "n_layers": 3, "n_heads": 2,
          "bf16": True, "attn_impl": "auto"}
    monkeypatch.setattr(cs, "WORK_DIR", str(tmp_path))
    monkeypatch.setattr(cs, "LM_CONFIG", lm)
    monkeypatch.setattr(cs, "MOE_CONFIG", {**lm, "n_experts": 4, "moe_top_k": 2})
    monkeypatch.setattr(cs, "SEQ_LEN", 32)
    out = cs.export_lm_sub_step(0, "cpu", device="cpu")
    programs = out["programs"]
    assert sorted(programs) == ["lm_bf16", "lm_f32", "moe_bf16"]
    assert [programs[t]["nodes"] for t in ("lm_bf16", "lm_f32", "moe_bf16")] == [3, 2, 2]
    assert programs["moe_bf16"]["batch_polymorphic"] is False
    for rec in programs.values():
        assert rec["max_rel_err"] == 0.0
        assert all(not any(x.values()) for x in rec["launches"])
    assert "op_host" not in out and not os.path.exists(tmp_path / "lm_programs")
