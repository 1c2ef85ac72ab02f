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
                    "input_dtype": "float32", "batch_polymorphic": True}

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


def test_cuda_export_of_the_lm_refuses_naming_the_kernel(tmp_path, monkeypatch):
    """On ``cuda`` the LM's forward reaches the ctypes-bound attention
    kernel, which ``torch.export`` cannot trace: ``export_program`` raises
    before any weight moves, naming the route and the ROADMAP item (the
    device is only resolved here; nothing runs on a card)."""
    from tensorflowonspark_torch import gpu_info

    monkeypatch.setattr(gpu_info, "default_device", lambda d=None: torch.device("cuda"))
    config = FAMILIES["transformer"]
    with pytest.raises(NotImplementedError,
                       match=r"flash_attn_fwd_tf32 .*ROADMAP \(f\)"):
        ckpt.export_program(str(tmp_path), {}, config, input_shape=(16,),
                            input_dtype=np.int32)
    with pytest.raises(NotImplementedError, match=r"attention kernel flash_attn_fwd "):
        ckpt.export_program(str(tmp_path), {}, {**config, "bf16": True},
                            input_shape=(16,), input_dtype=np.int32)
    assert not (tmp_path / "model.pt2").exists()
