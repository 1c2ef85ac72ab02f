"""The port's training checkpoints (``tensorflowonspark_torch.checkpoint``),
restating ``tests/test_checkpoint.py``: round trip, keep-newest, a
``hopsfs://`` model_dir, async commit-and-restore, async keep-newest, and a
full-state resume — held against the JAX package's ``optax.sgd`` run on the
same numpy batches — plus what the commit by rename guarantees."""

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
