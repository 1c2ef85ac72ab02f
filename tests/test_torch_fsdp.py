"""ResNet over a ``dp × fsdp`` mesh and the collective save of its state
(``models/layers.BatchNorm`` over the batch group, ``tp.shard_model(rules=())``,
``dp.make_bn_train_step(mesh=)``, ``checkpoint.Shard`` and ``chief_save``'s
collective regime) against the JAX package.

ONE gloo world of 4 CPU ranks (``tests/torch_fsdp_worker.py``) trains the
small ResNet of ``tests/test_torch_resnet.py``'s BN trajectory test over
``dp=2 × fsdp=2``, each rank on its 2 rows of the 8-row batch, and is held
against the JAX package's single-process ``make_bn_train_step`` on the
global batch, in float64 as that test holds it (flax's ``E[x²] - E[x]²``
variance cancels in float32): loss, gradients (atol 1e-7, below), parameters
and running averages (each step moves them by the batch statistics) after
each of 3 steps, rtol 1e-5 / atol 1e-8.  BatchNorm is where
a per-rank statistic would give a plausible but wrong loss, and this test
fails then.  The same world saves its fsdp state collectively and restores
it onto the same mesh bit for bit; this process then reads the checkpoint
whole.  A 2-node cluster (``run(torch_distributed=True)``) does the same
through ``chief_save``, and ``resnet_train.py --fsdp 2`` runs under
``torchrun``, saving and then resuming."""

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

import tensorflowonspark_torch as tos
from tensorflowonspark_torch import checkpoint as tckpt
from tensorflowonspark_torch import convert
from tensorflowonspark_torch.parallel.tp import param_name
from tensorflowonspark_tpu.models import resnet as jres
from tensorflowonspark_tpu.parallel import dp as jdp

from tests import torch_mapfuns
from tests.torch_image_refs import images, random_variables

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
STEPS = 3
CIFAR = {"model": "resnet_cifar", "depth_blocks": 1, "width": 8, "bf16": False}
TOL = dict(rtol=1e-5, atol=1e-8)
# both sides compute the head and its softmax in float32 (flax's
# dtype=jnp.float32), which rounds each gradient at about 2^-24 of the
# logits' scale; a parameter carries that times the learning rate (TOL)
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_setup():
    """The BN trajectory test's float64 model, variables and 8-row batch."""
    stages = dict(stage_sizes=(1, 1, 1), num_classes=10, width=8, stem="cifar")
    jmodel = jres.ResNet(**stages, compute_dtype=jax.numpy.float64,
                         norm_dtype=jax.numpy.float64)
    variables = jax.tree.map(lambda a: a.astype(np.float64),
                             random_variables(jmodel, (32, 32, 3), train=True))
    batch = {"image": images(8, 32, seed=3).astype(np.float64),
             "label": np.arange(8, dtype=np.int32) % 10}
    return jmodel, variables, batch


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4 ranks of ``tests/torch_fsdp_worker.py`` on weights converted
    from the JAX package's variables; returns ``(outputs by rank, the
    work dir)``."""
    work = tmp_path_factory.mktemp("fsdp_world")
    _, variables, batch = jax_setup()
    torch.save({"weights": convert.flax_to_torch(variables, CIFAR),
                "image": torch.from_numpy(batch["image"]),
                "label": torch.from_numpy(batch["label"])}, work / "bn.pt")
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_fsdp_worker.py"),
         "--rank", str(r), "--world", str(WORLD), "--port", str(port), "--dir", str(work)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r in range(WORLD):
        path = work / f"errors{r}.json"
        if not path.exists():
            pytest.fail(f"rank {r} wrote no results:\n{logs[r][-3000:]}")
        errors = json.loads(path.read_text())
        if errors:
            pytest.fail(f"rank {r}:\n{errors['run']}")
        outs.append(dict(np.load(work / f"rank{r}.npz")))
    return outs, work


def test_bn_step_over_dp2_fsdp2_matches_jax_global_batch(world):
    """3 BN steps over dp=2 × fsdp=2 against the JAX package's
    single-process step over the global batch: the loss (averaged over the
    batch ranks), the gradients SGD applied, the parameters after it and
    the running averages (global statistics), on every rank."""
    outs, _ = world
    jmodel, variables, batch = jax_setup()
    assert int(outs[0]["sharded_dims"]) > 0  # parameters really are split
    with jax.enable_x64(True):
        loss_fn = jres.make_loss_fn(jmodel, weight_decay=1e-4)
        opt = optax.sgd(0.1, momentum=0.9, nesterov=True)
        state = jdp.BNTrainState.create(variables["params"], variables["batch_stats"], opt)
        jstep = jdp.make_bn_train_step(loss_fn, opt, donate=False)
        grad_fn = jax.jit(jax.grad(lambda p, s, b: loss_fn(p, s, b)[0]))
        for i in range(STEPS):
            grads = grad_fn(state.params, state.batch_stats, batch)
            state, metrics = jstep(state, batch)
            want_grads = convert.flax_to_torch({"params": jax.device_get(grads)}, CIFAR)
            want = convert.flax_to_torch({"params": jax.device_get(state.params),
                                          "batch_stats": jax.device_get(state.batch_stats)},
                                         CIFAR)
            for r, out in enumerate(outs):
                np.testing.assert_allclose(float(out[f"step{i}/loss"]), float(metrics["loss"]),
                                           rtol=1e-6, err_msg=f"rank {r} step {i + 1}")
                for name, w in want.items():
                    kind = "stats" if name.endswith(("running_mean", "running_var")) else "param"
                    np.testing.assert_allclose(out[f"step{i}/{kind}/{name}"], w.numpy(), **TOL,
                                               err_msg=f"rank {r} step {i + 1} {name}")
                for name, g in want_grads.items():
                    np.testing.assert_allclose(out[f"step{i}/grad/{name}"], g.numpy(), **GRAD_TOL,
                                               err_msg=f"rank {r} step {i + 1} grad {name}")


def test_collective_save_restores_bit_for_bit_and_reads_whole(world):
    """Every rank wrote its blocks (``shards_<rank>.pt``) and rank 0 the
    tree; restored onto a fresh state of the same mesh every leaf comes
    back bit for bit (the next step's loss too); read without a target in
    this one process, each parameter is whole and equals
    ``tp.full_parameters`` of the trained model."""
    outs, work = world
    for out in outs:
        assert int(out["shard_leaves"]) > 0
        assert list(out["restored_step"]) == [STEPS, STEPS]
        assert bool(out["restored_equal"])
        a, b = out["restored_leaves"]
        assert a == b
        assert out["next_loss"][0] == out["next_loss"][1]
    path = tckpt.latest_step_dir(str(work / "ckpt"))
    assert sorted(os.listdir(path)) == ["shards_0.pt", "shards_1.pt", "shards_2.pt",
                                        "shards_3.pt", "tree.pt"]
    whole = tckpt.restore_checkpoint(path)
    assert whole["step"] == STEPS
    model = {param_name(k): v for k, v in whole["model"].items()}
    full = {k[len("full/"):]: v for k, v in outs[0].items() if k.startswith("full/")}
    assert full and set(full) <= set(model)
    for name, v in full.items():
        np.testing.assert_array_equal(model[name].numpy(), v, err_msg=name)


def test_collective_export_bundle_loads_whole_in_both_packages(world):
    """Every rank called ``export_bundle`` with the model's ``Shard``s: the
    bundle is the npz layout with whole tensors (no pickled ``Shard``), and
    the port's and the JAX package's ``load_bundle`` both return each
    parameter equal, bit for bit, to ``tp.full_parameters``."""
    from tensorflowonspark_tpu import checkpoint as jckpt

    outs, work = world
    bundle = work / "bundle"
    assert sorted(os.listdir(bundle)) == ["bundle.json", "params.npz"]
    full = {k[len("full/"):]: v for k, v in outs[0].items() if k.startswith("full/")}
    for load in (tckpt.load_bundle, jckpt.load_bundle):
        params, config = load(str(bundle))
        assert config["model"] == "resnet_cifar"
        model = {param_name(k): np.asarray(v) for k, v in params.items()}
        assert full and set(full) <= set(model)
        for name, v in full.items():
            assert model[name].dtype == v.dtype and model[name].shape == v.shape, name
            np.testing.assert_array_equal(model[name], v, err_msg=name)


def test_two_node_chief_save_collective_regime(tmp_path):
    """``chief_save`` on a 2-node ``torch_distributed`` cluster with fsdp
    state: both nodes write their blocks, the barrier releases after rank
    0's commit, a fresh state of the same mesh restores bit for bit, and
    one process reads the checkpoint whole, equal to
    ``tp.full_parameters``."""
    model_dir = tmp_path / "ckpt"
    cluster = tos.run(torch_mapfuns.fsdp_bn_chief_save,
                      {"model_dir": str(model_dir), "device": "cpu"},
                      num_executors=2, torch_distributed=True, reservation_timeout=120,
                      log_dir=str(tmp_path / "logs"))
    cluster.shutdown(timeout=120.0)
    for r in range(2):
        seen = json.loads((model_dir / f"fsdp_{r}.json").read_text())
        assert seen["step"] == seen["restored_step"] == 2 and seen["equal"]
        assert seen["losses"][0] == seen["losses"][1]
    path = tckpt.latest_step_dir(str(model_dir))
    assert {"shards_0.pt", "shards_1.pt", "tree.pt"} == set(os.listdir(path))
    whole = {param_name(k): v for k, v in tckpt.restore_checkpoint(path)["model"].items()}
    for name, v in torch.load(model_dir / "full.pt").items():
        torch.testing.assert_close(whole[name], v, rtol=0, atol=0)


def _linreg_partitions(num_partitions: int, rows_per_partition: int):
    """``tests/test_distributed.py``'s rows: partition p from its index."""
    parts = []
    for p in range(num_partitions):
        rng = np.random.RandomState(100 + p)
        parts.append([(rng.randn(4).astype(np.float32), float(rng.randn()))
                      for _ in range(rows_per_partition)])
    return parts


def test_distributed_with_evaluator_collective_checkpoint(tmp_path):
    """``torch_distributed`` + an evaluator + the collective checkpoint
    compose (``tests/test_distributed.py``'s, slow there): the evaluator
    stays OUT of the process group (a collective save's barrier would
    otherwise wait on it forever), the two data nodes form one world, train
    in lockstep and save through ``chief_save``, and the checkpoint holds
    the final weights: those of the JAX package's step (``optax.sgd(0.1)``
    from ``w`` at 0.5) over each step's two rank batches concatenated (f32,
    1e-6)."""
    bs = 4
    cluster = tos.run(torch_mapfuns.train_streaming_dist_ckpt,
                      {"batch_size": bs, "model_dir": str(tmp_path / "model"),
                       "device": "cpu"},
                      num_executors=3, eval_node=True,
                      input_mode=tos.InputMode.STREAMING, torch_distributed=True,
                      log_dir=str(tmp_path / "logs"), reservation_timeout=120,
                      feed_timeout=120)
    try:
        cluster.train(_linreg_partitions(num_partitions=4, rows_per_partition=bs),
                      num_epochs=1)
    finally:
        cluster.shutdown(timeout=120.0)
    metas = {m["executor_id"]: m for m in cluster.coordinator.cluster_info()}
    # data nodes: one 2-process world, checkpoint committed
    for r in (0, 1):
        assert metas[r]["ckpt_dist"]["final_step"] == 2
        assert metas[r]["ckpt_dist"]["world"] == 2
    assert metas[0]["ckpt_dist"]["final_w"] == metas[1]["ckpt_dist"]["final_w"]
    # evaluator: outside the group
    assert metas[2]["job_name"] == "evaluator"
    assert metas[2]["eval_process_count"] == 1
    path = tckpt.latest_step_dir(str(tmp_path / "model"))
    assert path.endswith("step_2")
    np.testing.assert_array_equal(
        tckpt.restore_checkpoint(path)["model"]["w"].numpy().ravel(),
        np.asarray(metas[0]["ckpt_dist"]["final_w"], np.float32))
    # the reference: the JAX package's linear regression on the same rows
    opt = optax.sgd(0.1)
    state = jdp.TrainState.create({"w": np.full((4, 1), 0.5, np.float32)}, opt)

    def loss_fn(p, batch):
        return jnp.mean(((batch["x"] @ p["w"])[:, 0] - batch["y"]) ** 2), {}

    step = jdp.make_train_step(loss_fn, opt, donate=False)
    for i in range(2):
        state, _ = step(state, {k: np.concatenate(
            [np.asarray(metas[r]["ckpt_dist"]["batches"][i][k], np.float32) for r in (0, 1)])
            for k in ("x", "y")})
    np.testing.assert_allclose(metas[0]["ckpt_dist"]["final_w"],
                               np.asarray(state.params["w"]).ravel(), rtol=0, atol=1e-6)


def test_resnet_train_fsdp_saves_and_resumes(tmp_path):
    """``resnet_train.py --fsdp 2`` under ``torchrun`` (2 gloo ranks):
    ResNet-50 at 32 px trains, saves collectively, and a second run
    restores every leaf to its fsdp block and resumes from the step."""
    def run():
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
             "--master-port", str(_free_port()),
             str(REPO / "examples_torch" / "imagenet" / "resnet_train.py"), "--device", "cpu",
             "--fsdp", "2", "--image-size", "32", "--batch", "4", "--steps", "1",
             "--num-classes", "10", "--model-dir", str(tmp_path / "rn")],
            capture_output=True, text=True, timeout=300, cwd=REPO,
            env={**os.environ, "OMP_NUM_THREADS": "1"})
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return proc.stdout

    first = run()
    assert "fsdp=2" in first and "checkpoint saved" in first
    assert sorted(os.listdir(tmp_path / "rn" / "step_2")) == ["shards_0.pt", "shards_1.pt",
                                                              "tree.pt"]
    second = run()
    assert "restored checkpoint at step 2" in second
    losses = [float(v) for v in re.findall(r"loss=([0-9.]+)", second)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert os.path.isdir(tmp_path / "rn" / "step_4")
