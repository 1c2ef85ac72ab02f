"""The port's MNIST examples end to end on the CPU (``device="cpu"``), restating
``tests/test_mnist_e2e.py`` through real node processes: streaming train then
streaming inference over the exported bundle, the whole-job restart that
resumes from the checkpoint, the DIRECT TFRecord train, and the evaluator
role.  The map functions are ``examples_torch/mnist/*.py``'s own."""

import glob
import os

import tensorflowonspark_torch as tos
from examples_torch.mnist import mnist_dist, mnist_tfr
from tensorflowonspark_torch.checkpoint import latest_step_dir
from tensorflowonspark_torch.models.mnist import synthetic_mnist
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

TINY = {"features": [4, 8], "dense": 16, "batch_size": 16, "lr": 0.05, "device": "cpu"}


def test_streaming_train_then_inference(tmp_path):
    args = {**TINY, "model_dir": str(tmp_path / "model"),
            "export_dir": str(tmp_path / "export"), "log_dir": str(tmp_path / "logs")}
    data = tos.PartitionedDataset.from_iterable(synthetic_mnist(240), 4)
    cluster = tos.run(mnist_dist.main_fun, args, num_executors=2,
                      input_mode=tos.InputMode.STREAMING,
                      log_dir=str(tmp_path / "nodelogs"), reservation_timeout=120)
    cluster.train(data, num_epochs=2)
    cluster.shutdown(timeout=300)
    assert latest_step_dir(str(tmp_path / "model")) is not None
    assert os.path.exists(tmp_path / "export" / "bundle.json")
    assert glob.glob(str(tmp_path / "logs" / "train" / "events.out.tfevents.*"))

    # streaming inference over the exported bundle: ordered, exactly-count
    c2 = tos.run(mnist_dist.inference_fun, {**TINY, "export_dir": str(tmp_path / "export")},
                 num_executors=2, input_mode=tos.InputMode.STREAMING,
                 log_dir=str(tmp_path / "nodelogs2"), reservation_timeout=120)
    samples = synthetic_mnist(64, seed=9)
    preds = c2.inference([list(p) for p in (samples[:20], samples[20:45], samples[45:])])
    c2.shutdown(timeout=300)
    assert len(preds) == 64
    assert all(isinstance(p, int) and 0 <= p < 10 for p in preds)
    labels = [l for _, l in samples]
    acc = sum(p == l for p, l in zip(preds, labels)) / len(labels)
    assert acc > 0.5, f"accuracy {acc}"


def test_restart_resumes_from_checkpoint(tmp_path):
    """A second cluster over the same model_dir resumes from the saved full
    train state: the step counter keeps counting."""
    args = {**TINY, "model_dir": str(tmp_path / "model")}
    data = tos.PartitionedDataset.from_iterable(synthetic_mnist(40), 2)
    steps = []
    for run_no in range(2):
        cluster = tos.run(mnist_dist.main_fun, args, num_executors=1,
                          input_mode=tos.InputMode.STREAMING,
                          log_dir=str(tmp_path / f"logs{run_no}"), reservation_timeout=120)
        cluster.train(data)
        cluster.shutdown(timeout=300)
        steps.append(int(latest_step_dir(str(tmp_path / "model")).rsplit("_", 1)[1]))
    assert steps[0] > 0
    assert steps[1] == 2 * steps[0], steps        # resumed, not restarted


def test_direct_tfrecord_train(tmp_path):
    data_dir = str(tmp_path / "tfr")
    mnist_tfr.prepare_data(data_dir, samples=320, partitions=4)
    args = {**TINY, "data_dir": data_dir, "export_dir": str(tmp_path / "export"), "epochs": 1}
    cluster = tos.run(mnist_tfr.main_fun, args, num_executors=2,
                      input_mode=tos.InputMode.DIRECT,
                      log_dir=str(tmp_path / "nodelogs"), reservation_timeout=120)
    cluster.shutdown(timeout=300)
    assert os.path.exists(tmp_path / "export" / "bundle.json")


def test_evaluator_role_evaluates(tmp_path):
    """The evaluator node loads checkpoints as the chief writes them,
    publishes accuracies through the meta channel, writes eval scalars and
    exits once the chief's TRAINING_DONE marker is down, without joining
    the feed or the training consensus."""
    args = {**TINY, "model_dir": str(tmp_path / "model"), "log_dir": str(tmp_path / "logs"),
            "checkpoint_every": 2, "eval_interval": 0.2, "eval_samples": 64}
    data = tos.PartitionedDataset.from_iterable(synthetic_mnist(128), 4)
    cluster = tos.run(mnist_dist.main_fun, args, num_executors=3, eval_node=True,
                      input_mode=tos.InputMode.STREAMING,
                      log_dir=str(tmp_path / "nodelogs"), reservation_timeout=120)
    cluster.train(data)
    cluster.shutdown(timeout=300)
    ev = next(m for m in cluster.coordinator.cluster_info() if m["job_name"] == "evaluator")
    evals = ev.get("evals")
    assert evals, f"evaluator never evaluated: {ev}"
    final_step = int(latest_step_dir(args["model_dir"]).rsplit("_", 1)[1])
    assert evals[-1]["step"] == final_step
    assert all(0.0 <= e["accuracy"] <= 1.0 for e in evals)
    assert glob.glob(str(tmp_path / "logs" / "eval" / "events.out.tfevents.*"))
    assert os.path.exists(tmp_path / "model" / "TRAINING_DONE")
