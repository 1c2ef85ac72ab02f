"""The port's image examples end to end on the CPU (``device="cpu"``):
``examples_torch/cifar10/cifar10_train.py`` DIRECT through a real node
process (restating ``tests/test_cifar10_e2e.py::test_direct_tfrecord_cifar_train``),
``bundle_inference_loop`` over the BN bundle it exports and over the
Inception-v3 example's, and ``examples_torch/imagenet/resnet_train.py``'s
save, restore and unported flags."""

import numpy as np
import pytest
import torch

import tensorflowonspark_torch as tos
from examples_torch.cifar10 import cifar10_train
from examples_torch.imagenet import inception_infer, resnet_train
from tensorflowonspark_torch.checkpoint import latest_step_dir, load_bundle
from tensorflowonspark_torch.inference import bundle_inference_loop
from tensorflowonspark_torch.models.inception import synthetic_images
from tensorflowonspark_torch.models.registry import build_apply


def _serve(export_dir, rows, tmp_path, batch_size=4, executors=2, partitions=3):
    cluster = tos.run(bundle_inference_loop,
                      {"export_dir": export_dir, "batch_size": batch_size,
                       "postprocess": "argmax", "device": "cpu"},
                      num_executors=executors, input_mode=tos.InputMode.STREAMING,
                      log_dir=str(tmp_path / "servelogs"), reservation_timeout=120)
    try:
        return cluster.inference(tos.PartitionedDataset.from_iterable(rows, partitions))
    finally:
        cluster.shutdown(timeout=300)


def test_direct_tfrecord_cifar_train_then_serve_bn_bundle(tmp_path):
    """DIRECT training of ``resnet_cifar`` exports a ``{"params",
    "batch_stats"}`` bundle with moved running statistics; a two-node
    ``bundle_inference_loop`` over NHWC image rows returns one prediction
    per image, in order, equal to the bundle's own ``build_apply``."""
    data_dir = str(tmp_path / "tfr")
    cifar10_train.prepare_data(data_dir, samples=32, partitions=2)
    args = {"data_dir": data_dir, "export_dir": str(tmp_path / "export"), "epochs": 1,
            "batch_size": 8, "depth_blocks": 1, "width": 8, "bf16": False, "device": "cpu"}
    cluster = tos.run(cifar10_train.main_fun, args, num_executors=1,
                      input_mode=tos.InputMode.DIRECT,
                      log_dir=str(tmp_path / "nodelogs"), reservation_timeout=120)
    cluster.shutdown(timeout=300)
    variables, config = load_bundle(str(tmp_path / "export"))
    assert set(variables) == {"params", "batch_stats"} and config["model"] == "resnet_cifar"
    var = variables["batch_stats"]["bn_init"]["var"]
    assert not np.allclose(var, 1.0)              # the running variance moved

    rows = [img for img, _ in cifar10_train.synthetic_cifar(11, seed=4)]
    preds = _serve(str(tmp_path / "export"), rows, tmp_path)
    want = build_apply(config, device="cpu")(variables, np.stack(rows)).argmax(-1).tolist()
    assert preds == want


def test_inception_infer_example(tmp_path):
    """``inception_infer.main`` over a random-init Inception-v3 bundle
    (``{"params", "batch_stats"}``, 1001 classes) at the smallest legal
    input: exactly one result per image, in order."""
    export = str(tmp_path / "bundle")
    preds = inception_infer.main(["--device", "cpu", "--images", "6", "--image-size", "75",
                                  "--batch-size", "4", "--partitions", "2",
                                  "--export-dir", export,
                                  "--log-dir", str(tmp_path / "logs")])
    variables, config = load_bundle(export)
    assert set(variables) == {"params", "batch_stats"}
    images = np.stack(synthetic_images(6, 75))
    logits = build_apply(config, device="cpu")(variables, images).float().numpy()
    assert len(preds) == 6 and all(0 <= p < 1001 for p in preds)
    # bf16 convs: a row is decided where its top two logits are apart by
    # more than the 5% bf16 bound of tests/test_torch_inception.py
    top2 = np.sort(logits, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 0.05 * np.abs(logits).max()
    assert np.array_equal(np.asarray(preds)[decided], logits.argmax(-1)[decided])


def test_resnet_train_example_saves_and_resumes(tmp_path):
    """``resnet_train.main`` on the CPU at 32 px: the loss is finite, the
    checkpoint holds the full state, and a second run resumes its step."""
    argv = ["--device", "cpu", "--image-size", "32", "--batch", "2", "--steps", "1",
            "--num-classes", "10", "--model-dir", str(tmp_path / "model")]
    first = resnet_train.main(argv)
    assert np.isfinite(first["loss"]) and first["step"] == 2
    assert latest_step_dir(str(tmp_path / "model")).endswith("step_2")
    second = resnet_train.main(argv)
    assert second["step"] == 4
    assert latest_step_dir(str(tmp_path / "model")).endswith("step_4")


def test_resnet_train_reads_tfrecords(tmp_path):
    """``--tfrecord-dir``: rows with ``image`` (H*W*3 floats) and ``label``,
    written by ``dfutil.save_as_tfrecords``, cycled into batches."""
    from tensorflowonspark_torch import dfutil

    rows = [{"image": img.ravel().tolist(), "label": i % 10}
            for i, img in enumerate(synthetic_images(6, 32))]
    dfutil.save_as_tfrecords(tos.PartitionedDataset.from_iterable(rows, 2),
                             str(tmp_path / "tfr"))
    out = resnet_train.main(["--device", "cpu", "--image-size", "32", "--batch", "2",
                             "--steps", "3", "--num-classes", "10",
                             "--tfrecord-dir", str(tmp_path / "tfr")])
    assert out["step"] == 4 and np.isfinite(out["loss"])


@pytest.mark.parametrize("flag", [["--fsdp", "2"], ["--profile-dir", "/nonexistent"]])
def test_resnet_train_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        resnet_train.main(["--device", "cpu", *flag])


def test_resnet_train_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet_train.main(["--steps", "1"])
