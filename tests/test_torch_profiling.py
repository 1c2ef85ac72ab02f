"""The port's ``profiling`` (``tensorflowonspark_torch/profiling.py``) over
``torch.profiler``: ``tests/test_tpu_info.py::
test_profiler_trace_writes_tensorboard_profile`` restated, the annotation
and the refused ``server``, and ``train_lm.py --profile-dir``, on the CPU
(``resnet_train.py --profile-dir`` reaches the same ``profile_steps``:
``tests/test_torch_image_e2e.py::test_resnet_train_unported_flags_raise``)."""

import glob
import importlib.util
import json
import os

import pytest
import torch

from tensorflowonspark_torch import profiling
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _traces(log_dir):
    return glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json"), recursive=True)


def _example(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_profiler_trace_writes_tensorboard_profile(tmp_path):
    log_dir = str(tmp_path / "prof")
    x = torch.ones(64, 64)
    calls = []

    def step():
        calls.append(1)
        return x @ x

    out = profiling.profile_steps(log_dir, step, warmup=1, steps=2)
    assert len(calls) == 3 and torch.equal(out, x @ x)
    produced = _traces(log_dir)
    assert produced, f"no torch.profiler trace under {log_dir}"
    # the steady-state window is annotated step by step, as in the JAX package
    names = {e.get("name") for e in json.load(open(produced[0]))["traceEvents"]}
    assert {"step_0", "step_1"} <= names and "aten::mm" in names


def test_trace_and_annotate_name_the_region(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("decode_batch"):
            torch.arange(10).sum()
    assert any(e.name == "decode_batch" for e in prof.events())
    assert len(_traces(str(tmp_path))) == 1


def test_server_raises_naming_the_replacement():
    with pytest.raises(NotImplementedError, match="profiling.trace"):
        profiling.server(9012)


def test_train_lm_profile_dir_writes_a_trace(tmp_path):
    train_lm = _example("examples_torch/llm/train_lm.py", "train_lm_profiled")
    out = train_lm.main(["--device", "cpu", "--vocab-size", "64", "--d-model", "32",
                         "--n-layers", "1", "--n-heads", "2", "--seq-len", "16",
                         "--batch", "2", "--steps", "2",
                         "--profile-dir", str(tmp_path / "lm")])
    assert out["loss"] == out["loss"]  # finite, the timed steps ran
    assert _traces(str(tmp_path / "lm"))

