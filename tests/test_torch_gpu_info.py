"""The port's topology half of ``gpu_info`` against the JAX package's
``tpu_info`` (``tests/test_tpu_info.py``'s ``plan_topology``,
``default_mesh_axes`` and visibility-env cases): the same plans and mesh
axes, and ``CUDA_VISIBLE_DEVICES`` in place of the TPU chip env."""

import pytest

from tensorflowonspark_torch import gpu_info
from tensorflowonspark_tpu import tpu_info
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate


@pytest.mark.parametrize("counts", [[4, 4, 8], [1], [1, 1, 1, 1], [8, 0, 2]])
def test_plan_topology_contiguous_no_overlap(counts):
    plan = gpu_info.plan_topology(counts)
    # the JAX package's plan, field for field
    want = tpu_info.plan_topology(counts)
    assert [(a.executor_id, a.process_id, a.chip_start, a.num_chips, a.chip_ids)
            for a in plan] == [(a.executor_id, a.process_id, a.chip_start, a.num_chips,
                                a.chip_ids) for a in want]
    assert gpu_info.total_chips(plan) == tpu_info.total_chips(want) == sum(counts)
    seen = set()
    for a in plan:
        assert not (seen & set(a.chip_ids))
        seen |= set(a.chip_ids)
    assert seen == set(range(sum(counts)))


def test_plan_topology_starts():
    plan = gpu_info.plan_topology([4, 4, 8])
    assert [a.chip_start for a in plan] == [0, 4, 8]
    assert gpu_info.total_chips(plan) == 16


@pytest.mark.parametrize("n,mp", [(16, 1), (16, 4), (8, 8), (1, 1)])
def test_default_mesh_axes(n, mp):
    assert gpu_info.default_mesh_axes(n, model_parallel=mp) == \
        tpu_info.default_mesh_axes(n, model_parallel=mp)


def test_default_mesh_axes_values_and_refusal():
    assert gpu_info.default_mesh_axes(16) == {"dp": 16, "tp": 1}
    assert gpu_info.default_mesh_axes(16, model_parallel=4) == {"dp": 4, "tp": 4}
    with pytest.raises(ValueError, match="does not divide"):
        gpu_info.default_mesh_axes(6, model_parallel=4)


def test_gpu_visibility_env_slices():
    env = gpu_info.gpu_visibility_env([0, 1, 2, 3])
    assert env == {"CUDA_VISIBLE_DEVICES": "0,1,2,3", "CUDA_DEVICE_ORDER": "PCI_BUS_ID"}
    assert gpu_info.gpu_visibility_env([4, 5])["CUDA_VISIBLE_DEVICES"] == "4,5"


def test_gpu_visibility_env_cpu_and_unknown_platform():
    assert gpu_info.gpu_visibility_env([], platform="cpu") == {"CUDA_VISIBLE_DEVICES": ""}
    with pytest.raises(ValueError, match="unknown platform"):
        gpu_info.gpu_visibility_env([0], platform="tpu")
