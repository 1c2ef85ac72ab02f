"""The port's cluster end to end on the CPU: real node processes and real
sockets, as ``tests/test_cluster.py`` drives the JAX package's — run and
shutdown, roles, streaming train, ordered inference of a bundle the JAX
package exported (held against the JAX model's ``apply``), error
propagation, the early-termination drain, a ``torch.distributed`` world
through ``run(torch_distributed=True)``, and a launch without
``cloudpickle``.  Map functions live in ``tests/torch_mapfuns.py``, which
imports only the port."""

import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

import tensorflowonspark_torch as tos
from chip_smoke import make_lm_params
from tensorflowonspark_torch.cluster import InputMode, TorchCluster
from tensorflowonspark_tpu import checkpoint as jckpt
from tensorflowonspark_tpu.models import registry as jreg

from tests import torch_mapfuns

REPO = Path(__file__).resolve().parent.parent
LM = {"model": "transformer", "vocab_size": 64, "d_model": 32, "n_layers": 2,
      "n_heads": 4, "bf16": False, "attn_impl": "auto"}
SEQ = 16
HB = 0.5  # heartbeat interval: a node's exit waits for its heartbeat thread


def test_input_mode_aliases():
    assert InputMode.TENSORFLOW is InputMode.DIRECT
    assert InputMode.SPARK is InputMode.STREAMING


def test_run_and_shutdown_noop():
    cluster = tos.run(torch_mapfuns.noop, num_executors=2,
                      reservation_timeout=60, heartbeat_interval=HB)
    assert len(cluster.cluster_info) == 2
    assert cluster.cluster_info[0]["job_name"] == "chief"
    # each node registers the port's device summary (gpu_info), here the CPU
    for meta in cluster.cluster_info:
        dev = meta["device"]
        assert dev["platform"] == "cpu" and dev["num_devices"] == 0
        assert dev["process_index"] == 0 and dev["nvidia_smi"] == []
    cluster.shutdown()


def test_chip_plan_numbers_the_registered_devices():
    """``tests/test_cluster.py``'s ``chip_plan`` case: driver-side card
    numbering from the registered device facts (here the CPU, 0 cards a
    node), disjoint and contiguous."""
    cluster = tos.run(torch_mapfuns.noop, num_executors=2,
                      reservation_timeout=60, heartbeat_interval=HB)
    plan = cluster.chip_plan()
    assert [a.executor_id for a in plan] == [0, 1]
    counts = [(m.get("device") or {}).get("num_devices") or 0
              for m in cluster.cluster_info]
    assert [a.num_chips for a in plan] == [int(c) for c in counts]
    assert plan[1].chip_start == plan[0].num_chips  # disjoint, contiguous
    cluster.shutdown()


def test_chip_plan_over_cards_and_before_the_reports():
    """``chip_plan`` over nodes that registered 4, 4 and 8 cards gives
    disjoint contiguous slices; while a node still shows the distributed
    placeholder it refuses (a plan from placeholders would be all zero)."""
    def cluster_of(devices):
        infos = [{"executor_id": i, "device": d} for i, d in enumerate(devices)]
        coordinator = types.SimpleNamespace(cluster_info=lambda: infos)
        return types.SimpleNamespace(coordinator=coordinator)

    plan = TorchCluster.chip_plan(cluster_of([{"num_devices": n} for n in (4, 4, 8)]))
    assert [a.chip_ids for a in plan] == [(0, 1, 2, 3), (4, 5, 6, 7), tuple(range(8, 16))]
    pending = cluster_of([{"num_devices": 1}, {"platform": "pending_distributed_init"}])
    with pytest.raises(RuntimeError, match=r"nodes \[1\] have not reported"):
        TorchCluster.chip_plan(pending)


def test_roles_and_ctx(tmp_path):
    cluster = tos.run(torch_mapfuns.writes_role, {"out_dir": str(tmp_path)},
                      num_executors=3, eval_node=True, reservation_timeout=60,
                      heartbeat_interval=HB)
    cluster.shutdown()
    roles = sorted((tmp_path / f"role_{i}.txt").read_text() for i in range(3))
    assert roles == ["chief:0:3", "evaluator:0:3", "worker:0:3"]


def test_train_streaming_sums(tmp_path):
    cluster = tos.run(torch_mapfuns.sum_batches,
                      {"out_dir": str(tmp_path), "batch_size": 5},
                      num_executors=2, input_mode=InputMode.STREAMING,
                      reservation_timeout=60, heartbeat_interval=HB)
    data = tos.PartitionedDataset.from_iterable(range(100), 4)
    cluster.train(data, num_epochs=2, shuffle_seed=13)
    cluster.shutdown()
    totals, counts = 0.0, 0
    for i in range(2):
        t, c = (tmp_path / f"node_{i}.txt").read_text().split()
        totals += float(t)
        counts += int(c)
    assert counts == 200  # every item delivered exactly once per epoch
    assert totals == 2 * sum(range(100))


def test_inference_ordered_exact_on_a_jax_exported_lm_bundle(tmp_path):
    """``bundle_inference_loop`` on two port nodes scores a bundle the JAX
    package exported: results come back ordered and exactly counted, and
    match the JAX model's ``apply`` in f32."""
    export = str(tmp_path / "bundle")
    params = make_lm_params(LM, seed=3)  # random f32 weights, flax layout
    jckpt.export_bundle(export, params, LM)
    rng = np.random.RandomState(4)
    rows = [rng.randint(0, LM["vocab_size"], (SEQ,)).astype(np.int32)
            for _ in range(11)]
    cluster = tos.run(tos.bundle_inference_loop,
                      {"export_dir": export, "batch_size": 4, "device": "cpu"},
                      num_executors=2, input_mode=InputMode.STREAMING,
                      reservation_timeout=60, heartbeat_interval=HB)
    try:
        out = cluster.inference(tos.PartitionedDataset.from_iterable(rows, 3))
    finally:
        cluster.shutdown()
    assert len(out) == len(rows)
    want = np.asarray(jreg.build_apply(LM)(params, np.stack(rows)))
    np.testing.assert_allclose(np.stack(out), want, atol=1e-4, rtol=1e-4)


def test_error_propagation():
    cluster = tos.run(torch_mapfuns.failing, num_executors=2,
                      reservation_timeout=60, heartbeat_interval=HB)
    with pytest.raises(RuntimeError, match="intentional failure"):
        cluster.shutdown()


def test_early_termination_fast_drain():
    cluster = tos.run(torch_mapfuns.early_terminator, {"consume": 3},
                      num_executors=1, input_mode=InputMode.STREAMING,
                      reservation_timeout=60, heartbeat_interval=HB)
    # far more data than the node will consume; must not hang
    cluster.train(tos.PartitionedDataset.from_iterable(range(50_000), 2))
    cluster.shutdown()


def test_torch_distributed_world_over_gloo(tmp_path):
    """``run(torch_distributed=True)`` with ``device="cpu"`` in the args:
    the data nodes form one gloo world (rank = executor id, the chief's
    port from the control-plane max-reduce) and an all-reduce sums over
    both."""
    cluster = tos.run(torch_mapfuns.all_reduce_ranks,
                      {"out_dir": str(tmp_path), "device": "cpu"},
                      num_executors=2, torch_distributed=True,
                      reservation_timeout=60, heartbeat_interval=HB)
    cluster.shutdown()
    seen = [json.loads((tmp_path / f"dist_{i}.json").read_text()) for i in range(2)]
    assert [s["rank"] for s in seen] == [0, 1]
    # the device summary a node registers carries its rank
    assert [s["process_index"] for s in seen] == [0, 1]
    assert all(s["world"] == 2 and s["backend"] == "gloo" and s["sum"] == 3.0
               for s in seen)


def test_torch_distributed_refuses_elastic():
    with pytest.raises(ValueError, match="torch.distributed"):
        tos.run(torch_mapfuns.noop, num_executors=2, torch_distributed=True,
                elastic=True)


def test_unported_subsystems_raise_naming_the_roadmap(monkeypatch):
    """Named from before the ingest tier and the autoscaler were ported,
    when these calls raised ``NotImplementedError``: they now refuse what
    the JAX package refuses — an ingest tier outside DIRECT or beside a
    process group, a negative ingest pool — and ``TOS_AUTOSCALE=0`` turns
    ``autoscale()`` into a no-op, before any cluster starts."""
    with pytest.raises(ValueError, match="InputMode.DIRECT"):
        tos.run(torch_mapfuns.noop, ingest_workers=1,
                input_mode=tos.InputMode.STREAMING)
    with pytest.raises(ValueError, match="torch_distributed"):
        tos.run(torch_mapfuns.noop, ingest_workers=1, torch_distributed=True)
    monkeypatch.setenv("TOS_AUTOSCALE", "0")
    assert TorchCluster.autoscale(None) is None
    with pytest.raises(ValueError, match="num_workers >= 0"):
        TorchCluster.resize_ingest(None, -1)


def test_launch_without_cloudpickle(tmp_path):
    """Where ``cloudpickle`` is not installed (the card's machine) a
    module-level map_fun ships by reference through ``pickle``, and a
    lambda fails with an error that names cloudpickle."""
    script = tmp_path / "drive.py"
    script.write_text(textwrap.dedent(f"""
        import pickle, sys
        sys.modules["cloudpickle"] = None  # import cloudpickle -> ImportError
        sys.path.insert(0, {str(REPO)!r})
        import tensorflowonspark_torch as tos
        from tests import torch_mapfuns

        cluster = tos.run(torch_mapfuns.writes_role, {{"out_dir": {str(tmp_path)!r}}},
                          num_executors=2, reservation_timeout=60,
                          heartbeat_interval=0.5)
        cluster.shutdown()
        try:
            tos.run(lambda args, ctx: None, num_executors=1, reservation_timeout=5)
        except pickle.PicklingError as e:
            assert "cloudpickle" in str(e), e
            print("refused:", e)
        else:
            raise AssertionError("a lambda shipped without cloudpickle")
    """))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=180, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "refused:" in out.stdout
    roles = sorted((tmp_path / f"role_{i}.txt").read_text() for i in range(2))
    assert roles == ["chief:0:2", "worker:0:2"]
