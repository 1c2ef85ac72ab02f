"""The port's restart API end to end on the CPU, restating the JAX
package's gates: an elastic run whose node is SIGKILLed resumes from the
checkpoint its predecessor committed (``tests/test_elastic.py:453-497``),
``elastic`` refuses a pod launcher (``:436-440``), and a whole-job restart over the same model_dir keeps counting steps
(``tests/test_mnist_e2e.py:65-91``).  Map functions live in
``tests/torch_mapfuns.py``, which imports only the port."""

import pytest

import tensorflowonspark_torch as tos
from tensorflowonspark_torch.checkpoint import latest_step_dir
from tensorflowonspark_torch.cluster import InputMode
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

from tests import torch_mapfuns


def _coverage(tmp_path):
    seen: list[int] = []
    for f in tmp_path.glob("seen_*.txt"):
        seen.extend(int(x) for x in f.read_text().split())
    return seen


@pytest.mark.chaos
def test_elastic_restart_resumes_from_checkpoint_and_completes(tmp_path, monkeypatch):
    """2-worker STREAMING train, SIGKILL one worker mid-epoch (after its 3rd
    batch), elastic=True: train() completes, every item is delivered
    (at-least-once), and the restarted worker resumed from the latest
    committed checkpoint under a bumped incarnation."""
    monkeypatch.setenv("TOS_SHM_RING", "0")  # a SIGKILL leaves rings wedged
    monkeypatch.setenv("TOS_DEAD_NODE_TIMEOUT", "4")
    monkeypatch.setenv("TOS_RESTART_BACKOFF_BASE", "0.2")
    items = list(range(120))
    parts = [items[i * 20:(i + 1) * 20] for i in range(6)]
    # per_node_env targets ONE launch slot; `incarnation=0` keeps the fault
    # disarmed in the replacement process (it re-parses the same env)
    per_node_env = [{}, {"TOS_FAULTINJECT": "kill:after_batches=3,incarnation=0"}]
    cluster = tos.run(
        torch_mapfuns.elastic_sum_batches,
        {"batch_size": 2, "out_dir": str(tmp_path),
         "model_dir": str(tmp_path / "ckpt")},
        num_executors=2,
        input_mode=InputMode.STREAMING,
        queue_capacity=4,
        heartbeat_interval=0.5,
        per_node_env=per_node_env,
        log_dir=str(tmp_path / "logs"),
        reservation_timeout=120.0,
        elastic=True,
    )
    cluster.train(parts, num_epochs=1)
    metas = {m["executor_id"]: m for m in cluster.coordinator.cluster_info()}
    victims = [eid for eid, m in metas.items() if m.get("incarnation") == 1]
    assert len(victims) == 1, metas
    victim = victims[0]
    assert cluster.supervisor.restart_count(victim) == 1
    # the replacement loaded the latest checkpoint its predecessor committed
    # (killed during batch 3 => steps 1 and 2 were saved)
    assert metas[victim]["resumed_step_inc1"] == 2
    assert cluster.coordinator.registered_incarnation(victim) == (1, True)
    cluster.shutdown(timeout=120.0)
    assert cluster.coordinator.errors() == []
    seen = _coverage(tmp_path)
    assert set(seen) == set(items)      # every partition delivered & consumed
    assert len(seen) >= len(items)      # at-least-once: duplicates allowed


def test_restart_resumes_from_checkpoint(tmp_path):
    """Whole-job restart: a second cluster pointed at the same model_dir
    resumes from the saved full train state — the step counter keeps
    counting instead of starting again from zero."""
    import numpy as np

    rng = np.random.default_rng(0)
    rows = [(rng.standard_normal(4).astype(np.float32), float(i % 3))
            for i in range(40)]
    args = {"model_dir": str(tmp_path / "model"), "batch_size": 4}

    def train_once(logs):
        cluster = tos.run(torch_mapfuns.train_linear, args, num_executors=1,
                          input_mode=InputMode.STREAMING, heartbeat_interval=0.5,
                          log_dir=str(tmp_path / logs), reservation_timeout=120)
        cluster.train(tos.PartitionedDataset.from_iterable(rows, 2))
        cluster.shutdown(timeout=300)
        return int(latest_step_dir(args["model_dir"]).rsplit("_", 1)[1])

    step1 = train_once("logs1")
    assert step1 > 0
    step2 = train_once("logs2")  # "restart": a new cluster, same model_dir
    assert step2 == 2 * step1, (step1, step2)  # resumed, not restarted


def test_elastic_refuses_pod_launcher():
    """``tests/test_elastic.py``'s pod guard: a ``GPUPodLauncher`` forces
    ``torch_distributed`` on every node, so ``elastic`` is refused for it
    up front, naming the launcher."""
    from tensorflowonspark_torch.launcher import GPUPodLauncher

    with pytest.raises(ValueError, match="GPUPodLauncher"):
        tos.run(torch_mapfuns.noop, None, num_executors=1,
                launcher=GPUPodLauncher(hosts=["h0"]), elastic=True)
