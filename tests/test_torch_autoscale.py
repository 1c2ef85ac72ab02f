"""``tests/test_autoscale.py`` restated over the port: elastic autoscaling,
``cluster.resize`` + the policy loop (``tensorflowonspark_torch.autoscale``,
a copy of the JAX package's).  The serving cases load a bundle the JAX
package exported and serve it with the port's ``serving_loop`` on the CPU.

Layers under test, bottom-up:

- governor/policy units — the anti-flap hysteresis state machine driven
  with literal stats series (no cluster, no clock), including the "no
  flapping on a series oscillating around the threshold" guarantee;
- ledger units — mid-run ``add_slot``/``rebalance_to``/``retire_slot``
  bookkeeping against the driver-side partition ledger;
- end-to-end mechanism — a live STREAMING cluster resized in both
  directions: scale-out mid-``train()`` picks up ledger partitions (exact
  record coverage, duplicates allowed), serving scale-in drains without
  losing an accepted request (exactly-once answers), and the retired
  node is classified as intentional (no respawn, no restart budget, no
  ``elastic.restarts_total``);
- chaos — ``TOS_FAULTINJECT=kill`` SIGKILLs the victim mid-drain: the
  resize must not wedge (the ledger re-feed owns its partitions) and
  coverage must still hold;
- the policy loop e2e — serving replicas follow a load step up AND back
  down through ``cluster.autoscale``'s real tick loop.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from tensorflowonspark_torch import cluster as tcluster
from tensorflowonspark_torch import serving, telemetry
from tensorflowonspark_torch.autoscale import (
    HysteresisGovernor,
    LatencyCeilingPolicy,
    Policy,
    QueueDepthBandPolicy,
    RowsPerNodeFloorPolicy,
)
from tensorflowonspark_tpu.checkpoint import export_bundle
from tensorflowonspark_torch.cluster import _PartitionLedger
from tensorflowonspark_tpu.models import linear as linmod
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

from tests import torch_mapfuns

LINEAR = {"model": "linear", "in_dim": 4, "out_dim": 4}


# -- governor hysteresis (unit) ----------------------------------------------


def test_governor_scale_out_fires_once_then_cooldown_holds():
    gov = HysteresisGovernor(1, 8, cooldown_secs=10.0, scale_in_ticks=3)
    assert gov.decide(3, 1, now=0.0) == ("scale_out", 3)
    # still over target inside the cooldown: held, not re-fired
    assert gov.decide(4, 3, now=5.0) == ("cooldown_hold", 3)
    # cooldown expired: the next over-target window may fire again
    assert gov.decide(4, 3, now=11.0) == ("scale_out", 4)


def test_governor_scale_in_needs_consecutive_evidence():
    gov = HysteresisGovernor(1, 8, cooldown_secs=0.0, scale_in_ticks=3)
    assert gov.decide(1, 2, now=0.0) == ("hold", 2)   # evidence 1/3
    assert gov.decide(1, 2, now=1.0) == ("hold", 2)   # evidence 2/3
    # one at-target window RESETS the evidence
    assert gov.decide(2, 2, now=2.0) == ("hold", 2)
    assert gov.decide(1, 2, now=3.0) == ("hold", 2)
    assert gov.decide(1, 2, now=4.0) == ("hold", 2)
    assert gov.decide(1, 2, now=5.0) == ("scale_in", 1)


def test_governor_no_flap_on_oscillating_series():
    """A stats series oscillating around the threshold (desired flips
    current-1 / current+0 every tick) must never shrink the fleet, and an
    oscillation into over-target must not fire inside the cooldown."""
    gov = HysteresisGovernor(1, 8, cooldown_secs=5.0, scale_in_ticks=3)
    actions = [gov.decide(2 if i % 2 else 3, 3, now=float(i))
               for i in range(20)]
    assert all(a[0] == "hold" for a in actions), actions
    # now a burst: one scale_out, then oscillation keeps holding
    assert gov.decide(4, 3, now=20.0)[0] == "scale_out"
    followups = [gov.decide(3 if i % 2 else 5, 4, now=20.5 + i * 0.5)[0]
                 for i in range(8)]
    assert set(followups) <= {"hold", "cooldown_hold"}, followups


def test_governor_cooldown_windows_are_not_scale_in_evidence():
    """Evidence gathered while the fleet is still settling (inside the
    cooldown) must not count: after a scale-out drains the queue, the
    first eligible scale-in needs K under-target windows AFTER the
    cooldown expired — otherwise bursty load oscillates the fleet with
    period == cooldown_secs."""
    gov = HysteresisGovernor(1, 8, cooldown_secs=10.0, scale_in_ticks=3)
    assert gov.decide(3, 2, now=0.0) == ("scale_out", 3)
    # the burst drains instantly: under-target all through the cooldown
    for t in (2.0, 5.0, 8.0):
        assert gov.decide(2, 3, now=t) == ("cooldown_hold", 3)
    # cooldown expired: the shrink evidence starts from ZERO here
    assert gov.decide(2, 3, now=11.0) == ("hold", 3)
    assert gov.decide(2, 3, now=12.0) == ("hold", 3)
    assert gov.decide(2, 3, now=13.0) == ("scale_in", 2)


def test_governor_clamps_to_bounds():
    gov = HysteresisGovernor(2, 4, cooldown_secs=0.0, scale_in_ticks=1)
    assert gov.decide(100, 4, now=0.0) == ("hold", 4)     # clamped to max
    assert gov.decide(100, 3, now=1.0) == ("scale_out", 4)
    assert gov.decide(0, 3, now=2.0) == ("scale_in", 2)   # clamped to min
    assert gov.decide(0, 2, now=3.0) == ("hold", 2)


# -- policies (unit) ----------------------------------------------------------


def _stats(serving_block=None, streams=None):
    return {"serving": serving_block or {}, "streams": streams or {}}


def test_queue_depth_band_policy():
    p = QueueDepthBandPolicy(low=1.0, high=8.0, step=2)
    assert p.desired(_stats({"queue_depth": 12}), 2) == 4   # above band
    assert p.desired(_stats({"queue_depth": 4}), 2) == 2    # inside band
    assert p.desired(_stats({"queue_depth": 0}), 2) == 1    # at/below low
    assert p.desired(_stats({}), 2) == 2                    # no signal: hold


def test_latency_ceiling_policy():
    p = LatencyCeilingPolicy(ceiling_ms=100.0, relax_frac=0.3)
    hot = {"p99_ms": 250.0, "qps": 50.0}
    cool = {"p99_ms": 10.0, "qps": 50.0}
    quiet = {"p99_ms": 10.0, "qps": 0.0}
    assert p.desired(_stats(hot), 2) == 3
    assert p.desired(_stats(cool), 2) == 1
    assert p.desired(_stats(quiet), 2) == 2   # no traffic: not latency's call
    assert p.desired(_stats({}), 2) == 2


def test_rows_per_node_floor_policy():
    p = RowsPerNodeFloorPolicy(min_rows_per_sec=100.0)
    streams = {"0": {"rates": {"feed.rows_consumed": 90.0}},
               "1": {"rates": {"feed.rows_consumed": 85.0}},
               "driver": {"rates": {"feed.rows_consumed": 999.0}}}  # ignored
    # 175 rows/s over 2 nodes is under the floor; shrink-to-fit says 1
    assert p.desired(_stats(None, streams), 2) == 1
    rich = {"0": {"rates": {"feed.rows_consumed": 400.0}},
            "1": {"rates": {"feed.rows_consumed": 400.0}}}
    assert p.desired(_stats(None, rich), 2) == 2    # never grows
    assert p.desired(_stats(None, {}), 2) == 2      # no signal: hold


# -- partition ledger resize bookkeeping (unit) -------------------------------


def test_ledger_add_slot_rebalances_and_delivers():
    ledger = _PartitionLedger(num_partitions=12, num_epochs=1, num_slots=2)
    # slot 0 takes one task in flight; the newcomer gets a fair share of
    # the still-queued work from the most-loaded peers
    t0 = ledger.next_task(0)
    assert t0 is not None
    pos = ledger.add_slot()
    assert pos == 2
    moved = ledger.rebalance_to(pos)
    assert moved > 0
    # the newcomer can draw its rebalanced tasks immediately
    t2 = ledger.next_task(pos)
    assert t2 is not None and t2 != t0


def test_ledger_retire_slot_requeues_home_work_to_survivors():
    ledger = _PartitionLedger(num_partitions=8, num_epochs=1, num_slots=2)
    t1 = ledger.next_task(1)          # slot 1 has one in flight...
    moved = ledger.retire_slot(1)     # ...and forfeits its queue to orphans
    assert moved == 3                 # 4 home partitions minus the in-flight
    assert ledger.next_task(1) is None          # retired: no new work
    assert not ledger.slot_idle(1)              # in-flight still out
    ledger.ack(1, consumed=None)
    assert ledger.slot_idle(1)
    # survivors drain their own queue AND the retiree's orphans: all 7
    # remaining tasks come out of slot 0
    got = []
    for _ in range(7):
        task = ledger.next_task(0)
        assert task is not None
        got.append(task)
        ledger.ack(0, consumed=None)
    assert ledger.next_task(0) is None          # everything resolved
    assert t1 not in got                        # the acked in-flight task


# -- coordinator slot bookkeeping (unit) --------------------------------------


def test_cancel_slots_realigns_promised_ids_after_failed_scale_out():
    """A timed-out scale-out must roll back ``open_slots`` for slots that
    never registered: ``open_slots`` promises ids from ``len(roles)`` while
    registration assigns ``len(_nodes)`` — without the rollback every later
    scale-out waits forever on ids no registration can ever be assigned."""
    from tensorflowonspark_torch.coordinator import (
        CoordinatorClient,
        CoordinatorServer,
    )

    server = CoordinatorServer(expected=1)
    addr = server.start()
    try:
        c = CoordinatorClient(addr)
        c.register({"host": "127.0.0.1", "data_port": 1000})
        server.await_registrations(timeout=10)
        # failed scale-out: nobody registers for the opened slot
        assert server.open_slots(1) == [1]
        with pytest.raises(TimeoutError):
            server.await_slots([1], timeout=0.3)
        server.cancel_slots([1])
        # the NEXT scale-out promises the same id — and this one registers
        assert server.open_slots(1) == [1]
        c2 = CoordinatorClient(addr)
        ident = c2.register({"host": "127.0.0.1", "data_port": 1001})
        assert ident["executor_id"] == 1
        server.await_slots([1], timeout=10)
        c.close()
        c2.close()
    finally:
        server.stop()


def test_default_barrier_count_tracks_retirement():
    """Default-group barriers/reduces must count the LIVE membership:
    ``expected`` only ever grows, so a default count that ignored retired
    slots would make every post-scale-in ``ctx.barrier()`` wait on ghosts
    until its timeout kills the job."""
    from tensorflowonspark_torch.coordinator import (
        CoordinatorClient,
        CoordinatorServer,
    )

    server = CoordinatorServer(expected=2)
    addr = server.start()
    try:
        c0 = CoordinatorClient(addr)
        c0.register({"host": "127.0.0.1", "data_port": 1000})
        c1 = CoordinatorClient(addr)
        c1.register({"host": "127.0.0.1", "data_port": 1001})
        server.await_registrations(timeout=10)
        server.retire_node(1)
        # one live participant: a default-count barrier completes alone
        # (pre-fix this would hang on count=2 until the timeout)
        c0.barrier("after_retire", 0, timeout=5.0)
        c0.close()
        c1.close()
    finally:
        server.stop()


# -- end-to-end: scale-out mid-train ------------------------------------------


def test_scale_out_mid_train_picks_up_ledger_partitions(tmp_path, monkeypatch):
    """1-node STREAMING train with a slow consumer; resize(2) mid-feed.
    The newcomer must be admitted through rendezvous, receive rebalanced
    ledger partitions, and the union of consumed records must cover the
    fed records exactly (duplicates allowed, loss not)."""
    monkeypatch.setenv("TOS_SHM_RING", "0")
    telemetry.reset()
    items = list(range(120))
    parts = [items[i * 10:(i + 1) * 10] for i in range(12)]
    cluster = tcluster.run(
        torch_mapfuns.record_items,
        {"batch_size": 10, "out_dir": str(tmp_path), "sleep_per_batch": 0.25},
        num_executors=1,
        input_mode=tcluster.InputMode.STREAMING,
        queue_capacity=4,   # small buffer: most partitions stay driver-side
        heartbeat_interval=0.5,
        reservation_timeout=120.0,
        elastic=True,
    )
    record = {}
    try:
        trainer = threading.Thread(
            target=lambda: cluster.train(parts, num_epochs=1), name="trainer")
        trainer.start()
        time.sleep(1.0)     # ~4 of 12 partitions consumed
        assert trainer.is_alive(), "feed finished before the resize; slow it down"
        record = cluster.resize(2)
        trainer.join(timeout=120.0)
        assert not trainer.is_alive()
    finally:
        cluster.shutdown(timeout=120.0)
    assert record["action"] == "scale_out" and record["to"] == 2
    new_id = record["added"][0]
    files = {f.name: f.read_text() for f in tmp_path.glob("node_*.txt")}
    assert f"node_{new_id}.txt" in files, files.keys()
    seen = [int(x) for text in files.values() if text
            for x in text.split(",") if x]
    assert set(seen) == set(items)          # exact coverage
    assert len(files[f"node_{new_id}.txt"]) > 0  # the newcomer did real work
    # the run report records the resize
    assert cluster._resize_log and cluster._resize_log[0]["action"] == "scale_out"


# -- end-to-end: serving scale-in ---------------------------------------------


def _serve_cluster(tmp_path, *, num_executors=2, elastic=True,
                   per_node_env=None, config=LINEAR, scale=2.0, max_batch=4):
    export = str(tmp_path / "bundle")
    export_bundle(export, linmod.init_params(config, scale=scale), config)
    cluster = tcluster.run(
        serving.serving_loop,
        {"export_dir": export, "max_batch": max_batch, "device": "cpu"},
        num_executors=num_executors,
        input_mode=tcluster.InputMode.STREAMING,
        heartbeat_interval=0.5,
        per_node_env=per_node_env,
        reservation_timeout=120.0,
        elastic=elastic,
        log_dir=str(tmp_path / "logs"),
    )
    return cluster, export


def test_scale_in_drains_serving_exactly_once(tmp_path, monkeypatch):
    """2-replica serving cluster under continuous load; resize(1) mid-flight.
    Every accepted request is answered exactly once with the right result
    (in-flight batches on the victim finish or retry on the survivor), the
    victim exits cleanly, and retirement is classified as intentional: no
    respawn, no restart budget, no elastic.restarts_total."""
    monkeypatch.setenv("TOS_SHM_RING", "0")
    telemetry.reset()
    cluster, export = _serve_cluster(tmp_path)
    base = np.arange(4, dtype=np.float32)
    answers: dict = {}
    errors: list = []
    lock = threading.Lock()
    stop = threading.Event()
    counter = [0]

    def loader():
        gw_local = gw
        while not stop.is_set():
            with lock:
                i = counter[0]
                counter[0] += 1
            try:
                out = gw_local.predict([base + i], timeout=60.0)[0]
                with lock:
                    answers[i] = out
            except Exception as e:  # noqa: BLE001 - asserted empty below
                with lock:
                    errors.append((i, repr(e)))

    try:
        gw = cluster.serve(export, max_batch=4, max_delay_ms=2.0,
                           listen=False, reload_poll_secs=0)
        threads = [threading.Thread(target=loader) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(1.0)                      # load flowing on both replicas
        record = cluster.resize(1)           # victim = least-loaded != chief
        time.sleep(1.0)                      # load keeps flowing on survivor
        stop.set()
        for t in threads:
            t.join(timeout=60.0)
        assert record["action"] == "scale_in" and record["retired"] == [1]
        assert not errors, errors[:3]
        assert sorted(answers) == list(range(len(answers)))
        for i, out in answers.items():
            np.testing.assert_allclose(out, (base + i) * 2.0)
        assert gw.healthy_replicas() == [0]
        assert gw.replica_loads().keys() == {0}
        # intentional retirement: no recovery machinery fired
        assert telemetry.counter("elastic.restarts_total").value() == 0
        assert telemetry.counter("elastic.retirements_total").value() == 1
        assert cluster.supervisor.restart_count(1) == 0
        assert cluster.coordinator.is_retired(1)
        assert not cluster.coordinator.is_tracked(1)
        # the victim's process exited CLEANLY (EOF path, not terminate)
        _, proc = cluster._proc_for(1)
        assert proc is not None and proc.exitcode == 0
        # stats surface the draining-vs-healthy split (drained back to 0)
        s = cluster.stats(5.0)
        assert s["serving"]["replicas_draining"] == 0
        assert s["serving"]["replicas_healthy"] == 1
    finally:
        cluster.shutdown(timeout=120.0)
    assert cluster.coordinator.errors() == []


def test_scale_in_refused_during_live_inference(tmp_path, monkeypatch):
    """Inference partitions are statically assigned at call start (no live
    re-feed session like train()), so a scale-in landing mid-call would
    EOF a worker that still owns partitions and fail the whole call on a
    healthy cluster — resize() refuses instead, and the shrink succeeds
    the moment the call completes."""
    monkeypatch.setenv("TOS_SHM_RING", "0")
    telemetry.reset()
    cluster = tcluster.run(
        torch_mapfuns.echo_inference, {},
        num_executors=2,
        input_mode=tcluster.InputMode.STREAMING,
        heartbeat_interval=0.5,
        reservation_timeout=120.0,
        elastic=True,
    )
    try:
        parts = [[float(3 * i + j) for j in range(3)] for i in range(6)]
        stream = cluster.inference_stream(parts)
        first = next(stream)          # the call is now live
        with pytest.raises(RuntimeError, match="live inference"):
            cluster.resize(1)
        rest = list(stream)           # drain: the call completes
        got = [x for _, part in [first, *rest] for x in part]
        assert got == [x * 2 for p in parts for x in p]
        record = cluster.resize(1)    # now the shrink is allowed
        assert record["action"] == "scale_in" and record["retired"] == [1]
    finally:
        cluster.shutdown(timeout=120.0)
    assert cluster.coordinator.errors() == []


def test_scale_in_non_elastic_drains_promptly(tmp_path, monkeypatch):
    """resize() needs no supervisor: on an ``elastic=False`` cluster the
    retired slot's feed worker still polls the victim's consumption
    watermark, so scale-in completes as soon as the backlog is consumed —
    instead of burning the whole drain_timeout and then terminating a
    perfectly healthy node (exit code 0 pins the clean-EOF path)."""
    monkeypatch.setenv("TOS_SHM_RING", "0")
    telemetry.reset()
    items = list(range(80))
    parts = [items[i * 10:(i + 1) * 10] for i in range(8)]
    cluster = tcluster.run(
        torch_mapfuns.record_items,
        {"batch_size": 10, "out_dir": str(tmp_path), "sleep_per_batch": 0.15},
        num_executors=2,
        input_mode=tcluster.InputMode.STREAMING,
        queue_capacity=4,   # backpressure: partitions stay driver-side
        heartbeat_interval=0.5,
        reservation_timeout=120.0,
        elastic=False,
    )
    try:
        trainer = threading.Thread(
            target=lambda: cluster.train(parts, num_epochs=1), name="trainer")
        trainer.start()
        time.sleep(0.5)
        assert trainer.is_alive()
        record = cluster.resize(1, drain_timeout=60.0)
        assert record["action"] == "scale_in" and record["retired"] == [1]
        assert record["secs"] < 30.0, f"drain burned the timeout: {record}"
        trainer.join(timeout=120.0)
        assert not trainer.is_alive()
    finally:
        cluster.shutdown(timeout=120.0)
    assert cluster.coordinator.errors() == []
    _, proc = cluster._proc_for(1)
    assert proc is not None and proc.exitcode == 0
    seen = [int(x) for f in tmp_path.glob("node_*.txt")
            for x in f.read_text().split(",") if x]
    assert set(seen) == set(items)


# -- chaos: kill during drain -------------------------------------------------


@pytest.mark.chaos
def test_kill_during_drain_does_not_wedge_resize(tmp_path, monkeypatch):
    """SIGKILL the scale-in victim while it is draining its buffered
    partitions: the resize must complete (the ledger re-feed owns its
    partitions — survivors deliver them), coverage must hold, and the death
    mid-drain must still count as retirement (no respawn, no budget)."""
    monkeypatch.setenv("TOS_SHM_RING", "0")  # a SIGKILL leaves rings wedged
    monkeypatch.setenv("TOS_DEAD_NODE_TIMEOUT", "4")
    telemetry.reset()
    items = list(range(120))
    parts = [items[i * 10:(i + 1) * 10] for i in range(12)]
    # Executor 1 (the resize victim — the chief never retires) dies
    # consuming its 4th batch: past the ~2 batches it consumes before the
    # resize lands, within the backlog it drains after it.  Cluster-wide
    # env + `executor=1` filter, NOT per_node_env: executor ids are
    # assigned in REGISTRATION order, so the fault must follow the
    # assigned id, not the launch slot.  batch_size=4 on 10-item
    # partitions keeps the kill batch marker-free (per-partition batches
    # run [4, 4, 2+EndPartition]): the kill hook fires inside
    # ``next_batch`` AFTER the pop, so a kill on a marker-bearing batch
    # would report the partition consumed while its items never reached
    # the map_fun's log — the at-least-once watermark's honest boundary,
    # not a coverage bug.
    cluster = tcluster.run(
        torch_mapfuns.record_items,
        {"batch_size": 4, "out_dir": str(tmp_path), "sleep_per_batch": 0.4},
        num_executors=2,
        input_mode=tcluster.InputMode.STREAMING,
        heartbeat_interval=0.5,
        env={"TOS_FAULTINJECT":
             "kill:after_batches=4,executor=1,incarnation=0"},
        log_dir=str(tmp_path / "logs"),
        reservation_timeout=120.0,
        elastic=True,
    )
    try:
        trainer = threading.Thread(
            target=lambda: cluster.train(parts, num_epochs=1), name="trainer")
        trainer.start()
        time.sleep(0.7)     # victim consumed ~2 batches, backlog buffered
        assert trainer.is_alive()
        record = cluster.resize(1, drain_timeout=60.0)
        trainer.join(timeout=120.0)
        assert not trainer.is_alive()
        assert record["retired"] == [1]
        # retirement, not recovery: the kill mid-drain never respawned
        assert telemetry.counter("elastic.restarts_total").value() == 0
        assert cluster.supervisor.restart_count(1) == 0
        assert cluster.coordinator.is_retired(1)
    finally:
        cluster.shutdown(timeout=120.0)
    # the recovered death never became a fatal node error
    assert cluster.coordinator.errors() == []
    seen: list[int] = []
    for f in tmp_path.glob("node_*.txt"):
        text = f.read_text()
        if text:
            seen.extend(int(x) for x in text.split(",") if x)
    assert set(seen) == set(items)      # every record delivered & consumed
    assert len(seen) >= len(items)      # at-least-once: duplicates allowed


# -- the policy loop e2e: replicas follow a load step -------------------------


class _QpsStepPolicy(Policy):
    """Deterministic e2e policy: windowed qps (a RATE — stable, unlike a
    point-sampled gauge) above the threshold wants 2 replicas, else 1."""

    name = "qps_step"

    def __init__(self, threshold_qps: float):
        self.threshold_qps = threshold_qps

    def desired(self, stats, current):
        qps = (stats.get("serving") or {}).get("qps") or 0.0
        return 2 if qps > self.threshold_qps else 1


def test_serving_replicas_follow_load_step(tmp_path, monkeypatch):
    """The closed loop: a 1-replica serving cluster under a load step must
    scale out through the REAL autoscaler tick loop (spawn, rendezvous,
    router admission), serve from both replicas, then scale back in once
    the load stops — with zero non-503 failures throughout."""
    monkeypatch.setenv("TOS_SHM_RING", "0")
    telemetry.reset()
    cluster, export = _serve_cluster(tmp_path, num_executors=1)
    stop = threading.Event()
    errors: list = []
    served = [0]
    lock = threading.Lock()
    base = np.arange(4, dtype=np.float32)

    def loader():
        while not stop.is_set():
            try:
                out = gw.predict([base], timeout=60.0)[0]
                np.testing.assert_allclose(out, base * 2.0)
                with lock:
                    served[0] += 1
            except Exception as e:  # noqa: BLE001 - asserted empty below
                with lock:
                    errors.append(repr(e))

    def _await(predicate, timeout, what):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if predicate():
                return
            time.sleep(0.25)
        pytest.fail(f"timed out waiting for {what}; "
                    f"decisions={scaler.decisions()}")

    try:
        gw = cluster.serve(export, max_batch=4, max_delay_ms=2.0,
                           listen=False, reload_poll_secs=0)
        scaler = cluster.autoscale(
            _QpsStepPolicy(threshold_qps=5.0),
            min_nodes=1, max_nodes=2, tick_secs=0.4, cooldown_secs=1.0,
            scale_in_ticks=3, window=2.0)
        assert scaler is not None
        threads = [threading.Thread(target=loader) for _ in range(4)]
        for t in threads:
            t.start()
        _await(lambda: cluster.num_feedable() == 2 and
               gw.healthy_replicas() == [0, 1], 60.0, "scale-out to 2")
        before = served[0]
        _await(lambda: served[0] > before + 20, 30.0,
               "requests served at 2 replicas")
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
        # load gone: qps decays within the window, K under-target ticks
        # plus the cooldown, and the fleet shrinks back
        _await(lambda: cluster.num_feedable() == 1, 60.0, "scale-in to 1")
        assert not errors, errors[:3]
        report = scaler.report()
        assert report["counts"]["scale_out"] >= 1
        assert report["counts"]["scale_in"] >= 1
        actions = [d["action"] for d in report["decisions"]]
        assert "scale_out" in actions and "scale_in" in actions
        # every decision carries its stats justification
        assert all("stats" in d for d in report["decisions"])
        assert telemetry.counter("elastic.restarts_total").value() == 0
    finally:
        cluster.shutdown(timeout=120.0)
    assert cluster.coordinator.errors() == []
