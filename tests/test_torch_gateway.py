"""The port's online-serving gateway end to end on the CPU, restating the
JAX package's ``tests/test_serving.py``: the batcher units against a fake
router; a 2-node STREAMING cluster running the port's ``serving_loop`` over
a linear bundle — round trip, the TCP endpoint (``GatewayClient``),
coalescing, hot reload; a replica SIGKILLed mid-flight with every request
answered exactly once; and an LM bundle the JAX package exported, whose
gateway logits are held against the JAX ``Transformer.apply``."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from chip_smoke import make_lm_params
from tensorflowonspark_torch import cluster as tcluster
from tensorflowonspark_torch import serving, telemetry
from tensorflowonspark_torch.serving import (
    GatewayClient,
    MicroBatcher,
    ServeClosed,
    ServeQueueFull,
    ServeTimeout,
)
from tensorflowonspark_tpu import checkpoint as jckpt
from tensorflowonspark_tpu.models import linear as jlin
from tensorflowonspark_tpu.models import registry as jreg
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

LINEAR = {"model": "linear", "in_dim": 4, "out_dim": 4}
LM = {"model": "transformer", "vocab_size": 64, "d_model": 32, "n_layers": 2,
      "n_heads": 4, "bf16": False, "attn_impl": "auto"}
SEQ = 16


# -- batcher units (fake router) ----------------------------------------------


class _FakeRouter:
    """Records batches; completes them with f(row) when told to."""

    def __init__(self, batcher_ref: list, fn=lambda r: r, auto: bool = True):
        self.batches: list = []
        self.fn = fn
        self.auto = auto
        self._batcher_ref = batcher_ref

    def submit(self, batch):
        self.batches.append(batch)
        if self.auto:
            self.complete(batch)

    def complete(self, batch):
        self._batcher_ref[0].complete_batch(
            batch, [self.fn(r) for r in batch.rows])


def _make(batcher_ref, *, max_batch=8, delay=0.05, queue=16, pause=None,
          fn=lambda r: r, auto=True, capacity=None):
    router = _FakeRouter(batcher_ref, fn=fn, auto=auto)
    b = MicroBatcher(router.submit, max_batch=max_batch, max_delay_secs=delay,
                     queue_limit=queue, pause_fn=pause, capacity_fn=capacity)
    batcher_ref[0] = b
    return b, router


def test_batcher_coalesces_concurrent_requests_into_one_padded_batch():
    ref: list = [None]
    b, router = _make(ref, max_batch=8, delay=0.25, fn=lambda r: r * 2)
    try:
        results: dict = {}

        def one(i):
            req = b.submit([float(i)], time.monotonic() + 30.0)
            results[i] = b.await_request(req)[0]

        threads = [threading.Thread(target=one, args=(i,)) for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert len(router.batches) == 1  # all five rode ONE padded batch
        batch = router.batches[0]
        assert batch.n == 5 and len(batch.rows) == 8
        assert results == {i: float(i) * 2 for i in range(5)}
    finally:
        b.close()


def test_batcher_flushes_full_batch_before_delay():
    ref: list = [None]
    b, router = _make(ref, max_batch=4, delay=10.0)  # delay can never trip
    try:
        t0 = time.monotonic()
        req = b.submit([1.0, 2.0, 3.0, 4.0], time.monotonic() + 30.0)
        assert b.await_request(req) == [1.0, 2.0, 3.0, 4.0]
        assert time.monotonic() - t0 < 5.0  # size-triggered, not delay
        assert router.batches[0].n == 4
    finally:
        b.close()


def test_batcher_request_spanning_batches_keeps_row_order():
    ref: list = [None]
    b, router = _make(ref, max_batch=4, delay=0.02, fn=lambda r: r + 100)
    try:
        rows = [float(i) for i in range(10)]
        req = b.submit(rows, time.monotonic() + 30.0)
        assert b.await_request(req) == [r + 100 for r in rows]
        assert [batch.n for batch in router.batches] == [4, 4, 2]
        assert all(len(batch.rows) == 4 for batch in router.batches)
    finally:
        b.close()


def test_batcher_failed_spanning_request_tail_never_dispatches():
    ref: list = [None]
    allowance = [1]  # one batch may dispatch per allowance
    b, router = _make(ref, max_batch=4, delay=0.02, auto=False,
                      capacity=lambda: len(router.batches) < allowance[0])
    try:
        req = b.submit([float(i) for i in range(10)], time.monotonic() + 30.0)
        deadline = time.monotonic() + 5.0
        while not router.batches and time.monotonic() < deadline:
            time.sleep(0.01)
        assert router.batches, "first slice never dispatched"
        b.fail_batch(router.batches[0], RuntimeError("replica down"))
        with pytest.raises(RuntimeError, match="replica down"):
            b.await_request(req)
        n_after_fail = len(router.batches)
        allowance[0] = 2  # gate reopens: only NEW work may flush now
        clean = b.submit([42.0], time.monotonic() + 30.0)
        deadline = time.monotonic() + 5.0
        while len(router.batches) == n_after_fail \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        last = router.batches[-1]
        assert last.n == 1 and last.rows[0] == 42.0, (
            "dead request's tail rows leaked into a later batch")
        router.complete(last)
        assert b.await_request(clean) == [42.0]
    finally:
        b.close()


def test_batcher_queue_full_fast_fails_and_close_resolves_pending():
    ref: list = [None]
    b, _ = _make(ref, max_batch=8, delay=10.0, queue=2,
                 pause=lambda: True)  # paused: nothing ever dispatches
    reqs = [b.submit([1.0], time.monotonic() + 60.0) for _ in range(2)]
    with pytest.raises(ServeQueueFull):
        b.submit([2.0], time.monotonic() + 60.0)
    b.close()
    for req in reqs:  # queued work resolves (with an error), never hangs
        with pytest.raises(ServeClosed):
            b.await_request(req)
    with pytest.raises(ServeClosed):
        b.submit([3.0], time.monotonic() + 60.0)


def test_batcher_deadline_expires_queued_request():
    ref: list = [None]
    b, _ = _make(ref, max_batch=8, delay=10.0, pause=lambda: True)
    try:
        t0 = time.monotonic()
        req = b.submit([1.0], time.monotonic() + 0.15)
        with pytest.raises(ServeTimeout):
            b.await_request(req)
        assert 0.1 < time.monotonic() - t0 < 5.0
    finally:
        b.close()


# -- end-to-end: 2-node serving cluster ---------------------------------------


def _serve_cluster(export, *, elastic=False, per_node_env=None):
    return tcluster.run(
        serving.serving_loop,
        {"export_dir": export, "max_batch": 4, "device": "cpu"},
        num_executors=2, input_mode=tcluster.InputMode.STREAMING,
        heartbeat_interval=0.5, per_node_env=per_node_env,
        reservation_timeout=120.0, elastic=elastic)


@pytest.fixture(scope="module")
def linear_cluster(tmp_path_factory):
    """One 2-replica cluster over a JAX-exported linear bundle (y = 2x),
    shared by the round-trip and hot-reload tests (the reload runs last)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TOS_SHM_RING", "0")
        export = str(tmp_path_factory.mktemp("linear") / "bundle")
        jckpt.export_bundle(export, jlin.init_params(LINEAR, scale=2.0), LINEAR)
        cluster = _serve_cluster(export)
        try:
            yield cluster, export
        finally:
            cluster.shutdown(timeout=120.0)


def test_gateway_round_trip_and_tcp_endpoint_and_coalescing(linear_cluster):
    cluster, export = linear_cluster
    gw = cluster.serve(export, max_batch=4, max_delay_ms=5.0, reload_poll_secs=0)
    rows = [np.arange(4, dtype=np.float32) + i for i in range(3)]

    out = gw.predict(rows, timeout=60.0)  # one result per row, in order
    assert len(out) == 3
    for i in range(3):
        np.testing.assert_allclose(out[i], rows[i] * 2.0)

    host, port = gw.endpoint  # the TCP endpoint: authkey + v2 frames
    client = GatewayClient("127.0.0.1", port, cluster.authkey)
    try:
        assert client.ping()
        np.testing.assert_allclose(client.predict(rows, timeout=60.0)[1],
                                   rows[1] * 2.0)
    finally:
        client.close()

    # five concurrent 1-row requests inside one delay window ride ONE batch
    before = telemetry.counter("serve.batches_total").value()
    gw2 = cluster.serve(export, max_batch=8, max_delay_ms=300.0, listen=False,
                        reload_poll_secs=0)
    results: dict = {}

    def one(i):
        results[i] = gw2.predict([rows[0] + i], timeout=60.0)[0]

    threads = [threading.Thread(target=one, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert telemetry.counter("serve.batches_total").value() - before == 1
    for i in range(5):
        np.testing.assert_allclose(results[i], (rows[0] + i) * 2.0)
    reg = telemetry.get_registry()
    assert reg.histogram("serve.request_secs").count >= 2
    assert reg.histogram("serve.batch_secs").count >= 2
    gw.close()
    gw2.close()


def test_gateway_hot_reload_swaps_bundle(linear_cluster):
    """Re-exporting into the served export_dir swaps predictions on every
    replica without restarting anything."""
    cluster, export = linear_cluster
    gw = cluster.serve(export, max_batch=4, max_delay_ms=2.0, listen=False,
                       reload_poll_secs=0.2)
    row = np.arange(4, dtype=np.float32) + 1.0
    np.testing.assert_allclose(gw.predict([row], timeout=60.0)[0], row * 2.0)
    before = telemetry.counter("serve.reloads_total").value()
    jckpt.export_bundle(export, jlin.init_params(LINEAR, scale=3.0), LINEAR)
    deadline = time.monotonic() + 60.0
    swapped = False
    while time.monotonic() < deadline and not swapped:
        out = gw.predict([row], timeout=30.0)[0]
        swapped = np.allclose(out, row * 3.0)
        if not swapped:
            np.testing.assert_allclose(out, row * 2.0)  # old, never junk
            time.sleep(0.2)
    assert swapped, "hot reload never swapped the bundle in"
    assert telemetry.counter("serve.reloads_total").value() > before
    gw.close()


def test_gateway_serves_a_jax_exported_lm_bundle(tmp_path, monkeypatch):
    """An LM bundle the JAX package exported, served by two port replicas:
    ``gateway.predict`` and ``GatewayClient`` give the JAX model's logits
    (f32, the port's plain attention on the CPU)."""
    monkeypatch.setenv("TOS_SHM_RING", "0")
    export = str(tmp_path / "lm")
    params = make_lm_params(LM, seed=5)  # random f32 weights, flax layout
    jckpt.export_bundle(export, params, LM)
    rng = np.random.RandomState(6)
    rows = [rng.randint(0, LM["vocab_size"], (SEQ,)).astype(np.int32)
            for _ in range(6)]
    want = np.asarray(jreg.build_apply(LM)(params, np.stack(rows)))
    cluster = _serve_cluster(export)
    try:
        gw = cluster.serve(export, max_batch=4, max_delay_ms=2.0,
                           reload_poll_secs=0)
        got = gw.predict(rows[:5], timeout=60.0)  # spans two batches
        client = GatewayClient("127.0.0.1", gw.endpoint[1], cluster.authkey)
        try:
            got += client.predict(rows[5:], timeout=60.0)
        finally:
            client.close()
    finally:
        cluster.shutdown(timeout=120.0)
    assert len(got) == len(rows)
    np.testing.assert_allclose(np.stack(got), want, atol=1e-4, rtol=1e-4)


@pytest.mark.chaos
def test_serving_survives_replica_kill_with_exactly_one_answer_each(
        tmp_path, monkeypatch):
    """SIGKILL a serving replica mid-flight (``TOS_FAULTINJECT=kill`` on its
    3rd consumed batch): the in-flight batch retries on the survivor, every
    accepted request is answered exactly once with the right result, and
    the elastic supervisor brings the slot back."""
    monkeypatch.setenv("TOS_SHM_RING", "0")  # a SIGKILL leaves rings wedged
    monkeypatch.setenv("TOS_DEAD_NODE_TIMEOUT", "4")
    monkeypatch.setenv("TOS_RESTART_BACKOFF_BASE", "0.2")
    telemetry.reset()
    export = str(tmp_path / "bundle")
    jckpt.export_bundle(export, jlin.init_params(LINEAR, scale=2.0), LINEAR)
    cluster = _serve_cluster(
        export, elastic=True,
        per_node_env=[{}, {"TOS_FAULTINJECT": "kill:after_batches=3,incarnation=0"}])
    try:
        gw = cluster.serve(export, max_batch=4, max_delay_ms=2.0, listen=False,
                           reload_poll_secs=0)
        base = np.arange(4, dtype=np.float32)
        answers: dict = {}
        errors: list = []
        lock = threading.Lock()

        def one(i):
            try:
                out = gw.predict([base + i], timeout=90.0)[0]
                with lock:
                    answers[i] = out
            except Exception as e:  # noqa: BLE001 - asserted empty below
                with lock:
                    errors.append((i, repr(e)))

        # sequential probes until the kill fired: the batch whose
        # consumption triggers the SIGKILL is in flight on the victim
        i = 0
        deadline = time.monotonic() + 90.0
        while (telemetry.counter("serve.replica_failures").value() == 0
               and time.monotonic() < deadline):
            one(i)
            i += 1
        assert telemetry.counter("serve.replica_failures").value() >= 1, \
            f"fault never fired after {i} sequential requests"
        threads = []
        n = 16
        for wave in range(n // 4):  # a concurrent burst on the survivor
            ws = [threading.Thread(target=one, args=(i + wave * 4 + j,))
                  for j in range(4)]
            threads += ws
            for t in ws:
                t.start()
            time.sleep(0.05)
        for t in threads:
            t.join(120.0)
        assert not errors, errors[:3]
        assert sorted(answers) == list(range(i + n))  # exactly once each
        for k, out in answers.items():
            np.testing.assert_allclose(out, (base + k) * 2.0)
        assert telemetry.counter("serve.retries_total").value() >= 1
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and len(gw.healthy_replicas()) < 2:
            time.sleep(0.5)
        assert gw.healthy_replicas() == [0, 1]
        np.testing.assert_allclose(gw.predict([base], timeout=60.0)[0],
                                   base * 2.0)
    finally:
        cluster.shutdown(timeout=120.0)
    assert telemetry.counter("elastic.restarts_total").value() >= 1
