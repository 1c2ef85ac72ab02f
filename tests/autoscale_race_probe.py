"""How long ``cluster.train`` takes at the settings of
``test_scale_in_non_elastic_drains_promptly`` (``tests/test_autoscale.py``
and its port's copy in ``tests/test_torch_autoscale.py``), in both
packages, alternating: the tests sleep 0.5 s and then expect the feed to be
still running, so this is the race they run.  Not collected by pytest::

    JAX_PLATFORMS=cpu python tests/autoscale_race_probe.py [ROUNDS] [RUNS]

Prints one line per ``train`` (host clock from ``run``'s return) and, per
package, the median, the spread and how many ended under 0.5 s.
"""

from __future__ import annotations

import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLEEP_S = 0.5  # the tests' sleep before they expect the trainer alive


def train_seconds(package: str, runs: int) -> list[float]:
    """``cluster.train`` seconds, ``runs`` times, for ``package`` ("torch"
    or "jax"), on a fresh 2-node STREAMING cluster each time."""
    os.environ["TOS_SHM_RING"] = "0"
    if package == "torch":
        from tensorflowonspark_torch import cluster, telemetry
        from tests import torch_mapfuns as mapfuns
    else:
        from tensorflowonspark_tpu import cluster, telemetry
        from tests import mapfuns
    out = []
    for _ in range(runs):
        telemetry.reset()
        items = list(range(80))
        parts = [items[i * 10:(i + 1) * 10] for i in range(8)]
        with tempfile.TemporaryDirectory() as tmp:
            c = cluster.run(mapfuns.record_items,
                            {"batch_size": 10, "out_dir": tmp, "sleep_per_batch": 0.15},
                            num_executors=2, input_mode=cluster.InputMode.STREAMING,
                            queue_capacity=4, heartbeat_interval=0.5,
                            reservation_timeout=120.0, elastic=False)
            t0 = time.perf_counter()
            c.train(parts, num_epochs=1)
            out.append(time.perf_counter() - t0)
            c.shutdown(timeout=60)
        print(f"{package} train {out[-1]:.3f} s", flush=True)
    return out


def main() -> int:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    runs = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    if len(sys.argv) > 3:  # a child: one package's runs
        sys.path.insert(0, ROOT)
        for s in train_seconds(sys.argv[3], runs):
            print(f"SECONDS {s}")
        return 0
    import subprocess

    got: dict[str, list[float]] = {"torch": [], "jax": []}
    for _ in range(rounds):
        for package in got:
            res = subprocess.run([sys.executable, __file__, "1", str(runs), package],
                                 capture_output=True, text=True, timeout=600, check=True)
            got[package] += [float(line.split()[1]) for line in res.stdout.splitlines()
                             if line.startswith("SECONDS")]
    for package, secs in got.items():
        print(f"{package}: {len(secs)} runs, median {statistics.median(secs):.3f} s, "
              f"{min(secs):.3f}-{max(secs):.3f}, {sum(s < SLEEP_S for s in secs)} under "
              f"{SLEEP_S} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
