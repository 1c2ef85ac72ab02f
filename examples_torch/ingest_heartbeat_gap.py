"""The longest heartbeat silence the coordinator sees of each node while
``chip_smoke.py``'s ingest phase runs (``phase_ingest_resnet50``: run A
twice with node-local readers, run B with one data-service worker).

A node silent past the driver's dead-node window (``TOS_DEAD_NODE_TIMEOUT``,
12 s by default) is declared dead and fenced, healthy or not, so this is
the margin the phase runs with.  Each tree given is run once, in order, in
a process of its own that imports that tree's ``chip_smoke`` and port; a
parent and a change compare on one card when their rounds alternate::

    git archive <parent> | tar -x -C _archive_check/parent
    python3 examples_torch/ingest_heartbeat_gap.py \\
        --trees _archive_check/parent . . _archive_check/parent

One line ``GAP {...}`` a round: whether the phase passed, its seconds, and
``max_silence_s`` per ``cluster<i>_node<j>`` (the phase's clusters in the
order they start: run A, run A untraced, run B).  ``--cpu`` rehearses it
at the CPU test's small sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import traceback


def one_round(tree: str, cpu: bool) -> dict:
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs

    from tensorflowonspark_torch import coordinator as co

    servers, gaps = [], {}
    init = co.CoordinatorServer.__init__

    def tracked_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        servers.append(self)

    co.CoordinatorServer.__init__ = tracked_init
    stop = threading.Event()

    def sample() -> None:
        while not stop.wait(0.05):
            now = time.monotonic()
            for n, server in enumerate(list(servers)):
                with server._lock:
                    for eid, seen in server._last_seen.items():
                        key = f"cluster{n}_node{eid}"
                        gaps[key] = max(gaps.get(key, 0.0), now - seen)

    threading.Thread(target=sample, daemon=True).start()
    out: dict = {"tree": tree}
    t0 = time.time()
    try:
        if cpu:
            cs.RESNET_CONFIG = {"model": "resnet_cifar", "depth_blocks": 1,
                                "width": 8, "num_classes": 10, "bf16": False}
            cs.RESNET_BATCH, cs.RESNET_SIZE = 16, 32
            cs.INGEST_IMAGES, cs.INGEST_PER_SHARD = 96, 24
            cs.phase_ingest_resnet50(0, "cpu", None, device="cpu")
        else:
            cs.phase_ingest_resnet50(0, cs.phase_device(), None)
        out["ok"] = True
    except Exception as e:  # noqa: BLE001 - the round's outcome is the report
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"[:600]
        traceback.print_exc()
    stop.set()
    out["seconds"] = round(time.time() - t0, 1)
    out["max_silence_s"] = {k: round(v, 3) for k, v in sorted(gaps.items())}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."],
                    help="checkouts to run, one round each, in this order")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse at the CPU test's sizes")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print("GAP " + json.dumps(one_round(args.one, args.cpu)), flush=True)
        return 0
    failed = 0
    for tree in args.trees:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", os.path.abspath(tree)]
        proc = subprocess.run(cmd + (["--cpu"] if args.cpu else []),
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("GAP ")]
        if proc.returncode or not lines:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            failed += 1
            continue
        print(lines[-1], flush=True)
        failed += not json.loads(lines[-1][4:])["ok"]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
