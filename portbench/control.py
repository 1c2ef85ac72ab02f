#!/usr/bin/env python3
"""The readings a cell's limits are set from, at the cell's own size: the
program's first steps against the plain reference over many seeds (the
lower readings), the control (the reference in float8, the precision below
the configuration's bfloat16, in the program's place) and the planted
faults (``faults.py``) against it on some of them (the upper readings).
The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2] [--faults half_batch,unchanged] [--out FILE]

One JSON line a reading goes to ``--out`` (and the same to standard
output): ``{"seed", "side", "numbers": {name: [value, where]}}``, with
``side`` ``program``, ``control`` or a fault's name.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(root, name: str, seeds: list, control_seeds: list, faults: list,
             device: str, emit) -> None:
    import torch

    from portbench import compare
    from portbench.bench import Bench
    from portbench.faults import planted

    bench = Bench(root)
    cell = bench.workload(name)
    cfg, mix = bench.config(cell["config"]), bench.mix(cell["traffic"])
    entry = bench.entry(cell["entry"])
    steps, optimizer = cell["proof_steps"], cfg["optimizer"]["name"]
    cuda = torch.device(device).type == "cuda"
    if cuda and cell["builds"]:
        from tensorflowonspark_torch.ops import cuda_build

        cuda_build.load_libraries(*cell["builds"])

    def free():
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def program(seed, fault=None):
        with planted(fault):
            session = entry.build(cfg, mix, seed, device, lambda m: None)
            try:
                return session.first_steps(steps, lambda m: None)
            finally:
                session.close()
                del session
                free()

    for seed in seeds:
        t = time.perf_counter()
        reference = entry.reference(cfg, mix, seed, device, steps)
        free()
        sides = [("program", program(seed))]
        if seed in control_seeds:
            sides.append(("control", entry.reference(cfg, mix, seed, device, steps,
                                                     precision="float8")))
            free()
            sides += [(fault, program(seed, fault)) for fault in faults]
        for side, found in sides:
            emit({"seed": seed, "side": side,
                  "numbers": compare.numbers(found, reference, optimizer),
                  "loss": found["loss"], "reference_loss": reference["loss"],
                  "seconds": time.perf_counter() - t})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--faults", default="")
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    def ints(text):
        return [int(x) for x in text.split(",") if x]

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None  # noqa: SIM115 - closed below

    def emit(line):
        text = json.dumps({"workload": args.workload, **line})
        print(text, flush=True)
        if out is not None:
            out.write(text + "\n")
            out.flush()

    try:
        readings(ROOT, args.workload, ints(args.seeds), ints(args.control_seeds),
                 [f for f in args.faults.split(",") if f], "cuda", emit)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
