#!/usr/bin/env python3
"""The benchmark of the PyTorch / H100 port (``tensorflowonspark_torch``): one
run of one cell, as one process on one machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The run finds the cell's files by name
(``bench.py``), makes the weights and the traffic from ``--seed``, builds
the libraries the cell's path loads, takes the program through its first
steps (set-up, which also warms every shape the window uses), then
measures for ``--seconds``: the window opens and closes at a
``torch.cuda.synchronize()``, and each step's completion is a CUDA event
read once the window has closed.  ``--trace 1`` runs ``torch.profiler``
over the window and reports the per-layer metrics instead of the
end-to-end ones.  After the window the program is freed and the plain
reference follows its first steps; ``correct`` is the comparison of the
two (``compare.py``) against the cell's limits.

The last line of standard output is the result; the last lines of standard
error are the numbers compared, each beside its limit.  A machine without
as many CUDA cards as the cell asks for gets no result and a non-zero exit.
"""

import time

_STARTED = time.perf_counter()  # before the heavy imports: set-up counts them

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorflowonspark_tpu")
# every build and kernel cache under the checkout, at fixed paths
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda"}
CACHE_ROOT = "portbench_cache"


def log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def set_environment(root: Path) -> None:
    """Before torch is imported: the caches inside the checkout, and no
    Flax or JAX behind a library's back."""
    os.environ["USE_FLAX"] = "0"
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(root / CACHE_ROOT / sub)


def loaded_forbidden() -> list:
    """The JAX-side packages in ``sys.modules``, by whole top-level name."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    import torch

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        smi = f"not read ({err})"
    return (f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi name, power limit, "
            f"max SM clock: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")


class _Window:
    """The measured window's readings."""

    def __init__(self):
        self.losses, self.feed_ms, self.host_ms, self.stamps = [], [], [], []
        self.seconds = 0.0
        self.started = 0.0


def run_window(session, seconds: float, traced: bool, cuda: bool) -> tuple:
    """Steps until ``seconds`` have passed on the host clock, then waits for
    the card; returns ``(window, profiler or None)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import devtrace

    def mark(name):
        return record_function(name) if traced else contextlib.nullcontext()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def stamp():
        if cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    profiler = profile(activities=activities) if traced else contextlib.nullcontext()
    w = _Window()
    sync()
    with profiler:
        with mark(devtrace.WINDOW):
            sync()
            w.started = start = time.perf_counter()
            w.stamps.append(stamp())
            while True:
                a = time.perf_counter()
                with mark("portbench.feed"):
                    batch = session.next_batch()
                b = time.perf_counter()
                with mark("portbench.step"):
                    w.losses.append(session.train_step(batch))
                c = time.perf_counter()
                w.stamps.append(stamp())
                w.feed_ms.append((b - a) * 1e3)
                w.host_ms.append((c - b) * 1e3)
                if c - start >= seconds:
                    break
            sync()
            w.seconds = time.perf_counter() - start
    return w, (profiler if traced else None)


def step_ms(stamps: list, cuda: bool) -> list:
    if cuda:
        return [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
    return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]


def run_cell(root, name: str, seed: int, seconds: float, traced: bool, device: str,
             started: float) -> tuple[dict, dict]:
    """One run of cell ``name``; returns ``(result, checks)``."""
    import torch

    from portbench import compare, devtrace
    from portbench.bench import Bench
    from portbench.record import RunRecord

    cuda = torch.device(device).type == "cuda"
    bench = Bench(root)
    cell = bench.workload(name)
    cfg, mix = bench.config(cell["config"]), bench.mix(cell["traffic"])
    entry = bench.entry(cell["entry"])
    wanted = bench.metrics_for(name, traced)
    readers = {m["name"]: bench.reader(m["name"]) for m in wanted}
    if cuda:
        log(card_line())
        if cell["builds"]:
            from tensorflowonspark_torch.ops import cuda_build

            t = time.perf_counter()
            cuda_build.load_libraries(*cell["builds"])
            log(f"[setup] kernel libraries {cell['builds']} built or loaded in "
                f"{time.perf_counter() - t:.3f} s (a build only where the checkout "
                f"holds none)")
    session = entry.build(cfg, mix, seed, device, log)
    program = session.first_steps(cell["proof_steps"], log)
    log(f"[setup] first {cell['proof_steps']} steps: losses {program['loss']}")
    win, profiler = run_window(session, seconds, traced, cuda)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    view = None
    if profiler is not None:
        t = time.perf_counter()
        view = devtrace.read(profiler)
        log(f"[trace] {sum(map(len, view.ops.values()))} device operations in the "
            f"window, read in {time.perf_counter() - t:.3f} s")
    del profiler
    record = RunRecord(cell=cell, config=cfg, mix=mix, shapes=session.shapes,
                       unit=session.unit, units_per_step=session.units_per_step,
                       setup_s=win.started - started, window_s=win.seconds,
                       step_ms=step_ms(win.stamps, cuda), feed_ms=win.feed_ms,
                       host_ms=win.host_ms, trace=view)
    metrics = {}
    for m in wanted:
        if not cuda and m["source"] == "device_trace":
            continue  # a CPU run never reports a device's metric
        value = readers[m["name"]].read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    losses = torch.stack([x.detach().float() for x in win.losses])
    failed = int((~torch.isfinite(losses)).sum())
    log(f"[window] {record.steps} steps in {win.seconds:.3f} s; setup {record.setup_s:.3f} s; "
        f"peak memory {peak} bytes; last loss {losses[-1].item():.6f}")
    session.close()
    del session, win, losses
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t = time.perf_counter()
    reference = entry.reference(cfg, mix, seed, device, cell["proof_steps"])
    log(f"[reference] {cell['proof_steps']} steps of the plain reference in "
        f"{time.perf_counter() - t:.3f} s; losses {reference['loss']}")
    found = compare.numbers(program, reference, cfg["optimizer"]["name"])
    limits = dict(cell["limits"])
    if "path_mismatch" in program:
        found["kernel_path"] = (program["path_mismatch"], "first steps")
        limits["kernel_path"] = 0
    correct, checks = compare.judge(found, limits)
    device_facts = {"platform": "gpu" if cuda else "cpu",
                    "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                    "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": record.steps, "failed": failed,
              "metrics": metrics, "device": device_facts}
    if view is not None:
        device_facts.update(busy_s=view.busy_s, window_s=view.window_s)
        result["breakdown"] = view.breakdown()
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed is a non-negative whole number")
    set_environment(ROOT)
    import torch

    from portbench.bench import Bench

    chips = Bench(ROOT).workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: {args.workload} needs {chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, checks = run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", _STARTED)
    found = loaded_forbidden()
    if found:
        log(f"no result: the process holds {found}, which the port must not load")
        return 3
    for name, check in checks.items():
        log(f"[check] {name} {check['value']} limit {check['limit']} (at {check['at']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root, not portbench/, on the path
    sys.exit(main())
