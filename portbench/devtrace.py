"""What a traced run reads from ``torch.profiler``'s events, in memory (no
trace file is written): the device operations inside the window, the
device's busy time (the union of their intervals), and its idle gaps named
by what the host was doing when each began.

The window is the ``portbench.window`` range the harness records; the
harness also records ``portbench.feed`` around each ``next()`` of the
batch iterator and ``portbench.step`` around each step call.  A device
operation is a kernel, a copy or a memset: the device-side copies of
host ranges are left out.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

WINDOW = "portbench.window"
TOP = 10          # entries of each breakdown list
NAME_CHARS = 160  # a kernel's name is cut to this many characters


@dataclasses.dataclass
class TraceView:
    window_s: float
    busy_s: float
    ops: dict          # device operation name -> [seconds of each run in the window]
    idle_by_host: dict  # host activity -> idle seconds that began under it

    def calls(self, pattern) -> list:
        """Durations of the device operations whose name matches ``pattern``."""
        return [d for name, runs in self.ops.items() if pattern.search(name) for d in runs]

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top({k[:NAME_CHARS]: sum(v) for k, v in self.ops.items()}),
                "idle_gaps": top(self.idle_by_host)}


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def read(profiler) -> TraceView:
    """The view of a finished ``torch.profiler.profile``."""
    events = profiler.profiler.kineto_results.events()
    window = next(e for e in events if e.name() == WINDOW)
    w0, w1 = window.start_ns(), window.start_ns() + window.duration_ns()
    main = window.start_thread_id()
    device, host = [], []
    for e in events:
        kind = str(e.device_type())
        start = e.start_ns()
        end = start + e.duration_ns()
        if kind.endswith("CUDA"):
            # a range recorded on the host shows on the device's timeline
            # too, over the kernels it launched: it is not an operation
            if end > w0 and start < w1 and not e.is_user_annotation():
                device.append((max(start, w0), min(end, w1), e.name()))
        elif end > w0 and start < w1 and e.name() != WINDOW:
            host.append((start, end, e.name(), e.start_thread_id()))
    ops = collections.defaultdict(list)
    for start, end, name in device:
        ops[name].append((end - start) * 1e-9)
    busy = _union((s, e) for s, e, _ in device)
    gaps, at = [], w0
    for start, end in busy:
        if start > at:
            gaps.append((at, start))
        at = max(at, end)
    if at < w1:
        gaps.append((at, w1))
    return TraceView(window_s=(w1 - w0) * 1e-9,
                     busy_s=sum(e - s for s, e in busy) * 1e-9,
                     ops=dict(ops), idle_by_host=_idle_by_host(gaps, host, main))


def _idle_by_host(gaps, host, main) -> dict:
    """Idle seconds by what the host was doing when each gap began: the
    harness range open on the main thread, and the innermost range open
    on any thread (the backward runs on autograd's), the latest begun."""
    host.sort(key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    out = collections.defaultdict(float)
    stacks: dict = collections.defaultdict(list)
    i = 0
    for g0, g1 in gaps:
        j = bisect.bisect_right(starts, g0)
        for start, end, name, tid in host[i:j]:
            stack = stacks[tid]
            while stack and stack[-1][1] <= start:
                stack.pop()
            stack.append((start, end, name))
        i = max(i, j)
        for stack in stacks.values():
            while stack and stack[-1][1] <= g0:
                stack.pop()
        harness = next((n for _, _, n in reversed(stacks[main]) if n.startswith("portbench.")),
                       "outside the harness")
        tops = [st[-1] for st in stacks.values() if st and not st[-1][2].startswith("portbench.")]
        label = f"{harness} / {max(tops)[2]}" if tops else harness
        out[label] += (g1 - g0) * 1e-9
    return dict(out)
