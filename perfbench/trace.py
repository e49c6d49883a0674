"""Device traces: a profiled sub-window reduced to the numbers the
per-layer metrics read.

``profiled(work)`` runs ``work()`` under ``torch.profiler`` (CPU and CUDA
activities; the trace stays in memory) inside a ``bench.subwindow`` span
and returns a :class:`Trace`: the device's busy time (the union of the
intervals of every operation that ran on it: kernels, copies, fills), the
traced window's length, kernel time by name, the idle gaps labelled by the
host span that was open across them, and the launch check: every runtime
launch call of the window against the device events it correlates with,
and kernel counts by name for the caller to hold against the program's
launch counters. A trace in which a launch has no device event has dropped
events and is not to be read.
"""

from __future__ import annotations

import collections
import dataclasses
import re
from typing import Callable, Dict, List, Optional, Tuple

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelEx")
GRAPH_LAUNCH = "cudaGraphLaunch"


@dataclasses.dataclass
class Trace:
    window_s: float                  # the traced sub-window, on the profiler's clock
    busy_s: float                    # union of device intervals inside it
    kernels: Dict[str, Tuple[int, float]]   # name -> (count, seconds)
    device_ops: List[Tuple[str, float]]     # top device ops by time
    idle_gaps: List[Tuple[str, float]]      # longest gaps by the host span open across them
    launches: int                    # runtime kernel launches (not graphs) in the window
    graph_launches: int
    launches_without_event: int      # launches with no device event: dropped
    graph_launches_without_event: int
    kernel_events: int

    def count(self, substring: str) -> int:
        return sum(n for name, (n, _) in self.kernels.items() if substring in name)

    @property
    def sound(self) -> bool:
        return (self.launches_without_event == 0 and self.graph_launches_without_event == 0
                and self.kernel_events > 0)

    def check_line(self, pairs: Dict[str, Tuple[int, int]]) -> dict:
        """The launch check as one record: ``pairs`` maps a kernel name to
        (the program's launch counter over the window, kernel events)."""
        return {"launches": self.launches, "graph_launches": self.graph_launches,
                "launches_without_event": self.launches_without_event,
                "graph_launches_without_event": self.graph_launches_without_event,
                "kernel_events": self.kernel_events,
                "counters": {k: {"counter": c, "events": e} for k, (c, e) in pairs.items()},
                "agree": self.sound and all(c == e for c, e in pairs.values())}


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def profiled(work: Callable[[], None], synchronize: Callable[[], None],
             host_ops: bool = True) -> Trace:
    """``host_ops`` False records the device and the runtime calls only:
    far less overhead a launch, where a step launches thousands of
    kernels; the window is then the span of the recorded calls and
    device operations."""
    from torch.profiler import ProfilerActivity, profile, record_function

    synchronize()
    import torch

    host_ops = host_ops or not torch.cuda.is_available()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        with record_function("bench.subwindow"):
            work()
            synchronize()
    return reduce(prof.profiler.kineto_results.events())


_RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def _kind(e) -> str:
    """kernel, gpu_memcpy, gpu_memset, cuda_runtime or cpu (older torch
    has no ``activity_type``)."""
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        return "cuda_runtime" if kind == "cuda_driver" else kind
    name = e.name()
    if e.device_type().name == "CUDA":
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return "cuda_runtime" if _RUNTIME.match(name) else "cpu"


def reduce(events) -> Trace:
    window: Optional[Tuple[int, int]] = None
    device, runtime, host = [], [], []
    events = list(events)
    # a span recorded on the host is mirrored on the device's timeline: it
    # is no device operation
    host_names = {e.name() for e in events if e.device_type().name != "CUDA"}
    for e in events:
        if e.device_type().name == "CUDA" and e.name() in host_names:
            continue
        kind, name = _kind(e), e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if name == "bench.subwindow":
            window = (a, b)
        elif kind in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((name, kind, a, b, e.correlation_id()))
        else:
            host.append((name, a, b))
            if kind == "cuda_runtime":
                runtime.append((name, a, b, e.correlation_id()))
    if window is None:
        if not device:
            raise RuntimeError("the profiler recorded no bench.subwindow span and no device op")
        window = (min([d[2] for d in device] + [r[1] for r in runtime]),
                  max(d[3] for d in device))
    lo, hi = window
    device = [d for d in device if d[3] > lo and d[2] < hi]
    spans = _union([(max(a, lo), min(b, hi)) for _, _, a, b, _ in device])
    busy = sum(b - a for a, b in spans)

    by_corr = collections.Counter(d[4] for d in device)
    launches = graph = no_event = graph_no_event = 0
    for name, a, b, corr in runtime:
        if not (lo <= a <= hi):
            continue
        if name == GRAPH_LAUNCH:
            graph += 1
            graph_no_event += by_corr[corr] == 0
        elif name in LAUNCH_CALLS:
            launches += 1
            no_event += by_corr[corr] == 0

    kernels: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0.0])
    for name, kind, a, b, _ in device:
        if kind == "kernel":
            kernels[name][0] += 1
        kernels[name][1] += (b - a) * 1e-9
    top = sorted(((n, s) for n, (_, s) in kernels.items()), key=lambda t: -t[1])[:10]

    gaps = []
    edges = [lo] + [x for ab in spans for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:10]:
        mid = (a + b) // 2
        cover = [(e - s, n) for n, s, e in host if s <= mid <= e]
        labelled.append((min(cover)[1] if cover else "host:none", (b - a) * 1e-9))
    return Trace(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
                 kernels={n: (int(c), s) for n, (c, s) in kernels.items()},
                 device_ops=top, idle_gaps=labelled, launches=launches, graph_launches=graph,
                 launches_without_event=no_event, graph_launches_without_event=graph_no_event,
                 kernel_events=sum(int(c) for c, _ in kernels.values()))
