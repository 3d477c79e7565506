"""Reading one torch.profiler trace of the window (CUDA activity alone):
device activity, the kernels by name, and the host's spans over the idle
gaps.

The device's busy time is the union of every CUDA interval (kernels,
copies, sets) inside the window; the idle share is what is left of the
window.  Kernels are grouped by name: a fill kernel's name holds
FILL_NAME, a walk's WALK_NAMES.  The window and the host's spans (the
benchmark's "bench.*" spans and the program's PhaseTimer phases, as
"phase.<name>") are taken on the host's realtime clock beside the trace;
an idle gap is labelled by the innermost span that covers its middle.
"""

from __future__ import annotations

from collections import defaultdict

WINDOW = "bench.window"
FILL_NAME = "fill_kernel"
WALK_NAMES = ("walk_kernel", "compact_events_kernel")


def _events(prof):
    """(name, on_device, start_ns, end_ns) of every recorded event, and
    the trace's start (ns, on the trace's clock)."""
    results = prof.profiler.kineto_results
    return ([(e.name(), e.device_type().name == "CUDA", e.start_ns(),
              e.end_ns()) for e in results.events()],
            results.trace_start_ns())


def clock_offset(trace_start, clocks: dict) -> tuple[str, int]:
    """The clock the trace's times are on, of the host's `clocks` read as
    the trace began ({"realtime": ns, "monotonic": ns}), and what to add
    to a realtime reading to put it on that clock: the one whose reading
    lies nearest the trace's start."""
    name = min(clocks, key=lambda k: abs(clocks[k] - trace_start))
    return name, clocks[name] - clocks["realtime"]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(prof, spans, clocks) -> dict:
    """busy_s, window_s, kernel seconds by name, fill and walk kernel
    counts and seconds, the top device operations and the idle gaps'
    seconds by host span.  spans: (start_ns, end_ns, name) on the host's
    realtime clock, the window's among them; clocks: the host's clocks
    as the trace began."""
    events, trace_start = _events(prof)
    clock, shift = clock_offset(trace_start, clocks)
    spans = [(s + shift, e + shift, n) for s, e, n in spans]
    window = [(s, e) for s, e, n in spans if n == WINDOW]
    if not window:
        raise RuntimeError("no window span was taken")
    w0, w1 = window[0]
    device = [(n, max(s, w0), min(e, w1)) for n, dev, s, e in events
              if dev and e > w0 and s < w1]
    busy = _union([(s, e) for _, s, e in device])
    by_name: dict[str, float] = defaultdict(float)
    for n, s, e in device:
        by_name[n] += (e - s) / 1e9
    fill = [(n, s, e) for n, s, e in device if FILL_NAME in n]
    walk = [(n, s, e) for n, s, e in device
            if any(w in n for w in WALK_NAMES)]
    spans = [(s, e, n) for s, e, n in spans if e > w0 and s < w1]
    gaps = []
    at = w0
    for s, e in busy + [[w1, w1]]:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    idle: dict[str, float] = defaultdict(float)
    # spans nest (one host thread takes them): sweep the gaps' middles
    # in order, keeping the stack of spans open there; its top is the
    # innermost
    spans.sort(key=lambda sp: (sp[0], -sp[1]))
    stack, k = [], 0
    for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (s + e) / 2
        while k < len(spans) and spans[k][0] <= mid:
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        idle[stack[-1][2] if stack else "outside any span"] += (e - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "clock": clock,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "fill_launches": len(fill),
        "fill_s": sum(e - s for _, s, e in fill) / 1e9,
        "walk_launches": len(walk),
        "walk_s": sum(e - s for _, s, e in walk) / 1e9,
        "device_ops": [[n, t] for n, t in top],
        "idle_gaps": [[n, t] for n, t in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }
