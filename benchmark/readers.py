"""Readers of what a traced run leaves: the profiler's device activity
(kernel time by name, the device's busy seconds, idle gaps labelled by
the benchmark's host spans) and the assembler's ``StageTimer`` log."""

from __future__ import annotations

import re

_NOTE = re.compile(r"^\[NOTE\] (.*)$")
_ELAPSED = re.compile(r"elapsed time [-0-9.]+ CPU seconds \(([-0-9.]+) real "
                      r"seconds\)")


def stage_seconds(log_text: str) -> dict:
    """Real seconds of each stage of a ``run_assembler`` log: the
    ``StageTimer`` prints a ``[NOTE]`` as a stage starts and the
    cumulative real seconds as it ends.  Stages of the same note add."""
    out, note, last = {}, None, 0.0
    for line in log_text.splitlines():
        m = _NOTE.match(line.strip())
        if m:
            note = m.group(1)
            continue
        m = _ELAPSED.search(line)
        if m:
            t = float(m.group(1))
            key = note if note is not None else "(start)"
            out[key] = out.get(key, 0.0) + t - last
            last = t
    return out


def device_events(prof) -> list:
    """``(name, start_s, end_s)`` of every operation that ran on the
    card while ``prof`` (a finished ``torch.profiler.profile``) traced:
    kernels, copies and fills."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        # a record_function range is mirrored on the device's timeline
        # as an annotation: no operation ran there
        if e.device_type() != DeviceType.CUDA or getattr(
                e, "is_user_annotation", lambda: False)():
            continue
        t0 = e.start_ns() * 1e-9
        out.append((e.name(), t0, t0 + e.duration_ns() * 1e-9))
    return out


def host_spans(prof, names) -> list:
    """``(name, start_s, end_s)`` of the host ranges in ``names`` (the
    benchmark's ``record_function`` spans) on the profiler's clock."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in names:
            t0 = e.start_ns() * 1e-9
            out.append((e.name(), t0, t0 + e.duration_ns() * 1e-9))
    return out


def union(intervals) -> list:
    """The union of ``(start, end)`` pairs, as sorted disjoint pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy_seconds(events) -> float:
    """Seconds in which some operation ran on the card."""
    return sum(b - a for a, b in union((e[1], e[2]) for e in events))


def kernel_seconds(events, *parts) -> float:
    """Device seconds of the operations whose name holds every one of
    ``parts``."""
    return sum(b - a for name, a, b in events
               if all(p in name for p in parts))


def idle_gaps(events, spans, start: float, end: float, top: int = 10):
    """The ``top`` longest stretches of ``[start, end]`` in which nothing
    ran on the card, cut where the host moved from one span to another
    and each named by the innermost host span it lies in (``"host"``
    where none is): ``[[name, seconds], ...]``."""
    gaps, t = [], start
    for a, b in union((e[1], e[2]) for e in events):
        if a > t:
            gaps.append((t, min(a, end)))
        t = max(t, b)
    if t < end:
        gaps.append((t, end))
    cuts = sorted({x for s in spans for x in (s[1], s[2])})
    out = []
    for a, b in gaps:
        edges = [a] + [c for c in cuts if a < c < b] + [b]
        pieces = []
        for lo, hi in zip(edges, edges[1:]):
            mid = (lo + hi) / 2
            around = [s for s in spans if s[1] <= mid <= s[2]]
            name = (min(around, key=lambda s: s[2] - s[1])[0] if around
                    else "host")
            if pieces and pieces[-1][0] == name:
                pieces[-1][1] += hi - lo
            else:
                pieces.append([name, hi - lo])
        out.extend(p for p in pieces if p[1] > 0)
    out.sort(key=lambda g: -g[1])
    return out[:top]


def top_ops(events, top: int = 10):
    """The ``top`` device operations by total seconds: ``[[name, s]]``."""
    by = {}
    for name, a, b in events:
        by[name] = by.get(name, 0.0) + (b - a)
    return [[k[:120], v] for k, v in sorted(by.items(),
                                            key=lambda kv: -kv[1])[:top]]


# -- helpers of the per-layer metric readers (benchmark/metrics/*.py) --

def mean_over_passes(ctx, fn):
    """Mean of ``fn(pass layers)`` over the traced passes; None where it
    finds nothing to read."""
    vals = [fn(p["layers"]) for p in ctx["passes"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None


def idle_pct(ctx):
    """The card's idle share of the traced window, in %."""
    if not ctx["events"] or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def nw_roofline_pct(ctx, kernels):
    """Share of the int32 roofline of the banded-DP kernels ``kernels``
    (``{launch name: name parts of the device kernel}``), in %."""
    from benchmark import counts

    cells = sum(ctx["cells"].get(k, 0) for k in kernels)
    t = sum(kernel_seconds(ctx["events"], *parts)
            for parts in kernels.values())
    if cells <= 0 or t <= 0:
        return None
    return 100.0 * counts.dp_seconds(cells) / t
