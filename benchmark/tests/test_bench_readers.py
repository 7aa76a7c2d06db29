"""The trace and log readers, on recorded logs and on the CPU's
profiler; the device trace on a card."""

import os

import pytest
import torch

from benchmark import readers

DATA = os.path.join(os.path.dirname(__file__), "data")


def test_stage_seconds_of_a_recorded_log():
    with open(os.path.join(DATA, "stagetimer.log")) as f:
        text = f.read()
    st = readers.stage_seconds(text)
    assert "calling consensus sequence between anchors..." in st
    assert len(st) == 15
    assert sum(st.values()) == pytest.approx(0.37)
    assert min(st.values()) >= 0


def test_union_busy_and_idle_gaps():
    ev = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k1", 5.0, 6.0)]
    assert readers.union([(e[1], e[2]) for e in ev]) == [(1.0, 3.0),
                                                         (5.0, 6.0)]
    assert readers.busy_seconds(ev) == pytest.approx(3.0)
    spans = [("outer", 0.0, 10.0), ("inner", 3.0, 5.0)]
    gaps = readers.idle_gaps(ev, spans, 0.0, 8.0)
    assert gaps == [["inner", 2.0], ["outer", 2.0], ["outer", 1.0]]
    assert readers.kernel_seconds(ev, "k1") == pytest.approx(2.0)
    assert readers.top_ops(ev)[0] == ["k1", pytest.approx(2.0)]


def test_metric_helpers():
    ctx = {"passes": [{"layers": {"consensus": {"pack": 1.0}}},
                      {"layers": {"consensus": {"pack": 3.0}}},
                      {"layers": {"consensus": {}}}],
           "events": [("rowscan_kernel<VotesEmit, 4, 1>", 0.0, 0.5)],
           "busy_s": 0.5, "window_s": 2.0,
           "cells": {"rowscan_votes": 10**9}, "v1_bytes": 0}
    assert readers.mean_over_passes(
        ctx, lambda p: p["consensus"].get("pack")) == 2.0
    assert readers.idle_pct(ctx) == 75.0
    from benchmark import counts
    got = readers.nw_roofline_pct(
        ctx, {"rowscan_votes": ("rowscan_kernel", "VotesEmit")})
    assert got == pytest.approx(100 * counts.dp_seconds(10**9) / 0.5)
    assert readers.nw_roofline_pct(
        ctx, {"wavefront_votes": ("wf_walk_kernel", "VotesEmit")}) is None
    assert readers.idle_pct(dict(ctx, events=[])) is None


def test_host_spans_on_the_cpu_profiler():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.span"):
            torch.ones(64).sum()
    spans = readers.host_spans(prof, {"bench.span"})
    assert len(spans) == 1 and spans[0][2] > spans[0][1]
    assert readers.device_events(prof) == []


@pytest.mark.card
def test_device_trace_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            x = x * 2
        torch.cuda.synchronize()
    ev = readers.device_events(prof)
    assert len(ev) >= 10
    assert 0 < readers.busy_seconds(ev) < 1
