"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration (``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``, which names the stage module
under ``benchmark/stages/`` and its parameters); its limits are in
``benchmark/limits/<cell>.json`` and each per-layer metric's reader is
``benchmark/metrics/<metric>.py``.

A run generates the cell's input from the seed, runs one warm-up pass
on a slice of it (every kernel built and loaded), then whole passes of
the stage's public entry over the whole input, each into a new, empty
directory, while the time left holds another pass.  ``--trace 1``
traces the same window with ``torch.profiler`` and reports the
per-layer metrics in place of the end-to-end ones.  Once the window has
closed, the plain reference judges the last pass's output (every pass's
output must be the same bytes), and the result line is printed.
"""

from __future__ import annotations

import time

T_START = time.time()   # set-up is counted from here, before torch loads

import argparse  # noqa: E402
import hashlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "haslr_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_of(sp: dict, name: str) -> dict:
    for w in sp["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_inputs(sp: dict, name: str):
    """(cell, configuration, traffic, limits, stage module) of a cell."""
    cell = cell_of(sp, name)
    cfg = load_json(BENCH, "configs", cell["config"] + ".json")
    traffic = load_json(BENCH, "traffic", cell["traffic"] + ".json")
    limits = load_json(BENCH, "limits", name + ".json")
    stage = importlib.import_module("benchmark.stages." + traffic["stage"])
    return cell, cfg, traffic, limits, stage


def metric_reader(name: str):
    path = os.path.join(BENCH, "metrics", name + ".py")
    sp = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def cell_metrics(sp: dict, name: str, rate: str):
    """The cell's end-to-end metrics and its per-layer metrics.

    An end-to-end metric with a ``workloads`` list belongs to the cells
    it names.  One without a list belongs to every cell whose run
    reports it: the stage's ``rate`` and ``setup_s``, which every run
    reports.  So a cell enters with new files and new entries alone,
    and a cell of another stage is never held to a rate it does not
    report.  A per-layer metric with a list belongs to the cells it
    names; one without, to every cell that has the metric it moves."""
    reported = {rate, "setup_s"}
    e2e = [m for m in sp["end_to_end"]
           if (name in m["workloads"] if "workloads" in m
               else m["name"] in reported)]
    e2e_names = {m["name"] for m in e2e}
    per = []
    for m in sp["per_layer"]:
        if ("workloads" in m and name in m["workloads"]) or (
                "workloads" not in m and m["moves"] in e2e_names):
            per.append(m)
    if rate not in e2e_names:
        raise SystemExit(f"{name}: BENCHMARK.json gives it no {rate}")
    return e2e, per


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def digest(out_dir: str, files) -> str:
    h = hashlib.sha256()
    for f in files:
        with open(os.path.join(out_dir, f), "rb") as fp:
            while chunk := fp.read(1 << 20):
                h.update(chunk)
    return h.hexdigest()


def window(stage, st, work, seconds, device):
    """Whole passes while the time left holds another (judged by the
    mean of the passes so far); returns (passes, start, end), each pass
    ``{"seconds", "digest", "layers"}``, the last pass's output kept in
    ``work/last``."""
    import torch

    passes, t0, last = [], time.time(), None
    while True:
        out = os.path.join(work, f"pass{len(passes)}")
        os.makedirs(out)
        a = time.time()
        layers = stage.run_pass(st, out, device)
        if device == "cuda":
            torch.cuda.synchronize()
        b = time.time()
        passes.append({"seconds": b - a, "layers": layers,
                       "digest": digest(out, stage.OUTPUTS)})
        if last is not None:
            shutil.rmtree(last)
        last = out
        mean = sum(p["seconds"] for p in passes) / len(passes)
        if b - t0 + mean > seconds:
            break
    os.replace(last, os.path.join(work, "last"))
    return passes, t0, b


def judge(checks: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) of the numbers compared."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = checks.get(name)
        out[name] = {"value": v, "limit": limit}
        ok = ok and v is not None and v <= limit
    return ok, out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", sp: dict | None = None,
             cfg_override=None, plant: str | None = None,
             warm: bool = True) -> dict:
    """One run of cell ``name``; returns the result's fields.  ``device``
    ``"cpu"``, ``cfg_override`` (a function of the configuration),
    ``plant`` (a control or fault of the stage's ``PLANTS``) and ``warm``
    False (no warm-up pass: the process has run one) serve the tests and
    ``benchmark.calibrate`` only."""
    import contextlib

    import numpy as np
    import torch

    sp = sp or spec()
    cell, cfg, traffic, limits, stage = cell_inputs(sp, name)
    if cfg_override is not None:
        cfg = cfg_override(cfg)
    e2e, per = cell_metrics(sp, name, stage.RATE)
    work = tempfile.mkdtemp(prefix="haslr_bench_")
    try:
        st = stage.prepare(cfg, traffic, seed, work)
        if warm:
            warm_dir = os.path.join(work, "warm")
            os.makedirs(warm_dir)
            stage.run_pass(st, warm_dir, device, warm=True)
            shutil.rmtree(warm_dir)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.time() - T_START
        with contextlib.ExitStack() as stack:
            if plant is not None:
                stack.enter_context(stage.PLANTS[plant](st))
            probes = prof = None
            if trace:
                from torch.profiler import ProfilerActivity, profile

                from benchmark.probes import Probes

                probes = stack.enter_context(Probes(stage.SPANS))
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if device == "cuda" else [])
                prof = stack.enter_context(profile(activities=acts))
            passes, t0, t1 = window(stage, st, work, seconds, device)
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        rng = np.random.default_rng(np.random.SeedSequence(
            [int(seed) % (1 << 64), 1]))
        try:
            checks = stage.check(st, os.path.join(work, "last"), rng, device)
        except Exception as e:  # a check that cannot read the output fails
            print(f"check failed: {type(e).__name__}: {e}", file=sys.stderr)
            checks = {}
        checks["passes_differ"] = len({p["digest"] for p in passes}) - 1
        correct, compared = judge(checks, limits)
        mbp = stage.pass_mbp(st) * len(passes)
        result = {"correct": correct, "attempted": len(passes),
                  "failed": 0 if correct else len(passes)}
        if trace:
            result["metrics"], extra = traced_metrics(
                per, passes, prof, probes, stage, t0, t1)
            result["breakdown"] = extra.pop("breakdown")
        else:
            result["metrics"] = {stage.RATE: {"value": mbp / (t1 - t0)},
                                 "setup_s": {"value": setup_s}}
            extra = {}
        units = {m["name"]: m["unit"] for m in e2e + per}
        for k, v in result["metrics"].items():
            v["unit"] = units[k]
        result["device"] = device_record(device, cell["chips"], peak, extra)
        result["passes_s"] = [p["seconds"] for p in passes]
        result["readings"] = checks
        result["checks"] = compared
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def traced_metrics(per, passes, prof, probes, stage, t0, t1):
    """The per-layer metrics of a traced window, ``busy_s`` and
    ``window_s``, and the breakdown."""
    from benchmark import readers

    events = readers.device_events(prof)
    spans = readers.host_spans(prof, {s[2] for s in stage.SPANS})
    busy = readers.busy_seconds(events)
    if events:
        lo = min(e[1] for e in events + spans)
        hi = max(e[2] for e in events + spans)
    else:
        lo, hi = 0.0, 0.0
    ctx = {"passes": passes, "events": events, "cells": probes.cells,
           "v1_bytes": probes.v1_bytes, "busy_s": busy,
           "window_s": t1 - t0}
    out = {}
    for m in per:
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v}
    breakdown = {"device_ops": readers.top_ops(events),
                 "idle_gaps": readers.idle_gaps(events, spans, lo, hi)}
    return out, {"busy_s": busy, "window_s": t1 - t0,
                 "breakdown": breakdown}


def device_record(device, chips, peak, extra) -> dict:
    import torch

    if device == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": chips, "memory_peak_bytes": peak}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
    rec.update(extra)
    return rec


def power_limit() -> str:
    import subprocess

    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def cache_dirs():
    """Kernel caches in fixed directories of the checkout (the port
    builds its own into ``haslr_tpu_torch/_build/``)."""
    base = os.path.join(ROOT, "_bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cache_dirs()
    import torch

    sp = spec()
    chips = cell_of(sp, a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{a.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), sp=sp)
    found = forbidden_modules()
    if found:
        print(f"the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    result["card"] = power_limit()
    checks = result.pop("checks")
    result["checks"] = checks     # the compared numbers come last
    for k, v in checks.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
