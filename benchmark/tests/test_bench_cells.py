"""Each cell of ``BENCHMARK.json`` driven on the CPU at a small size, the
harness's look for a card skipped: sound, it comes out correct; with the
control or a fault of its stage's ``PLANTS`` under the timed path, not
correct; traced, it reads its host layers and invents no device metric.
One rule sizes every cell (``small.cpu_cut``); the repeat families longer
than 2 kb are left out here (their consensus windows of up to 8192 bases
take minutes in the plain CPU DP); the chip runs them.

Besides: which metrics ``run.cell_metrics`` gives a cell, and a cell that
enters as new files and new entries alone, run to correct."""

import json
import shutil

import pytest

from benchmark import run
from benchmark.tests.small import cpu_cut, cpu_share, shrink

SP = run.spec()
CELLS = [w["name"] for w in SP["workloads"]]
SEED = 2**31 + 5


def stage_of(name):
    return run.cell_inputs(SP, name)[4]


PLANTED = [(name, plant) for name in CELLS for plant in stage_of(name).PLANTS]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run.run_cell(name, SEED, 1.0, False, device="cpu",
                     cfg_override=cpu_cut)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {stage_of(name).RATE, "setup_s"}
    assert r["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("name,plant", PLANTED)
def test_control_and_faults_are_not_correct(name, plant):
    r = run.run_cell(name, SEED, 1.0, False, device="cpu",
                     cfg_override=cpu_cut, plant=plant)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_host_layers(name):
    r = run.run_cell(name, 7, 1.0, True, device="cpu", cfg_override=cpu_cut)
    assert r["correct"]
    per = run.cell_metrics(SP, name, stage_of(name).RATE)[1]
    # every layer the host records is read; with no card there is nothing
    # to read for the device metrics, and none is invented
    assert set(r["metrics"]) == {m["name"] for m in per
                                 if m["source"] != "device_trace"}


def test_the_cpu_rule_keeps_ecoli_at_a_tenth():
    cfg = run.load_json(run.BENCH, "configs", "ecoli_pacbio.json")
    assert cpu_share(cfg) == 0.1
    assert cpu_cut(cfg) == shrink(0.1)(cfg)


def _names(metrics):
    return sorted(m["name"] for m in metrics)


def test_cell_metrics_by_list_and_by_stage():
    sp = {"end_to_end": [
              {"name": "asm_mbp_per_s"},
              {"name": "map_mbp_per_s"},
              {"name": "setup_s"},
              {"name": "sr_mbp_per_s", "workloads": ["g.sr"]},
              {"name": "resume_s", "workloads": ["g.asm"]}],
          "per_layer": [
              {"name": "asm.listed", "moves": "asm_mbp_per_s",
               "workloads": ["g.asm"]},
              {"name": "asm.free", "moves": "asm_mbp_per_s"},
              {"name": "map.free", "moves": "map_mbp_per_s"},
              {"name": "sr.listed", "moves": "sr_mbp_per_s",
               "workloads": ["g.sr"]}]}
    # a listed metric goes to the cells it names, a list-less one to the
    # cells whose stage reports it
    e2e, per = run.cell_metrics(sp, "g.asm", "asm_mbp_per_s")
    assert _names(e2e) == ["asm_mbp_per_s", "resume_s", "setup_s"]
    assert _names(per) == ["asm.free", "asm.listed"]
    # a new cell of the same stage: the stage's rate and setup_s, and the
    # list-less per-layer metric that moves the rate
    e2e, per = run.cell_metrics(sp, "h.asm", "asm_mbp_per_s")
    assert _names(e2e) == ["asm_mbp_per_s", "setup_s"]
    assert _names(per) == ["asm.free"]
    # another stage's cell is never held to a rate it does not report
    e2e, per = run.cell_metrics(sp, "g.map", "map_mbp_per_s")
    assert _names(e2e) == ["map_mbp_per_s", "setup_s"]
    assert _names(per) == ["map.free"]
    e2e, per = run.cell_metrics(sp, "g.sr", "sr_mbp_per_s")
    assert _names(e2e) == ["setup_s", "sr_mbp_per_s"]
    assert _names(per) == ["sr.listed"]
    # a stage whose rate BENCHMARK.json does not give the cell
    with pytest.raises(SystemExit):
        run.cell_metrics(sp, "h.sr", "sr_mbp_per_s")
    with pytest.raises(SystemExit):
        run.cell_metrics(sp, "g.x", "x_mbp_per_s")


def test_cell_metrics_of_the_benchmark():
    for name in CELLS:
        e2e, per = run.cell_metrics(SP, name, stage_of(name).RATE)
        assert _names(e2e) == sorted([stage_of(name).RATE, "setup_s"])
        assert _names(per) == sorted(m["name"] for m in SP["per_layer"]
                                     if name in m["workloads"])
    # a new cell of the assembler's stage gets its rate; every per-layer
    # metric lists the cells it reads, so it gets none of them
    e2e, per = run.cell_metrics(SP, "new_genome.assemble", "asm_mbp_per_s")
    assert _names(e2e) == ["asm_mbp_per_s", "setup_s"]
    assert per == []


def test_a_cell_enters_as_new_files_and_entries(tmp_path, monkeypatch):
    """A configuration of E. coli's length in two replicons, its cell and
    its limits, added to a copy of the harness's data as new files and to
    the spec as new entries; nothing that is there changes.  (The CPU
    rule runs its longest replicon.)"""
    bench = tmp_path / "benchmark"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(f"{run.BENCH}/{d}", bench / d)
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    monkeypatch.setattr(run, "BENCH", str(bench))

    cfg = run.load_json(bench, "configs", "ecoli_pacbio.json")
    cfg["name"] = "ecoli_split"
    total = cfg["genome"]["replicons"][0]
    cfg["genome"]["replicons"] = [total // 2, total - total // 2]
    (bench / "configs" / "ecoli_split.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "limits" / "ecoli_pacbio.assemble.json",
                bench / "limits" / "ecoli_split.assemble.json")
    sp = json.loads(json.dumps(SP))
    sp["configs"].append({
        "name": "ecoli_split", "source": "https://github.com/vpc-ccg/haslr",
        "file": "benchmark/configs/ecoli_split.json", "reduced": [],
        "why": "E. coli's length in two replicons"})
    sp["workloads"].append({
        "name": "ecoli_split.assemble", "config": "ecoli_split",
        "traffic": "assemble", "chips": 1,
        "why": "whole run_assembler passes over two replicons"})

    r = run.run_cell("ecoli_split.assemble", SEED, 1.0, False, device="cpu",
                     sp=sp, cfg_override=cpu_cut)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"asm_mbp_per_s", "setup_s"}
    assert {p: p.read_bytes() for p in before} == before
