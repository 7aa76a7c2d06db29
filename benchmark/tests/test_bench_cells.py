"""Each cell's run driven on the CPU at a small size, the harness's look
for a card skipped: sound, it comes out correct; with the control or a
fault planted under the timed path, not correct.  The repeat families
longer than 2 kb are left out here (their consensus windows of up to
8192 bases take minutes in the plain CPU DP); the chip runs them."""

import pytest

from benchmark import run
from benchmark.tests.small import shrink

CELLS = [("ecoli_pacbio.assemble", 0.1)]


@pytest.mark.parametrize("name,share", CELLS)
def test_sound_run_is_correct(name, share):
    r = run.run_cell(name, 2**31 + 5, 1.0, False, device="cpu",
                     cfg_override=shrink(share))
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {run.cell_inputs(run.spec(), name)[4].RATE,
                                 "setup_s"}
    assert r["metrics"]["setup_s"]["value"] > 0


PLANTS = [(cell, share, plant) for cell, share in CELLS
          for plant in ("control", "half", "alter", "graph")]


@pytest.mark.parametrize("name,share,plant", PLANTS)
def test_control_and_faults_are_not_correct(name, share, plant):
    r = run.run_cell(name, 2**31 + 5, 1.0, False, device="cpu",
                     cfg_override=shrink(share), plant=plant)
    assert not r["correct"], r["checks"]


def test_traced_run_reads_the_host_layers():
    r = run.run_cell("ecoli_pacbio.assemble", 7, 1.0, True, device="cpu",
                     cfg_override=shrink(0.1))
    assert r["correct"]
    m = r["metrics"]
    assert {"asm.graph_s", "asm.consensus_s", "consensus.host_s"} <= set(m)
    # no card: nothing to read for the device metrics, none invented
    assert "kernel.v1_roofline" not in m and "device.idle_pct" not in m
