"""The port stands on its own: no module of ``haslr_tpu_torch`` (nor
``chip_smoke.py``) imports ``jax`` or ``haslr_tpu``, a whole CLI run on
the CPU loads neither, and every entry point runs on the card unless the
caller passes ``device="cpu"`` (so it raises here, where there is no
card)."""

import ast
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from haslr_tpu_torch.testutil import simulate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "haslr_tpu"}  # exact top-level names
PORT_FILES = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "haslr_tpu_torch", "**", "*.py"),
                       recursive=True)
) + ["chip_smoke.py"]


def _imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_import_of_jax_or_reference(rel):
    bad = [(top, line) for top, line in _imported_tops(os.path.join(ROOT, rel))
           if top in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_port_file_list_is_whole():
    assert len(PORT_FILES) > 40
    for rel in ("haslr_tpu_torch/native/__init__.py",
                "haslr_tpu_torch/sr/assemble_sr.py",
                "haslr_tpu_torch/aligner/map.py",
                "haslr_tpu_torch/testutil/simulate.py",
                "haslr_tpu_torch/dist/__init__.py",
                "haslr_tpu_torch/dist/mesh.py",
                "haslr_tpu_torch/dist/consensus_step.py",
                "haslr_tpu_torch/kernels/kmer.py",
                "haslr_tpu_torch/kernels/kmer_stream.py",
                "haslr_tpu_torch/cli/haslr_assemble.py",
                "haslr_tpu_torch/trace.py"):
        assert rel in PORT_FILES


_CLI_RUN = r"""
import json, sys
import torch
torch.set_num_threads(1)
from haslr_tpu_torch.cli.haslr import main
rc = main(sys.argv[1:])
from haslr_tpu_torch import native
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "haslr_tpu"))
print(json.dumps({"rc": rc, "loaded": loaded,
                  "native": native.get_lib() is not None,
                  "native_so": getattr(native.get_lib(), "_name", "")}))
"""


def test_cli_run_on_cpu_loads_neither_jax_nor_reference(tmp_path):
    """The five stages on a small simulated genome, two seeding workers
    (spawned processes that import the port's own modules)."""
    rng = np.random.default_rng(5)
    genome = simulate.genome_with_repeats(
        rng, 20_000, n_families=2, copies_per_family=3, repeat_len=400
    )
    sr_path = str(tmp_path / "sr.fq")
    simulate.write_short_reads(
        sr_path, simulate.make_short_reads(rng, genome, coverage=45.0)
    )
    lr_path = str(tmp_path / "lr.fa")
    with open(lr_path, "w") as fp:
        for r in simulate.make_reads(rng, genome, coverage=18.0,
                                     mean_len=8000, error_rate=0.05):
            fp.write(f">sim{r.rid}\n{r.seq}\n")
    out = str(tmp_path / "out")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", _CLI_RUN, "-o", out, "-g", "20k", "-l",
         lr_path, "-x", "pacbio", "-s", sr_path, "-t", "2", "--device",
         "cpu"],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=600,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    info = json.loads(res.stdout.strip().splitlines()[-1])
    assert info["rc"] == 0
    assert info["loaded"] == []
    assert info["native"] is True
    # the port's library, built from its own sources into its _build/
    assert os.path.dirname(info["native_so"]) == \
        os.path.join(ROOT, "haslr_tpu_torch", "_build")
    asm = [d for d in os.listdir(out) if d.startswith("asm_")
           and os.path.isdir(os.path.join(out, d))]
    assert len(asm) == 1
    assert os.path.getsize(os.path.join(out, asm[0], "asm.final.fa")) > 0


def _tiny_batch():
    reads = np.zeros((2, 128), np.uint8)
    lens = np.full(2, 100, np.int32)
    return reads, lens, reads.copy(), lens.copy()


def _entry_points():
    from haslr_tpu_torch.aligner import extend, map as amap
    from haslr_tpu_torch.assemble import consensus, pipeline
    from haslr_tpu_torch.config import AssembleConfig
    from haslr_tpu_torch.kernels import consensus as kcons
    from haslr_tpu_torch.kernels import consensus_dense, kmer, kmer_stream
    from haslr_tpu_torch.kernels import nw, nw_rowscan
    from haslr_tpu_torch.sr import assemble_sr, dbg

    codes = [[np.zeros(40, np.uint8)] * 3]
    return {
        "run_assembler": lambda **kw: pipeline.run_assembler(
            "c.fa", "l.fa", "m.paf", "out_never_made", log=None, **kw),
        "calc_consensus": lambda **kw: consensus.calc_consensus(
            None, None, AssembleConfig(consensus_engine="tpu"), **kw),
        "map_reads": lambda **kw: amap.map_reads(
            "c.fa", "r.fa", "o.paf", **kw),
        "batch_align_segments": lambda **kw: extend.batch_align_segments(
            [], **kw),
        "batched_consensus": lambda **kw: kcons.batched_consensus(
            [["ACGT" * 10] * 3], **kw),
        "dense_consensus": lambda **kw: consensus_dense.dense_consensus(
            codes, **kw),
        "cigar_runs_device_raw": lambda **kw:
            nw_rowscan.cigar_runs_device_raw(*_tiny_batch(), **kw),
        "align_mapping_device_raw": lambda **kw:
            nw.align_mapping_device_raw(*_tiny_batch(), **kw),
        "align_mapping_device": lambda **kw:
            nw.align_mapping_device(*_tiny_batch(), **kw),
        "banded_nw_batch": lambda **kw:
            nw.banded_nw_batch(*_tiny_batch(), **kw),
        "count_kmers_device": lambda **kw: kmer.count_kmers_device(
            np.zeros(40, np.uint8), 21, **kw),
        "count_kmers_streaming": lambda **kw:
            kmer_stream.count_kmers_streaming([np.zeros(40, np.uint8)], 21,
                                              **kw),
        "assemble_unitigs": lambda **kw: dbg.assemble_unitigs(
            np.zeros(40, np.uint8), 21, 1,
            **{"torch_device" if k == "device" else k: v
               for k, v in kw.items()}),
        "assemble_short_reads": lambda **kw:
            assemble_sr.assemble_short_reads(
                ["never.fa"], "never_out.fa", streaming=True,
                **{"torch_device" if k == "device" else k: v
                   for k, v in kw.items()}),
    }


ENTRY_POINTS = ["run_assembler", "calc_consensus", "map_reads",
                "batch_align_segments", "batched_consensus",
                "dense_consensus", "cigar_runs_device_raw",
                "align_mapping_device_raw", "align_mapping_device",
                "banded_nw_batch", "count_kmers_device",
                "count_kmers_streaming", "assemble_unitigs",
                "assemble_short_reads"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_takes_the_card_by_default(name, tmp_path, monkeypatch):
    """Without ``device`` every entry point resolves to the card; where
    there is none it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    monkeypatch.chdir(tmp_path)
    call = _entry_points()[name]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        call()
    assert not os.path.exists(tmp_path / "out_never_made")


@pytest.mark.parametrize("name", ["batch_align_segments",
                                  "dense_consensus",
                                  "cigar_runs_device_raw",
                                  "align_mapping_device",
                                  "count_kmers_device",
                                  "count_kmers_streaming",
                                  "assemble_unitigs"])
def test_entry_point_runs_on_cpu_when_asked(name):
    torch.set_num_threads(1)
    assert _entry_points()[name](device="cpu") is not None


def test_resolve_device_default_is_the_card():
    from haslr_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()


_STOP_RUN = r"""
import json, multiprocessing as mp, os, sys
import chip_smoke

def pooled():
    with mp.get_context("spawn").Pool(2) as pool:
        return pool.map(abs, [-1, -2])

if __name__ == "__main__":
    got = pooled()
    before = chip_smoke.child_pids()
    killed = chip_smoke.stop_children()
    print(json.dumps({"got": got, "before": len(before), "killed": killed,
                      "after": chip_smoke.child_pids()}))
"""


def test_chip_smoke_leaves_no_process_behind(tmp_path):
    """A spawn pool, as the pipeline's seeding stage opens one, leaves
    multiprocessing's resource tracker running; ``stop_children`` ends
    it without a kill, and no child of the script is left."""
    script = tmp_path / "stop_run.py"
    script.write_text(_STOP_RUN)
    res = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT), timeout=120,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    info = json.loads(res.stdout.strip().splitlines()[-1])
    assert info["got"] == [1, 2]
    assert info["before"] >= 1  # the tracker outlived the pool
    assert info["killed"] == [] and info["after"] == []
    assert "leaked" not in res.stderr
