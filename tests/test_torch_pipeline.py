"""The port's five-stage CLI on the CPU against the reference CLI.

The port runs in a subprocess: this test process has jax loaded (see
``conftest.py``), and the subprocess shows that importing every
``haslr_tpu_torch`` module and running the whole pipeline never imports
jax.  Same simulated 30 kb dataset as ``test_pipeline_e2e.py``; the
final assembly must be byte-identical to ``haslr_tpu``'s."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from haslr_tpu.testutil import simulate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PORT_RUN = r"""
import importlib, json, pkgutil, sys
import torch
torch.set_num_threads(1)
import haslr_tpu_torch
mods = sorted(
    m.name for m in pkgutil.walk_packages(
        haslr_tpu_torch.__path__, "haslr_tpu_torch."
    )
)
for m in mods:
    importlib.import_module(m)
from haslr_tpu_torch.cli.haslr import main
rc = main(sys.argv[1:])
print(json.dumps({"rc": rc, "modules": mods, "jax": "jax" in sys.modules}))
"""


def _args(out, sr_path, lr_path):
    return ["-o", out, "-g", "30k", "-l", lr_path, "-x", "pacbio",
            "-s", sr_path, "--minia-kmer", "49", "--cov-lr", "25"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pipeline")
    rng = np.random.default_rng(11)
    genome = simulate.genome_with_repeats(
        rng, 30_000, n_families=2, copies_per_family=4, repeat_len=400
    )
    srs = simulate.make_short_reads(rng, genome, coverage=45.0)
    sr_path = str(root / "sr.fq")
    simulate.write_short_reads(sr_path, srs)
    lrs = simulate.make_reads(rng, genome, coverage=18.0, mean_len=8000,
                              error_rate=0.05)
    lr_path = str(root / "lr.fa")
    with open(lr_path, "w") as fp:
        for r in lrs:
            fp.write(f">sim{r.rid} original_name\n{r.seq}\n")
    return root, sr_path, lr_path


@pytest.fixture(scope="module")
def port_run(dataset):
    root, sr_path, lr_path = dataset
    out = str(root / "port")
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", _PORT_RUN, *_args(out, sr_path, lr_path),
         "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    return out, json.loads(res.stdout.strip().splitlines()[-1])


def test_port_imports_and_runs_without_jax(port_run):
    _out, info = port_run
    assert info["rc"] == 0
    assert "haslr_tpu_torch.kernels.nw_rowscan" in info["modules"]
    assert "haslr_tpu_torch.kernels.nw_wavefront" in info["modules"]
    assert "haslr_tpu_torch.kernels.nw" in info["modules"]
    assert "haslr_tpu_torch.cli.haslr" in info["modules"]
    assert info["jax"] is False


def test_port_cli_matches_reference_cli(dataset, port_run):
    from haslr_tpu.cli.haslr import main

    root, sr_path, lr_path = dataset
    port_out, _info = port_run
    ref_out = str(root / "ref")
    assert main(_args(ref_out, sr_path, lr_path) + ["--platform", "cpu"]) \
        == 0
    asm = "asm_contigs_k49_a3_c250_lr25x_b500_s3_sim0.85"
    for name in ("asm.final.fa", "asm.final.ann"):
        with open(f"{ref_out}/{asm}/{name}", "rb") as f:
            want = f.read()
        with open(f"{port_out}/{asm}/{name}", "rb") as f:
            got = f.read()
        assert want == got, name
    paf = "map_contigs_k49_a3_c250_lr25x.paf"
    with open(f"{ref_out}/{paf}", "rb") as f, \
            open(f"{port_out}/{paf}", "rb") as g:
        assert f.read() == g.read()


def test_port_cli_matches_reference_cli_wavefront(dataset, tmp_path,
                                                  monkeypatch, capsys):
    """Both CLIs under the wavefront engine (the port's extension through
    B5's and its consensus through B4's plain versions): the same
    ``asm.final.*`` and PAF bytes."""
    from haslr_tpu.cli.haslr import main as ref_main
    from haslr_tpu.kernels import nw
    from haslr_tpu_torch.cli.haslr import main
    from haslr_tpu_torch.kernels import nw as pnw

    _root, sr_path, lr_path = dataset
    monkeypatch.setattr(nw, "ENGINE", "wavefront")
    monkeypatch.setattr(pnw, "ENGINE", "wavefront")
    torch.set_num_threads(1)
    ref_out = str(tmp_path / "ref")
    port_out = str(tmp_path / "port")
    assert ref_main(_args(ref_out, sr_path, lr_path)
                    + ["--platform", "cpu"]) == 0
    assert main(_args(port_out, sr_path, lr_path) + ["--device", "cpu"]) \
        == 0
    capsys.readouterr()
    asm = "asm_contigs_k49_a3_c250_lr25x_b500_s3_sim0.85"
    for name in (f"{asm}/asm.final.fa", f"{asm}/asm.final.ann",
                 "map_contigs_k49_a3_c250_lr25x.paf"):
        with open(f"{ref_out}/{name}", "rb") as f, \
                open(f"{port_out}/{name}", "rb") as g:
            assert f.read() == g.read(), name


def test_port_cli_resume_skips_every_stage(dataset, port_run, capsys):
    from haslr_tpu_torch.cli.haslr import main

    _root, sr_path, lr_path = dataset
    port_out, _info = port_run
    torch.set_num_threads(1)
    assert main(_args(port_out, sr_path, lr_path) + ["--device", "cpu"]) \
        == 0
    said = capsys.readouterr().out
    assert said.count("already exists") == 6, said


def test_port_cli_devices_flag_byte_identical(dataset, port_run, tmp_path,
                                             capsys):
    """``--devices 2 --device cpu``: the k-mer merge, the extension and
    the consensus split over two CPU shards write the single-device run's
    SR contigs, PAF and final assembly."""
    from haslr_tpu_torch.cli.haslr import main

    _root, sr_path, lr_path = dataset
    port_out, _info = port_run
    torch.set_num_threads(1)
    out = str(tmp_path / "mesh")
    assert main(_args(out, sr_path, lr_path)
                + ["--device", "cpu", "--devices", "2"]) == 0
    capsys.readouterr()
    asm = "asm_contigs_k49_a3_c250_lr25x_b500_s3_sim0.85"
    for name in ("sr_k49_a3.contigs.fa", "map_contigs_k49_a3_c250_lr25x.paf",
                 f"{asm}/asm.final.fa", f"{asm}/asm.final.ann"):
        with open(f"{port_out}/{name}", "rb") as f, \
                open(f"{out}/{name}", "rb") as g:
            assert f.read() == g.read(), name


def test_port_cli_rejects_several_devices(dataset, tmp_path, monkeypatch):
    """More cards than are visible: the mesh is never shrunk to what is
    there, and nothing runs before the refusal."""
    from haslr_tpu_torch.cli.haslr import main

    _root, sr_path, lr_path = dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    out = tmp_path / "o"
    with pytest.raises(ValueError, match="requested 2 devices but only 1"):
        main(_args(str(out), sr_path, lr_path)
             + ["--device", "cuda", "--devices", "2"])
    assert not out.exists()


def test_resolve_device():
    from haslr_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
