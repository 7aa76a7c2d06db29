"""The port's standalone ``haslr_assemble`` against the JAX package's:
the same ``asm.final.fa`` and ``.ann`` under both consensus engines, the
resume from the ``index.*.npz`` snapshots with the inputs gone, the
defaults taken where a value is invalid, PAF shards read through
``--mapping-fofn``, and the card by default (port of
``tests/test_resume_and_cli.py::test_haslr_assemble_cli_and_resume``)."""

import os

import pytest
import torch

from haslr_tpu.testutil import simulate

ASM = ("asm.final.fa", "asm.final.ann")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_haslr_assemble")
    _genome, _contigs, _reads, paths = simulate.simulate(
        str(out), genome_len=20_000, seed=5, coverage=12.0, error_rate=0.05
    )
    return paths


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _port(args):
    from haslr_tpu_torch.cli.haslr_assemble import main

    return main(args)


@pytest.fixture(scope="module")
def reference(sim, tmp_path_factory):
    """The JAX CLI's outputs, by consensus engine."""
    from haslr_tpu.cli.haslr_assemble import main

    contig, lr, paf = sim
    out = {}
    for engine in ("poa", "tpu"):
        d = str(tmp_path_factory.mktemp(f"ref_{engine}"))
        assert main(["-c", contig, "-l", lr, "-m", paf, "-d", d,
                     "--consensus-engine", engine, "--platform", "cpu"]) == 0
        out[engine] = {name: _read(f"{d}/{name}") for name in ASM}
    return out


@pytest.mark.parametrize("engine", ["poa", "tpu"])
def test_haslr_assemble_matches_reference_and_resumes(sim, reference,
                                                      tmp_path, engine):
    contig, lr, paf = sim
    out = str(tmp_path / "asmcli")
    assert _port(["-c", contig, "-l", lr, "-m", paf, "-d", out,
                  "--consensus-engine", engine, "--device", "cpu"]) == 0
    for name in ASM:
        assert _read(f"{out}/{name}") == reference[engine][name], name
    assert os.path.isfile(f"{out}/index.contig.npz")
    assert os.path.isfile(f"{out}/index.longread.npz")
    os.remove(f"{out}/asm.final.fa")
    # inputs gone: the snapshots must reproduce the assembly
    assert _port(["-c", "/nonexistent.fa", "-l", "/nonexistent2.fa",
                  "-m", "/nonexistent3.paf", "-d", out,
                  "--consensus-engine", engine, "--device", "cpu"]) == 0
    assert _read(f"{out}/asm.final.fa") == reference[engine]["asm.final.fa"]


def test_haslr_assemble_takes_defaults_for_invalid_values(sim, reference,
                                                          tmp_path):
    """``Commandline.cpp:148-175``: a negative block length or edge
    support, or a similarity outside [0, 1], runs with the default."""
    contig, lr, paf = sim
    out = str(tmp_path / "invalid")
    assert _port(["-c", contig, "-l", lr, "-m", paf, "-d", out,
                  "--aln-block", "-5", "--aln-sim", "3", "--edge-sup", "-1",
                  "--consensus-engine", "poa", "--device", "cpu"]) == 0
    for name in ASM:
        assert _read(f"{out}/{name}") == reference["poa"][name], name


def test_haslr_assemble_reads_paf_shards_through_a_fofn(sim, reference,
                                                        tmp_path):
    """The PAF cut into two host shards (each read's lines whole in one,
    as two mapping processes write them) and named in a
    file-of-file-names: the single PAF's assembly."""
    contig, lr, paf = sim
    shards = [str(tmp_path / f"shard{i}.paf") for i in range(2)]
    names = {}
    with open(paf) as f, open(shards[0], "w") as a, open(shards[1], "w") as b:
        for line in f:
            q = line.split("\t", 1)[0]
            (a, b)[names.setdefault(q, len(names) % 2)].write(line)
    assert all(os.path.getsize(s) > 0 for s in shards)
    fofn = str(tmp_path / "maps.fofn")
    with open(fofn, "w") as f:
        f.write("\n".join(shards) + "\n")
    out = str(tmp_path / "fofn")
    assert _port(["-c", contig, "-l", lr, "-m", fofn, "-d", out,
                  "--mapping-fofn", "--consensus-engine", "poa",
                  "--device", "cpu"]) == 0
    for name in ASM:
        assert _read(f"{out}/{name}") == reference["poa"][name], name


def test_haslr_assemble_takes_the_card_by_default(sim, tmp_path):
    contig, lr, paf = sim
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    out = tmp_path / "never"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _port(["-c", contig, "-l", lr, "-m", paf, "-d", str(out)])
    assert not out.exists()


def test_haslr_assemble_poa_needs_no_card(sim, reference, tmp_path):
    """The host POA engine runs without ``--device`` where there is no
    card (the default ``cuda`` is not resolved for it), as the JAX
    CLI's runs on any host."""
    contig, lr, paf = sim
    out = str(tmp_path / "poa")
    assert _port(["-c", contig, "-l", lr, "-m", paf, "-d", out,
                  "--consensus-engine", "poa"]) == 0
    for name in ASM:
        assert _read(f"{out}/{name}") == reference["poa"][name], name
