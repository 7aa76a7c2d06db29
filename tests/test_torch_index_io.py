"""The assembler's resume snapshots (``index.contig.npz``,
``index.longread.npz``): the port writes every member stored, not
deflated; its write and read give back the stores it wrote; and the
snapshots resume in both directions between the port and ``haslr_tpu``.
Each case runs on the golden input and on the same reads with no
alignments."""

import dataclasses
import gzip
import os
import zipfile

import numpy as np
import pytest

from haslr_tpu.assemble import index_io as ref_io
from haslr_tpu.config import AssembleConfig
from haslr_tpu_torch.assemble import index_io
from haslr_tpu_torch.assemble.contig_store import ContigStore
from haslr_tpu_torch.assemble.longread_store import (
    LongreadStore,
    load_alignments,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden", "input")
INPUTS = ["golden", "no_alignments"]


@pytest.fixture(scope="module")
def golden_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("index_io_golden")
    paths = []
    for name in ("contigs.fa", "lr.fa", "map.paf"):
        with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rb") as fi, \
                open(d / name, "wb") as fo:
            fo.write(fi.read())
        paths.append(str(d / name))
    return paths


@pytest.fixture(scope="module", params=INPUTS)
def stores(request, golden_files):
    """The port's contig and long-read stores of one input."""
    contigs_p, lr_p, paf_p = golden_files
    contigs = ContigStore.load_fasta(contigs_p)
    lrs = LongreadStore.load_fasta(lr_p)
    if request.param == "golden":
        n = load_alignments(paf_p, contigs, lrs, contigs.calc_uniq_freq(),
                            AssembleConfig())
        assert n > 0
    return contigs, lrs


def _write(tmp_path, contigs, lrs, io=index_io):
    c, lr = str(tmp_path / "index.contig.npz"), \
        str(tmp_path / "index.longread.npz")
    io.write_contig_index(c, contigs)
    io.write_longread_index(lr, lrs)
    return c, lr


def _seqs(store):
    s = store.seqs
    return (s.packed.dtype.str, s.packed.tobytes(),
            np.asarray(s.offsets).tolist(), list(s.lengths))


def _contigs(store):
    return (_seqs(store), list(store.kmer_count), list(store.mean_kmer))


def _aln(a):
    fields = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    ops, lens = fields.pop("ops"), fields.pop("lens")
    return (tuple(sorted(fields.items())), ops.dtype.str, ops.tolist(),
            lens.dtype.str, lens.tolist())


def _longreads(store):
    return (_seqs(store),
            [[_aln(a) for a in alns] for alns in store.alignments])


def _n_alignments(store):
    return sum(len(x) for x in store.alignments)


def test_every_member_is_stored(tmp_path, stores):
    for path in _write(tmp_path, *stores):
        with zipfile.ZipFile(path) as z:
            infos = z.infolist()
        assert infos
        assert all(i.compress_type == zipfile.ZIP_STORED for i in infos)
    with zipfile.ZipFile(tmp_path / "index.longread.npz") as z:
        assert sorted(z.namelist()) == sorted(
            f"{m}.npy" for m in ("packed", "offsets", "lengths", "aln_table",
                                 "aln_ops", "aln_lens", "aln_n_ops",
                                 "per_read"))
    z = np.load(tmp_path / "index.longread.npz")
    assert z["packed"].dtype == np.uint8
    assert z["aln_ops"].dtype == np.uint8
    assert z["aln_lens"].dtype == np.int64
    assert z["aln_table"].dtype == np.dtype(index_io._ALN_FIELDS)


def test_port_write_then_read_gives_the_stores_back(tmp_path, stores):
    contigs, lrs = stores
    c, lr = _write(tmp_path, contigs, lrs)
    assert _contigs(index_io.read_contig_index(c)) == _contigs(contigs)
    back, n = index_io.read_longread_index(lr)
    assert n == _n_alignments(lrs)
    assert _longreads(back) == _longreads(lrs)


def test_reference_reads_the_ports_snapshot(tmp_path, stores):
    c, lr = _write(tmp_path, *stores)
    ref_lrs, ref_n = ref_io.read_longread_index(lr)
    port_lrs, port_n = index_io.read_longread_index(lr)
    assert ref_n == port_n
    assert _longreads(ref_lrs) == _longreads(port_lrs)
    assert _contigs(ref_io.read_contig_index(c)) == \
        _contigs(index_io.read_contig_index(c))


def test_port_reads_the_references_snapshot(tmp_path, stores):
    """``haslr_tpu`` deflates its members; the port's readers load them
    into the stores the port's own snapshot gives."""
    contigs, lrs = stores
    ref_c, ref_lr = _write(tmp_path, contigs, lrs, io=ref_io)
    with zipfile.ZipFile(ref_lr) as z:
        assert {i.compress_type for i in z.infolist()} == {zipfile.ZIP_DEFLATED}
    own = tmp_path / "own"
    own.mkdir()
    c, lr = _write(own, contigs, lrs)
    assert _contigs(index_io.read_contig_index(ref_c)) == \
        _contigs(index_io.read_contig_index(c))
    ref_back, ref_n = index_io.read_longread_index(ref_lr)
    back, n = index_io.read_longread_index(lr)
    assert ref_n == n == _n_alignments(lrs)
    assert _longreads(ref_back) == _longreads(back)
