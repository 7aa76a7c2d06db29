"""The port keeps its own copy of the reference's host stack.  Each copied
file equals its ``haslr_tpu`` source once the package name is rewritten;
the files that had to differ are listed with the reason, and the
definitions they took over unchanged are still held to the reference's
text.  A failure here means the reference moved under a copy (or a copy
was edited): bring the two back together."""

import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "haslr_tpu")
PORT = os.path.join(ROOT, "haslr_tpu_torch")

# copied whole: only the package name in imports and docstrings changes
WHOLE = [
    "config.py",
    "core/__init__.py", "core/seq.py", "core/io.py", "core/cigar.py",
    "core/intervals.py",
    "sr/__init__.py", "sr/fastutils.py", "sr/nooverlap.py",
    "aligner/minimizer.py", "aligner/index.py", "aligner/chain.py",
    "assemble/backbone.py", "assemble/cleaning.py", "assemble/compact.py",
    "assemble/contig_store.py", "assemble/coords.py",
    "assemble/stitch.py", "assemble/repeat.py", "assemble/poa.py",
    "testutil/__init__.py", "testutil/simulate.py",
]

# the native sources, byte for byte
CPP_SAME = ["fastx.cpp", "dbg.cpp", "mapcig.cpp", "poa.cpp", "kmer.cpp",
            "paf.cpp"]
# chain.cpp: one comment line names the original HASLR driver by a
# relative path, where the reference's names a path of its first machine
CPP_BUT_COMMENTS = {"chain.cpp": 1}
# the port's own native sources (none in the reference), and why
CPP_OWN = {
    "paf_read.cpp": "the assembler's PAF ingest: one native pass reads the "
                    "file's columns and decodes the CIGARs that "
                    "load_alignments keeps, in place of a regex match and "
                    "two list appends per CIGAR operation",
}

# files that differ, why, and the top-level definitions they share with
# the reference unchanged
PARTIAL = {
    "native/__init__.py": (
        "builds into the package's _build/ under a hash of the sources, "
        "not beside them by mtime, and binds the port's own PAF reader",
        ["_SOURCES", "poa_consensus_native", "mapping_cigars_native",
         "runs_cigars_native", "merge_kmer_native", "idx_lookup_native",
         "paf_write_native", "chain_anchors_batch_native",
         "chain_anchors_native", "count_kmers_native", "dbg_unitigs",
         "read_fastx_encoded"],
    ),
    "sr/assemble_sr.py": (
        "assemble_short_reads takes the torch device that the device "
        "k-mer counters run on",
        ["load_read_codes", "iter_read_codes", "_clip_tips",
         "STREAMING_THRESHOLD", "_load_flat", "_count_native",
         "_count_native_sharded", "_finish"],
    ),
    "sr/dbg.py": (
        "assemble_unitigs takes the torch device that the device k-mer "
        "counter runs on",
        ["rc_int", "kmer_to_str", "Unitig", "DeBruijnGraph", "_side_links",
         "find_simple_bubbles", "_kmer_ints", "pop_bubbles",
         "write_unitigs_fasta", "_unitigs_from_native",
         "unitigs_from_counts"],
    ),
    "aligner/map.py": (
        "map_reads takes a torch device or a mesh and streams through the "
        "port's extension",
        ["PRESETS", "collect_anchors", "accept_chains", "_emit_record",
         "map_read", "_seed_chain_segments", "_emit_all", "_load_contigs",
         "_shard_worker", "_seed_chain_shards"],
    ),
    "aligner/extend.py": (
        "batch_align_segments launches the CUDA kernels on the blocks of "
        "a mesh; no jit downcast",
        ["NEG_H", "nw_cigar", "mapping_to_cigar", "_decode_runs_py",
         "chain_to_segments", "assemble_parts", "chain_to_cigar"],
    ),
    "assemble/longread_store.py": (
        "load_alignments reads the PAF through the port's native scan and "
        "counts its records, parsed CIGARs and kept alignments on the "
        "port's trace",
        ["Alignment", "LongreadStore", "_process_group",
         "fix_overlapping_alignments", "dump_alignments", "dump_reads",
         "fix_alignments"],
    ),
    "assemble/index_io.py": (
        "writes the resume snapshots as stored .npz members, as the "
        "reference's raw index dumps, not zlib-deflated ones",
        ["_ALN_FIELDS", "read_contig_index", "read_longread_index"],
    ),
    "assemble/pipeline.py": (
        "run_assembler takes a torch device or a torch mesh, and runs "
        "each StageTimer stage in a span of the port's trace",
        ["StageTimer"],
    ),
    "assemble/consensus.py": (
        "calc_consensus calls the port's batched_consensus on a torch "
        "device or mesh, its window extraction in a span of the trace",
        ["_edge_window_seqs", "_host_poa_windows"],
    ),
    "kernels/kmer.py": (
        "the device counter is the port's own (int64 words of 31 bases, "
        "torch sorts); merge_kmer_counts saturates (ROADMAP C4, below)",
        ["SEP", "_pack_pair_np", "_revcomp_pair_np", "count_kmers_host"],
    ),
    "kernels/kmer_stream.py": (
        "the chunk count, the accumulator and the merges are torch ops "
        "on a device or a torch mesh",
        ["pack2", "_PartitionStore"],
    ),
    "cli/haslr.py": (
        "--device beside --devices; the mesh is built once, of --device's "
        "kind; the stages run in spans of the port's trace (--trace)",
        ["_stamp", "_done", "prepare_lrs", "remove_short_src"],
    ),
}


def _renamed(path):
    with open(path) as f:
        return re.sub(r"\bhaslr_tpu\b", "haslr_tpu_torch", f.read())


def _read(path, mode="r"):
    with open(path, mode) as f:
        return f.read()


def _definitions(src):
    """Top-level name -> its source text (functions, classes, simple
    assignments)."""
    out = {}
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.get_source_segment(src, node)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    out[target.id] = ast.get_source_segment(src, node)
    return out


@pytest.mark.parametrize("rel", WHOLE)
def test_copied_file_equals_reference(rel):
    assert _read(os.path.join(PORT, rel)) == _renamed(os.path.join(REF, rel))


@pytest.mark.parametrize("name", CPP_SAME)
def test_native_source_is_byte_identical(name):
    assert _read(os.path.join(PORT, "native", name), "rb") == \
        _read(os.path.join(REF, "native", name), "rb")


@pytest.mark.parametrize("name", sorted(CPP_BUT_COMMENTS))
def test_native_source_differs_in_comments_only(name):
    port = _read(os.path.join(PORT, "native", name)).splitlines()
    ref = _read(os.path.join(REF, "native", name)).splitlines()
    assert len(port) == len(ref)
    changed = [(a, b) for a, b in zip(port, ref) if a != b]
    assert len(changed) == CPP_BUT_COMMENTS[name]
    for a, b in changed:
        assert a.lstrip().startswith("//") and b.lstrip().startswith("//")


def test_every_native_source_is_held():
    held = set(CPP_SAME) | set(CPP_BUT_COMMENTS)
    assert all(CPP_OWN.values()) and not held & set(CPP_OWN)
    for pkg, own in ((PORT, set(CPP_OWN)), (REF, set())):
        found = {f for f in os.listdir(os.path.join(pkg, "native"))
                 if f.endswith(".cpp")}
        assert found == held | own


@pytest.mark.parametrize("rel", sorted(PARTIAL))
def test_shared_definitions_equal_reference(rel):
    reason, names = PARTIAL[rel]
    assert reason
    port = _definitions(_read(os.path.join(PORT, rel)))
    ref = _definitions(_renamed(os.path.join(REF, rel)))
    for name in names:
        assert name in port, f"{rel}: {name} is gone from the port"
        assert name in ref, f"{rel}: {name} is gone from the reference"
        assert port[name] == ref[name], f"{rel}: {name} differs"


def test_every_port_module_is_accounted_for():
    """A module of the port is a copy (whole or partial) or the port's
    own; a new file must be put in one of the lists."""
    own = {
        "__init__.py", "device.py", "aligner/__init__.py",
        "assemble/__init__.py", "cli/__init__.py", "kernels/__init__.py",
        "kernels/_build.py", "kernels/consensus.py",
        "kernels/consensus_dense.py", "kernels/nw.py",
        "dist/__init__.py", "dist/mesh.py", "dist/consensus_step.py",
        "cli/haslr_assemble.py",
        "kernels/nw_rowscan.py", "kernels/nw_wavefront.py",
        "kernels/vote_tables.py", "trace.py",
    }
    found = set()
    for d, _dirs, files in os.walk(PORT):
        if os.path.basename(d) in ("__pycache__", "_build"):
            continue
        found.update(os.path.relpath(os.path.join(d, f), PORT)
                     for f in files if f.endswith(".py"))
    assert found == own | set(WHOLE) | set(PARTIAL)


def test_merge_kmer_counts_differs_only_in_saturation():
    """``kernels/kmer.py:merge_kmer_counts`` is the reference's function
    with one difference (ROADMAP C4): the merged counts saturate at
    2^32 - 1 in the numpy branches as in the native merge, which the
    docstring says."""
    port = _definitions(_read(os.path.join(PORT, "kernels", "kmer.py")))
    ref = _definitions(_renamed(os.path.join(REF, "kernels", "kmer.py")))
    want = ref["merge_kmer_counts"]
    for old, new in (
        ("""        keep = sums >= min_count
        return hi[starts][keep], lo[starts][keep], sums[keep].astype(
            np.int64
        )""", """        keep = sums >= min_count
        return hi[starts][keep], lo[starts][keep], np.minimum(
            sums[keep], COUNT_MAX
        ).astype(np.int64)"""),
        ("""        return hi[keep], lo[keep], cnt[keep].astype(np.int64)""",
         """        return hi[keep], lo[keep], np.minimum(cnt[keep], COUNT_MAX).astype(
            np.int64
        )"""),
        ("""    the same way if that ever matters; production k is 49.)
    \"\"\"""", """    the same way if that ever matters; production k is 49.)

    Counts are summed in int64, filtered, then saturated at
    :data:`COUNT_MAX` = 2^32 - 1, as the native merge (``hx_kmer_merge``,
    ``native/kmer.cpp``) stores them in uint32: both branches give one
    answer.  This is the one difference from the reference's function,
    whose numpy branch returns the unsaturated sums.
    \"\"\""""),
    ):
        assert want.count(old) == 1, old
        want = want.replace(old, new)
    assert port["merge_kmer_counts"] == want
    assert port["COUNT_MAX"] == "COUNT_MAX = 0xFFFFFFFF"
