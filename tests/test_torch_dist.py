"""The port on several devices and several processes against the JAX
package: the ``dp`` mesh (CPU shards here, standing in for the JAX
tests' virtual CPU devices) over the score-only NW step, the consensus
rounds under both NW engines, the read mapper and the short-read k-mer
merge; host-sharded mapping by two processes under gloo; and the
launch-device repair's cache keys.  Exact equality throughout."""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haslr_tpu.kernels import kmer as kk
from haslr_tpu.kernels import nw
from haslr_tpu.testutil import simulate
from haslr_tpu_torch.dist.mesh import Mesh, make_mesh
from haslr_tpu_torch.kernels import nw as pnw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def cpu_mesh(n):
    return make_mesh(n, device="cpu")


# --------------------------------------------------------------------------
# the mesh itself
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_rows,n", [(10, 3), (2, 3), (0, 2), (16, 8)])
def test_mesh_blocks_cover_rows_in_order(n_rows, n):
    blocks = cpu_mesh(n).blocks(n_rows)
    assert len(blocks) == n and blocks[0][0] == 0 and blocks[-1][1] == n_rows
    sizes = [b - a for a, b in blocks]
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]


def test_mesh_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="index"):
        Mesh(["cuda"])
    with pytest.raises(ValueError, match="all cuda or all cpu"):
        Mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="at least one"):
        Mesh([])
    with pytest.raises(ValueError, match="number of shards"):
        make_mesh(None, device="cpu")
    m = Mesh(["cuda:0", "cuda:0"])  # one card split in two: allowed
    assert m.size == 2 and m.devices == (torch.device("cuda", 0),) * 2


def test_make_mesh_never_shrinks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices but only 1"):
        make_mesh(2)
    m = make_mesh(None)
    assert m.devices == (torch.device("cuda", 0),)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert make_mesh(3).devices == tuple(
        torch.device("cuda", i) for i in range(3))


def test_a_device_beside_a_mesh_must_agree(tmp_path):
    """An entry point turns (device, mesh) into one mesh: a device of
    another kind than the mesh's raises instead of being ignored, and the
    pipeline takes its mesh from ``devices`` or from ``mesh=``, not both."""
    from haslr_tpu_torch.cli import haslr as cli
    from haslr_tpu_torch.config import PipelineConfig
    from haslr_tpu_torch.dist.mesh import as_mesh

    cpu2 = cpu_mesh(2)
    assert as_mesh("cpu", cpu2) is cpu2 and as_mesh(None, cpu2) is cpu2
    assert as_mesh("cpu", None).devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="disagrees"):
        as_mesh("cuda", cpu2)
    with pytest.raises(ValueError, match="disagrees"):
        as_mesh("cpu", Mesh(["cuda:0", "cuda:0"]))
    out = tmp_path / "never"
    cfg = PipelineConfig(out=str(out), devices=2)
    with pytest.raises(ValueError, match="not both"):
        cli.run_pipeline(cfg, "cpu", mesh=cpu2)
    with pytest.raises(ValueError, match="disagrees"):
        cli.run_pipeline(PipelineConfig(out=str(out)), "cuda", mesh=cpu2)
    assert not out.exists()
    assert cli._get_mesh(cfg, "cpu").devices == (torch.device("cpu"),) * 2


def test_per_device_caches_need_an_indexed_card():
    """The band tables and SM counts are cached by device: a plain
    ``cuda`` (whichever card is current) is refused before any CUDA call,
    so it can never share an entry with ``cuda:0`` or ``cuda:1``."""
    from haslr_tpu_torch.kernels import nw_rowscan as rs
    from haslr_tpu_torch.kernels import nw_wavefront as wf

    for call in (lambda d: rs._base_tensor(64, 64, 32, 64, d),
                 lambda d: wf._base_tensor(64, 64, 32, d),
                 rs._sm_count):
        with pytest.raises(ValueError, match="indexed"):
            call(torch.device("cuda"))
    cpu = torch.device("cpu")
    assert rs._base_tensor(64, 64, 32, 64, cpu) is \
        rs._base_tensor(64, 64, 32, 64, cpu)
    assert rs.check_indexed(torch.device("cuda", 1)) != \
        rs.check_indexed(torch.device("cuda", 0))


# --------------------------------------------------------------------------
# nw_scores and the support step
# --------------------------------------------------------------------------


def _score_batch(rng, B, R, D):
    drafts = rng.integers(0, 4, (B, D)).astype(np.uint8)
    reads = rng.integers(0, 4, (B, R)).astype(np.uint8)
    m = min(R, D)
    keep = rng.random((B, m)) < 0.9
    reads[:, :m] = np.where(keep, drafts[:, :m], reads[:, :m])
    r_lens = rng.integers(0, R + 1, B).astype(np.int32)
    d_lens = np.clip(r_lens + rng.integers(-6, 7, B), 0, D).astype(np.int32)
    r_lens[0] = d_lens[0] = 0  # an empty pair
    r_lens[1] = 0
    d_lens[2] = 0
    return reads, r_lens, drafts, d_lens


@pytest.mark.parametrize("B,R,D,W", [(16, 128, 128, 128), (12, 100, 90, 64),
                                     (8, 90, 120, 32), (6, 64, 64, 128)])
def test_nw_scores_matches_jax(B, R, D, W):
    batch = _score_batch(np.random.default_rng(R + D), B, R, D)
    want = np.asarray(nw.nw_scores(*map(jnp.asarray, batch), W=W))
    got = pnw.nw_scores(*map(torch.from_numpy, batch), W=W)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _step_inputs():
    """The inputs of ``tests/test_dist.py``'s support-step test."""
    B, S = 32, 128
    n_edges = 7
    rng = np.random.default_rng(3)
    drafts = rng.integers(0, 4, (B, S)).astype(np.uint8)
    reads = drafts.copy()
    mask = rng.random((B, S)) < 0.08
    reads = np.where(mask, (reads + 1) % 4, reads).astype(np.uint8)
    r_lens = rng.integers(60, 100, B).astype(np.int32)
    d_lens = r_lens + rng.integers(-3, 4, B).astype(np.int32)
    edge_ids = rng.integers(0, n_edges, B).astype(np.int32)
    return (reads, r_lens, drafts, d_lens, edge_ids), n_edges


@pytest.fixture(scope="module")
def jax_step():
    from haslr_tpu.dist.consensus_step import make_sharded_step, shard_batch
    from haslr_tpu.dist.mesh import make_mesh as jax_mesh

    arrays, n_edges = _step_inputs()
    mesh = jax_mesh(8)
    step = make_sharded_step(mesh, n_edges, W=128)
    scores, supp = step(*shard_batch(mesh, arrays))
    return np.asarray(scores), np.asarray(supp)


@pytest.mark.parametrize("n", [8, 3])
def test_sharded_support_step_matches_jax(jax_step, n):
    from haslr_tpu_torch.dist.consensus_step import (
        make_sharded_step,
        shard_batch,
    )

    arrays, n_edges = _step_inputs()
    mesh = cpu_mesh(n)
    scores, supp = make_sharded_step(mesh, n_edges, W=128)(
        *shard_batch(mesh, arrays))
    np.testing.assert_array_equal(scores.numpy(), jax_step[0])
    np.testing.assert_array_equal(supp.numpy(), jax_step[1])
    want = np.bincount(arrays[4][jax_step[0] >= 0], minlength=n_edges)
    np.testing.assert_array_equal(supp.numpy(), want)


# --------------------------------------------------------------------------
# consensus rounds
# --------------------------------------------------------------------------


def _mutator(rng, p_del, p_sub, p_ins):
    bases = "ACGT"

    def mutate(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < p_del:
                continue
            if r < p_sub:
                out.append(bases[rng.integers(0, 4)])
            else:
                out.append(ch)
                if r < p_ins:
                    out.append(bases[rng.integers(0, 4)])
        return "".join(out)

    return mutate


def _windows():
    """The windows of ``tests/test_dist.py``'s sharded-consensus test."""
    rng = np.random.default_rng(11)
    mutate = _mutator(rng, 0.02, 0.04, 0.06)
    windows = []
    for _ in range(23):
        L = int(rng.integers(80, 700))
        true = "".join("ACGT"[i] for i in rng.integers(0, 4, L))
        n_sup = int(rng.integers(1, 14))
        windows.append([mutate(true) for _ in range(n_sup)])
    windows.append([])
    windows.append(["ACGT"])
    return windows


def _set_engine(monkeypatch, engine):
    monkeypatch.setattr(nw, "ENGINE", engine)
    monkeypatch.setattr(pnw, "ENGINE", engine)


@pytest.fixture(scope="module")
def consensus_refs():
    """Per engine: (JAX's output, the port's on one CPU device).  JAX's
    own mesh output equals its single-device one (``tests/test_dist.py``)."""
    from haslr_tpu.kernels.consensus import batched_consensus as ref
    from haslr_tpu_torch.kernels.consensus import batched_consensus

    torch.set_num_threads(1)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for engine in ("rowscan", "wavefront"):
            _set_engine(mp, engine)
            out[engine] = (ref(_windows()),
                           batched_consensus(_windows(), device="cpu"))
    return out


@pytest.mark.parametrize("engine", ["rowscan", "wavefront"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_sharded_consensus_matches_single_and_jax(consensus_refs, monkeypatch,
                                                  engine, n):
    from haslr_tpu_torch.kernels.consensus import batched_consensus

    _set_engine(monkeypatch, engine)
    want, single = consensus_refs[engine]
    assert single == want
    assert batched_consensus(_windows(), mesh=cpu_mesh(n)) == single


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_dense_consensus_edge_windows(n):
    """The engine-agreement windows, with the empty, single-read,
    all-empty and identical-read windows among them, through
    ``dense_consensus`` on a mesh: the same drafts as one device."""
    from haslr_tpu_torch.core import seq as pseq
    from haslr_tpu_torch.kernels.consensus_dense import dense_consensus
    from test_torch_consensus import WINDOW_SETS, str_windows

    codes = [[pseq.encode(s) for s in w if s]
             for w in str_windows(*WINDOW_SETS["engines"])]
    single = dense_consensus(codes, device="cpu")
    got = dense_consensus(codes, mesh=cpu_mesh(n))
    assert len(got) == len(single) == len(codes)
    for a, b in zip(got, single):
        np.testing.assert_array_equal(a, b)


def test_sharded_consensus_multibucket_multisubgroup(monkeypatch):
    """Three buckets, each split into several dispatches by a lowered
    read cap (``MAX_READS`` a device, times the mesh's size), on a
    3-shard mesh: the same output as the JAX package and as one device,
    and the dispatch count shows the split."""
    from haslr_tpu.kernels.consensus import batched_consensus as ref
    from haslr_tpu_torch.kernels import consensus_dense as pcd
    from haslr_tpu_torch.kernels.consensus import batched_consensus

    rng = np.random.default_rng(29)
    mutate = _mutator(rng, 0.015, 0.03, 0.045)
    windows = []
    for L in (90, 100, 110, 220, 240, 260, 300, 460, 470, 480, 490, 500):
        true = "".join("ACGT"[i] for i in rng.integers(0, 4, L))
        windows.append([mutate(true) for _ in range(9)])
    want = ref(windows)
    dispatch = pcd._dispatch_group
    n_dispatch = []

    def counted(*args):
        n_dispatch.append(1)
        return dispatch(*args)

    monkeypatch.setattr(pcd, "_dispatch_group", counted)
    monkeypatch.setattr(pcd, "MAX_READS", 8)  # x 3 shards: 24 reads
    assert batched_consensus(windows, mesh=cpu_mesh(3)) == want
    assert len(n_dispatch) >= 6, n_dispatch  # 3 buckets x >= 2 groups
    monkeypatch.setattr(pcd, "MAX_READS", 24)
    assert batched_consensus(windows, device="cpu") == want


def test_sharded_consensus_sums_drops_before_the_max(monkeypatch):
    """The band-incompatible warning counts the reads of each window
    summed over the shards (the reference's psum before the max): a
    window whose out-of-gate reads land on different shards warns with
    their total."""
    from haslr_tpu_torch.kernels.consensus import batched_consensus

    rng = np.random.default_rng(5)
    true = "".join("ACGT"[i] for i in rng.integers(0, 4, 300))
    # median draft 300 bp, W = 128: the reads 80 bp shorter are out of
    # the gate, and the four shards hold 0, 1, 1 and 1 of them
    window = [true, true, true, true[:220], true, true[:220], true[:220]]
    said = {}
    for n in (1, 4):
        warns = []
        out = batched_consensus([window], warn=warns.append,
                                mesh=cpu_mesh(n))
        said[n] = (out, [w for w in warns if "band-incompatible" in w])
    assert said[1] == said[4]
    assert said[1][1] and said[1][1][0].startswith(
        "consensus: 3 band-incompatible")


# --------------------------------------------------------------------------
# the read mapper
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def map_data(tmp_path_factory):
    """The contigs and reads of ``tests/test_dist.py``'s sharded-aligner
    test, and the JAX package's PAF of them."""
    from haslr_tpu.aligner.map import map_reads

    root = tmp_path_factory.mktemp("torch_dist_map")
    rng = np.random.default_rng(6)
    genome = simulate.genome_with_repeats(
        rng, 20_000, n_families=2, copies_per_family=3, repeat_len=300
    )
    ctg = str(root / "ctg.fa")
    with open(ctg, "w") as fp:
        for i in range(0, len(genome) - 1500, 1500):
            fp.write(f">{i // 1500}\n{genome[i:i + 2000]}\n")
    reads = simulate.make_reads(
        rng, genome, coverage=4.0, mean_len=6000, error_rate=0.06
    )
    lr = str(root / "lr.fa")
    with open(lr, "w") as fp:
        for r in reads:
            fp.write(f">{r.rid}\n{r.seq}\n")
    ref = str(root / "ref.paf")
    assert map_reads(ctg, lr, ref) > 0
    with open(ref, "rb") as f:
        return ctg, lr, f.read()


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_mapping_paf_matches_single_and_jax(map_data, tmp_path, n):
    from haslr_tpu_torch.aligner.map import map_reads

    ctg, lr, want = map_data
    got = {}
    for tag, kw in (("one", {"device": "cpu"}), ("mesh", {"mesh":
                                                          cpu_mesh(n)})):
        path = str(tmp_path / f"{tag}.paf")
        map_reads(ctg, lr, path, **kw)
        with open(path, "rb") as f:
            got[tag] = f.read()
    assert got["one"] == want
    assert got["mesh"] == want


def test_sharded_align_mapping_rows_in_order():
    """Both sharded align entry points give the single call's rows, block
    by block, with uneven blocks and a block left empty."""
    from haslr_tpu_torch.kernels import nw_rowscan as rs

    rng = np.random.default_rng(8)
    batch = _score_batch(rng, 5, 128, 128)
    mesh = cpu_mesh(8)  # 5 rows: three shards get none
    want_map = pnw.align_mapping_device(*batch, 64, device="cpu")
    got = pnw.align_mapping_device_sharded(*batch, mesh, 64)
    assert len(got) == 5
    np.testing.assert_array_equal(
        np.concatenate([m.numpy() for m in got]), want_map)
    runs, n_runs = rs.cigar_runs_device_raw(*batch, 64, device="cpu")
    parts = rs.cigar_runs_device_sharded(*batch, cpu_mesh(3), 64)
    np.testing.assert_array_equal(
        np.concatenate([r.numpy() for r, _ in parts]), runs.numpy())
    np.testing.assert_array_equal(
        np.concatenate([n.numpy() for _, n in parts]), n_runs.numpy())


# --------------------------------------------------------------------------
# the short-read k-mer merge
# --------------------------------------------------------------------------


def _count_shards(rng, k, n_shards, n_reads=400):
    genome = rng.integers(0, 4, 8_000).astype(np.uint8)
    reads = [genome[p : p + 120]
             for p in rng.integers(0, len(genome) - 120, n_reads)]
    shards = []
    for s in range(n_shards):
        block = reads[s * n_reads // n_shards : (s + 1) * n_reads // n_shards]
        cat = np.concatenate([np.append(r, kk.SEP).astype(np.uint8)
                              for r in block])
        shards.append(kk.count_kmers_host(cat, k, 1))
    return shards


def _no_native_merge(monkeypatch):
    from haslr_tpu import native as ref_native
    from haslr_tpu_torch import native

    monkeypatch.setattr(ref_native, "merge_kmer_native", lambda *a: None)
    monkeypatch.setattr(native, "merge_kmer_native", lambda *a: None)


@pytest.mark.parametrize("branch", ["native", "numpy"])
@pytest.mark.parametrize("k,n_shards", [(31, 4), (49, 3), (49, 1)])
def test_merge_kmer_counts_matches_jax(monkeypatch, branch, k, n_shards):
    from haslr_tpu_torch.kernels.kmer import merge_kmer_counts

    if branch == "numpy":
        _no_native_merge(monkeypatch)
    shards = _count_shards(np.random.default_rng(k + n_shards), k, n_shards)
    for min_count in (1, 3):
        want = kk.merge_kmer_counts(shards, min_count)
        got = merge_kmer_counts(shards, min_count)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert len(merge_kmer_counts([], 1)[0]) == 0


@pytest.mark.parametrize("branch", ["native", "numpy"])
def test_merge_kmer_counts_saturates_at_uint32(monkeypatch, branch):
    """C4: counts summing past 2^32 - 1 come out as 2^32 - 1 from both
    branches (the native merge's uint32 ceiling), filtered on the full
    sum; the reference's numpy branch alone returns the full sum."""
    from haslr_tpu_torch.kernels.kmer import COUNT_MAX, merge_kmer_counts

    if branch == "numpy":
        _no_native_merge(monkeypatch)
    big = np.int64(3_000_000_000)
    u = np.uint64
    parts = [
        (np.array([0, 0], u), np.array([5, 9], u), np.array([big, 1])),
        (np.array([0, 0], u), np.array([5, 7], u), np.array([big, 2])),
    ]
    hi, lo, cnt = merge_kmer_counts(parts, 2)
    np.testing.assert_array_equal(lo, [5, 7])
    np.testing.assert_array_equal(cnt, [COUNT_MAX, 2])
    assert cnt.dtype == np.int64
    one = merge_kmer_counts([(np.array([0], u), np.array([5], u),
                              np.array([2 * big]))], 1)
    np.testing.assert_array_equal(one[2], [COUNT_MAX])
    if branch == "numpy":
        assert kk.merge_kmer_counts(parts, 2)[2][0] == 2 * big


@pytest.fixture(scope="module")
def sr_reads(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dist_sr")
    rng = np.random.default_rng(9)
    genome = simulate.genome_with_repeats(
        rng, 20_000, n_families=2, copies_per_family=3, repeat_len=300
    )
    sr = str(root / "sr.fq")
    simulate.write_short_reads(sr, simulate.make_short_reads(
        rng, genome, coverage=30.0))
    return sr


@pytest.mark.parametrize("n", [3, 8])
def test_sharded_short_read_assembly_matches_single(sr_reads, tmp_path, n):
    from haslr_tpu_torch.sr import assemble_sr

    out = {}
    for tag, mesh in (("one", None), ("mesh", cpu_mesh(n))):
        path = tmp_path / f"{tag}.fa"
        assemble_sr.assemble_short_reads([sr_reads], str(path),
                                         kmer_size=49, mesh=mesh)
        out[tag] = (path.read_bytes(), assemble_sr.PROF["count_engine"])
    assert out["one"][1] == "native" and out["mesh"][1] == "native_sharded"
    assert out["one"][0] == out["mesh"][0] and len(out["one"][0]) > 10_000


def test_sharded_streaming_count_is_not_ported(sr_reads, tmp_path):
    """The streaming count over a mesh (it raised until the device
    counters were ported; the name is kept) writes the single native
    count's SR contigs."""
    from haslr_tpu_torch.sr import assemble_sr

    out = {}
    for tag, kw in (("one", {}),
                    ("mesh", {"streaming": True, "mesh": cpu_mesh(2),
                              "torch_device": "cpu"})):
        path = tmp_path / f"{tag}.fa"
        assemble_sr.assemble_short_reads([sr_reads], str(path),
                                         kmer_size=49, **kw)
        out[tag] = path.read_bytes()
    assert "count.phase2_merge" in assemble_sr.PROF
    assert out["one"] == out["mesh"] and len(out["one"]) > 10_000


# --------------------------------------------------------------------------
# several processes
# --------------------------------------------------------------------------

_WORKER = r"""
import sys

import torch

torch.set_num_threads(1)
coord, pid, ctg, lr, out_paf = sys.argv[1:6]
sys.path.insert(0, {repo!r})
import torch.distributed as td

from haslr_tpu_torch import dist
from haslr_tpu_torch.aligner.map import map_reads

dist.initialize(coord, 2, int(pid), timeout_s=120)
assert dist.host_shard() == (int(pid), 2), dist.host_shard()
assert td.get_backend() == "gloo"
map_reads(ctg, lr, out_paf, host_shard=dist.host_shard(), device="cpu")
td.destroy_process_group()
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    return dict(os.environ, GLOO_SOCKET_IFNAME="lo", PYTHONPATH=ROOT)


def test_two_process_host_sharded_mapping(tmp_path):
    """Two processes under gloo each map their host shard of the reads;
    the shards' lines are the single process's, and the assembler's fofn
    path loads the same alignments from the two shards as from the single
    PAF (port of ``tests/test_multiprocess.py``)."""
    from haslr_tpu.aligner.map import map_reads as ref_map
    from haslr_tpu_torch.aligner.map import map_reads
    from haslr_tpu_torch.assemble.contig_store import ContigStore
    from haslr_tpu_torch.assemble.longread_store import (
        LongreadStore,
        load_alignments,
    )
    from haslr_tpu_torch.config import AssembleConfig

    rng = np.random.default_rng(13)
    genome = simulate.genome_with_repeats(
        rng, 15_000, n_families=2, copies_per_family=3, repeat_len=300
    )
    ctg = str(tmp_path / "ctg.fa")
    with open(ctg, "w") as fp:
        for i in range(0, len(genome) - 1500, 1500):
            fp.write(f">{i // 1500}\n{genome[i:i + 2000]}\n")
    reads = simulate.make_reads(
        rng, genome, coverage=3.0, mean_len=5000, error_rate=0.06
    )
    lr = str(tmp_path / "lr.fa")
    with open(lr, "w") as fp:
        for r in reads:
            fp.write(f">{r.rid}\n{r.seq}\n")

    worker = str(tmp_path / "worker.py")
    with open(worker, "w") as fp:
        fp.write(_WORKER.format(repo=ROOT))
    coord = f"127.0.0.1:{_free_port()}"
    shards = [str(tmp_path / f"shard{i}.paf") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, str(i), ctg, lr, shards[i]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_env(),
        )
        for i in range(2)
    ]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]

    single = str(tmp_path / "single.paf")
    map_reads(ctg, lr, single, device="cpu")
    ref = str(tmp_path / "ref.paf")
    ref_map(ctg, lr, ref)
    with open(single) as f:
        want = sorted(f.readlines())
    with open(ref) as f:
        assert sorted(f.readlines()) == want
    got = []
    for s in shards:
        with open(s) as f:
            got.extend(f.readlines())
    assert sorted(got) == want and len(want) > 0
    assert all(os.path.getsize(s) > 0 for s in shards)

    cfg = AssembleConfig()
    contigs = ContigStore.load_fasta(ctg)
    uniq = contigs.calc_uniq_freq()

    def load(paths):
        lrs = LongreadStore.load_fasta(lr)
        for p in paths:
            load_alignments(p, contigs, lrs, uniq, cfg)
        return [
            [tuple(v.tobytes() if isinstance(v, np.ndarray) else v
                   for v in vars(a).values()) for a in per_read]
            for per_read in lrs.alignments
        ]

    assert load([single]) == load(shards)


def test_initialize_explicit_bad_coordinator_fails():
    """A coordinator nobody serves must fail the process (exit 42 below,
    or an abort of its own), never leave it single (exit 7).  Rank 1 of
    two on a local port where nothing listens; a subprocess keeps this
    process outside any group."""
    script = (
        "import sys; sys.path.insert(0, %r)\n"
        "from haslr_tpu_torch import dist\n"
        "try:\n"
        "    dist.initialize('127.0.0.1:%d', 2, 1, timeout_s=5)\n"
        "except Exception:\n"
        "    sys.exit(42)\n"
        "sys.exit(7)\n" % (ROOT, _free_port())
    )
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       timeout=120, env=_env())
    assert p.returncode not in (0, 7), (
        f"bad coordinator address left the process single "
        f"(rc={p.returncode})")


def test_initialize_without_arguments_stays_single(monkeypatch):
    import torch.distributed as td

    from haslr_tpu_torch import dist

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    dist.initialize()
    assert not td.is_initialized()
    assert dist.host_shard() == (0, 1)
    with pytest.raises(ValueError, match="together"):
        dist.initialize("127.0.0.1:1")
