"""The port's chunked consensus engine (``kernels/consensus.py:
_one_round`` with ``kernels/pileup.py``) on the CPU against the JAX
package's chunked engine and the port's dense engine, under both NW
engines and with the vote tables on the device or on the host (ports of
``tests/test_consensus_kernel.py:129-190``)."""

import numpy as np
import pytest
import torch

from haslr_tpu.kernels import nw as jnw
from haslr_tpu.kernels.consensus import batched_consensus as jax_consensus

from haslr_tpu_torch.dist.mesh import make_mesh
from haslr_tpu_torch.kernels import nw
from haslr_tpu_torch.kernels.consensus import batched_consensus

BASES = "ACGT"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(params=["rowscan", "wavefront"])
def engine(request, monkeypatch):
    """Both packages' NW engine set for the test, restored after it."""
    monkeypatch.setattr(nw, "ENGINE", request.param)
    monkeypatch.setattr(jnw, "ENGINE", request.param)
    return request.param


def _mutate(rng, s, rate):
    out = []
    for ch in s:
        r = rng.random()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append(BASES[rng.integers(0, 4)])
        else:
            out.append(ch)
            if r < rate:
                out.append(BASES[rng.integers(0, 4)])
    return "".join(out)


def _windows(seed, lengths, rate, edge_cases):
    rng = np.random.default_rng(seed)
    windows = []
    for L in lengths:
        true = "".join(BASES[i] for i in rng.integers(0, 4, L))
        windows.append([_mutate(rng, true, rate) for _ in range(9)])
    if edge_cases:
        s = "ACGTTGCAGGACCATAGGACCA"
        windows += [[], ["ACGT"], ["", ""], [s, s, s]]
    return windows


# the two window sets of the reference's engine tests: device vs host
# pileup (80, 250, 600 bp) and dense vs chunked (60, 200, 500 bp with the
# empty, single-read, all-empty and identical-read windows)
WINDOW_SETS = {
    "pileups": (21, (80, 250, 600), 0.07, False),
    "engines": (33, (60, 200, 500), 0.07, True),
}


@pytest.mark.parametrize("device_pileup", [True, False])
@pytest.mark.parametrize("which", sorted(WINDOW_SETS))
def test_chunked_matches_jax_chunked_and_port_dense(engine, which,
                                                    device_pileup):
    windows = _windows(*WINDOW_SETS[which])
    want = jax_consensus(windows, engine="chunked",
                         device_pileup=device_pileup)
    got = batched_consensus(windows, engine="chunked",
                            device_pileup=device_pileup, device="cpu")
    assert got == want
    assert batched_consensus(windows, device="cpu") == got


def test_chunked_empty_and_single_windows():
    for windows, want in (([[]], [""]), ([["ACGT"]], ["ACGT"]),
                          ([["", ""]], [""]), ([], [])):
        for device_pileup in (True, False):
            assert batched_consensus(windows, engine="chunked",
                                     device_pileup=device_pileup,
                                     device="cpu") == want


def test_chunked_runs_the_engines_mapping_kernel(engine, monkeypatch):
    """The chunked rounds reach the active engine's mapping wrapper (B3
    under the row-scan engine, B5 under the wavefront), on every chunk of
    every round, and the other engine's never."""
    from haslr_tpu_torch.kernels import nw as pnw

    calls = {"rowscan": 0, "wavefront": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(pnw, "rowscan_mapping",
                        spy("rowscan", pnw.rowscan_mapping))
    monkeypatch.setattr(pnw, "wavefront_mapping",
                        spy("wavefront", pnw.wavefront_mapping))
    windows = _windows(5, (120, 300), 0.05, False)
    batched_consensus(windows, engine="chunked", device="cpu")
    # two rounds of two buckets (S = 256 and 512), one chunk each
    other = ({"rowscan", "wavefront"} - {engine}).pop()
    assert calls == {engine: 4, other: 0}


def test_chunked_on_a_mesh_runs_on_its_first_device():
    """The chunked engine does not shard, as the reference's does not:
    given only a mesh it runs on the mesh's first device."""
    windows = _windows(7, (100, 260), 0.06, True)
    single = batched_consensus(windows, engine="chunked", device="cpu")
    assert batched_consensus(windows, engine="chunked",
                             mesh=make_mesh(3, device="cpu")) == single


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="engine"):
        batched_consensus([["ACGT"] * 3], engine="sparse", device="cpu")


def test_device_pileup_tables_equal_host_pileup():
    """One chunk's scatter into the device tables equals the host
    ``_Pileup.add_chunk`` table for table, and the two votes agree, on a
    mapping from the row-scan mapping's plain version."""
    from haslr_tpu_torch.kernels.consensus import _Pileup
    from haslr_tpu_torch.kernels.pileup import DevicePileup

    rng = np.random.default_rng(3)
    S, W, B = 256, 128, 24
    drafts = [rng.integers(0, 4, int(n)).astype(np.uint8)
              for n in rng.integers(90, 200, 4)]
    reads = np.full((B, S), 4, np.uint8)
    dr = np.full((B, S), 4, np.uint8)
    r_lens = np.zeros(B, np.int32)
    d_lens = np.zeros(B, np.int32)
    win_idx = rng.integers(0, len(drafts), B)
    for b in range(B):
        d = drafts[win_idx[b]]
        r = np.array([c for c in d if rng.random() > 0.05]
                     + list(rng.integers(0, 4, int(rng.integers(0, 6)))),
                     np.uint8)
        reads[b, : len(r)] = r
        dr[b, : len(d)] = d
        r_lens[b], d_lens[b] = len(r), len(d)
    r_lens[-1] = 0  # a row that aligns nothing
    mapping = nw.align_mapping_device(reads, r_lens, dr, d_lens, W,
                                      device="cpu")
    host = _Pileup(drafts)
    host.add_chunk(mapping, reads, r_lens, win_idx)
    dev = DevicePileup(drafts, torch.device("cpu"))
    dev.add_chunk_device(torch.from_numpy(mapping), reads, r_lens, win_idx)
    np.testing.assert_array_equal(dev.counts.numpy(), host.counts)
    np.testing.assert_array_equal(dev.cov_diff.numpy(), host.cov_diff[:-1])
    np.testing.assert_array_equal(dev.ins1.numpy(), host.ins1)
    np.testing.assert_array_equal(dev.ins2.numpy(), host.ins2)
    np.testing.assert_array_equal(dev.n_reads.numpy(), host.n_reads)
    assert host.ins1.sum() > 0 and host.n_reads.min() > 0
    for a, b in zip(dev.vote(drafts), host.vote(drafts), strict=True):
        np.testing.assert_array_equal(a, b)
