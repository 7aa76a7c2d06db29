"""Row-scan banded NW: plain PyTorch versions and the CUDA kernel wrappers.

Port of :mod:`haslr_tpu.kernels.nw_rowscan`.  The DP scans one read row
per step over a W-lane band that follows the length-proportional
diagonal; the in-row LEFT chain collapses to a prefix max
(``torch.cummax`` here, exact for every W — the Pallas ``_prefix_max``
was exact only for W <= 128).  A row-lockstep traceback then emits one
of three products:

- vote planes + aligned span (:func:`rowscan_votes`, consensus rounds) —
  CUDA kernel ``hx_rowscan_votes`` in ``csrc/rowscan.cu``;
- CIGAR runs (:func:`rowscan_cigar`, the aligner's extension) — CUDA
  kernel ``hx_rowscan_cigar``;
- the read->draft mapping (:func:`rowscan_mapping`,
  :func:`haslr_tpu_torch.kernels.nw.align_mapping_device` under the
  default engine) — CUDA kernel ``hx_rowscan_mapping``.

Each wrapper takes its plain version for tensors on the CPU and launches
its kernel for CUDA tensors (or raises); there is no fallback between the
two.  Every entry point checks :func:`rowscan_supported`.

The kernels keep two bits a direction in a global scratch, a thread
owning C band lanes and a read WPR warps (32 * C * WPR lanes: 128, 256 or
512); :func:`_route` picks among these by band width and launch size.  A
band of another width (32 to 512 in steps of 32) runs on the next of
these with its spare lanes masked, and code rows whose length is no
multiple of four are padded to one (:func:`_word_rows`).
:func:`pack_dirs_row` and :func:`resolve_packed` mirror the packed
traceback step on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

NEG = -(10**8)
DIAG, UP, LEFT = 0, 1, 2

# direction-scratch budget per launch, by device type: the wrappers cut
# the batch so that the scratch bytes per read (one byte a cell for the
# plain versions and the wavefront kernels, two bits a cell for the
# row-scan kernels) stay within it
DIRS_BUDGET = {"cuda": 4 << 30, "cpu": 256 << 20}

# kernel launches by wrapper (plain-version calls do not count); reset
# and read by callers that must show the main path went through a kernel
LAUNCHES = {"rowscan_votes": 0, "rowscan_cigar": 0, "rowscan_mapping": 0}

# like LAUNCHES, for callers that report on a run and for nothing on the
# main path: when a list, every kernel launch appends (name, B, R, W,
# start event, end event), CUDA events recorded around the launch on its
# stream; None (the default) records nothing
LAUNCH_LOG: list | None = None

# the row-scan kernels' routes: (C lanes a thread, WPR warps a read) by
# the lanes computed, 32 * C * WPR.  One warp a read fills the card with
# reads.  At 512 lanes a launch of fewer than SMALL_LAUNCH reads (the
# extension's largest buckets) spreads a read over four warps at C = 4
# with one barrier a row instead: there one row's latency is the
# launch's time.  Measured on an H100 at S = 16384: 7.1 ms against 8.1
# at 32 and at 128 reads; at 512 reads and S = 4096 one warp a read wins,
# 2.16 ms against 2.38.
ROUTES = {128: ((4, 1),), 256: ((8, 1),), 512: ((16, 1), (4, 4))}
SMALL_LAUNCH = 256
MAX_READS_PER_BLOCK = 16      # one warp a read: reads (warps) a block


def row_bases(R: int, D: int, W: int) -> np.ndarray:
    """Lane-0 draft column per read row i in [0, R]: the
    length-proportional diagonal minus W/2, clipped and monotone.  For the
    production shapes (R == D) consecutive steps are in {0, 1}."""
    i = np.arange(R + 1, dtype=np.int64)
    center = (i * D) // max(R, 1)
    hi = max(0, D - W + 1)
    base = np.clip(center - W // 2, 0, hi)
    base = np.maximum.accumulate(base)
    return base.astype(np.int32)


def rowscan_supported(R: int, D: int, W: int) -> bool:
    """The DP assumes the row band advances by {0, 1} columns per row
    (true whenever D <= R; all production call sites pad to R == D)."""
    return D <= R or bool((np.diff(row_bases(R, D, W)) <= 1).all())


def _check_shape(R: int, D: int, W: int):
    if not rowscan_supported(R, D, W):
        raise ValueError(
            f"row-scan band unsupported for R={R}, D={D}, W={W}: the row "
            "bases must advance by at most one column per row"
        )


# --------------------------------------------------------------------------
# plain PyTorch versions (vectorised over the batch, a Python loop over
# rows); the CPU path and the reference the CUDA kernels are held to
# --------------------------------------------------------------------------


def rowscan_dirs_plain(reads, r_lens, drafts, d_lens, W, match, mismatch,
                       gap):
    """Row-scan DP; returns directions (R+1, B, W) uint8 (row 0 zero)."""
    B, R = reads.shape
    D = drafts.shape[1]
    _check_shape(R, D, W)
    dev = reads.device
    base = row_bases(R, D, W)
    lanes = torch.arange(W, dtype=torch.int32, device=dev)
    glane = gap * lanes
    rl = r_lens.to(torch.int32)[:, None]
    dl = d_lens.to(torch.int32)[:, None]
    neg, match_t, mismatch_t = torch.tensor(
        [NEG, match, mismatch], dtype=torch.int32, device=dev
    )
    h = torch.where(lanes[None, :] <= dl, glane, neg)
    drafts_p = torch.cat(
        [drafts, torch.full((B, 1), 4, dtype=drafts.dtype, device=dev)], 1
    )
    negcol = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    dirs = torch.zeros((R + 1, B, W), dtype=torch.uint8, device=dev)
    for i in range(1, R + 1):
        b_i = int(base[i])
        s = b_i - int(base[i - 1])
        hp = torch.cat([negcol, h, negcol], 1)  # lanes -1 .. W
        up = hp[:, s + 1 : s + 1 + W]
        diag = hp[:, s : s + W]
        j = b_i + lanes
        db = drafts_p[:, torch.clamp(j - 1, 0, D).long()]
        sub = torch.where(reads[:, i - 1 : i] == db, match_t, mismatch_t)
        cand_d = diag + sub
        cand_u = up + gap
        valid = (j[None, :] <= dl) & (i <= rl)
        x = torch.where(valid, torch.maximum(cand_d, cand_u), neg) - glane
        hh = glane + torch.cummax(x, 1).values
        dirs[i] = torch.where(
            hh == cand_d, DIAG, torch.where(hh == cand_u, UP, LEFT)
        ).to(torch.uint8)
        h = torch.where(valid, hh, neg)
    return dirs


def _traceback(dirs, r_lens, d_lens, R, D, W, on_row):
    """Row-lockstep traceback over rows r = R .. 1.  For each row calls
    ``on_row(r, active, is_diag, is_up, jp, j)`` (jp: the acted-on
    column, j: the column before the act); returns the final j (B,)."""
    dev = dirs.device
    base = row_bases(R, D, W)
    lanes = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    i = r_lens.to(torch.int64).clone()
    j = d_lens.to(torch.int64).clone()
    for r in range(R, 0, -1):
        active = i == r
        b_r = int(base[r])
        lane = j - b_r
        in_band = (lane >= 0) & (lane < W)
        row = dirs[r].to(torch.int64)
        val = torch.where(row != LEFT, (lanes << 2) | row, -1)
        picked = torch.cummax(val, 1).values.gather(
            1, lane.clamp(0, W - 1)[:, None]
        )[:, 0]
        forced = ~in_band | (picked < 0)
        d = torch.where(forced, UP, picked & 3)
        jp = b_r + torch.where(forced, lane, picked >> 2)
        is_diag = active & (d == DIAG)
        is_up = active & (d == UP)
        on_row(r, active, is_diag, is_up, jp, j)
        i = i - active.to(torch.int64)
        j = torch.where(is_diag, jp - 1, torch.where(is_up, jp, j))
    return j


def rowscan_mapping_plain(reads, r_lens, drafts, d_lens, W, match,
                          mismatch, gap):
    """(B, R) int64 read->draft mapping: j for a base aligned to draft
    column j, -(a+3) for a base inserted after column a, -1 unused."""
    B, R = reads.shape
    D = drafts.shape[1]
    dirs = rowscan_dirs_plain(reads, r_lens, drafts, d_lens, W, match,
                              mismatch, gap)
    mapping = torch.full((B, R + 1), -1, dtype=torch.int64,
                         device=reads.device)
    bidx = torch.arange(B, device=reads.device)

    def on_row(r, active, is_diag, is_up, jp, j):
        val = torch.where(is_diag, jp - 1, -(jp + 2))
        mapping[bidx, torch.where(is_diag | is_up, r - 1, R)] = val

    _traceback(dirs, r_lens, d_lens, R, D, W, on_row)
    return mapping[:, :R]


def rowscan_votes_plain(reads, r_lens, drafts, d_lens, W, match, mismatch,
                        gap):
    """Plain version of the vote-plane kernel; returns ``planes``
    (B, 3D + 256) uint8 and ``stats`` (B, 2) int32 (layout in
    ``csrc/rowscan.cu``)."""
    B, R = reads.shape
    D = drafts.shape[1]
    DQ = D + 128
    dev = reads.device
    dirs = rowscan_dirs_plain(reads, r_lens, drafts, d_lens, W, match,
                              mismatch, gap)
    bidx = torch.arange(B, device=dev)
    # one dump column past each plane takes the writes that drop
    pb = torch.full((B, D + 1), 4, dtype=torch.uint8, device=dev)
    pa = torch.full((B, DQ + 1), 4, dtype=torch.uint8, device=dev)
    pa2 = torch.full((B, DQ + 1), 4, dtype=torch.uint8, device=dev)
    st = {
        "anchor": torch.full((B,), -9, dtype=torch.int64, device=dev),
        "b_a": torch.full((B,), 4, dtype=torch.int64, device=dev),
        "b_b": torch.full((B,), 4, dtype=torch.int64, device=dev),
        "jmn": torch.full((B,), 1 << 29, dtype=torch.int64, device=dev),
        "jmx": torch.full((B,), -1, dtype=torch.int64, device=dev),
    }

    def flush(cond):
        q = st["anchor"] + 1
        at = torch.where(cond & (q >= 0) & (q < DQ), q, DQ)
        pa[bidx, at] = st["b_a"].to(torch.uint8)
        pa2[bidx, at] = st["b_b"].to(torch.uint8)

    def on_row(r, active, is_diag, is_up, jp, j):
        rb = reads[:, r - 1].to(torch.int64) & 3
        c = jp - 1
        pb[bidx, torch.where(is_diag & (c >= 0) & (c < D), c, D)] = \
            rb.to(torch.uint8)
        st["jmn"] = torch.where(is_diag, torch.minimum(st["jmn"], c),
                                st["jmn"])
        st["jmx"] = torch.where(is_diag, torch.maximum(st["jmx"], c),
                                st["jmx"])
        anchor = st["anchor"]
        same_run = is_up & (anchor == c)
        ended = active & (anchor >= -1) & ~same_run
        flush(ended)
        b_a, b_b = st["b_a"], st["b_b"]
        st["b_b"] = torch.where(same_run, b_a, torch.where(is_up, 4, b_b))
        st["b_a"] = torch.where(is_up, rb, torch.where(ended, 4, b_a))
        st["anchor"] = torch.where(
            is_up, c, torch.where(ended, -9, anchor)
        )

    _traceback(dirs, r_lens, d_lens, R, D, W, on_row)
    flush(st["anchor"] >= -1)
    planes = torch.cat([pb[:, :D], pa[:, :DQ], pa2[:, :DQ]], 1)
    stats = torch.stack([st["jmn"], st["jmx"]], 1).to(torch.int32)
    return planes, stats


def rowscan_cigar_plain(reads, r_lens, drafts, d_lens, W, match, mismatch,
                        gap, maxr):
    """Plain version of the CIGAR-run kernel; returns ``runs`` (B, maxr)
    int32 (``(len - 1) << 2 | op``, traceback order, zero past the last
    emitted slot) and ``n_runs`` (B,) int32, the true run count."""
    B, R = reads.shape
    D = drafts.shape[1]
    dev = reads.device
    dirs = rowscan_dirs_plain(reads, r_lens, drafts, d_lens, W, match,
                              mismatch, gap)
    bidx = torch.arange(B, device=dev)
    runs = torch.zeros((B, maxr + 1), dtype=torch.int64, device=dev)
    st = {
        "n": torch.zeros(B, dtype=torch.int64, device=dev),
        "op": torch.full((B,), -1, dtype=torch.int64, device=dev),
        "len": torch.zeros(B, dtype=torch.int64, device=dev),
    }

    def emit(cond, op, length):
        n = st["n"]
        runs[bidx, torch.where(cond & (n < maxr), n, maxr)] = \
            ((length - 1) << 2) | op
        st["n"] = n + cond.to(torch.int64)

    def on_row(r, active, is_diag, is_up, jp, j):
        len_d = j - jp
        emit_d = active & (len_d > 0)
        emit(emit_d & (st["len"] > 0), st["op"], st["len"])
        emit(emit_d, LEFT, len_d)
        cur_len = torch.where(emit_d, 0, st["len"])
        act_op = torch.where(is_diag, DIAG, UP)
        open_run = active & (cur_len > 0)
        emit(open_run & (st["op"] != act_op), st["op"], cur_len)
        same = open_run & (st["op"] == act_op)
        st["len"] = torch.where(
            active, torch.where(same, cur_len + 1, 1), cur_len
        )
        st["op"] = torch.where(active, act_op, st["op"])

    j = _traceback(dirs, r_lens, d_lens, R, D, W, on_row)
    emit(st["len"] > 0, st["op"], st["len"])
    emit(j > 0, LEFT, j)
    return runs[:, :maxr].to(torch.int32), st["n"].to(torch.int32)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def band_table(R: int, D: int, W: int,
               rows: int | None = None) -> np.ndarray:
    """What the row-scan kernels read of the band, one int32 array:
    :func:`row_bases` (R + 1 entries), then R // 32 + 1 words of step
    bits, bit ``i & 31`` of word ``i >> 5`` set where the band moves a
    column between rows ``i - 1`` and ``i``.  With ``rows`` >= R the
    table is laid out for reads stored ``rows`` codes wide: the band of
    (R, D, W) standing still over the rows past R."""
    rows = R if rows is None else rows
    base = np.zeros(rows + 1, np.int32)
    base[: R + 1] = row_bases(R, D, W)
    base[R + 1 :] = base[R]
    bits = np.zeros((rows // 32 + 1) * 32, np.uint32)
    bits[1 : rows + 1] = np.diff(base)
    words = (bits.reshape(-1, 32) << np.arange(32, dtype=np.uint32)).sum(
        1, dtype=np.uint32)
    return np.concatenate([base, words.view(np.int32)])


@functools.lru_cache(maxsize=None)
def _base_tensor(R, D, W, rows, device):
    return torch.from_numpy(band_table(R, D, W, rows)).to(device)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_cuda_args(reads, r_lens, drafts, d_lens, W):
    B = reads.shape[0]
    for name, t, dtype, shape in (
        ("reads", reads, torch.uint8, (B, reads.shape[1])),
        ("r_lens", r_lens, torch.int32, (B,)),
        ("drafts", drafts, torch.uint8, (B, drafts.shape[1])),
        ("d_lens", d_lens, torch.int32, (B,)),
    ):
        if t.device != reads.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want a contiguous {dtype} tensor of shape {shape}"
                f" on {reads.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}"
            )
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: the kernels read 32-bit words; the "
                             "tensor's storage must be 4-byte aligned")
    if not (32 <= W <= 512 and W % 32 == 0):
        raise ValueError(f"the CUDA NW kernels take W in 32..512, "
                         f"a multiple of 32 (got {W})")


def launch_chunked(name, launches, reads, r_lens, drafts, d_lens, W, base,
                   per_read, outs, extra):
    """Launch kernel ``hx_{name}`` over the batch in chunks whose
    direction scratch (``per_read`` bytes a read) fits
    :data:`DIRS_BUDGET`, counting each launch
    in ``launches[name]``; ``base`` is the band's lane-0 column table on
    the device, ``outs`` (tensor, bytes per read) output pairs, ``extra``
    trailing int arguments."""
    from haslr_tpu_torch.kernels import _build

    B, R = reads.shape
    D = drafts.shape[1]
    chunk = max(1, min(B, DIRS_BUDGET["cuda"] // per_read))
    dirs = torch.empty(chunk * per_read, dtype=torch.uint8,
                       device=reads.device)
    fn = _build.lib()[f"hx_{name}"]
    stream = torch.cuda.current_stream(reads.device)
    for lo in range(0, B, chunk):
        n = min(chunk, B - lo)
        if LAUNCH_LOG is not None:
            t0 = torch.cuda.Event(enable_timing=True)
            t0.record(stream)
        err = fn(
            reads.data_ptr() + lo * R, r_lens.data_ptr() + 4 * lo,
            drafts.data_ptr() + lo * D, d_lens.data_ptr() + 4 * lo,
            base.data_ptr(), dirs.data_ptr(),
            *(t.data_ptr() + lo * nbytes for t, nbytes in outs),
            n, R, D, W, *extra, stream.cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err}")
        launches[name] += 1
        if LAUNCH_LOG is not None:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record(stream)
            LAUNCH_LOG.append((name, n, R, W, t0, t1))


def packed_bytes(R: int, lanes: int) -> int:
    """Bytes of one read's packed directions: (R + 1) rows of lanes / 4."""
    return (R + 1) * (lanes // 4)


def _route(W, B, n_sm):
    """How the row-scan kernels run a launch of ``B`` reads at band ``W``
    on a card of ``n_sm`` SMs: ``(C, wpr, reads_per_block)``, computing
    32 * C * wpr >= W lanes.  One warp a read (four at 512 lanes below
    :data:`SMALL_LAUNCH` reads) and as many reads a block as spread the
    launch over every SM (a power of two up to
    :data:`MAX_READS_PER_BLOCK`).  Raises on a band no route takes."""
    if not (32 <= W <= 512 and W % 32 == 0):
        raise ValueError(f"the CUDA NW kernels take W in 32..512, "
                         f"a multiple of 32 (got {W})")
    lanes = min(n for n in ROUTES if n >= W)
    C, wpr = ROUTES[lanes][-1 if B < SMALL_LAUNCH else 0]
    rpb = 1
    while wpr == 1 and rpb < MAX_READS_PER_BLOCK and rpb * n_sm < B:
        rpb *= 2
    return C, wpr, rpb


def _word_rows(reads, r_lens, drafts):
    """The batch as the kernels read it, code rows a multiple of four
    wide: ``(reads, r_lens, drafts)``, the very tensors where R and D are
    such multiples.  Else the rows are padded with code 4, and a read
    longer than R (which no row of the walk reaches) stays longer than
    the padded row."""
    R, D = reads.shape[1], drafts.shape[1]
    Rk, Dk = -(-R // 4) * 4, -(-D // 4) * 4
    if Rk != R:
        reads = torch.nn.functional.pad(reads, (0, Rk - R), value=4)
        r_lens = torch.where(r_lens > R, Rk + 1, r_lens).to(torch.int32)
    if Dk != D:
        drafts = torch.nn.functional.pad(drafts, (0, Dk - D), value=4)
    return reads, r_lens, drafts


def _launch(name, reads, r_lens, drafts, d_lens, R, D, W, outs, extra):
    """Launch ``hx_{name}`` on a :func:`_word_rows` batch of band
    (R, D, W)."""
    B, Rk = reads.shape
    C, wpr, rpb = _route(W, B, _sm_count(reads.device))
    launch_chunked(name, LAUNCHES, reads, r_lens, drafts, d_lens, W,
                   _base_tensor(R, D, W, Rk, reads.device),
                   packed_bytes(Rk, 32 * C * wpr), outs,
                   (*extra, C, wpr, rpb))


def pack_dirs_row(row: np.ndarray) -> np.ndarray:
    """One direction row (W,) of values 0..2 as the kernels store it: two
    bits a lane, 16 lanes a uint32 word, lane k in bits 2(k % 16) and
    2(k % 16) + 1 of word k // 16."""
    r = np.asarray(row, np.uint32).reshape(-1, 16)
    return (r << (2 * np.arange(16, dtype=np.uint32))).sum(
        1, dtype=np.uint32)


def resolve_packed(words: np.ndarray, lane: int):
    """The kernels' traceback step on a packed row: the nearest non-LEFT
    cell at or left of ``lane`` as ``(direction, lane)``, or ``None`` when
    there is none (or ``lane`` is out of the band): per word a mask of the
    cells whose high code bit is clear, cut at ``lane``, and a
    leading-zero count."""
    n_words = len(words)
    if not 0 <= lane < 16 * n_words:
        return None
    for q in range(lane >> 4, -1, -1):  # the kernel: one ballot + clz
        m = ~int(words[q]) & 0xAAAAAAAA
        if q == lane >> 4:
            m &= 0xFFFFFFFF >> (30 - 2 * (lane & 15))
        if m:
            cell = (m.bit_length() - 1) >> 1  # 31 - clz(m), halved
            return (int(words[q]) >> (2 * cell)) & 1, 16 * q + cell
    return None


def takes_plain(reads, r_lens, drafts, d_lens, W) -> bool:
    """Shared wrapper front: True for CPU tensors (take the plain
    version); CUDA tensors are validated for the kernel, any other device
    raises."""
    if reads.device.type == "cpu":
        return True
    if reads.device.type != "cuda":
        raise ValueError(f"unsupported device {reads.device}")
    _check_cuda_args(reads, r_lens, drafts, d_lens, W)
    return False


def _on_cpu(reads, r_lens, drafts, d_lens, W) -> bool:
    _check_shape(reads.shape[1], drafts.shape[1], W)
    return takes_plain(reads, r_lens, drafts, d_lens, W)


def chunked_plain(reads, r_lens, drafts, d_lens, W, plain, plain_args,
                  per_read):
    """``plain`` over the batch in chunks whose directions
    (``per_read`` bytes a read) fit :data:`DIRS_BUDGET`; its output
    tuples concatenated along the batch."""
    B = reads.shape[0]
    chunk = max(1, DIRS_BUDGET["cpu"] // per_read)
    parts = [
        plain(reads[lo : lo + chunk], r_lens[lo : lo + chunk],
              drafts[lo : lo + chunk], d_lens[lo : lo + chunk], W,
              *plain_args)
        for lo in range(0, max(B, 1), chunk)
    ]
    return tuple(torch.cat(p, 0) for p in zip(*parts))


def rowscan_votes(reads, r_lens, drafts, d_lens, W, match, mismatch, gap):
    """Row-scan DP + vote-plane traceback: ``planes`` (B, 3D + 256) uint8
    and ``stats`` (B, 2) int32 (min / max aligned draft column).

    CPU tensors: :func:`rowscan_votes_plain`.  CUDA tensors (uint8 codes,
    int32 lengths, contiguous): the ``hx_rowscan_votes`` kernel, by
    :func:`_route`."""
    if _on_cpu(reads, r_lens, drafts, d_lens, W):
        return chunked_plain(reads, r_lens, drafts, d_lens, W,
                             rowscan_votes_plain, (match, mismatch, gap),
                             (reads.shape[1] + 1) * W)
    B, R = reads.shape
    D = drafts.shape[1]
    reads, r_lens, drafts = _word_rows(reads, r_lens, drafts)
    Dk = drafts.shape[1]
    planes = torch.full((B, 3 * Dk + 256), 4, dtype=torch.uint8,
                        device=reads.device)
    stats = torch.empty((B, 2), dtype=torch.int32, device=reads.device)
    _launch("rowscan_votes", reads, r_lens, drafts, d_lens, R, D, W,
            ((planes, 3 * Dk + 256), (stats, 8)), (match, mismatch, gap))
    if Dk != D:  # the three planes of a D-wide draft out of the Dk-wide
        planes = torch.cat([planes[:, :D], planes[:, Dk : Dk + D + 128],
                            planes[:, 2 * Dk + 128 : 2 * Dk + D + 256]], 1)
    return planes, stats


def rowscan_cigar(reads, r_lens, drafts, d_lens, W, match, mismatch, gap,
                  maxr):
    """Row-scan DP + CIGAR-run traceback: ``runs`` (B, maxr) int32 and
    ``n_runs`` (B,) int32 (> maxr: overflow, the caller realigns).

    CPU tensors: :func:`rowscan_cigar_plain`.  CUDA tensors: the
    ``hx_rowscan_cigar`` kernel, by :func:`_route`."""
    if _on_cpu(reads, r_lens, drafts, d_lens, W):
        return chunked_plain(reads, r_lens, drafts, d_lens, W,
                             rowscan_cigar_plain,
                             (match, mismatch, gap, maxr),
                             (reads.shape[1] + 1) * W)
    B, R = reads.shape
    D = drafts.shape[1]
    runs = torch.zeros((B, maxr), dtype=torch.int32, device=reads.device)
    n_runs = torch.empty(B, dtype=torch.int32, device=reads.device)
    _launch("rowscan_cigar", *_word_rows(reads, r_lens, drafts), d_lens,
            R, D, W, ((runs, 4 * maxr), (n_runs, 4)),
            (match, mismatch, gap, maxr))
    return runs, n_runs


def rowscan_mapping(reads, r_lens, drafts, d_lens, W, match, mismatch, gap):
    """Row-scan DP + mapping traceback: (B, R) int32 read->draft mapping
    (encoding of :func:`rowscan_mapping_plain`).

    CPU tensors: :func:`rowscan_mapping_plain`.  CUDA tensors: the
    ``hx_rowscan_mapping`` kernel, by :func:`_route`."""
    if _on_cpu(reads, r_lens, drafts, d_lens, W):
        (mapping,) = chunked_plain(
            reads, r_lens, drafts, d_lens, W,
            lambda *a: (rowscan_mapping_plain(*a).to(torch.int32),),
            (match, mismatch, gap), (reads.shape[1] + 1) * W,
        )
        return mapping
    B, R = reads.shape
    D = drafts.shape[1]
    reads, r_lens, drafts = _word_rows(reads, r_lens, drafts)
    Rk = reads.shape[1]
    mapping = torch.full((B, Rk), -1, dtype=torch.int32, device=reads.device)
    _launch("rowscan_mapping", reads, r_lens, drafts, d_lens, R, D, W,
            ((mapping, 4 * Rk),), (match, mismatch, gap))
    return mapping if Rk == R else mapping[:, :R].contiguous()


def cigar_runs_device_raw(reads, r_lens, drafts, d_lens, W=128, match=2,
                          mismatch=-4, gap=-2, maxr=None, device=None):
    """Align host (numpy) batches on ``device`` (the card unless the
    caller says ``"cpu"``) and emit CIGAR runs;
    returns DEVICE tensors ``(runs (B, MAXR) int32, n_runs (B,) int32)``
    with MAXR = max(128, R // 4) by default (the reference's choice)."""
    R = reads.shape[1]
    if maxr is None:
        maxr = max(128, R // 4)
    return rowscan_cigar(*put_batch(device, reads, r_lens, drafts, d_lens),
                         W, match, mismatch, gap, maxr)


def put_batch(device, reads, r_lens, drafts, d_lens):
    """A host (numpy) batch as the wrappers take it on ``device``
    (``None``: the card): contiguous uint8 codes and int32 lengths."""
    from haslr_tpu_torch.device import resolve_device

    device = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return (put(reads, np.uint8), put(r_lens, np.int32),
            put(drafts, np.uint8), put(d_lens, np.int32))
