"""Per-window vote tables of a dense consensus round: the plain PyTorch
version and the CUDA kernel wrapper.

Port of the reference's ``consensus_dense._kernel_vote_tables``: each
round, the per-read vote planes of the votes kernel (B1 or B4, (B, 3S +
256) uint8: the base plane at column 0, the first insertion plane at S,
the second at 2S + 128) and its stats (B, 2) int32 (the aligned draft
span jmin, jmax) reduce to per-window tables — base counts (N*S, 4),
coverage difference (N*(S+1) + 1,), 1st/2nd insertion counts (N*(S+1), 4)
each and voting reads (N,), all int32.  A row votes when it passed the
admission gate (``ok``) and aligned at least one base (jmax >= 0); code 4
is no vote.

:func:`vote_tables` takes :func:`vote_tables_plain` (int32 ``index_add_``
scatters) for CPU tensors and launches ``hx_vote_tables``
(``csrc/vote_tables.cu``: persistent CTAs over (window, column tile)
items, each item's rows brought into a shared-memory ring by bulk
copies, counted in packed 8-bit counters widened after every chunk of
rows, and its table rows written back by bulk stores) for CUDA tensors,
or raises; there is no fallback between the two.  The kernel reads each
window's rows as a range of the rows sorted by window, given as CSR
offsets (:func:`window_rows`, made on the host where the
dense engine packs the rows in window order).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from haslr_tpu_torch import trace

# kernel launches (plain-version calls do not count); reset and read by
# callers that must show the main path went through the kernel
LAUNCHES = {"vote_tables": 0}


def plane_offsets(S: int) -> tuple[int, int]:
    """Columns of the first and second insertion planes in a vote-plane
    row of a width-S draft (the base plane starts at 0)."""
    return S, 2 * S + 128


def window_rows(win_idx, N: int) -> np.ndarray:
    """CSR row offsets (N + 1,) int32 of rows sorted by window: the rows
    of window ``w`` are ``[out[w], out[w + 1])``.  Raises unless
    ``win_idx`` is non-decreasing and within ``[0, N)``."""
    win = np.asarray(win_idx, np.int64)
    if len(win) and (win[0] < 0 or win[-1] >= N
                     or bool((np.diff(win) < 0).any())):
        raise ValueError("window_rows needs rows sorted by window, each "
                         f"in [0, {N})")
    out = np.zeros(N + 1, np.int32)
    np.cumsum(np.bincount(win, minlength=N), out=out[1:])
    return out


def _count_table(plane, win, rows_ok, N, width):
    """(N * width, 4) int32 counts of plane codes 0-3 per (window,
    column); rows not ``rows_ok`` and unset cells (code 4) drop."""
    p = plane.to(torch.int64)
    col = torch.arange(width, device=p.device)[None, :]
    cell = (win[:, None] * width + col) * 4 + p
    dump = N * width * 4
    cell = torch.where(rows_ok[:, None] & (p < 4), cell, dump).reshape(-1)
    table = torch.zeros(dump + 1, dtype=torch.int32, device=p.device)
    table.index_add_(0, cell, torch.ones_like(cell, dtype=torch.int32))
    return table[:dump].view(N * width, 4)


def vote_tables_plain(planes, stats, win, ok, N, S):
    """The five tables of one round (module docstring) with int32
    ``index_add_``; ``win`` (B,) int64 window of each row, in any order.
    Same tables as the reference's ``_kernel_vote_tables`` /
    ``_scatter_votes``."""
    off1, off2 = plane_offsets(S)
    win = win.to(torch.int64)
    jmin = stats[:, 0].to(torch.int64)
    jmax = stats[:, 1].to(torch.int64)
    rows_ok = ok & (jmax >= 0)
    counts = _count_table(planes[:, :S], win, rows_ok, N, S)
    ins1 = _count_table(planes[:, off1 : off1 + S + 1], win, rows_ok, N,
                        S + 1)
    ins2 = _count_table(planes[:, off2 : off2 + S + 1], win, rows_ok, N,
                        S + 1)

    dev = planes.device
    size = N * (S + 1) + 1
    woff1 = win * (S + 1)

    def in_table(t):
        return torch.where(rows_ok & (t >= 0) & (t < size), t, size)

    cov = torch.zeros(size + 1, dtype=torch.int32, device=dev)
    one = torch.ones(win.shape[0], dtype=torch.int32, device=dev)
    cov.index_add_(0, in_table(woff1 + jmin), one)
    cov.index_add_(0, in_table(woff1 + jmax + 1), -one)
    n_reads = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    n_reads.index_add_(0, torch.where(rows_ok, win, N), one)
    return counts, cov[:size], ins1, ins2, n_reads[:N]


def _check_cuda_args(planes, stats, win_ptr, ok, N, S):
    # the kernel's column tiles are whole windows up to S = 512, else
    # 512 columns, and its bulk copies move multiples of 16 bytes
    if S <= 0 or S % 16 or (S > 512 and S % 512):
        raise ValueError(f"the vote-tables kernel takes S a multiple of 16, "
                         f"and of 512 above it (got S={S})")
    dev = planes.device
    B = planes.shape[0]
    if N < 1:
        raise ValueError(f"the vote-tables kernel takes N >= 1 (got {N})")
    if planes.dtype != torch.uint8 or planes.dim() != 2 \
            or planes.shape[1] != 3 * S + 256 or planes.stride(1) != 1 \
            or planes.stride(0) % 16 or planes.data_ptr() % 16:
        raise ValueError(
            f"planes: want uint8 rows of 3S+256 = {3 * S + 256} contiguous "
            "columns, row stride and storage 16-byte aligned (the bulk "
            f"copies); got {planes.dtype} {tuple(planes.shape)} strides "
            f"{planes.stride()} at {planes.data_ptr() % 16} past 16")
    for name, t, dtype, shape in (
        ("stats", stats, torch.int32, (B, 2)),
        ("ok", ok, torch.bool, (B,)),
        ("win_ptr", win_ptr, torch.int32, (N + 1,)),
    ):
        if t.device != dev or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want a contiguous {dtype} tensor of shape {shape}"
                f" on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if stats.data_ptr() % 8:
        raise ValueError("stats: the kernel reads (jmin, jmax) as one "
                         "8-byte word; the storage must be 8-byte aligned")


def vote_tables(planes, stats, win_ptr, ok, N, S):
    """The five tables of one round (module docstring), the rows sorted
    by window: window ``w``'s are ``[win_ptr[w], win_ptr[w + 1])``
    (``win_ptr`` int32 (N + 1,), :func:`window_rows` of the rows'
    windows, on the tensors' device).

    CPU tensors: :func:`vote_tables_plain` on the windows ``win_ptr``
    gives.  CUDA tensors: the ``hx_vote_tables`` kernel on the tensors'
    card and current stream, which takes the stats of the votes kernels
    (jmin <= jmax < S where jmax >= 0) and ``win_ptr[N]`` equal to B
    (not checked there: it would wait for the card)."""
    if planes.device.type == "cpu":
        sizes = win_ptr.diff()
        if win_ptr.shape != (N + 1,) or int(win_ptr[0]) != 0 \
                or int(win_ptr[-1]) != planes.shape[0] \
                or bool((sizes < 0).any()):
            raise ValueError(f"win_ptr: want the CSR row offsets of "
                             f"{planes.shape[0]} rows in {N} windows")
        win = torch.repeat_interleave(torch.arange(N), sizes.to(torch.int64))
        return vote_tables_plain(planes, stats, win, ok, N, S)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    _check_cuda_args(planes, stats, win_ptr, ok, N, S)
    from haslr_tpu_torch.kernels import _build

    dev = planes.device
    counts = torch.empty((N * S, 4), dtype=torch.int32, device=dev)
    cov = torch.empty(N * (S + 1) + 1, dtype=torch.int32, device=dev)
    ins1 = torch.empty((N * (S + 1), 4), dtype=torch.int32, device=dev)
    ins2 = torch.empty((N * (S + 1), 4), dtype=torch.int32, device=dev)
    n_reads = torch.empty(N, dtype=torch.int32, device=dev)
    off1, off2 = plane_offsets(S)
    fn = _build.lib()["hx_vote_tables"]
    stream = torch.cuda.current_stream(dev)
    with torch.cuda.device(dev), trace.launch(
            "vote_tables", planes.shape[0], windows=N, S=S, stream=stream):
        err = fn(planes.data_ptr(), ok.data_ptr(), stats.data_ptr(),
                 win_ptr.data_ptr(), counts.data_ptr(), cov.data_ptr(),
                 ins1.data_ptr(), ins2.data_ptr(), n_reads.data_ptr(), N, S,
                 planes.stride(0), off1, off2, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"vote_tables kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["vote_tables"] += 1
    return counts, cov, ins1, ins2, n_reads


def launch_plan(N, S, device=None):
    """The kernel's launch at N windows of width S on ``device`` (a CUDA
    device; the current one by default): the persistent grid, CTAs an SM,
    dynamic shared memory a CTA, threads a CTA, ring stages, the column
    tile of a work item and the rows a stage."""
    from haslr_tpu_torch.kernels import _build

    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        err = _build.lib()["hx_vote_tables_plan"](N, S,
                                                  ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"vote_tables plan failed: CUDA error {err}")
    return dict(zip(("grid", "ctas_per_sm", "smem_bytes", "threads",
                     "stages", "tile", "chunk_rows"), out))
