"""CIGAR algebra on op-level arrays.

The reference walks CIGARs character-by-character over fully expanded strings
(``Common.cpp:108-150`` expand/collapse, ``Longread.cpp:375-420``
``find_contig_pos``, ``Assemble.cpp:129-155`` ``asm_find_lr_pos``).  Here a
CIGAR is a pair of numpy arrays ``(ops, lens)`` with ``ops`` in {M=0, I=1,
D=2}; the walks become cumulative-sum + searchsorted computations — O(#ops)
instead of O(#bases) — while reproducing the reference's exact positional
semantics (verified against character-level walks in tests/test_cigar.py).

Orientation conventions: query = long read, target = contig, matching
minimap2 PAF ``cg:Z`` tags. M consumes both; I consumes query only; D
consumes target only.
"""

from __future__ import annotations

import re

import numpy as np

M, I, D = 0, 1, 2
_OP_CODE = {"M": M, "I": I, "D": D}
_OP_CHAR = np.frombuffer(b"MID", dtype=np.uint8)
_CIGAR_RE = re.compile(r"(\d+)([MID])")


def parse(cigar: str) -> tuple[np.ndarray, np.ndarray]:
    """CIGAR string -> (ops, lens) arrays."""
    ops, lens = [], []
    for n, op in _CIGAR_RE.findall(cigar):
        ops.append(_OP_CODE[op])
        lens.append(int(n))
    return np.array(ops, dtype=np.uint8), np.array(lens, dtype=np.int64)


_OP_CHARS = np.array(["M", "I", "D"])


def to_string(ops: np.ndarray, lens: np.ndarray) -> str:
    """(ops, lens) -> CIGAR string (adjacent equal ops merged)."""
    ops, lens = normalize(ops, lens)
    # batch str conversion: ~2x faster than per-op f-strings on the
    # multi-thousand-op CIGARs of long reads (PAF emit is a measured
    # host hot spot)
    chars = _OP_CHARS[ops]
    return "".join(
        s
        for pair in zip(map(str, lens.tolist()), chars.tolist())
        for s in pair
    )


def normalize(ops: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Drop zero-length ops and merge adjacent runs of the same op."""
    keep = lens > 0
    ops, lens = ops[keep], lens[keep]
    if len(ops) == 0:
        return ops, lens
    boundary = np.concatenate([[True], ops[1:] != ops[:-1]])
    group = np.cumsum(boundary) - 1
    out_ops = ops[boundary]
    out_lens = np.zeros(len(out_ops), dtype=np.int64)
    np.add.at(out_lens, group, lens)
    return out_ops, out_lens


def expand(ops: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Expanded per-column op array (one entry per CIGAR character)."""
    return np.repeat(ops, lens)


def query_len(ops: np.ndarray, lens: np.ndarray) -> int:
    return int(lens[ops != D].sum())


def target_len(ops: np.ndarray, lens: np.ndarray) -> int:
    return int(lens[ops != I].sum())


def n_columns(ops: np.ndarray, lens: np.ndarray) -> int:
    return int(lens.sum())


def n_matches(ops: np.ndarray, lens: np.ndarray) -> int:
    """Matched-column count (reference count_matches_expanded_cigar,
    Longread.cpp:422-428)."""
    return int(lens[ops == M].sum())


def reverse(ops: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Column-order reversal (reference ``reverse(cigar_exp)``)."""
    return ops[::-1].copy(), lens[::-1].copy()


def _minimal_prefix(consuming_lens: np.ndarray, delta: int) -> tuple[int, int]:
    """Find the minimal char-prefix consuming exactly ``delta`` units.

    ``consuming_lens[j]`` is how many units op ``j`` consumes on the tracked
    coordinate.  Returns ``(j, within)``: the break sits after consuming
    ``within`` chars of op ``j`` (``within`` may equal ``lens[j]``); if
    ``delta`` exceeds the total, returns ``(len, 0)``.
    """
    cum = np.cumsum(consuming_lens)
    j = int(np.searchsorted(cum, delta, side="left"))
    if j >= len(consuming_lens):
        return len(consuming_lens), 0
    prev = int(cum[j - 1]) if j > 0 else 0
    return j, delta - prev


def truncate_at_query(
    ops: np.ndarray,
    lens: np.ndarray,
    q_start: int,
    t_start: int,
    q_step: int,
    t_step: int,
    q_pos: int,
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Truncate a CIGAR at query position ``q_pos``, ending on a match.

    Op-level equivalent of reference ``find_contig_pos``
    (``Longread.cpp:375-420``): walk columns until the query coordinate
    reaches ``q_pos`` (checked before consuming each column), then roll back
    so the kept CIGAR ends on an M column; coordinates advance by
    ``q_step``/``t_step`` per consumed column.

    Returns ``(kept_ops, kept_lens, res_q, res_t)`` where ``res_q``/``res_t``
    are the query/target coordinates of the last kept (M) column — the values
    the reference leaves in ``lr_curr``/``c_curr``.
    """
    delta_q = (q_pos - q_start) * q_step
    qlens = np.where(ops != D, lens, 0)
    if delta_q < 0:
        delta_q = int(qlens.sum()) + 1  # walk everything, like the reference
    j, within = _minimal_prefix(qlens, delta_q)

    # Character index i_break sits after `within` chars of op j. The column
    # AT i_break (first unconsumed) is op j if within < lens[j], else op j+1.
    # Reference keeps columns 0..i_final where i_final is the last M column
    # at-or-before i_break (Longread.cpp:398-415).
    if j < len(ops) and within < lens[j]:
        at_op, at_off = j, within  # column i_break belongs to op j
    else:
        at_op, at_off = j + (1 if j < len(ops) else 0), 0
        if at_op >= len(ops):
            at_op, at_off = -1, 0  # i_break == end of cigar

    kept_ops: np.ndarray
    kept_lens: np.ndarray
    if at_op != -1 and ops[at_op] == M:
        # the column at i_break is a match: keep it too
        kept_ops = ops[: at_op + 1].copy()
        kept_lens = lens[: at_op + 1].copy()
        kept_lens[-1] = at_off + 1
    else:
        # scan backwards for the last M column strictly before i_break
        if at_op == -1:
            hi_op, hi_off = len(ops) - 1, int(lens[-1]) - 1
        elif at_off > 0:
            hi_op, hi_off = at_op, at_off - 1
        else:
            hi_op, hi_off = at_op - 1, int(lens[at_op - 1]) - 1
        # last M op at index <= hi_op
        m_idx = np.nonzero(ops[: hi_op + 1] == M)[0]
        if len(m_idx) == 0:
            # degenerate: no match column before the cut; keep nothing
            return (np.zeros(0, np.uint8), np.zeros(0, np.int64), q_start, t_start)
        k = int(m_idx[-1])
        kept_ops = ops[: k + 1].copy()
        kept_lens = lens[: k + 1].copy()
        if k == hi_op:
            kept_lens[-1] = hi_off + 1
    kept_ops, kept_lens = normalize(kept_ops, kept_lens)
    qc = query_len(kept_ops, kept_lens)
    tc = target_len(kept_ops, kept_lens)
    res_q = q_start + q_step * (qc - 1)
    res_t = t_start + t_step * (tc - 1)
    return kept_ops, kept_lens, res_q, res_t


def project_target_to_query(
    ops: np.ndarray,
    lens: np.ndarray,
    q_start: int,
    t_start: int,
    q_step: int,
    t_step: int,
    t_pos: int,
) -> int | None:
    """Project a target (contig) coordinate onto the query (long read).

    Op-level equivalent of reference ``asm_find_lr_pos``
    (``Assemble.cpp:129-155``): walk columns until the target coordinate
    reaches ``t_pos`` (checked before consuming each column) and return the
    query coordinate there.  Returns ``None`` when ``t_pos`` lies behind the
    walk direction (reference returns -1); if the walk exhausts the CIGAR
    without reaching ``t_pos`` the final query coordinate is returned, exactly
    like the reference's fall-through.
    """
    if (t_step > 0 and t_start > t_pos) or (t_step < 0 and t_start < t_pos):
        return None
    delta_t = (t_pos - t_start) * t_step
    tlens = np.where(ops != I, lens, 0)
    j, within = _minimal_prefix(tlens, delta_t)
    qlens = np.where(ops != D, lens, 0)
    if j >= len(ops):
        qc = int(qlens.sum())
    else:
        qc = int(qlens[:j].sum())
        if ops[j] != D:  # M consumes query along with target; D does not
            qc += within
    return q_start + q_step * qc
