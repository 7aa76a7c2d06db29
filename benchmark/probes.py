"""What the traced run adds around the program, from the benchmark's own
files: a ``record_function`` span around each call into a layer, and a
count of the work each kernel launch is handed (DP cells from the reads'
lengths, V1's bytes from its round's shape), taken by wrapping the
port's Python kernel entries.  Everything is restored on exit; the
timed runs (``--trace 0``) run the program untouched."""

from __future__ import annotations

import contextlib
import functools
import importlib

from benchmark import counts


@contextlib.contextmanager
def patched(module: str, attr: str, make):
    """``module.attr`` replaced by ``make(original)`` inside the block."""
    mod = importlib.import_module(module)
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def _spanned(name):
    def make(fn):
        from torch.profiler import record_function

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapper
    return make


class Probes:
    """Spans and work counts of one traced window.  ``cells[name]``: DP
    cells handed to kernel ``name`` (``rowscan_cigar``, ``rowscan_votes``,
    ``wavefront_mapping``, ...); ``v1_bytes``: bytes V1's rounds need."""

    def __init__(self, spans):
        self.spans = list(spans)
        self._cells = {}
        self.v1_bytes = 0
        self._stack = None

    def _count_launch(self, fn):
        import torch

        @functools.wraps(fn)
        def wrapper(name, launches, reads, r_lens, drafts, d_lens, W, *a,
                    **kw):
            # counts.dp_cells on the card, read once the window has closed
            rows = reads.shape[1]
            add = r_lens.clamp(0, rows).to(torch.int64).sum() * W
            self._cells[name] = self._cells.get(name, 0) + add
            return fn(name, launches, reads, r_lens, drafts, d_lens, W, *a,
                      **kw)
        return wrapper

    def _count_v1(self, fn):
        @functools.wraps(fn)
        def wrapper(planes, stats, win_ptr, ok, N, S):
            self.v1_bytes += counts.vote_tables_bytes(planes.shape[0], N, S)
            return fn(planes, stats, win_ptr, ok, N, S)
        return wrapper

    @property
    def cells(self) -> dict:
        """The DP cells by kernel (reading them waits for the card)."""
        return {k: int(v) for k, v in self._cells.items()}

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        k = "haslr_tpu_torch.kernels."
        for mod in ("nw_rowscan", "nw_wavefront"):
            self._stack.enter_context(
                patched(k + mod, "launch_chunked", self._count_launch))
        self._stack.enter_context(
            patched(k + "consensus_dense", "vote_tables", self._count_v1))
        for module, attr, name in self.spans:
            self._stack.enter_context(patched(module, attr, _spanned(name)))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False
