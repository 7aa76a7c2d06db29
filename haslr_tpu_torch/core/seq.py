"""DNA sequence primitives: 2-bit packed arrays, codes, reverse complement.

Replaces the reference's per-character C loops
(``Compressed_sequence.cpp:21-62`` pack/unpack, ``Common.cpp:186-193``
reverseComplement) with vectorized numpy transforms over ``uint8`` code
arrays.  The canonical in-memory representation throughout haslr_tpu_torch is a
numpy ``uint8`` array of 2-bit codes (A=0, C=1, G=2, T=3; anything else
mapped to A like the reference's ``_dna_tableVal`` which stores non-ACGT as
bits of 'A', ``Compressed_sequence.cpp:10-19``).  Code arrays upload directly
as device buffers; packing to 4-bases-per-byte is provided for compact
storage of large read sets.

Layout note: we pack base ``i`` into byte ``i // 4`` at bit ``(i % 4) * 2``
(little-endian within the byte) — a simpler layout than the reference's
reversed-byte order (``Compressed_sequence.cpp:46-62``); the two never need
to interoperate because indexes are our own format.
"""

from __future__ import annotations

import numpy as np

# ASCII -> 2-bit code lookup (A=0, C=1, G=2, T=3, other=0). Mirrors the
# semantics of reference _dna_tableVal (Compressed_sequence.cpp:10-19) where
# non-ACGT encode as 'A'.
_CODE_LUT = np.zeros(256, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i
    _CODE_LUT[_b + 32] = _i  # lowercase

_CHAR_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)

# complement of a 2-bit code: A<->T (0<->3), C<->G (1<->2)  == 3 - code
_COMP_LUT = np.array([3, 2, 1, 0], dtype=np.uint8)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII DNA -> uint8 code array (A=0 C=1 G=2 T=3, other->0)."""
    if isinstance(seq, str):
        seq = seq.encode()
    a = np.frombuffer(seq, dtype=np.uint8)
    return _CODE_LUT[a]


def decode(codes: np.ndarray) -> str:
    """uint8 code array -> ASCII DNA string."""
    return _CHAR_LUT[codes].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (vectorized).

    Equivalent of reference ``reverseComplement`` (Common.cpp:186-193) on the
    code domain: complement == ``3 - code``.
    """
    return (3 - codes[::-1]).astype(np.uint8)


def revcomp(seq: str) -> str:
    """Reverse complement of an ASCII DNA string."""
    return decode(revcomp_codes(encode(seq)))


def pack(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit codes, 4 bases per byte (base i -> byte i//4, bits (i%4)*2)."""
    n = len(codes)
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    c = codes.reshape(-1, 4).astype(np.uint16)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    return packed.astype(np.uint8)


def unpack(packed: np.ndarray, length: int) -> np.ndarray:
    """Unpack a packed buffer back to ``length`` 2-bit codes."""
    p = packed.astype(np.uint8)
    out = np.empty((len(p), 4), dtype=np.uint8)
    out[:, 0] = p & 3
    out[:, 1] = (p >> 2) & 3
    out[:, 2] = (p >> 4) & 3
    out[:, 3] = (p >> 6) & 3
    return out.reshape(-1)[:length]


class SeqStore:
    """Flat structure-of-arrays store for many sequences (2-bit packed).

    The device-friendly analog of the reference's ``Contig_List_t`` /
    ``Longread_List_t`` flat blocks (``Contig.hpp:14-33``,
    ``Longread.hpp:16-77``): one contiguous packed buffer plus per-sequence
    (offset, length). Random access decodes on demand; whole-store uploads
    hand XLA a single contiguous buffer.
    """

    def __init__(self):
        self._chunks: list[np.ndarray] = []
        self.lengths: list[int] = []
        self._packed: np.ndarray | None = None
        self._offsets: np.ndarray | None = None  # byte offsets into _packed

    def __len__(self) -> int:
        return len(self.lengths)

    def add(self, codes: np.ndarray) -> int:
        """Append a code array; returns its id."""
        self._chunks.append(pack(codes))
        self.lengths.append(int(len(codes)))
        self._packed = None
        return len(self.lengths) - 1

    def add_str(self, seq: str) -> int:
        return self.add(encode(seq))

    def _ensure_flat(self):
        if self._packed is None:
            sizes = np.array([len(c) for c in self._chunks], dtype=np.int64)
            self._offsets = np.concatenate([[0], np.cumsum(sizes)])
            self._packed = (
                np.concatenate(self._chunks) if self._chunks
                else np.zeros(0, dtype=np.uint8)
            )

    def get(self, i: int) -> np.ndarray:
        """Return the code array of sequence ``i``."""
        self._ensure_flat()
        beg, end = self._offsets[i], self._offsets[i + 1]
        return unpack(self._packed[beg:end], self.lengths[i])

    def get_str(self, i: int) -> str:
        return decode(self.get(i))

    @property
    def packed(self) -> np.ndarray:
        self._ensure_flat()
        return self._packed

    @property
    def offsets(self) -> np.ndarray:
        self._ensure_flat()
        return self._offsets

    @classmethod
    def from_flat(cls, packed: np.ndarray, offsets: np.ndarray,
                  lengths: np.ndarray) -> "SeqStore":
        """Rebuild a store from its flat representation (index loading)."""
        store = cls()
        store._packed = np.asarray(packed, dtype=np.uint8)
        store._offsets = np.asarray(offsets, dtype=np.int64)
        store.lengths = [int(x) for x in lengths]
        store._chunks = [
            store._packed[store._offsets[i] : store._offsets[i + 1]]
            for i in range(len(store.lengths))
        ]
        return store
