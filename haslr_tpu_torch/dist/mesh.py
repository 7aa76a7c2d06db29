"""The ``dp`` device mesh of the port (port of :mod:`haslr_tpu.dist.mesh`).

A :class:`Mesh` is an explicit list of torch devices along one
data-parallel axis.  The device stages split their rows into contiguous
blocks, one a device (:meth:`Mesh.blocks`), launch every block before
collecting any, and merge on the mesh's first device: the extension
concatenates its rows, the consensus rounds sum their vote tables.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices along the one data-parallel axis (``dp`` in the JAX
    package, where the name drives its ``PartitionSpec``s; the port has
    none, so the axis has no name here).  A CUDA device must
    carry its index; a device may repeat (``Mesh(["cuda:0", "cuda:0"])``
    splits the rows over one card, which holds the split and the merge to
    the single-device result where there is only one)."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1 or devs[0].type not in (
                "cuda", "cpu"):
            raise ValueError(f"a mesh is all cuda or all cpu devices, got "
                             f"{[str(d) for d in devs]}")
        if any(d.type == "cuda" and d.index is None for d in devs):
            raise ValueError("a CUDA device of a mesh must carry its index "
                             "(cuda:0, not cuda)")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    def blocks(self, n_rows: int) -> list[tuple[int, int]]:
        """Contiguous ``(start, stop)`` row blocks, one a device in mesh
        order; their sizes differ by at most one, the larger first."""
        q, r = divmod(n_rows, self.size)
        out, lo = [], 0
        for i in range(self.size):
            hi = lo + q + (i < r)
            out.append((lo, hi))
            lo = hi
        return out


def make_mesh(n_devices: int | None = None,
              device: torch.device | str | None = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` cards (``cuda:0`` ...), all
    visible cards for ``None``; ``device="cpu"`` gives ``n_devices`` CPU
    shards.  Asking for more cards than are visible raises, as does a CPU
    mesh without its size: the mesh is never shrunk to what is there."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        if n_devices is None or n_devices < 1:
            raise ValueError(f"a CPU mesh needs its number of shards (got "
                             f"{n_devices})")
        return Mesh((torch.device("cpu"),) * n_devices)
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r} (use cuda or cpu)")
    n_avail = torch.cuda.device_count()
    if n_devices is None:
        n_devices = n_avail
    if n_devices < 1 or n_avail < n_devices:
        raise ValueError(
            f"requested {n_devices} devices but only {n_avail} available"
        )
    return Mesh(tuple(torch.device("cuda", i) for i in range(n_devices)))


def as_mesh(device: torch.device | str | None,
            mesh: Mesh | None) -> Mesh:
    """The mesh an entry point runs on: ``mesh`` itself, else one of
    ``device`` alone (the card unless the caller says ``"cpu"``).  A single
    device is a mesh of one, so one code path serves both.  A ``device``
    given beside a ``mesh`` must be of the mesh's kind: a ``"cpu"`` beside
    a mesh of cards raises rather than being ignored."""
    if mesh is None:
        from haslr_tpu_torch.device import resolve_device

        return Mesh((resolve_device(device),))
    if device is not None and torch.device(device).type != \
            mesh.devices[0].type:
        raise ValueError(f"device {str(device)!r} disagrees with the mesh's "
                         f"{mesh.devices[0].type} devices")
    return mesh
