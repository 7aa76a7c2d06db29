"""Torch device selection for the port.

The device is chosen once, by the caller (the CLI's ``--device``), and
passed down explicitly; no module keeps a global device.  Every entry
point takes ``device=None``, which means the card: the CPU is taken only
when the caller says ``"cpu"``."""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device | None = None) -> torch.device:
    """``"cuda"`` (also for ``None``, the default of every entry point)
    or ``"cpu"`` as a :class:`torch.device`.  Asking for CUDA where none
    is available raises: the port never falls back to the CPU
    silently."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False"
            )
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (use cuda or cpu)")
    return dev
