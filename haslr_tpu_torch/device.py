"""Torch device selection for the port.

The device is chosen once, by the caller (the CLI's ``--device``), and
passed down explicitly; no module keeps a global device."""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cuda"`` or ``"cpu"`` as a :class:`torch.device`.  Asking for
    CUDA where none is available raises: the port never falls back to
    the CPU silently."""
    dev = torch.device(name)
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
