"""Several devices and several processes (port of :mod:`haslr_tpu.dist`).

Inside one process the device stages shard over a ``dp`` mesh
(:mod:`haslr_tpu_torch.dist.mesh`): the extension splits its rows, the
consensus rounds split their reads and sum their vote tables on the
mesh's first device each round, so every output equals the
single-device run's.  Across processes only the long-read stream is
split: call :func:`initialize` once per process, map with
``map_reads(..., host_shard=host_shard())``, and hand the PAF shards to
the assembler through ``--mapping-fofn``.  No tensor crosses processes,
so the process group is gloo's on every device.
"""

from __future__ import annotations

import datetime
import os


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout_s: int | None = None) -> None:
    """Join the process group (``torch.distributed``, backend gloo).

    ``coordinator_address`` is ``host:port`` (or any ``init_method``
    URL) of rank 0's store.  With every argument ``None`` the group comes
    from torchrun's environment (``env://``) when ``RANK``,
    ``WORLD_SIZE`` and ``MASTER_ADDR`` are set, and the process stays
    single otherwise.  With explicit arguments any failure raises: a
    mistyped address must fail the run, not leave every process in a
    world of its own.  A group that is already up is kept."""
    import torch.distributed as td

    if td.is_initialized():
        return
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        if all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR")):
            td.init_process_group("gloo", init_method="env://", **kwargs)
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize: give the coordinator address, the "
                         "number of processes and this process's id "
                         "together")
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    td.init_process_group("gloo", init_method=url, world_size=num_processes,
                          rank=process_id, **kwargs)


def host_shard() -> tuple[int, int]:
    """(rank, world size): the round-robin share of the long-read stream
    this process maps; ``(0, 1)`` outside a process group."""
    import torch.distributed as td

    if td.is_available() and td.is_initialized():
        return td.get_rank(), td.get_world_size()
    return 0, 1
