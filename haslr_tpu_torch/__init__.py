"""haslr_tpu_torch — the haslr hybrid assembler on PyTorch and CUDA.

A second package beside :mod:`haslr_tpu` (JAX + Pallas), which stays the
reference it is tested against.  It runs the ``haslr`` pipeline's main
path with the device work in PyTorch and hand-written CUDA kernels for
NVIDIA Hopper (``csrc/``).  It imports nothing of :mod:`haslr_tpu`: the
host code that uses no framework (``config``, ``core/``, the assembler's
graph stack, the short-read stage, the aligner's index, seeding,
chaining and emit, the C++ in ``native/``, ``testutil/``) is its own copy
of the reference's, held to it file by file in the tests.  Every entry
point runs on the card unless the caller passes ``device="cpu"``.

- ``device``            torch device selection (no global device state).
- ``config``, ``core/``, ``native/``, ``sr/``, ``testutil/``
                        the host stack (copies of the reference's).
- ``kernels/``          the banded NW kernels, row-scan and wavefront
                        (CUDA + plain PyTorch), the engine switch
                        ``kernels.nw.ENGINE`` and the dense
                        window-consensus engine.
- ``aligner/``          long-read mapping with the device extension.
- ``assemble/``         consensus-engine selection and ``run_assembler``.
- ``cli/haslr``         the five-stage pipeline driver (``--device``).
- ``trace``             spans, counters and kernel launches, recorded
                        while a ``torch.profiler`` session records or
                        inside ``trace.recording()``.

Importing this package never imports torch or jax, and never builds a
kernel: the CUDA sources are compiled with ``nvcc`` at first launch.
"""

__version__ = "0.1.0"

from haslr_tpu_torch.config import AssembleConfig, PipelineConfig  # noqa: F401
