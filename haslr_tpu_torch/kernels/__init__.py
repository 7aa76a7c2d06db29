"""Device code of the port: the banded NW kernels, row-scan
(``nw_rowscan``) and anti-diagonal wavefront (``nw_wavefront``), each CUDA
C++ in ``csrc/`` with a plain PyTorch version beside it; the engine switch
and mapping entry points (``nw``); the dense consensus engine."""
