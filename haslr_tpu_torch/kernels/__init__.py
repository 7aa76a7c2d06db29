"""Device code of the port: the banded NW kernels, row-scan
(``nw_rowscan``) and anti-diagonal wavefront (``nw_wavefront``), each CUDA
C++ in ``csrc/`` with a plain PyTorch version beside it; the engine switch
and mapping entry points (``nw``); the dense and chunked consensus
engines (``consensus_dense``, ``consensus``, ``pileup``) and the dense
round's vote tables (``vote_tables``, CUDA C++ in ``csrc/`` with its
plain version); the k-mer counters (``kmer``, ``kmer_stream``)."""
