"""Device code of the port: the banded NW kernels, row-scan
(``nw_rowscan``) and anti-diagonal wavefront (``nw_wavefront``), each CUDA
C++ in ``csrc/`` with a plain PyTorch version beside it; the engine switch
and mapping entry points (``nw``); the one window-consensus engine, dense
multi-round (``consensus_dense``, behind ``consensus.batched_consensus``)
and its round's vote tables (``vote_tables``, CUDA C++ in ``csrc/`` with
its plain version); the k-mer counters (``kmer``, ``kmer_stream``)."""
