"""Core sequence primitives: DNA codec, CIGAR algebra, intervals, I/O."""
