"""Short-read side of the pipeline: k-mer counting + de Bruijn contigs
(replaces minia), contig overlap trimming (replaces minia_nooverlap), and
read formatting/subsampling (replaces fastutils)."""
