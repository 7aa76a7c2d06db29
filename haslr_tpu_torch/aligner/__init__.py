"""Long-read -> SR-contig aligner with the extension on a torch device.

Presets, index, seeding, chaining and PAF emission are the port's own
copy of :mod:`haslr_tpu.aligner`'s."""
