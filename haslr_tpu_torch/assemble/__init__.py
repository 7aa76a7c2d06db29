"""The core assembler with the port's consensus engine; every other step
is the port's own copy of :mod:`haslr_tpu.assemble`'s host code."""
