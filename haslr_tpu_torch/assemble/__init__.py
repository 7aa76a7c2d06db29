"""The core assembler with the port's consensus engine; every other step
is :mod:`haslr_tpu.assemble`'s shared host code."""
