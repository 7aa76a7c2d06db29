"""The plain reference that decides ``correct``: NumPy and plain PyTorch
only.  It imports nothing of the program (no ``haslr_tpu_torch``), nor
JAX nor ``haslr_tpu``, and takes nothing the program made: it works
from the generator's truth (the genome, each read's template and edit
operations, each contig's placements) and reads the program's output
files only to judge them.
"""
