"""The benchmark of haslr_tpu_torch: one stage of the assembler, driven in
whole passes over one genome's generated input, on one card.

Run one cell once from the root of a checkout::

    python3 -m benchmark.run --workload ecoli_pacbio.assemble --seed 7 \\
        --seconds 51 --trace 0

``BENCHMARK.json`` names the cells; each configuration, traffic mix,
limit set and per-layer metric is a file of its own under this folder,
found by its name.
"""
