"""End-to-end pipeline driver on a torch device (port of
:mod:`haslr_tpu.cli.haslr`).

The same five stages, parameterised artifact names, flags and
skip-if-exists resume as the reference driver (``bin/haslr.py:18-50``);
long-read preparation, short-read assembly and overlap removal are the
shared host stages of :mod:`haslr_tpu.cli.haslr`.  The aligner's
extension and the consensus run on ``--device`` (``cuda``, the default,
or ``cpu``).  Only ``--devices 1`` is accepted for now.

Usage::

    python -m haslr_tpu_torch.cli.haslr -o OUT -g 4.6m -l LR.fa -x pacbio \\
        -s SR.fq [-t THREADS] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from haslr_tpu.cli.haslr import (
    _done,
    _stamp,
    assemble_srs,
    prepare_lrs,
    remove_short_src,
)
from haslr_tpu.config import PipelineConfig

# wall-clock per stage of the last run_pipeline call
STAGE_TIMES: dict[str, float] = {}


def _lr_name(cfg: PipelineConfig) -> str:
    return "lrall" if cfg.cov_lr == 0 else f"lr{cfg.cov_lr}x"


def align_lr_src(cfg: PipelineConfig, lr_file: str, src_file: str,
                 device) -> str:
    from haslr_tpu_torch.aligner.map import map_reads

    paf = (
        f"{cfg.out}/map_{cfg.minia_asm}_k{cfg.minia_kmer}_a{cfg.minia_solid}"
        f"_c{cfg.min_src}_{_lr_name(cfg)}.paf"
    )
    _stamp("aligning long reads to short read assembly... ")
    if not os.path.isfile(paf):
        map_reads(src_file, lr_file, paf, read_type=cfg.type,
                  threads=cfg.threads, device=device)
        _done()
    else:
        _done(skipped=True)
    return paf


def assemble_lr(cfg: PipelineConfig, lr_file: str, src_file: str,
                paf: str, device) -> str:
    from haslr_tpu_torch.assemble.pipeline import run_assembler

    asm_dir = (
        f"{cfg.out}/asm_{cfg.minia_asm}_k{cfg.minia_kmer}_a{cfg.minia_solid}"
        f"_c{cfg.min_src}_{_lr_name(cfg)}_b{cfg.aln_block}_s{cfg.edge_sup}"
        f"_sim{cfg.aln_sim}"
    )
    _stamp("assembling long reads using HASLR... ")
    if not os.path.isfile(f"{asm_dir}/asm.final.fa"):
        with open(asm_dir + ".err", "w") as err:
            run_assembler(src_file, lr_file, paf, asm_dir,
                          cfg=cfg.assemble_config(), log=err, device=device)
        _done()
    else:
        _done(skipped=True)
    return f"{asm_dir}/asm.final.fa"


def run_pipeline(cfg: PipelineConfig, device) -> str:
    """The five stages on ``device``; returns the final assembly path."""
    from haslr_tpu import native

    if cfg.devices != 1:
        raise ValueError(
            f"--devices {cfg.devices}: only one device is supported so far"
        )
    os.makedirs(cfg.out, exist_ok=True)
    sys.stdout.write(f"number of threads: {cfg.threads}\n")
    sys.stdout.write(f"output directory: {cfg.out}\n")
    STAGE_TIMES.clear()
    t = time.time()
    lr_file = prepare_lrs(cfg)
    STAGE_TIMES["prepare_lrs"] = time.time() - t
    if cfg.contig is None:
        # without the native library the SR stage would fall through to
        # the reference's device k-mer counters, which need jax
        if native.get_lib() is None:
            raise RuntimeError(
                "the native library (haslr_tpu/native, built with g++ -lz)"
                " is unavailable; the short-read stage needs it"
            )
        t = time.time()
        assemble_srs(cfg)
        STAGE_TIMES["assemble_srs"] = time.time() - t
    t = time.time()
    noov_file, good_file = remove_short_src(cfg)
    STAGE_TIMES["remove_short_src"] = time.time() - t
    t = time.time()
    paf = align_lr_src(cfg, lr_file, good_file, device)
    STAGE_TIMES["align_lr_src"] = time.time() - t
    t = time.time()
    out = assemble_lr(cfg, lr_file, noov_file, paf, device)
    STAGE_TIMES["assemble_lr"] = time.time() - t
    return out


def parse_options(argv=None) -> tuple[PipelineConfig, str]:
    """The reference driver's flags, with ``--device`` in place of
    ``--platform``; returns (config, device name)."""
    p = argparse.ArgumentParser(
        prog="haslr",
        usage=(
            "haslr [-t THREADS] -o OUT_DIR -g GENOME_SIZE -l LONG [LONG ...]"
            " -x LONG_TYPE -s SHORT [SHORT ...] [--device cuda|cpu]"
        ),
    )
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-l", "--long", nargs="+", required=True)
    p.add_argument(
        "-x", "--type", required=True,
        choices=["pacbio", "nanopore", "corrected"],
    )
    p.add_argument("-s", "--short", nargs="+")
    p.add_argument("-c", "--contig")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--cov-lr", type=int, default=25)
    p.add_argument("--aln-block", type=int, default=500)
    p.add_argument("--aln-sim", type=float, default=0.85)
    p.add_argument("--edge-sup", type=int, default=3)
    p.add_argument("--minia-kmer", type=int, default=49)
    p.add_argument("--minia-solid", type=int, default=3)
    p.add_argument("--minia-asm", default="contigs",
                   choices=["contigs", "unitigs"])
    p.add_argument("--min-src", type=int, default=250)
    p.add_argument("--short-fofn", action="store_true")
    p.add_argument("--long-fofn", action="store_true")
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="torch device for the aligner extension and consensus",
    )
    p.add_argument(
        "--devices", type=int, default=1,
        help="number of devices (only 1 is supported so far)",
    )
    a = p.parse_args(argv)
    if a.short is None and a.contig is None:
        p.error("either -s/--short or -c/--contig is required")
    longs = list(a.long)
    shorts = list(a.short or [])
    if a.long_fofn or a.short_fofn:
        from haslr_tpu.core.io import read_fofn

        if a.long_fofn:
            longs = [f for fn in longs for f in read_fofn(fn)]
        if a.short_fofn:
            shorts = [f for fn in shorts for f in read_fofn(fn)]
    for fn in longs + shorts + ([a.contig] if a.contig else []):
        if not os.path.isfile(fn):
            p.error(f"could not find file {fn}")
    cfg = PipelineConfig(
        out=os.path.abspath(a.out),
        genome=a.genome,
        long=tuple(os.path.abspath(f) for f in longs),
        type=a.type,
        short=tuple(os.path.abspath(f) for f in shorts),
        contig=os.path.abspath(a.contig) if a.contig else None,
        threads=max(1, a.threads),
        cov_lr=a.cov_lr,
        aln_block=a.aln_block,
        aln_sim=a.aln_sim,
        edge_sup=a.edge_sup,
        minia_kmer=a.minia_kmer,
        minia_solid=a.minia_solid,
        minia_asm=a.minia_asm,
        min_src=a.min_src,
        devices=a.devices,
    )
    return cfg, a.device


def main(argv=None):
    from haslr_tpu_torch.device import resolve_device

    cfg, device_name = parse_options(argv)
    out = run_pipeline(cfg, resolve_device(device_name))
    sys.stdout.write(f"final assembly: {out}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
