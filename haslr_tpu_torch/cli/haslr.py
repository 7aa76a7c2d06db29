"""End-to-end pipeline driver on a torch device (port of
:mod:`haslr_tpu.cli.haslr`).

The same five stages, parameterised artifact names, flags and
skip-if-exists resume as the reference driver (``bin/haslr.py:18-50``);
long-read preparation, short-read assembly and overlap removal are the
port's copy of the host stages of :mod:`haslr_tpu.cli.haslr`, without
its device mesh.  The aligner's
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

from haslr_tpu_torch.config import PipelineConfig, parse_genome_size

# wall-clock per stage of the last run_pipeline call
STAGE_TIMES: dict[str, float] = {}


def _stamp(msg: str):
    import datetime

    now = datetime.datetime.now().strftime("%d-%b-%Y %H:%M:%S")
    sys.stdout.write(f"[{now}] {msg}")
    sys.stdout.flush()


def _done(skipped=False):
    sys.stdout.write("already exists\n" if skipped else "done\n")
    sys.stdout.flush()


def prepare_lrs(cfg: PipelineConfig) -> str:
    from haslr_tpu_torch.sr import fastutils

    lr_name = "lrall" if cfg.cov_lr == 0 else f"lr{cfg.cov_lr}x"
    lr_file = f"{cfg.out}/{lr_name}.fasta"
    if cfg.cov_lr == 0:
        _stamp(f"renaming long reads and storing in {lr_file}... ")
        if not os.path.isfile(lr_file):
            fastutils.format_rename(list(cfg.long), lr_file)
            _done()
        else:
            _done(skipped=True)
    else:
        _stamp(f"subsampling {cfg.cov_lr}x long reads to {lr_file}... ")
        if not os.path.isfile(lr_file):
            fastutils.subsample_longest(
                list(cfg.long), lr_file, cfg.cov_lr,
                parse_genome_size(cfg.genome),
            )
            _done()
        else:
            _done(skipped=True)
    return lr_file


def assemble_srs(cfg: PipelineConfig) -> str:
    from haslr_tpu_torch.sr.assemble_sr import assemble_short_reads

    prefix = f"{cfg.out}/sr_k{cfg.minia_kmer}_a{cfg.minia_solid}"
    sr_asm = f"{prefix}.{cfg.minia_asm}.fa"
    _stamp("assembling short reads... ")
    if not os.path.isfile(sr_asm):
        assemble_short_reads(
            list(cfg.short), sr_asm,
            kmer_size=cfg.minia_kmer,
            min_abundance=cfg.minia_solid,
            asm_type=cfg.minia_asm,
        )
        _done()
    else:
        _done(skipped=True)
    return sr_asm


def remove_short_src(cfg: PipelineConfig) -> tuple[str, str]:
    """Returns (nooverlap_fasta, length_filtered_fasta).

    Note the reference's asymmetry (bin/haslr.py:60,87): the aligner
    targets the length-filtered file but the core assembler loads the
    *unfiltered* nooverlap file — contig ids in the PAF are minia's
    sequential names, which match file order only in the unfiltered file.
    """
    from haslr_tpu_torch.sr import fastutils, nooverlap

    prefix = f"{cfg.out}/sr_k{cfg.minia_kmer}_a{cfg.minia_solid}"
    sr_asm = cfg.contig if cfg.contig else f"{prefix}.{cfg.minia_asm}.fa"
    noov = f"{prefix}.{cfg.minia_asm}.nooverlap.fa"
    _stamp("removing overlaps in short read assembly... ")
    if not os.path.isfile(noov):
        nooverlap.remove_overlaps(sr_asm, noov, cfg.minia_kmer)
        _done()
    else:
        _done(skipped=True)
    good = f"{prefix}.{cfg.minia_asm}.nooverlap.{cfg.min_src}.fa"
    _stamp("removing short sequences in short read assembly... ")
    if not os.path.isfile(good):
        fastutils.format_min_len(noov, good, cfg.min_src)
        _done()
    else:
        _done(skipped=True)
    return noov, good


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
        from haslr_tpu_torch.core.io import read_fofn

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
