"""Command-line interface of the PyTorch port, mirroring the reference's
flags (src/CommandLineParser.cpp:126-309) and the JAX package's CLI.

    python -m lordfast_tpu_torch.cli --index ref.fa
    python -m lordfast_tpu_torch.cli --search ref.fa --seq reads.fq \
        [--device cuda|cpu] [options]

``--device`` (default cuda) takes the place of the JAX package's
JAX_PLATFORMS; cuda without a usable card is an error.  Flags of paths
not ported yet (--shardIndex, --numProcesses > 1, --mergeShards,
--seeder other than extend-whole, -a clasp, --profile) are refused.
"""

from __future__ import annotations

import argparse
import sys

from .config import ChainAlg, LordfastConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lordfast_tpu_torch",
        description="long-read aligner (lordFAST capabilities), PyTorch + "
                    "CUDA port",
    )
    p.add_argument("--index", "-I", metavar="REF", help="build index for REF")
    p.add_argument("--search", "-S", metavar="REF", help="map reads against REF")
    p.add_argument("--seq", "-s", metavar="READS", help="FASTA/FASTQ(.gz) reads")
    p.add_argument("--out", "-o", default="", help="output SAM (default stdout)")
    p.add_argument("--threads", "-t", type=int, default=1)
    p.add_argument("--minAnchorLen", "-k", type=int, default=14)
    p.add_argument("--maxRefHit", "-m", type=int, default=1000)
    p.add_argument("--minReadLen", "-l", type=int, default=1000)
    p.add_argument("--anchorCount", "-c", type=int, default=1000)
    p.add_argument("--numMap", "-n", type=int, default=10)
    p.add_argument("--chainAlg", "-a", default="dp-n2")
    p.add_argument("--readGroup", "-R", default="")
    p.add_argument("--noSamHeader", action="store_true")
    p.add_argument("--chainReward", "-r", type=float, default=9.3)
    p.add_argument("--chainPenalty", "-p", type=float, default=11.4)
    p.add_argument("--gapPenalty", "-g", type=float, default=0.15)
    p.add_argument("--version", "-v", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the index and the device stages "
                        "(default cuda; cuda without a GPU is an error)")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted --search run at the last "
                        "completed chunk (requires --out)")
    p.add_argument("--verbose", "-d", type=int, default=0, metavar="N",
                   help="runtime verbosity 0-3 (reference VERBOSITY builds)")
    p.add_argument("--chunkSize", type=int, default=0, metavar="BYTES",
                   help="read-chunk size (default 100 MB, the reference's "
                        "bound, src/baseFAST.cpp:59)")
    p.add_argument("--exportBwa", action="store_true",
                   help="with --index: also write the reference-"
                        "compatible .bwt/.sa/.pac/.ann/.amb/.cache file "
                        "set next to REF (index/bwa_io.py)")
    # flags of the JAX package whose paths are not ported yet: parsed so
    # that they are refused with a clear message
    p.add_argument("--profile", default="", metavar="DIR",
                   help="not ported yet")
    p.add_argument("--shardIndex", action="store_true",
                   help="not ported yet")
    p.add_argument("--numProcesses", type=int, default=1,
                   help="not ported yet (only 1)")
    p.add_argument("--processIndex", type=int, default=-1,
                   help="not ported yet")
    p.add_argument("--coordinator", default="", help="not ported yet")
    p.add_argument("--mergeShards", action="store_true",
                   help="not ported yet")
    p.add_argument("--seeder", default="extend-whole",
                   choices=["extend-whole", "extend-whole-2",
                            "extend-whole-3"],
                   help="seeder variant; only extend-whole is ported")
    return p


def unported_flags(args) -> list:
    """The flags of args that select a path the port does not have."""
    bad = []
    if args.profile:
        bad.append("--profile")
    if args.shardIndex:
        bad.append("--shardIndex")
    if args.numProcesses > 1 or args.processIndex > 0 or args.coordinator:
        bad.append("--numProcesses/--processIndex/--coordinator")
    if args.mergeShards:
        bad.append("--mergeShards")
    if args.seeder != "extend-whole":
        bad.append(f"--seeder {args.seeder}")
    if args.chainAlg == ChainAlg.CLASP:
        bad.append("-a clasp")
    return bad


def parse_read_group(rg_line: str):
    """set_read_group (src/CommandLineParser.cpp:85-124)."""
    if not rg_line.startswith("@RG"):
        raise ValueError("SAM read group line does not start with @RG")
    if "\t" in rg_line:
        raise ValueError("read group line contained literal <tab> characters")
    out = []
    i = 0
    while i < len(rg_line):
        c = rg_line[i]
        if c == "\\" and i + 1 < len(rg_line):
            nxt = rg_line[i + 1]
            out.append({"t": "\t", "n": "\n", "r": "\r", "\\": "\\"}.get(nxt, ""))
            i += 2
        else:
            out.append(c)
            i += 1
    rg = "".join(out)
    pos = rg.find("ID:")
    if pos < 0:
        raise ValueError("no ID within the read group line")
    end = pos + 3
    while end < len(rg) and rg[end] not in "\t\n":
        end += 1
    return rg, rg[pos + 3 : end]


def config_from_args(args) -> LordfastConfig:
    chain_alg = args.chainAlg
    if chain_alg not in (ChainAlg.CLASP, ChainAlg.DPN2):
        print(
            "[WARNING] unknown argument for --chainAlg. "
            "Using dynamic programming (dp-n2)!",
            file=sys.stderr,
        )
        chain_alg = ChainAlg.DPN2
    rg, rg_id = ("", "")
    if args.readGroup:
        rg, rg_id = parse_read_group(args.readGroup)
    return LordfastConfig(
        min_anchor_len=args.minAnchorLen,
        max_ref_hits=args.maxRefHit,
        min_read_len=args.minReadLen,
        sampling_count=args.anchorCount,
        max_map=args.numMap,
        chain_alg=chain_alg,
        chain_reward=args.chainReward,
        chain_penalty=args.chainPenalty,
        gap_penalty=args.gapPenalty,
        read_group=rg,
        read_group_id=rg_id,
        no_sam_header=args.noSamHeader,
        num_threads=args.threads,
        verbosity=args.verbose,
        seeder=args.seeder,
        **({"chunk_bytes": args.chunkSize} if args.chunkSize > 0 else {}),
    ).validate()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    if args.version:
        from . import __version__

        print(f"lordfast_tpu_torch {__version__}")
        return 0

    bad = unported_flags(args)
    if bad:
        print(f"[ERROR] not ported to lordfast_tpu_torch yet: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 1

    if bool(args.index) == bool(args.search):
        print("[ERROR] indexing / searching mode should be selected",
              file=sys.stderr)
        return 1

    cfg = config_from_args(args)

    if args.index:
        from .index.builder import build_index, index_path_for, save_index

        idx = build_index(args.index, cfg)
        save_index(idx, index_path_for(args.index))
        if args.exportBwa:
            from .index.bwa_io import save_bwa_index

            save_bwa_index(idx, args.index)
            print(f"[NOTE] wrote reference-compatible index files next to "
                  f"{args.index}", file=sys.stderr)
        return 0

    if not args.seq:
        print("[ERROR] please indicate a sequence file for searching",
              file=sys.stderr)
        return 1

    from .pipeline.engine import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1

    from .index.builder import (build_index, index_path_for, load_index,
                                save_index)
    from .pipeline.engine import MappingEngine

    ipath = index_path_for(args.search)
    try:
        idx = load_index(ipath)
    except FileNotFoundError:
        # fall back to a reference-built on-disk index (bwa files) before
        # rebuilding — mirrors bwt_load's reuse (src/BWT.cpp:189-242)
        from .index.bwa_io import bwa_files_present, load_bwa_index

        if bwa_files_present(args.search):
            print(f"[NOTE] loading reference-format index files for "
                  f"{args.search}", file=sys.stderr)
            idx = load_bwa_index(args.search, cfg)
        else:
            print(f"[WARNING] could not locate index file: {ipath}; "
                  f"building", file=sys.stderr)
            idx = build_index(args.search, cfg)
            save_index(idx, ipath)

    engine = MappingEngine(idx, cfg, device=device)
    cmdline = "lordfast-tpu " + " ".join(argv)
    from .utils.checkpoint import ChunkProgress

    progress = None
    mode = "w"
    out_path = args.out
    if args.out and args.resume:
        progress = ChunkProgress(out_path, str(args.seq),
                                 chunk_bytes=cfg.chunk_bytes)
        if progress.load() >= 0:
            mode = "a"
            # a crash mid-chunk leaves partially flushed records for the
            # unfinished chunk; truncate back to the last durable offset
            # so the resumed chunk is not duplicated after a torn line
            try:
                import os

                if os.path.getsize(out_path) > progress.out_offset:
                    with open(out_path, "r+") as f:
                        f.truncate(progress.out_offset)
            except OSError:
                pass
            print(
                f"[NOTE] resuming after chunk {progress.last_done}",
                file=sys.stderr,
            )
    elif args.resume:
        print("[WARNING] --resume requires --out; ignoring", file=sys.stderr)
    if args.out and progress is None:
        progress = ChunkProgress(out_path, str(args.seq),
                                 chunk_bytes=cfg.chunk_bytes)

    if args.out:
        # buffered SAM writes, reference's opt_outputBufferSize
        # (2 MB default; src/CommandLineParser.cpp:40,
        # src/LordFAST.cpp:451-458)
        with open(out_path, mode,
                  buffering=max(cfg.output_buffer_size, 2)) as out:
            engine.map_file(args.seq, out, cmdline, progress=progress)
    else:
        engine.map_file(args.seq, sys.stdout, cmdline)

    if cfg.verbosity >= 1:
        print("[metrics] " + engine.metrics.to_json(), file=sys.stderr)
    # cumulative across resumed runs (persisted in the progress sidecar)
    n_reads = engine.stats["reads"]
    n_mapped = engine.stats["mapped"]
    if progress is not None:
        n_reads = max(n_reads, progress.total_reads)
        n_mapped = max(n_mapped, progress.total_mapped)
    print(
        f"[NOTE] processed {n_reads} reads ({n_mapped} mapped)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
