"""Command-line interface of the PyTorch port, mirroring the reference's
flags (src/CommandLineParser.cpp:126-309) and the JAX package's CLI.

    python -m lordfast_tpu_torch.cli --index ref.fa
    python -m lordfast_tpu_torch.cli --search ref.fa --seq reads.fq \
        [--device cuda|cpu] [options]

``--device`` (default cuda) takes the place of the JAX package's
JAX_PLATFORMS; cuda without a usable card is an error.  ``--profile DIR``
writes a torch.profiler Chrome trace into DIR; ``--numProcesses N
--processIndex I --coordinator HOST:PORT`` map chunk shards in N
processes under a torch.distributed (gloo) group, and process 0 merges
them (parallel/multihost.py).  ``--shardIndex`` stripes the index over
the ranks of a torch.distributed group, one process per device
(parallel/sharded_index.py): run under torchrun, every rank maps and
rank 0 writes the SAM,

    torchrun --nproc_per_node N -m lordfast_tpu_torch.cli --search ref.fa \
        --seq reads.fq -o out.sam --shardIndex [--device cuda|cpu]

on NCCL for cuda and gloo for cpu; without torchrun, on a group of one.
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
    p.add_argument("--profile", default="", metavar="DIR",
                   help="write a torch.profiler Chrome trace of the "
                        "mapping run into DIR (with NVTX ranges on cuda)")
    p.add_argument("--shardIndex", action="store_true",
                   help="stripe the FM-index over the ranks of a "
                        "torch.distributed group, one process per device "
                        "(run under torchrun; rank 0 writes the SAM)")
    # ---- multi-process flags (parallel/multihost.py) ----
    p.add_argument("--numProcesses", type=int, default=1,
                   help="total mapping processes; this process maps "
                        "chunks with id %% numProcesses == processIndex "
                        "and writes <out>.part<i>")
    p.add_argument("--processIndex", type=int, default=-1,
                   help="this process's index (default: $LORDFAST_PROCESS_"
                        "INDEX or 0)")
    p.add_argument("--coordinator", default="",
                   help="host:port of the torch.distributed (gloo) "
                        "rendezvous, served by process 0; when set the "
                        "processes barrier at the end of mapping and "
                        "process 0 merges the shards")
    p.add_argument("--mergeShards", action="store_true",
                   help="merge <out>.part0..N-1 (from a --numProcesses "
                        "run) into <out> in input order and exit")
    p.add_argument("--seeder", default="extend-whole",
                   choices=["extend-whole", "extend-whole-2",
                            "extend-whole-3"],
                   help="seeder variant: the reference's active "
                        "getLocs_extend_whole_step (default, on the "
                        "device) or its two dormant in-tree variants "
                        "(src/BWT.cpp:423-591; on the host)")
    return p


# How long a rank > 0 of --shardIndex waits for rank 0's index: twice
# the ~70 min a 3.1 Gbp genome's build takes (gbp_build.py).
INDEX_WAIT_S = 2 * 3600


def _wait_for_index(ipath, ref, poll_s: float = 1.0,
                    timeout_s: float = INDEX_WAIT_S,
                    sidecar: bool = False) -> None:
    """Block until the index of ``ref`` can be loaded: its saved file
    (written whole by rank 0) or the reference-format files, and with
    ``sidecar`` a device-layout sidecar made from them
    (index/builder.py devcache_meta), which rank 0 writes after either.
    Raises TimeoutError naming the file after timeout_s seconds (a rank 0
    that failed, with ranks launched by hand)."""
    import time

    from .index.bwa_io import bwa_files_present
    from .index.builder import devcache_dir_for, devcache_meta

    t0 = time.monotonic()
    while not ((ipath.exists() or bwa_files_present(ref))
               and (not sidecar or devcache_meta(ipath) is not None)):
        if time.monotonic() - t0 >= timeout_s:
            raise TimeoutError(
                f"waited {timeout_s:g} s for rank 0's index {ipath} (or the "
                f"reference-format index of {ref})"
                + (f" and its sidecar {devcache_dir_for(ipath)}"
                   if sidecar else "")
                + "; did rank 0 fail?")
        time.sleep(min(poll_s, timeout_s))


def _write_sidecar(idx, ipath, sources):
    """Write idx's device-layout sidecar (index/builder.py
    save_device_cache), stamped with the files idx was loaded from,
    beside ipath: into a directory of another name, renamed into place
    once whole, so a waiting rank never maps a part of it; a stale
    sidecar is replaced."""
    import os
    import shutil

    from .index.builder import (devcache_dir_for, remove_device_cache,
                                save_device_cache)

    tmp = ipath.with_name(f"{ipath.name}.{os.getpid()}.tmp")
    shutil.rmtree(devcache_dir_for(tmp), ignore_errors=True)
    part = save_device_cache(idx, tmp, sources)
    remove_device_cache(ipath)
    os.rename(part, devcache_dir_for(ipath))


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

    if args.shardIndex and args.numProcesses > 1:
        print("[ERROR] --shardIndex cannot be combined with --numProcesses "
              "> 1: each process maps chunks of its own, while the sharded "
              "index needs every rank in the same device-stage calls; run "
              "--shardIndex under torchrun instead", file=sys.stderr)
        return 1

    if args.mergeShards:
        if not args.out or args.numProcesses < 1:
            print("[ERROR] --mergeShards requires --out and --numProcesses",
                  file=sys.stderr)
            return 1
        from .parallel.multihost import merge_shards

        n = merge_shards(args.out, args.numProcesses)
        print(f"[NOTE] merged {n} chunks from {args.numProcesses} shards "
              f"into {args.out}", file=sys.stderr)
        return 0

    if bool(args.index) == bool(args.search):
        print("[ERROR] indexing / searching mode should be selected",
              file=sys.stderr)
        return 1

    cfg = config_from_args(args)

    if args.index:
        from .index.builder import (build_index, index_path_for,
                                    remove_device_cache, save_index)

        idx = build_index(args.index, cfg)
        # a sidecar of the index being replaced is stale
        remove_device_cache(index_path_for(args.index))
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
                                remove_device_cache, save_index)
    from .pipeline.engine import MappingEngine

    import os as _os
    from pathlib import Path

    ipath = index_path_for(args.search)
    # one index copy a host: under --shardIndex every rank memory-maps the
    # device-layout sidecar (index/builder.py save_device_cache), which
    # rank 0 alone writes where there is none made from the index files
    # as they stand, so the ranks map one set of files.  The host seeders
    # read occ_cp, which the sidecar leaves out (fm_blocks holds it), so
    # they load the index file as before.
    sidecar = args.shardIndex and cfg.seeder == "extend-whole"
    rank_env = int(_os.environ.get("RANK", "0"))
    if args.shardIndex and rank_env != 0:
        # rank 0 builds a missing index (and its sidecar) before any rank
        # joins the group, so no rank waits out the build (up to an hour
        # at Gbp scale) in a collective; under torchrun a rank 0 that
        # fails ends the rest
        _wait_for_index(ipath, args.search, sidecar=sidecar)
    sources = [ipath]
    try:
        idx = load_index(ipath, mmap=sidecar)
    except FileNotFoundError:
        # fall back to a reference-built on-disk index (bwa files) before
        # rebuilding — mirrors bwt_load's reuse (src/BWT.cpp:189-242)
        from .index.bwa_io import bwa_files_present, load_bwa_index

        if bwa_files_present(args.search):
            print(f"[NOTE] loading reference-format index files for "
                  f"{args.search}", file=sys.stderr)
            idx = load_bwa_index(args.search, cfg)
            sources = [Path(f"{args.search}{ext}") for ext in
                       (".bwt", ".sa", ".pac", ".ann", ".amb", ".cache")]
        else:
            print(f"[WARNING] could not locate index file: {ipath}; "
                  f"building", file=sys.stderr)
            idx = build_index(args.search, cfg)
            # written whole under another name and renamed, so a waiting
            # rank never loads a part of it; a sidecar of a deleted
            # index is stale
            remove_device_cache(ipath)
            tmp = ipath.with_name(f"{ipath.name}.{_os.getpid()}.tmp.npz")
            save_index(idx, tmp)
            _os.replace(tmp, ipath)
    if sidecar and idx._host_cache is None and rank_env == 0:
        # the other ranks wait for this sidecar: write it, then map it as
        # they do
        _write_sidecar(idx, ipath, sources)
        del idx
        idx = load_index(ipath, mmap=True)
    if sidecar and idx._host_cache is not None:
        print(f"[NOTE] rank {rank_env}: index memory-mapped from its "
              f"device-layout sidecar {ipath}.devcache", file=sys.stderr)

    mesh, rank = None, 0
    if args.shardIndex:
        import torch.distributed as dist

        from .parallel.mesh import make_mesh

        mesh = make_mesh(device.type)
        rank = dist.get_rank()

    # ---- multi-process setup (parallel/multihost.py) ----
    num_procs = max(1, args.numProcesses)
    proc_idx = (args.processIndex if args.processIndex >= 0
                else int(_os.environ.get("LORDFAST_PROCESS_INDEX", "0")))
    out_path = args.out
    if num_procs > 1:
        if not args.out:
            print("[ERROR] --numProcesses requires --out (per-process "
                  "shard files)", file=sys.stderr)
            return 1
        from .parallel.multihost import maybe_init_distributed, shard_path

        maybe_init_distributed(args.coordinator, num_procs, proc_idx)
        out_path = shard_path(args.out, proc_idx)

    engine = MappingEngine(idx, cfg, device=device, mesh=mesh,
                           shard_index=args.shardIndex)
    cmdline = "lordfast-tpu " + " ".join(argv)
    from .utils.checkpoint import ChunkProgress
    from .utils.metrics import profiler_trace

    if rank:
        # ranks > 0 serve rank 0's device-stage calls; rank 0 writes
        with profiler_trace(args.profile, device):
            engine.map_file(args.seq, None)
        dist.destroy_process_group()
        return 0

    progress = None
    mode = "w"
    prior_table = []
    if args.out and args.resume:
        progress = ChunkProgress(out_path, str(args.seq),
                                 process_index=proc_idx,
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
            if num_procs > 1:
                # keep the durable part of the shard's chunk table
                from .parallel.multihost import chunks_path

                try:
                    import json

                    rec = json.loads(open(chunks_path(out_path)).read())
                    prior_table = [
                        tuple(c) for c in rec["chunks"]
                        if c[0] <= progress.last_done
                        and c[2] <= progress.out_offset
                    ]
                except (OSError, ValueError, KeyError):
                    prior_table = []
            print(
                f"[NOTE] resuming after chunk {progress.last_done}",
                file=sys.stderr,
            )
    elif args.resume:
        print("[WARNING] --resume requires --out; ignoring", file=sys.stderr)
    if args.out and progress is None:
        progress = ChunkProgress(out_path, str(args.seq),
                                 process_index=proc_idx,
                                 chunk_bytes=cfg.chunk_bytes)

    with profiler_trace(args.profile, device):
        if args.out:
            # buffered SAM writes, reference's opt_outputBufferSize
            # (2 MB default; src/CommandLineParser.cpp:40,
            # src/LordFAST.cpp:451-458)
            with open(out_path, mode,
                      buffering=max(cfg.output_buffer_size, 2)) as out:
                engine.map_file(args.seq, out, cmdline, progress=progress,
                                process_index=proc_idx,
                                num_processes=num_procs)
        else:
            engine.map_file(args.seq, sys.stdout, cmdline,
                            process_index=proc_idx,
                            num_processes=num_procs)

    if num_procs > 1:
        from .parallel.multihost import (barrier, merge_shards,
                                         write_chunk_table)

        write_chunk_table(out_path, prior_table + engine.chunk_table)
        # with a live process group, process 0 merges after the barrier;
        # otherwise run --mergeShards separately
        barrier("lordfast-map-done")
        if args.coordinator and proc_idx == 0:
            n = merge_shards(args.out, num_procs)
            print(f"[NOTE] merged {n} chunks into {args.out}",
                  file=sys.stderr)
        barrier("lordfast-merge-done")
    if mesh is not None:
        dist.destroy_process_group()
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
