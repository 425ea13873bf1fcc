"""Multi-process scale-out: per-process read shards + SAM shard merge.

The reference is single-node, but its chunked driver loop is already the
right decomposition for processes: each ~100 MB chunk is independent
(src/baseFAST.cpp:64-78), so processes simply own disjoint chunk ids of
the shared input (round-robin: chunk_id % num_processes ==
process_index) and write their own SAM shard, with no cross-process
traffic on the mapping path.  An optional ordered merge concatenates the
shards back into one SAM in input (chunk) order, which the reference
cannot do (its output order is thread-nondeterministic).

``torch.distributed`` (the gloo backend: the barrier moves no tensors,
and several processes may share one card) is only needed for the
end-of-run barrier before the rank-0 merge; ``maybe_init_distributed``
gates it behind explicit coordinator configuration.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

_DIST_INITIALIZED = False


def maybe_init_distributed(coordinator: str, num_processes: int,
                           process_index: int) -> bool:
    """torch.distributed's gloo process group at tcp://<coordinator>
    (host:port, served by process 0), gated behind explicit
    configuration; returns True when the group is (now) up."""
    global _DIST_INITIALIZED
    if not coordinator:
        return _DIST_INITIALIZED
    if _DIST_INITIALIZED:
        return True
    from datetime import timedelta

    import torch.distributed as dist

    # the timeout bounds the rendezvous and each barrier: finite, so a
    # peer that never arrives fails the run, and long enough for the
    # slowest process's last chunk and the rank-0 merge (a peer that
    # dies after the rendezvous closes its connection and fails the
    # barrier at once)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_index,
        timeout=timedelta(seconds=1800),
    )
    _DIST_INITIALIZED = True
    return True


def barrier(name: str = "lordfast") -> None:
    """Cross-process sync point (no-op when distributed is not
    initialized); name labels the call site, as in the JAX package."""
    if not _DIST_INITIALIZED:
        return
    import torch.distributed as dist

    dist.barrier()


def shard_path(out_path: str | os.PathLike, process_index: int) -> str:
    return f"{out_path}.part{process_index}"


def chunks_path(out_path: str | os.PathLike) -> str:
    return f"{out_path}.chunks"


def write_chunk_table(out_path: str | os.PathLike, table) -> None:
    """Persist the per-chunk byte ranges of one SAM shard
    ([(chunk_id, byte_start, byte_end), ...], engine.chunk_table)."""
    tmp = f"{chunks_path(out_path)}.tmp"
    with open(tmp, "w") as f:
        json.dump({"chunks": [list(c) for c in table]}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, chunks_path(out_path))


def merge_shards(out_path: str | os.PathLike, num_processes: int,
                 keep_parts: bool = False) -> int:
    """Ordered merge of per-host SAM shards into ``out_path``.

    Each shard carries a ``.chunks`` sidecar with its chunk byte ranges;
    the merge emits the header of shard 0 followed by every chunk in
    ascending chunk-id order.  Returns the number of chunks merged.
    """
    parts = [Path(shard_path(out_path, i)) for i in range(num_processes)]
    tables = []
    for p in parts:
        rec = json.loads(Path(chunks_path(p)).read_text())
        tables.append([tuple(c) for c in rec["chunks"]])

    all_chunks = sorted(
        (cid, pi, s, e)
        for pi, tbl in enumerate(tables)
        for cid, s, e in tbl
    )
    with open(out_path, "wb") as out:
        # header = shard 0's bytes before its first chunk
        hdr_end = tables[0][0][1] if tables[0] else parts[0].stat().st_size
        with open(parts[0], "rb") as f:
            out.write(f.read(hdr_end))
        for cid, pi, s, e in all_chunks:
            with open(parts[pi], "rb") as f:
                f.seek(s)
                out.write(f.read(e - s))
    if not keep_parts:
        for p in parts:
            p.unlink(missing_ok=True)
            Path(chunks_path(p)).unlink(missing_ok=True)
    return len(all_chunks)
