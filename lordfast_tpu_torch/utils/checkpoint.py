"""Chunk-level checkpoint / resume.

The reference has no mid-run checkpointing; its durable artifacts are the
index files (written once, reloaded: src/BWT.cpp:117-133,159-187) and the
independent ~100 MB read chunks (src/baseFAST.cpp:59,64-78), so a restart
loses at most one chunk.  The TPU build keeps exactly that granularity
(SURVEY.md §5.4): a sidecar ``<out>.progress`` JSON records the
last-completed chunk id (per host, for multi-host runs) together with

- an input fingerprint (path, size, mtime) and the chunk size, so chunk
  ids cannot silently misalign when the input or config changed;
- the output byte offset after the chunk's flush, so a crash mid-chunk
  (partially flushed SAM records for the unfinished chunk) is repaired on
  resume by truncating the output back to the last durable offset;
- cumulative read/mapped counts, so a resumed run reports run totals.

The record is fsynced after each chunk so a killed run resumes cleanly.
"""

from __future__ import annotations

import json
import os
from pathlib import Path


class ChunkProgress:
    """Tracks last-completed chunk for one (seq_file, out_file) run."""

    def __init__(self, out_path: str | os.PathLike, seq_path: str,
                 process_index: int = 0, chunk_bytes: int = 0):
        self.path = Path(f"{out_path}.progress")
        self.seq_path = str(seq_path)
        self.process_index = process_index
        self.chunk_bytes = int(chunk_bytes)
        self.last_done = -1
        self.out_offset = 0       # durable output size after last chunk
        self.total_reads = 0      # cumulative across resumed runs
        self.total_mapped = 0

    def _fingerprint(self) -> dict:
        try:
            st = os.stat(self.seq_path)
            return {"size": st.st_size, "mtime": int(st.st_mtime)}
        except OSError:
            return {"size": -1, "mtime": -1}

    def load(self) -> int:
        """Returns the last completed chunk id (-1 if starting fresh, or
        the record belongs to a different input / chunking / host)."""
        try:
            rec = json.loads(self.path.read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            return -1
        if rec.get("seq_path") != self.seq_path or \
                rec.get("process_index", 0) != self.process_index:
            return -1
        if rec.get("chunk_bytes", 0) != self.chunk_bytes or \
                rec.get("fingerprint") != self._fingerprint():
            # input contents or chunking changed: chunk ids would misalign
            return -1
        self.last_done = int(rec.get("last_chunk", -1))
        self.out_offset = int(rec.get("out_offset", 0))
        self.total_reads = int(rec.get("total_reads", 0))
        self.total_mapped = int(rec.get("total_mapped", 0))
        return self.last_done

    def mark_done(self, chunk_id: int, out_offset: int = 0,
                  total_reads: int = 0, total_mapped: int = 0) -> None:
        self.last_done = chunk_id
        self.out_offset = int(out_offset)
        self.total_reads = int(total_reads)
        self.total_mapped = int(total_mapped)
        tmp = self.path.with_suffix(".progress.tmp")
        with open(tmp, "w") as f:
            json.dump(
                {
                    "seq_path": self.seq_path,
                    "last_chunk": chunk_id,
                    "process_index": self.process_index,
                    "chunk_bytes": self.chunk_bytes,
                    "fingerprint": self._fingerprint(),
                    "out_offset": self.out_offset,
                    "total_reads": self.total_reads,
                    "total_mapped": self.total_mapped,
                },
                f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def finish(self) -> None:
        """Run completed: remove the sidecar so the next run starts clean."""
        try:
            self.path.unlink()
        except FileNotFoundError:
            pass
