"""Streaming FASTA/FASTQ(.gz) reader with bounded chunks.

Capability match of the reference's kseq-based loader
(src/Reads.cpp:46-142): reads are streamed in ~chunk_bytes batches (the
reference bounds chunks at 100 MB, src/baseFAST.cpp:59), each read keeps
(name, seq, qual, is_fastq).  Names are cut at the first whitespace (kseq
semantics)."""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator, List, Optional


@dataclass
class Read:
    name: str
    seq: bytes
    qual: Optional[bytes]  # None for FASTA

    @property
    def is_fastq(self) -> bool:
        return self.qual is not None


def _open(path):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb", buffering=1 << 20)


def _fast_fastq4(data: bytes, at_eof: bool):
    """Vectorized parse of uniform 4-line FASTQ records.

    Returns (reads, consumed) or None when the block is not plain 4-line
    FASTQ (wrapped sequences, FASTA, etc.) — the caller then falls back
    to the kseq state machine.  Line splitting and format checks are
    numpy over the whole block; Python touches each record once to slice
    it out (the reference's kseq walks every byte in C,
    lib/bwa/kseq.h:239; this is the numpy equivalent of that hot loop).
    """
    import numpy as np

    arr = np.frombuffer(data, np.uint8)
    nl = np.flatnonzero(arr == 10)
    n_rec = len(nl) // 4
    if n_rec == 0:
        return None
    nl4 = nl[: n_rec * 4]
    starts = np.empty(n_rec * 4, np.int64)
    starts[0] = 0
    starts[1:] = nl4[:-1] + 1
    ends = nl4 - (arr[np.maximum(nl4 - 1, 0)] == 13)  # tolerate CRLF
    s = starts.reshape(n_rec, 4)
    e = ends.reshape(n_rec, 4)
    ok = (
        (arr[s[:, 0]] == ord("@")).all()
        and (arr[s[:, 2]] == ord("+")).all()
        and ((e[:, 3] - s[:, 3]) == (e[:, 1] - s[:, 1])).all()
        and int((e - s).min()) > 0 - 1  # no negative lengths
    )
    if not ok:
        return None
    reads = []
    for i in range(n_rec):
        name = data[s[i, 0] + 1 : e[i, 0]].split(None, 1)[0].decode()
        reads.append(Read(name, data[s[i, 1] : e[i, 1]],
                          data[s[i, 3] : e[i, 3]]))
    consumed = int(nl4[-1]) + 1
    if not at_eof:
        return reads, consumed
    # trailing bytes after the last complete group must themselves be a
    # well-formed tail; let the fallback handle any remainder
    return reads, consumed


def read_fastx(path) -> Iterator[Read]:
    """Yield reads one by one.  Plain 4-line FASTQ takes a vectorized
    numpy fast path; anything else (FASTA, wrapped/multi-line records)
    uses the kseq-semantics state machine below."""
    BLOCK = 64 << 20
    with _open(path) as f:
        head = f.peek(1)[:1] if hasattr(f, "peek") else b""
        if head == b"@":
            rem = b""
            fast_failed = False
            while not fast_failed:
                block = f.read(BLOCK)
                if not block:
                    if rem.strip():
                        fast_failed = True  # tail needs the state machine
                    break
                data = rem + block
                at_eof = len(block) < BLOCK
                got = _fast_fastq4(data, at_eof)
                if got is None:
                    fast_failed = True
                    rem = data
                    break
                reads, consumed = got
                yield from reads
                rem = data[consumed:]
            if not fast_failed:
                return
            # fall back: re-parse the unconsumed remainder + rest of file
            yield from _read_fastx_slow_bytes(rem, f)
            return
        yield from _read_fastx_slow(f)


def _read_fastx_slow_bytes(rem: bytes, f) -> Iterator[Read]:
    import io as _io

    class _Chain:
        def __init__(self, a, b):
            self._a = _io.BytesIO(a)
            self._b = b

        def readline(self):
            line = self._a.readline()
            if line:
                return line
            return self._b.readline()

    yield from _read_fastx_slow(_Chain(rem, f))


def _read_fastx_slow(f) -> Iterator[Read]:
    if True:
        first = f.peek(1)[:1] if hasattr(f, "peek") else b""
        if not first:
            first = b""
        line = f.readline()
        while line:
            line = line.strip()
            if not line:
                line = f.readline()
                continue
            if line.startswith(b">"):  # FASTA record
                name = line[1:].split()[0].decode()
                seq_parts = []
                line = f.readline()
                while line and not line.startswith(b">") and not line.startswith(b"@"):
                    seq_parts.append(line.strip())
                    line = f.readline()
                yield Read(name, b"".join(seq_parts), None)
            elif line.startswith(b"@"):  # FASTQ record (kseq semantics:
                # sequence and quality may wrap across lines,
                # lib/bwa/kseq.h kseq_read — sequence runs
                # until the '+' separator, quality until its length
                # matches the sequence; CRLF tolerated via strip)
                name = line[1:].split()[0].decode()
                seq_parts = []
                line = f.readline()
                while line and not line.startswith(b"+"):
                    seq_parts.append(line.strip())
                    line = f.readline()
                seq = b"".join(seq_parts)
                qual_parts = []
                qlen = 0
                while qlen < len(seq):
                    line = f.readline()
                    if not line:  # truncated final record: kseq returns
                        break     # the read with partial quality
                    part = line.strip()
                    qual_parts.append(part)
                    qlen += len(part)
                yield Read(name, seq, b"".join(qual_parts))
                line = f.readline()
            else:
                raise ValueError(f"malformed FASTA/FASTQ near: {line[:40]!r}")


def read_chunks(path, chunk_bytes: int) -> Iterator[List[Read]]:
    """Group reads into chunks bounded by chunk_bytes of sequence+name
    payload (reference: readChunk stops past 100 MB, src/Reads.cpp:64-131)."""
    chunk: List[Read] = []
    size = 0
    for r in read_fastx(path):
        chunk.append(r)
        size += len(r.seq) + len(r.name) + (len(r.qual) if r.qual else 0)
        if size >= chunk_bytes:
            yield chunk
            chunk, size = [], 0
    if chunk:
        yield chunk
