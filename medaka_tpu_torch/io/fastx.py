"""FASTA/FASTQ reading and writing (plain, gzip or BGZF compressed).

Counterpart of ``medaka_tpu/io/fastx.py``: ``read_fastx``,
``FastaReader``, ``FastaWriter``, ``FastqWriter`` and ``write_fai``.
"""
from __future__ import annotations

import gzip
from typing import Dict, Iterator, NamedTuple, Optional


class FastxRecord(NamedTuple):
    """A sequence record; ``quality`` is None for FASTA."""

    name: str
    sequence: str
    comment: Optional[str] = None
    quality: Optional[str] = None


def _open_text(path: str):
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "rt")


def read_fastx(path: str) -> Iterator[FastxRecord]:
    """Stream records from a FASTA or FASTQ file (optionally gzipped)."""
    with _open_text(path) as fh:
        first = fh.read(1)
        if not first:
            return
        if first == ">":
            yield from _fasta_lines(first, fh)
        elif first == "@":
            yield from _fastq_records(first, fh)
        else:
            raise ValueError(
                "{} does not look like FASTA/FASTQ".format(path))


def _fasta_lines(first: str, fh) -> Iterator[FastxRecord]:
    name, comment, seq = None, None, []
    header = first + fh.readline()
    while True:
        fields = header[1:].rstrip("\n").split(None, 1)
        name = fields[0]
        comment = fields[1] if len(fields) > 1 else None
        seq = []
        header = None
        for line in fh:
            if line.startswith(">"):
                header = line
                break
            seq.append(line.strip())
        yield FastxRecord(name, "".join(seq), comment)
        if header is None:
            return


def _fastq_records(first: str, fh) -> Iterator[FastxRecord]:
    header = first + fh.readline()
    while header:
        fields = header[1:].rstrip("\n").split(None, 1)
        # sequence may wrap over several lines (legal FASTQ): read
        # until the '+' separator
        seq_parts = []
        line = fh.readline()
        while line and not line.startswith("+"):
            seq_parts.append(line.strip())
            line = fh.readline()
        if not line:
            raise ValueError(
                "Truncated FASTQ record {}".format(fields[0]))
        seq = "".join(seq_parts)
        # qualities may wrap too; they end when their length matches
        # the sequence ('@' can legally start a quality line)
        qual_parts = []
        q_len = 0
        while q_len < len(seq):
            line = fh.readline()
            if not line:
                raise ValueError(
                    "Truncated FASTQ qualities for {}".format(fields[0]))
            part = line.strip()
            qual_parts.append(part)
            q_len += len(part)
        if q_len != len(seq):
            raise ValueError(
                "FASTQ qualities length mismatch for {}".format(
                    fields[0]))
        yield FastxRecord(
            fields[0], seq, fields[1] if len(fields) > 1 else None,
            "".join(qual_parts))
        header = fh.readline()
        if header and not header.startswith("@"):
            raise ValueError("Malformed FASTQ near {}".format(header[:40]))


class FastaReader:
    """Random-access FASTA with an in-memory index (pysam.FastaFile analog)."""

    def __init__(self, path: str):
        self.path = path
        self._seqs: Dict[str, str] = {}
        self._order = []
        for rec in read_fastx(path):
            self._seqs[rec.name] = rec.sequence
            self._order.append(rec.name)

    @property
    def references(self):
        """Contig names in file order."""
        return list(self._order)

    @property
    def lengths(self):
        """Contig lengths in file order."""
        return [len(self._seqs[n]) for n in self._order]

    def fetch(self, ref_name: str, start: Optional[int] = None,
              end: Optional[int] = None) -> str:
        """Return a subsequence of a contig."""
        seq = self._seqs[ref_name]
        return seq[start:end]

    def get_reference_length(self, ref_name: str) -> int:
        """Length of a contig."""
        return len(self._seqs[ref_name])

    def __contains__(self, name):
        return name in self._seqs

    def close(self):  # noqa: D102
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def _wrap(seq: str, width: int = 80):
    return "\n".join(seq[i:i + width] for i in range(0, len(seq), width))


class FastaWriter:
    """Write FASTA records."""

    def __init__(self, path: str, width: int = 80):
        self._fh = open(path, "w")
        self._width = width

    def write(self, name: str, sequence: str, comment: str = None):
        """Append one record."""
        header = ">" + name + ((" " + comment) if comment else "")
        self._fh.write(header + "\n")
        self._fh.write(_wrap(sequence, self._width) + "\n")

    def close(self):  # noqa: D102
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FastqWriter:
    """Write FASTQ records."""

    def __init__(self, path: str):
        self._fh = open(path, "w")

    def write(self, name: str, sequence: str, quality: str,
              comment: str = None):
        """Append one record."""
        header = "@" + name + ((" " + comment) if comment else "")
        self._fh.write(
            "{}\n{}\n+\n{}\n".format(header, sequence, quality))

    def close(self):  # noqa: D102
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_fai(path: str, out_path: Optional[str] = None) -> str:
    """Write a .fai index for an (uncompressed) FASTA file."""
    out_path = out_path or path + ".fai"
    entries = []
    with open(path, "rb") as fh:
        name = None
        seq_start = 0
        seq_len = 0
        line_blen = 0
        line_len = 0
        offset = 0
        for line in fh:
            if line.startswith(b">"):
                if name is not None:
                    entries.append(
                        (name, seq_len, seq_start, line_blen, line_len))
                name = line[1:].split()[0].decode()
                seq_start = offset + len(line)
                seq_len = 0
                line_blen = 0
                line_len = 0
            else:
                blen = len(line.rstrip(b"\r\n"))
                seq_len += blen
                if line_blen == 0:
                    line_blen, line_len = blen, len(line)
            offset += len(line)
        if name is not None:
            entries.append((name, seq_len, seq_start, line_blen, line_len))
    with open(out_path, "w") as fh:
        for e in entries:
            fh.write("\t".join(map(str, e)) + "\n")
    return out_path
