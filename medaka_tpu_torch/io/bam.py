"""BAM reading/writing with BAI indexing.

Counterpart of ``medaka_tpu/io/bam.py``, written from the SAM spec in place
of htslib/pysam. Supports: header parsing, full-file iteration,
BAI region queries (reg2bin binning scheme, linear index), record
construction, sorted BAM writing and .bai index generation.
"""
from __future__ import annotations

import functools
import os
import struct
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from medaka_tpu_torch.io.bgzf import BgzfReader, BgzfWriter

# CIGAR op encoding per the BAM spec.
CIGAR_OPS = "MIDNSHP=X"
C_M, C_I, C_D, C_N, C_S, C_H, C_P, C_EQ, C_X = range(9)
_CONSUMES_REF = np.array(
    [1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.int64)  # M D N = X

SEQ_NT16_STR = "=ACMGRSVTWYHKDBN"
_NT16_LUT = np.frombuffer(SEQ_NT16_STR.encode(), dtype=np.uint8)
SEQ_NT16_TABLE = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(SEQ_NT16_STR):
    SEQ_NT16_TABLE[ord(_c)] = _i
    SEQ_NT16_TABLE[ord(_c.lower())] = _i

# flag bits
FPAIRED, FPROPER_PAIR, FUNMAP, FMUNMAP, FREVERSE, FMREVERSE = (
    1, 2, 4, 8, 16, 32)
FREAD1, FREAD2, FSECONDARY, FQCFAIL, FDUP, FSUPPLEMENTARY = (
    64, 128, 256, 512, 1024, 2048)


def reg2bin(beg: int, end: int) -> int:
    """Compute the smallest bin containing [beg, end) (SAM spec 5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """List all bins overlapping [beg, end) (SAM spec 5.3)."""
    end -= 1
    bins = [0]
    for base, shift in ((1, 26), (9, 23), (73, 20), (585, 17), (4681, 14)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


class BamError(ValueError):
    """Malformed BAM data."""


class BamRecord:
    """One alignment record, decoded lazily from its binary payload.

    ``raw`` excludes the leading ``block_size`` field.
    """

    __slots__ = (
        "raw", "ref_id", "pos", "mapq", "flag", "_l_read_name", "_n_cigar",
        "_l_seq", "next_ref_id", "next_pos", "tlen", "__dict__")

    def __init__(self, raw: bytes):
        self.raw = raw
        (self.ref_id, self.pos, self._l_read_name, self.mapq, _bin,
         self._n_cigar, self.flag, self._l_seq, self.next_ref_id,
         self.next_pos, self.tlen) = struct.unpack_from("<iiBBHHHIiii", raw)

    # --- layout helpers ---
    @property
    def _cigar_off(self):
        return 32 + self._l_read_name

    @property
    def _seq_off(self):
        return self._cigar_off + 4 * self._n_cigar

    @property
    def _qual_off(self):
        return self._seq_off + (self._l_seq + 1) // 2

    @property
    def _aux_off(self):
        return self._qual_off + self._l_seq

    # --- core fields ---
    @functools.cached_property
    def query_name(self) -> str:
        """Read name."""
        return self.raw[32:32 + self._l_read_name - 1].decode()

    @functools.cached_property
    def has_long_cigar(self) -> bool:
        """True for the BAM long-cigar convention (>65535 ops).

        Such records store a placeholder ``<l_seq>S<ref_len>N`` cigar
        with the real cigar in the ``CG`` aux tag (SAM spec 4.2.2).
        """
        if self._n_cigar != 2:
            return False
        enc = np.frombuffer(
            self.raw, dtype="<u4", count=2, offset=self._cigar_off)
        return (int(enc[0] & 0xF) == C_S
                and int(enc[0] >> 4) == self._l_seq
                and int(enc[1] & 0xF) == C_N
                and "CG" in self.tags)

    @functools.cached_property
    def cigar_array(self) -> np.ndarray:
        """(n_ops, 2) array of (op_code, length).

        Transparently expands the ``CG``-tag long-cigar convention.
        """
        if self.has_long_cigar:
            enc = np.asarray(self.tags["CG"], dtype=np.uint32)
        else:
            enc = np.frombuffer(
                self.raw, dtype="<u4", count=self._n_cigar,
                offset=self._cigar_off)
        out = np.empty((len(enc), 2), dtype=np.int64)
        out[:, 0] = enc & 0xF
        out[:, 1] = enc >> 4
        return out

    @functools.cached_property
    def seq_nt16(self) -> np.ndarray:
        """Per-base 4-bit nt16 codes as a uint8 array of length l_seq."""
        packed = np.frombuffer(
            self.raw, dtype=np.uint8, count=(self._l_seq + 1) // 2,
            offset=self._seq_off)
        out = np.empty(2 * len(packed), dtype=np.uint8)
        out[0::2] = packed >> 4
        out[1::2] = packed & 0xF
        return out[:self._l_seq]

    @functools.cached_property
    def query_qualities(self) -> Optional[np.ndarray]:
        """Base qualities (None when absent)."""
        if self._l_seq == 0:
            return None
        q = np.frombuffer(
            self.raw, dtype=np.uint8, count=self._l_seq,
            offset=self._qual_off)
        if len(q) and q[0] == 0xFF:
            return None
        return q

    @functools.cached_property
    def tags(self) -> Dict[str, object]:
        """Aux tags decoded into a dict."""
        out = {}
        buf = self.raw
        pos = self._aux_off
        n = len(buf)
        while pos + 3 <= n:
            tag = buf[pos:pos + 2].decode()
            typ = chr(buf[pos + 2])
            pos += 3
            if typ == "A":
                out[tag] = chr(buf[pos]); pos += 1
            elif typ in "cC":
                out[tag] = struct.unpack_from(
                    "<b" if typ == "c" else "<B", buf, pos)[0]
                pos += 1
            elif typ in "sS":
                out[tag] = struct.unpack_from(
                    "<h" if typ == "s" else "<H", buf, pos)[0]
                pos += 2
            elif typ in "iI":
                out[tag] = struct.unpack_from(
                    "<i" if typ == "i" else "<I", buf, pos)[0]
                pos += 4
            elif typ == "f":
                out[tag] = struct.unpack_from("<f", buf, pos)[0]; pos += 4
            elif typ in "ZH":
                endp = buf.index(b"\x00", pos)
                out[tag] = buf[pos:endp].decode()
                pos = endp + 1
            elif typ == "B":
                sub = chr(buf[pos])
                count = struct.unpack_from("<I", buf, pos + 1)[0]
                pos += 5
                dtype = {"c": "<i1", "C": "<u1", "s": "<i2", "S": "<u2",
                         "i": "<i4", "I": "<u4", "f": "<f4"}[sub]
                arr = np.frombuffer(buf, dtype=dtype, count=count, offset=pos)
                out[tag] = arr
                pos += arr.itemsize * count
            else:
                raise BamError("Unknown aux type {!r}".format(typ))
        return out

    # --- flags ---
    @property
    def is_unmapped(self):  # noqa: D102
        return bool(self.flag & FUNMAP)

    @property
    def is_reverse(self):  # noqa: D102
        return bool(self.flag & FREVERSE)

    # --- derived geometry ---
    @functools.cached_property
    def reference_length(self) -> int:
        """Number of reference bases consumed by the alignment."""
        # straight off the packed words — cigar_array's (n, 2) copy
        # costs more than this whole reduction on typical reads
        enc = np.frombuffer(
            self.raw, dtype="<u4", count=self._n_cigar,
            offset=self._cigar_off)
        return int(np.sum((enc >> 4) * _CONSUMES_REF[enc & 0xF]))

    @property
    def reference_end(self) -> int:
        """One past the last consumed reference coordinate."""
        return self.pos + self.reference_length

    # --- construction ---
    @classmethod
    def build(
            cls, query_name: str, ref_id: int, pos: int,
            seq: Optional[str] = None, qual=None, cigar: str = "*",
            flag: int = 0, mapq: int = 60, next_ref_id: int = -1,
            next_pos: int = -1, tlen: int = 0,
            tags: Optional[Dict] = None) -> "BamRecord":
        """Construct a record from python values."""
        name_b = query_name.encode() + b"\x00"
        cigar_ops = parse_cigar(cigar) if cigar not in ("*", None) else []
        cig_b = b"".join(
            struct.pack("<I", (ln << 4) | op) for op, ln in cigar_ops)
        if seq:
            codes = SEQ_NT16_TABLE[
                np.frombuffer(seq.encode(), dtype=np.uint8)]
            if len(codes) % 2:
                codes = np.concatenate([codes, [0]])
            packed = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8)
            seq_b = packed.tobytes()
            l_seq = len(seq)
        else:
            seq_b, l_seq = b"", 0
        if qual is None:
            qual_b = b"\xff" * l_seq
        else:
            qual_b = bytes(bytearray(qual))
            if len(qual_b) != l_seq:
                raise BamError("quality length != sequence length")
        aux_b = encode_tags(tags or {})
        end = pos + sum(
            ln for op, ln in cigar_ops if _CONSUMES_REF[op])
        rec_bin = reg2bin(pos, max(end, pos + 1))
        head = struct.pack(
            "<iiBBHHHIiii", ref_id, pos, len(name_b), mapq, rec_bin,
            len(cigar_ops), flag, l_seq, next_ref_id, next_pos, tlen)
        return cls(head + name_b + cig_b + seq_b + qual_b + aux_b)


def parse_cigar(cigar: str) -> List[Tuple[int, int]]:
    """Parse a text CIGAR into (op_code, length) tuples."""
    out = []
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            out.append((CIGAR_OPS.index(ch), num))
            num = 0
    return out


def encode_tags(tags: Dict) -> bytes:
    """Encode aux tags. Values may be int, float, str, or numeric sequences."""
    chunks = []
    for name, value in tags.items():
        tag_b = name.encode()
        if isinstance(value, bool):
            raise BamError("bool tag value not supported")
        if isinstance(value, (int, np.integer)):
            v = int(value)
            if -(1 << 31) <= v < (1 << 31):
                chunks.append(tag_b + b"i" + struct.pack("<i", v))
            elif 0 <= v < (1 << 32):
                chunks.append(tag_b + b"I" + struct.pack("<I", v))
            else:
                raise BamError(
                    "int tag {}={} exceeds 32 bits".format(name, v))
        elif isinstance(value, (float, np.floating)):
            chunks.append(tag_b + b"f" + struct.pack("<f", float(value)))
        elif isinstance(value, str):
            chunks.append(tag_b + b"Z" + value.encode() + b"\x00")
        elif isinstance(value, (list, tuple, np.ndarray)) or \
                value.__class__.__name__ == "array":
            arr = np.asarray(value)
            if arr.dtype.kind == "f":
                sub, dt = b"f", "<f4"
            else:
                lo, hi = (int(arr.min()), int(arr.max())) if len(arr) else (0, 0)
                # narrowest lossless subtype, signed or unsigned
                for sub, dt, dlo, dhi in (
                        (b"c", "<i1", -(1 << 7), (1 << 7) - 1),
                        (b"C", "<u1", 0, (1 << 8) - 1),
                        (b"s", "<i2", -(1 << 15), (1 << 15) - 1),
                        (b"S", "<u2", 0, (1 << 16) - 1),
                        (b"i", "<i4", -(1 << 31), (1 << 31) - 1),
                        (b"I", "<u4", 0, (1 << 32) - 1)):
                    if dlo <= lo and hi <= dhi:
                        break
                else:
                    raise BamError(
                        "B-array tag {} range [{}, {}] exceeds 32 "
                        "bits".format(name, lo, hi))
            data = arr.astype(dt).tobytes()
            chunks.append(
                tag_b + b"B" + sub + struct.pack("<I", len(arr)) + data)
        else:
            raise BamError(
                "Cannot encode tag {}={!r}".format(name, value))
    return b"".join(chunks)


class BamReader:
    """BAM file reader with optional .bai-driven region queries."""

    def __init__(self, path: str):
        self.path = path
        self._bgzf = BgzfReader(path)
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise BamError("{} is not a BAM file".format(path))
        l_text = struct.unpack("<i", self._bgzf.read(4))[0]
        self.header_text = self._bgzf.read(l_text).rstrip(b"\x00").decode()
        n_ref = struct.unpack("<i", self._bgzf.read(4))[0]
        refs = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._bgzf.read(4))[0]
            name = self._bgzf.read(l_name)[:-1].decode()
            l_ref = struct.unpack("<i", self._bgzf.read(4))[0]
            refs.append((name, l_ref))
        self.references = [r[0] for r in refs]
        self.lengths = [r[1] for r in refs]
        self._ref_by_name = {n: i for i, (n, _) in enumerate(refs)}
        self._data_voffset = self._bgzf.tell_virtual()
        self._index = None

    # --- header conveniences ---
    def get_tid(self, ref_name: str) -> int:
        """Reference id for a contig name (-1 when unknown)."""
        return self._ref_by_name.get(ref_name, -1)

    # --- iteration ---
    def _records_from(self, voffset: int) -> Iterator[Tuple[int, BamRecord]]:
        bg = self._bgzf
        bg.seek_virtual(voffset)
        while True:
            vo = bg.tell_virtual()
            head = bg.read(4)
            if len(head) < 4:
                return
            block_size = struct.unpack("<i", head)[0]
            raw = bg.read(block_size)
            if len(raw) < block_size:
                raise BamError("Truncated BAM record")
            yield vo, BamRecord(raw)

    def __iter__(self) -> Iterator[BamRecord]:
        self._bgzf.prefetch_all(self._data_voffset)
        return (rec for _, rec in self._records_from(self._data_voffset))

    # --- index ---
    def _load_index(self):
        if self._index is None:
            bai = self.path + ".bai"
            if not os.path.exists(bai):
                base, ext = os.path.splitext(self.path)
                alt = base + ".bai"
                bai = alt if os.path.exists(alt) else None
            self._index = BaiIndex.load(bai) if bai else False
        return self._index

    def fetch(self, ref_name: str, start: Optional[int] = None,
              end: Optional[int] = None) -> Iterator[BamRecord]:
        """Yield records overlapping [start, end) of a contig, sorted order."""
        tid = self.get_tid(ref_name)
        if tid < 0:
            raise KeyError("Unknown reference {}".format(ref_name))
        beg = 0 if start is None else max(0, start)
        stop = self.lengths[tid] if end is None else end
        index = self._load_index()
        if index:
            chunks = index.query(tid, beg, stop)
            for cbeg, cend in chunks:
                # inflate the chunk's block span in one multi-threaded
                # native pass rather than block-by-block in the record loop
                self._bgzf.prefetch(cbeg, cend)
                for vo, rec in self._records_from(cbeg):
                    if vo >= cend:
                        break
                    if rec.ref_id != tid or rec.is_unmapped:
                        continue
                    if rec.pos >= stop:
                        break
                    # htslib endpos semantics: a zero-reference-length
                    # record ends at pos+1, so pos >= beg implies
                    # overlap; the cigar walk only runs for reads
                    # starting left of the window
                    if rec.pos >= beg or rec.reference_end > beg:
                        yield rec
        else:
            # full scan fallback
            for rec in self:
                if rec.ref_id != tid or rec.is_unmapped:
                    continue
                if rec.pos >= stop:
                    # sorted inputs only benefit; keep scanning for safety
                    continue
                # htslib endpos semantics (see indexed path above)
                if rec.pos >= beg or rec.reference_end > beg:
                    yield rec

    def region_payload(self, ref_name: str, start: Optional[int] = None,
                       end: Optional[int] = None,
                       max_compressed_span: int = 256 << 20):
        """Inflate a region's index-chunk span in one native pass.

        The featurization hot path hands the result straight to the
        native record scan + pileup kernels, so a region goes BGZF
        bytes -> counts without materialising ``BamRecord`` objects
        (reference context: P1/P2, ``medaka/features.py:199-255``).

        :returns: ``(payload, seg_start, seg_end, tid)`` — inflated
            payload bytes (uint8 array) and, per index chunk, the
            payload-coordinate window bounding its records — or
            ``None`` when there is no .bai or the compressed span
            exceeds ``max_compressed_span`` (callers fall back to
            :meth:`fetch`).
        :raises NativeBuildError: when the native library cannot be
            built or the BGZF framing is corrupt.
        """
        from medaka_tpu_torch import native
        tid = self.get_tid(ref_name)
        if tid < 0:
            raise KeyError("Unknown reference {}".format(ref_name))
        index = self._load_index()
        if not index:
            return None
        beg = 0 if start is None else max(0, start)
        stop = self.lengths[tid] if end is None else end
        chunks = index.query(tid, beg, stop)
        data_len = len(self._bgzf._data)
        span = sum(
            min((ce >> 16) + 1, data_len) - (cb >> 16)
            for cb, ce in chunks)
        if span > max_compressed_span:
            return None
        # scan every chunk first (header walk only), then inflate all
        # spans into ONE pre-sized buffer — the old per-chunk payloads
        # + np.concatenate cost more in memcpy than the inflate itself
        # on multi-chunk regions (measured 0.80s vs 0.54s on an 8 Mb
        # region sweep)
        scans, seg_start, seg_end = [], [], []
        base = 0
        nthreads = self._bgzf._nthreads
        for cbeg, cend in chunks:
            c0 = cbeg >> 16
            limit = min((cend >> 16) + 1, data_len)
            coffs, bsizes, isizes, poffs = native.bgzf_scan_range(
                self._bgzf._data, c0, limit)
            eb = cend >> 16
            j = int(np.searchsorted(coffs, eb))
            if j < len(coffs) and coffs[j] == eb:
                e = int(poffs[j]) + (cend & 0xFFFF)
            else:
                e = int(poffs[-1])
            scans.append((coffs, bsizes, isizes, poffs, base))
            seg_start.append(base + (cbeg & 0xFFFF))
            seg_end.append(base + e)
            base += int(poffs[-1])
        if not scans:
            return (np.empty(0, np.uint8), np.empty(0, np.int64),
                    np.empty(0, np.int64), tid)
        payload = np.empty(base, np.uint8)
        for coffs, bsizes, isizes, poffs, off in scans:
            native.bgzf_inflate_into(
                self._bgzf._data, coffs, bsizes, isizes, poffs,
                payload, out_base=off, nthreads=nthreads)
        return (payload, np.asarray(seg_start, np.int64),
                np.asarray(seg_end, np.int64), tid)

    def close(self):
        """Close the underlying BGZF reader."""
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BaiIndex:
    """Parsed .bai index."""

    def __init__(self, bins, intervals):
        # bins: list per ref of dict bin_id -> [(chunk_beg, chunk_end), ...]
        # intervals: list per ref of uint64 array (16kb linear index)
        self.bins = bins
        self.intervals = intervals

    @classmethod
    def load(cls, path: str) -> "BaiIndex":
        """Parse a .bai file."""
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != b"BAI\x01":
            raise BamError("{} is not a BAI index".format(path))
        pos = 4
        (n_ref,) = struct.unpack_from("<i", data, pos)
        pos += 4
        bins, intervals = [], []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, pos)
            pos += 4
            bmap = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, pos)
                pos += 8
                chunks = list(
                    struct.iter_unpack(
                        "<QQ", data[pos:pos + 16 * n_chunk]))
                pos += 16 * n_chunk
                if bin_id != 37450:  # skip metadata pseudo-bin
                    bmap[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, pos)
            pos += 4
            ioff = np.frombuffer(data, dtype="<u8", count=n_intv, offset=pos)
            pos += 8 * n_intv
            bins.append(bmap)
            intervals.append(ioff)
        return cls(bins, intervals)

    def query(self, tid: int, beg: int, end: int) -> List[Tuple[int, int]]:
        """Return merged (voffset_beg, voffset_end) chunks for a region."""
        if tid >= len(self.bins):
            return []
        bmap = self.bins[tid]
        ioff = self.intervals[tid]
        win = beg >> 14
        min_off = int(ioff[win]) if win < len(ioff) else (
            int(ioff[-1]) if len(ioff) else 0)
        chunks = []
        for b in reg2bins(beg, end):
            for cbeg, cend in bmap.get(b, ()):
                if cend > min_off:
                    chunks.append((max(cbeg, min_off), cend))
        chunks.sort()
        merged = []
        for cbeg, cend in chunks:
            if merged and cbeg <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], cend))
            else:
                merged.append((cbeg, cend))
        return merged

    @staticmethod
    def build(bam_path: str, bai_path: Optional[str] = None) -> str:
        """Scan a (sorted) BAM and write its .bai index."""
        reader = BamReader(bam_path)
        n_ref = len(reader.references)
        bins = [dict() for _ in range(n_ref)]
        intervals = [dict() for _ in range(n_ref)]
        last_vo = reader._data_voffset
        for vo, rec in reader._records_from(reader._data_voffset):
            last_vo = reader._bgzf.tell_virtual()
            if rec.ref_id < 0 or rec.is_unmapped:
                continue
            end = max(rec.reference_end, rec.pos + 1)
            b = reg2bin(rec.pos, end)
            blist = bins[rec.ref_id].setdefault(b, [])
            if blist and blist[-1][1] == vo:
                blist[-1] = (blist[-1][0], last_vo)
            else:
                blist.append((vo, last_vo))
            for win in range(rec.pos >> 14, ((end - 1) >> 14) + 1):
                cur = intervals[rec.ref_id].get(win)
                if cur is None or vo < cur:
                    intervals[rec.ref_id][win] = vo
        reader.close()

        out = [b"BAI\x01", struct.pack("<i", n_ref)]
        for tid in range(n_ref):
            bmap = bins[tid]
            out.append(struct.pack("<i", len(bmap)))
            for bin_id in sorted(bmap):
                chunks = bmap[bin_id]
                out.append(struct.pack("<Ii", bin_id, len(chunks)))
                for cbeg, cend in chunks:
                    out.append(struct.pack("<QQ", cbeg, cend))
            imap = intervals[tid]
            n_intv = (max(imap) + 1) if imap else 0
            out.append(struct.pack("<i", n_intv))
            # fill linear index: windows without their own offset inherit
            # the previous window's (htslib convention).
            prev = 0
            for win in range(n_intv):
                prev = imap.get(win, prev)
                out.append(struct.pack("<Q", prev))
        bai_path = bai_path or bam_path + ".bai"
        with open(bai_path, "wb") as fh:
            fh.write(b"".join(out))
        return bai_path


class BamWriter:
    """Write BAM files (optionally sorting records and indexing)."""

    def __init__(self, path: str, references: Sequence[Tuple[str, int]],
                 header_text: Optional[str] = None, level: int = 6):
        self.path = path
        self.references = list(references)
        if header_text is None:
            lines = ["@HD\tVN:1.6\tSO:coordinate"]
            lines += [
                "@SQ\tSN:{}\tLN:{}".format(n, l) for n, l in self.references]
            header_text = "\n".join(lines) + "\n"
        self._bgzf = BgzfWriter(path, level=level)
        text = header_text.encode()
        self._bgzf.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
        self._bgzf.write(struct.pack("<i", len(self.references)))
        for name, length in self.references:
            nb = name.encode() + b"\x00"
            self._bgzf.write(struct.pack("<i", len(nb)) + nb +
                             struct.pack("<i", length))

    def write(self, rec: BamRecord):
        """Append one record."""
        self._bgzf.write(struct.pack("<i", len(rec.raw)) + rec.raw)

    def close(self):
        """Finish the BGZF stream."""
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_bam(path: str, records: Iterable[BamRecord],
              references: Sequence[Tuple[str, int]],
              header_text: Optional[str] = None, sort: bool = True,
              index: bool = True) -> str:
    """Write (and by default sort + index) a BAM file."""
    records = list(records)
    if sort:
        records.sort(key=lambda r: (
            r.ref_id if r.ref_id >= 0 else 1 << 30, r.pos))
    with BamWriter(path, references, header_text) as writer:
        for rec in records:
            writer.write(rec)
    if index and sort:
        BaiIndex.build(path)
    return path
