"""BGZF (blocked gzip) codec (counterpart of ``medaka_tpu/io/bgzf.py``).

Implements the BGZF framing from the SAM spec (section 4.1): a BGZF file is
a series of gzip members, each carrying a ``BC`` extra subfield recording the
compressed block size, terminated by a fixed 28-byte EOF member. Virtual file
offsets pack (compressed_offset << 16 | within_block_offset).

This replaces htslib's bgzf.c in the reference tool chain; written from the
format specification, not from htslib.
"""
from __future__ import annotations

import os
import struct
import zlib

# Fixed EOF marker from the SAM spec.
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

MAX_BLOCK_UNCOMPRESSED = 65280


class BgzfError(ValueError):
    """Malformed BGZF stream."""


def _parse_block_header(data: bytes, offset: int):
    """Return (block_size, xlen) for a BGZF member starting at ``offset``."""
    if data[offset:offset + 2] != b"\x1f\x8b":
        raise BgzfError("Not a gzip member at offset {}".format(offset))
    flg = data[offset + 3]
    if not flg & 4:
        raise BgzfError("gzip member without FEXTRA; not BGZF")
    xlen = struct.unpack_from("<H", data, offset + 10)[0]
    # scan extra subfields for BC
    pos = offset + 12
    end = pos + xlen
    bsize = None
    while pos + 4 <= end:
        si1, si2, slen = data[pos], data[pos + 1], struct.unpack_from(
            "<H", data, pos + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2:
            bsize = struct.unpack_from("<H", data, pos + 4)[0] + 1
        pos += 4 + slen
    if bsize is None:
        raise BgzfError("BGZF BC subfield missing")
    return bsize, xlen


def decompress_block(data: bytes, offset: int):
    """Decompress one BGZF block.

    :returns: (payload bytes, offset of next block)
    """
    bsize, xlen = _parse_block_header(data, offset)
    cdata_start = offset + 12 + xlen
    cdata_end = offset + bsize - 8
    isize = struct.unpack_from("<I", data, offset + bsize - 4)[0]
    payload = zlib.decompress(
        data[cdata_start:cdata_end], wbits=-15, bufsize=max(isize, 1))
    return payload, offset + bsize


def is_bgzf(path: str) -> bool:
    """Cheap test whether a file looks like BGZF."""
    with open(path, "rb") as fh:
        head = fh.read(18)
    if len(head) < 18 or head[:2] != b"\x1f\x8b" or not head[3] & 4:
        return False
    return head[12] == 66 and head[13] == 67


class BgzfReader:
    """Random-access reader over a BGZF file.

    The whole compressed file is mmap-read once; blocks are decompressed
    on demand and cached (most recent only) which suits both sequential
    scans and index-driven region jumps.  A caller expecting to walk a
    span sequentially (a region fetch, a full scan) should :meth:`prefetch`
    it first: the span's blocks are then inflated in one multi-threaded
    native pass (in capped windows) instead of serially per block — the
    dominant cost of BAM region fetches.
    """

    #: compressed bytes inflated per native pass; bounds prefetch memory
    PREFETCH_WINDOW = 32 << 20

    def __init__(self, path: str):
        import mmap
        self._fh = open(path, "rb")
        try:
            self._data = mmap.mmap(
                self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # zero-length file cannot be mmapped
            self._data = b""
        self._block_offset = 0       # compressed offset of current block
        self._payload = b""
        self._payload_pos = 0
        self._next_offset = 0
        self._cache = {}             # coffset -> (payload view, next coffset)
        self._hint_end = 0           # prefetch ahead while coffset < this
        self._nthreads = int(os.environ.get(
            "MEDAKA_TPU_INFLATE_THREADS",
            min(4, os.cpu_count() or 1)))
        self._load_block(0)

    def prefetch(self, vo_start: int, vo_end: int):
        """Hint that the virtual range [vo_start, vo_end] will be read.

        Inflates the first window immediately; `_load_block` keeps
        inflating subsequent windows as the cursor advances through the
        hinted range.  A no-op when the native library is unavailable.
        """
        self._hint_end = min((vo_end >> 16) + 1, len(self._data))
        self._prefetch_from(vo_start >> 16)

    def _prefetch_from(self, coffset: int):
        from medaka_tpu_torch import native
        limit = min(self._hint_end, coffset + self.PREFETCH_WINDOW)
        try:
            payload, coffs, poffs, nxt = native.bgzf_inflate_range(
                self._data, coffset, limit, self._nthreads)
        except Exception:
            self._hint_end = 0  # fall back to the serial path for good
            return
        view = memoryview(payload)
        cache = {}
        last = len(coffs) - 1
        for i, c in enumerate(coffs):
            cache[int(c)] = (
                view[poffs[i]:poffs[i + 1]],
                int(coffs[i + 1]) if i < last else nxt)
        self._cache = cache

    def _load_block(self, coffset: int):
        cached = self._cache.get(coffset)
        if cached is None and coffset < self._hint_end:
            self._prefetch_from(coffset)
            cached = self._cache.get(coffset)
        if cached is not None:
            self._block_offset = coffset
            self._payload, self._next_offset = cached
            self._payload_pos = 0
            return
        if coffset >= len(self._data) or (
                len(self._data) - coffset <= len(BGZF_EOF) and
                self._data[coffset:] == BGZF_EOF):
            self._block_offset = coffset
            self._payload = b""
            self._payload_pos = 0
            self._next_offset = len(self._data)
            return
        payload, nxt = decompress_block(self._data, coffset)
        self._block_offset = coffset
        self._payload = payload
        self._payload_pos = 0
        self._next_offset = nxt

    @property
    def eof(self) -> bool:
        """True when no more payload bytes are available."""
        return (self._payload_pos >= len(self._payload) and
                self._next_offset >= len(self._data))

    def tell_virtual(self) -> int:
        """Return the BGZF virtual offset of the read cursor."""
        if self._payload_pos == len(self._payload) and not self.eof:
            return self._next_offset << 16
        return (self._block_offset << 16) | self._payload_pos

    def seek_virtual(self, voffset: int):
        """Seek to a BGZF virtual offset."""
        coffset, uoffset = voffset >> 16, voffset & 0xFFFF
        if coffset != self._block_offset or uoffset > len(self._payload):
            self._load_block(coffset)
        if uoffset > len(self._payload):
            # a within-block offset past the payload (corrupt index)
            # must fail loudly — read() would otherwise compute a
            # negative remainder and return bytes from later blocks
            raise BgzfError(
                "Virtual offset {}:{} is beyond the {}-byte block "
                "payload.".format(coffset, uoffset, len(self._payload)))
        self._payload_pos = uoffset

    def read(self, n: int) -> bytes:
        """Read exactly ``n`` payload bytes (fewer only at EOF)."""
        out = []
        need = n
        while need > 0:
            avail = len(self._payload) - self._payload_pos
            if avail == 0:
                if self._next_offset >= len(self._data):
                    break
                self._load_block(self._next_offset)
                continue
            take = min(avail, need)
            out.append(
                self._payload[self._payload_pos:self._payload_pos + take])
            self._payload_pos += take
            need -= take
        return b"".join(out)

    def prefetch_all(self, voffset: int = 0):
        """Hint a scan from ``voffset`` to the end of the file.

        Windows are still inflated ``PREFETCH_WINDOW`` bytes at a time
        as the reader advances; this only sets the end hint.
        """
        self.prefetch(voffset, len(self._data) << 16)

    def close(self):
        """Release the mapping, the block cache and the underlying file."""
        if not isinstance(self._data, bytes):
            self._data.close()
        self._data = b""
        self._payload = b""
        # drop the prefetch cache: it can pin a full window (~200 MB
        # decompressed) and would otherwise serve stale blocks instead
        # of EOF after close
        self._cache = {}
        self._hint_end = 0
        if getattr(self, "_fh", None) is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BgzfWriter:
    """Streaming BGZF writer producing spec-compliant blocks + EOF marker."""

    def __init__(self, path_or_fh, level: int = 6):
        if isinstance(path_or_fh, (str, bytes)):
            self._fh = open(path_or_fh, "wb")
            self._owns = True
        else:
            self._fh = path_or_fh
            self._owns = False
        self._level = level
        self._buf = bytearray()
        self._coffset = 0
        self._closed = False

    def tell_virtual(self) -> int:
        """Virtual offset where the next byte written will land."""
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes):
        """Buffer payload bytes, flushing full blocks."""
        self._buf.extend(data)
        while len(self._buf) >= MAX_BLOCK_UNCOMPRESSED:
            self._emit(bytes(self._buf[:MAX_BLOCK_UNCOMPRESSED]))
            del self._buf[:MAX_BLOCK_UNCOMPRESSED]

    def flush_block(self):
        """Force out any buffered payload as a (short) block."""
        if self._buf:
            self._emit(bytes(self._buf))
            self._buf.clear()

    def _emit(self, payload: bytes):
        comp = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = comp.compress(payload) + comp.flush()
        bsize = len(cdata) + 25 + 1  # header(12) + extra(6) + crc/isize(8)
        header = struct.pack(
            "<4BIBBHBBHH", 0x1f, 0x8b, 8, 4, 0, 0, 0xff, 6,
            66, 67, 2, bsize - 1)
        footer = struct.pack(
            "<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
        block = header + cdata + footer
        self._fh.write(block)
        self._coffset += len(block)

    def close(self):
        """Flush, append the EOF marker and close the file."""
        if self._closed:
            return
        self.flush_block()
        self._fh.write(BGZF_EOF)
        if self._owns:
            self._fh.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
