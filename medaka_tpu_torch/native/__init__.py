"""Native (C++) host-side helpers of the consensus and variant paths.

Counterpart of ``medaka_tpu/native/__init__.py``, trimmed to the entry
points the port uses: affine-gap pairwise alignment (:func:`align`,
:func:`edit_distance`), the partial-order-alignment consensus
(:func:`poa_consensus`, ``poa.cpp``, of the smolecule and tandem
workflows), the read mapper (:class:`Mapper`), the pileup kernel
(:func:`pileup_counts_raw`, :func:`counts_norm_total`), the read-level
matrix (:func:`read_matrix_raw`), the BAM record scan
(:func:`bam_scan_filter`), multi-threaded BGZF inflation (``bgzf_*``)
and the LZF codec of HDF5 filter 32000 (:func:`lzf_compress`,
:func:`lzf_decompress`, ``lzf.cpp``). The shared library is built on first use with g++ from
``src/`` into ``_libmtt_<source hash>.so`` beside this file; a failed
build raises :class:`NativeBuildError`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_SOURCES = ("align.cpp", "poa.cpp", "mapper.cpp", "pileup.cpp", "bgzf.cpp",
            "bam_scan.cpp", "read_matrix.cpp", "lzf.cpp")
_LOCK = threading.Lock()
_LIB = None


class NativeBuildError(RuntimeError):
    """Raised when the native library cannot be built or loaded."""


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_SRC_DIR, name), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _build() -> str:
    out = os.path.abspath(os.path.join(
        _SRC_DIR, "..", "_libmtt_{}.so".format(_source_hash())))
    if os.path.exists(out):
        return out
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    tmp = "{}.{}.tmp".format(out, os.getpid())
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, *srcs,
           "-lz", "-lpthread"]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, text=True, timeout=300)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired) as e:
        stderr = getattr(e, "stderr", "")
        raise NativeBuildError(
            "Failed to build native library: {}\n{}".format(e, stderr))
    os.replace(tmp, out)
    return out


class _MtAlignment(ctypes.Structure):
    _fields_ = [
        ("score", ctypes.c_int32),
        ("ref_start", ctypes.c_int32),
        ("ref_end", ctypes.c_int32),
        ("query_start", ctypes.c_int32),
        ("query_end", ctypes.c_int32),
        ("cigar", ctypes.c_void_p),
    ]


_LOAD_ERROR = None


def _load():
    global _LIB, _LOAD_ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _LOAD_ERROR is not None:
            # don't re-run a failing g++ compile (up to 300 s) on
            # every call from the featurization hot loop
            raise NativeBuildError(
                "Native library unavailable (cached): {}".format(
                    _LOAD_ERROR))
        try:
            so_path = _build()
        except NativeBuildError as e:
            _LOAD_ERROR = e
            raise
        lib = ctypes.CDLL(so_path)
        lib.mt_align.restype = ctypes.c_int
        lib.mt_align.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(_MtAlignment)]
        lib.mt_edit_distance.restype = ctypes.c_int
        lib.mt_edit_distance.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int]
        lib.mt_poa_consensus.restype = ctypes.c_int
        lib.mt_poa_consensus.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        lib.mt_free.restype = None
        lib.mt_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


MODES = {"nw": 0, "hw": 1, "sw": 2, "shw": 3}


@dataclasses.dataclass
class Alignment:
    """Result of a pairwise alignment."""

    score: int
    cigar: str
    ref_start: int
    ref_end: int
    query_start: int
    query_end: int


def align(query: str, ref: str, mode: str = "nw", match: int = 2,
          mismatch: int = 4, gap_open: int = 4, gap_extend: int = 2,
          band: int = 0) -> Alignment:
    """Affine-gap pairwise alignment.

    :param mode: 'nw' global, 'hw' query-global/ref-free ends (infix),
        'sw' local, 'shw' ref-start anchored with free ref end (prefix).
    :param band: net diagonal drift bound; 0 = full DP.
    """
    lib = _load()
    res = _MtAlignment()
    q = query.encode()
    r = ref.encode()
    rv = lib.mt_align(
        q, len(q), r, len(r), match, mismatch, gap_open, gap_extend,
        MODES[mode], band, ctypes.byref(res))
    if rv != 0:
        raise NativeBuildError("mt_align failed")
    cigar = ctypes.cast(res.cigar, ctypes.c_char_p).value or b""
    lib.mt_free(res.cigar)
    return Alignment(
        score=res.score, cigar=cigar.decode(),
        ref_start=res.ref_start, ref_end=res.ref_end,
        query_start=res.query_start, query_end=res.query_end)


def edit_distance(a: str, b: str, max_k: int = -1) -> int:
    """Unit-cost edit distance (banded, band-doubling); -1 if > max_k."""
    lib = _load()
    ab = a.encode()
    bb = b.encode()
    return lib.mt_edit_distance(ab, len(ab), bb, len(bb), max_k)


def poa_consensus(seqs: Sequence[str], match: int = 2, mismatch: int = 4,
                  gap: int = 4) -> str:
    """Partial-order-alignment consensus of sequences (the heaviest path
    by edge support; ``""`` for none). Holds no state between calls, so
    threads may run it at once (ctypes releases the GIL)."""
    if not seqs:
        return ""
    lib = _load()
    enc = [s.encode() for s in seqs]
    arr = (ctypes.c_char_p * len(enc))(*enc)
    lens = (ctypes.c_int * len(enc))(*[len(s) for s in enc])
    cap = 2 * max(len(s) for s in enc) + 16
    out = ctypes.create_string_buffer(cap)
    n = lib.mt_poa_consensus(
        arr, lens, len(enc), match, mismatch, gap, out, cap)
    if n < 0:
        raise NativeBuildError("mt_poa_consensus failed")
    return out.value.decode()


def available() -> bool:
    """True when the native library can be built/loaded."""
    try:
        _load()
        return True
    except NativeBuildError:
        return False


# ---------------------------------------------------------------------------
# Read mapper (minimap2-lite; replaces mini_align/minimap2)
# ---------------------------------------------------------------------------


class _MtMapping(ctypes.Structure):
    _fields_ = [
        ("ref_id", ctypes.c_int32),
        ("ref_start", ctypes.c_int32),
        ("flag", ctypes.c_int32),
        ("score", ctypes.c_int32),
        ("query_start", ctypes.c_int32),
        ("query_end", ctypes.c_int32),
        ("mapq", ctypes.c_int32),
        ("cigar", ctypes.c_void_p),
    ]


@dataclasses.dataclass
class Mapping:
    """A read-to-reference mapping."""

    ref_id: int
    ref_start: int
    flag: int            # 0 fwd, 16 rev; | 2048 for supplementary
    score: int
    query_start: int     # clip on the oriented query
    query_end: int
    cigar: str           # aligned portion, no clips
    mapq: int = 60       # 0-60 confidence (gap over competing chains)

    @property
    def is_supplementary(self) -> bool:
        """Whether this is a supplementary (split-read) mapping."""
        return bool(self.flag & 2048)


def _load_mapper_symbols(lib):
    if getattr(lib, "_mapper_ready", False):
        return
    lib.mt_index_create.restype = ctypes.c_void_p
    lib.mt_index_create.argtypes = []
    lib.mt_index_add.restype = None
    lib.mt_index_add.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.mt_index_destroy.restype = None
    lib.mt_index_destroy.argtypes = [ctypes.c_void_p]
    lib.mt_map_multi.restype = ctypes.c_int
    lib.mt_map_multi.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_MtMapping), ctypes.c_int]
    lib._mapper_ready = True


class Mapper:
    """Minimizer index + banded-extension mapper over a reference set."""

    def __init__(self, references):
        """:param references: iterable of (name, sequence)."""
        self._lib = _load()
        _load_mapper_symbols(self._lib)
        self._handle = self._lib.mt_index_create()
        self.names = []
        self.lengths = []
        for name, seq in references:
            self.names.append(name)
            self.lengths.append(len(seq))
            s = seq.encode()
            self._lib.mt_index_add(self._handle, name.encode(), s, len(s))

    def map(self, seq: str, band: int = 500) -> Optional[Mapping]:
        """Primary mapping of a read (None when unmapped)."""
        hits = self.map_all(seq, band=band, max_mappings=1)
        return hits[0] if hits else None

    def map_all(self, seq: str, band: int = 500,
                max_mappings: int = 4) -> List[Mapping]:
        """All mappings of a read: primary first, then supplementary.

        Supplementary mappings (flag 2048) cover query intervals the
        primary does not (split/chimeric reads). Every mapping carries a
        minimap2-style ``mapq`` in [0, 60]; repetitive placements score
        0 so downstream ``min_mapq`` filters drop them.
        """
        res = (_MtMapping * max_mappings)()
        q = seq.encode()
        n = self._lib.mt_map_multi(
            self._handle, q, len(q), band, res, max_mappings)
        if n < 0:
            raise NativeBuildError("mt_map_multi failed")
        hits = []
        for i in range(n):
            cigar = ctypes.cast(res[i].cigar, ctypes.c_char_p).value or b""
            self._lib.mt_free(res[i].cigar)
            hits.append(Mapping(
                ref_id=res[i].ref_id, ref_start=res[i].ref_start,
                flag=res[i].flag, score=res[i].score,
                query_start=res[i].query_start,
                query_end=res[i].query_end, cigar=cigar.decode(),
                mapq=res[i].mapq))
        return hits

    def close(self):
        """Free the native index."""
        if self._handle:
            self._lib.mt_index_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Pileup counting kernel (native medaka_counts.c equivalent)
# ---------------------------------------------------------------------------


def _load_pileup_raw_symbols(lib):
    if getattr(lib, "_pileup_raw_ready", False):
        return
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.mt_pileup_counts_raw.restype = ctypes.c_int
    lib.mt_pileup_counts_raw.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,                     # records
        i64p,                                # rec_off
        ctypes.POINTER(ctypes.c_int32),      # read_dtype
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),   # counts
        ctypes.POINTER(i64p), ctypes.POINTER(i64p),       # majors, minors
        i64p,
    ]
    lib._pileup_raw_ready = True


def counts_norm_total(counts, minors):
    """Native "total" normalisation: (features f32, depth i64).

    Mirrors the numpy post-process in
    ``features._post_process_pileup`` for ``normalise='total'``.
    """
    import numpy as np

    lib = _load()
    if not getattr(lib, "_norm_ready", False):
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.mt_counts_norm_total.restype = ctypes.c_int
        lib.mt_counts_norm_total.argtypes = [
            ctypes.POINTER(ctypes.c_int32), i64p,
            ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), i64p]
        lib._norm_ready = True
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    minors = np.ascontiguousarray(minors, dtype=np.int64)
    n_cols, col_feat = counts.shape
    feats = np.empty((n_cols, col_feat), np.float32)
    depth = np.empty(n_cols, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.mt_counts_norm_total(
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        minors.ctypes.data_as(i64p), n_cols, col_feat,
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        depth.ctypes.data_as(i64p))
    return feats, depth


def _load_bam_scan_symbols(lib):
    if getattr(lib, "_bam_scan_ready", False):
        return
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.mt_bam_scan_filter.restype = ctypes.c_int64
    lib.mt_bam_scan_filter.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,     # payload, payload_len
        i64p, i64p, ctypes.c_int,            # seg_start, seg_end, n_seg
        ctypes.c_int32,                      # tid
        ctypes.c_int64, ctypes.c_int64,      # start, end
        ctypes.c_int,                        # min_mapq
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,  # tag filter
        ctypes.c_char_p,                     # read_group
        i64p, ctypes.c_int64,                # rec_off_out, cap
    ]
    lib._bam_scan_ready = True


class LongCigarInPayload(Exception):
    """A record in the scanned span carries a CG-style long cigar."""


def bam_scan_filter(payload, seg_start, seg_end, tid, start, end,
                    min_mapq=1, tag_name=None, tag_value=0,
                    keep_missing=False, read_group=None):
    """Filtered record offsets within an inflated BAM payload.

    ``payload`` holds inflated BGZF bytes; ``seg_start``/``seg_end``
    bound the record windows (payload offsets) of the region's index
    chunks. Returns int64 payload offsets of each passing record's
    refID field — the layout :func:`pileup_counts_raw` consumes directly.

    :raises LongCigarInPayload: when a passing record uses the CG
        long-cigar encoding (caller falls back to the Python parser).
    """
    import numpy as np

    lib = _load()
    _load_bam_scan_symbols(lib)
    i64p = ctypes.POINTER(ctypes.c_int64)
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    seg_start = np.ascontiguousarray(seg_start, dtype=np.int64)
    seg_end = np.ascontiguousarray(seg_end, dtype=np.int64)
    # smallest possible record is 4 (block_size) + 32 (fixed) + 1 byte
    cap = max(1, int(payload.size) // 37 + 1)
    rec_off = np.empty(cap, np.int64)
    n = lib.mt_bam_scan_filter(
        payload.ctypes.data_as(ctypes.c_char_p), payload.size,
        seg_start.ctypes.data_as(i64p), seg_end.ctypes.data_as(i64p),
        len(seg_start), tid, start, end, min_mapq,
        tag_name.encode() if tag_name else None, tag_value,
        int(keep_missing),
        read_group.encode() if read_group is not None else None,
        rec_off.ctypes.data_as(i64p), cap)
    if n == -2:
        raise LongCigarInPayload()
    if n < 0:
        raise NativeBuildError("malformed BAM record framing in scan")
    return rec_off[:n].copy()


def _load_bgzf_symbols(lib):
    if getattr(lib, "_bgzf_ready", False):
        return
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.mt_bgzf_scan.restype = ctypes.c_int64
    lib.mt_bgzf_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i64p, i32p, i32p, ctypes.c_int64]
    lib.mt_bgzf_inflate_many.restype = ctypes.c_int
    lib.mt_bgzf_inflate_many.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, i64p, i32p, i32p, i64p,
        ctypes.c_void_p, ctypes.c_int]
    lib._bgzf_ready = True


def bgzf_scan_range(data, offset: int, limit: int):
    """Scan BGZF member headers in [offset, limit) without inflating.

    :returns: (member compressed offsets int64[n], compressed sizes
        int32[n], inflated sizes int32[n], payload offsets int64[n+1]).
    """
    import numpy as np

    lib = _load()
    _load_bgzf_symbols(lib)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    src = np.frombuffer(data, dtype=np.uint8)
    limit = min(limit, src.size)
    # 28 bytes is the smallest legal member (the EOF marker)
    cap = max(1, (limit - offset) // 28 + 2)
    coffs = np.empty(cap, np.int64)
    bsizes = np.empty(cap, np.int32)
    isizes = np.empty(cap, np.int32)
    n = lib.mt_bgzf_scan(
        src.ctypes.data_as(ctypes.c_void_p), src.size, offset, limit,
        coffs.ctypes.data_as(i64p), bsizes.ctypes.data_as(i32p),
        isizes.ctypes.data_as(i32p), cap)
    if n < 0:
        raise NativeBuildError("malformed BGZF framing in scan")
    coffs, bsizes, isizes = coffs[:n], bsizes[:n], isizes[:n]
    payload_offs = np.zeros(n + 1, np.int64)
    np.cumsum(isizes, out=payload_offs[1:])
    return coffs, bsizes, isizes, payload_offs


def bgzf_inflate_into(data, coffs, bsizes, isizes, payload_offs, out,
                      out_base: int = 0, nthreads: int = 4):
    """Inflate pre-scanned members into ``out`` at ``out_base``.

    Lets callers assemble multiple scanned spans into one buffer with
    zero copies (the old concatenate of per-span payloads cost more
    than the inflate itself on multi-chunk regions).
    """
    import numpy as np

    lib = _load()
    _load_bgzf_symbols(lib)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = len(coffs)
    if not n:
        return
    if out_base + int(payload_offs[-1]) > out.size:
        raise ValueError("inflate target overflows output buffer")
    src = np.frombuffer(data, dtype=np.uint8)
    dst = ctypes.c_void_p(out.ctypes.data + out_base)
    if lib.mt_bgzf_inflate_many(
            src.ctypes.data_as(ctypes.c_void_p), n,
            np.ascontiguousarray(coffs).ctypes.data_as(i64p),
            np.ascontiguousarray(bsizes).ctypes.data_as(i32p),
            np.ascontiguousarray(isizes).ctypes.data_as(i32p),
            np.ascontiguousarray(payload_offs).ctypes.data_as(i64p),
            dst, nthreads) != 0:
        raise NativeBuildError("corrupt BGZF member payload")


def bgzf_inflate_range(data, offset: int, limit: int, nthreads: int = 4):
    """Scan + multi-thread-inflate the BGZF members in [offset, limit).

    :param data: buffer holding the compressed file (bytes/mmap).
    :returns: (payload uint8 array, member compressed offsets int64[n],
        payload offsets int64[n+1], compressed offset after the last
        member) — member i's payload is
        ``payload[payload_offs[i]:payload_offs[i + 1]]``.
    """
    import numpy as np

    coffs, bsizes, isizes, payload_offs = bgzf_scan_range(
        data, offset, limit)
    out = np.empty(int(payload_offs[-1]), np.uint8)
    bgzf_inflate_into(
        data, coffs, bsizes, isizes, payload_offs, out,
        nthreads=nthreads)
    n = len(coffs)
    next_off = int(coffs[-1] + bsizes[-1]) if n else offset
    return out, coffs, payload_offs, next_off


def pileup_counts_raw(records: bytes, rec_off, read_dtype, start, end,
                      num_dtypes, num_qstrat):
    """Native pileup directly over concatenated raw BAM record bytes."""
    import numpy as np

    lib = _load()
    _load_pileup_raw_symbols(lib)
    i64p = ctypes.POINTER(ctypes.c_int64)
    counts_p = ctypes.POINTER(ctypes.c_int32)()
    majors_p, minors_p = i64p(), i64p()
    n_cols = ctypes.c_int64()
    rec_off = np.ascontiguousarray(rec_off, dtype=np.int64)
    read_dtype = np.ascontiguousarray(read_dtype, dtype=np.int32)
    if isinstance(records, np.ndarray):
        records = records.ctypes.data_as(ctypes.c_char_p)
    rv = lib.mt_pileup_counts_raw(
        len(rec_off) - 1, records,
        rec_off.ctypes.data_as(i64p),
        read_dtype.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        start, end, num_dtypes, num_qstrat,
        ctypes.byref(counts_p), ctypes.byref(majors_p),
        ctypes.byref(minors_p), ctypes.byref(n_cols))
    if rv != 0:
        raise NativeBuildError("mt_pileup_counts_raw failed")
    n = n_cols.value
    col_feat = 10 * num_dtypes * num_qstrat
    if n == 0:
        return (np.empty((0, col_feat), np.int32),
                np.empty(0, np.int64), np.empty(0, np.int64))
    return (_adopt(lib, counts_p, (n, col_feat)),
            _adopt(lib, majors_p, (n,)), _adopt(lib, minors_p, (n,)))


def _adopt(lib, ptr, shape):
    """A numpy view of a malloc'd native array, freed with the view."""
    import weakref

    import numpy as np
    arr = np.ctypeslib.as_array(ptr, shape=shape)
    weakref.finalize(arr, lib.mt_free, ctypes.cast(ptr, ctypes.c_void_p).value)
    return arr


# ---------------------------------------------------------------------------
# Read-level feature matrix (native medaka_read_matrix.c equivalent)
# ---------------------------------------------------------------------------


def _load_read_matrix_symbols(lib):
    if getattr(lib, "_read_matrix_ready", False):
        return
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.mt_read_matrix_raw.restype = ctypes.c_int
    lib.mt_read_matrix_raw.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,                 # records
        i64p,                            # rec_off
        i32p,                            # read_dtype
        i8p,                             # read_hap
        i8p,                             # dwells
        i64p,                            # dwell_off
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(i8p), ctypes.POINTER(i64p), ctypes.POINTER(i64p),
        i64p, i32p,
        ctypes.POINTER(i32p), ctypes.POINTER(i32p),
    ]
    lib._read_matrix_ready = True


def read_matrix_raw(records: bytes, rec_off, read_dtype, read_hap,
                    dwells, dwell_off, start, end, num_dtypes,
                    include_dwells, include_hap, row_per_read, max_reads):
    """Native read-level feature matrix over raw BAM record bytes.

    :param records: concatenated records, each without its leading
        ``block_size`` field; ``rec_off`` holds the n+1 offsets.
    :param dwells: concatenated per-base dwells of the reads that have
        them; ``dwell_off`` is each read's offset into it (-1: none).
    :returns: (matrix (n_cols, n_rows, featlen) int8, majors, minors,
        left_rows, right_rows): the boundary arrays give the read index
        occupying each row at the first/last covered position (-1 none).
    :raises NativeBuildError: when the library fails to build or the
        native call fails.
    """
    import numpy as np

    lib = _load()
    _load_read_matrix_symbols(lib)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    matrix_p = i8p()
    majors_p, minors_p = i64p(), i64p()
    left_p, right_p = i32p(), i32p()
    n_cols = ctypes.c_int64()
    n_rows = ctypes.c_int32()
    rec_off = np.ascontiguousarray(rec_off, dtype=np.int64)
    read_dtype = np.ascontiguousarray(read_dtype, dtype=np.int32)
    read_hap = np.ascontiguousarray(read_hap, dtype=np.int8)
    dwells = np.ascontiguousarray(dwells, dtype=np.int8)
    dwell_off = np.ascontiguousarray(dwell_off, dtype=np.int64)
    rv = lib.mt_read_matrix_raw(
        len(rec_off) - 1, records,
        rec_off.ctypes.data_as(i64p),
        read_dtype.ctypes.data_as(i32p),
        read_hap.ctypes.data_as(i8p),
        dwells.ctypes.data_as(i8p),
        dwell_off.ctypes.data_as(i64p),
        start, end, num_dtypes, int(include_dwells), int(include_hap),
        int(row_per_read), max_reads,
        ctypes.byref(matrix_p), ctypes.byref(majors_p),
        ctypes.byref(minors_p), ctypes.byref(n_cols),
        ctypes.byref(n_rows), ctypes.byref(left_p), ctypes.byref(right_p))
    if rv != 0:
        raise NativeBuildError("mt_read_matrix_raw failed")
    featlen = (4 + int(include_dwells) + int(include_hap)
               + int(num_dtypes > 1))
    nc, nr = n_cols.value, n_rows.value
    if nc == 0 or nr == 0:
        return (np.empty((0, 0, featlen), np.int8),
                np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.int32), np.empty(0, np.int32))
    return (_adopt(lib, matrix_p, (nc, nr, featlen)),
            _adopt(lib, majors_p, (nc,)), _adopt(lib, minors_p, (nc,)),
            _adopt(lib, left_p, (nr,)), _adopt(lib, right_p, (nr,)))


def _load_lzf_symbols(lib):
    if getattr(lib, "_lzf_ready", False):
        return
    for fn in (lib.mt_lzf_compress, lib.mt_lzf_decompress):
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64]
    lib._lzf_ready = True


def lzf_compress(data: bytes) -> bytes:
    """``data`` as an LZF stream (empty for empty ``data``); it may be
    longer than ``data``, by at most a byte every 32."""
    lib = _load()
    _load_lzf_symbols(lib)
    data = bytes(data)
    if not data:
        return b""
    # the worst case: every byte a literal, a control byte every 32
    cap = len(data) + len(data) // 32 + 1
    out = ctypes.create_string_buffer(cap)
    n = lib.mt_lzf_compress(data, len(data), out, cap)
    if n <= 0:
        raise RuntimeError("LZF stream of {} bytes overran {} bytes".format(
            len(data), cap))
    return out.raw[:n]


def lzf_decompress(data: bytes, size: int) -> bytes:
    """The ``size`` bytes an LZF stream holds; raises ``ValueError`` when
    the stream is corrupt or does not hold exactly ``size`` bytes."""
    lib = _load()
    _load_lzf_symbols(lib)
    data = bytes(data)
    out = ctypes.create_string_buffer(max(1, size))
    n = lib.mt_lzf_decompress(data, len(data), out, size)
    if n == -1:
        raise ValueError("corrupt LZF stream")
    if n != size:
        raise ValueError("LZF stream holds {} bytes, not {}".format(
            "more than {}".format(size) if n == -2 else n, size))
    return out.raw[:size]
