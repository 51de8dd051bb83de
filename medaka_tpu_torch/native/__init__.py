"""Native (C++) host-side helpers of the counts path.

Counterpart of ``medaka_tpu/native/__init__.py``, trimmed to the entry
points the counts consensus path uses: the pileup kernel
(:func:`pileup_counts_raw`, :func:`counts_norm_total`), the BAM record
scan (:func:`bam_scan_filter`) and multi-threaded BGZF inflation
(``bgzf_*``). The shared library is built on first use with g++ from
``src/`` into ``_libmtt_<source hash>.so`` beside this file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_SOURCES = ("pileup.cpp", "bgzf.cpp", "bam_scan.cpp")
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
        lib.mt_free.restype = None
        lib.mt_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


def available() -> bool:
    """True when the native library can be built/loaded."""
    try:
        _load()
        return True
    except NativeBuildError:
        return False


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

    def adopt(ptr, shape):
        import weakref
        arr = np.ctypeslib.as_array(ptr, shape=shape)
        addr = ctypes.cast(ptr, ctypes.c_void_p).value
        weakref.finalize(arr, lib.mt_free, addr)
        return arr

    return (adopt(counts_p, (n, col_feat)), adopt(majors_p, (n,)),
            adopt(minors_p, (n,)))
