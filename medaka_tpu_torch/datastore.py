"""Storage of inference samples and indexing over sample files.

Counterpart of ``medaka_tpu/datastore.py`` with the same HDF5 layout, so
a probability file written by either package stitches with the other:

- :class:`DataStore` — one HDF5 file holding ``samples/data/<name>/{...}``
  datasets plus metadata stored as JSON in the ``meta_json/`` group, read
  and written with :mod:`medaka_tpu_torch.io.hdf5` (no h5py), its samples
  optionally gzip-1 compressed as reference medaka writes them, or lzf. The
  reference's pickled metadata (``meta/``) and sample registry are read
  through :mod:`medaka_tpu_torch.compat`; where ``meta_json/`` holds a key
  too, it wins. A pickle that does not convert raises (``medaka_tpu``
  logs a warning and goes on).
- :class:`ShardedDataStore` — round-robin writer over N shard files in
  spawned writer processes, with a ``shard_files`` manifest in the base
  file that either package's :class:`DataIndex` expands.
- :class:`DataIndex` — multi-file sample registry with per-contig sorted
  iteration.

Writes are funnelled through a single background thread, mirroring the
reference's single-writer executor, so featurization threads never block on
HDF5 (reference ``datastore.py:196``).
"""
from __future__ import annotations

import concurrent.futures
import json
import os
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

import numpy as np

from medaka_tpu_torch import common
from medaka_tpu_torch.common import Region, Sample
from medaka_tpu_torch.io import hdf5


_SAMPLE_FIELDS = (
    "features", "labels", "ref_seq", "positions", "label_probs", "depth")


class DataStore:
    """Read/write access to a single sample HDF5 file."""

    _data_path_ = "samples/data"
    _meta_path_ = "meta"
    _meta_json_path_ = "meta_json"
    _registry_path_ = "samples/registry"

    def __init__(self, filename: str, mode: str = "r",
                 compression: Optional[str] = None):
        """Open an HDF5 sample store.

        :param filename: file path.
        :param mode: 'r', 'w', or 'a' (appends to an existing file: its
            samples, registry and metadata are loaded and extended).
        :param compression: None (positions are narrowed to int32/int16 on
            disk, uncompressed), 'gzip' (level 1, the reference's codec)
            or 'lzf' (h5py's filter 32000) for the samples' arrays; any
            other value raises.
        """
        if compression not in (None, "gzip", "lzf"):
            raise NotImplementedError(
                "DataStore compression {!r} is not supported (None, gzip "
                "and lzf are).".format(compression))
        self.filename = filename
        self.mode = mode
        self.compression = compression
        self.logger = common.get_named_logger("DataStore")
        self.fh = hdf5.File(filename, mode)
        self._meta: Optional[Dict] = None
        self.write_executor = None
        self._futures: List = []
        if mode != "r":
            self.write_executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        """Flush pending writes, persist metadata, close the file.

        A failed background write re-raises AFTER the executor is
        stopped and the file handle released, so a disk-full mid-run
        doesn't leak the writer thread or an open (corrupt) handle —
        and a second ``close()`` is a no-op.
        """
        write_error = None
        try:
            if self.write_executor is not None:
                for fut in self._futures:
                    try:
                        fut.result()
                    except Exception as e:  # keep draining the rest
                        if write_error is None:
                            write_error = e
                self.write_executor.shutdown(wait=True)
                self.write_executor = None
            if (write_error is None and self.mode != "r"
                    and self._meta is not None and self.fh is not None):
                self._write_metadata(self._meta)
        finally:
            if self.fh is not None:
                self.fh.close()
                self.fh = None
        if write_error is not None:
            raise write_error

    # -- metadata ----------------------------------------------------------

    @property
    def meta(self) -> Dict:
        """Metadata dict {feature_encoder, label_scheme, model_function}."""
        if self._meta is None:
            self._meta = self._load_metadata()
        return self._meta

    def set_meta(self, obj, name: str):
        """Store a metadata item under ``name``."""
        self.meta[name] = obj

    def copy_meta(self, other: "DataStore"):
        """Copy all metadata from another (open) store."""
        self._meta = dict(other.meta)

    def _load_metadata(self) -> Dict:
        meta: Dict = {}
        if self._meta_path_ in self.fh:
            from medaka_tpu_torch import compat
            grp = self.fh[self._meta_path_]
            for key in grp:
                try:
                    meta[key] = compat.convert_meta(
                        key, compat.medaka_loads(grp[key][()]))
                except Exception as e:
                    raise ValueError("{}: cannot convert the pickled "
                                     "meta/{}: {}".format(self.filename, key,
                                                          e)) from e
        # the port's JSON metadata wins over pickles where both exist
        if self._meta_json_path_ in self.fh:
            from medaka_tpu_torch import features as feat_mod
            from medaka_tpu_torch import labels as label_mod
            grp = self.fh[self._meta_json_path_]
            for key in grp:
                d = json.loads(grp[key][()].decode())
                if key == "feature_encoder":
                    meta[key] = feat_mod.from_dict(d)
                elif key == "label_scheme":
                    meta[key] = label_mod.from_dict(d)
                else:
                    meta[key] = d
        return meta

    def _write_metadata(self, data: Dict):
        self.logger.debug("Writing metadata for %s.", self.filename)
        for key, value in data.items():
            path = "{}/{}".format(self._meta_json_path_, key)
            if hasattr(value, "to_dict"):
                doc = value.to_dict()
            else:
                doc = value
            blob = np.bytes_(json.dumps(doc).encode())
            if path in self.fh:
                del self.fh[path]
            self.fh[path] = blob

    # -- samples -----------------------------------------------------------

    def write_sample(self, sample: Sample):
        """Asynchronously write a sample if not already present.

        Mirrors the idempotent-append behaviour of reference
        ``datastore.py:278-299``.
        """
        contains_numpy_array = any(
            isinstance(getattr(sample, field), np.ndarray)
            for field in _SAMPLE_FIELDS)
        if not contains_numpy_array:
            self.logger.debug("Not writing sample with no data: %s",
                              sample.name)
            return
        if sample.name in self.sample_registry:
            self.logger.debug("Sample %s already in store.", sample.name)
            return
        self.sample_registry.add(sample.name)
        self._futures.append(
            self.write_executor.submit(self._write_sample, sample))

    @staticmethod
    def _narrow_positions(value: np.ndarray) -> np.ndarray:
        """Shrink (major, minor) int64 pairs for storage when they fit.

        16 bytes/column of position data dominates the write payload;
        int32 major + int16 minor (6 bytes) round-trips losslessly for
        any contig < 2^31 and insertion runs < 2^15 (both orders of
        magnitude beyond real data; oversized inputs stay int64).
        """
        if value.dtype != common.POSITIONS_DTYPE:
            return value
        if len(value) and (value["major"].max() >= 2 ** 31
                           or value["minor"].max() >= 2 ** 15):
            return value
        narrow = np.empty(
            len(value), dtype=[("major", "<i4"), ("minor", "<i2")])
        narrow["major"] = value["major"]
        narrow["minor"] = value["minor"]
        return narrow

    def _write_sample(self, sample: Sample):
        grp = "{}/{}".format(self._data_path_, sample.name)
        for field in _SAMPLE_FIELDS:
            value = getattr(sample, field)
            if value is None:
                continue
            if field == "positions":
                value = self._narrow_positions(value)
            self.fh.create_dataset(
                "{}/{}".format(grp, field), value,
                compression=self.compression
                if isinstance(value, np.ndarray) else None)
        self.fh["{}/ref_name".format(grp)] = sample.ref_name
        self.fh.flush()

    def load_sample(self, name: str) -> Sample:
        """Load a single sample by name."""
        def convert(field, value):
            if isinstance(value, bytes):
                return value.decode()
            if field == "positions" and isinstance(value, np.ndarray) \
                    and value.dtype != common.POSITIONS_DTYPE:
                return value.astype(common.POSITIONS_DTYPE)
            return value

        grp = self.fh["{}/{}".format(self._data_path_, name)]
        fields = {k: None for k in Sample._fields}
        for field in grp:
            if field in fields:
                fields[field] = convert(field, grp[field][()])
        return Sample(**fields)

    @property
    def sample_registry(self) -> set:
        """Set of sample names stored in the file."""
        if not hasattr(self, "_sample_registry"):
            self._sample_registry = self._load_registry()
        return self._sample_registry

    def _load_registry(self) -> set:
        if self._registry_path_ in self.fh:
            blob = bytes(self.fh[self._registry_path_][()])
            try:
                return set(json.loads(blob.decode()))
            except (UnicodeDecodeError, json.JSONDecodeError):
                # the reference's pickled registry
                from medaka_tpu_torch import compat
                return set(compat.medaka_loads(blob))
        if self._data_path_ in self.fh:
            return set(self.fh[self._data_path_].keys())
        return set()

    @property
    def n_samples(self) -> int:
        """Number of samples stored."""
        return len(self.sample_registry)

    def write_registry(self):
        """Persist the sample registry (JSON)."""
        if self._registry_path_ in self.fh:
            del self.fh[self._registry_path_]
        self.fh[self._registry_path_] = np.bytes_(
            json.dumps(sorted(self.sample_registry)).encode())


def _shard_writer_main(path, compression, queue, err_queue):
    """Shard writer process (``medaka_tpu.datastore._shard_writer_main``):
    drain samples into ``path`` until the None sentinel, then report None
    or the error on ``err_queue``."""
    try:
        with DataStore(path, "a", compression=compression) as ds:
            while True:
                item = queue.get()
                if item is None:
                    ds.write_registry()
                    break
                ds.write_sample(item)
        err_queue.put(None)
    except Exception as e:
        err_queue.put("{}: {}".format(type(e).__name__, e))


class ShardedDataStore:
    """Round-robin writer over N shard files in writer processes
    (``medaka_tpu.datastore.ShardedDataStore``, the same file names,
    manifest attribute and layout).

    Sample ``k`` goes to ``{filename}.shard{k % N:02d}``, each shard
    written by its own spawned process fed over a bounded queue; the base
    file holds the metadata and a ``shard_files`` root attribute (a JSON
    list of the shards' base names) that :func:`expand_shards` expands,
    so every consumer keeps its single-path signature. The metadata is
    copied into each shard at :meth:`close`. Spawn, not fork: the caller
    holds a CUDA context. A writer that fails, or dies without reporting,
    raises at :meth:`close`.
    """

    def __init__(self, filename: str, shards: int = 2,
                 compression: Optional[str] = None):
        import multiprocessing as mp
        self.filename = filename
        self.base = DataStore(filename, "a", compression=compression)
        self.shard_names = [
            "{}.shard{:02d}".format(filename, k) for k in range(shards)]
        self.base.fh.attrs["shard_files"] = json.dumps(
            [os.path.basename(n) for n in self.shard_names])
        ctx = mp.get_context("spawn")
        self._queues = [ctx.Queue(maxsize=64) for _ in self.shard_names]
        self._err_queue = ctx.Queue()
        self._procs = [
            ctx.Process(target=_shard_writer_main,
                        args=(name, compression, q, self._err_queue),
                        daemon=True)
            for name, q in zip(self.shard_names, self._queues)]
        for p in self._procs:
            p.start()
        self._next = 0
        self._closed = False

    def set_meta(self, obj, name: str):
        """Store metadata in the base file (copied into the shards at
        close)."""
        self.base.set_meta(obj, name)

    def write_sample(self, sample: Sample):
        """Queue the sample on the next shard (round-robin); raises if
        that shard's writer has died."""
        import queue as queue_mod
        q, proc = self._queues[self._next], self._procs[self._next]
        while True:
            try:
                q.put(sample, timeout=1.0)
                break
            except queue_mod.Full:
                if not proc.is_alive():
                    raise IOError("Shard writer for {} died (exit code "
                                  "{})".format(self.shard_names[self._next],
                                               proc.exitcode))
        self._next = (self._next + 1) % len(self._queues)

    def write_registry(self):
        """No-op: each shard persists its registry at close."""

    def close(self):
        """Drain the writers, copy the metadata into each shard and close
        the base file; raise if a writer failed."""
        if self._closed:
            return
        self._closed = True
        import queue as queue_mod
        errors = []
        for q, p in zip(self._queues, self._procs):
            while p.is_alive():
                try:
                    q.put(None, timeout=1.0)
                    break
                except queue_mod.Full:
                    continue
        reports = 0
        while reports < len(self._procs):
            try:
                err = self._err_queue.get(timeout=1.0)
            except queue_mod.Empty:
                if any(p.is_alive() for p in self._procs):
                    continue
                try:   # a report may still be in the pipe
                    err = self._err_queue.get(timeout=1.0)
                except queue_mod.Empty:
                    errors.append("a shard writer exited without "
                                  "reporting")
                    break
            reports += 1
            if err is not None:
                errors.append(err)
        for p in self._procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                errors.append("shard writer hung and was terminated")
            elif p.exitcode != 0:
                errors.append("shard writer exited with code {}".format(
                    p.exitcode))
        try:
            if not errors:
                for name in self.shard_names:
                    with DataStore(name, "a") as ds:
                        ds.copy_meta(self.base)
        finally:
            self.base.close()
        if errors:
            raise IOError("Shard writer failed: {}".format(
                "; ".join(errors)))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _IndexEntry(tuple):
    """(sample_name, filename) with parsed coordinates."""

    def __new__(cls, sample_name, filename):
        return tuple.__new__(cls, (sample_name, filename))

    sample_name = property(lambda self: self[0])
    filename = property(lambda self: self[1])


def expand_shards(filenames) -> List[str]:
    """Expand shard manifests in a file list
    (``medaka_tpu.datastore.expand_shards``).

    A file written by ``medaka_tpu.datastore.ShardedDataStore`` carries a
    ``shard_files`` attribute (JSON list) naming its sibling shard files;
    it is replaced by base + shards, the shards that exist, in order.
    """
    if isinstance(filenames, str):
        filenames = [filenames]
    out: List[str] = []
    for fname in filenames:
        out.append(fname)
        try:
            with hdf5.File(fname, "r") as fh:
                names = json.loads(fh.attrs.get("shard_files", "[]"))
        except (OSError, ValueError):
            names = []
        base_dir = os.path.dirname(fname)
        for name in names:
            path = os.path.join(base_dir, name)
            if os.path.exists(path):
                out.append(path)
    return out


class DataIndex:
    """Index over samples distributed across many HDF5 files.

    Reference: ``medaka/datastore.py:363-520``.
    """

    def __getstate__(self):
        # a named logger does not pickle (spawned training ranks get the
        # batcher); it is made again on the other side
        return {k: v for k, v in self.__dict__.items() if k != "logger"}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.logger = common.get_named_logger("DataIndex")

    def __init__(self, filenames, threads: int = 4):
        """Build an index over ``filenames`` (list or single path).

        Shard-manifest files expand to their shard set
        (:func:`expand_shards`).
        """
        self.filenames = expand_shards(filenames)
        self.logger = common.get_named_logger("DataIndex")
        self._meta: Optional[Dict] = None
        self._index: Optional[Dict[str, List[_IndexEntry]]] = None
        self.samples: List = []
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=threads) as ex:
            for fname, registry in zip(
                    self.filenames,
                    ex.map(self._load_one_registry, self.filenames)):
                self.samples.extend(
                    (name, fname) for name in sorted(registry))

    @staticmethod
    def _load_one_registry(fname: str) -> set:
        with DataStore(fname, "r") as ds:
            return ds.sample_registry

    @property
    def metadata(self) -> Dict:
        """Metadata of the first file (all files share it by contract)."""
        if self._meta is None:
            with DataStore(self.filenames[0], "r") as ds:
                self._meta = dict(ds.meta)
        return self._meta

    @property
    def index(self) -> Dict[str, List[_IndexEntry]]:
        """Per-contig entries sorted by (start, -end)."""
        if self._index is None:
            index = defaultdict(list)
            for name, fname in self.samples:
                d = Sample.decode_sample_name(name)
                if d is None:
                    continue
                index[d["ref_name"]].append(
                    (float(d["start"]), -float(d["end"]),
                     _IndexEntry(name, fname)))
            self._index = {
                ref: [e for _, _, e in sorted(entries)]
                for ref, entries in index.items()}
        return self._index

    @property
    def regions(self) -> List[Region]:
        """One region per contig spanning all indexed samples.

        Unlike the reference (which returns unbounded regions,
        ``datastore.py:446-451``) the end-exclusive extent of the indexed
        samples is reported.
        """
        out = []
        for ref_name, entries in self.index.items():
            starts, ends = [], []
            for e in entries:
                d = Sample.decode_sample_name(e.sample_name)
                starts.append(int(float(d["start"])))
                ends.append(int(float(d["end"])) + 1)
            out.append(Region(ref_name, min(starts), max(ends)))
        return sorted(out)

    def max_sample_size(self) -> int:
        """Longest sample (columns) across all files, from the shapes of
        their ``positions`` datasets (no data read)."""
        longest = 0
        for fname in self.filenames:
            with hdf5.File(fname, "r") as fh:
                if DataStore._data_path_ not in fh:
                    continue
                data = fh[DataStore._data_path_]
                for name in data:
                    group = data[name]
                    if "positions" in group:
                        longest = max(longest, group["positions"].shape[0])
        return longest

    def yield_from_feature_files(
            self, regions: Optional[Iterable[Region]] = None,
            samples: Optional[Iterable] = None):
        """Yield `Sample` objects in genomic order.

        :param regions: restrict to these regions (default: everything).
        :param samples: explicit (sample_name, filename) list to load.
        """
        handles: Dict[str, DataStore] = {}

        def _get(fname):
            if fname not in handles:
                handles[fname] = DataStore(fname, "r")
            return handles[fname]

        try:
            if samples is not None:
                for name, fname in samples:
                    yield _get(fname).load_sample(name)
                return
            if regions is None:
                regions = self.regions
            for region in regions:
                for entry in self.index.get(region.ref_name, ()):
                    d = Sample.decode_sample_name(entry.sample_name)
                    start = int(float(d["start"]))
                    end = int(np.ceil(float(d["end"])))
                    rstart = region.start if region.start is not None else 0
                    rend = region.end if region.end is not None else np.inf
                    if start < rend and end > rstart:
                        yield _get(entry.filename).load_sample(
                            entry.sample_name)
        finally:
            for ds in handles.values():
                ds.close()
