"""A small HDF5 reader and writer (no h5py, no libhdf5).

Written from the HDF5 file format specification (version 0 superblock,
version 1 object headers, symbol-table groups), covering what the
probability and feature files of the datastore hold: groups, and
contiguous or compact datasets of integers, floats, fixed-length and
variable-length strings and compound types. Files it writes open in
h5py; it reads files h5py writes with its default settings. Chunked or
compressed datasets are refused.

The writer appends each dataset's raw bytes as it is created and writes
the groups' metadata (object headers, local heaps, symbol-table nodes and
B-trees) when the file is closed, so samples stream to disk. Writes from
several threads are serialised by a lock.
"""
from __future__ import annotations

import os
import struct
import threading
from typing import Dict

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
LEAF_K = 4          # symbol-table node holds up to 2 * LEAF_K entries
INTERNAL_K = 16     # group B-tree node holds up to 2 * INTERNAL_K children
_SUPERBLOCK_SIZE = 96
_LOCAL_HEAP_FREE_NULL = 1   # free-list terminator of a local heap

# message types
_NIL, _DATASPACE, _DATATYPE, _FILL = 0x0, 0x1, 0x3, 0x5
_LAYOUT, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0x8, 0xB, 0x10, 0x11


class HDF5Error(ValueError):
    """Raised for files or features outside the supported subset."""


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ---------------------------------------------------------------------------
# datatypes
# ---------------------------------------------------------------------------

_VLEN_STR = "vlen-str"


def _encode_datatype(dtype: np.dtype) -> bytes:
    """Datatype message (version 1) for a numpy dtype."""
    dtype = np.dtype(dtype)
    if dtype.byteorder == ">":
        raise HDF5Error("big-endian data is not supported")
    kind, size = dtype.kind, dtype.itemsize
    if kind in "iu":
        bits = 0x08 if kind == "i" else 0
        return struct.pack("<B3sI", 0x10, bytes([bits, 0, 0]), size) + \
            struct.pack("<HH", 0, 8 * size)
    if kind == "f":
        exp = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127),
               8: (52, 11, 52, 1023)}
        if size not in exp:
            raise HDF5Error("unsupported float size {}".format(size))
        eloc, esize, msize, bias = exp[size]
        return struct.pack("<B3sI", 0x11, bytes([0x20, 8 * size - 1, 0]),
                           size) + struct.pack(
            "<HHBBBBI", 0, 8 * size, eloc, esize, 0, msize, bias)
    if kind == "S":
        # null-padded ASCII, as h5py stores numpy "S" strings
        return struct.pack("<B3sI", 0x13, bytes([1, 0, 0]), size)
    if kind == "V" and dtype.names:
        out = bytearray(struct.pack(
            "<B3sI", 0x16, struct.pack("<H", len(dtype.names)) + b"\0",
            size))
        for name in dtype.names:
            sub, offset = dtype.fields[name][:2]
            raw = name.encode() + b"\0"
            out += raw + b"\0" * (_pad8(len(raw)) - len(raw))
            out += struct.pack("<IB3xI4x16x", offset, 0, 0)
            out += _encode_datatype(sub)
        return bytes(out)
    raise HDF5Error("unsupported dtype {}".format(dtype))


def _decode_datatype(buf: bytes, pos: int = 0):
    """(numpy dtype or _VLEN_STR, bytes consumed) of a datatype message."""
    cls_ver, b0, b1, b2, size = struct.unpack_from("<BBBBI", buf, pos)
    cls, version = cls_ver & 0x0F, cls_ver >> 4
    p = pos + 8
    if cls == 0:                                   # fixed-point
        order = ">" if b0 & 1 else "<"
        signed = "i" if b0 & 0x08 else "u"
        return np.dtype("{}{}{}".format(order, signed, size)), 12
    if cls == 1:                                   # floating point
        order = ">" if b0 & 1 else "<"
        return np.dtype("{}f{}".format(order, size)), 20
    if cls == 3:                                   # fixed-length string
        return np.dtype("S{}".format(size)), 8
    if cls == 6:                                   # compound
        n_members = b0 | (b1 << 8)
        names, formats, offsets = [], [], []
        for _ in range(n_members):
            end = buf.index(b"\0", p)
            names.append(buf[p:end].decode())
            if version < 3:
                p += _pad8(end - p + 1)
                offsets.append(struct.unpack_from("<I", buf, p)[0])
                # version 1 members also carry dimension information
                p += 4 if version == 2 else 32
            else:
                p = end + 1
                width = max(1, (size.bit_length() + 7) // 8)
                offsets.append(int.from_bytes(buf[p:p + width], "little"))
                p += width
            sub, used = _decode_datatype(buf, p)
            formats.append(sub)
            p += used
        return np.dtype({"names": names, "formats": formats,
                         "offsets": offsets, "itemsize": size}), p - pos
    if cls == 9 and (b0 & 0x0F) == 1:              # variable-length string
        _, used = _decode_datatype(buf, p)
        return _VLEN_STR, 8 + used
    raise HDF5Error("unsupported datatype class {}".format(cls))


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


class Dataset:
    """A dataset of an open file; ``ds[()]`` reads it whole."""

    def __init__(self, f: "File", messages: Dict[int, bytes]):
        self._file = f
        self.shape = _decode_dataspace(messages[_DATASPACE])
        self.dtype, _ = _decode_datatype(messages[_DATATYPE])
        if _FILTERS in messages:
            raise HDF5Error("filtered (compressed) datasets are not "
                            "supported")
        self._layout = _decode_layout(messages[_LAYOUT])

    def __getitem__(self, key):
        if key != () and key != Ellipsis:
            raise HDF5Error("only whole-dataset reads are supported")
        count = int(np.prod(self.shape, dtype=np.int64))
        itemsize = 16 if self.dtype is _VLEN_STR else self.dtype.itemsize
        kind, where = self._layout
        if kind == "compact":
            raw = where
        elif where == UNDEF:
            raw = b"\0" * (count * itemsize)
        else:
            raw = self._file._read(where, count * itemsize)
        if self.dtype is _VLEN_STR:
            values = [self._file._vlen_string(raw[i * 16:(i + 1) * 16])
                      for i in range(count)]
            if not self.shape:
                return values[0]
            return np.array(values, dtype=object).reshape(self.shape)
        arr = np.frombuffer(raw, dtype=self.dtype, count=count).reshape(
            self.shape)
        return arr[()] if not self.shape else arr.copy()


def _decode_dataspace(buf: bytes):
    version, rank, flags = buf[0], buf[1], buf[2]
    if version == 1:
        p = 8
    elif version == 2:
        if buf[3] == 2:
            raise HDF5Error("null dataspaces are not supported")
        p = 4
    else:
        raise HDF5Error("dataspace version {}".format(version))
    return tuple(struct.unpack_from("<{}Q".format(rank), buf, p))


def _decode_layout(buf: bytes):
    version, cls = buf[0], buf[1]
    if version != 3:
        raise HDF5Error("layout message version {}".format(version))
    if cls == 0:
        size = struct.unpack_from("<H", buf, 2)[0]
        return "compact", bytes(buf[4:4 + size])
    if cls == 1:
        return "contiguous", struct.unpack_from("<Q", buf, 2)[0]
    raise HDF5Error("chunked datasets are not supported")


class Group:
    """A group of an open file: a mapping of names to members."""

    def __init__(self, f: "File", links: Dict[str, object]):
        self._file = f
        self._links = links

    def keys(self):
        """Member names, in name order."""
        return list(self._links)

    def __iter__(self):
        return iter(self._links)

    def __len__(self):
        return len(self._links)

    def __contains__(self, name):
        try:
            self[name]
            return True
        except KeyError:
            return False

    def __getitem__(self, path: str):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group) or part not in node._links:
                raise KeyError(path)
            node = node._links[part]
            if isinstance(node, int):
                node = self._file._open_object(node)
        return node


# ---------------------------------------------------------------------------
# the file
# ---------------------------------------------------------------------------


class _Written:
    """A dataset created by this writer: its messages and raw bytes."""

    def __init__(self, dtype, shape, address, nbytes, compact=None):
        self.dtype, self.shape = dtype, shape
        self.address, self.nbytes, self.compact = address, nbytes, compact


class File(Group):
    """An HDF5 file opened for reading ("r") or writing ("w", or "a" for a
    file that does not exist yet)."""

    def __init__(self, path: str, mode: str = "r"):
        self.filename = path
        self.mode = mode
        self._lock = threading.RLock()
        if mode == "a" and os.path.exists(path) and os.path.getsize(path):
            raise HDF5Error(
                "appending to the existing file {} is not supported".format(
                    path))
        if mode in ("w", "a"):
            self._fh = open(path, "w+b")
            self._fh.write(b"\0" * _SUPERBLOCK_SIZE)
            self._tree: Dict = {}
            super().__init__(self, {})
        elif mode == "r":
            self._fh = open(path, "rb")
            self._tree = None
            self._heaps: Dict[int, bytes] = {}
            super().__init__(self, self._read_superblock())
        else:
            raise ValueError("mode must be 'r', 'w' or 'a'")

    # -- context / lifetime -------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def flush(self):
        """Flush written raw data to disk."""
        if self._fh is not None:
            self._fh.flush()

    def close(self):
        """Write the metadata (when writing) and close the file."""
        with self._lock:
            if self._fh is None:
                return
            try:
                if self._tree is not None:
                    self._finish()
            finally:
                self._fh.close()
                self._fh = None

    # -- reading ------------------------------------------------------------

    def _read(self, address: int, size: int) -> bytes:
        self._fh.seek(address)
        data = self._fh.read(size)
        if len(data) != size:
            raise HDF5Error("truncated file {}".format(self.filename))
        return data

    def _read_superblock(self):
        head = self._read(0, 24)
        if head[:8] != SIGNATURE:
            raise HDF5Error("{} is not an HDF5 file".format(self.filename))
        if head[8] not in (0, 1):
            raise HDF5Error("superblock version {} is not supported".format(
                head[8]))
        if head[13] != 8 or head[14] != 8:
            raise HDF5Error("only 8-byte offsets and lengths are supported")
        p = 24 + (4 if head[8] == 1 else 0) + 32
        entry = self._read(p, 40)
        return self._group_links(struct.unpack_from("<Q", entry, 8)[0])

    def _messages(self, address: int) -> Dict[int, bytes]:
        head = self._read(address, 16)
        if head[:4] == b"OHDR":
            raise HDF5Error("version 2 object headers are not supported")
        if head[0] != 1:
            raise HDF5Error("object header version {}".format(head[0]))
        n_messages, _, size = struct.unpack_from("<HII", head, 2)
        blocks = [(address + 16, size)]
        out: Dict[int, bytes] = {}
        seen = 0
        while blocks and seen < n_messages:
            start, length = blocks.pop(0)
            buf = self._read(start, length)
            p = 0
            while p + 8 <= length and seen < n_messages:
                mtype, msize = struct.unpack_from("<HH", buf, p)
                data = buf[p + 8:p + 8 + msize]
                seen += 1
                if mtype == _CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data))
                elif mtype != _NIL:
                    out.setdefault(mtype, data)
                p += 8 + msize
        return out

    def _open_object(self, address: int):
        messages = self._messages(address)
        if _SYMBOL_TABLE in messages:
            return Group(self, self._group_links(address, messages))
        if _LAYOUT in messages:
            return Dataset(self, messages)
        raise HDF5Error("object at {} is neither a symbol-table group nor a "
                        "dataset".format(address))

    def _group_links(self, address, messages=None) -> Dict[str, int]:
        messages = messages or self._messages(address)
        if _SYMBOL_TABLE not in messages:
            raise HDF5Error("only symbol-table groups are supported")
        btree, heap = struct.unpack_from("<QQ", messages[_SYMBOL_TABLE])
        names = self._local_heap(heap)
        links: Dict[str, int] = {}
        self._walk_btree(btree, names, links)
        return dict(sorted(links.items()))

    def _local_heap(self, address: int) -> bytes:
        head = self._read(address, 32)
        if head[:4] != b"HEAP":
            raise HDF5Error("bad local heap at {}".format(address))
        size, _, data = struct.unpack_from("<QQQ", head, 8)
        return self._read(data, size)

    def _walk_btree(self, address, names: bytes, links: Dict[str, int]):
        head = self._read(address, 24)
        if head[:4] != b"TREE" or head[4] != 0:
            raise HDF5Error("bad group B-tree node at {}".format(address))
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        body = self._read(address + 24, 8 + 16 * used)
        for i in range(used):
            child = struct.unpack_from("<Q", body, 8 + 16 * i)[0]
            if level:
                self._walk_btree(child, names, links)
                continue
            node = self._read(child, 8)
            if node[:4] != b"SNOD":
                raise HDF5Error("bad symbol-table node at {}".format(child))
            n = struct.unpack_from("<H", node, 6)[0]
            entries = self._read(child + 8, 40 * n)
            for k in range(n):
                name_off, obj = struct.unpack_from("<QQ", entries, 40 * k)
                end = names.index(b"\0", name_off)
                links[names[name_off:end].decode()] = obj

    def _vlen_string(self, ref: bytes) -> bytes:
        length, collection, index = struct.unpack("<IQI", ref)
        if length == 0 or collection in (0, UNDEF):
            return b""
        heap = self._heaps.get(collection)
        if heap is None:
            head = self._read(collection, 16)
            if head[:4] != b"GCOL":
                raise HDF5Error("bad global heap at {}".format(collection))
            heap = self._heaps[collection] = self._read(
                collection, struct.unpack_from("<Q", head, 8)[0])
        p = 16
        while p + 16 <= len(heap):
            idx, _, _, size = struct.unpack_from("<HHIQ", heap, p)
            if idx == 0:
                break
            if idx == index:
                return heap[p + 16:p + 16 + length]
            p += 16 + _pad8(size)
        raise HDF5Error("global heap object {} not found".format(index))

    # -- writing ------------------------------------------------------------

    def _writable(self):
        if self._tree is None or self._fh is None:
            raise HDF5Error("{} is not open for writing".format(
                self.filename))

    def _parent(self, path: str, create: bool):
        parts = [p for p in path.split("/") if p]
        node = self._tree
        for part in parts[:-1]:
            child = node.get(part)
            if child is None:
                if not create:
                    raise KeyError(path)
                child = node[part] = {}
            if not isinstance(child, dict):
                raise HDF5Error("{} is a dataset, not a group".format(part))
            node = child
        return node, parts[-1]

    def create_dataset(self, path: str, data) -> None:
        """Write ``data`` (array, bytes or str) as the dataset ``path``."""
        self._writable()
        if isinstance(data, str):
            data = data.encode()
        if isinstance(data, bytes):
            data = np.array(data, dtype="S{}".format(max(1, len(data))))
        arr = np.asarray(data)
        if not arr.flags.c_contiguous:
            arr = arr.copy()
        _encode_datatype(arr.dtype)          # refuse unsupported types now
        raw = arr.tobytes()
        with self._lock:
            parent, name = self._parent(path, create=True)
            if name in parent:
                raise HDF5Error("{} already exists".format(path))
            if len(raw) <= 64:
                parent[name] = _Written(arr.dtype, arr.shape, UNDEF,
                                        len(raw), compact=raw)
            else:
                parent[name] = _Written(arr.dtype, arr.shape,
                                        self._append(raw), len(raw))

    def __setitem__(self, path: str, value):
        self.create_dataset(path, value)

    def __delitem__(self, path: str):
        self._writable()
        with self._lock:
            parent, name = self._parent(path, create=False)
            del parent[name]

    def __getitem__(self, path: str):
        if self._tree is None:
            return super().__getitem__(path)
        node = self._tree
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, dict) or part not in node:
                raise KeyError(path)
            node = node[part]
        return node

    def keys(self):
        return sorted(self._tree) if self._tree is not None else \
            super().keys()

    def __iter__(self):
        return iter(self.keys())

    # -- metadata serialisation --------------------------------------------

    def _append(self, blob: bytes) -> int:
        self._fh.seek(0, os.SEEK_END)
        address = _pad8(self._fh.tell())
        self._fh.seek(address)
        self._fh.write(blob)
        return address

    @staticmethod
    def _header(messages) -> bytes:
        body = bytearray()
        for mtype, data in messages:
            data = data + b"\0" * (_pad8(len(data)) - len(data))
            body += struct.pack("<HHB3x", mtype, len(data), 0) + data
        return struct.pack("<BBHII4x", 1, 0, len(messages), 1,
                           len(body)) + bytes(body)

    def _write_dataset(self, ds: _Written) -> int:
        rank = len(ds.shape)
        space = struct.pack("<BBBB4x", 1, rank, 0, 0) + struct.pack(
            "<{}Q".format(rank), *ds.shape)
        fill = bytes([2, 1, 2, 0])
        if ds.compact is not None:
            layout = struct.pack("<BBH", 3, 0, len(ds.compact)) + ds.compact
        else:
            layout = struct.pack("<BBQQ", 3, 1, ds.address, ds.nbytes)
        return self._append(self._header([
            (_DATASPACE, space), (_DATATYPE, _encode_datatype(ds.dtype)),
            (_FILL, fill), (_LAYOUT, layout)]))

    def _write_group(self, node: Dict):
        """Write a group's members, then the group; returns
        (object header, B-tree, local heap) addresses."""
        names = sorted(node, key=lambda n: n.encode())
        entries = []
        heap = bytearray(b"\0" * 8)       # offset 0: the empty name
        for name in names:
            child = node[name]
            if isinstance(child, dict):
                ohdr, btree, lheap = self._write_group(child)
                scratch = (1, struct.pack("<QQ", btree, lheap))
            else:
                ohdr, scratch = self._write_dataset(child), (0, b"\0" * 16)
            offset = len(heap)
            raw = name.encode() + b"\0"
            heap += raw + b"\0" * (_pad8(len(raw)) - len(raw))
            entries.append((offset, ohdr, scratch))
        heap_data = self._append(bytes(heap))
        lheap = self._append(b"HEAP" + struct.pack(
            "<B3xQQQ", 0, len(heap), _LOCAL_HEAP_FREE_NULL, heap_data))
        # symbol-table nodes of up to 2 * LEAF_K entries, then B-tree
        # levels of up to 2 * INTERNAL_K children, bottom up
        children = []                     # (address, heap offset of last)
        for i in range(0, max(1, len(entries)), 2 * LEAF_K):
            chunk = entries[i:i + 2 * LEAF_K]
            body = bytearray()
            for offset, ohdr, (cache, scratch) in chunk:
                body += struct.pack("<QQI4x", offset, ohdr, cache) + scratch
            body += b"\0" * (40 * 2 * LEAF_K - len(body))
            if not chunk:
                break
            children.append((self._append(
                b"SNOD" + struct.pack("<BxH", 1, len(chunk)) + bytes(body)),
                chunk[-1][0]))
        level = 0
        while True:
            nodes = []
            for i in range(0, max(1, len(children)), 2 * INTERNAL_K):
                group = children[i:i + 2 * INTERNAL_K]
                body = bytearray(struct.pack("<Q", 0))
                for address, last in group:
                    body += struct.pack("<QQ", address, last)
                size = (2 * INTERNAL_K + 1) * 8 + 2 * INTERNAL_K * 8
                body += b"\0" * (size - len(body))
                nodes.append((self._append(
                    b"TREE" + struct.pack("<BBHQQ", 0, level, len(group),
                                          UNDEF, UNDEF) + bytes(body)),
                    group[-1][1] if group else 0))
            if len(nodes) == 1:
                btree = nodes[0][0]
                break
            children, level = nodes, level + 1
        ohdr = self._append(self._header(
            [(_SYMBOL_TABLE, struct.pack("<QQ", btree, lheap))]))
        return ohdr, btree, lheap

    def _finish(self):
        ohdr, btree, lheap = self._write_group(self._tree)
        self._fh.seek(0, os.SEEK_END)
        eof = self._fh.tell()
        root = struct.pack("<QQI4x", 0, ohdr, 1) + struct.pack(
            "<QQ", btree, lheap)
        superblock = SIGNATURE + struct.pack(
            "<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K, INTERNAL_K, 0) \
            + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF) + root
        assert len(superblock) == _SUPERBLOCK_SIZE
        self._fh.seek(0)
        self._fh.write(superblock)

