"""A small HDF5 reader and writer (no h5py, no libhdf5).

Written from the HDF5 file format specification (version 0 superblock,
version 1 object headers, symbol-table groups), covering what the
probability and feature files of the datastore and fast5 files hold:
groups, and contiguous, compact or chunked datasets of integers, floats
(either byte order), fixed-length and variable-length strings, opaque
bytes and compound types, and the attributes of the root group
(``File.attrs``; written as fixed-length strings or arrays). Files it
writes open in h5py; it reads files h5py writes with its default
settings.

Chunked datasets are read through their version-1 B-tree chunk index,
every level of it, with edge chunks cut to the dataset's bounds, and
through their filter pipeline: deflate (gzip, ``zlib``), shuffle (a
byte transpose) and lzf (filter 32000, h5py's; decoded by the native
library's ``lzf.cpp`` to the size of the chunk, and skipped where the
chunk's filter mask marks it as not applied, as h5py stores a chunk that
lzf does not shrink). Any other filter (vbz, szip, fletcher32, ...)
raises :class:`HDF5Error` naming it. ``create_dataset(...,
compression="gzip")`` writes a dataset deflated at level 1, as reference
medaka does, and ``compression="lzf"`` one compressed with lzf under
h5py's pipeline entry (optional, client data 4, 261 and the chunk's
bytes; a chunk lzf does not shrink is stored raw with its mask bit set),
each as one chunk covering the whole dataset (one B-tree leaf entry): a
chunk's size is a 32-bit field, so such a dataset must stay under 4 GiB
once compressed.

The writer appends each dataset's raw bytes as it is created and writes
the groups' metadata (object headers, local heaps, symbol-table nodes and
B-trees) when the file is closed, so samples stream to disk. Writes from
several threads are serialised by a lock.

Mode "a" on an existing file appends: the file's groups, datasets and
attributes are read at open, their raw data stays where it is, new
datasets go after the end of the file, and on close the whole tree's
metadata is written anew after them (every existing object header's
messages copied as they are, so datasets of any layout and type survive)
and the superblock points at it; the old metadata is left unreferenced.
Overwriting an existing dataset raises, as in a new file.
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
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
_LAYOUT, _FILTERS, _ATTRIBUTE = 0x8, 0xB, 0xC
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11

# filters of a dataset's pipeline
_DEFLATE, _SHUFFLE, _LZF = 1, 2, 32000
#: h5py's lzf filter entry: its version, liblzf's version (then the
#: chunk's size in bytes)
_LZF_CLIENT_DATA = (4, 261)
#: filters this module cannot decode, named in its errors
FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
                5: "nbit", 6: "scaleoffset", 307: "bzip2", 32000: "lzf",
                32001: "blosc", 32004: "lz4", 32015: "zstd", 32020: "vbz"}
#: the "K" of chunk B-trees in a version 0 superblock: nodes hold up to
#: 2K children
CHUNK_BTREE_K = 32


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
    big = int(dtype.byteorder == ">")
    kind, size = dtype.kind, dtype.itemsize
    if kind in "iu":
        bits = (0x08 if kind == "i" else 0) | big
        return struct.pack("<B3sI", 0x10, bytes([bits, 0, 0]), size) + \
            struct.pack("<HH", 0, 8 * size)
    if kind == "f":
        exp = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127),
               8: (52, 11, 52, 1023)}
        if size not in exp:
            raise HDF5Error("unsupported float size {}".format(size))
        eloc, esize, msize, bias = exp[size]
        return struct.pack("<B3sI", 0x11,
                           bytes([0x20 | big, 8 * size - 1, 0]),
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
    if cls == 5:                                   # opaque
        return np.dtype("V{}".format(size)), 8 + _pad8(b0)
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
        self._layout = _decode_layout(messages[_LAYOUT])
        self._filters = _decode_filters(messages[_FILTERS]) \
            if _FILTERS in messages else []
        if self._filters and self._layout[0] != "chunked":
            raise HDF5Error("filters on a {} dataset".format(
                self._layout[0]))

    def __getitem__(self, key):
        if key != () and key != Ellipsis:
            raise HDF5Error("only whole-dataset reads are supported")
        count = int(np.prod(self.shape, dtype=np.int64))
        itemsize = 16 if self.dtype is _VLEN_STR else self.dtype.itemsize
        kind, where = self._layout
        if kind == "compact":
            raw = where
        elif kind == "chunked":
            raw = self._read_chunked(where, itemsize)
        elif where == UNDEF:
            raw = b"\0" * (count * itemsize)
        else:
            raw = self._file._read(where, count * itemsize)
        return _decode_values(self._file, raw, self.dtype, self.shape)

    def _read_chunked(self, where, itemsize: int) -> bytes:
        """The dataset's bytes, assembled from its chunks (unallocated
        chunks read as zeros, the default fill)."""
        btree, dims = where
        rank = len(self.shape)
        chunk = tuple(dims[:rank])
        if dims[rank] != itemsize:
            raise HDF5Error("chunk element size {} for a {}-byte "
                            "type".format(dims[rank], itemsize))
        item = np.dtype((np.void, itemsize))
        out = np.zeros(self.shape, dtype=item)
        if btree == UNDEF or out.size == 0:
            return out.tobytes()
        chunk_bytes = int(np.prod(chunk, dtype=np.int64)) * itemsize
        for size, mask, offset, address in self._file._chunk_entries(
                btree, rank + 1):
            raw = _unfilter(self._file._read(address, size), self._filters,
                            mask, itemsize, chunk_bytes)
            if len(raw) != chunk_bytes:
                raise HDF5Error("chunk at {} holds {} bytes, not {}".format(
                    address, len(raw), chunk_bytes))
            data = np.frombuffer(raw, dtype=item).reshape(chunk)
            # an edge chunk reaches past the dataset's bounds: keep the
            # part inside them
            inside = tuple(slice(0, min(c, n - o)) for c, n, o in
                           zip(chunk, self.shape, offset))
            out[tuple(slice(o, o + s.stop) for o, s in
                      zip(offset, inside))] = data[inside]
        return out.tobytes()


def _decode_filters(buf: bytes):
    """[(filter id, client data)] of a filter pipeline message (versions
    1 and 2), in the order the writer applied them; raises naming any
    filter other than deflate, shuffle and lzf."""
    version, n = buf[0], buf[1]
    if version not in (1, 2):
        raise HDF5Error("filter pipeline message version {}".format(version))
    p = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = struct.unpack_from("<H", buf, p)[0]
        p += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len = struct.unpack_from("<H", buf, p)[0]
            p += 2
        _flags, n_values = struct.unpack_from("<HH", buf, p)
        p += 4
        p += _pad8(name_len) if version == 1 else name_len
        values = struct.unpack_from("<{}I".format(n_values), buf, p)
        p += 4 * n_values
        if version == 1 and n_values % 2:
            p += 4
        if fid not in (_DEFLATE, _SHUFFLE, _LZF):
            raise HDF5Error("the HDF5 filter {} ({}) is not supported (only "
                            "deflate, shuffle and lzf are)".format(
                                FILTER_NAMES.get(fid, "unknown"), fid))
        out.append((fid, values))
    return out


def _unfilter(raw: bytes, filters, mask: int, itemsize: int,
              chunk_bytes: int) -> bytes:
    """Undo a chunk's filters, last applied first; bit i of ``mask``
    marks filter i as skipped for this chunk. The other filters keep a
    chunk's size, so lzf decodes to the chunk's ``chunk_bytes``."""
    for i in reversed(range(len(filters))):
        if mask & (1 << i):
            continue
        fid, values = filters[i]
        if fid == _DEFLATE:
            raw = zlib.decompress(raw)
        elif fid == _LZF:
            raw = _lzf_decode(raw, chunk_bytes)
        else:
            size = values[0] if values else itemsize
            n = len(raw) // size
            if size > 1 and n > 1:
                body = np.frombuffer(raw, np.uint8, n * size)
                raw = body.reshape(size, n).T.tobytes() + raw[n * size:]
    return raw


def _lzf_decode(raw: bytes, size: int) -> bytes:
    from medaka_tpu_torch import native
    try:
        return native.lzf_decompress(raw, size)
    except ValueError as e:
        raise HDF5Error("lzf chunk: {}".format(e)) from e


def _encode_filters_deflate(level: int = 1) -> bytes:
    """A version 1 filter pipeline message of deflate at ``level``."""
    return struct.pack("<BB6x", 1, 1) + struct.pack(
        "<HHHHI4x", _DEFLATE, 0, 0, 1, level)


def _encode_filters_lzf(chunk_bytes: int) -> bytes:
    """A version 1 filter pipeline message of lzf as h5py writes it: named
    "lzf", optional (flags 1), client data (4, 261, chunk bytes)."""
    values = _LZF_CLIENT_DATA + (chunk_bytes,)
    return struct.pack("<BB6x", 1, 1) + struct.pack(
        "<HHHH", _LZF, 8, 1, len(values)) + b"lzf".ljust(8, b"\0") + \
        struct.pack("<3I4x", *values)


def _decode_values(f: "File", raw: bytes, dtype, shape):
    """The values of a dataset or attribute from its raw bytes: a scalar
    for shape (), else an array (of bytes objects for vlen strings)."""
    count = int(np.prod(shape, dtype=np.int64))
    if dtype is _VLEN_STR:
        values = [f._vlen_string(raw[i * 16:(i + 1) * 16])
                  for i in range(count)]
        if not shape:
            return values[0]
        return np.array(values, dtype=object).reshape(shape)
    arr = np.frombuffer(raw, dtype=dtype, count=count).reshape(shape)
    return arr[()] if not shape else arr.copy()


def _decode_attribute(f: "File", buf: bytes):
    """(name, value) of an attribute message (versions 1-3)."""
    version = buf[0]
    if version not in (1, 2, 3):
        raise HDF5Error("attribute message version {}".format(version))
    name_size, dt_size, ds_size = struct.unpack_from("<HHH", buf, 2)
    # version 1 pads each part to 8 bytes; version 3 adds an encoding byte
    pad = _pad8 if version == 1 else (lambda n: n)
    p = 9 if version == 3 else 8
    name = bytes(buf[p:p + name_size]).split(b"\0")[0].decode()
    p += pad(name_size)
    dtype, _ = _decode_datatype(buf, p)
    p += pad(dt_size)
    shape = _decode_dataspace(buf[p:p + ds_size])
    p += pad(ds_size)
    value = _decode_values(f, bytes(buf[p:]), dtype, shape)
    if dtype is _VLEN_STR and not shape:
        value = value.decode()
    return name, value


def _encode_dataspace(shape) -> bytes:
    """Dataspace message (version 1); rank 0 is a scalar."""
    return struct.pack("<BBBB4x", 1, len(shape), 0, 0) + struct.pack(
        "<{}Q".format(len(shape)), *shape)


def _encode_attribute(name: str, value) -> bytes:
    """Attribute message (version 1) of a str (a fixed-length string),
    bytes or array value."""
    if isinstance(value, str):
        value = value.encode()
    if isinstance(value, bytes):
        value = np.array(value, dtype="S{}".format(max(1, len(value))))
    arr = np.array(value, order="C")
    raw_name = name.encode() + b"\0"
    dtype, space = _encode_datatype(arr.dtype), _encode_dataspace(arr.shape)

    def padded(b):
        return b + b"\0" * (_pad8(len(b)) - len(b))
    return (struct.pack("<BBHHH", 1, 0, len(raw_name), len(dtype),
                        len(space)) + padded(raw_name) + padded(dtype)
            + padded(space) + arr.tobytes())


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
    """("compact", bytes), ("contiguous", address) or ("chunked",
    (B-tree address, chunk dimensions with the element size last))."""
    version, cls = buf[0], buf[1]
    if version != 3:
        raise HDF5Error("layout message version {}".format(version))
    if cls == 0:
        size = struct.unpack_from("<H", buf, 2)[0]
        return "compact", bytes(buf[4:4 + size])
    if cls == 1:
        return "contiguous", struct.unpack_from("<Q", buf, 2)[0]
    if cls == 2:
        ndims = buf[2]
        btree = struct.unpack_from("<Q", buf, 3)[0]
        return "chunked", (btree, struct.unpack_from(
            "<{}I".format(ndims), buf, 11))
    raise HDF5Error("layout class {} is not supported".format(cls))


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
    """A dataset created by this writer: its messages and raw bytes
    (``codec`` "gzip" or "lzf": one chunk of ``nbytes`` at ``address``,
    its filter skipped where ``mask`` is 1)."""

    def __init__(self, f: "File", dtype, shape, address, nbytes,
                 compact=None, codec=None, mask=0):
        self._file = f
        self.dtype, self.shape = dtype, shape
        self.address, self.nbytes, self.compact = address, nbytes, compact
        self.codec, self.mask = codec, mask

    def __getitem__(self, key):
        if key != () and key != Ellipsis:
            raise HDF5Error("only whole-dataset reads are supported")
        raw = self.compact if self.compact is not None else \
            self._file._read(self.address, self.nbytes)
        if self.codec == "gzip":
            raw = zlib.decompress(raw)
        elif self.codec == "lzf" and not self.mask:
            raw = _lzf_decode(raw, self.dtype.itemsize * int(np.prod(
                self.shape, dtype=np.int64)))
        return _decode_values(self._file, raw, self.dtype, self.shape)


class _Existing:
    """A dataset of a file opened for appending: the (type, flags, body)
    messages of its object header, written again as they are on close."""

    def __init__(self, f: "File", messages):
        self._file = f
        self.messages = messages

    def __getitem__(self, key):
        first = {}
        for mtype, _, data in self.messages:
            first.setdefault(mtype, data)
        return Dataset(self._file, first)[key]


class _Group(dict):
    """A group of a file being written: its members by name and the
    messages of its object header besides the symbol table (attributes,
    times), kept from the file it was read from."""

    def __init__(self, messages=()):
        super().__init__()
        self.messages = list(messages)


class File(Group):
    """An HDF5 file opened for reading ("r"), writing ("w") or appending
    ("a": a new file, or an existing one whose objects are kept; see the
    module docstring)."""

    def __init__(self, path: str, mode: str = "r"):
        self.filename = path
        self.mode = mode
        self._lock = threading.RLock()
        self._heaps: Dict[int, bytes] = {}
        #: root attributes of a file being written, and those read from it
        #: with their messages (written again unless replaced)
        self._attrs: Dict[str, object] = {}
        self._attrs_kept: Dict[str, tuple] = {}
        if mode == "a" and os.path.exists(path) and os.path.getsize(path):
            self._fh = open(path, "r+b")
            self._tree = None
            try:
                self._read_superblock()
                self._tree = self._load_tree(self._root)
            except Exception:
                self._fh.close()
                raise
            for mtype, flags, data in self._tree.messages:
                if mtype == _ATTRIBUTE:
                    name, value = _decode_attribute(self, data)
                    self._attrs[name] = value
                    self._attrs_kept[name] = (value, (mtype, flags, data))
            super().__init__(self, {})
        elif mode in ("w", "a"):
            self._fh = open(path, "w+b")
            self._fh.write(b"\0" * _SUPERBLOCK_SIZE)
            self._tree = _Group()
            super().__init__(self, {})
        elif mode == "r":
            self._fh = open(path, "rb")
            self._tree = None
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
        with self._lock:
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
        self._root = struct.unpack_from("<Q", entry, 8)[0]
        return self._group_links(self._root)

    @property
    def attrs(self) -> Dict[str, object]:
        """The root group's attributes; a scalar variable-length string
        reads as ``str``, as in h5py. In a file being written this is the
        mapping written on close: set a ``str``, ``bytes`` or array value
        (a string is stored as a fixed-length one)."""
        if self._tree is not None:
            return self._attrs
        return dict(_decode_attribute(self, data) for mtype, _, data in
                    self._message_list(self._root) if mtype == _ATTRIBUTE)

    def _messages(self, address: int) -> Dict[int, bytes]:
        """The first message of each type in an object header."""
        out: Dict[int, bytes] = {}
        for mtype, _, data in self._message_list(address):
            out.setdefault(mtype, data)
        return out

    def _message_list(self, address: int):
        """(type, flags, body) of every message of an object header, in
        order, continuations followed and NIL messages left out."""
        head = self._read(address, 16)
        if head[:4] == b"OHDR":
            raise HDF5Error("version 2 object headers are not supported")
        if head[0] != 1:
            raise HDF5Error("object header version {}".format(head[0]))
        n_messages, _, size = struct.unpack_from("<HII", head, 2)
        blocks = [(address + 16, size)]
        out = []
        seen = 0
        while blocks and seen < n_messages:
            start, length = blocks.pop(0)
            buf = self._read(start, length)
            p = 0
            while p + 8 <= length and seen < n_messages:
                mtype, msize, flags = struct.unpack_from("<HHB", buf, p)
                data = buf[p + 8:p + 8 + msize]
                seen += 1
                if mtype == _CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data))
                elif mtype != _NIL:
                    out.append((mtype, flags, data))
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

    def _load_tree(self, address: int) -> _Group:
        """The group at ``address`` and everything below it, as the
        writer's tree: groups, and datasets as their messages."""
        messages = self._message_list(address)
        node = _Group(m for m in messages if m[0] != _SYMBOL_TABLE)
        for name, child in self._group_links(address).items():
            sub = self._message_list(child)
            if any(m[0] == _SYMBOL_TABLE for m in sub):
                node[name] = self._load_tree(child)
            elif any(m[0] == _LAYOUT for m in sub):
                node[name] = _Existing(self, sub)
            else:
                raise HDF5Error("object {} is neither a symbol-table group "
                                "nor a dataset".format(name))
        return node

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

    def _chunk_entries(self, address: int, ndims: int):
        """(size, filter mask, offset, address) of every chunk under the
        chunk B-tree node at ``address``, all levels walked; the offset
        holds the chunk's first element in each dimension."""
        head = self._read(address, 24)
        if head[:4] != b"TREE" or head[4] != 1:
            raise HDF5Error("bad chunk B-tree node at {}".format(address))
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        key = 8 + 8 * ndims
        body = self._read(address + 24, used * (key + 8) + key)
        out = []
        for i in range(used):
            p = i * (key + 8)
            size, mask = struct.unpack_from("<II", body, p)
            offset = struct.unpack_from("<{}Q".format(ndims - 1), body, p + 8)
            child = struct.unpack_from("<Q", body, p + key)[0]
            if level:
                out.extend(self._chunk_entries(child, ndims))
            else:
                out.append((size, mask, offset, child))
        return out

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
                child = node[part] = _Group()
            if not isinstance(child, dict):
                raise HDF5Error("{} is a dataset, not a group".format(part))
            node = child
        return node, parts[-1]

    def create_dataset(self, path: str, data, compression=None) -> None:
        """Write ``data`` (array, bytes or str) as the dataset ``path``.

        :param compression: None, "gzip" for one deflated chunk (level 1)
            or "lzf" for one lzf chunk (stored raw, its filter marked as
            skipped, where lzf does not shrink it), when ``data`` is an
            array with at least one dimension and one element; any other
            value raises.
        """
        self._writable()
        if compression not in (None, "gzip", "lzf"):
            raise HDF5Error("compression {!r} is not supported (only "
                            "gzip and lzf are)".format(compression))
        if isinstance(data, str):
            data = data.encode()
        if isinstance(data, bytes):
            data = np.array(data, dtype="S{}".format(max(1, len(data))))
        arr = np.asarray(data)
        if not arr.flags.c_contiguous:
            arr = arr.copy()
        _encode_datatype(arr.dtype)          # refuse unsupported types now
        raw = arr.tobytes()
        codec = compression if arr.ndim > 0 and arr.size > 0 else None
        mask = 0
        if codec == "gzip":
            raw = zlib.compress(raw, 1)
        elif codec == "lzf":
            from medaka_tpu_torch import native
            packed = native.lzf_compress(raw)
            if len(packed) < len(raw):
                raw = packed
            else:
                mask = 1
        if codec is not None and len(raw) >= 2 ** 32:
            raise HDF5Error("{}: a {} chunk of {} bytes does not fit the "
                            "chunk index's 32-bit size".format(
                                path, codec, len(raw)))
        with self._lock:
            parent, name = self._parent(path, create=True)
            if name in parent:
                raise HDF5Error("{} already exists".format(path))
            if len(raw) <= 64 and codec is None:
                parent[name] = _Written(self, arr.dtype, arr.shape, UNDEF,
                                        len(raw), compact=raw)
            else:
                parent[name] = _Written(self, arr.dtype, arr.shape,
                                        self._append(raw), len(raw),
                                        codec=codec, mask=mask)

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
        """A version 1 object header of (type, body) or (type, flags,
        body) messages."""
        body = bytearray()
        for message in messages:
            mtype, data = message[0], message[-1]
            flags = message[1] if len(message) == 3 else 0
            data = data + b"\0" * (_pad8(len(data)) - len(data))
            body += struct.pack("<HHB3x", mtype, len(data), flags) + data
        return struct.pack("<BBHII4x", 1, 0, len(messages), 1,
                           len(body)) + bytes(body)

    def _chunk_btree(self, ds: _Written) -> int:
        """The one-leaf chunk B-tree of a compressed dataset: its chunk
        starts at the origin and its right key at the chunk's far corner
        (in elements; the element size in the last dimension), the node
        padded to the 2K entries readers expect."""
        ndims = len(ds.shape) + 1
        left = struct.pack("<II{}Q".format(ndims), ds.nbytes, ds.mask,
                           *([0] * ndims))
        right = struct.pack("<II{}Q".format(ndims), 0, 0, *ds.shape,
                            ds.dtype.itemsize)
        body = left + struct.pack("<Q", ds.address) + right
        size = 2 * CHUNK_BTREE_K * 8 + (2 * CHUNK_BTREE_K + 1) * len(left)
        return self._append(b"TREE" + struct.pack(
            "<BBHQQ", 1, 0, 1, UNDEF, UNDEF) + body
            + b"\0" * (size - len(body)))

    def _write_dataset(self, ds) -> int:
        if isinstance(ds, _Existing):
            return self._append(self._header(ds.messages))
        space = _encode_dataspace(ds.shape)
        extra = []
        if ds.compact is not None:
            fill = bytes([2, 1, 2, 0])
            layout = struct.pack("<BBH", 3, 0, len(ds.compact)) + ds.compact
        elif ds.codec is not None:
            # incremental allocation, as h5py writes chunked datasets
            fill = bytes([2, 2, 2, 0])
            layout = struct.pack("<BBBQ", 3, 2, len(ds.shape) + 1,
                                 self._chunk_btree(ds)) + struct.pack(
                "<{}I".format(len(ds.shape) + 1), *ds.shape,
                ds.dtype.itemsize)
            extra = [(_FILTERS, _encode_filters_deflate()
                      if ds.codec == "gzip" else _encode_filters_lzf(
                          ds.dtype.itemsize * int(np.prod(
                              ds.shape, dtype=np.int64))))]
        else:
            fill = bytes([2, 1, 2, 0])
            layout = struct.pack("<BBQQ", 3, 1, ds.address, ds.nbytes)
        return self._append(self._header([
            (_DATASPACE, space), (_DATATYPE, _encode_datatype(ds.dtype)),
            (_FILL, fill)] + extra + [(_LAYOUT, layout)]))

    def _write_group(self, node: _Group, extra=None):
        """Write a group's members, then the group (with ``extra``
        messages in place of the group's own besides its symbol table);
        returns (object header, B-tree, local heap) addresses."""
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
            [(_SYMBOL_TABLE, struct.pack("<QQ", btree, lheap))]
            + (node.messages if extra is None else extra)))
        return ohdr, btree, lheap

    def _root_messages(self):
        """The root group's messages besides its symbol table: those it
        had, with its attributes as ``attrs`` holds them now."""
        out = [m for m in self._tree.messages if m[0] != _ATTRIBUTE]
        for name, value in self._attrs.items():
            kept = self._attrs_kept.get(name)
            if kept is not None and kept[0] is value:
                out.append(kept[1])
            else:
                out.append((_ATTRIBUTE, _encode_attribute(name, value)))
        return out

    def _finish(self):
        ohdr, btree, lheap = self._write_group(self._tree,
                                              self._root_messages())
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

