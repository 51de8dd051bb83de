"""The port's HDF5 reader/writer against h5py, in both directions."""
import json

import h5py
import numpy as np
import pytest

from medaka_tpu_torch.io import hdf5

POS = np.zeros(7, dtype=[("major", "<i4"), ("minor", "<i2")])
POS["major"] = np.arange(7)
POS["minor"] = [0, 1, 0, 0, 2, 0, 0]
PROBS = np.random.default_rng(0).random((7, 5)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 9, 300])
def test_port_writes_h5py_reads(tmp_path, n):
    """Groups of 1, 9 (two symbol-table nodes) and 300 members (a
    two-level B-tree) open in h5py with the same contents."""
    path = str(tmp_path / "port.h5")
    with hdf5.File(path, "w") as f:
        for i in range(n):
            base = "samples/data/s{:04d}".format(i)
            f[base + "/label_probs"] = PROBS + i
            f[base + "/positions"] = POS
            f[base + "/depth"] = np.arange(i, i + 7, dtype=np.int64)
            f[base + "/ref_name"] = "contig_{}".format(i)
        f["meta_json/scheme"] = np.bytes_(json.dumps({"a": 1}).encode())
        f["samples/registry"] = np.bytes_(b"[]")
        del f["samples/registry"]
        f["samples/registry"] = np.bytes_(b'["s0000"]')
    with h5py.File(path, "r") as h:
        assert sorted(h["samples/data"]) == [
            "s{:04d}".format(i) for i in range(n)]
        last = "samples/data/s{:04d}/".format(n - 1)
        np.testing.assert_array_equal(h[last + "label_probs"][()],
                                      PROBS + (n - 1))
        np.testing.assert_array_equal(h[last + "positions"][()], POS)
        np.testing.assert_array_equal(h[last + "depth"][()],
                                      np.arange(n - 1, n + 6))
        assert h[last + "ref_name"][()] == "contig_{}".format(n - 1).encode()
        assert json.loads(h["meta_json/scheme"][()]) == {"a": 1}
        assert h["samples/registry"][()] == b'["s0000"]'


def test_h5py_writes_port_reads(tmp_path):
    path = str(tmp_path / "h5py.h5")
    with h5py.File(path, "w") as h:
        for i in range(300):
            base = "samples/data/t{:04d}".format(i)
            h[base + "/label_probs"] = PROBS * i
            h[base + "/positions"] = POS
            h[base + "/ref_name"] = "synth"
        h["meta_json/y"] = np.bytes_(b'{"b": 2}')
    with hdf5.File(path) as f:
        names = list(f["samples/data"])
        assert names == ["t{:04d}".format(i) for i in range(300)]
        np.testing.assert_array_equal(
            f["samples/data/t0299/label_probs"][()], PROBS * 299)
        np.testing.assert_array_equal(
            f["samples/data/t0007/positions"][()], POS)
        assert f["samples/data/t0003/ref_name"][()] == b"synth"
        assert f["meta_json/y"][()] == b'{"b": 2}'
        assert "meta_json" in f and "samples/data/t0003" in f
        assert "missing" not in f


def _vbz_file(path):
    """A gzip dataset of the port's writer whose filter pipeline names
    vbz (32020), ONT's codec, instead of deflate."""
    with hdf5.File(path, "w") as f:
        f.create_dataset("x", np.arange(1000), compression="gzip")
    deflate = hdf5._encode_filters_deflate()
    data = open(path, "rb").read()
    assert data.count(deflate) == 1
    vbz = deflate[:8] + (32020).to_bytes(2, "little") + deflate[10:]
    open(path, "wb").write(data.replace(deflate, vbz))


@pytest.mark.parametrize("name,write", [("vbz", _vbz_file)])
def test_unsupported_inputs_are_refused(tmp_path, name, write):
    """A filter the reader lacks raises naming it; so does a file that is
    not HDF5."""
    path = str(tmp_path / "f.h5")
    write(path)
    with hdf5.File(path) as f:
        with pytest.raises(hdf5.HDF5Error, match=name):
            f["x"][()]
    with pytest.raises(hdf5.HDF5Error, match="not an HDF5 file"):
        open(str(tmp_path / "plain"), "wb").write(b"x" * 200)
        hdf5.File(str(tmp_path / "plain"))


_RNG = np.random.default_rng(14)
_TABLE = np.zeros(1000, dtype=[("base", "S1"), ("shape", ">f4"),
                               ("scale", ">f4")])
_TABLE["base"] = _RNG.choice([b"A", b"C", b"G", b"T"], 1000)
_TABLE["shape"] = _RNG.random(1000)
_TABLE["scale"] = _RNG.random(1000)
#: h5py-written chunked datasets: (data, create_dataset options)
_CHUNKED = {
    # 101 x 3 chunks, the last row and column of chunks past the bounds
    "edge_chunks": (_RNG.random((1003, 7)).astype(np.float32),
                    dict(chunks=(10, 3), compression="gzip",
                         compression_opts=1)),
    # 201 chunks: more than one B-tree node holds (2K = 64), two levels
    "multi_level_btree": (_RNG.integers(0, 100, 10007).astype(np.int64),
                          dict(chunks=(50,), compression="gzip")),
    # a fast5 RunlengthBasecall table: compound, big-endian floats
    "compound_big_endian": (_TABLE, dict(chunks=(64,), compression="gzip")),
    "shuffle_deflate": (_RNG.random((300, 5)).astype(np.float32),
                        dict(chunks=(32, 5), compression="gzip",
                             shuffle=True)),
    "chunked_uncompressed": (_RNG.random((37, 5, 3)).astype(">f8"),
                             dict(chunks=(8, 2, 2))),
    "positions": (np.tile(POS, 50), dict(chunks=(16,), compression="gzip")),
}


@pytest.mark.parametrize("case", list(_CHUNKED))
def test_h5py_chunked_datasets_read_bit_for_bit(tmp_path, case):
    """Chunked datasets as h5py writes them read as written: many chunks,
    edge chunks, a two-level chunk B-tree, a compound table with
    big-endian members, shuffle before deflate."""
    data, options = _CHUNKED[case]
    path = str(tmp_path / "c.h5")
    with h5py.File(path, "w") as h:
        h.create_dataset("d", data=data, **options)
        h.create_dataset("s", data=np.array(
            [b"x" * i for i in range(1, 40)], dtype=h5py.string_dtype()),
            chunks=(8,), compression="gzip")
    with hdf5.File(path) as f:
        got = f["d"][()]
        assert got.dtype == data.dtype and got.shape == data.shape
        assert got.tobytes() == data.tobytes()
        assert list(f["s"][()]) == [b"x" * i for i in range(1, 40)]


@pytest.mark.parametrize("case", list(_CHUNKED))
def test_port_gzip_writes_h5py_reads(tmp_path, case):
    """The port's gzip-1 datasets (one chunk each) open in h5py as
    deflated chunked datasets holding the same bytes, and read back in
    the port."""
    data = _CHUNKED[case][0]
    path = str(tmp_path / "g.h5")
    with hdf5.File(path, "w") as f:
        f.create_dataset("a/d", data, compression="gzip")
        f.create_dataset("a/tiny", np.arange(2, dtype=np.int16),
                         compression="gzip")
    with h5py.File(path, "r") as h:
        d = h["a/d"]
        assert (d.compression, d.compression_opts, d.chunks) == (
            "gzip", 1, data.shape)
        assert d[()].tobytes() == data.tobytes() and d.dtype == data.dtype
        np.testing.assert_array_equal(h["a/tiny"][()], [0, 1])
    with hdf5.File(path) as f:
        assert f["a/d"][()].tobytes() == data.tobytes()


def _h5py_layout(path):
    """A file as medaka_tpu's DataStore writes it with h5py: samples
    (compact and contiguous datasets, a vlen-string ref_name), the JSON
    metadata and registry; plus root and group attributes."""
    from medaka_tpu import datastore as jax_datastore
    from medaka_tpu.common import Sample as JaxSample
    from medaka_tpu.labels import HaploidLabelScheme
    with jax_datastore.DataStore(path, "w") as ds:
        ds.set_meta(HaploidLabelScheme(), "label_scheme")
        for i in range(2):
            ds.write_sample(JaxSample(
                ref_name="c", features=None, labels=None, ref_seq=None,
                positions=_positions(10 * i), label_probs=PROBS + i,
                depth=np.arange(7, dtype=np.int64)))
        ds.write_registry()
    with h5py.File(path, "a") as h:
        h.attrs["note"] = "kept"
        h["samples"].attrs["count"] = 2


def _port_layout(path):
    from medaka_tpu_torch import datastore
    from medaka_tpu_torch.labels import HaploidLabelScheme
    with datastore.DataStore(path, "w") as ds:
        ds.set_meta(HaploidLabelScheme(), "label_scheme")
        for i in range(2):
            ds.write_sample(_port_sample(i))
        ds.write_registry()
    with hdf5.File(path, "a") as f:
        f.attrs["note"] = "kept"


def _positions(offset):
    from medaka_tpu.common import POSITIONS_DTYPE
    pos = np.zeros(7, dtype=POSITIONS_DTYPE)
    pos["major"] = np.arange(7) + offset
    return pos


def _port_sample(i):
    from medaka_tpu_torch.common import Sample
    return Sample(ref_name="c", features=None, labels=None, ref_seq=None,
                  positions=_positions(10 * i), label_probs=PROBS + i,
                  depth=np.arange(7, dtype=np.int64))


@pytest.mark.parametrize("writer", ["h5py", "port"])
def test_append_keeps_every_object(tmp_path, writer):
    """``File(path, "a")`` and ``DataStore(path, "a")`` on a file of
    medaka_tpu's layout written by h5py or by the port: the old samples,
    metadata and attributes stay, two samples and an attribute are
    added, and h5py, medaka_tpu's DataStore and the port read every old
    and new object back; overwriting a dataset raises."""
    from medaka_tpu import datastore as jax_datastore
    from medaka_tpu_torch import datastore
    path = str(tmp_path / "probs.hdf")
    (_h5py_layout if writer == "h5py" else _port_layout)(path)
    with datastore.DataStore(path, "a") as ds:
        assert ds.n_samples == 2
        assert type(ds.meta["label_scheme"]).__name__ == "HaploidLabelScheme"
        for i in (2, 3):
            ds.write_sample(_port_sample(i))
        ds.set_meta({"type": "GRUModel"}, "model_function")
        ds.write_registry()
    with hdf5.File(path, "a") as f:
        with pytest.raises(hdf5.HDF5Error, match="already exists"):
            f["samples/registry"] = np.bytes_(b"[]")
        f.attrs["added"] = "new"
    names = ["c:{}.0-{}.0".format(10 * i, 10 * i + 6) for i in range(4)]
    with h5py.File(path, "r") as h:
        assert sorted(h["samples/data"]) == names
        assert json.loads(h["samples/registry"][()]) == names
        assert h.attrs["note"] in ("kept", b"kept")
        assert h.attrs["added"] == b"new"
        if writer == "h5py":
            assert h["samples"].attrs["count"] == 2
        for i, name in enumerate(names):
            np.testing.assert_array_equal(
                h["samples/data/{}/label_probs".format(name)][()], PROBS + i)
    for store in (jax_datastore.DataStore, datastore.DataStore):
        with store(path) as ds:
            assert sorted(ds.sample_registry) == names
            assert ds.meta["model_function"] == {"type": "GRUModel"}
            assert type(ds.meta["label_scheme"]).__name__ == \
                "HaploidLabelScheme"
            for i, name in enumerate(names):
                sample = ds.load_sample(name)
                np.testing.assert_array_equal(sample.label_probs, PROBS + i)
                assert sample.ref_name == "c"
                assert list(sample.positions["major"]) == list(
                    range(10 * i, 10 * i + 7))
    with hdf5.File(path) as f:
        assert f.attrs["added"] == b"new"
