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


def test_unsupported_inputs_are_refused(tmp_path):
    path = str(tmp_path / "gz.h5")
    with h5py.File(path, "w") as h:
        h.create_dataset("x", data=np.arange(1000), compression="gzip")
    with hdf5.File(path) as f:
        with pytest.raises(hdf5.HDF5Error, match="compressed|chunked"):
            f["x"][()]
    with pytest.raises(hdf5.HDF5Error, match="not an HDF5 file"):
        open(str(tmp_path / "plain"), "wb").write(b"x" * 200)
        hdf5.File(str(tmp_path / "plain"))


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
