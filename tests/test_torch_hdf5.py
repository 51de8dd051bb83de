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
    with pytest.raises(hdf5.HDF5Error, match="appending"):
        hdf5.File(path, "a")
    with pytest.raises(hdf5.HDF5Error, match="not an HDF5 file"):
        open(str(tmp_path / "plain"), "wb").write(b"x" * 200)
        hdf5.File(str(tmp_path / "plain"))
