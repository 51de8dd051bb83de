"""Sharded probability files written by medaka_tpu, read by the port.

``medaka_tpu.datastore.ShardedDataStore`` writes its samples into
``<out>.shardNN`` files and leaves a ``shard_files`` attribute on the base
file's root group; the port's ``DataIndex`` expands it as
``medaka_tpu.datastore.expand_shards`` does, through the root-group
attributes that ``medaka_tpu_torch.io.hdf5`` reads.
"""
import json

import h5py
import numpy as np
import pytest

from medaka_tpu import datastore as jax_datastore
from medaka_tpu import stitch as jax_stitch
from medaka_tpu.common import POSITIONS_DTYPE, Sample
from medaka_tpu.labels import HaploidLabelScheme
from medaka_tpu_torch import datastore, stitch
from medaka_tpu_torch.io import hdf5

N_SAMPLES = 7
STEP, WIDTH = 90, 100      # samples overlap by 10 columns
CONTIG = "contig1"


def _sample(start, seed):
    rng = np.random.default_rng(seed)
    pos = np.array([(start + i, 0) for i in range(WIDTH)],
                   dtype=POSITIONS_DTYPE)
    probs = rng.random((WIDTH, 5)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    return Sample(ref_name=CONTIG, features=None, labels=None, ref_seq=None,
                  positions=pos, label_probs=probs,
                  depth=np.full(WIDTH, 7, dtype=np.uint64))


def _write(path, shards):
    samples = [_sample(STEP * i, i) for i in range(N_SAMPLES)]
    if shards:
        store = jax_datastore.ShardedDataStore(path, shards=shards)
    else:
        store = jax_datastore.DataStore(path, "w")
    with store as ds:
        ds.set_meta(HaploidLabelScheme(), "label_scheme")
        for s in samples:
            ds.write_sample(s)
        ds.write_registry()
    return path


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp("shards") / "probs.hdf"), 3)


@pytest.fixture(scope="module")
def draft(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("draft") / "draft.fasta")
    rng = np.random.default_rng(1)
    seq = "".join(rng.choice(list("ACGT"), STEP * (N_SAMPLES - 1) + WIDTH))
    with open(path, "w") as fh:
        fh.write(">{}\n{}\n".format(CONTIG, seq))
    return path


def test_port_index_lists_the_shards_samples(sharded):
    """The port's DataIndex lists the same 7 samples, from the same
    files in the same order, as medaka_tpu's."""
    want = jax_datastore.DataIndex(sharded)
    got = datastore.DataIndex(sharded)
    assert len(want.samples) == N_SAMPLES
    assert got.filenames == want.filenames
    assert datastore.expand_shards(sharded) == \
        jax_datastore.expand_shards(sharded)
    assert len(got.filenames) == 4
    assert got.samples == want.samples
    assert sorted(s.first_pos[0] for s in got.yield_from_feature_files()) \
        == [STEP * i for i in range(N_SAMPLES)]


def test_port_stitches_shards_as_medaka_tpu(sharded, draft, tmp_path):
    """stitch_to_fasta over the base path: the port's FASTA equals
    medaka_tpu's byte for byte."""
    want = str(tmp_path / "jax.fasta")
    got = str(tmp_path / "port.fasta")
    jax_stitch.stitch_to_fasta(sharded, draft, want)
    stitch.stitch_to_fasta(sharded, draft, got)
    with open(want, "rb") as a, open(got, "rb") as b:
        want_bytes, got_bytes = a.read(), b.read()
    with open(draft) as fh:
        draft_seq = fh.read().split()[1]
    assert got_bytes == want_bytes
    # the samples were read: the consensus is not the draft written back
    assert got_bytes.split(b"\n")[1].decode() != draft_seq


def test_unsharded_file_reads_as_before(tmp_path):
    """A file without the attribute: no attributes, no expansion."""
    path = _write(str(tmp_path / "plain.hdf"), 0)
    with hdf5.File(path) as f:
        assert f.attrs == {}
    index = datastore.DataIndex(path)
    assert index.filenames == [path]
    assert index.samples == jax_datastore.DataIndex(path).samples


@pytest.mark.parametrize("name,value", [
    ("shard_files", json.dumps(["a.shard00", "a.shard01"])),
    ("count", np.int64(7)),
    ("scale", np.float32(0.5)),
    ("vector", np.arange(5, dtype=np.int32)),
    ("fixed", np.bytes_(b"abc")),
])
def test_root_attributes_from_h5py(tmp_path, name, value):
    """Root-group attributes h5py writes read back with their values."""
    path = str(tmp_path / "attrs.h5")
    with h5py.File(path, "w") as h:
        h["data"] = np.arange(3)
        h.attrs[name] = value
        h.attrs["other"] = "x"
    with hdf5.File(path) as f:
        attrs = f.attrs
        np.testing.assert_array_equal(f["data"][()], np.arange(3))
    assert set(attrs) == {name, "other"}
    assert attrs["other"] == "x"
    if isinstance(value, np.ndarray):
        np.testing.assert_array_equal(attrs[name], value)
    else:
        assert attrs[name] == value


def test_attributes_are_read_only(tmp_path):
    """A file opened for reading gives its attributes as a copy: changing
    it writes nothing. (A file being written takes the attributes set on
    ``attrs``, written when it closes.)"""
    path = str(tmp_path / "w.h5")
    with hdf5.File(path, "w") as f:
        f.attrs["shard_files"] = json.dumps(["w.h5.shard00"])
    with hdf5.File(path) as f:
        f.attrs["shard_files"] = "changed"
        assert json.loads(f.attrs["shard_files"]) == ["w.h5.shard00"]
    with h5py.File(path, "r") as h:
        assert json.loads(h.attrs["shard_files"]) == ["w.h5.shard00"]
