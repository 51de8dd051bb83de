"""The lzf filter (HDF5 filter 32000) of the port against h5py and
``medaka_tpu``.

- The native codec (``native/src/lzf.cpp``) round-trips seeded random,
  low-entropy and repetitive buffers of 0 bytes to 1 MB; a corrupt or
  short stream raises.
- The port's reader takes h5py's lzf datasets, int8 through float64 in
  1-3 dimensions over several (edge) chunks, empty ones, and incompressible
  random chunks, which h5py stores raw with the filter's mask bit set.
- h5py reads the port's lzf datasets (one chunk, raw with the mask bit
  where lzf does not shrink it), value for value.
- A ``medaka_tpu`` ``DataStore(compression="lzf")`` probability file loads
  in the port sample for sample and stitches to ``medaka_tpu``'s FASTA;
  the port's lzf files (``DataStore`` and ``ShardedDataStore``) load in
  ``medaka_tpu`` and stitch to the port's FASTA.
"""
import h5py
import numpy as np
import pytest

from medaka_tpu import datastore as jax_datastore
from medaka_tpu import labels as jax_labels
from medaka_tpu import stitch as jax_stitch
from medaka_tpu.common import Sample as JaxSample
from medaka_tpu_torch import datastore, labels, native, stitch
from medaka_tpu_torch.common import POSITIONS_DTYPE, Sample
from medaka_tpu_torch.io import hdf5

SIZES = [0, 1, 2, 3, 31, 32, 33, 100, 8193, 65536, 1 << 20]


def _buffer(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "low_entropy":
        return rng.integers(0, 4, n, dtype=np.uint8).tobytes()
    unit = rng.integers(0, 256, 37, dtype=np.uint8).tobytes()
    return (unit * (n // 37 + 1))[:n]


@pytest.mark.parametrize("kind", ["random", "low_entropy", "repetitive"])
@pytest.mark.parametrize("n", SIZES)
def test_codec_round_trips(kind, n):
    data = _buffer(kind, n, n)
    packed = native.lzf_compress(data)
    # at most the worst case: a control byte every 32 literals
    assert len(packed) <= n + (n + 31) // 32
    if not n:
        assert packed == b""
        return
    assert native.lzf_decompress(packed, n) == data
    if kind == "repetitive" and n > 100:
        assert len(packed) < n // 10


def test_corrupt_streams_raise():
    data = _buffer("low_entropy", 5000, 1) + _buffer("repetitive", 5000, 2)
    packed = native.lzf_compress(data)
    with pytest.raises(ValueError, match="corrupt"):
        native.lzf_decompress(packed[:-1], len(data))      # a cut run
    with pytest.raises(ValueError, match="not"):
        native.lzf_decompress(packed, len(data) - 1)       # too small
    with pytest.raises(ValueError, match="not"):
        native.lzf_decompress(packed, len(data) + 1)       # too large
    with pytest.raises(ValueError, match="corrupt"):
        # a back reference before the output's start
        native.lzf_decompress(bytes([0x20, 0x05]), 8)


DTYPES = ["int8", "uint8", "int16", "uint16", "int32", "int64", "float16",
          "float32", "float64"]
SHAPES = [(1000,), (0,), (37, 11), (6, 7, 9)]


def _array(dtype, shape, seed, compressible):
    rng = np.random.default_rng(seed)
    if compressible:
        arr = np.arange(int(np.prod(shape))) // 64 % 3
    else:
        arr = rng.integers(-100, 100, int(np.prod(shape)))
    arr = arr.astype(dtype).reshape(shape)
    if not compressible and arr.dtype.kind == "f":
        arr = rng.random(shape).astype(dtype)
    return arr


def _chunks(shape):
    """Chunks that leave edge chunks in every dimension."""
    return tuple(max(1, (n + 2) // 3) for n in shape)


@pytest.mark.parametrize("compressible", [True, False],
                         ids=["compressible", "random"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_port_reads_h5py_lzf(tmp_path, dtype, shape, compressible):
    arr = _array(dtype, shape, len(shape), compressible)
    path = str(tmp_path / "h.h5")
    with h5py.File(path, "w") as h:
        h.create_dataset("auto", data=arr, compression="lzf")
        if arr.size:
            h.create_dataset("chunked", data=arr, compression="lzf",
                             chunks=_chunks(shape))
            d = h["chunked"]
            masks = {d.id.get_chunk_info(i).filter_mask
                     for i in range(d.id.get_num_chunks())}
            if compressible:
                assert masks == {0}
            elif arr.dtype.kind == "f" and arr.dtype.itemsize >= 4:
                # random floats: h5py stores raw chunks, the filter's bit
                # set
                assert 1 in masks
    with hdf5.File(path) as f:
        names = ["auto", "chunked"] if arr.size else ["auto"]
        for name in names:
            got = f[name][()]
            assert got.dtype == arr.dtype and got.shape == arr.shape
            assert got.tobytes() == arr.tobytes()


@pytest.mark.parametrize("compressible", [True, False],
                         ids=["compressible", "random"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_h5py_reads_port_lzf(tmp_path, dtype, shape, compressible):
    arr = _array(dtype, shape, len(shape), compressible)
    path = str(tmp_path / "p.h5")
    with hdf5.File(path, "w") as f:
        f.create_dataset("x", arr, compression="lzf")
        assert f["x"][()].tobytes() == arr.tobytes()
    with h5py.File(path, "r") as h:
        d = h["x"]
        assert d[()].dtype == arr.dtype
        assert d[()].tobytes() == arr.tobytes()
        if arr.size:
            assert d.compression == "lzf"
            info = d.id.get_chunk_info(0)
            packed = native.lzf_compress(arr.tobytes())
            shrinks = len(packed) < arr.nbytes
            assert info.filter_mask == (0 if shrinks else 1)
            assert info.size == (len(packed) if shrinks else arr.nbytes)
    with hdf5.File(path) as f:
        assert f["x"][()].tobytes() == arr.tobytes()


def test_h5py_lzf_pipeline_entry_is_h5py_s(tmp_path):
    """The pipeline entry the port writes is the one h5py writes: filter
    32000, optional, named lzf, client data (4, 261, chunk bytes)."""
    arr = np.arange(500, dtype=np.float64)
    ours, theirs = str(tmp_path / "p.h5"), str(tmp_path / "h.h5")
    with hdf5.File(ours, "w") as f:
        f.create_dataset("x", arr, compression="lzf")
    with h5py.File(theirs, "w") as h:
        h.create_dataset("x", data=arr, compression="lzf", chunks=(500,))
    entries = []
    for path in (ours, theirs):
        with h5py.File(path, "r") as h:
            entries.append(h["x"].id.get_create_plist().get_filter(0))
    assert entries[0] == entries[1] == (32000, 1, (4, 261, 4000), b"lzf")


def _draft_and_samples(tmp_path, seed=17):
    """A 3 kb draft and three overlapping probability samples with
    insertion columns, voting for the draft with random noise."""
    rng = np.random.default_rng(seed)
    draft = "".join(rng.choice(list("ACGT"), 3000))
    path = str(tmp_path / "draft.fasta")
    with open(path, "w") as fh:
        fh.write(">c\n{}\n".format(draft))
    scheme = labels.HaploidLabelScheme()
    out = []
    for start, end in ((0, 1200), (1000, 2300), (2100, 3000)):
        majors = np.repeat(np.arange(start, end), np.where(
            rng.random(end - start) < 0.02, 2, 1))
        pos = np.zeros(len(majors), dtype=POSITIONS_DTYPE)
        pos["major"] = majors
        pos["minor"][1:] = (majors[1:] == majors[:-1])
        probs = rng.random((len(pos), 5)).astype(np.float32) * 0.3
        call = np.array([scheme._encoding[(b,)] for b in draft[start:end]])
        probs[np.arange(len(pos)), call[majors - start]] += 1.0
        probs /= probs.sum(-1, keepdims=True)
        out.append(dict(ref_name="c", features=None, labels=None,
                        ref_seq=None, positions=pos, label_probs=probs,
                        depth=rng.integers(5, 30, len(pos))))
    return path, out


def _same_samples(got, want):
    assert got.sample_registry == want.sample_registry
    for name in want.sample_registry:
        a, b = got.load_sample(name), want.load_sample(name)
        for field in ("positions", "label_probs", "depth"):
            x, y = getattr(a, field), getattr(b, field)
            np.testing.assert_array_equal(x, y)
            if field != "positions":
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _fastas(tmp_path, path, draft):
    ours, theirs = str(tmp_path / "o.fasta"), str(tmp_path / "t.fasta")
    stitch.stitch_to_fasta(path, draft, ours)
    jax_stitch.stitch_to_fasta(path, draft, theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        return a.read(), b.read()


def test_medaka_tpu_lzf_file_loads_in_the_port(tmp_path):
    draft, samples = _draft_and_samples(tmp_path)
    path = str(tmp_path / "jax_lzf.hdf")
    with jax_datastore.DataStore(path, "w", compression="lzf") as ds:
        ds.set_meta(jax_labels.HaploidLabelScheme(), "label_scheme")
        for fields in samples:
            ds.write_sample(JaxSample(**fields))
        ds.write_registry()
    with h5py.File(path, "r") as h:
        name = JaxSample(**samples[0]).name
        assert h["samples/data/{}/label_probs".format(name)].compression \
            == "lzf"
    with datastore.DataStore(path) as ours, \
            jax_datastore.DataStore(path) as theirs:
        assert isinstance(ours.meta["label_scheme"],
                          labels.HaploidLabelScheme)
        _same_samples(ours, theirs)
    ours, theirs = _fastas(tmp_path, path, draft)
    assert ours == theirs and ours.count(b">") == 1


@pytest.mark.parametrize("shards", [0, 2])
def test_port_lzf_file_loads_in_medaka_tpu(tmp_path, shards):
    draft, samples = _draft_and_samples(tmp_path)
    path = str(tmp_path / "port_lzf.hdf")
    store = datastore.ShardedDataStore(path, shards=shards,
                                       compression="lzf") if shards \
        else datastore.DataStore(path, "w", compression="lzf")
    with store as ds:
        ds.set_meta(labels.HaploidLabelScheme(), "label_scheme")
        for fields in samples:
            ds.write_sample(Sample(**fields))
        ds.write_registry()
    index = jax_datastore.DataIndex([path])
    assert len(index.samples) == len(samples)
    assert len(index.filenames) == (shards + 1 if shards else 1)
    for name, fname in index.samples:
        with h5py.File(fname, "r") as h:
            assert h["samples/data/{}/label_probs".format(name)] \
                .compression == "lzf"
        with datastore.DataStore(fname) as ours, \
                jax_datastore.DataStore(fname) as theirs:
            _same_samples(ours, theirs)
    ours, theirs = _fastas(tmp_path, path, draft)
    assert ours == theirs and ours.count(b">") == 1


def test_other_filters_stay_refused(tmp_path):
    with pytest.raises(hdf5.HDF5Error, match="vbz"):
        with hdf5.File(str(tmp_path / "v.h5"), "w") as f:
            f.create_dataset("x", np.arange(10), compression="vbz")
    with pytest.raises(NotImplementedError, match="szip"):
        datastore.DataStore(str(tmp_path / "s.hdf"), "w",
                            compression="szip")
