"""Reference medaka artifacts in the port, against medaka_tpu, on the CPU.

Reference checkpoints (``weights.pt`` + pickled ``meta.pkl``, the modern
``model_from_dict`` partial and the legacy ``build_model_torch`` one)
built as ``tests/test_models.py`` builds them, and by the port's
``testing.write_reference_checkpoint``; probability files with pickled
``meta/`` and gzip-1 chunked samples, as reference medaka writes them
with h5py, as ``medaka_tpu.datastore.DataStore(compression="gzip")``
writes them and as the port writes them. Nothing falls back: a pickle
that does not convert raises naming it.
"""
import functools
import io
import pickle
import sys
import tarfile

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medaka_tpu import datastore as jax_datastore
from medaka_tpu import labels as jax_labels
from medaka_tpu import models as jax_models
from medaka_tpu import stitch as jax_stitch
from medaka_tpu.common import Sample as JaxSample
from medaka_tpu_torch import compat, datastore, features, labels, models, \
    stitch, testing
from medaka_tpu_torch.common import POSITIONS_DTYPE, Sample
from medaka_tpu_torch.io import hdf5
from medaka_tpu_torch.models.latent_space_lstm import LatentSpaceLSTM
from tests.test_models import _fake_medaka_modules, _torch_gru_model
from tests.torch_threads import one_thread  # noqa: F401


def _tarball(path, state, meta):
    """weights.pt of ``state`` and meta.pkl of ``meta`` (pickled here
    unless it is bytes already)."""
    buf = io.BytesIO()
    torch.save(state, buf)
    meta_bytes = meta if isinstance(meta, bytes) else pickle.dumps(meta)
    with tarfile.open(path, "w:gz") as tar:
        for name, data in (("model/weights.pt", buf.getvalue()),
                           ("model/meta.pkl", meta_bytes)):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return path


def _reference_tarball(path, gru_size, legacy, encoder=None):
    """A reference checkpoint of a torch GRU + Linear at ``gru_size``
    (tests/test_models.py's construction): the modern ``model_from_dict``
    partial, or the legacy ``build_model_torch(10, 5, gru_size)``."""
    mods = _fake_medaka_modules()
    try:
        def build_model_torch(*args):
            pass
        build_model_torch.__module__ = "medaka.models"
        build_model_torch.__qualname__ = "build_model_torch"
        mods["medaka.models"].build_model_torch = build_model_torch
        tm = _torch_gru_model(gru_size=gru_size, seed=gru_size)
        enc = mods["medaka.features"].CountsFeatureEncoder()
        enc.__dict__.update(encoder or dict(
            normalise="total", dtypes=("",), tag_name=None, tag_value=None,
            tag_keep_missing=False, read_group=None, min_mapq=1,
            sym_indels=False))
        function = functools.partial(build_model_torch, 10, 5, gru_size) \
            if legacy else functools.partial(
                mods["medaka.models"].model_from_dict,
                {"type": "GRUModel", "kwargs": {
                    "num_features": 10, "num_classes": 5,
                    "gru_size": gru_size}})
        meta = {"model_function": function, "feature_encoder": enc,
                "label_scheme": mods["medaka.labels"].HaploidLabelScheme()}
        _tarball(path, tm.state_dict(), meta)
    finally:
        for name in mods:
            del sys.modules[name]
    return tm


@pytest.mark.parametrize("gru_size,legacy", [(12, False), (128, True)],
                         ids=["modern", "legacy_2x128"])
def test_reference_checkpoint_loads_in_both(tmp_path, gru_size, legacy):
    """The checkpoint loads in both packages with the same model dict,
    encoder and scheme, and the port's logits equal the torch reference
    module's within 2e-6 (as tests/test_models.py holds medaka_tpu)."""
    path = str(tmp_path / "ref.tar.gz")
    tm = _reference_tarball(path, gru_size, legacy)
    ours, theirs = models.load_model(path), jax_models.load_model(path)
    assert ours.model.to_dict() == theirs.model.to_dict()
    assert ours.model.gru_size == gru_size
    assert ours.feature_encoder.to_dict() == theirs.feature_encoder.to_dict()
    assert isinstance(ours.feature_encoder, features.CountsFeatureEncoder)
    assert isinstance(ours.label_scheme, labels.HaploidLabelScheme)
    assert isinstance(theirs.label_scheme, jax_labels.HaploidLabelScheme)
    x = np.random.default_rng(1).random((2, 25, 10), np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()
        got = ours.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    # the same weights in both packages
    for a, b in zip(jax.tree_util.tree_leaves(ours.model.jax_params()),
                    jax.tree_util.tree_leaves(theirs.params)):
        np.testing.assert_array_equal(a, b)


def _rl_bundle(seed=4):
    model = LatentSpaceLSTM(lstm_size=8, cnn_size=8, kernel_sizes=(1, 3),
                            use_dwells=True)
    jmodel = jax_models.model_from_dict(model.to_dict())
    params = jax.tree.map(np.asarray,
                          jmodel.init_params(jax.random.PRNGKey(seed)))
    # running statistics off (0, 1), so that they must travel
    rng = np.random.default_rng(seed)
    for conv in params["convs"]:
        conv["bn"]["mean"] = rng.random(8).astype(np.float32)
        conv["bn"]["var"] = 1 + rng.random(8).astype(np.float32)
    model.load_jax_params(params)
    return models.ModelBundle(
        model, features.ReadAlignmentFeatureEncoder(max_reads=6),
        labels.HaploidLabelScheme()), jmodel


def _gru_bundle(gru_size=16):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(gru_size)
        model = models.model_from_dict({"type": "GRUModel", "kwargs": {
            "num_features": 10, "num_classes": 5, "gru_size": gru_size}})
    return models.ModelBundle(model, features.CountsFeatureEncoder(),
                              labels.HaploidLabelScheme())


@pytest.mark.parametrize("kind", ["gru", "gru_legacy", "read_level"])
def test_port_reference_writer_loads_in_both(tmp_path, kind):
    """testing.write_reference_checkpoint: both packages load the same
    weights, architecture, encoder and scheme; the read-level model (batch
    norm's running statistics included) gives medaka_tpu's forward on the
    same weights within 1e-5."""
    if kind == "read_level":
        bundle, _ = _rl_bundle()
    else:
        bundle = _gru_bundle()
    path = testing.write_reference_checkpoint(
        bundle, str(tmp_path / "w.tar.gz"), legacy=kind == "gru_legacy")
    with tarfile.open(path) as tar:
        assert sorted(tar.getnames()) == ["model/meta.pkl",
                                          "model/weights.pt"]
    ours, theirs = models.load_model(path), jax_models.load_model(path)
    assert ours.model.to_dict() == bundle.model.to_dict()
    assert theirs.model.to_dict()["type"] == bundle.model.to_dict()["type"]
    assert ours.feature_encoder.to_dict() == \
        bundle.feature_encoder.to_dict() == theirs.feature_encoder.to_dict()
    assert type(ours.label_scheme).__name__ == \
        type(theirs.label_scheme).__name__ == "HaploidLabelScheme"
    want = bundle.model.jax_params()
    for a, b, c in zip(jax.tree_util.tree_leaves(want),
                       jax.tree_util.tree_leaves(ours.model.jax_params()),
                       jax.tree_util.tree_leaves(theirs.params)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    if kind == "read_level":
        rng = np.random.default_rng(3)
        x = np.zeros((2, 20, 6, 5), np.int8)
        x[..., 0] = rng.integers(0, 6, (2, 20, 6))
        x[..., 1] = rng.integers(-1, 40, (2, 20, 6))
        x[..., 2] = rng.choice([-1, 1], (2, 20, 6))
        x[..., 3] = 60
        x[..., 4] = rng.integers(0, 12, (2, 20, 6))
        with torch.no_grad():
            got = ours.model(torch.from_numpy(x)).numpy()
        ref = np.asarray(theirs.model.apply(theirs.params, jnp.asarray(x)))
        np.testing.assert_allclose(got, ref, atol=1e-5)


def _bad_meta(kind):
    mods = _fake_medaka_modules()
    try:
        class FancyEncoder:
            pass
        FancyEncoder.__module__ = "medaka.features"
        FancyEncoder.__qualname__ = FancyEncoder.__name__ = "FancyEncoder"
        mods["medaka.features"].FancyEncoder = FancyEncoder

        def build_transformer(*args):
            pass
        build_transformer.__module__ = "medaka.models"
        build_transformer.__qualname__ = "build_transformer"
        mods["medaka.models"].build_transformer = build_transformer
        good = functools.partial(
            mods["medaka.models"].model_from_dict,
            {"type": "GRUModel", "kwargs": {"gru_size": 4}})
        if kind == "encoder":
            return pickle.dumps({"model_function": good,
                                 "feature_encoder": FancyEncoder()})
        if kind == "model_function":
            return pickle.dumps({"model_function": functools.partial(
                build_transformer, 10)})
        return pickle.dumps({"model_function": 7})
    finally:
        for name in mods:
            del sys.modules[name]


@pytest.mark.parametrize("kind,match", [
    ("encoder", "FancyEncoder"), ("model_function", "build_transformer"),
    ("not_medaka", "model function 7")])
def test_unconvertible_checkpoint_raises(tmp_path, kind, match):
    """A pickled object the port cannot convert raises naming it."""
    path = _tarball(str(tmp_path / "bad.tar.gz"),
                    _torch_gru_model(gru_size=4).state_dict(),
                    _bad_meta(kind))
    with pytest.raises(ValueError, match=match):
        models.load_model(path)


def test_unpickler_refuses_other_globals():
    """A pickle naming a global outside medaka's stubs and plain
    containers raises naming it, where medaka_tpu's unpickler would
    resolve it; numpy arrays and dtypes pass."""
    import numpy
    import os as os_mod
    with pytest.raises(pickle.UnpicklingError, match="posix.system|os.system"):
        compat.medaka_loads(pickle.dumps(os_mod.system))
    value = {"a": numpy.arange(3, dtype=numpy.float32), "t": numpy.int64,
             "s": {1, 2}}
    got = compat.medaka_loads(pickle.dumps(value))
    np.testing.assert_array_equal(got["a"], value["a"])
    assert got["t"] is numpy.int64 and got["s"] == {1, 2}


def test_missing_weight_raises_naming_it(tmp_path):
    """A state dict without one of the model's tensors raises naming the
    key."""
    bundle = _gru_bundle(8)
    state = bundle.model.torch_state()
    del state["gru.bias_hh_l1_reverse"]
    with pytest.raises(ValueError, match="gru.bias_hh_l1_reverse"):
        bundle.model.load_torch_state(state)


# ---------------------------------------------------------------------------
# probability files: pickled meta/, gzip-1 chunked samples
# ---------------------------------------------------------------------------


def _draft_and_samples(tmp_path, seed=6):
    """A 3 kb draft and three overlapping probability samples with a few
    insertion columns, voting for the draft with planted edits."""
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
        probs = rng.random((len(pos), 5)).astype(np.float32) * 0.1
        call = np.array([scheme._encoding[(b,)] for b in draft[start:end]])
        probs[np.arange(len(pos)), call[majors - start]] += 1.0
        probs /= probs.sum(-1, keepdims=True)
        out.append(dict(ref_name="c", features=None, labels=None,
                        ref_seq=None, positions=pos, label_probs=probs,
                        depth=rng.integers(5, 30, len(pos))))
    return path, out


def _h5py_reference(path, samples):
    """As reference medaka writes it: h5py datasets gzip-1 (h5py's own
    chunking), ``meta/label_scheme`` pickled, no JSON metadata, no
    registry (the layout tests/crossstack/run_reference.py prepares)."""
    mods = _fake_medaka_modules()
    try:
        scheme = pickle.dumps(mods["medaka.labels"].HaploidLabelScheme())
    finally:
        for name in mods:
            del sys.modules[name]
    with h5py.File(path, "w") as h:
        for fields in samples:
            grp = "samples/data/" + JaxSample(**fields).name
            for key in ("positions", "label_probs", "depth"):
                h.create_dataset(grp + "/" + key, data=fields[key],
                                 compression="gzip", compression_opts=1)
            h[grp + "/ref_name"] = fields["ref_name"]
        h["meta/label_scheme"] = np.bytes_(scheme)


def _medaka_tpu_gzip(path, samples):
    with jax_datastore.DataStore(path, "w", compression="gzip") as ds:
        ds.set_meta(jax_labels.HaploidLabelScheme(), "label_scheme")
        for fields in samples:
            ds.write_sample(JaxSample(**fields))
        ds.write_registry()


def _port_reference(path, samples):
    src = path + ".src"
    with datastore.DataStore(src, "w") as ds:
        ds.set_meta(labels.HaploidLabelScheme(), "label_scheme")
        for fields in samples:
            ds.write_sample(Sample(**fields))
        ds.write_registry()
    testing.write_reference_probabilities(src, path)
    with hdf5.File(path) as f:
        assert "meta_json" not in f and "samples/registry" not in f
        assert "meta/label_scheme" in f


_WRITERS = {"reference_h5py": _h5py_reference,
            "medaka_tpu_gzip": _medaka_tpu_gzip,
            "port_reference_writer": _port_reference}


@pytest.mark.parametrize("writer", list(_WRITERS))
def test_probability_file_reads_and_stitches(tmp_path, writer):
    """The port reads the file's samples bit for bit as medaka_tpu does,
    its metadata converts, and ``sequence`` writes medaka_tpu's FASTA
    byte for byte."""
    draft, samples = _draft_and_samples(tmp_path)
    path = str(tmp_path / "probs.hdf")
    _WRITERS[writer](path, samples)
    with h5py.File(path, "r") as h:
        d = h["samples/data/" + JaxSample(**samples[0]).name + "/label_probs"]
        assert d.compression == "gzip"
    with datastore.DataStore(path) as ours, \
            jax_datastore.DataStore(path) as theirs:
        assert isinstance(ours.meta["label_scheme"],
                          labels.HaploidLabelScheme)
        assert ours.sample_registry == theirs.sample_registry
        for name in ours.sample_registry:
            a, b = ours.load_sample(name), theirs.load_sample(name)
            for field in ("positions", "label_probs", "depth"):
                assert getattr(a, field).tobytes() == \
                    getattr(b, field).tobytes()
    out_ours, out_theirs = str(tmp_path / "o.fasta"), str(tmp_path / "t.fa")
    stitch.stitch_to_fasta(path, draft, out_ours)
    jax_stitch.stitch_to_fasta(path, draft, out_theirs)
    assert open(out_ours, "rb").read() == open(out_theirs, "rb").read()


def test_port_gzip_datastore_reads_in_medaka_tpu(tmp_path):
    """DataStore(compression="gzip") (and ShardedDataStore's writers)
    write gzip-1 datasets that h5py and medaka_tpu read bit for bit."""
    _, samples = _draft_and_samples(tmp_path)
    path = str(tmp_path / "g.hdf")
    with datastore.ShardedDataStore(path, shards=2,
                                    compression="gzip") as ds:
        ds.set_meta(labels.HaploidLabelScheme(), "label_scheme")
        for fields in samples:
            ds.write_sample(Sample(**fields))
    index = jax_datastore.DataIndex([path])
    assert len(index.samples) == len(samples)
    for (name, fname), fields in zip(sorted(index.samples), sorted(
            samples, key=lambda f: JaxSample(**f).name)):
        with h5py.File(fname, "r") as h:
            assert h["samples/data/{}/label_probs".format(name)] \
                .compression == "gzip"
        with jax_datastore.DataStore(fname) as theirs:
            got = theirs.load_sample(name)
        assert got.label_probs.tobytes() == fields["label_probs"].tobytes()
        np.testing.assert_array_equal(got.positions, fields["positions"])


def test_unconvertible_meta_pickle_raises(tmp_path):
    """A pickled meta/ item the port cannot convert raises naming it
    (medaka_tpu logs a warning and goes on)."""
    path = str(tmp_path / "bad.hdf")
    mods = _fake_medaka_modules()
    try:
        class TriploidLabelScheme:
            pass
        TriploidLabelScheme.__module__ = "medaka.labels"
        TriploidLabelScheme.__qualname__ = "TriploidLabelScheme"
        TriploidLabelScheme.__name__ = "TriploidLabelScheme"
        mods["medaka.labels"].TriploidLabelScheme = TriploidLabelScheme
        blob = pickle.dumps(TriploidLabelScheme())
    finally:
        for name in mods:
            del sys.modules[name]
    with h5py.File(path, "w") as h:
        h["meta/label_scheme"] = np.bytes_(blob)
    with datastore.DataStore(path) as ds:
        with pytest.raises(ValueError, match="TriploidLabelScheme"):
            ds.meta


def test_meta_json_wins_over_pickles(tmp_path):
    """Where a file holds a key both pickled under meta/ and as JSON under
    meta_json/, the JSON wins, as in medaka_tpu; a key only pickled is
    still read."""
    path = str(tmp_path / "both.hdf")
    with h5py.File(path, "w") as h:
        h["meta/label_scheme"] = np.bytes_(testing.reference_meta_pickle(
            label_scheme=labels.DiploidLabelScheme()))
        h["meta/feature_encoder"] = np.bytes_(testing.reference_meta_pickle(
            feature_encoder=features.CountsFeatureEncoder(
                normalise="fwd_rev")))
        h["meta_json/label_scheme"] = np.bytes_(
            b'{"type": "HaploidLabelScheme"}')
    with datastore.DataStore(path) as ours, \
            jax_datastore.DataStore(path) as theirs:
        assert type(ours.meta["label_scheme"]).__name__ == \
            type(theirs.meta["label_scheme"]).__name__ == "HaploidLabelScheme"
        assert ours.meta["feature_encoder"].normalise == \
            theirs.meta["feature_encoder"].normalise == "fwd_rev"


def test_medaka_loads_converts_meta_items():
    """convert_meta maps each pickled meta item as medaka_tpu's does."""
    from medaka_tpu import compat as jax_compat
    scheme = labels.DiploidLabelScheme()
    blob = testing.reference_meta_pickle(label_scheme=scheme)
    ours = compat.convert_meta("label_scheme", compat.medaka_loads(blob))
    theirs = jax_compat.convert_meta("label_scheme",
                                     jax_compat.medaka_loads(blob))
    assert type(ours).__name__ == type(theirs).__name__ == \
        "DiploidLabelScheme"
    enc = features.CountsFeatureEncoder(normalise="fwd_rev")
    blob = testing.reference_meta_pickle(feature_encoder=enc)
    ours = compat.convert_meta("feature_encoder", compat.medaka_loads(blob))
    theirs = jax_compat.convert_meta("feature_encoder",
                                     jax_compat.medaka_loads(blob))
    assert ours.to_dict() == theirs.to_dict() == enc.to_dict()
    assert compat.convert_meta("other", 5) == 5
