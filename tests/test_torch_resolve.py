"""The port's ``models.resolve_model`` against ``medaka_tpu``'s.

``--model`` takes a path or a model name in both packages: the path as
given, then the bundles in ``medaka_tpu/data``, then ``~/.medaka_tpu/data``,
each with the suffixes ``_model_pt.tar.gz``, ``.tar.gz`` and none. A known
model that is not on disk is downloaded (its fetcher is injected here, so
nothing is fetched; ``tests/test_torch_model_select.py`` tests the
download).
"""
import os

import numpy as np
import pytest

from medaka_tpu import models as jax_models
from medaka_tpu import options as jax_options
from medaka_tpu_torch import cli, datastore, models, options, testing
from tests.torch_threads import one_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "medaka_tpu", "data")
BUNDLES = sorted(name for name in os.listdir(DATA)
                 if name.endswith(".tar.gz"))


def _names():
    """Each bundled file by its file name, without ".tar.gz" and, where it
    has one, without "_model_pt.tar.gz"."""
    out = []
    for fname in BUNDLES:
        out.append(fname)
        stem = fname[:-len(".tar.gz")]
        out.append(stem)
        if stem.endswith("_model_pt"):
            out.append(stem[:-len("_model_pt")])
    return out


@pytest.fixture
def empty_home(tmp_path, monkeypatch):
    """No user model store: both packages see only the bundled files."""
    monkeypatch.setenv("HOME", str(tmp_path))
    return tmp_path


def test_catalogue_matches():
    assert options.known_models == jax_options.known_models
    assert options.deprecated_models == jax_options.deprecated_models


@pytest.mark.parametrize("name", _names())
def test_bundled_names_resolve_alike(name, empty_home):
    got = models.resolve_model(name)
    want = jax_models.resolve_model(name)
    assert os.path.realpath(got) == os.path.realpath(want)
    assert os.path.dirname(os.path.realpath(got)) == os.path.realpath(DATA)


def test_a_path_resolves_to_itself(tmp_path, empty_home):
    path = os.path.join(DATA, "gru256_variant_demo.tar.gz")
    assert models.resolve_model(path) == jax_models.resolve_model(path) \
        == path
    # a file anywhere, by its path, even where its name is a model's
    other = tmp_path / "r941_min_sup_g507"
    other.write_bytes(b"")
    assert models.resolve_model(str(other)) == str(other)


def test_the_user_store_is_searched(empty_home):
    store = empty_home / ".medaka_tpu" / "data"
    store.mkdir(parents=True)
    (store / "my_model_model_pt.tar.gz").write_bytes(b"")
    got = models.resolve_model("my_model")
    assert got == jax_models.resolve_model("my_model")
    assert got == str(store / "my_model_model_pt.tar.gz")


def test_unknown_name_raises(empty_home):
    with pytest.raises(FileNotFoundError, match="Could not resolve"):
        models.resolve_model("no_such_model")
    with pytest.raises(FileNotFoundError):
        jax_models.resolve_model("no_such_model")


def test_known_name_not_on_disk_raises_without_download(empty_home):
    """A known model that is not on disk is downloaded; where the fetch
    fails (its fetcher is injected here, so nothing is fetched) both
    packages raise FileNotFoundError naming the model, and leave nothing
    in the user store."""
    name = "r1041_e82_400bps_sup_v5.2.0"
    assert name in options.known_models
    with pytest.raises(FileNotFoundError, match=name):
        models.resolve_model(name, fetcher=_refuse)
    with pytest.raises(FileNotFoundError, match=name):
        jax_models.resolve_model(name, fetcher=_refuse)
    store = empty_home / ".medaka_tpu" / "data"
    assert not store.exists() or not os.listdir(store)


def _refuse(url):
    raise OSError("no network: " + url)


@pytest.mark.parametrize("name", ["r941_min_high_g360",
                                  "r941_min_high_g340_rle"])
def test_deprecated_name_raises(name, empty_home):
    with pytest.raises(options.DeprecationError, match=name):
        models.resolve_model(name)
    with pytest.raises(jax_options.DeprecationError):
        jax_models.resolve_model(name)


def test_cli_inference_takes_a_model_name(tmp_path):
    """``inference --cpu --model gru256_lambda_demo`` runs through the
    port's CLI on a tiny BAM and writes the bundle's probabilities."""
    bam, _ = testing.create_synth_bam(str(tmp_path / "reads.bam"),
                                      ref_mb=0.004, depth=4, read_len=1000)
    out = str(tmp_path / "probs.hdf")
    assert cli.main(["inference", bam, out, "--model", "gru256_lambda_demo",
                     "--cpu", "--chunk_len", "1000", "--chunk_ovlp", "100",
                     "--batch_size", "4"]) == 0
    index = datastore.DataIndex(out)
    assert index.samples
    with datastore.DataStore(out) as ds:
        probs = ds.load_sample(index.samples[0][0]).label_probs
    assert probs.shape[1] == 5 and np.all(np.isfinite(probs))
