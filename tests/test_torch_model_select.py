"""Model selection from basecaller output and model download, the port
against ``medaka_tpu``.

- ``models.model_from_basecaller`` on FASTQs of both of dorado's comment
  forms and on BAMs with ``@RG`` ``DS`` fields
  (``testing.write_basecaller_fastq``/``write_basecaller_bam``) picks
  ``medaka_tpu``'s model, consensus or variant, with and without
  ``bacteria``, and raises the same errors: ``IOError`` for a file that is
  neither, ``ValueError`` for no or several basecallers and for a missing
  variant model, ``KeyError`` for an unknown basecaller.
- ``models.download_model`` and ``resolve_model``'s download branch
  through ``file://`` URLs and injected fetchers: a good bundle is cached
  and loads in both packages; a blob that does not load is deleted (no
  ``.part`` file) and its error raised; a raising fetcher gives
  ``DownloadError``. A model either package cached resolves and loads in
  the other. No test opens a socket: every URL is a ``file://`` path.
- ``tools resolve_model --auto_model``, ``tools download_models`` (rc 1 and
  ``FAILED`` lines where the template names no file) and
  ``tools list_models`` print ``medaka_tpu``'s bytes.
"""
import io
import os
import shutil
import socket
import contextlib

import pytest

from medaka_tpu import cli as jcli
from medaka_tpu import models as jmodels
from medaka_tpu import options as joptions
from medaka_tpu_torch import cli, models, options, testing

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "medaka_tpu", "data")
BUNDLE = os.path.join(DATA, "gru256_lambda_demo_model_pt.tar.gz")

#: basecallers with a variant model, without one, and one whose consensus
#: model takes the bacterial methylation model
BASECALLERS = ["dna_r10.4.1_e8.2_400bps_sup@v5.0.0",
               "dna_r10.4.1_e8.2_400bps_hac@v4.0.0",
               "dna_r9.4.1_e8_hac@v3.3",
               "dna_r10.4.1_e8.2_400bps_hac@v4.2.0",
               "dna_r10.3_450bps_hac"]


@pytest.fixture(autouse=True)
def no_sockets(monkeypatch):
    """Any socket a test opens fails it."""
    def refuse(*args, **kwargs):
        raise AssertionError("a test opened a socket")
    monkeypatch.setattr(socket, "socket", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)


@pytest.fixture(scope="module")
def synth_bam(tmp_path_factory):
    bam, _ = testing.create_synth_bam(
        str(tmp_path_factory.mktemp("bam") / "reads.bam"), ref_mb=0.005,
        depth=4, read_len=1000)
    return bam


def _both(fn_port, fn_jax):
    """(outcome, outcome): a return value, or the exception's type."""
    out = []
    for fn in (fn_port, fn_jax):
        try:
            out.append(fn())
        except Exception as e:  # noqa: BLE001 - compared by type
            out.append(type(e))
    return out


@pytest.mark.parametrize("bacteria", [False, True])
@pytest.mark.parametrize("variant", [False, True])
@pytest.mark.parametrize("kind", ["version_id", "rg", "bam"])
@pytest.mark.parametrize("basecaller", BASECALLERS)
def test_model_from_basecaller_matches(tmp_path, synth_bam, basecaller,
                                       kind, variant, bacteria):
    if kind == "bam":
        path = testing.write_basecaller_bam(
            synth_bam, str(tmp_path / "calls.bam"), [basecaller],
            max_records=20)
    else:
        path = testing.write_basecaller_fastq(
            str(tmp_path / "calls.fastq"), [basecaller], fmt=kind)
    got, want = _both(
        lambda: models.model_from_basecaller(path, variant, bacteria),
        lambda: jmodels.model_from_basecaller(path, variant, bacteria))
    assert got == want
    consensus, var = options.basecaller_models[basecaller]
    if variant and var is None:
        assert got is ValueError
    elif variant:
        assert got == var
    elif bacteria and consensus in options.bact_methyl_compatible_models:
        assert got == options.bact_methyl_model
    else:
        assert got == consensus


def _garbage(path):
    with open(path, "w") as fh:
        fh.write("neither a BAM nor a FASTQ\n")
    return path


ERRORS = {
    "neither": (IOError, lambda d, bam: _garbage(str(d / "x.txt"))),
    "no_model_fastq": (ValueError, lambda d, bam:
                       testing.write_basecaller_fastq(str(d / "a.fq"), [])),
    # a BAM that names no model is then read as a FASTQ, which fails
    "no_model_bam": (IOError, lambda d, bam: testing.write_basecaller_bam(
        bam, str(d / "a.bam"), [], max_records=5)),
    "two_models_fastq": (ValueError, lambda d, bam:
                         testing.write_basecaller_fastq(
                             str(d / "b.fq"), BASECALLERS[:2])),
    "two_models_bam": (ValueError, lambda d, bam:
                       testing.write_basecaller_bam(
                           bam, str(d / "b.bam"), BASECALLERS[:2],
                           max_records=5)),
    "unknown_basecaller": (KeyError, lambda d, bam:
                           testing.write_basecaller_fastq(
                               str(d / "c.fq"), ["dna_r99_unknown@v9"])),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_model_from_basecaller_errors(tmp_path, synth_bam, case):
    error, make = ERRORS[case]
    path = make(tmp_path, synth_bam)
    with pytest.raises(error):
        models.model_from_basecaller(path)
    with pytest.raises(error):
        jmodels.model_from_basecaller(path)


def test_bacteria_falls_back_with_a_warning(tmp_path, caplog):
    path = testing.write_basecaller_fastq(
        str(tmp_path / "r9.fq"), ["dna_r9.4.1_e8_hac@v3.3"])
    with caplog.at_level("WARNING"):
        got = models.model_from_basecaller(path, bacteria=True)
    assert got == "r941_min_hac_g507"
    assert "not compatible" in caplog.text


@pytest.mark.parametrize("kind", ["version_id", "rg", "bam"])
@pytest.mark.parametrize("auto", ["consensus", "variant"])
def test_cli_auto_model_prints_the_same(tmp_path, synth_bam, kind, auto):
    basecaller = BASECALLERS[0]
    if kind == "bam":
        path = testing.write_basecaller_bam(
            synth_bam, str(tmp_path / "c.bam"), [basecaller], max_records=5)
    else:
        path = testing.write_basecaller_fastq(
            str(tmp_path / "c.fq"), [basecaller], fmt=kind)
    outs = []
    for main in (cli.main, jcli.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["tools", "resolve_model", "--model", path,
                         "--auto_model", auto, "--bacteria"]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] != ""


# ---------------------------------------------------------------------------
# download
# ---------------------------------------------------------------------------

NAME = "r1041_e82_400bps_sup_v5.0.0"


def _published(tmp_path, blob=None):
    """A directory holding ``NAME``'s file (the counts demo bundle, or
    ``blob``), and its ``file://`` template."""
    root = tmp_path / "published"
    root.mkdir()
    target = root / (NAME + "_model_pt.tar.gz")
    if blob is None:
        shutil.copy(BUNDLE, str(target))
    else:
        target.write_bytes(blob)
    return "file://" + str(root) + "/{fname}"


@pytest.mark.parametrize("package", ["port", "medaka_tpu"])
def test_download_caches_a_bundle_both_load(tmp_path, package):
    template = _published(tmp_path)
    store = str(tmp_path / "store")
    download = models.download_model if package == "port" \
        else jmodels.download_model
    path = download(NAME, cache_dir=store, url_template=template)
    assert path == os.path.join(store, NAME + "_model_pt.tar.gz")
    assert os.listdir(store) == [os.path.basename(path)]
    with open(path, "rb") as a, open(BUNDLE, "rb") as b:
        assert a.read() == b.read()
    assert models.load_model(path).model.num_classes == 5
    assert jmodels.load_model(path).model is not None


@pytest.mark.parametrize("package", ["port", "medaka_tpu"])
def test_a_cached_model_resolves_in_the_other_package(
        tmp_path, monkeypatch, package):
    """Either package downloads into the user store ``~/.medaka_tpu/data``;
    the other resolves the name to that file and loads it."""
    monkeypatch.setenv("HOME", str(tmp_path))
    store = str(tmp_path / ".medaka_tpu" / "data")
    template = _published(tmp_path)
    if package == "port":
        models.download_model(NAME, cache_dir=store, url_template=template)
        got = jmodels.resolve_model(NAME, fetcher=_refuse)
        jmodels.load_model(got)
    else:
        jmodels.download_model(NAME, cache_dir=store, url_template=template)
        got = models.resolve_model(NAME, fetcher=_refuse)
        models.load_model(got)
    assert got == os.path.join(store, NAME + "_model_pt.tar.gz")


def _refuse(url):
    raise OSError("no network: " + url)


def test_resolve_downloads_a_known_model(tmp_path, monkeypatch):
    """resolve_model of a known name found nowhere downloads it into the
    user store, through the fetcher it is given."""
    monkeypatch.setenv("HOME", str(tmp_path))
    stores = {}
    for opts in (options, joptions):
        store = str(tmp_path / ("store_" + opts.__name__))
        monkeypatch.setattr(opts, "model_stores",
                            (opts.model_stores[0], store))
        stores[opts] = store
    fetched = []

    def fetch(url):
        fetched.append(url)
        with open(BUNDLE, "rb") as fh:
            return fh.read()
    got = models.resolve_model(NAME, fetcher=fetch)
    want = jmodels.resolve_model(NAME, fetcher=fetch)
    assert got == os.path.join(stores[options], NAME + "_model_pt.tar.gz")
    assert want == os.path.join(stores[joptions], NAME + "_model_pt.tar.gz")
    assert fetched[0] == fetched[1] == options.model_url_template.format(
        fname=NAME + "_model_pt.tar.gz")
    models.load_model(got)


@pytest.mark.parametrize("package", ["port", "medaka_tpu"])
def test_a_blob_that_does_not_load_is_deleted(tmp_path, package):
    template = _published(tmp_path, blob=b"not a tarball at all")
    store = str(tmp_path / "store")
    download = models.download_model if package == "port" \
        else jmodels.download_model
    with pytest.raises(Exception) as caught:
        download(NAME, cache_dir=store, url_template=template)
    assert not isinstance(caught.value, (models.DownloadError,
                                         jmodels.DownloadError))
    assert os.listdir(store) == []


def test_blob_errors_match(tmp_path):
    template = _published(tmp_path, blob=b"\x1f\x8b garbage")
    got, want = _both(
        lambda: models.download_model(NAME, cache_dir=str(tmp_path / "a"),
                                      url_template=template),
        lambda: jmodels.download_model(NAME, cache_dir=str(tmp_path / "b"),
                                       url_template=template))
    assert got == want and issubclass(got, Exception)
    assert os.listdir(str(tmp_path / "a")) == []


def test_a_raising_fetcher_gives_download_error(tmp_path):
    store = str(tmp_path / "store")
    with pytest.raises(models.DownloadError, match=NAME):
        models.download_model(NAME, fetcher=_refuse, cache_dir=store)
    with pytest.raises(jmodels.DownloadError, match=NAME):
        jmodels.download_model(NAME, fetcher=_refuse, cache_dir=store)
    assert not os.path.exists(store)
    # a file:// URL that names no file fails the same way
    with pytest.raises(models.DownloadError, match="Could not fetch"):
        models.download_model(
            NAME, cache_dir=store,
            url_template="file://" + str(tmp_path / "none") + "/{fname}")


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_download_models_without_the_files(tmp_path, monkeypatch):
    """``tools download_models`` where the template's files do not exist:
    rc 1 and one ``FAILED <name>: ...`` line a model, as
    ``medaka_tpu``'s."""
    template = "file://" + str(tmp_path / "nowhere") + "/{fname}"
    for opts in (options, joptions):
        monkeypatch.setattr(opts, "model_url_template", template)
        monkeypatch.setattr(opts, "model_stores", (
            opts.model_stores[0], str(tmp_path / "store")))
    for argv in (["tools", "download_models"],
                 ["tools", "download_models", "--models", NAME]):
        got, want = _stdout(cli.main, argv), _stdout(jcli.main, argv)
        assert got == want
        assert got[0] == 1
        lines = got[1].splitlines()
        assert len(lines) == (1 if "--models" in argv
                              else len(options.current_models))
        assert all(line.startswith("FAILED ") for line in lines)


def test_download_models_with_the_files(tmp_path, monkeypatch):
    template = _published(tmp_path)
    for opts in (options, joptions):
        monkeypatch.setattr(opts, "model_url_template", template)
        monkeypatch.setattr(opts, "model_stores", (
            opts.model_stores[0], str(tmp_path / "store")))
    argv = ["tools", "download_models", "--models", NAME]
    got = _stdout(cli.main, argv)
    want = _stdout(jcli.main, argv)
    assert got == want == (0, os.path.join(
        str(tmp_path / "store"), NAME + "_model_pt.tar.gz") + "\n")


@pytest.mark.parametrize("user_store", [False, True])
def test_list_models_prints_the_same(tmp_path, monkeypatch, user_store):
    monkeypatch.setenv("HOME", str(tmp_path))
    if user_store:
        store = tmp_path / ".medaka_tpu" / "data"
        store.mkdir(parents=True)
        (store / (NAME + "_model_pt.tar.gz")).write_bytes(b"")
    got = _stdout(cli.main, ["tools", "list_models"])
    want = _stdout(jcli.main, ["tools", "list_models"])
    assert got == want
    assert ("  " + NAME + "_model_pt.tar.gz" in got[1]) == user_store


def test_catalogue_matches():
    for name in ("default_models", "current_models", "basecaller_models",
                 "archived_models", "bact_methyl_model",
                 "bact_methyl_compatible_models", "deprecated_models",
                 "known_models", "allowed_models", "model_subdir",
                 "model_url_template", "alignment_params"):
        assert getattr(options, name) == getattr(joptions, name), name
    assert os.path.realpath(options.model_stores[0]) == \
        os.path.realpath(joptions.model_stores[0])
    assert options.model_stores[1] == joptions.model_stores[1]
    assert models.DATA_DIR == options.model_stores[0]
