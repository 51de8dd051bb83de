"""The port's fast5 reading, ``compress_bam --use_fast5_info`` and
``rlebam`` against medaka_tpu's, on the CPU.

The fast5 files are the JAX tests' mock (``tests/mock_data.py``, written
by h5py: contiguous compound tables with big-endian floats) and the
port's ``testing.create_mock_fast5`` (gzip-chunked little-endian tables,
as ONT writes them), read by both packages.
"""
import io
import os

import h5py
import numpy as np
import pytest

from medaka_tpu import rle as jax_rle
from medaka_tpu.io import fast5 as jax_fast5
from medaka_tpu_torch import cli, common, rle, testing
from medaka_tpu_torch.io import fast5
from medaka_tpu_torch.io.bam import BamReader
from tests import mock_data
from tests.torch_threads import one_thread  # noqa: F401

_DECOY = np.array([(b"A", 9.0, 9.0), (b"C", 9.0, 9.0)],
                  dtype=[("base", "S1"), ("shape", ">f4"), ("scale", ">f4")])


def _port_mock(path):
    """mock_data's reads as the port's writer lays them out."""
    reads = []
    for name, seq, _q, _c, _m, flag, tags in mock_data.CALLS:
        shape, scale = np.float32(tags["WL"]), np.float32(tags["WK"])
        if flag & 16:
            seq = common.reverse_complement(seq)
            shape, scale = shape[::-1], scale[::-1]
        reads.append((name, seq, shape, scale))
    return testing.create_mock_fast5(path, reads)


_WRITERS = {"h5py_mock": mock_data.create_mock_fast5, "port": _port_mock}


@pytest.fixture(params=list(_WRITERS))
def fast5_dir(request, tmp_path):
    """A fast5 of the mock reads, a re-basecalled decoy (Basecall_1D_001,
    another table) for the first read, a summary, and the mock BAM and
    reference."""
    path = _WRITERS[request.param](str(tmp_path / "mock.fast5"))
    with h5py.File(path, "a") as h5:
        h5.create_dataset(
            "read_{}/Analyses/Basecall_1D_001/BaseCalled_template/"
            "RunlengthBasecall".format(mock_data.CALLS[0][0]), data=_DECOY)
    mock_data.create_mock_summary(str(tmp_path / "summary.txt"),
                                  "mock.fast5")
    mock_data.create_simple_bam(str(tmp_path / "in.bam"))
    with open(str(tmp_path / "ref.fasta"), "w") as fh:
        fh.write(">{}\n{}\n".format(mock_data.REF_NAME, mock_data.REF_SEQ))
    return tmp_path


def test_fast5_readers_match_medaka_tpu(fast5_dir):
    """get_runlength_basecall (latest and pinned analysis),
    latest_analysis, read_summary_index and Fast5Index equal
    medaka_tpu's, the decoy winning as the latest analysis only."""
    path = str(fast5_dir / "mock.fast5")
    summary = str(fast5_dir / "summary.txt")
    assert fast5.read_summary_index(summary) == \
        jax_fast5.read_summary_index(summary)
    ours = fast5.Fast5Index(str(fast5_dir), summary)
    theirs = jax_fast5.Fast5Index(str(fast5_dir), summary)
    for name, *_ in mock_data.CALLS:
        assert (name in ours) == (name in theirs)
        for analysis in (None, "Basecall_1D_000"):
            a = fast5.get_runlength_basecall(path, name, analysis)
            b = jax_fast5.get_runlength_basecall(path, name, analysis)
            assert a[0] == b[0]
            for x, y in zip(a[1:], b[1:]):
                assert x.dtype == np.float32
                np.testing.assert_array_equal(x, y)
        a, b = ours.get_rl_params(name), theirs.get_rl_params(name)
        assert a[0] == b[0] and a[0] != "AC"
        np.testing.assert_array_equal(a[1], b[1])
    assert ours.path_for(mock_data.CALLS[0][0]) == path
    first = mock_data.CALLS[0][0]
    assert fast5.get_runlength_basecall(path, first)[0] == "AC"
    from medaka_tpu_torch.io import hdf5
    with hdf5.File(path) as h, h5py.File(path, "r") as j:
        group = "read_" + first
        assert fast5.latest_analysis(h[group]) == \
            jax_fast5.latest_analysis(j[group]) == "Basecall_1D_001"
    with pytest.raises(KeyError):
        fast5.get_runlength_basecall(path, "missing_read")


def test_single_read_layout(tmp_path):
    """Analyses at the file root (a single-read fast5), gzip-chunked."""
    path = str(tmp_path / "single.fast5")
    with h5py.File(path, "w") as h5:
        h5.create_dataset("Analyses/Basecall_1D_000/BaseCalled_template/"
                          "RunlengthBasecall", data=_DECOY,
                          compression="gzip", chunks=(1,))
    a = fast5.get_runlength_basecall(path, "any")
    b = jax_fast5.get_runlength_basecall(path, "any")
    assert a[0] == b[0] == "AC"
    np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.parametrize("drop", [False, True], ids=["all", "missing_read"])
def test_compress_bam_use_fast5_info_matches_medaka_tpu(fast5_dir, drop):
    """compress_bam --use_fast5_info (through the CLI) writes a BAM
    byte-identical to medaka_tpu's, WL/WK tags included; a read the
    summary does not name is skipped in both."""
    d = fast5_dir
    summary = str(d / "summary.txt")
    if drop:
        lines = open(summary).read().splitlines()
        open(summary, "w").write("\n".join(lines[:-1]) + "\n")
    ours, theirs = str(d / "ours.bam"), str(d / "theirs.bam")
    assert cli.main(["compress_bam", str(d / "in.bam"), ours,
                     str(d / "ref.fasta"), "--use_fast5_info", str(d),
                     summary]) == 0
    jax_rle.compress_bam(str(d / "in.bam"), theirs, str(d / "ref.fasta"),
                         use_fast5_info=(str(d), summary))
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    with BamReader(ours) as br:
        recs = {r.query_name: r for r in br}
    expected = {name: tags for name, *_, tags in mock_data.CALLS}
    assert len(recs) == len(expected) - int(drop)
    for name, rec in recs.items():
        np.testing.assert_allclose(rec.tags["WL"], expected[name]["WL"],
                                   rtol=1e-6)
        np.testing.assert_allclose(rec.tags["WK"], expected[name]["WK"],
                                   rtol=1e-6)


def test_compress_bam_tags_equal_planted(tmp_path):
    """On a synthetic BAM, the tags equal the tables
    ``testing.plant_fast5_tables`` planted (flipped for reverse reads),
    and the BAM equals medaka_tpu's."""
    bam, ref = testing.create_synth_bam(str(tmp_path / "r.bam"),
                                        ref_mb=0.004, depth=4,
                                        read_len=1000, seed=2)
    planted = testing.plant_fast5_tables(
        bam, str(tmp_path / "p.fast5"), str(tmp_path / "s.txt"), seed=5)
    info = (str(tmp_path), str(tmp_path / "s.txt"))
    ours, theirs = str(tmp_path / "o.bam"), str(tmp_path / "t.bam")
    rle.compress_bam(bam, ours, ref, threads=2, use_fast5_info=info)
    jax_rle.compress_bam(bam, theirs, ref, use_fast5_info=info)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    with BamReader(ours) as br:
        recs = list(br)
    assert len(recs) == len(planted) > 5
    for rec in recs:
        shape, scale = planted[rec.query_name]
        np.testing.assert_array_equal(rec.tags["WL"], shape)
        np.testing.assert_array_equal(rec.tags["WK"], scale)


def test_rlebam_matches_medaka_tpu(fast5_dir):
    """rlebam (spawned workers) decorates a SAM stream as medaka_tpu's
    does: the same lines, header and an unindexed read passed through."""
    d = fast5_dir
    sam = testing.write_sam(str(d / "in.bam"), str(d / "in.sam"))
    index = str(d / "index.tsv")
    with open(index, "w") as fh:
        for name, *_ in mock_data.CALLS[:-1]:
            fh.write("{}\t{}\n".format(name, d / "mock.fast5"))
    outs = []
    for module in (rle, jax_rle):
        out = io.StringIO()
        with open(sam) as fh:
            module.rlebam(index, workers=2, input_sam=fh, output=out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    lines = outs[0].splitlines()
    assert lines[0].startswith("@SQ")
    tagged = [ln for ln in lines[1:] if "\tWL:B:f," in ln]
    assert len(tagged) == len(mock_data.CALLS) - 1
    assert os.path.exists(sam)


def test_rlebam_worker_failure_raises(fast5_dir):
    """A worker that cannot read its fast5 raises in the caller."""
    d = fast5_dir
    sam = testing.write_sam(str(d / "in.bam"), str(d / "in.sam"))
    index = str(d / "index.tsv")
    with open(index, "w") as fh:
        fh.write("{}\t{}\n".format(mock_data.CALLS[0][0], d / "absent.fast5"))
    with open(sam) as fh, pytest.raises(FileNotFoundError):
        rle.rlebam(index, workers=1, input_sam=fh, output=io.StringIO())
