"""The port's small helpers against ``medaka_tpu``'s on the CPU.

- ``io.fastx.write_fai`` and ``FastqWriter``: the bytes they write, over
  seeded FASTAs of several contigs, line widths and line endings, and
  FASTQ records with and without comments;
- ``io.bgzf.is_bgzf`` on BGZF, plain gzip, plain text, short and empty
  files;
- ``common.sliding_window`` at lengths with and without a remainder,
  several steps and both axes; ``grouper`` and ``roundrobin`` over uneven
  iterables; ``read_key_value_tsv`` (the ``tools rlebam`` read index) and
  ``ref_name_from_region_str``.
"""
import gzip
import itertools

import numpy as np
import pytest

from medaka_tpu import common as jcommon
from medaka_tpu.io import bgzf as jbgzf
from medaka_tpu.io import fastx as jfastx
from medaka_tpu_torch import common
from medaka_tpu_torch.io import bgzf, fastx


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _fasta_text(rng, width, newline):
    """Four contigs of seeded lengths (one empty) wrapped at ``width``."""
    lines = []
    for i, n in enumerate((int(rng.integers(1, 400)), 0, width,
                           int(rng.integers(400, 2000)))):
        seq = "".join(rng.choice(list("ACGT"), n))
        lines.append(">ctg{} some description".format(i))
        lines.extend(seq[k:k + width] for k in range(0, n, width))
    return newline.join(lines) + newline


@pytest.mark.parametrize("newline", ["\n", "\r\n"], ids=["lf", "crlf"])
@pytest.mark.parametrize("width", [1, 60, 80, 5000])
def test_write_fai(tmp_path, width, newline):
    path = str(tmp_path / "a.fasta")
    with open(path, "w", newline="") as fh:
        fh.write(_fasta_text(np.random.default_rng(width), width, newline))
    got = fastx.write_fai(path, str(tmp_path / "port.fai"))
    want = jfastx.write_fai(path, str(tmp_path / "jax.fai"))
    assert _read(got) == _read(want)
    # the default name, beside the FASTA
    assert fastx.write_fai(path) == path + ".fai"
    assert _read(path + ".fai") == _read(want)


def test_fastq_writer(tmp_path):
    rng = np.random.default_rng(5)
    records = []
    for i in range(12):
        n = int(rng.integers(0, 300))
        seq = "".join(rng.choice(list("ACGT"), n))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 60, n))
        comment = None if i % 3 == 0 else ("" if i % 3 == 1 else
                                          "RG:Z:x pos={}".format(i))
        records.append(("read{}".format(i), seq, qual, comment))
    for writer, name in ((fastx.FastqWriter, "port"),
                         (jfastx.FastqWriter, "jax")):
        with writer(str(tmp_path / (name + ".fastq"))) as fh:
            for name_, seq, qual, comment in records:
                fh.write(name_, seq, qual, comment=comment)
    assert _read(tmp_path / "port.fastq") == _read(tmp_path / "jax.fastq")


def _bgzf_file(path):
    with bgzf.BgzfWriter(path) as fh:
        fh.write(b"ACGT" * 20000)


def _gzip_file(path):
    with gzip.open(path, "wb") as fh:
        fh.write(b"ACGT" * 100)


def _write(data):
    def make(path):
        with open(path, "wb") as fh:
            fh.write(data)
    return make


@pytest.mark.parametrize("kind,make,want", [
    ("bgzf", _bgzf_file, True),
    ("gzip", _gzip_file, False),
    ("plain", _write(b">a\nACGT\n" * 10), False),
    ("short", _write(b"\x1f\x8b\x08\x04"), False),
    ("empty", _write(b""), False)], ids=lambda v: v if isinstance(v, str)
    else None)
def test_is_bgzf(tmp_path, kind, make, want):
    path = str(tmp_path / kind)
    make(path)
    assert bgzf.is_bgzf(path) == jbgzf.is_bgzf(path) == want


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("window,step", [(3, 1), (4, 2), (5, 5), (7, 3)])
@pytest.mark.parametrize("length", [7, 10, 12, 20])
def test_sliding_window(axis, window, step, length):
    """Lengths that the steps tile exactly and ones that leave a
    remainder, which both emit as a last window at the array's end."""
    a = np.arange(length * 3).reshape(length, 3)
    a = a if axis == 0 else a.T.copy()
    got = list(common.sliding_window(a, window, step, axis))
    want = list(jcommon.sliding_window(a, window, step, axis))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("n,batch", [(0, 4), (1, 4), (8, 4), (9, 4),
                                     (10, 3), (5, 1)])
def test_grouper(n, batch):
    got = list(common.grouper(iter(range(n)), batch))
    assert got == list(jcommon.grouper(iter(range(n)), batch))
    assert list(itertools.chain(*got)) == list(range(n))


@pytest.mark.parametrize("lengths", [(), (0,), (3,), (3, 1, 4),
                                     (0, 5, 2), (2, 2, 2)])
def test_roundrobin(lengths):
    iterables = [["{}{}".format(chr(97 + i), k) for k in range(n)]
                 for i, n in enumerate(lengths)]
    got = list(common.roundrobin(*(iter(x) for x in iterables)))
    assert got == list(jcommon.roundrobin(*(iter(x) for x in iterables)))
    assert sorted(got) == sorted(itertools.chain(*iterables))


def test_read_key_value_tsv(tmp_path):
    """A read index as ``tools rlebam`` reads it: blank lines skipped, a
    value may hold tabs, a later key wins."""
    path = str(tmp_path / "index.tsv")
    with open(path, "w") as fh:
        fh.write("r1\t/a/b.fast5\n\nr2\t/c d.fast5\textra\nr1\t/e.fast5\n")
    got = common.read_key_value_tsv(path)
    assert got == jcommon.read_key_value_tsv(path)
    assert got == {"r1": "/e.fast5", "r2": "/c d.fast5\textra"}


def test_ref_name_from_region_str():
    regions = ["chr1:100-200", "chr2", "chr1", "chr10:5-6", "chr2:1-2"]
    got = common.ref_name_from_region_str(regions)
    assert sorted(got) == sorted(jcommon.ref_name_from_region_str(regions))
    assert sorted(got) == ["chr1", "chr10", "chr2"]
