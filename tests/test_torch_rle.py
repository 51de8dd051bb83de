"""The run-length (RLE) model family of the port against medaka_tpu.

- ``rle.RLEConverter``, ``compress_seq``, ``fastrle`` and ``compress_bam``
  (reads re-aligned in compressed space by the native aligner): the same
  FASTQ and BAM bytes as ``medaka_tpu.rle``.
- ``HardRLEFeatureEncoder``, ``SymHardRLEFeatureEncoder`` and
  ``SoftRLEFeatureEncoder`` (Weibull partial counts from WL/WK tags
  planted on the reads): the same features as medaka_tpu's.
- ``RLELabelScheme``: the same truth labels and decodes.
- End to end: ``compress_bam``, ``inference --model gru256_rle_demo``
  and ``sequence`` against the compact draft over the first 4 kb
  (compact): in float32 the expanded FASTA is medaka_tpu's byte for
  byte; in bf16 it is too (no near tie there).
"""
import io
import os

import jax
import numpy as np
import pytest
import torch

from medaka_tpu import features as jax_features
from medaka_tpu import labels as jax_labels
from medaka_tpu import prediction as jax_prediction
from medaka_tpu import rle as jax_rle
from medaka_tpu import stitch as jax_stitch
from medaka_tpu.common import Region as JaxRegion
from medaka_tpu.io.bam import BamReader as JaxBamReader
from medaka_tpu_torch import cli, features, labels, rle, testing
from medaka_tpu_torch.common import Region, Sample
from medaka_tpu_torch.io.bam import BamReader, BamRecord, write_bam
from medaka_tpu_torch.io.fastx import FastaReader, FastaWriter, FastxRecord

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTIG = "synth"
#: the compact region of the end-to-end runs
E2E_END = 4000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's CPU operators on one thread for this module (restored
    after it): the CPU routes run many small operators a step, which the
    suite's parallel workers slow many times over when each spreads them
    over every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A 12 kb genome at depth 10 (2 kb reads at ~96% identity), its
    RLE-compressed BAM (by the port) and compact draft."""
    d = tmp_path_factory.mktemp("rle")
    bam, draft = testing.create_synth_bam(str(d / "reads.bam"),
                                          ref_mb=0.012, depth=10, seed=5,
                                          read_len=2000)
    rle_bam = rle.compress_bam(bam, str(d / "rle.bam"), draft, threads=2)
    compact = str(d / "compact.fasta")
    with FastaWriter(compact) as fw:
        fw.write(CONTIG, rle.RLEConverter(
            FastaReader(draft).fetch(CONTIG)).compact_basecall)
    return bam, draft, rle_bam, compact


def test_converter_and_compress_seq():
    """Coordinates and compressed records of medaka_tpu's converter,
    including a run past the 93 a phred character holds."""
    seq = "AAACGGGGTTA" + "C" * 100 + "GT"
    ours, theirs = rle.RLEConverter(seq), jax_rle.RLEConverter(seq)
    assert ours.compact_basecall == theirs.compact_basecall == "ACGTACGT"
    np.testing.assert_array_equal(ours.homop_length, theirs.homop_length)
    for start, end in ((0, 3), (2, 9), (5, 112), (1, len(seq))):
        assert ours.transform_coords(start, end) == \
            theirs.transform_coords(start, end)
        assert ours.trimmed_compact(start, end) == \
            theirs.trimmed_compact(start, end)
    assert ours.coord_compact_to_full(5) == theirs.coord_compact_to_full(5)
    rec = FastxRecord(name="r", comment="c", sequence=seq, quality=None)
    got = rle.compress_seq(rec)
    want = jax_rle.compress_seq(rec)
    assert (got.name, got.sequence, got.quality) == \
        (want.name, want.sequence, want.quality)
    assert rle.add_extra_clipping("3S10M2I4M", 2, 5) == \
        jax_rle.add_extra_clipping("3S10M2I4M", 2, 5) == "5S10M2I4M5S"


@pytest.mark.parametrize("block_size", [94, 5])
def test_fastrle_matches(synth, tmp_path, block_size):
    """``fastrle`` of the reads' FASTQ (and a FASTA with a 12-base run,
    split into blocks at ``block_size`` 5): medaka_tpu's bytes, also
    through the command line."""
    bam = synth[0]
    fastq = str(tmp_path / "reads.fastq")
    testing.write_reads_fastq(bam, fastq)
    fasta = str(tmp_path / "runs.fasta")
    with open(fasta, "w") as fh:
        fh.write(">x\nACGT" + "G" * 12 + "TTAC\n")
    for path in (fastq, fasta):
        want, got = io.StringIO(), io.StringIO()
        jax_rle.fastrle(path, want, block_size=block_size)
        rle.fastrle(path, got, block_size=block_size)
        assert got.getvalue() == want.getvalue() and got.getvalue()
    out = str(tmp_path / "cli.fastq")
    assert cli.main(["fastrle", fastq, "--output", out, "--block_size",
                     str(block_size)]) == 0
    want = io.StringIO()
    jax_rle.fastrle(fastq, want, block_size=block_size)
    with open(out) as fh:
        assert fh.read() == want.getvalue()


def test_compress_bam_matches(synth, tmp_path):
    """The port's compressed BAM (native SW in RLE space, 2 threads) is
    medaka_tpu's, byte for byte, and the command line writes it too."""
    bam, draft, rle_bam, _ = synth
    want = jax_rle.compress_bam(bam, str(tmp_path / "jax.bam"), draft,
                                threads=2)
    with open(rle_bam, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    out = str(tmp_path / "cli.bam")
    assert cli.main(["compress_bam", bam, out, draft, "--regions",
                     "synth:0-12000"]) == 0
    with open(out, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    with BamReader(rle_bam) as reader:
        recs = list(reader.fetch(CONTIG))
        assert reader.lengths[0] < 12000 and len(recs) > 40
    assert all(int(r.query_qualities.max()) > 1 for r in recs)


def test_fast5_paths_are_refused(synth, tmp_path):
    """compress_bam --use_fast5_info over the synthetic genome's first
    3 kb tags every read with the tables planted in its fast5, in a BAM
    byte-identical to medaka_tpu's; only a fast5 whose tables use a codec
    the port lacks (ONT's vbz) is refused, naming it."""
    from medaka_tpu_torch.io import hdf5
    bam, draft, _, _ = synth
    region = Region(CONTIG, 0, 3000)
    fast5 = str(tmp_path / "reads.fast5")
    summary = str(tmp_path / "summary.txt")
    planted = testing.plant_fast5_tables(bam, fast5, summary, seed=1,
                                         region=region)
    out, want = str(tmp_path / "x.bam"), str(tmp_path / "want.bam")
    assert cli.main(["compress_bam", bam, out, draft, "--regions",
                     "{}:0-3000".format(CONTIG), "--threads", "2",
                     "--use_fast5_info", str(tmp_path), summary]) == 0
    jax_rle.compress_bam(bam, want, draft,
                         regions=[JaxRegion(CONTIG, 0, 3000)],
                         use_fast5_info=(str(tmp_path), summary))
    with open(out, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    with BamReader(out) as reader:
        recs = list(reader)
    assert len(recs) == len(planted) > 5
    for rec in recs:
        np.testing.assert_array_equal(rec.tags["WL"],
                                      planted[rec.query_name][0])
        np.testing.assert_array_equal(rec.tags["WK"],
                                      planted[rec.query_name][1])
    deflate = hdf5._encode_filters_deflate()
    data = open(fast5, "rb").read()
    open(fast5, "wb").write(data.replace(
        deflate, deflate[:8] + (32020).to_bytes(2, "little") + deflate[10:]))
    with pytest.raises(hdf5.HDF5Error, match="vbz"):
        rle.compress_bam(bam, str(tmp_path / "y.bam"), draft,
                         regions=[region], use_fast5_info=(str(tmp_path),
                                                           summary))


def _weibull_bam(rle_bam, path):
    """The compressed BAM with WL/WK float arrays planted on every read
    but the first (a read without tags counts nothing)."""
    rng = np.random.default_rng(9)
    out = []
    with BamReader(rle_bam) as reader:
        refs = list(zip(reader.references, reader.lengths))
        for i, rec in enumerate(reader.fetch(CONTIG)):
            n = len(rec.query_sequence)
            tags = {} if i == 0 else {
                "WL": rng.uniform(0.5, 4.0, n).astype(np.float32),
                "WK": rng.uniform(0.5, 8.0, n).astype(np.float32)}
            out.append(BamRecord.build(
                query_name=rec.query_name, ref_id=rec.ref_id, pos=rec.pos,
                seq=rec.query_sequence, qual=rec.query_qualities,
                cigar=rec.cigarstring, flag=rec.flag, mapq=rec.mapq,
                tags=tags))
    write_bam(path, out, refs)
    return path


@pytest.mark.parametrize("name,kwargs", [
    ("HardRLEFeatureEncoder", {"num_qstrat": 12}),
    ("SymHardRLEFeatureEncoder", {"num_qstrat": 12}),
    ("SoftRLEFeatureEncoder", {"num_qstrat": 12}),
    ("HardRLEFeatureEncoder", {"num_qstrat": 5, "normalise": "fwd_rev"})])
def test_encoders_match(synth, tmp_path, name, kwargs):
    """Each encoder's samples over the compressed BAM (with WL/WK tags
    for the soft encoder) equal medaka_tpu's: features, positions and
    depth, bit for bit."""
    rle_bam = synth[2]
    if name.startswith("Soft"):
        rle_bam = _weibull_bam(rle_bam, str(tmp_path / "weibull.bam"))
    with BamReader(rle_bam) as reader:
        length = reader.lengths[0]
    ours = features.from_dict({"type": name, "kwargs": kwargs})
    theirs = jax_features.from_dict({"type": name, "kwargs": kwargs})
    assert ours.to_dict() == theirs.to_dict()
    assert ours.feature_vector_length == 10 * kwargs["num_qstrat"]
    for start, end in ((0, length), (1000, 2500)):
        got = ours.bam_to_sample(rle_bam, Region(CONTIG, start, end))
        want = theirs.bam_to_sample(rle_bam, JaxRegion(CONTIG, start, end))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.features.dtype == w.features.dtype == np.float32
            np.testing.assert_array_equal(g.features, w.features)
            np.testing.assert_array_equal(g.positions, w.positions)
            np.testing.assert_array_equal(g.depth, w.depth)
        assert np.count_nonzero(got[0].features[:, 10:]) > 0


def test_weibull_counts_match(synth, tmp_path):
    """``pileup_counts(weibull_summation=True)``: medaka_tpu's scaled
    partial counts, a read without tags counting nothing."""
    rle_bam = _weibull_bam(synth[2], str(tmp_path / "weibull.bam"))
    got = features.pileup_counts(Region(CONTIG, 0, 3000), rle_bam,
                                 num_qstrat=12, weibull_summation=True)
    want = jax_features.pileup_counts(JaxRegion(CONTIG, 0, 3000), rle_bam,
                                      num_qstrat=12, weibull_summation=True)
    assert len(got) == len(want)
    for (gc, gp), (wc, wp) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gp, wp)
    assert got[0][0].max() > features.WEIBULL_SCALE // 2


def test_label_scheme_encodes_and_decodes_as_medaka_tpu(synth):
    """Truth labels of a compressed truth read, the padding vector, the
    49 classes, and run-expanding decodes with qualities."""
    rle_bam = synth[2]
    ours, theirs = labels.RLELabelScheme(12), jax_labels.RLELabelScheme(12)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.num_classes == theirs.num_classes == 49
    assert ours._encoding == theirs._encoding
    assert ours.padding_vector == theirs.padding_vector == 0
    with BamReader(rle_bam) as reader:
        rec = next(iter(reader.fetch(CONTIG)))
    with JaxBamReader(rle_bam) as reader:
        jrec = next(iter(reader.fetch(CONTIG)))
    got = list(ours._alignment_to_pairs(rec))
    want = list(theirs._alignment_to_pairs(jrec))
    assert got == want and len(got) > 100
    enc = ours._labels_to_encoded_labels([(p,) for _, p in got])
    np.testing.assert_array_equal(
        enc, theirs._labels_to_encoded_labels([(p,) for _, p in want]))
    probs = np.random.default_rng(3).dirichlet(
        np.full(49, 0.2), 200).astype(np.float32)
    sample = Sample(ref_name=CONTIG, features=None, labels=None,
                    ref_seq=None, positions=None, label_probs=probs,
                    depth=None)
    for quals in (False, True):
        assert ours.decode_consensus(sample, with_qualities=quals) == \
            theirs.decode_consensus(sample, with_qualities=quals)
    with pytest.raises(NotImplementedError):
        ours.decode_variants(sample, "ACGT")
    with pytest.raises(NotImplementedError):
        ours._prob_to_snp()
    assert labels.from_dict(ours.to_dict()).max_run == 12


def test_direct_route_refuses_the_scheme():
    from medaka_tpu_torch.prediction import _check_direct_scheme
    with pytest.raises(ValueError, match="RLELabelScheme"):
        _check_direct_scheme(labels.RLELabelScheme())


@pytest.fixture(scope="module")
def e2e(synth, tmp_path_factory):
    """``inference --model gru256_rle_demo`` + ``sequence`` on the
    compressed BAM over its first ``E2E_END`` compact columns against the
    compact draft, by both packages (medaka_tpu on one JAX device), in
    float32 and bf16."""
    _, _, rle_bam, compact = synth
    d = tmp_path_factory.mktemp("e2e")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    model = os.path.join(REPO, "medaka_tpu", "data", "gru256_rle_demo.tar.gz")
    out = {}
    for full in (True, False):
        tag = "f32" if full else "bf16"
        hdfs = {k: str(d / "{}_{}.hdf".format(k, tag))
                for k in ("port", "jax")}
        region = "{}:0-{}".format(CONTIG, E2E_END)
        args = ["inference", rle_bam, hdfs["port"], "--model",
                "gru256_rle_demo", "--chunk_len", "1000", "--chunk_ovlp",
                "200", "--batch_size", "8", "--regions", region, "--cpu"]
        assert cli.main(args + (["--full_precision"] if full else [])) == 0
        jax_region = [JaxRegion(CONTIG, 0, E2E_END)]
        jax_prediction.predict(
            rle_bam, hdfs["jax"], model_path=model, batch_size=8,
            chunk_len=1000, chunk_overlap=200, full_precision=full,
            mesh=mesh, regions=jax_region)
        fastas = {}
        for k in ("port", "jax"):
            path = str(d / "{}_{}.fasta".format(k, tag))
            if k == "port":
                assert cli.main(["sequence", hdfs[k], compact, path,
                                 "--regions", region, "--no-fillgaps"]) == 0
            else:
                jax_stitch.stitch_to_fasta(hdfs[k], compact, path,
                                           regions=jax_region,
                                           fillgaps=False)
            with open(path, "rb") as fh:
                fastas[k] = fh.read()
        out[tag] = fastas
    return out


@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_rle_consensus_matches(e2e, synth, tag):
    """The expanded consensus (``--no-fillgaps``: the polished piece of
    the region, named with its compact span) is medaka_tpu's byte for
    byte (in bf16 too: measured 0 differing columns there) and expands
    the runs: longer than its compact span, about as long as the draft's
    bases there."""
    fastas = e2e[tag]
    assert fastas["port"] == fastas["jax"]
    header, seq = fastas["port"].decode().split("\n", 1)
    seq = seq.replace("\n", "")
    start, stop = (int(v) for v in header.split()[1].split("-"))
    conv = rle.RLEConverter(FastaReader(synth[1]).fetch(CONTIG))
    full = (conv.coord_compact_to_full(stop)
            - conv.coord_compact_to_full(start))
    assert stop - start < len(seq) and stop - start > E2E_END // 2
    assert abs(len(seq) - full) < 0.05 * full
