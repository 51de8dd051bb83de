"""The port's direct route (decode on the device, no probability file).

``prediction.predict_direct`` must write the same bytes as the HDF5 route
(``prediction.predict`` + ``stitch.stitch_to_fasta``), and the same as
``medaka_tpu.prediction.predict_direct``, on a synthetic 20 kb BAM at
batch 8 on the CPU; also with the stitch windows and work regions shrunk
so that samples span work-region overlaps and region events arrive out of
order (``tests/test_workflows.py:594``). The runs are full precision: the
f32 scans of the two packages give the same quality characters, where
their bf16 CPU routes round at other points (ROADMAP.md section 3) and
move a few; the bf16 kernels' direct route is held against the HDF5 route
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import os

import jax
import numpy as np
import pytest

from medaka_tpu import prediction as jax_prediction
from medaka_tpu_torch import labels, prediction, stitch, testing
from tests.torch_threads import one_thread  # noqa: F401

MODEL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "medaka_tpu", "data",
    "gru256_lambda_demo_model_pt.tar.gz")
RUN = dict(model_path=MODEL, chunk_len=1000, chunk_overlap=100,
           batch_size=8, full_precision=True)
BED = ".gaps_in_draft_coords.bed"


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("direct")
    bam, draft = testing.create_synth_bam(
        str(d / "reads.bam"), ref_mb=0.02, depth=10, read_len=2000, seed=7)
    return d, bam, draft


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _hdf5_route(d, bam, draft, tag, **kw):
    hdf = str(d / (tag + ".hdf"))
    out = str(d / (tag + ".fastq"))
    prediction.predict(bam, hdf, device="cpu", **RUN, **kw)
    stitch.stitch_to_fasta(hdf, draft, out, qualities=True)
    return out


@pytest.fixture(scope="module")
def routes(synth):
    """The port's HDF5 and direct routes and medaka_tpu's direct route,
    FASTQ with qualities. medaka_tpu runs on one device, as the port
    does (tests/test_torch_pipeline.py)."""
    d, bam, draft = synth
    out = {"hdf5": _hdf5_route(d, bam, draft, "hdf5")}
    out["direct"] = str(d / "direct.fastq")
    prediction.predict_direct(bam, out["direct"], draft, qualities=True,
                              device="cpu", **RUN)
    out["jax"] = str(d / "jax_direct.fastq")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jax_prediction.predict_direct(bam, out["jax"], draft, qualities=True,
                                  mesh=mesh, **RUN)
    return out


def test_direct_matches_hdf5_route(routes):
    """FASTQ and gaps bed byte-identical to predict + stitch_to_fasta."""
    assert len(_read(routes["direct"])) > 39000
    assert _read(routes["direct"]) == _read(routes["hdf5"])
    assert _read(routes["direct"] + BED) == _read(routes["hdf5"] + BED)


def test_direct_matches_medaka_tpu_direct(routes):
    """Byte-identical to medaka_tpu's predict_direct: the consensus, the
    quality characters and the gaps bed."""
    assert _read(routes["direct"]) == _read(routes["jax"])
    assert _read(routes["direct"] + BED) == _read(routes["jax"] + BED)


def test_direct_multiwindow_matches_hdf5_route(synth, monkeypatch):
    """4.5 kb stitch windows over 6 kb work regions (3 workers): samples
    span work-region overlaps, region events arrive out of order, and a
    window flush needs samples of two neighbouring work regions."""
    d, bam, draft = synth
    kw = dict(bam_chunk=6000, bam_workers=3)
    monkeypatch.setattr(stitch, "MAX_REGION_SIZE", 4500)
    want = _hdf5_route(d, bam, draft, "mw_hdf5", **kw)
    got = str(d / "mw_direct.fastq")
    prediction.predict_direct(bam, got, draft, qualities=True, device="cpu",
                              **RUN, **kw)
    assert len(prediction.plan_work(None, bam, 6000, 100)) == 4
    assert _read(got) == _read(want)
    assert _read(got + BED) == _read(want + BED)


def test_region_events_follow_their_batches(synth):
    """Each ("rdone", rid) marker comes after every batch that holds a
    sample of that work region, and every region gets one."""
    _, bam, _ = synth
    from medaka_tpu_torch import models
    fenc = models.load_model(MODEL).feature_encoder
    work = prediction.plan_work(None, bam, 6000, 100)
    loader = prediction.DataLoader(bam, work, fenc, batch_size=8,
                                   chunk_len=1000, chunk_overlap=100,
                                   bam_workers=3, emit_region_events=True)
    done, seen = [], []
    for item in loader:
        if isinstance(item, tuple):
            done.append(item[1])
            continue
        for s in item.samples:
            rid = next(i for i, r in enumerate(work)
                       if r.ref_name == s.ref_name
                       and r.start <= s.positions["major"][0] < r.end)
            assert rid not in done or any(
                r.start <= s.positions["major"][0] < r.end
                for i, r in enumerate(work) if i != rid and i not in done)
            seen.append(rid)
    assert sorted(done) == list(range(len(work)))
    assert set(seen) <= set(done)


class _RunLengthScheme(labels.HaploidLabelScheme):
    def decode_consensus(self, sample, **kw):   # not a plain argmax
        return super().decode_consensus(sample, **kw)


def test_direct_refuses_non_argmax_schemes(synth):
    d, bam, draft = synth
    from medaka_tpu_torch import models
    bundle = models.load_model(MODEL)
    with pytest.raises(ValueError, match="plain haploid"):
        prediction.predict_direct(
            bam, str(d / "x.fasta"), draft, model=bundle.model,
            feature_encoder=bundle.feature_encoder,
            label_scheme=_RunLengthScheme(), device="cpu")
    with pytest.raises(ValueError, match="label scheme"):
        prediction.run_prediction_direct(
            str(d / "y.fasta"), bam, [], bundle.model,
            bundle.feature_encoder, None, draft, device="cpu")
