"""The port's read-level path against medaka_tpu's, on the CPU.

Features, the bi-LSTM kernel's plain version, the ``LatentSpaceLSTM``
forward and the whole ``inference`` + ``sequence`` pipeline, each held
against the matching ``medaka_tpu`` call on the same inputs and weights
(made from numpy seeds or the bundled ``rl_lstm128_*`` models).
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medaka_tpu import features as jax_features
from medaka_tpu import models as jax_models
from medaka_tpu import prediction as jax_prediction
from medaka_tpu import stitch as jax_stitch
from medaka_tpu.common import Region as JaxRegion
from medaka_tpu.ops import pallas_gru
from medaka_tpu.ops import rnn as jax_rnn
from medaka_tpu_torch import datastore, features, models, prediction, \
    stitch, testing
from medaka_tpu_torch.common import Region
from medaka_tpu_torch.io.bam import BamReader, BamRecord, write_bam
from medaka_tpu_torch.io.fastx import FastaReader
from medaka_tpu_torch.models.latent_space_lstm import LatentSpaceLSTM, \
    params_from_jax, params_to_jax
from medaka_tpu_torch.ops import bilstm, rnn
from tests import mock_data

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "medaka_tpu", "data")
LAMBDA = os.path.join(DATA, "rl_lstm128_lambda_demo.tar.gz")
DWELLS = os.path.join(DATA, "rl_lstm128_dwells_demo.tar.gz")
RUN = dict(chunk_len=1000, chunk_overlap=100, batch_size=8)


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    """A plain synthetic BAM, one with mv move tables, one whose first
    read carries its cigar in a CG tag (the long-cigar convention)."""
    d = tmp_path_factory.mktemp("rl")
    plain = testing.create_synth_bam(str(d / "plain.bam"), ref_mb=0.01,
                                     depth=10, read_len=2000)
    moves = testing.create_synth_bam(str(d / "moves.bam"), ref_mb=0.01,
                                     depth=10, read_len=2000,
                                     move_tables=True)
    with BamReader(plain[0]) as reader:
        refs = list(zip(reader.references, reader.lengths))
        records = list(reader.fetch("synth", 0, 10000))
    first = records[0]
    seq = "".join("=ACMGRSVTWYHKDBN"[c] for c in first.seq_nt16)
    records[0] = BamRecord.build(
        query_name=first.query_name, ref_id=0, pos=first.pos, seq=seq,
        qual=first.query_qualities,
        cigar="{}S{}N".format(len(seq), first.reference_length),
        flag=first.flag, mapq=first.mapq,
        tags={"CG": (first.cigar_array[:, 1] << 4
                     | first.cigar_array[:, 0]).astype(np.uint32)})
    assert records[0].has_long_cigar
    long_bam = str(d / "long.bam")
    write_bam(long_bam, records, refs)
    return {"plain": plain[0], "moves": moves[0], "long_cigar": long_bam}


@pytest.mark.parametrize("bam,dwells", [
    ("moves", True), ("plain", True), ("plain", False),
    ("long_cigar", True)])
def test_read_alignment_matrix_equals_jax(bams, bam, dwells):
    """Array-equal to medaka_tpu's: native path with and without mv
    tags, and the numpy path a CG long-cigar record takes."""
    got = features.read_alignment_matrix(
        Region("synth", 0, 10000), bams[bam], include_dwells=dwells)
    want = jax_features.read_alignment_matrix(
        JaxRegion("synth", 0, 10000), bams[bam], include_dwells=dwells)
    assert len(got) == len(want) >= 1
    for (m1, p1), (m2, p2) in zip(got, want):
        assert m1.dtype == np.int8 and m1.shape[-1] == 4 + int(dwells)
        np.testing.assert_array_equal(m1, m2)
        np.testing.assert_array_equal(p1, p2)
    if bam == "moves":
        assert (got[0][0][..., 4] > 0).any()


def test_encoder_samples_equal_jax(bams):
    """Sample generation with the bundle's encoder: same chunks, depth."""
    port = models.load_model(LAMBDA).feature_encoder
    ref = jax_models.load_model(LAMBDA).feature_encoder
    assert port.to_dict() == ref.to_dict()
    got = features.SampleGenerator(
        bams["plain"], Region("synth", 0, 10000), port, chunk_len=1000,
        chunk_overlap=100).samples
    want = jax_features.SampleGenerator(
        bams["plain"], JaxRegion("synth", 0, 10000), ref, chunk_len=1000,
        chunk_overlap=100).samples
    assert len(got) == len(want) > 5
    for a, b in zip(got, want):
        assert a.name == b.name
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.depth, b.depth)


def test_dwell_reads_match_mock_data():
    """The port's simulator repeats tests/mock_data's draws; its cigar
    aligns the read exactly and the mv table has one move per base."""
    arr = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(1).integers(0, 4, 5000)]
    want = mock_data.simulate_dwell_read(arr, 100, 1500,
                                         np.random.default_rng(3))
    seq, mv, cigar = testing.simulate_dwell_read(
        arr, 100, 1500, np.random.default_rng(3))
    assert seq == want[0]
    np.testing.assert_array_equal(mv, want[1])
    rec = BamRecord.build("r", 0, 100, seq=seq, cigar=cigar)
    assert rec.reference_length == 1500
    assert int(np.sum(mv[1:] == 1)) == len(seq)
    assert features.calculate_dwells(
        BamRecord.build("r", 0, 100, seq=seq, cigar=cigar,
                        tags={"mv": mv})) is not None


def _lstm_layer(rng, in_size, hidden):
    k = 1.0 / np.sqrt(hidden)
    return {name: rng.uniform(-k, k, shape).astype(np.float32)
            for name, shape in (("w_ih", (4 * hidden, in_size)),
                                ("w_hh", (4 * hidden, hidden)),
                                ("b_ih", (4 * hidden,)),
                                ("b_hh", (4 * hidden,)))}


def _stack(rng, hidden=16, in_size=16):
    return [{"fwd": _lstm_layer(rng, i, hidden),
             "bwd": _lstm_layer(rng, i, hidden)}
            for i in (in_size, 2 * hidden)]


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype,atol", [(None, 1e-5), ("bf16", 3e-2)])
def test_lstm_scan_matches_jax(reverse, dtype, atol):
    """f32 within 1e-5; bf16 within the 3e-2 bar of test_pallas_gru.py."""
    rng = np.random.default_rng(8)
    params = _lstm_layer(rng, 10, 32)
    x = rng.random((4, 40, 10)).astype(np.float32)
    lengths = np.array([40, 25, 3, 39], np.int32)
    ref = jax_rnn.lstm_scan(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), reverse=reverse,
        compute_dtype=jnp.bfloat16 if dtype else None,
        lengths=jnp.asarray(lengths))
    got = rnn.lstm_scan(
        _torch_tree(params), torch.from_numpy(x), reverse=reverse,
        compute_dtype=torch.bfloat16 if dtype else None,
        lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref, np.float32), atol=atol)


def test_bilstm_stack_matches_jax():
    rng = np.random.default_rng(9)
    layers = _stack(rng)
    x = rng.random((4, 48, 16)).astype(np.float32)
    lengths = np.array([48, 30, 7, 1], np.int32)
    ref = jax_rnn.bilstm_stack(jax.tree.map(jnp.asarray, layers),
                               jnp.asarray(x), lengths=jnp.asarray(lengths))
    got = rnn.bilstm_stack(_torch_tree(layers), torch.from_numpy(x),
                           lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("level", ["kernel", "stack"])
def test_bilstm_plain_matches_jax_interpret(level):
    """The kernel's plain version against ``bilstm_pallas`` and the stack
    against ``bilstm_stack_fused``, both with ``interpret=True``, at the
    shapes of test_pallas_gru.py's TestFusedLSTM (H=16, T=48, B=4) with
    lengths [48, 30, 7, 1]: within one bf16 step, 4e-3 (measured 9.8e-4
    for the stack)."""
    rng = np.random.default_rng(5)
    layers = _stack(rng)
    x = rng.random((4, 48, 16)).astype(np.float32)
    lengths = np.array([48, 30, 7, 1], np.int32)
    with torch.inference_mode():
        if level == "stack":
            want = pallas_gru.bilstm_stack_fused(
                layers, jnp.asarray(x), lengths=jnp.asarray(lengths),
                interpret=True)
            got = bilstm.bilstm_stack_fused(
                _torch_tree(layers), torch.from_numpy(x),
                lengths=torch.from_numpy(lengths))
        else:
            xp = [rng.uniform(-2, 2, (48, 4, 64)).astype(np.float32)
                  for _ in range(2)]
            w_hh = np.stack([layers[0]["fwd"]["w_hh"],
                             layers[0]["bwd"]["w_hh"]])
            b_hh = np.stack([layers[0]["fwd"]["b_hh"],
                             layers[0]["bwd"]["b_hh"]])
            want = jnp.stack(pallas_gru.bilstm_pallas(
                *(jnp.asarray(v, jnp.bfloat16) for v in xp),
                jnp.asarray(w_hh), jnp.asarray(b_hh),
                lengths=jnp.asarray(lengths), interpret=True))
            got = torch.stack(bilstm.bilstm_fused(
                *(torch.from_numpy(v).to(torch.bfloat16) for v in xp),
                torch.from_numpy(w_hh), torch.from_numpy(b_hh),
                torch.from_numpy(lengths)))
        assert got.dtype == torch.bfloat16
        diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert diff.max() <= 4e-3


@pytest.fixture(scope="module")
def lambda_bundles():
    return models.load_model(LAMBDA), jax_models.load_model(LAMBDA)


@pytest.fixture(scope="module")
def chunks(bams, lambda_bundles):
    """Three real 200-column chunks of the plain BAM and one empty row."""
    samples = features.SampleGenerator(
        bams["plain"], Region("synth", 0, 10000),
        lambda_bundles[0].feature_encoder, chunk_len=200,
        chunk_overlap=20).samples[:3]
    batch = prediction.Batch.collate(samples, 4, 200, 100)
    assert batch.features.shape == (4, 200, 25, 4)
    return batch.features, batch.lengths


@pytest.mark.parametrize("mode", ["f32", "bf16_fused"])
def test_model_matches_jax_apply(lambda_bundles, chunks, mode, monkeypatch):
    """f32 (the scan): probabilities within 1e-4 of ``apply`` (measured
    6.6e-7). bf16 with ``fused=True`` (the kernel's plain version)
    against ``apply(fused=True)`` with the Pallas stack in interpret
    mode: within 2e-2, argmax agreement >= 0.999 (measured 1.6e-4, 1.0)."""
    bundle, ref = lambda_bundles
    x, lengths = chunks
    kwargs = {}
    if mode == "bf16_fused":
        monkeypatch.setattr(pallas_gru, "bilstm_stack_fused", functools.partial(
            pallas_gru.bilstm_stack_fused, interpret=True))
        kwargs = {"fused": True}
    want = np.asarray(ref.model.apply(
        ref.params, jnp.asarray(x).astype(jnp.float32),
        lengths=jnp.asarray(lengths),
        compute_dtype=jnp.bfloat16 if kwargs else None, **kwargs))
    with torch.inference_mode():
        got = bundle.model(
            torch.from_numpy(x), lengths=torch.from_numpy(lengths),
            compute_dtype=torch.bfloat16 if kwargs else None,
            **kwargs).numpy()
    valid = np.arange(200)[None, :] < lengths[:, None]
    diff = np.abs(got - want)[valid]
    if mode == "f32":
        assert diff.max() <= 1e-4
    else:
        assert diff.max() <= 2e-2
        assert (got.argmax(-1) == want.argmax(-1))[valid].mean() >= 0.999


def test_dwells_bundle_forward_matches_jax(bams):
    """The dwells bundle loads as it is and its f32 forward on mv-tagged
    features matches ``apply`` within 1e-4."""
    bundle, ref = models.load_model(DWELLS), jax_models.load_model(DWELLS)
    assert bundle.model.use_dwells and bundle.feature_encoder.include_dwells
    assert bundle.model.to_dict() == ref.model.to_dict()
    samples = features.SampleGenerator(
        bams["moves"], Region("synth", 0, 10000), bundle.feature_encoder,
        chunk_len=200, chunk_overlap=20).samples[:2]
    batch = prediction.Batch.collate(samples, 2, 200, 100)
    assert batch.features.shape[-1] == 5
    want = np.asarray(ref.model.apply(
        ref.params, jnp.asarray(batch.features).astype(jnp.float32),
        lengths=jnp.asarray(batch.lengths)))
    with torch.inference_mode():
        got = bundle.model(torch.from_numpy(batch.features),
                           lengths=torch.from_numpy(batch.lengths)).numpy()
    assert np.abs(got - want).max() <= 1e-4


def test_unidirectional_stack_matches_jax():
    """The 4-layer reverse/forward interleave (no kernel) in f32."""
    model = LatentSpaceLSTM(lstm_size=16, cnn_size=8, kernel_sizes=(1, 3),
                            bidirectional=False)
    ref_model = jax_models.model_from_dict(model.to_dict())
    params = ref_model.init_params(jax.random.PRNGKey(2))
    model.load_jax_params(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(4)
    x = np.zeros((2, 30, 6, 4), np.int8)
    x[..., 0] = rng.integers(0, 6, (2, 30, 6))
    x[..., 1] = rng.integers(-1, 40, (2, 30, 6))
    x[..., 2] = rng.choice([-1, 1], (2, 30, 6))
    x[:, :, 4:] = 0                                   # two empty read rows
    lengths = np.array([30, 17], np.int32)
    want = np.asarray(ref_model.apply(params, jnp.asarray(x),
                                      lengths=jnp.asarray(lengths)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x),
                    lengths=torch.from_numpy(lengths)).numpy()
    assert np.abs(got - want).max() <= 1e-4


def test_params_round_trip(lambda_bundles):
    _, ref = lambda_bundles
    back = params_to_jax(params_from_jax(ref.params))
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, ref.params))
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(ref.params)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_collate_read_buckets():
    """Reads pad to the smallest of {25, 50, 100} covering the batch's
    deepest sample, as medaka_tpu's Batch.collate."""
    def sample(reads, cols=5):
        from medaka_tpu_torch.common import Sample, make_positions
        return Sample("c", np.ones((cols, reads, 4), np.int8), None, None,
                      make_positions(np.arange(cols), np.zeros(cols)), None)
    for depth, bucket in ((3, 25), (25, 25), (26, 50), (80, 100),
                          (100, 100)):
        samples = [sample(depth), sample(2, cols=3)]
        got = prediction.Batch.collate(samples, 3, 6, max_reads=100)
        want = jax_prediction.Batch.collate(samples, 3, 6, max_reads=100)
        assert got.features.shape == (3, 6, bucket, 4)
        np.testing.assert_array_equal(got.features, want.features)
        np.testing.assert_array_equal(got.lengths, want.lengths)


def test_auto_batch_size_read_level():
    """chunk_len x max_reads x cnn_size x 2 bytes x 3 live activations
    per row (76.8 MB at 1000 x 100 x 128); half the free memory is
    budgeted, capped at 128; the CPU uses 128."""
    model = LatentSpaceLSTM()
    gib = 1 << 30
    assert prediction.auto_batch_size(model, "cpu", chunk_len=1000) == 128
    assert prediction.auto_batch_size(
        model, "cuda", chunk_len=1000, free_bytes=80 * gib) == 128
    assert prediction.auto_batch_size(
        model, "cuda", chunk_len=1000, free_bytes=8 * gib) == 55
    assert prediction.auto_batch_size(
        model, "cuda", chunk_len=1000, free_bytes=8 * gib,
        full_precision=True) == 27
    assert prediction.auto_batch_size(
        model, "cuda", chunk_len=10000, free_bytes=1 * gib) == 1


def test_dispatch_keeps_int8_features(lambda_bundles, chunks):
    """Under compact transfer, int8 read-level features reach the model
    as int8 (the model widens them); float features go as bf16."""
    seen = []

    class Spy(torch.nn.Module):
        def forward(self, x, **kwargs):
            seen.append(x.dtype)
            return torch.zeros(x.shape[:2] + (5,))

    x, lengths = chunks
    pred = prediction.Predictor(Spy(), device="cpu", compact_transfer=True)
    pred.dispatch(prediction.Batch(x, lengths, []))
    pred.dispatch(prediction.Batch(x[..., 0].astype(np.float32), lengths,
                                   []))
    assert seen == [torch.int8, torch.float32]


@pytest.fixture(scope="module")
def runs(bams, tmp_path_factory):
    """Both packages' probability files of a 20 kb BAM at depth 15, in
    f32 and bf16; medaka_tpu on one device, as the port runs."""
    d = tmp_path_factory.mktemp("rl_runs")
    bam, draft = testing.create_synth_bam(str(d / "reads.bam"), ref_mb=0.02,
                                          depth=15, read_len=2000)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    out = {"bam": bam, "draft": draft}
    for full in (True, False):
        tag = "f32" if full else "bf16"
        jax_hdf = str(d / "jax_{}.hdf".format(tag))
        port_hdf = str(d / "port_{}.hdf".format(tag))
        jax_prediction.predict(bam, jax_hdf, model_path=LAMBDA,
                               full_precision=full, mesh=mesh, **RUN)
        prediction.predict(bam, port_hdf, model_path=LAMBDA,
                           full_precision=full, device="cpu", **RUN)
        out[tag] = (jax_hdf, port_hdf)
    return out


def _probs(path):
    index = datastore.DataIndex(path)
    with datastore.DataStore(path) as ds:
        return {name: ds.load_sample(name).label_probs
                for name, _ in index.samples}


@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_pipeline_matches_jax(runs, tag, tmp_path):
    """Probabilities within 1e-4 (f32) and 2e-2 (bf16); each package
    stitches the other's file to the same bytes; the consensus FASTAs
    are byte-identical in f32, and in bf16 on this BAM (measured: the
    same 20,005 bp in both precisions, 34 edits from the draft by greedy
    walk, identity 0.9983)."""
    jax_hdf, port_hdf = runs[tag]
    want, got = _probs(jax_hdf), _probs(port_hdf)
    assert sorted(want) == sorted(got) and len(got) > 10
    worst = max(np.abs(got[k] - want[k]).max() for k in want)
    assert worst <= (1e-4 if tag == "f32" else 2e-2)
    fastas = {}
    for name, fn, hdf in (
            ("jax", jax_stitch.stitch_to_fasta, jax_hdf),
            ("port", stitch.stitch_to_fasta, port_hdf),
            ("jax_stitches_port", jax_stitch.stitch_to_fasta, port_hdf),
            ("port_stitches_jax", stitch.stitch_to_fasta, jax_hdf)):
        path = str(tmp_path / (name + ".fasta"))
        fn(hdf, runs["draft"], path)
        with open(path, "rb") as fh:
            fastas[name] = fh.read()
    assert fastas["jax_stitches_port"] == fastas["port"]
    assert fastas["port_stitches_jax"] == fastas["jax"]
    assert fastas["port"] == fastas["jax"]
    with FastaReader(runs["draft"]) as fr:
        draft = fr.fetch("synth")
    with FastaReader(str(tmp_path / "port.fasta")) as fr:
        consensus = fr.fetch("synth")
    edits = testing.greedy_edit_count(consensus.encode(), draft.encode())
    assert 1.0 - edits / len(draft) >= 0.99


def test_cli_read_level_inference_and_sequence(runs, tmp_path):
    """The command line of the read-level path: ``--cpu`` runs on the
    CPU and gives the bf16 pipeline's bytes; without ``--cpu`` and
    without a GPU it raises."""
    from medaka_tpu_torch import cli
    hdf, fasta = str(tmp_path / "cli.hdf"), str(tmp_path / "cli.fasta")
    args = ["inference", runs["bam"], hdf, "--model", LAMBDA,
            "--chunk_len", "1000", "--chunk_ovlp", "100", "--batch_size",
            "8", "--quiet"]
    assert cli.main(args + ["--cpu"]) == 0
    assert cli.main(["sequence", hdf, runs["draft"], fasta, "--quiet"]) == 0
    want = str(tmp_path / "want.fasta")
    stitch.stitch_to_fasta(runs["bf16"][1], runs["draft"], want)
    with open(fasta, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            cli.main(args[:2] + [str(tmp_path / "gpu.hdf")] + args[3:])
