"""The port's training path against medaka_tpu's, on the CPU.

BAM accessors, truth alignments, labelled features, the trainable GRU
kernels' plain versions (against ``gru_pallas``/``gru_bwd_pallas`` with
``interpret=True``), the stack and the model under autograd, the optax
chains, the training loop and the CLI, each held against the matching
``medaka_tpu`` call on the same inputs and weights (made from numpy
seeds), with each tolerance stated.
"""
import argparse
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medaka_tpu import features as jax_features
from medaka_tpu import labels as jax_labels
from medaka_tpu import models as jax_models
from medaka_tpu import parallel as jax_parallel
from medaka_tpu import training as jax_training
from medaka_tpu.common import Region as JaxRegion
from medaka_tpu.io import bam as jax_bam
from medaka_tpu.models.gru import GRUModel as JaxGRUModel
from medaka_tpu.ops import pallas_gru
from medaka_tpu_torch import cli, features, labels, models, parallel, \
    testing, training
from medaka_tpu_torch.common import Region
from medaka_tpu_torch.io import bam as port_bam
from medaka_tpu_torch.io.fastx import FastaReader
from medaka_tpu_torch.models.gru import GRUModel, params_from_jax
from medaka_tpu_torch.ops import gru_train
from tests import mock_data
from tests.torch_threads import one_thread  # noqa: F401

BF16_STEP = 2.0 ** -8    # one bf16 step for |h| < 1


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# BAM accessors
# ---------------------------------------------------------------------------

_RECORDS = [e for e in mock_data.CALLS] + [mock_data.TRUTH] + [
    # soft clips, a deletion and an insertion, MD naming a mismatch and
    # the deleted bases
    ("clipped", "TTACAGTAGATGAA", [30] * 14, "2S3M1D2M1I4M2S", 60, 256,
     dict(MD="3^T1C4")),
    # no MD tag: get_reference_sequence raises in both packages
    ("no_md", "ACATG", [30] * 5, "5M", 60, 0, dict(HP=2)),
]


@pytest.mark.parametrize("entry", _RECORDS, ids=[e[0] for e in _RECORDS])
def test_bam_accessors_match_medaka_tpu(entry):
    """query_sequence, get_tag, is_secondary, get_aligned_pairs and
    get_reference_sequence (via MD) equal medaka_tpu's on the same
    record bytes."""
    name, seq, quals, cigar, mapq, flag, tags = entry
    kwargs = dict(query_name=name, ref_id=0, pos=3, seq=seq, qual=quals,
                  cigar=cigar, flag=flag, mapq=mapq, tags=tags)
    ours = port_bam.BamRecord.build(**kwargs)
    theirs = jax_bam.BamRecord.build(**kwargs)
    assert ours.raw == theirs.raw
    assert ours.query_sequence == theirs.query_sequence
    assert ours.is_secondary == theirs.is_secondary
    assert ours.reference_start == theirs.reference_start
    for tag in ("MD", "HP", "DT", "XX"):
        assert ours.get_tag(tag, "none") == theirs.get_tag(tag, "none")
    assert ours.get_aligned_pairs() == theirs.get_aligned_pairs()
    if "MD" in tags:
        assert ours.get_reference_sequence() == \
            theirs.get_reference_sequence()
    else:
        with pytest.raises(ValueError, match="MD tag not present"):
            theirs.get_reference_sequence()
        with pytest.raises(ValueError, match="MD tag not present"):
            ours.get_reference_sequence()


# ---------------------------------------------------------------------------
# truth alignments and labelled features
# ---------------------------------------------------------------------------


_SEGMENTS = {
    # comparable overlap (split), a short one engulfed by a long one,
    # a secondary record and one holding an N
    "haploid": [("a", 0, 3000, 0, {}), ("b", 2600, 3000, 0, {}),
                ("c", 4000, 500, 0, {}), ("d", 100, 2000, 256, {}),
                ("e", 5700, 300, 0, {"N": 1})],
    # two haplotypes grouped to their common windows
    "diploid": [("h1a", 0, 2500, 0, {"HP": 1}), ("h2a", 300, 2600, 0,
                                                 {"HP": 2}),
                ("h1b", 3000, 2500, 0, {"HP": 1}),
                ("h2b", 3200, 2000, 0, {"HP": 2})],
}


@pytest.mark.parametrize("min_length", [300, 1000])
@pytest.mark.parametrize("case", sorted(_SEGMENTS))
def test_truth_alignments_match_medaka_tpu(tmp_path, case, min_length):
    """TruthAlignment.bam_to_alignments: the same groups, windows and
    records as medaka_tpu's for overlapping, engulfed, short, secondary
    and unclean segments, with and without a haplotype tag."""
    rng = np.random.default_rng(5)
    genome = "".join(rng.choice(list("ACGT"), 6000))
    segs = []
    for name, start, length, flag, tags in _SEGMENTS[case]:
        tags = dict(tags)
        if tags.pop("N", None):
            genome_n = genome[:start + 10] + "N" + genome[start + 11:]
            seq = genome_n
        else:
            seq = genome
        segs.append((name, start, length, flag, tags, seq))
    records = []
    for name, start, length, flag, tags, seq in segs:
        s = seq[start:start + length]
        records.append(port_bam.BamRecord.build(
            query_name=name, ref_id=0, pos=start, seq=s, qual=[60] * length,
            cigar="{}M".format(length), flag=flag, mapq=60,
            tags=dict(tags, MD=str(length))))
    path = str(tmp_path / "truth.bam")
    port_bam.write_bam(path, records, [("synth", len(genome))])
    haplotag = "HP" if case == "diploid" else None

    def summary(groups):
        return [tuple((a.aln.query_name, a.start, a.end) for a in g)
                for g in groups]

    ours = labels.TruthAlignment.bam_to_alignments(
        path, Region("synth", 0, 6000), haplotag=haplotag,
        min_length=min_length)
    theirs = jax_labels.TruthAlignment.bam_to_alignments(
        path, JaxRegion("synth", 0, 6000), haplotag=haplotag,
        min_length=min_length)
    print(summary(ours))
    assert summary(ours) == summary(theirs)
    assert ours


def _assert_samples_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a.name == b.name
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
        assert a.labels.dtype == b.labels.dtype
        np.testing.assert_array_equal(a.positions["major"],
                                      b.positions["major"])
        np.testing.assert_array_equal(a.positions["minor"],
                                      b.positions["minor"])


def test_mock_training_samples_match_medaka_tpu(tmp_path):
    """The 8 bp mock draft, its four reads and its truth (an extra
    insertion): labelled samples array-equal to medaka_tpu's."""
    bam = mock_data.create_simple_bam(str(tmp_path / "calls.bam"))
    truth = mock_data.create_truth_bam(str(tmp_path / "truth.bam"))
    n = len(mock_data.REF_SEQ)
    ours = features.CountsFeatureEncoder().bams_to_training_samples(
        truth, bam, Region(mock_data.REF_NAME, 0, n),
        labels.HaploidLabelScheme(), min_length=1)
    theirs = jax_features.CountsFeatureEncoder().bams_to_training_samples(
        truth, bam, JaxRegion(mock_data.REF_NAME, 0, n),
        jax_labels.HaploidLabelScheme(), min_length=1)
    _assert_samples_equal(ours, theirs)


@pytest.fixture(scope="module")
def labelled(tmp_path_factory):
    """A 20 kb synthetic BAM at depth 10, its truth BAM with 5 planted
    draft substitutions, and labelled feature files from both packages
    (chunk_len 100)."""
    d = tmp_path_factory.mktemp("train")
    bam, ref = testing.create_synth_bam(str(d / "reads.bam"), ref_mb=0.02,
                                        depth=10, read_len=2000, seed=3)
    with FastaReader(ref) as fr:
        genome = fr.fetch("synth")
    subs = {p: "ACGT"[("ACGT".index(genome[p]) + 1) % 4]
            for p in (500, 4321, 9000, 15000, 19000)}
    truth = testing.create_truth_bam(str(d / "truth.bam"), ref,
                                     substitutions={"synth": subs},
                                     draft_fasta=str(d / "draft.fasta"))
    ours = str(d / "ours.hdf")
    theirs = str(d / "theirs.hdf")
    run = dict(truth_bam=truth, chunk_len=100, chunk_ovlp=0)
    n_ours = features.create_samples(bam, ours, **run)
    n_theirs = jax_features.create_samples(bam, theirs, **run)
    return dict(dir=d, bam=bam, truth=truth, ours=ours, theirs=theirs,
                n=(n_ours, n_theirs), subs=subs, genome=genome)


def test_truth_bam_names_planted_substitutions(labelled):
    """The truth record holds the genome; its MD tag names the draft's
    planted bases, so the reconstructed reference is the planted draft."""
    with port_bam.BamReader(labelled["truth"]) as reader:
        (rec,) = list(reader.fetch("synth"))
    assert rec.query_sequence == labelled["genome"]
    draft = rec.get_reference_sequence()
    with FastaReader(str(labelled["dir"] / "draft.fasta")) as fr:
        assert draft == fr.fetch("synth")
    diff = [i for i, (a, b) in enumerate(zip(draft, labelled["genome"]))
            if a != b]
    assert diff == sorted(labelled["subs"])


def test_create_samples_matches_medaka_tpu(labelled):
    """create_samples with a truth BAM: the same samples (features,
    labels, positions) as medaka_tpu.features.create_samples."""
    from medaka_tpu import datastore as jax_datastore
    from medaka_tpu_torch import datastore
    assert labelled["n"][0] == labelled["n"][1] > 100
    ours_index = datastore.DataIndex(labelled["ours"])
    theirs_index = jax_datastore.DataIndex(labelled["theirs"])
    assert [s for s, _ in ours_index.samples] == \
        [s for s, _ in theirs_index.samples]
    names = ours_index.samples
    ours = list(ours_index.yield_from_feature_files(samples=names))
    theirs = list(theirs_index.yield_from_feature_files(
        samples=[(s, labelled["theirs"]) for s, _ in names]))
    _assert_samples_equal(ours, theirs)


@pytest.mark.parametrize("which", ["ours", "theirs"])
def test_feature_files_load_in_both_batchers(labelled, which):
    """Each package's feature file serves the same batches in both
    packages' TrainBatcher."""
    path = labelled[which]
    ours = training.TrainBatcher([path], validation=0.2, seed=1,
                                 batch_size=8)
    theirs = jax_training.TrainBatcher([path], validation=0.2, seed=1,
                                       batch_size=8)
    assert ours.train_samples == theirs.train_samples
    assert (ours.time_steps, ours.feat_dim) == (100, 10)
    a = next(ours.batches("train", seed=2))
    b = next(theirs.batches("train", seed=2))
    for key in ("features", "labels", "mask", "lengths"):
        np.testing.assert_array_equal(a[key], b[key])
    assert isinstance(ours.meta["label_scheme"], labels.HaploidLabelScheme)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret=True)
# ---------------------------------------------------------------------------


def _direction_inputs(seed, T=24, B=3, H=16):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    xp = np.asarray(jnp.asarray(rng.uniform(-2, 2, (T, B, 3 * H)).astype(
        np.float32)).astype(jnp.bfloat16).astype(jnp.float32))
    w = rng.uniform(-k, k, (3 * H, H)).astype(np.float32)
    b = rng.uniform(-k, k, (3 * H,)).astype(np.float32)
    lengths = np.array([T, T // 3, T - 5][:B], np.int32)
    dh = np.asarray(jnp.asarray(rng.standard_normal((T, B, H)).astype(
        np.float32)).astype(jnp.bfloat16).astype(jnp.float32))
    return xp, w, b, lengths, dh


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_fwd_plain_matches_gru_pallas(reverse):
    """gru_fwd_plain vs gru_pallas(interpret=True), ragged lengths: within
    one bf16 step (the sigmoid and tanh implementations differ)."""
    xp, w, b, lengths, _ = _direction_inputs(1 + reverse)
    want = _np(pallas_gru.gru_pallas(
        jnp.asarray(xp, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(lengths), reverse=reverse, interpret=True))
    got = gru_train.gru_fwd(
        torch.from_numpy(xp).to(torch.bfloat16), torch.from_numpy(w),
        torch.from_numpy(b), torch.from_numpy(lengths), reverse)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    print("gru_fwd plain vs pallas max", diff.max())
    assert diff.max() <= BF16_STEP
    # padded steps: forward tails repeat the last valid h, reverse tails
    # hold the zero state
    t_pad = np.arange(xp.shape[0])[:, None] >= lengths[None, :]
    g = got.float().numpy()
    if reverse:
        assert np.all(g[t_pad] == 0)
    else:
        assert np.array_equal(g[-1, 1], g[lengths[1] - 1, 1])


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_bwd_plain_matches_gru_bwd_pallas(reverse):
    """gru_bwd_plain vs gru_bwd_pallas(interpret=True) on the same bf16
    forward outputs and upstream gradient: dxp, dW_hh and db_hh within
    1e-3 of each tensor's largest magnitude."""
    xp, w, b, lengths, dh = _direction_inputs(3 + reverse)
    xj = jnp.asarray(xp, jnp.bfloat16)
    h_out = pallas_gru.gru_pallas(
        xj, jnp.asarray(w), jnp.asarray(b), jnp.asarray(lengths),
        reverse=reverse, interpret=True)
    want = pallas_gru.gru_bwd_pallas(
        xj, h_out, jnp.asarray(dh), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(lengths), reverse=reverse, interpret=True)
    got = gru_train.gru_bwd(
        torch.from_numpy(xp).to(torch.bfloat16),
        torch.from_numpy(_np(h_out)).to(torch.bfloat16),
        torch.from_numpy(dh), torch.from_numpy(w), torch.from_numpy(b),
        torch.from_numpy(lengths), reverse)
    for name, g, wt in zip(("dxp", "dW_hh", "db_hh"), got, want):
        wt = _np(wt).reshape(g.shape)
        rel = np.abs(g.numpy() - wt).max() / np.abs(wt).max()
        print(name, "relative max", rel)
        assert g.dtype == torch.float32
        assert rel <= 1e-3


# ---------------------------------------------------------------------------
# the stack and the model under autograd
# ---------------------------------------------------------------------------


def _jax_model(H=8, bidirectional=True, seed=1):
    model = JaxGRUModel(gru_size=H, bidirectional=bidirectional)
    return model, jax.tree_util.tree_map(
        np.asarray, model.init_params(jax.random.PRNGKey(seed)))


def _port_model(jparams, H=8, bidirectional=True):
    model = GRUModel(gru_size=H, bidirectional=bidirectional)
    model.load_state_dict(params_from_jax(jparams))
    return model


def _batch(seed=1, B=3, T=16):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, 9, T - 3][:B], np.int32)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return {"features": rng.random((B, T, 10)).astype(np.float32),
            "labels": rng.integers(0, 5, (B, T)).astype(np.int32),
            "mask": mask, "lengths": lengths}


def _assert_grads_close(ours, theirs, bar):
    """Each gradient leaf within ``bar`` of its largest magnitude."""
    worst = 0.0
    for key, g in ours.items():
        t = theirs[key]
        rel = np.abs(g - t).max() / max(np.abs(t).max(), 1e-12)
        worst = max(worst, rel)
        assert rel <= bar, (key, rel)
    print("worst relative gradient difference", worst)


def _port_grads(model):
    """{state key: gradient} of the port's model."""
    return {k: p.grad.numpy() for k, p in model.named_parameters()
            if p.grad is not None}


def _jax_grads(grads):
    """The same keys for a JAX gradient pytree."""
    return {k: np.asarray(v) for k, v in params_from_jax(grads).items()}


@pytest.mark.parametrize("bidirectional", [True, False])
def test_stack_autograd_matches_jax_grad(bidirectional):
    """bigru_stack_trainable (plain route) and its gradients vs jax.grad of
    pallas_gru.bigru_stack_trainable(interpret=True): outputs within one
    bf16 step, every gradient leaf within 1e-2 of its largest magnitude
    (medaka_tpu's own bar between its kernel pair and scan autodiff is
    5%)."""
    _, jparams = _jax_model(bidirectional=bidirectional)
    batch = _batch()
    x, lengths = batch["features"], batch["lengths"]
    proj = np.random.default_rng(9).standard_normal(
        (3, 16, 16 if bidirectional else 8)).astype(np.float32)

    def jax_loss(layers):
        out = pallas_gru.bigru_stack_trainable(
            layers, jnp.asarray(x), lengths=jnp.asarray(lengths),
            bidirectional=bidirectional, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * proj), out

    (_, j_out), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(
        jparams["gru"])
    model = _port_model(jparams, bidirectional=bidirectional)
    out = gru_train.bigru_stack_trainable(
        model.layer_params(), torch.from_numpy(x),
        lengths=torch.from_numpy(lengths), bidirectional=bidirectional)
    assert out.dtype == torch.bfloat16
    diff = np.abs(out.float().detach().numpy() - _np(j_out))
    print("stack outputs max", diff.max())
    assert diff.max() <= BF16_STEP
    (out.float() * torch.from_numpy(proj)).sum().backward()
    ours = _port_grads(model)
    assert len(ours) == 8 * (2 if bidirectional else 1)
    _assert_grads_close(ours, _jax_grads(
        {"gru": j_grads, "linear": jparams["linear"]}), 1e-2)


def _jax_fused_loss(jmodel, batch):
    """The JAX bf16 training loss through the trainable kernel pair in
    interpret mode: the stack, the f32 head and the masked cross-entropy
    of parallel.cross_entropy_loss."""
    def loss(params):
        feats = pallas_gru.bigru_stack_trainable(
            params["gru"], jnp.asarray(batch["features"]),
            lengths=jnp.asarray(batch["lengths"]),
            bidirectional=jmodel.bidirectional, interpret=True)
        logits = (jnp.einsum("bth,ch->btc", feats.astype(jnp.float32),
                             params["linear"]["w"].astype(jnp.float32))
                  + params["linear"]["b"].astype(jnp.float32))
        logp = jax.nn.log_softmax(logits, axis=-1)
        ll = jnp.take_along_axis(
            logp, jnp.asarray(batch["labels"])[..., None], axis=-1)[..., 0]
        mask = jnp.asarray(batch["mask"])
        return -(ll * mask).sum() / jnp.maximum(mask.sum(), 1.0)
    return loss


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_model_training_forward_matches_jax():
    """GRUModel.forward(training=True, fused=True), bf16, loss and
    gradients vs jax.value_and_grad of the composed JAX loss: loss within
    1e-3 relative (bf16 features within one step), every gradient leaf
    within 1e-2 of its largest magnitude."""
    jmodel, jparams = _jax_model()
    batch = _batch(seed=2)
    j_loss, j_grads = jax.value_and_grad(_jax_fused_loss(jmodel, batch))(
        jparams)
    model = _port_model(jparams)
    loss, (n_c, n_t) = parallel.cross_entropy_loss(
        lambda *a, **kw: model(*a, fused=True, **kw), _torch_batch(batch),
        compute_dtype=torch.bfloat16, training=True)
    loss.backward()
    print("loss", loss.item(), "jax", float(j_loss))
    assert abs(loss.item() - float(j_loss)) <= 1e-3 * abs(float(j_loss))
    assert float(n_t) == batch["mask"].sum()
    _assert_grads_close(_port_grads(model), _jax_grads(j_grads), 1e-2)


@pytest.mark.parametrize("class_weights", [None, [0.5, 1.0, 2.0, 1.0, 3.0]])
def test_f32_loss_and_grads_match_jax(class_weights):
    """The f32 route (compute_dtype=None: the scan under autograd) vs
    jax.grad of parallel.cross_entropy_loss(compute_dtype=None): loss and
    every gradient leaf within 1e-5 (relative), with and without
    class_weights."""
    jmodel, jparams = _jax_model()
    batch = _batch(seed=4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        return jax_parallel.cross_entropy_loss(
            jmodel, p, jbatch, compute_dtype=None,
            class_weights=class_weights)[0]

    j_loss, j_grads = jax.value_and_grad(jloss)(jparams)
    model = _port_model(jparams)
    loss, _ = parallel.cross_entropy_loss(
        model, _torch_batch(batch), compute_dtype=None, training=True,
        class_weights=class_weights)
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    _assert_grads_close(_port_grads(model), _jax_grads(j_grads), 1e-5)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def _grad_stream(seed, steps=10):
    """Gradients of two leaves; step 7 spikes 20x to exercise the clip."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(steps):
        scale = 20.0 if i == 7 else 1.0
        out.append({"a": scale * rng.standard_normal((6, 4)).astype(
                        np.float32),
                    "b": scale * rng.standard_normal((5,)).astype(
                        np.float32)})
    return out


@pytest.mark.parametrize("name,args,schedule", [
    ("adam", {"learning_rate": 1e-3}, False),
    ("nadam", {"learning_rate": 1e-3}, False),
    ("nadam", {}, True),
    ("rmsprop", {}, False),
    ("rmsprop", {"momentum": 0.9, "nesterov": True}, False),
    ("sgd", {}, False),
    ("sgd", {"momentum": 0.5}, True),
])
def test_optimizer_matches_optax(name, args, schedule):
    """build_optimizer (clip on) vs medaka_tpu.training.build_optimizer fed
    the same gradients for 10 steps: updates within 1e-6."""
    grads = _grad_stream(len(name) + len(args))
    params = {k: jnp.zeros_like(v) for k, v in grads[0].items()}
    sched_j = jax_training.cosine_schedule(1e-3, 10, warmup_steps=3) \
        if schedule else None
    sched_t = training.cosine_schedule(1e-3, 10, warmup_steps=3) \
        if schedule else None
    opt_j = jax_training.build_optimizer(name, sched_j, dict(args))
    state = opt_j.init(params)
    opt_t = training.build_optimizer(name, sched_t, dict(args))
    worst = 0.0
    for g in grads:
        upd_j, state = opt_j.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, params)
        upd_t = opt_t.update([torch.from_numpy(g["a"]),
                              torch.from_numpy(g["b"])])
        for key, u in zip(("a", "b"), upd_t):
            err = np.abs(u.numpy() - _np(upd_j[key])).max()
            worst = max(worst, err)
            assert err <= 1e-6, (key, err)
    print(name, args, "worst update difference", worst)


def test_clip_by_running_median_matches_jax():
    """The running-median clip across its warmup and a spike: the clipped
    updates within 1e-6 relative of medaka_tpu's."""
    clip_j = jax_training.clip_by_running_median(buffer_size=8, warmup=2)
    clip_t = training.clip_by_running_median(buffer_size=8, warmup=2)
    grads = _grad_stream(11, steps=14)
    state = clip_j.init(None)
    clipped = 0
    for g in grads:
        out_j, state = clip_j.update({k: jnp.asarray(v) for k, v in
                                      g.items()}, state)
        out_t = clip_t([torch.from_numpy(g["a"]), torch.from_numpy(g["b"])])
        for key, u in zip(("a", "b"), out_t):
            want = _np(out_j[key])
            np.testing.assert_allclose(u.numpy(), want, rtol=1e-6,
                                       atol=1e-7)
            clipped += int(not np.allclose(want, g[key]))
    assert clipped > 0
    np.testing.assert_allclose(clip_t.norms.numpy(), _np(state["norms"]),
                               rtol=1e-6)


def test_cosine_schedule_matches_optax():
    """cosine_schedule vs medaka_tpu's at every step of a 40-step schedule
    (4 warmup steps) and past its end: within 1e-6 relative."""
    ours = training.cosine_schedule(2e-3, 40)
    theirs = jax_training.cosine_schedule(2e-3, 40)
    for step in range(45):
        np.testing.assert_allclose(float(ours(step)), float(theirs(step)),
                                   rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------


def _csv_rows(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


def _port_run(labelled, out, jparams):
    batcher = training.TrainBatcher(
        [labelled["ours"]], validation=0.2, seed=3, batch_size=8,
        max_samples=32, max_valid_samples=8)
    training.run_training(
        out, batcher, model_dict=JaxGRUModel(gru_size=8).to_dict(),
        epochs=2, optimizer="nadam", optim_args={"learning_rate": 5e-3},
        compute_dtype=None, seed=3, initial_params=jparams, device="cpu")
    return _csv_rows(os.path.join(out, "training.csv"))


def test_run_training_matches_medaka_tpu(labelled, tmp_path):
    """run_training in f32 on the CPU vs medaka_tpu's run_training in f32,
    same initial weights, seed and batch order, 2 epochs: the loss of
    every training.csv row within 1e-4 relative; the last checkpoint
    gives the same probabilities in both packages (1e-5); a second
    identical run reproduces the losses exactly."""
    _, jparams = _jax_model(seed=7)
    ours = _port_run(labelled, str(tmp_path / "ours"), jparams)
    jbatcher = jax_training.TrainBatcher(
        [labelled["ours"]], validation=0.2, seed=3, batch_size=8,
        max_samples=32, max_valid_samples=8)
    jax_training.run_training(
        str(tmp_path / "theirs"), jbatcher,
        model_dict=JaxGRUModel(gru_size=8).to_dict(), epochs=2,
        optimizer="nadam", optim_args={"learning_rate": 5e-3},
        compute_dtype=None, seed=3, initial_params=jparams)
    theirs = _csv_rows(str(tmp_path / "theirs" / "training.csv"))
    assert [(r["split"], r["epoch"], r["batch"]) for r in ours] == \
        [(r["split"], r["epoch"], r["batch"]) for r in theirs]
    worst = 0.0
    for a, b in zip(ours, theirs):
        rel = abs(float(a["loss"]) - float(b["loss"])) / abs(float(b["loss"]))
        worst = max(worst, rel)
        assert rel <= 1e-4, (a, b)
        assert a["baseline_acc"] == b["baseline_acc"]
    print("worst relative loss difference", worst)
    train_losses = [float(r["loss"]) for r in ours if r["split"] == "train"]
    assert train_losses[-1] < train_losses[0]

    ckpt = str(tmp_path / "ours" / "model-1.tar.gz")
    x = np.random.default_rng(0).random((2, 50, 10)).astype(np.float32)
    port_bundle = models.load_model(ckpt)
    jax_bundle = jax_models.load_model(ckpt)
    assert isinstance(jax_bundle.label_scheme, jax_labels.HaploidLabelScheme)
    with torch.no_grad():
        p_ours = port_bundle.model(torch.from_numpy(x)).numpy()
    p_theirs = _np(jax_bundle.model.apply(jax_bundle.params, jnp.asarray(x)))
    np.testing.assert_allclose(p_ours, p_theirs, atol=1e-5)
    for name in ("model-0", "model-best_val_loss", "model-best_val_acc"):
        assert os.path.exists(str(tmp_path / "ours" / (name + ".tar.gz")))

    again = _port_run(labelled, str(tmp_path / "again"), jparams)
    assert [r["loss"] for r in again] == [r["loss"] for r in ours]


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_cli_features_and_train_on_cpu(labelled, tmp_path):
    """features --truth then train --cpu through cli.main, warm-started
    from a bundle medaka_tpu wrote: checkpoints that load and serve."""
    hdf = str(tmp_path / "train.hdf")
    assert cli.main(["features", labelled["bam"], hdf, "--truth",
                     labelled["truth"], "--chunk_len", "100",
                     "--regions", "synth:0-6000", "--quiet"]) == 0
    jmodel, jparams = _jax_model(seed=2)
    start = str(tmp_path / "start.tar.gz")
    jax_models.save_model(start, jmodel, jparams,
                          feature_encoder=jax_features.CountsFeatureEncoder(),
                          label_scheme=jax_labels.HaploidLabelScheme())
    run = str(tmp_path / "run")
    assert cli.main(["train", hdf, "--train_name", run, "--batch_size", "8",
                     "--epochs", "1", "--max_samples", "16",
                     "--optimizer", "adam", "--optim_args",
                     "learning_rate=1e-2", "--model", start, "--cpu",
                     "--quiet"]) == 0
    rows = _csv_rows(os.path.join(run, "training.csv"))
    assert [r["split"] for r in rows] == ["train"] * 2 + ["validation"] * 2
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    bundle = models.load_model(os.path.join(run, "model-0.tar.gz"))
    assert bundle.model.gru_size == 8
    with torch.no_grad():
        probs = bundle.model(torch.zeros((1, 20, 10)))
    assert probs.shape == (1, 20, 5)


def test_cli_train_model_parallel_on_one_device_raises_mesh_error(
        labelled, tmp_path, monkeypatch):
    """--model_parallel 2 with one device raises medaka_tpu's mesh error
    (data = gcd(batch, 1 // 2) = batch: a 128x2 mesh over 1 device), as
    medaka_tpu's run_training does on one device."""
    with pytest.raises(ValueError, match=r"mesh 128x2 != 1 devices"):
        cli.main(["train", labelled["ours"], "--train_name",
                  str(tmp_path / "x"), "--cpu", "--quiet",
                  "--model_parallel", "2"])
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *args: one)
    with pytest.raises(ValueError, match=r"mesh 128x2 != 1 devices"):
        jax_training.run_training(
            str(tmp_path / "y"), jax_training.TrainBatcher(
                [labelled["theirs"]], batch_size=128), model_parallel=2)
def test_cpu_flag_is_required_without_a_gpu(labelled, tmp_path):
    """train without --cpu asks for the GPU and raises where there is
    none (nothing falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    args = argparse.Namespace(
        features=[labelled["ours"]], validation_features=None,
        validation_split=0.2, seed=0, batch_size=8, max_samples=8,
        max_valid_samples=None, model=None, train_name=str(tmp_path / "g"),
        epochs=1, optimizer="adam", optim_args={}, cpu=False)
    with pytest.raises(RuntimeError, match="no GPU"):
        training.train(args)
