"""The port's read-level training path against medaka_tpu's, on the CPU.

The trainable LSTM kernels' plain versions (against ``lstm_pallas``/
``lstm_bwd_pallas`` with ``interpret=True``), the stack and
``LatentSpaceLSTM`` under autograd with training-mode batch norm, the
train step's running statistics, the majority-vote baseline, the
read-level ``TrainBatcher``, ``run_training`` and the CLI, each held
against the matching ``medaka_tpu`` call on the same inputs and weights
(made from numpy seeds), with each tolerance stated.
"""
import csv
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medaka_tpu import datastore as jax_datastore
from medaka_tpu import features as jax_features
from medaka_tpu import labels as jax_labels
from medaka_tpu import models as jax_models
from medaka_tpu import parallel as jax_parallel
from medaka_tpu import training as jax_training
from medaka_tpu.ops import pallas_gru
from medaka_tpu_torch import cli, datastore, features, models, parallel, \
    testing, training
from medaka_tpu_torch.io.fastx import FastaReader
from medaka_tpu_torch.models.latent_space_lstm import LatentSpaceLSTM, \
    MaskedBatchStats, params_from_jax
from medaka_tpu_torch.ops import lstm_train

BF16_STEP = 2.0 ** -8    # one bf16 step for |h| < 1
ENCODER = "ReadAlignmentFeatureEncoder"


def _np(x):
    return np.asarray(x, np.float32)


def _bf16_round(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret=True)
# ---------------------------------------------------------------------------


def _direction_inputs(seed, T=24, B=3, H=16):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    xp = _bf16_round(rng.uniform(-2, 2, (T, B, 4 * H)).astype(np.float32))
    w = rng.uniform(-k, k, (4 * H, H)).astype(np.float32)
    b = rng.uniform(-k, k, (4 * H,)).astype(np.float32)
    lengths = np.array([T, T // 3, T - 5][:B], np.int32)
    dh = _bf16_round(rng.standard_normal((T, B, H)).astype(np.float32))
    return xp, w, b, lengths, dh


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_fwd_plain_matches_lstm_pallas(reverse):
    """lstm_fwd_plain vs lstm_pallas(interpret=True), ragged lengths: h
    within one bf16 step and c within 1e-5 of its largest magnitude (the
    sigmoid and tanh implementations differ; measured h identical, c
    2.4e-7); padded steps freeze h and c."""
    xp, w, b, lengths, _ = _direction_inputs(1 + reverse)
    want_h, want_c = pallas_gru.lstm_pallas(
        jnp.asarray(xp, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(lengths), reverse=reverse, interpret=True)
    h, c = lstm_train.lstm_fwd(
        torch.from_numpy(xp).to(torch.bfloat16), torch.from_numpy(w),
        torch.from_numpy(b), torch.from_numpy(lengths), reverse)
    assert h.dtype == torch.bfloat16 and c.dtype == torch.float32
    diff = np.abs(h.float().numpy() - _np(want_h))
    print("lstm_fwd plain vs pallas: h max", diff.max(), "c relative",
          _rel(c.numpy(), _np(want_c)))
    assert diff.max() <= BF16_STEP
    assert _rel(c.numpy(), _np(want_c)) <= 1e-5
    t_pad = np.arange(xp.shape[0])[:, None] >= lengths[None, :]
    g, cg = h.float().numpy(), c.numpy()
    if reverse:
        assert np.all(g[t_pad] == 0) and np.all(cg[t_pad] == 0)
    else:
        assert np.array_equal(g[-1, 1], g[lengths[1] - 1, 1])
        assert np.array_equal(cg[-1, 1], cg[lengths[1] - 1, 1])


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_bwd_plain_matches_lstm_bwd_pallas(reverse):
    """lstm_bwd_plain vs lstm_bwd_pallas(interpret=True) on the same bf16
    forward outputs, f32 cell states and upstream gradient: dxp, dW_hh and
    db_hh within 1e-5 of each tensor's largest magnitude (measured
    2.1e-7 at worst)."""
    xp, w, b, lengths, dh = _direction_inputs(3 + reverse)
    xj = jnp.asarray(xp, jnp.bfloat16)
    h_out, c_out = pallas_gru.lstm_pallas(
        xj, jnp.asarray(w), jnp.asarray(b), jnp.asarray(lengths),
        reverse=reverse, interpret=True)
    want = pallas_gru.lstm_bwd_pallas(
        xj, h_out, c_out, jnp.asarray(dh), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(lengths), reverse=reverse, interpret=True)
    got = lstm_train.lstm_bwd(
        torch.from_numpy(xp).to(torch.bfloat16),
        torch.from_numpy(_np(h_out)).to(torch.bfloat16),
        torch.from_numpy(_np(c_out)), torch.from_numpy(dh),
        torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(lengths),
        reverse)
    for name, g, wt in zip(("dxp", "dW_hh", "db_hh"), got, want):
        rel = _rel(g.numpy(), _np(wt).reshape(g.shape))
        print(name, "relative max", rel)
        assert g.dtype == torch.float32
        assert rel <= 1e-5


# ---------------------------------------------------------------------------
# the stack and the model under autograd
# ---------------------------------------------------------------------------


def _lstm_layer(rng, in_size, hidden):
    k = 1.0 / np.sqrt(hidden)
    return {name: rng.uniform(-k, k, shape).astype(np.float32)
            for name, shape in (("w_ih", (4 * hidden, in_size)),
                                ("w_hh", (4 * hidden, hidden)),
                                ("b_ih", (4 * hidden,)),
                                ("b_hh", (4 * hidden,)))}


def _layers(rng, bidirectional, hidden=8, in_size=12):
    if bidirectional:
        return [{"fwd": _lstm_layer(rng, i, hidden),
                 "bwd": _lstm_layer(rng, i, hidden)}
                for i in (in_size, 2 * hidden)]
    # the ReversibleLSTM interleave: 4 single-direction layers
    return [{"fwd": _lstm_layer(rng, in_size if k == 0 else hidden,
                                hidden)} for k in range(4)]


def _assert_grads_close(ours, theirs, bar):
    """Each gradient leaf within ``bar`` of its largest magnitude."""
    worst = 0.0
    for key, g in ours.items():
        rel = _rel(g, theirs[key])
        worst = max(worst, rel)
        assert rel <= bar, (key, rel)
    print("worst relative gradient difference", worst)
    return worst


@pytest.mark.parametrize("bidirectional", [True, False])
def test_stack_autograd_matches_jax_grad(bidirectional):
    """bilstm_stack_trainable (plain route) and its gradients vs jax.grad
    of pallas_gru.bilstm_stack_trainable(interpret=True), ragged lengths:
    outputs within one bf16 step, every gradient leaf (w_ih, w_hh, b_ih,
    b_hh of every layer and the input) within 1e-4 of its largest
    magnitude."""
    rng = np.random.default_rng(11 + bidirectional)
    layers = _layers(rng, bidirectional)
    B, T = 4, 20
    x = rng.standard_normal((B, T, 12)).astype(np.float32)
    lengths = np.array([T, 13, 5, T - 1], np.int32)
    proj = rng.standard_normal((B, T, 16 if bidirectional else 8)).astype(
        np.float32)

    def jax_loss(ls, xx):
        out = pallas_gru.bilstm_stack_trainable(
            ls, xx, lengths=jnp.asarray(lengths),
            bidirectional=bidirectional, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * proj), out

    (_, j_out), (j_grads, j_dx) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, layers), jnp.asarray(x))
    t_layers = jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), layers)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = lstm_train.bilstm_stack_trainable(
        t_layers, tx, lengths=torch.from_numpy(lengths),
        bidirectional=bidirectional)
    assert out.dtype == torch.bfloat16
    assert out.shape == (B, T, 16 if bidirectional else 8)
    diff = np.abs(out.float().detach().numpy() - _np(j_out))
    print("stack outputs max", diff.max())
    assert diff.max() <= BF16_STEP
    (out.float() * torch.from_numpy(proj)).sum().backward()
    ours = {"x": tx.grad.numpy()}
    theirs = {"x": _np(j_dx)}
    for k, layer in enumerate(t_layers):
        for d, p in layer.items():
            for name, v in p.items():
                key = "{}.{}.{}".format(k, d, name)
                ours[key] = v.grad.numpy()
                theirs[key] = _np(j_grads[k][d][name])
    assert len(ours) == 1 + 16
    _assert_grads_close(ours, theirs, 1e-4)


def _rl_models(seed=1, **kwargs):
    """A small LatentSpaceLSTM in both packages with JAX's random init."""
    geometry = dict(lstm_size=8, cnn_size=8, kernel_sizes=(1, 3),
                    use_dwells=True)
    geometry.update(kwargs)
    model = LatentSpaceLSTM(**geometry)
    jmodel = jax_models.model_from_dict(model.to_dict())
    jparams = jax.tree.map(np.asarray,
                           jmodel.init_params(jax.random.PRNGKey(seed)))
    model.load_jax_params(jparams)
    return model, jmodel, jparams


def _rl_batch(seed=1, B=3, T=30, R=6):
    """int8 read-level features with ragged lengths and empty read rows."""
    rng = np.random.default_rng(seed)
    x = np.zeros((B, T, R, 5), np.int8)
    x[..., 0] = rng.integers(0, 6, (B, T, R))
    x[..., 1] = rng.integers(-1, 40, (B, T, R))
    x[..., 2] = rng.choice([-1, 1], (B, T, R))
    x[..., 3] = 60
    x[..., 4] = rng.integers(0, 12, (B, T, R))
    x[0, :, 4:] = 0                                   # two empty read rows
    x[2, :, 1:] = 0
    lengths = np.array([T, 17, T - 4][:B], np.int32)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return {"features": x,
            "labels": rng.integers(0, 5, (B, T)).astype(np.int32),
            "mask": mask, "lengths": lengths}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(model):
    return {k: p.grad.numpy() for k, p in model.named_parameters()}


def _jax_grads(grads):
    return {k: v.numpy() for k, v in params_from_jax(grads).items()}


@pytest.mark.parametrize("mode", ["f32", "bf16_fused"])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_model_training_matches_jax(mode, bidirectional, monkeypatch):
    """LatentSpaceLSTM.forward(training=True): the masked cross-entropy,
    the logits, each conv layer's batch (mean, var) and every parameter
    gradient vs JAX apply(training=True, bn_stats=...) and jax.grad.

    f32 (the scan under autograd): loss within 1e-5 relative, logits and
    statistics within 1e-5, gradients within 1e-4 of each leaf's largest
    magnitude (measured 6.8e-6). bf16 with ``fused=True`` (the kernels'
    plain versions) against apply(fused=True) with the Pallas pair in
    interpret mode: loss within 1e-5 relative, statistics within 2e-2,
    the LSTM stack's and the head's gradients within 1e-4 (measured
    2.4e-7). Upstream of the stack the two frameworks sum the bf16
    convolution, batch-norm and embedding gradients at other precisions
    (XLA's broadcast gradients in bf16, PyTorch's in f32), and a bias
    gradient that cancels keeps few bits (the two bf16 routes differ by up
    to 36% there): each of those leaves must be no further from JAX's
    f32 gradient than JAX's own bf16 gradient is, within 1.25x + 1e-2."""
    model, jmodel, jparams = _rl_models(bidirectional=bidirectional)
    batch = _rl_batch(seed=2 + bidirectional)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    kwargs, cd, jcd = {}, None, None
    if mode == "bf16_fused":
        monkeypatch.setattr(pallas_gru, "bilstm_stack_trainable",
                            functools.partial(
                                pallas_gru.bilstm_stack_trainable,
                                interpret=True))
        kwargs, cd, jcd = {"fused": True}, torch.bfloat16, jnp.bfloat16

    def jloss(p):
        stats = []
        loss, _ = jax_parallel.cross_entropy_loss(
            jmodel, p, jbatch, compute_dtype=jcd,
            apply_kwargs=dict(kwargs, bn_stats=stats))
        return loss, stats

    (j_loss, j_stats), j_grads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, jparams))
    j_logits = jmodel.apply(jparams, jbatch["features"], normalise=False,
                            compute_dtype=jcd, lengths=jbatch["lengths"],
                            training=True, **kwargs)
    stats = []
    loss, (_, n_t) = parallel.cross_entropy_loss(
        lambda *a, **kw: model(*a, **kwargs, **kw), _torch_batch(batch),
        compute_dtype=cd, training=True, bn_stats=stats)
    loss.backward()
    with torch.no_grad():
        logits = model(torch.from_numpy(batch["features"]),
                       lengths=torch.from_numpy(batch["lengths"]),
                       normalise=False, compute_dtype=cd, training=True,
                       **kwargs)
    f32 = mode == "f32"
    print("loss", loss.item(), "jax", float(j_loss))
    assert float(n_t) == batch["mask"].sum()
    assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    if f32:
        np.testing.assert_allclose(logits.numpy(), _np(j_logits), atol=1e-5)
    assert len(stats) == len(j_stats) == 2
    for (m, v), (jm, jv) in zip(stats, j_stats):
        for got, want in ((m, jm), (v, jv)):
            assert got.dtype == torch.float32
            assert _rel(got.detach().numpy(), _np(want)) <= \
                (1e-5 if f32 else 2e-2)
    ours, theirs = _port_grads(model), _jax_grads(j_grads)
    assert set(ours) < set(theirs)
    if f32:
        _assert_grads_close(ours, theirs, 1e-4)
        return
    stack = ("lstm.", "linear.")
    _assert_grads_close({k: g for k, g in ours.items()
                         if k.startswith(stack)}, theirs, 1e-4)
    j_f32 = _jax_grads(jax.grad(lambda p: jax_parallel.cross_entropy_loss(
        jmodel, p, jbatch)[0])(jax.tree.map(jnp.asarray, jparams)))
    for key, g in ours.items():
        if not key.startswith(stack):
            ours_err, jax_err = _rel(g, j_f32[key]), _rel(theirs[key],
                                                          j_f32[key])
            print(key, "vs f32: port bf16", ours_err, "jax bf16", jax_err)
            assert ours_err <= 1.25 * jax_err + 1e-2, key


def test_masked_batch_stats_in_slices(monkeypatch):
    """MaskedBatchStats gives the same statistics and gradient when it
    walks the activation one row at a time as in one slice (the slices
    bound its f32 temporaries at full size), and its gradient equals
    autograd through the eager expressions within 1e-6."""
    from medaka_tpu_torch.models import latent_space_lstm as lsl
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((10, 3, 7)).astype(np.float32))
    w = torch.from_numpy((rng.random(10) > 0.3).astype(np.float32))
    g_m = torch.from_numpy(rng.standard_normal(3).astype(np.float32))
    g_v = torch.from_numpy(rng.standard_normal(3).astype(np.float32))

    def run(fn):
        xx = x.clone().requires_grad_(True)
        m, v = fn(xx)
        ((m * g_m).sum() + (v * g_v).sum()).backward()
        return m.detach(), v.detach(), xx.grad

    def eager(xx):
        n = torch.clamp(w.sum() * 7, min=1.0)
        mean = (xx * w[:, None, None]).sum(dim=(0, 2)) / n
        var = ((xx - mean[:, None]) ** 2 * w[:, None, None]).sum(
            dim=(0, 2)) / n
        return mean, var

    want = run(eager)
    whole = run(lambda xx: MaskedBatchStats.apply(xx, w))
    monkeypatch.setattr(lsl, "_STATS_CHUNK", 21)
    sliced = run(lambda xx: MaskedBatchStats.apply(xx, w))
    for a, b, c in zip(whole, sliced, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-6)


def test_table_lookup_gradient_matches_indexing():
    """TableLookup gives table[idx] exactly and the gradient of the
    indexing (a scatter-add into the table's rows) within 1e-6, rows no
    index reaches included."""
    from medaka_tpu_torch.models.latent_space_lstm import TableLookup
    rng = np.random.default_rng(6)
    table = torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 5, (3, 7, 5)))
    g = torch.from_numpy(rng.standard_normal((3, 7, 5, 4)).astype(
        np.float32))
    a = table.clone().requires_grad_(True)
    b = table.clone().requires_grad_(True)
    out = TableLookup.apply(a, idx)
    assert torch.equal(out, table[idx])
    (out * g).sum().backward()
    (b[idx] * g).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-6)
    assert torch.equal(a.grad[5], torch.zeros(4))


def test_train_step_running_stats_match_jax():
    """Two f32 train steps (adam) vs medaka_tpu.parallel.make_train_step on
    a one-device mesh: losses within 1e-5 relative, every parameter within
    1e-6 and the running mean and variance within 1e-6 after each step;
    the running statistics moved off (0, 1)."""
    model, jmodel, jparams = _rl_models(seed=3)
    mesh = jax_parallel.make_mesh(jax.devices()[:1], data=1)
    j_opt = jax_training.build_optimizer("adam", None,
                                         {"learning_rate": 1e-3})
    j_step = jax_parallel.make_train_step(jmodel, j_opt, mesh,
                                          compute_dtype=None)
    params = jax.tree.map(jnp.asarray, jparams)
    opt_state = j_opt.init(params)
    step = parallel.make_train_step(
        model, training.build_optimizer("adam", None,
                                        {"learning_rate": 1e-3}),
        compute_dtype=None)
    for i in range(2):
        batch = _rl_batch(seed=10 + i)
        params, opt_state, j_loss, _, _ = j_step(
            params, opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
        loss, _, _ = step(_torch_batch(batch))
        assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))
        want = {k: v.numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, params)).items()}
        for key, value in model.state_dict().items():
            np.testing.assert_allclose(value.numpy(), want[key], atol=1e-6,
                                       err_msg=key)
    bn = model.convs[0]["bn"]
    assert not torch.equal(bn.mean, torch.zeros_like(bn.mean))
    assert not torch.equal(bn.var, torch.ones_like(bn.var))


# ---------------------------------------------------------------------------
# labelled read-level features, the baseline and the batcher
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rl_labelled(tmp_path_factory):
    """A 10 kb synthetic BAM with move tables at depth 10, its truth BAM
    with 3 planted draft substitutions, and labelled read-level feature
    files (dwells on, max_reads 16, chunk_len 100) from both packages."""
    d = tmp_path_factory.mktemp("rl_train")
    bam, ref = testing.create_synth_bam(str(d / "reads.bam"), ref_mb=0.01,
                                        depth=10, read_len=2000, seed=5,
                                        move_tables=True)
    with FastaReader(ref) as fr:
        genome = fr.fetch("synth")
    subs = {p: "ACGT"[("ACGT".index(genome[p]) + 1) % 4]
            for p in (700, 4321, 8000)}
    truth = testing.create_truth_bam(str(d / "truth.bam"), ref,
                                     substitutions={"synth": subs},
                                     draft_fasta=str(d / "draft.fasta"))
    run = dict(truth_bam=truth, chunk_len=100, chunk_ovlp=0,
               feature_encoder_name=ENCODER,
               feature_encoder_args={"max_reads": 16})
    ours, theirs = str(d / "ours.hdf"), str(d / "theirs.hdf")
    n_ours = features.create_samples(bam, ours, **run)
    n_theirs = jax_features.create_samples(bam, theirs, **run)
    return dict(dir=d, bam=bam, truth=truth, ours=ours, theirs=theirs,
                n=(n_ours, n_theirs))


def test_counts_matrix_and_majority_vote_equal_jax(rl_labelled):
    """Sample.counts_matrix and majority_vote_probs of every read-level
    sample array-equal to medaka_tpu's (the reference's lowercase-forward
    channels included), and 2-D features pass through counts_matrix."""
    names = datastore.DataIndex(rl_labelled["ours"]).samples
    ours = list(datastore.DataIndex(rl_labelled["ours"])
                .yield_from_feature_files(samples=names))
    theirs = list(jax_datastore.DataIndex(rl_labelled["ours"])
                  .yield_from_feature_files(samples=names))
    assert len(ours) == len(theirs) > 50
    minor_cols = 0
    for a, b in zip(ours, theirs):
        assert a.features.ndim == 3
        np.testing.assert_array_equal(a.counts_matrix, b.counts_matrix)
        np.testing.assert_array_equal(a.majority_vote_probs,
                                      b.majority_vote_probs)
        minor_cols += int((a.positions["minor"] > 0).sum())
    assert minor_cols > 0
    flat = ours[0].amend(features=ours[0].counts_matrix)
    assert flat.counts_matrix is flat.features


def test_read_level_feature_files_match_medaka_tpu(rl_labelled):
    """features --truth with ReadAlignmentFeatureEncoder: the same samples
    (int8 features, labels, positions) in both packages' files."""
    assert rl_labelled["n"][0] == rl_labelled["n"][1] > 50
    names = datastore.DataIndex(rl_labelled["ours"]).samples
    ours = list(datastore.DataIndex(rl_labelled["ours"])
                .yield_from_feature_files(samples=names))
    theirs = list(jax_datastore.DataIndex(rl_labelled["theirs"])
                  .yield_from_feature_files(
                      samples=[(s, rl_labelled["theirs"]) for s, _ in names]))
    for a, b in zip(ours, theirs):
        assert a.name == b.name and a.features.dtype == np.int8
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("which", ["ours", "theirs"])
def test_read_level_batches_equal_jax(rl_labelled, which):
    """Each package's read-level file serves the same batches in both
    packages' TrainBatcher: int8 (B, T, max_reads, C) features padded to
    the encoder's static max_reads, labels, mask, lengths and the
    host-side baseline_pred, for the train and validation splits."""
    path = rl_labelled[which]
    ours = training.TrainBatcher([path], validation=0.2, seed=1,
                                 batch_size=8)
    theirs = jax_training.TrainBatcher([path], validation=0.2, seed=1,
                                       batch_size=8)
    assert ours.is_read_level and theirs.is_read_level
    assert ours.train_samples == theirs.train_samples
    assert (ours.time_steps, ours.max_reads, ours.feat_dim) == (100, 16, 5)
    for split in ("train", "validation"):
        a = next(ours.batches(split, seed=2))
        b = next(theirs.batches(split, seed=2))
        assert a["features"].dtype == np.int8
        assert a["features"].shape == (8, 100, 16, 5)
        assert sorted(a) == sorted(b) == [
            "baseline_pred", "features", "labels", "lengths", "mask"]
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
        assert (a["baseline_pred"] == a["labels"])[a["mask"] > 0].mean() \
            > 0.9


# ---------------------------------------------------------------------------
# the training loop and the command line
# ---------------------------------------------------------------------------


def _csv_rows(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


_RUN = dict(epochs=2, optimizer="nadam", optim_args={"learning_rate": 5e-3},
            compute_dtype=None, seed=3)


def _batcher(module, path):
    return module.TrainBatcher([path], validation=0.2, seed=3, batch_size=8,
                               max_samples=24, max_valid_samples=8)


def test_run_training_read_level_matches_medaka_tpu(rl_labelled, tmp_path):
    """run_training in f32 on the CPU vs medaka_tpu's run_training in f32
    on read-level files, same initial weights, seed and batch order, 2
    epochs: the loss of every training.csv row within 1e-4 relative and
    the same baseline accuracy; the last checkpoint (running statistics
    included) gives the same probabilities in both packages (1e-5); a
    second identical run reproduces the losses exactly."""
    _, jmodel, jparams = _rl_models(seed=7)
    model_dict = jmodel.to_dict()
    out = str(tmp_path / "ours")
    training.run_training(out, _batcher(training, rl_labelled["ours"]),
                          model_dict=model_dict, initial_params=jparams,
                          device="cpu", **_RUN)
    ours = _csv_rows(os.path.join(out, "training.csv"))
    jax_training.run_training(
        str(tmp_path / "theirs"), _batcher(jax_training, rl_labelled["ours"]),
        model_dict=model_dict, initial_params=jparams, **_RUN)
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

    ckpt = os.path.join(out, "model-1.tar.gz")
    port_bundle = models.load_model(ckpt)
    jax_bundle = jax_models.load_model(ckpt)
    assert port_bundle.feature_encoder.max_reads == 16
    bn = port_bundle.model.convs[1]["bn"]
    assert not torch.equal(bn.mean, torch.zeros_like(bn.mean))
    x = _rl_batch(seed=9)["features"]
    with torch.no_grad():
        p_ours = port_bundle.model(torch.from_numpy(x)).numpy()
    p_theirs = _np(jax_bundle.model.apply(jax_bundle.params, jnp.asarray(x)))
    np.testing.assert_allclose(p_ours, p_theirs, atol=1e-5)

    again = str(tmp_path / "again")
    training.run_training(again, _batcher(training, rl_labelled["ours"]),
                          model_dict=model_dict, initial_params=jparams,
                          device="cpu", **_RUN)
    assert [r["loss"] for r in _csv_rows(
        os.path.join(again, "training.csv"))] == [r["loss"] for r in ours]


def test_run_training_default_read_level_model(rl_labelled, tmp_path):
    """With no model_dict a read-level file trains the reference's
    rl_lstm384 geometry (lstm_size 384, cnn_size 128, kernel sizes 1 and
    17, dwells following the encoder), as medaka_tpu's run_training."""
    model = training.run_training(
        str(tmp_path / "default"), _batcher(training, rl_labelled["ours"]),
        epochs=0, device="cpu")
    assert isinstance(model, LatentSpaceLSTM)
    kwargs = model.to_dict()["kwargs"]
    assert (kwargs["lstm_size"], kwargs["cnn_size"], kwargs["kernel_sizes"],
            kwargs["use_dwells"]) == (384, 128, [1, 17], True)


def test_feature_kind_mismatch_is_refused(rl_labelled, tmp_path):
    """A counts model on read-level files raises a ValueError naming
    them, as medaka_tpu's run_training does."""
    with pytest.raises(ValueError, match="read-level"):
        training.run_training(
            str(tmp_path / "x"), _batcher(training, rl_labelled["ours"]),
            model_dict=dict(models.DEFAULT_MODEL_DICT), epochs=1,
            device="cpu")


def test_cli_read_level_features_and_train_on_cpu(rl_labelled, tmp_path):
    """features --truth --feature_encoder ReadAlignmentFeatureEncoder then
    train --cpu through cli.main, warm-started from a read-level bundle
    medaka_tpu wrote (bf16, so the kernels' plain versions under
    autograd): finite losses, checkpoints with moved running statistics
    that load in both packages and serve inference + sequence."""
    hdf = str(tmp_path / "train.hdf")
    assert cli.main(["features", rl_labelled["bam"], hdf, "--truth",
                     rl_labelled["truth"], "--feature_encoder", ENCODER,
                     "--feature_encoder_args", "max_reads=16",
                     "--chunk_len", "100", "--regions", "synth:0-4000",
                     "--quiet"]) == 0
    jmodel = jax_models.model_from_dict(LatentSpaceLSTM(
        lstm_size=8, cnn_size=8, kernel_sizes=(1, 3),
        use_dwells=True).to_dict())
    start = str(tmp_path / "start.tar.gz")
    jax_models.save_model(
        start, jmodel, jmodel.init_params(jax.random.PRNGKey(2)),
        feature_encoder=jax_features.ReadAlignmentFeatureEncoder(
            max_reads=16),
        label_scheme=jax_labels.HaploidLabelScheme())
    run = str(tmp_path / "run")
    assert cli.main(["train", hdf, "--train_name", run, "--batch_size", "8",
                     "--epochs", "1", "--max_samples", "16",
                     "--optimizer", "adam", "--optim_args",
                     "learning_rate=1e-2", "--model", start, "--cpu",
                     "--quiet"]) == 0
    rows = _csv_rows(os.path.join(run, "training.csv"))
    assert [r["split"] for r in rows] == ["train"] * 2 + ["validation"]
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    assert all("baseline_acc" in r for r in rows)
    ckpt = os.path.join(run, "model-0.tar.gz")
    bundle = models.load_model(ckpt)
    assert isinstance(bundle.model, LatentSpaceLSTM)
    assert not torch.equal(bundle.model.convs[0]["bn"].var,
                           torch.ones(8))
    assert jax_models.load_model(ckpt).model.lstm_size == 8
    probs, fasta = str(tmp_path / "probs.hdf"), str(tmp_path / "out.fasta")
    assert cli.main(["inference", rl_labelled["bam"], probs, "--model",
                     ckpt, "--chunk_len", "1000", "--chunk_ovlp", "100",
                     "--regions", "synth:0-4000", "--batch_size", "4",
                     "--cpu", "--quiet"]) == 0
    assert cli.main(["sequence", probs,
                     str(rl_labelled["dir"] / "draft.fasta"), fasta,
                     "--quiet"]) == 0
    with FastaReader(fasta) as fr:
        assert len(fr.fetch("synth")) > 1000


def test_train_read_level_without_gpu_raises(rl_labelled, tmp_path):
    """train on read-level files without --cpu asks for the GPU and raises
    where there is none (nothing falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        cli.main(["train", rl_labelled["ours"], "--train_name",
                  str(tmp_path / "g"), "--epochs", "1", "--quiet"])
