"""The port's scale-out against medaka_tpu's meshes, on the CPU.

Data-parallel inference over replicas (``Predictor(devices=...)``), the
train step on (data, model) meshes of gloo ranks (loss, gradients, counts
and batch-norm statistics global; the recurrent weights cut by gate
rows), ``run_training`` over spawned ranks (its rows, checkpoints and
resume snapshots), and the failures that must raise, each held against
``medaka_tpu.parallel`` on the conftest's 8 virtual CPU devices with the
same inputs and weights (made from numpy seeds). The multi-rank cases
share one set of 4 spawned gloo ranks (``tests/torch_parallel_worker.py``,
which imports no JAX); every collective there waits at most
``TIMEOUT_S``.
"""
import csv
import json
import multiprocessing
import os
import queue
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medaka_tpu import parallel as jax_parallel
from medaka_tpu import training as jax_training
from medaka_tpu.models.gru import GRUModel as JaxGRUModel
from medaka_tpu.models.latent_space_lstm import \
    LatentSpaceLSTM as JaxLatentSpaceLSTM
from medaka_tpu_torch import features, models, parallel, prediction, \
    testing, training
from medaka_tpu_torch.io.fastx import FastaReader
from medaka_tpu_torch.labels import HaploidLabelScheme
from tests import torch_parallel_worker as worker
from tests.torch_threads import one_thread  # noqa: F401

TIMEOUT_S = worker.TIMEOUT_S
WORLD = 4
#: test_parallel.py's bars for a sharded result against the unsharded one
RTOL, ATOL = 1e-5, 1e-6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """tests/test_parallel.py's setup: gru_size 32, (8, 64, 10) features,
    ragged lengths, labels and the masks of the lengths."""
    model = JaxGRUModel(num_features=10, num_classes=5, gru_size=32)
    params = _np_tree(model.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    x = rng.random((8, 64, 10)).astype(np.float32)
    lengths = np.array([64, 64, 50, 64, 3, 64, 64, 17], np.int32)
    labels = rng.integers(0, 5, (8, 64)).astype(np.int32)
    mask = (np.arange(64)[None, :] < lengths[:, None]).astype(np.float32)
    batch = {"features": x, "labels": labels, "mask": mask,
             "lengths": lengths}
    return model, params, batch


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """4 spawned gloo ranks that run jobs; ``pool(name, **kwargs)``
    returns {rank: result} of the ranks in the job's mesh."""
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path_factory.mktemp("pool") / "store")
    jobs = [ctx.Queue() for _ in range(WORLD)]
    results = ctx.Queue()
    procs = [ctx.Process(target=worker.pool_main,
                         args=(r, WORLD, store, jobs[r], results),
                         daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()

    def run(name, **kwargs):
        for q in jobs:
            q.put((name, kwargs))
        out = {}
        deadline = time.monotonic() + TIMEOUT_S
        for _ in range(WORLD):
            try:
                rank, ok, value = results.get(
                    timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                pytest.fail("a rank did not answer within {} s".format(
                    TIMEOUT_S))
            assert ok, "rank {} failed:\n{}".format(rank, value)
            if value is not None:
                out[rank] = value
        return out

    yield run
    for q in jobs:
        q.put(None)
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.terminate()


def _assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    flat_got = jax.tree_util.tree_leaves(got)
    flat_want = jax.tree_util.tree_leaves(_np_tree(want))
    assert len(flat_got) == len(flat_want)
    for a, b in zip(flat_got, flat_want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,data,model", [
    (8, None, 3), (8, 3, 2), (4, 4, 2), (1, 128, 2), (8, None, 2),
    (6, 3, 2)])
def test_mesh_raises_where_make_mesh_raises(n, data, model):
    """Mesh over n devices raises exactly where make_mesh raises, with its
    message."""
    try:
        jax_parallel.make_mesh(jax.devices()[:n], data=data, model=model)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        mesh = parallel.Mesh(["cpu"] * n, data=data, model=model)
        assert (mesh.data, mesh.model) == (n // model, model)
    else:
        with pytest.raises(ValueError) as info:
            parallel.Mesh(["cpu"] * n, data=data, model=model)
        assert str(info.value) == want


@pytest.mark.parametrize("model_par", [2, 4])
def test_shard_params_match_jax_shards(setup, model_par):
    """params_spec_for_model gives medaka_tpu's specs; shard_params gives
    each model rank the rows JAX places on its device."""
    model, params, _ = setup
    specs = parallel.params_spec_for_model(None, params)
    want = jax_parallel.params_spec_for_model(None, params)
    for a, b in zip(jax.tree_util.tree_leaves(specs, is_leaf=lambda v:
                                              isinstance(v, tuple)),
                    jax.tree_util.tree_leaves(want)):
        assert tuple(b) == a
    jmesh = jax_parallel.make_mesh(jax.devices()[:model_par], data=1,
                                   model=model_par)
    sharded = jax_parallel.shard_params(params, jmesh)
    for m in range(model_par):
        mesh = parallel.Mesh(["cpu"] * model_par, data=1, model=model_par)
        mesh.rank = m
        mine = parallel.shard_params(params, mesh)
        dev = jmesh.devices[0, m]
        for got, leaf in zip(jax.tree_util.tree_leaves(mine),
                             jax.tree_util.tree_leaves(sharded)):
            shard = next(s for s in leaf.addressable_shards
                         if s.device == dev)
            np.testing.assert_array_equal(got, np.asarray(shard.data))


def test_tp_fence():
    """Under a model axis the forward runs the scan on the shards, with
    medaka_tpu's warning; nothing otherwise."""
    net = models.model_from_dict(JaxGRUModel(gru_size=8).to_dict())
    assert parallel._tp_kernel_fence(net, None) == {}
    assert parallel._tp_kernel_fence(
        net, parallel.Mesh(["cpu"] * 2, data=2)) == {}
    fence = parallel._tp_kernel_fence(
        net, parallel.Mesh(["cpu"] * 2, data=1, model=2))
    assert fence["fused"] is False
    assert isinstance(fence["gate_gather"], parallel.ModelAxis)


# ---------------------------------------------------------------------------
# data-parallel inference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_replicas_match_sharded_forward(setup, k):
    """Predictor over k CPU replicas (k=3 pads 8 rows to 9) against
    make_sharded_forward on JAX's kx1 mesh, f32: within rtol 1e-5, atol
    1e-6; its decode route gives the argmax of those probabilities and the
    one-replica decode's bytes; each replica launched once."""
    model, params, batch = setup
    mesh = jax_parallel.make_mesh(jax.devices()[:k], data=k, model=1)
    fwd = jax_parallel.make_sharded_forward(model, mesh, compute_dtype=None)
    pad = (-8) % k      # medaka_tpu's Predictor pads as the port's does
    want = np.asarray(fwd(
        jax_parallel.shard_params(params, mesh),
        jnp.asarray(np.pad(batch["features"], ((0, pad), (0, 0), (0, 0)))),
        jnp.asarray(np.pad(batch["lengths"], (0, pad)))))[:8]
    net = models.model_from_dict(model.to_dict()).load_jax_params(params)
    pred = prediction.Predictor(net, compute_dtype=None,
                                devices=["cpu"] * k)
    assert len(pred.replicas) == k
    x = prediction.Batch(batch["features"], batch["lengths"], [None] * 8)
    got = pred.fetch(pred.dispatch(x), 8)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    phred = HaploidLabelScheme()._phred
    classes, quals = pred.fetch_decoded(pred.dispatch(x, decode=True), 8,
                                        phred)
    np.testing.assert_array_equal(classes, got.argmax(-1))
    one = prediction.Predictor(
        models.model_from_dict(model.to_dict()).load_jax_params(params),
        compute_dtype=None, device="cpu")
    c1, q1 = one.fetch_decoded(one.dispatch(x, decode=True), 8, phred)
    np.testing.assert_array_equal(classes, c1)
    np.testing.assert_array_equal(quals, q1)


def test_replicated_batch_size():
    """The automatic batch is the one-card batch times the distinct
    cards; replicas on the CPU keep the CPU's batch."""
    net = models.model_from_dict(JaxGRUModel(gru_size=8).to_dict())
    assert prediction.replicated_batch_size(
        net, [torch.device("cpu")] * 3) == 128
    assert parallel.distinct_cards(["cuda:0", "cuda:0"]) == 1
    assert parallel.distinct_cards(["cuda:0", "cuda:1", "cpu"]) == 2


# ---------------------------------------------------------------------------
# the train step on meshes
# ---------------------------------------------------------------------------


def _jax_steps(jmodel, params, batch, data, model_par, optimizer, steps,
               class_weights=None):
    mesh = jax_parallel.make_mesh(jax.devices()[:data * model_par],
                                  data=data, model=model_par)
    p = jax_parallel.shard_params(_np_tree(params), mesh)
    state = optimizer.init(p)
    step = jax_parallel.make_train_step(jmodel, optimizer, mesh,
                                        compute_dtype=None,
                                        class_weights=class_weights)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        p, state, loss, n_c, n_t = step(p, state, jbatch)
        losses.append(float(loss))
    return _np_tree(p), losses, state, (float(n_c), float(n_t))


MESHES = [(1, 1), (2, 1), (4, 1), (2, 2), (1, 4)]
#: (optimizer, learning rate, the clip of train's chain): optax.sgd(1e-2)
#: as in test_parallel.py, and train's default chain (clip, nadam at its
#: default rate 1e-4; at 1e-3 one leaf element of the 1x1 step moves by
#: 2.2e-6 from JAX's, nadam scaling a gradient element near zero to the
#: rate)
STEP_OPTIMIZERS = [("sgd", 1e-2, False), ("nadam", 1e-4, True)]


@pytest.mark.parametrize("opt", STEP_OPTIMIZERS, ids=lambda o: o[0])
@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=lambda m: "{}x{}".format(*m))
def test_step_is_topology_independent(setup, pool, mesh_shape, opt):
    """A step (optax.sgd(1e-2)), or two (train's clip + nadam chain), of
    the port on a (data, model) mesh of gloo ranks, with ragged masks (the
    ranks' mask sums differ), against medaka_tpu's make_train_step on the
    same mesh shape: the parameters within rtol 1e-5, atol 1e-6, the
    global losses within 1e-5 relative, the counts equal, the clip's
    norms (the whole gradient's, under a model axis too) within 1e-5
    relative; every rank ends with the same parameters and optimizer
    state, bit for bit."""
    model, params, batch = setup
    data, model_par = mesh_shape
    name, lr, clip = opt
    steps = 2 if clip else 1
    out = pool("step", data=data, model=model_par,
               model_dict=model.to_dict(), params=params, batch=batch,
               optimizer=name, lr=lr, clip=clip, steps=steps)
    assert sorted(out) == list(range(data * model_par))
    for rank in out:
        for a, b in zip(jax.tree_util.tree_leaves(out[rank]["params"]),
                        jax.tree_util.tree_leaves(out[0]["params"])):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(out[rank]["mu"], out[0]["mu"]):
            np.testing.assert_array_equal(a, b)
    joptimizer = jax_training.build_optimizer(
        name, None, {"learning_rate": lr}, clip=clip)
    want, losses, state, counts = _jax_steps(
        model, params, batch, data, model_par, joptimizer, steps)
    _assert_trees_close(out[0]["params"], want)
    np.testing.assert_allclose(out[0]["losses"], losses, rtol=1e-5)
    assert out[0]["counts"] == counts
    if clip:
        np.testing.assert_allclose(
            out[0]["norms"], np.asarray(state[0]["norms"])[:steps],
            rtol=1e-5)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)],
                         ids=lambda m: "{}x{}".format(*m))
def test_class_weighted_step_matches_jax(setup, pool, mesh_shape):
    """class_weights: the global weight sum divides the loss (the bars of
    test_step_is_topology_independent)."""
    model, params, batch = setup
    weights = np.array([1.0, 3.0, 0.5, 2.0, 1.0], np.float32)
    out = pool("step", data=mesh_shape[0], model=mesh_shape[1],
               model_dict=model.to_dict(), params=params, batch=batch,
               optimizer="sgd", lr=1e-2, clip=False, steps=1,
               class_weights=weights)
    want, losses, _, _ = _jax_steps(model, params, batch, *mesh_shape,
                                    optax.sgd(1e-2), 1,
                                    class_weights=weights)
    _assert_trees_close(out[0]["params"], want)
    np.testing.assert_allclose(out[0]["losses"], losses, rtol=1e-5)


@pytest.fixture(scope="module")
def read_level():
    """A small LatentSpaceLSTM and a read-level batch of 8 rows whose
    read counts differ from row to row (so from rank to rank)."""
    jmodel = JaxLatentSpaceLSTM(lstm_size=16, cnn_size=8,
                                kernel_sizes=(1, 3))
    params = _np_tree(jmodel.init_params(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(5)
    B, T, R = 8, 30, 6
    x = np.zeros((B, T, R, 4), np.int8)
    x[..., 0] = rng.integers(0, 6, (B, T, R))
    x[..., 1] = rng.integers(-1, 40, (B, T, R))
    x[..., 2] = rng.choice([-1, 1], (B, T, R))
    x[..., 3] = 60
    reads = np.array([6, 1, 4, 6, 2, 5, 3, 6])
    for i, r in enumerate(reads):
        x[i, :, r:] = 0
    lengths = np.array([30, 30, 21, 30, 9, 30, 30, 14], np.int32)
    batch = {"features": x,
             "labels": rng.integers(0, 5, (B, T)).astype(np.int32),
             "mask": (np.arange(T)[None, :]
                      < lengths[:, None]).astype(np.float32),
             "lengths": lengths}
    return jmodel, params, batch


@pytest.fixture(scope="module")
def read_level_refs(read_level, pool):
    """The 1-rank step of the port and medaka_tpu's step on its 4x1 mesh,
    for test_global_batch_norm."""
    jmodel, params, batch = read_level
    one = pool("step", data=1, model=1, model_dict=jmodel.to_dict(),
               params=params, batch=batch, optimizer="sgd", lr=1e-2,
               clip=False, steps=1)
    return one[0], _jax_steps(jmodel, params, batch, 4, 1, optax.sgd(1e-2),
                              1)


@pytest.mark.parametrize("data", [2, 4])
def test_global_batch_norm(read_level, read_level_refs, pool, data):
    """A training step of a LatentSpaceLSTM on 2 and 4 ranks: the loss, the
    updated parameters (so the gradients) and the running batch-norm
    statistics equal the 1-rank step's and medaka_tpu's 4x1 mesh step's
    within rtol 1e-5, atol 1e-6 (the ranks' rows hold different read
    counts, so local statistics would differ)."""
    jmodel, params, batch = read_level
    got = pool("step", data=data, model=1, model_dict=jmodel.to_dict(),
               params=params, batch=batch, optimizer="sgd", lr=1e-2,
               clip=False, steps=1)
    one, (want, losses, _, _) = read_level_refs
    for ref in (one["params"], want):
        _assert_trees_close(got[0]["params"], ref)
    np.testing.assert_allclose(got[0]["losses"], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)
    bn = got[0]["params"]["convs"][1]["bn"]
    assert not np.allclose(bn["mean"], 0.0)


@pytest.fixture(scope="module")
def jax_forwards(setup):
    """The f32 forward of the unsharded apply and of medaka_tpu's 4x2 and
    2x4 meshes (test_sharded_forward_matches_single's cases)."""
    model, params, batch = setup
    x, lengths = batch["features"], batch["lengths"]
    out = {"single": np.asarray(model.apply(params, x, lengths=lengths))}
    for data, model_par in ((4, 2), (2, 4)):
        mesh = jax_parallel.make_mesh(jax.devices()[:8], data=data,
                                      model=model_par)
        fwd = jax_parallel.make_sharded_forward(model, mesh,
                                                compute_dtype=None)
        out["{}x{}".format(data, model_par)] = np.asarray(fwd(
            jax_parallel.shard_params(params, mesh), jnp.asarray(x),
            jnp.asarray(lengths)))
    return out


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2), (1, 4)],
                         ids=lambda m: "{}x{}".format(*m))
def test_model_axis_forward_matches_single(setup, pool, jax_forwards,
                                           mesh_shape):
    """The f32 forward with the gate rows cut over the model axis
    (make_sharded_forward) against the unsharded apply and medaka_tpu's
    4x2 and 2x4 meshes (test_sharded_forward_matches_single): within
    rtol 1e-5, atol 1e-6."""
    model, params, batch = setup
    out = pool("forward", data=mesh_shape[0], model=mesh_shape[1],
               model_dict=model.to_dict(), params=params,
               x=batch["features"], lengths=batch["lengths"])
    for want in jax_forwards.values():
        np.testing.assert_allclose(out[0], want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# run_training over spawned ranks
# ---------------------------------------------------------------------------

GRU = {"type": "GRUModel", "kwargs": {"num_features": 10, "num_classes": 5,
                                      "gru_size": 8}}


@pytest.fixture(scope="module")
def feats(tmp_path_factory):
    """Labelled counts features (chunk_len 100) of a small genome."""
    d = tmp_path_factory.mktemp("dp")
    bam, ref = testing.create_synth_bam(
        str(d / "reads.bam"), ref_mb=0.006, depth=8, read_len=1500, seed=4)
    with FastaReader(ref) as fr:
        genome = fr.fetch("synth")
    subs = {p: "ACGT"[("ACGT".index(genome[p]) + 1) % 4] for p in (700, 4000)}
    truth = testing.create_truth_bam(str(d / "truth.bam"), ref,
                                     substitutions={"synth": subs},
                                     draft_fasta=str(d / "draft.fasta"))
    out = str(d / "feats.hdf")
    features.create_samples(bam, out, truth_bam=truth, chunk_len=100,
                            chunk_ovlp=0)
    return out


def _batcher(module, path):
    return module.TrainBatcher([path], validation=0.25, seed=3,
                               batch_size=8, max_samples=24,
                               max_valid_samples=8)


#: a constant rate: a 1-epoch run then stops where a 2-epoch run's first
#: epoch does (the schedule's length would follow the epochs)
RUN = dict(model_dict=GRU, optimizer="nadam",
           optim_args={"learning_rate": 5e-3}, compute_dtype=None, seed=3,
           use_lr_schedule=False)


def _rows(path):
    with open(os.path.join(path, "training.csv")) as fh:
        return list(csv.DictReader(fh))


def _weights(path):
    return models.load_model(path).model.jax_params()


def _assert_runs_close(got, want):
    a, b = _rows(got), _rows(want)
    assert [(r["split"], r["epoch"], r["batch"]) for r in a] == \
        [(r["split"], r["epoch"], r["batch"]) for r in b]
    for x, y in zip(a, b):
        assert abs(float(x["loss"]) - float(y["loss"])) <= \
            1e-5 * abs(float(y["loss"])), (x, y)
        assert x["acc"] == y["acc"] and x["baseline_acc"] == \
            y["baseline_acc"]
    last = "model-{}.tar.gz".format(a[-1]["epoch"])
    _assert_trees_close(_weights(os.path.join(got, last)),
                        _weights(os.path.join(want, last)))


@pytest.fixture(scope="module")
def one_rank(feats, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("one") / "run")
    training.run_training(out, _batcher(training, feats), epochs=2,
                          device="cpu", **RUN)
    return out


def test_run_training_over_two_ranks(feats, one_rank, tmp_path):
    """run_training(devices=["cpu"] * 2): 2 spawned gloo ranks, 4 rows
    each, 2 epochs: training.csv within 1e-5 relative of the 1-rank run
    (its accuracies equal) and the last checkpoint within rtol 1e-5, atol
    1e-6; each rank reports its device and backend; the returned model is
    the last checkpoint's."""
    out = str(tmp_path / "two")
    trained = training.run_training(out, _batcher(training, feats),
                                    epochs=2, devices=["cpu"] * 2, **RUN)
    _assert_runs_close(out, one_rank)
    for rank in range(2):
        with open(os.path.join(out, "rank{}.json".format(rank))) as fh:
            report = json.load(fh)
        assert report["backend"] == "gloo" and report["world"] == 2
    _assert_trees_close(trained.jax_params(),
                        _weights(os.path.join(out, "model-1.tar.gz")),
                        rtol=0, atol=0)


def test_two_rank_snapshot_resumes_on_one_rank_and_in_jax(
        feats, one_rank, tmp_path, monkeypatch):
    """A 2-rank run's snapshot after epoch 0 resumes on 1 rank to the
    1-rank run's epoch 1 (the bars of test_run_training_over_two_ranks),
    and in medaka_tpu (one device) to the same rows within 1e-4
    relative (test_torch_training's bar between the packages)."""
    two = str(tmp_path / "two")
    training.run_training(two, _batcher(training, feats), epochs=1,
                          devices=["cpu"] * 2, **RUN)
    theirs = str(tmp_path / "theirs")
    shutil.copytree(two, theirs)
    training.run_training(two, _batcher(training, feats), epochs=2,
                          resume=True, device="cpu", **RUN)
    _assert_runs_close(two, one_rank)
    first = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *args, **kw: first)
    jax_training.run_training(theirs, _batcher(jax_training, feats),
                              epochs=2, resume=True, **RUN)
    want = _rows(one_rank)
    got = _rows(theirs)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert abs(float(x["loss"]) - float(y["loss"])) <= \
            1e-4 * abs(float(y["loss"])), (x, y)


def test_model_parallel_run_training(feats, one_rank, tmp_path):
    """run_training(devices=["cpu"] * 2, model_parallel=2): a 1x2 mesh,
    the gate rows of every recurrent weight cut over 2 ranks, the scan on
    them: the 1-rank run's rows and last checkpoint (whole weights) to
    the bars of test_run_training_over_two_ranks."""
    out = str(tmp_path / "tp")
    training.run_training(out, _batcher(training, feats), epochs=2,
                          devices=["cpu"] * 2, model_parallel=2, **RUN)
    _assert_runs_close(out, one_rank)


def test_failing_rank_raises(feats, tmp_path):
    """A rank that cannot run (a tensor on the meta device reaches its
    first collective) makes run_training raise within the timeout, not
    hang; a CUDA rank without a GPU raises before any is spawned."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="training rank failed"):
        training.run_training(str(tmp_path / "f"), _batcher(training, feats),
                              epochs=1, devices=["cpu", "meta"],
                              timeout_s=60, **RUN)
    assert time.monotonic() - t0 < 60
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            training.run_training(str(tmp_path / "g"),
                                  _batcher(training, feats), epochs=1,
                                  devices=["cpu", "cuda:0"], **RUN)
