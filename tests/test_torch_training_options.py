"""The port's training options against medaka_tpu's, on the CPU.

``train --resume`` (a run killed after epoch 1 and resumed equals the run
straight through, bit for bit in f32; a resume snapshot of either package
resumes in the other), ``--validate_only``, architecture TOML files and
``tools export``, each held against the matching ``medaka_tpu`` call on
the same inputs and weights (made from numpy seeds).
"""
import argparse
import csv
import os
import shutil
import tarfile
import tomllib

import jax
import numpy as np
import pytest
import torch

from medaka_tpu import cli as jax_cli
from medaka_tpu import models as jax_models
from medaka_tpu import training as jax_training
from medaka_tpu_torch import cli, features, labels, models, testing, training
from medaka_tpu_torch.io.fastx import FastaReader
from tests.torch_threads import one_thread  # noqa: F401

#: a small counts GRUModel and read-level LatentSpaceLSTM
GRU = {"type": "GRUModel", "kwargs": {"num_features": 10, "num_classes": 5,
                                      "gru_size": 8}}
LSTM = {"type": "LatentSpaceLSTM", "kwargs": {
    "lstm_size": 8, "cnn_size": 8, "kernel_sizes": [1, 3],
    "use_dwells": True}}


def _labelled(d, read_level):
    bam, ref = testing.create_synth_bam(
        str(d / "reads.bam"), ref_mb=0.006, depth=8, read_len=1500, seed=4,
        move_tables=read_level)
    with FastaReader(ref) as fr:
        genome = fr.fetch("synth")
    subs = {p: "ACGT"[("ACGT".index(genome[p]) + 1) % 4] for p in (700, 4000)}
    truth = testing.create_truth_bam(str(d / "truth.bam"), ref,
                                     substitutions={"synth": subs},
                                     draft_fasta=str(d / "draft.fasta"))
    out = str(d / "feats.hdf")
    kwargs = dict(feature_encoder_name="ReadAlignmentFeatureEncoder",
                  feature_encoder_args={"max_reads": 8}) \
        if read_level else {}
    features.create_samples(bam, out, truth_bam=truth, chunk_len=100,
                            chunk_ovlp=0, **kwargs)
    return out


@pytest.fixture(scope="module")
def feats(tmp_path_factory):
    """Labelled counts and read-level feature files (chunk_len 100) of
    small synthetic genomes."""
    d = tmp_path_factory.mktemp("opts")
    (d / "rl").mkdir()
    return {"counts": _labelled(d, False), "reads": _labelled(d / "rl", True)}


@pytest.fixture(autouse=True)
def one_jax_device(monkeypatch):
    """medaka_tpu's training builds its mesh over ``jax.devices()``: one
    device, as the port trains on one."""
    first = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *args, **kw: first)


def _csv_rows(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


def _npz(path):
    with tarfile.open(path) as tar, np.load(
            tar.extractfile("model/weights.npz")) as z:
        return {k: z[k] for k in z.files}


def _write_arch(path, model_dict):
    with open(path, "w") as fh:
        models.toml_dump({"model": model_dict}, fh)
    return path


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------


def _kill_after(monkeypatch, passes):
    """Make training.run_epoch raise after ``passes`` calls (a kill)."""
    real = training.run_epoch
    calls = {"n": 0}

    def dying(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] > passes:
            raise RuntimeError("simulated kill -9")
        return real(*args, **kwargs)
    monkeypatch.setattr(training, "run_epoch", dying)
    return lambda: monkeypatch.setattr(training, "run_epoch", real)


def _train_counts(feats, tmp_path, name, extra=()):
    arch = _write_arch(str(tmp_path / "arch.toml"), GRU)
    return cli.main(["train", feats["counts"], "--train_name",
                     str(tmp_path / name), "--model", arch, "--batch_size",
                     "8", "--epochs", "4", "--max_samples", "24",
                     "--max_valid_samples", "8", "--optimizer", "nadam",
                     "--optim_args", "learning_rate=5e-3", "--seed", "3",
                     "--full_precision", "--cpu", "--quiet"] + list(extra))


def _train_reads(feats, out, resume=False):
    batcher = training.TrainBatcher(
        [feats["reads"]], validation=0.2, seed=3, batch_size=8,
        max_samples=24, max_valid_samples=8)
    return training.run_training(
        out, batcher, model_dict=LSTM, epochs=4, optimizer="nadam",
        optim_args={"learning_rate": 5e-3}, compute_dtype=None, seed=3,
        resume=resume, device="cpu")


@pytest.mark.parametrize("kind", ["counts", "reads"])
def test_kill_and_resume_matches_uninterrupted(feats, tmp_path, monkeypatch,
                                               kind):
    """4 epochs straight against a run killed after epoch 1 and resumed
    (the counts model through the CLI, from an architecture TOML; the
    read-level model, batch norm included, through run_training): the
    training.csv rows of epochs 2-3 and the last checkpoint are
    bit-identical in f32 on the CPU. Three batches an epoch, so the
    clip's buffer and the schedule's count both carry over."""
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    if kind == "counts":
        assert _train_counts(feats, tmp_path, "full") == 0
    else:
        _train_reads(feats, full)
    restore = _kill_after(monkeypatch, 4)
    with pytest.raises(RuntimeError, match="simulated kill"):
        if kind == "counts":
            _train_counts(feats, tmp_path, "part")
        else:
            _train_reads(feats, part)
    restore()
    with open(os.path.join(part, "resume.json")) as fh:
        assert '"epoch": 1' in fh.read()
    if kind == "counts":
        assert _train_counts(feats, tmp_path, "part", ["--resume"]) == 0
    else:
        _train_reads(feats, part, resume=True)
    # every column but the seconds
    rows = {d: [{k: v for k, v in r.items() if k != "time"}
                for r in _csv_rows(os.path.join(d, "training.csv"))
                if int(r["epoch"]) >= 2] for d in (full, part)}
    assert len(rows[full]) == 8 and \
        [r["split"] for r in rows[full]].count("train") == 6
    assert rows[full] == rows[part]
    a = _npz(os.path.join(full, "model-3.tar.gz"))
    b = _npz(os.path.join(part, "model-3.tar.gz"))
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].tobytes() == b[key].tobytes(), key


_OPTIMIZERS = [
    ("nadam", {}, True), ("nadam", {}, False), ("adam", {}, True),
    ("adam", {}, False), ("rmsprop", {"momentum": 0.9}, True),
    ("rmsprop", {"momentum": 0.9}, False), ("sgd", {}, True),
    ("sgd", {}, False)]


def _ids(case):
    name, args, schedule = case
    return "{}{}{}".format(name, "-momentum" if args else "",
                           "-schedule" if schedule else "")


def _batcher(module, path):
    return module.TrainBatcher([path], validation=0.2, seed=3, batch_size=8,
                               max_samples=16, max_valid_samples=8)


def _port_optimizer(name, args, schedule, steps):
    lr = training.cosine_schedule(5e-3, steps) if schedule else 5e-3
    return training.build_optimizer(name, lr, dict(args))


@pytest.mark.parametrize("case", _OPTIMIZERS + [("lstm", {}, True)],
                         ids=_ids)
def test_resume_snapshot_crosses_packages(feats, tmp_path, monkeypatch,
                                          case):
    """medaka_tpu trains 2 epochs; its snapshot after epoch 0 loads in the
    port with every parameter and optimizer leaf equal; the port resumed
    from it logs medaka_tpu's epoch 1 within 1e-4 relative (the bar of
    test_torch_training's runs); the port's own snapshot then passes
    medaka_tpu's _load_resume_state with every leaf equal to the port's
    weights and optimizer state. nadam, adam, rmsprop with momentum and
    sgd, with and without the schedule; and the read-level model, whose
    batch-norm running statistics are pytree leaves in JAX and buffers
    here."""
    name, args, schedule = case
    model_dict, path = (LSTM, feats["reads"]) if name == "lstm" else \
        (GRU, feats["counts"])
    name = "nadam" if name == "lstm" else name
    jmodel = jax_models.model_from_dict(model_dict)
    jparams = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(7)))
    run = dict(model_dict=model_dict, epochs=2, optimizer=name,
               optim_args=dict(args, learning_rate=5e-3), compute_dtype=None,
               seed=3, use_lr_schedule=schedule)
    snap = str(tmp_path / "snap")
    os.makedirs(snap)
    real_save = jax_training._save_resume_state

    def keep_first(train_name, epoch, *rest):
        real_save(train_name, epoch, *rest)
        if epoch == 0:
            for f in ("resume.npz", "resume.json"):
                shutil.copy(os.path.join(train_name, f), snap)
    monkeypatch.setattr(jax_training, "_save_resume_state", keep_first)
    theirs = str(tmp_path / "theirs")
    jax_training.run_training(theirs, _batcher(jax_training, path),
                              initial_params=jparams, **run)

    # the JAX snapshot loads leaf for leaf
    steps = _batcher(training, path).n_batches("train") * 2
    model = models.model_from_dict(model_dict)
    opt = _port_optimizer(name, args, schedule, steps)
    params = list(model.parameters())
    opt.init(params)
    assert training.load_resume_state(snap, model, opt, params) is not None
    leaves = training.param_leaves(model)
    with np.load(os.path.join(snap, "resume.npz")) as z:
        for i, t in enumerate(leaves):
            np.testing.assert_array_equal(t.detach().numpy(), z["p%d" % i])
        o = training.optimizer_leaves(opt, leaves, params)
        assert len(o) == sum(k.startswith("o") for k in z.files)
        for i, a in enumerate(o):
            np.testing.assert_array_equal(a, z["o%d" % i])

    # the port resumes from it
    ours = str(tmp_path / "ours")
    shutil.copytree(snap, ours)
    trained = training.run_training(ours, _batcher(training, path),
                                    resume=True, device="cpu", **run)
    want = [r for r in _csv_rows(os.path.join(theirs, "training.csv"))
            if r["epoch"] == "1"]
    got = _csv_rows(os.path.join(ours, "training.csv"))
    assert [(r["split"], r["batch"]) for r in got] == \
        [(r["split"], r["batch"]) for r in want] and len(got) == 3
    for a, b in zip(got, want):
        rel = abs(float(a["loss"]) - float(b["loss"])) / abs(float(b["loss"]))
        assert rel <= 1e-4, (a, b)

    # the port's snapshot (epoch 1) in medaka_tpu
    jopt = jax_training.build_optimizer(
        name, jax_training.cosine_schedule(5e-3, steps) if schedule
        else None, dict(args, learning_rate=5e-3))
    state = jax_training._load_resume_state(
        ours, jparams, jopt.init(jax.tree_util.tree_map(np.asarray,
                                                        jparams)))
    assert state[0] == 2
    mine_p = [t.detach().numpy() for t in training.param_leaves(trained)]
    for a, b in zip(jax.tree_util.tree_leaves(state[1]), mine_p,
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    with np.load(os.path.join(ours, "resume.npz")) as z:
        for i, a in enumerate(jax.tree_util.tree_leaves(state[2])):
            np.testing.assert_array_equal(np.asarray(a), z["o%d" % i])


def test_mismatched_snapshot_raises(feats, tmp_path):
    """A snapshot of another model (leaf count or shape) does not resume:
    it raises as medaka_tpu's _load_resume_state does."""
    out = str(tmp_path / "run")
    training.run_training(out, _batcher(training, feats["counts"]),
                          model_dict=GRU, epochs=1, compute_dtype=None,
                          device="cpu")
    wider = {"type": "GRUModel", "kwargs": dict(GRU["kwargs"], gru_size=12)}
    with pytest.raises(ValueError, match="cannot resume"):
        training.run_training(out, _batcher(training, feats["counts"]),
                              model_dict=wider, epochs=2, resume=True,
                              compute_dtype=None, device="cpu")
    with pytest.raises(ValueError, match="cannot resume"):
        training.run_training(out, _batcher(training, feats["counts"]),
                              model_dict=GRU, epochs=2, resume=True,
                              optimizer="rmsprop",
                              optim_args={"momentum": 0.5},
                              compute_dtype=None, device="cpu")


# ---------------------------------------------------------------------------
# --validate_only
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", [0.2, 0.0], ids=["split", "all_samples"])
def test_validate_only_matches_medaka_tpu(feats, tmp_path, capsys, split):
    """run_validation of a saved checkpoint equals medaka_tpu's within
    1e-6 (f32) and the port's last validation row in training.csv; with
    no validation split both evaluate every sample. The CLI prints the
    same numbers."""
    out = str(tmp_path / "run")
    training.run_training(out, _batcher(training, feats["counts"]),
                          model_dict=GRU, epochs=1, compute_dtype=None,
                          seed=5, device="cpu")
    ckpt = os.path.join(out, "model-0.tar.gz")

    def batcher(module):
        return module.TrainBatcher([feats["counts"]], validation=split,
                                   seed=3, batch_size=8, max_samples=16,
                                   max_valid_samples=8)
    loss, acc = training.run_validation(batcher(training), ckpt,
                                        compute_dtype=None, device="cpu")
    j_loss, j_acc = jax_training.run_validation(batcher(jax_training), ckpt,
                                                compute_dtype=None)
    assert abs(loss - j_loss) <= 1e-6 and abs(acc - j_acc) <= 1e-6
    if split:
        last = [r for r in _csv_rows(os.path.join(out, "training.csv"))
                if r["split"] == "validation"][-1]
        assert abs(float(last["loss"]) - loss) <= 1e-6
        assert abs(float(last["acc"]) - acc) <= 1e-6
    capsys.readouterr()
    assert cli.main(["train", feats["counts"], "--validate_only", "--model",
                     ckpt, "--validation_split", str(split), "--seed", "3",
                     "--batch_size", "8", "--max_samples", "16",
                     "--max_valid_samples", "8", "--full_precision",
                     "--cpu", "--quiet"]) == 0
    assert capsys.readouterr().out.strip() == \
        "validation loss {!r} accuracy {!r}".format(loss, acc)


def test_validate_only_requires_model(feats, tmp_path):
    with pytest.raises(ValueError, match="requires --model"):
        cli.main(["train", feats["counts"], "--validate_only", "--cpu",
                  "--train_name", str(tmp_path / "x"), "--quiet"])


# ---------------------------------------------------------------------------
# architecture TOML and tools export
# ---------------------------------------------------------------------------


def _bundle(kind):
    torch.manual_seed(2)
    if kind == "gru":
        return models.ModelBundle(models.model_from_dict(GRU),
                                  features.CountsFeatureEncoder(),
                                  labels.HaploidLabelScheme())
    return models.ModelBundle(
        models.model_from_dict(LSTM),
        features.ReadAlignmentFeatureEncoder(max_reads=8),
        labels.HaploidLabelScheme())


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_export_matches_medaka_tpu(tmp_path, kind):
    """tools export writes what medaka_tpu's export writes for the same
    bundle: config.toml documents that tomllib reads the same, and
    weights.pt state dicts with the same keys and equal tensors."""
    bundle = _bundle(kind)
    src = models.save_model(str(tmp_path / "m.tar.gz"), bundle.model,
                            bundle.feature_encoder, bundle.label_scheme)
    assert cli.main(["tools", "export", src, "--output",
                     str(tmp_path / "ours"), "--supported_basecallers",
                     "dna_r10.4.1_e8.2_400bps_sup@v5.0.0"]) == 0
    jax_models.export_model(src, str(tmp_path / "theirs"),
                            supported_basecallers=[
                                "dna_r10.4.1_e8.2_400bps_sup@v5.0.0"])
    docs, states = [], []
    for name in ("ours", "theirs"):
        with tarfile.open(str(tmp_path / (name + ".tar.gz"))) as tar:
            assert sorted(tar.getnames())[-2:] == ["model/config.toml",
                                                   "model/weights.pt"]
            docs.append(tomllib.loads(
                tar.extractfile("model/config.toml").read().decode()))
            states.append(torch.load(tar.extractfile("model/weights.pt"),
                                     weights_only=True))
    assert docs[0] == docs[1]
    assert docs[0]["config_version"] == models.EXPORT_CONFIG_VERSION
    assert states[0].keys() == states[1].keys()
    for key in states[0]:
        assert torch.equal(states[0][key], states[1][key]), key
    again = models.model_from_dict(bundle.model.to_dict())
    again.load_torch_state(states[0])
    for a, b in zip(again.state_dict().values(),
                    bundle.model.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(FileExistsError):
        models.export_model(src, str(tmp_path / "ours"))


def test_train_from_exported_config_toml(feats, tmp_path):
    """The config.toml of tools export trains in both packages (1 epoch,
    a random init from --seed) and both build the exported
    architecture."""
    bundle = _bundle("gru")
    src = models.save_model(str(tmp_path / "m.tar.gz"), bundle.model,
                            bundle.feature_encoder, bundle.label_scheme)
    out = models.export_model(src, str(tmp_path / "exp"))
    with tarfile.open(out) as tar:
        tar.extract("model/config.toml", str(tmp_path), filter="data")
    toml = str(tmp_path / "model" / "config.toml")
    common = ["--batch_size", "8", "--epochs", "1", "--max_samples", "8",
              "--max_valid_samples", "8", "--seed", "1", "--model", toml,
              "--quiet"]
    assert cli.main(["train", feats["counts"], "--train_name",
                     str(tmp_path / "ours"), "--cpu"] + common) == 0
    jax_cli.main(["train", feats["counts"], "--train_name",
                  str(tmp_path / "theirs")] + common)
    ours = models.load_model(str(tmp_path / "ours" / "model-0.tar.gz"))
    theirs = jax_models.load_model(
        str(tmp_path / "theirs" / "model-0.tar.gz"))
    assert ours.model.to_dict() == theirs.model.to_dict() == \
        bundle.model.to_dict()
    assert [a.shape for a in jax.tree_util.tree_leaves(
        ours.model.jax_params())] == [
        a.shape for a in jax.tree_util.tree_leaves(theirs.params)]


def test_toml_without_architecture_raises(feats, tmp_path):
    path = str(tmp_path / "empty.toml")
    with open(path, "w") as fh:
        fh.write("config_version = 3\n")
    args = argparse.Namespace(
        features=[feats["counts"]], validation_features=None,
        validation_split=0.2, seed=0, batch_size=8, max_samples=8,
        max_valid_samples=None, model=path, train_name=str(tmp_path / "t"),
        epochs=1, optimizer="adam", optim_args={}, cpu=True)
    with pytest.raises(ValueError, match="no model architecture"):
        training.train(args)
