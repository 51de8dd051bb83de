"""Model training from labelled feature HDF5 files.

Counterpart of ``medaka_tpu/training.py`` (``medaka_tpu train``) for
counts and read-level feature files, on one device:

- :class:`TrainBatcher` indexes feature files, splits train/validation
  and serves fixed-shape ``{features, labels, mask, lengths}`` batches,
  loaded in a worker thread; read-level batches are int8 (B, T,
  max_reads, C) with the encoder's static ``max_reads``, plus a
  host-side majority-vote ``baseline_pred``;
- :class:`Optimizer` is the optax chain ``medaka_tpu`` builds
  (:func:`clip_by_running_median`, then adam, nadam, rmsprop or sgd with
  the reference's default learning rates, then the learning rate or the
  :func:`cosine_schedule`), written as plain tensor code that equals
  optax step for step: ``optax.nadam`` is Adam with a Nesterov step, not
  ``torch.optim.NAdam``. It updates the model's f32 parameters in place;
- :func:`run_training` trains the counts ``GRUModel`` (default: the
  full-width ``DEFAULT_MODEL_DICT``) or the read-level
  ``LatentSpaceLSTM`` (default: the reference's ``rl_lstm384``
  geometry), writes ``model-{epoch}.tar.gz``,
  ``model-best_val_loss.tar.gz`` and ``model-best_val_acc.tar.gz``
  bundles (loadable by both packages) and ``training.csv``, and stops
  early after 20 epochs without a better validation loss.

Not ported yet, and refused by name: ``--resume``, ``--validate_only``
and ``.toml`` architecture files (the training-options slice, queue 1 of
ROADMAP.md, after the remaining GRU kernels), and ``--model_parallel``
above 1 (the scale-out slice).
"""
from __future__ import annotations

import csv
import math
import os
import queue as queue_mod
import threading
from timeit import default_timer as now
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from medaka_tpu_torch import common, datastore, parallel
from medaka_tpu_torch import models as models_mod

_LATER = ("{} is not ported to medaka_tpu_torch's train yet; it comes "
          "with a later slice of the port ({}).")
_OPTIONS_SLICE = "the training-options slice, after the remaining GRU kernels"


def qscore(acc: float) -> float:
    """Accuracy as a phred-style Q score."""
    return float(-10 * np.log10(max(1e-9, 1.0 - acc)))


# ---------------------------------------------------------------------------
# Optimizers: the optax chains of medaka_tpu, step for step
# ---------------------------------------------------------------------------

_F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=_F32)


def _bias_correction(decay: float, count: int) -> torch.Tensor:
    """``1 - decay ** count`` in f32 (optax ``tree_bias_correction``)."""
    return 1.0 - _f32(decay) ** count


def cosine_schedule(peak_lr: float, total_steps: int,
                    warmup_steps: int = 500) -> Callable[[int], torch.Tensor]:
    """Linear warmup + cosine decay to 0, in f32.

    ``optax.warmup_cosine_decay_schedule`` with the warmup and decay
    lengths of ``medaka_tpu.training.cosine_schedule``.
    """
    warmup_steps = min(warmup_steps, max(1, total_steps // 10))
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps

    def schedule(count: int) -> torch.Tensor:
        if count < warmup_steps:
            frac = 1.0 - _f32(min(max(count, 0), warmup_steps)) / warmup_steps
            return (0.0 - _f32(peak_lr)) * frac + _f32(peak_lr)
        c = torch.minimum(_f32(count - warmup_steps), _f32(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return _f32(peak_lr) * ((1 - 0.0) * cosine + 0.0)

    return schedule


class _RunningMedianClip:
    """Clip the global norm to ``factor`` x the median of recent norms.

    ``clip_by_running_median`` of ``medaka_tpu/training.py``: the ring
    buffer of the last ``buffer_size`` (clipped) norms, no clipping for
    the first ``warmup`` steps.
    """

    def __init__(self, buffer_size: int = 100, factor: float = 2.0,
                 warmup: int = 5):
        self.buffer_size, self.factor, self.warmup = \
            buffer_size, factor, warmup
        self.norms = torch.zeros((buffer_size,), dtype=_F32)
        self.count = 0

    def __call__(self, updates: List[torch.Tensor]) -> List[torch.Tensor]:
        norm = torch.sqrt(sum(torch.sum(u.float() ** 2).cpu()
                              for u in updates)).to(_F32)
        n_valid = min(self.count, self.buffer_size)
        masked = torch.where(torch.arange(self.buffer_size) < n_valid,
                             self.norms, _f32(math.inf))
        med = torch.sort(masked).values[max(0, (n_valid - 1) // 2)]
        limit = self.factor * med
        use_clip = self.count >= self.warmup
        if use_clip and bool(norm > limit) and bool(torch.isfinite(limit)):
            scale = limit / torch.maximum(norm, _f32(1e-12))
        else:
            scale = _f32(1.0)
        out = [u * scale.to(device=u.device, dtype=u.dtype) for u in updates]
        clipped = torch.minimum(norm, limit if use_clip else norm)
        self.norms[self.count % self.buffer_size] = clipped
        self.count += 1
        return out


def clip_by_running_median(buffer_size: int = 100, factor: float = 2.0,
                           warmup: int = 5) -> _RunningMedianClip:
    """The running-median global-norm clip (a callable over the updates)."""
    return _RunningMedianClip(buffer_size, factor, warmup)


class Optimizer:
    """An optax-equivalent chain: [clip ->] optimizer -> learning rate.

    :param name: "adam", "nadam", "rmsprop" or "sgd".
    :param learning_rate: a float or a schedule ``count -> lr``.
    :param clip: prepend :func:`clip_by_running_median`.
    :param kwargs: the optax optimizer's own arguments (adam/nadam: b1,
        b2, eps, eps_root; rmsprop: decay, eps, momentum, nesterov; sgd:
        momentum, nesterov).
    """

    _ARGS = {
        "adam": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0},
        "nadam": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0},
        "rmsprop": {"decay": 0.9, "eps": 1e-8, "momentum": None,
                    "nesterov": False},
        "sgd": {"momentum": None, "nesterov": False},
    }

    def __init__(self, name: str, learning_rate, clip: bool = True,
                 **kwargs):
        if name not in self._ARGS:
            raise ValueError("Unknown optimizer {}".format(name))
        unknown = set(kwargs) - set(self._ARGS[name])
        if unknown:
            raise TypeError("{}() got unexpected arguments {}".format(
                name, sorted(unknown)))
        self.name = name
        self.args = dict(self._ARGS[name], **kwargs)
        self.learning_rate = learning_rate
        self.clip = clip_by_running_median() if clip else None
        self.count = 0      # optimizer and schedule steps taken
        self.state: Optional[Dict[str, List[torch.Tensor]]] = None

    def _init(self, grads):
        zeros = [torch.zeros_like(g, dtype=_F32) for g in grads]
        if self.name in ("adam", "nadam"):
            self.state = {"mu": zeros,
                          "nu": [torch.zeros_like(z) for z in zeros]}
        elif self.name == "rmsprop":
            self.state = {"nu": [torch.zeros_like(z) for z in zeros]}
        else:
            self.state = {}
        if self.args.get("momentum") is not None:
            self.state["trace"] = [torch.zeros_like(z) for z in zeros]

    def _trace(self, updates):
        a = self.args
        decay = a["momentum"]
        new = [g + decay * t for g, t in zip(updates, self.state["trace"])]
        self.state["trace"] = new
        if a["nesterov"]:
            return [g + decay * t for g, t in zip(updates, new)]
        return new

    def update(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The updates (to be added to the parameters) for ``grads``."""
        grads = [g.float() for g in grads]
        if self.state is None:
            self._init(grads)
        if self.clip is not None:
            grads = self.clip(grads)
        a = self.args
        count_inc = self.count + 1
        if self.name in ("adam", "nadam"):
            b1, b2 = a["b1"], a["b2"]
            mu = [(1 - b1) * g + b1 * m
                  for g, m in zip(grads, self.state["mu"])]
            nu = [(1 - b2) * (g ** 2) + b2 * v
                  for g, v in zip(grads, self.state["nu"])]
            self.state["mu"], self.state["nu"] = mu, nu
            bc1 = _bias_correction(b1, count_inc)
            if self.name == "nadam":
                bc1_next = _bias_correction(b1, count_inc + 1)
                mu_hat = [b1 * (m / bc1_next.to(m.device))
                          + (1 - b1) * (g / bc1.to(g.device))
                          for m, g in zip(mu, grads)]
            else:
                mu_hat = [m / bc1.to(m.device) for m in mu]
            bc2 = _bias_correction(b2, count_inc)
            updates = [m / (torch.sqrt(v / bc2.to(v.device) + a["eps_root"])
                            + a["eps"]) for m, v in zip(mu_hat, nu)]
        elif self.name == "rmsprop":
            decay = a["decay"]
            nu = [(1 - decay) * (g ** 2) + decay * v
                  for g, v in zip(grads, self.state["nu"])]
            self.state["nu"] = nu
            updates = [torch.rsqrt(v + a["eps"]) * g
                       for v, g in zip(nu, grads)]
        else:
            updates = grads
            if a["momentum"] is not None:
                updates = self._trace(updates)
        lr = self.learning_rate
        if callable(lr):
            step = (-1 * lr(self.count)).to(_F32)
            updates = [step.to(u.device) * u for u in updates]
        else:
            updates = [-lr * u for u in updates]
        if self.name == "rmsprop" and a["momentum"] is not None:
            updates = self._trace(updates)
        self.count = count_inc
        return updates


#: reference per-optimizer default learning rates (training.py:107-142)
_OPTIMIZERS = {
    "adam": {"learning_rate": 1e-4},
    "nadam": {"learning_rate": 1e-4},
    "rmsprop": {"learning_rate": 1e-3},
    "sgd": {"learning_rate": 1e-3},
}


def build_optimizer(name: str = "nadam", lr_schedule=None,
                    optim_args: Optional[Dict] = None,
                    clip: bool = True) -> Optimizer:
    """The chain clip -> optimizer -> learning rate or schedule."""
    kwargs = dict(_OPTIMIZERS[name])
    if optim_args:
        kwargs.update(optim_args)
    if lr_schedule is not None:
        kwargs["learning_rate"] = lr_schedule
    lr = kwargs.pop("learning_rate")
    return Optimizer(name, lr, clip=clip, **kwargs)


# ---------------------------------------------------------------------------
# Batching from HDF5 sample files
# ---------------------------------------------------------------------------


class TrainBatcher:
    """Index feature files, split train/valid, serve fixed-shape batches."""

    def __init__(self, features: Sequence[str],
                 validation: Union[float, Sequence[str]] = 0.2,
                 seed: int = 0, batch_size: int = 128,
                 max_samples: Optional[int] = None,
                 max_valid_samples: Optional[int] = None):
        """:param features: HDF5 feature file paths.

        :param validation: fraction for validation, or a list of file
            paths to use exclusively for validation.
        """
        self.logger = common.get_named_logger("TrainBatcher")
        self.batch_size = batch_size
        if isinstance(validation, (list, tuple)):
            train_index = datastore.DataIndex(list(features))
            valid_index = datastore.DataIndex(list(validation))
            self.train_samples = list(train_index.samples)
            self.valid_samples = list(valid_index.samples)
            self._index = train_index
        else:
            index = datastore.DataIndex(list(features))
            samples = list(index.samples)
            rng = np.random.default_rng(seed)
            rng.shuffle(samples)
            n_valid = int(len(samples) * validation)
            self.valid_samples = samples[:n_valid]
            self.train_samples = samples[n_valid:]
            self._index = index
        if max_samples is not None:
            self.train_samples = self.train_samples[:max_samples]
        if max_valid_samples is not None:
            self.valid_samples = self.valid_samples[:max_valid_samples]
        if not self.train_samples:
            raise ValueError("No training samples found.")
        self.meta = dict(self._index.metadata)
        first = next(self._index.yield_from_feature_files(
            samples=self.train_samples[:1]))
        self.time_steps = first.features.shape[0]
        self.feat_dim = first.features.shape[-1]
        # read-level feature files hold (positions, reads, channels) int8
        # tensors; batches get a static reads dimension, the encoder's
        # max_reads cap, as medaka_tpu's do (one shape a run)
        self.is_read_level = first.features.ndim == 3
        if self.is_read_level:
            fenc = self.meta.get("feature_encoder")
            self.max_reads = int(getattr(fenc, "max_reads", 0)
                                 or first.features.shape[1])
            self.logger.info(
                "%d train / %d valid read-level samples of shape "
                "(%d, <=%d, %d).", len(self.train_samples),
                len(self.valid_samples), self.time_steps, self.max_reads,
                self.feat_dim)
        else:
            self.max_reads = None
            self.logger.info(
                "%d train / %d valid samples of shape (%d, %d).",
                len(self.train_samples), len(self.valid_samples),
                self.time_steps, self.feat_dim)

    def _load(self, sample_names) -> Dict[str, np.ndarray]:
        if self.is_read_level:
            feats = np.zeros((self.batch_size, self.time_steps,
                              self.max_reads, self.feat_dim), np.int8)
            baseline = np.zeros((self.batch_size, self.time_steps), np.int32)
        else:
            feats = np.zeros(
                (self.batch_size, self.time_steps, self.feat_dim),
                np.float32)
            baseline = None
        labels = np.zeros((self.batch_size, self.time_steps), np.int32)
        mask = np.zeros((self.batch_size, self.time_steps), np.float32)
        lengths = np.zeros((self.batch_size,), np.int32)
        for i, sample in enumerate(self._index.yield_from_feature_files(
                samples=sample_names)):
            n = min(sample.features.shape[0], self.time_steps)
            if self.is_read_level:
                r = min(sample.features.shape[1], self.max_reads)
                feats[i, :n, :r] = sample.features[:n, :r]
                # the majority-vote baseline, here in the loader thread:
                # counts_matrix needs the (major, minor) positions, which
                # do not ride into the device batch
                baseline[i, :n] = np.argmax(
                    sample.majority_vote_probs[:n], axis=-1)
            else:
                feats[i, :n] = sample.features[:n]
            labels[i, :n] = np.asarray(sample.labels[:n]).reshape(n)
            mask[i, :n] = 1.0
            lengths[i] = n
        out = {"features": feats, "labels": labels, "mask": mask,
               "lengths": lengths}
        if baseline is not None:
            out["baseline_pred"] = baseline
        return out

    def batches(self, split: str = "train", shuffle: bool = True,
                seed: int = 0, prefetch: int = 4):
        """Yield batch dicts for an epoch, loading in a worker thread."""
        names = list(
            self.train_samples if split == "train" else self.valid_samples)
        if shuffle:
            np.random.default_rng(seed).shuffle(names)
        groups = [
            names[i:i + self.batch_size]
            for i in range(0, len(names), self.batch_size)]
        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=prefetch)
        stop = threading.Event()
        error = []

        def worker():
            try:
                for g in groups:
                    if stop.is_set():
                        return
                    batch = self._load(g)
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.2)
                            break
                        except queue_mod.Full:
                            continue
            except Exception as e:
                # surface IO errors to the consumer: a silently truncated
                # epoch would train on partial data
                error.append(e)
            finally:
                while True:  # the sentinel must land even when q is full
                    try:
                        q.put(None, timeout=0.2)
                        break
                    except queue_mod.Full:
                        if stop.is_set():
                            break

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            # an abandoned generator must not leak a blocked loader thread
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue_mod.Empty:
                    break
            t.join(timeout=10)
        if error:
            raise error[0]

    def n_batches(self, split: str = "train") -> int:
        """Batches per epoch."""
        n = len(self.train_samples if split == "train"
                else self.valid_samples)
        return int(np.ceil(n / self.batch_size))


class CSVLogger:
    """Append-only CSV metrics log."""

    def __init__(self, path: str):
        self.path = path
        self._fieldnames: Optional[List[str]] = None
        self._fh = None

    def append(self, row: Dict):
        """Write one row (the first row fixes the columns)."""
        if self._fh is None:
            self._fieldnames = list(row.keys())
            exists = os.path.exists(self.path)
            self._fh = open(self.path, "a", newline="")
            self._writer = csv.DictWriter(
                self._fh, fieldnames=self._fieldnames)
            if not exists:
                self._writer.writeheader()
        self._writer.writerow(row)
        self._fh.flush()

    def close(self):
        """Close the file."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------


def run_epoch(step_fn, batcher, split, epoch, logger, csv_logger=None,
              is_training=True, eval_fn=None, max_batches=None,
              device="cuda"):
    """One pass over a split; returns (mean loss, accuracy).

    :param max_batches: truncate the epoch after this many batches
        (``--samples_per_training_epoch``).
    """
    total_loss, total_correct, total_count, n_batches = 0.0, 0.0, 0.0, 0
    base_correct = 0.0
    is_counts = batcher.feat_dim == 10 and not batcher.is_read_level
    has_baseline = is_counts or batcher.is_read_level
    t0 = now()
    for batch in batcher.batches(split, shuffle=is_training, seed=epoch):
        if max_batches is not None and n_batches >= max_batches:
            break
        # the read-level majority argmax, computed by the loader thread,
        # stays on the host
        host_baseline = batch.pop("baseline_pred", None)
        tbatch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        if is_training:
            loss, n_c, n_t = step_fn(tbatch)
        else:
            loss, n_c, n_t = eval_fn(tbatch)
        row = {
            "split": split, "epoch": epoch, "batch": n_batches + 1,
            "loss": float(loss),
            "acc": float(n_c) / max(1.0, float(n_t)),
            "time": now() - t0}
        if is_counts:
            # argmax-of-counts reference point
            b_c, _b_t = parallel.majority_baseline_accuracy(tbatch)
            base_correct += float(b_c)
            row["baseline_acc"] = float(b_c) / max(1.0, float(n_t))
        elif host_baseline is not None:
            b_c = float(np.sum(
                (host_baseline == batch["labels"]) * batch["mask"]))
            base_correct += b_c
            row["baseline_acc"] = b_c / max(1.0, float(n_t))
        total_loss += float(loss)
        total_correct += float(n_c)
        total_count += float(n_t)
        n_batches += 1
        if csv_logger is not None:
            csv_logger.append(row)
    acc = total_correct / max(1.0, total_count)
    mean_loss = total_loss / max(1, n_batches)
    if has_baseline:
        base_acc = base_correct / max(1.0, total_count)
        logger.info(
            "[%s] epoch %d: loss %.4f acc %.4f (Q%.1f; baseline %.4f "
            "Q%.1f) in %.1fs", split, epoch, mean_loss, acc,
            qscore(acc), base_acc, qscore(base_acc), now() - t0)
    else:
        logger.info(
            "[%s] epoch %d: loss %.4f acc %.4f (Q%.1f) in %.1fs",
            split, epoch, mean_loss, acc, qscore(acc), now() - t0)
    return mean_loss, acc


def run_training(
        train_name: str, batcher: TrainBatcher,
        model_dict: Optional[Dict] = None, epochs: int = 10,
        optimizer: str = "nadam", optim_args: Optional[Dict] = None,
        compute_dtype=torch.bfloat16, seed: int = 0,
        early_stop_epochs: int = 20, initial_params=None,
        samples_per_epoch: Optional[int] = None,
        use_lr_schedule: bool = True, class_weights=None, device=None):
    """Train a consensus model.

    :param train_name: output directory.
    :param batcher: a :class:`TrainBatcher`.
    :param model_dict: {type, kwargs} architecture (default: for
        read-level files the reference's ``rl_lstm384`` geometry, a
        ``LatentSpaceLSTM`` with lstm_size 384 and dwells following the
        encoder; else ``DEFAULT_MODEL_DICT`` at the batcher's feature
        width).
    :param compute_dtype: torch.bfloat16 (the kernels on the GPU) or None
        (float32 throughout).
    :param initial_params: warm-start weights as a JAX-layout pytree
        (e.g. a bundle's); a random init from ``seed`` when None.
    :param samples_per_epoch: truncate each training epoch at this many
        samples.
    :param use_lr_schedule: warmup + cosine when True, constant learning
        rate otherwise.
    :param device: "cuda" (default) or "cpu".
    :returns: the trained model.
    """
    logger = common.get_named_logger("Training")
    device = common.resolve_device(device)
    os.makedirs(train_name, exist_ok=True)

    feature_encoder = batcher.meta.get("feature_encoder")
    label_scheme = batcher.meta.get("label_scheme")
    if model_dict is None:
        if batcher.is_read_level:
            # the reference's rl_lstm384 geometry (its options.py:175-182,
            # latent_space_lstm.py:47-59), the dwell channel following the
            # encoder
            use_dwells = bool(getattr(
                feature_encoder, "include_dwells", batcher.feat_dim >= 5))
            model_dict = {
                "type": "LatentSpaceLSTM",
                "kwargs": {"lstm_size": 384, "use_dwells": use_dwells}}
        else:
            model_dict = dict(models_mod.DEFAULT_MODEL_DICT)
            model_dict["kwargs"] = dict(model_dict["kwargs"])
            model_dict["kwargs"]["num_features"] = batcher.feat_dim
    # the random init draws from a generator of its own, seeded
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = models_mod.model_from_dict(model_dict)
    kind = getattr(model, "input_kind", "counts")
    if batcher.is_read_level != (kind == "reads"):
        raise ValueError(
            "Model {} expects {} features but the feature files hold {} "
            "ones.".format(type(model).__name__, kind,
                           "read-level" if batcher.is_read_level
                           else "counts"))
    if initial_params is not None:
        model.load_jax_params(initial_params)
        logger.info("Warm-starting from provided checkpoint params.")
    model.to(device)

    max_batches = None
    steps_per_epoch = batcher.n_batches("train")
    if samples_per_epoch is not None:
        max_batches = max(1, samples_per_epoch // batcher.batch_size)
        steps_per_epoch = min(steps_per_epoch, max_batches)
    peak_lr = (
        _OPTIMIZERS[optimizer]["learning_rate"]
        if not (optim_args or {}).get("learning_rate")
        else optim_args["learning_rate"])
    schedule = cosine_schedule(
        peak_lr, total_steps=epochs * steps_per_epoch) \
        if use_lr_schedule else peak_lr
    opt = build_optimizer(optimizer, schedule, optim_args)
    step_fn = parallel.make_train_step(
        model, opt, compute_dtype=compute_dtype, class_weights=class_weights)

    def eval_fn(batch):
        with torch.inference_mode(), parallel.deterministic_convolutions():
            loss, (n_c, n_t) = parallel.cross_entropy_loss(
                model, batch, compute_dtype=compute_dtype, training=False)
        return loss, n_c, n_t

    csv_logger = CSVLogger(os.path.join(train_name, "training.csv"))
    best = {"val_loss": np.inf, "val_acc": -np.inf}
    best_epoch = 0

    def save(name):
        return models_mod.save_model(
            os.path.join(train_name, name + ".tar.gz"), model,
            feature_encoder=feature_encoder, label_scheme=label_scheme)

    try:
        for epoch in range(epochs):
            run_epoch(step_fn, batcher, "train", epoch, logger, csv_logger,
                      is_training=True, max_batches=max_batches,
                      device=device)
            save("model-{}".format(epoch))
            if not batcher.valid_samples:
                continue
            val_loss, val_acc = run_epoch(
                step_fn, batcher, "validation", epoch, logger, csv_logger,
                is_training=False, eval_fn=eval_fn, device=device)
            if val_loss < best["val_loss"]:
                best["val_loss"] = val_loss
                best_epoch = epoch
                save("model-best_val_loss")
            if val_acc > best["val_acc"]:
                best["val_acc"] = val_acc
                save("model-best_val_acc")
            if epoch - best_epoch >= early_stop_epochs:
                logger.info(
                    "Early stop: no val-loss improvement in %d epochs.",
                    early_stop_epochs)
                break
    finally:
        csv_logger.close()
    return model


def train(args):
    """CLI entry point for ``medaka_tpu_torch train``."""
    if getattr(args, "resume", False):
        raise NotImplementedError(_LATER.format(
            "--resume", "resume snapshots of parameters and optimizer "
            "state: " + _OPTIONS_SLICE))
    if getattr(args, "validate_only", False):
        raise NotImplementedError(_LATER.format(
            "--validate_only", "checkpoint validation: " + _OPTIONS_SLICE))
    if getattr(args, "model_parallel", 1) > 1:
        raise NotImplementedError(_LATER.format(
            "--model_parallel > 1", "scale-out: the model mesh axis"))
    if getattr(args, "model", None) and args.model.endswith(".toml"):
        raise NotImplementedError(_LATER.format(
            ".toml architecture files", "architecture files: "
            + _OPTIONS_SLICE))
    # bf16 mixed precision is the default; --full_precision / --no-amp
    # force float32
    amp = getattr(args, "amp", None)
    full_precision = getattr(args, "full_precision", False)
    if amp is True and full_precision:
        raise ValueError(
            "--amp and --full_precision are mutually exclusive.")
    compute_dtype = (None if (full_precision or amp is False)
                     else torch.bfloat16)
    device = "cpu" if getattr(args, "cpu", False) else "cuda"
    common.resolve_device(device)
    batcher = TrainBatcher(
        args.features, validation=args.validation_features
        or args.validation_split, seed=args.seed,
        batch_size=args.batch_size, max_samples=args.max_samples,
        max_valid_samples=args.max_valid_samples)
    model_dict = None
    initial_params = None
    if getattr(args, "model", None):
        bundle = models_mod.open_model(args.model)
        model_dict = bundle.model.to_dict()
        initial_params = bundle.model.jax_params()
    return run_training(
        args.train_name, batcher, model_dict=model_dict,
        epochs=args.epochs, optimizer=args.optimizer,
        optim_args=args.optim_args, seed=args.seed,
        initial_params=initial_params,
        samples_per_epoch=getattr(args, "samples_per_training_epoch", None),
        use_lr_schedule=getattr(args, "use_lr_schedule", True),
        compute_dtype=compute_dtype, device=device)
