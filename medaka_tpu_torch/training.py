"""Model training from labelled feature HDF5 files.

Counterpart of ``medaka_tpu/training.py`` (``medaka_tpu train``) for
counts and read-level feature files:

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
  early after 20 epochs without a better validation loss. After every
  epoch it writes a resume snapshot, ``resume.npz`` + ``resume.json``, in
  ``medaka_tpu``'s layout, from which ``resume=True`` continues a killed
  run bit for bit; a snapshot of either package resumes in the other;
- :func:`run_validation` evaluates a checkpoint (``--validate_only``);
- :func:`train`, the CLI entry, also takes an architecture TOML as
  ``--model`` (a random init from ``--seed``).

Every run goes through the mesh of :func:`training_mesh`: one rank in
this process, or spawned ranks over several GPUs (or several ranks on one
GPU, or on the CPU), with ``--model_parallel`` ranks on the model axis.
"""
from __future__ import annotations

import csv
import json
import logging
import math
import os
import queue as queue_mod
import threading
import time
from timeit import default_timer as now
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from medaka_tpu_torch import common, datastore, parallel
from medaka_tpu_torch import models as models_mod


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
        #: under a model axis, sums each cut leaf's squares over the model
        #: group (``parallel.make_train_step``), so the norm is the whole
        #: gradient's
        self.reduce_squares: Optional[Callable] = None

    def __call__(self, updates: List[torch.Tensor]) -> List[torch.Tensor]:
        squares = [torch.sum(u.float() ** 2).cpu() for u in updates]
        if self.reduce_squares is not None:
            squares = self.reduce_squares(squares)
        norm = torch.sqrt(sum(squares)).to(_F32)
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

    def state_dict(self) -> Dict:
        """{"count", "norms"}: optax's clip state."""
        return {"count": self.count, "norms": self.norms.clone()}

    def load_state_dict(self, state: Dict):
        """Set the state :meth:`state_dict` returns."""
        norms = torch.as_tensor(state["norms"], dtype=_F32).cpu()
        if norms.shape != self.norms.shape:
            raise ValueError("clip state holds {} norms, not {}".format(
                tuple(norms.shape), tuple(self.norms.shape)))
        self.norms = norms.clone()
        self.count = int(state["count"])


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

    def slots(self) -> List[str]:
        """The names of this optimizer's per-parameter state lists, in
        the order optax's chain holds them ("mu", "nu", "trace")."""
        return {"adam": ["mu", "nu"], "nadam": ["mu", "nu"],
                "rmsprop": ["nu"], "sgd": []}[self.name] + (
            ["trace"] if self.args.get("momentum") is not None else [])

    def init(self, params: Sequence[torch.Tensor]):
        """Zero state for ``params`` (as ``optax``'s ``init``)."""
        self._init([p.detach() for p in params])

    def state_dict(self) -> Dict:
        """{"count", "clip": clip state or None, and each of
        :meth:`slots`: one f32 tensor a parameter}."""
        if self.state is None:
            raise ValueError("the optimizer has no state yet; call init")
        return {"count": self.count,
                "clip": self.clip.state_dict() if self.clip else None,
                **{k: [t.clone() for t in self.state[k]]
                   for k in self.slots()}}

    def load_state_dict(self, state: Dict):
        """Set the state :meth:`state_dict` returns (tensors keep the
        device and shape of the current state; call :meth:`init`
        first)."""
        if self.state is None:
            raise ValueError("the optimizer has no state yet; call init")
        for k in self.slots():
            new = []
            for old, value in zip(self.state[k], state[k], strict=True):
                value = torch.as_tensor(value, dtype=_F32)
                if value.shape != old.shape:
                    raise ValueError("optimizer {} state of shape {} for a "
                                     "parameter of shape {}".format(
                                         k, tuple(value.shape),
                                         tuple(old.shape)))
                new.append(value.to(old.device))
            self.state[k] = new
        if self.clip is not None:
            self.clip.load_state_dict(state["clip"])
        self.count = int(state["count"])

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

    def __getstate__(self):
        # a named logger does not pickle (spawned training ranks get the
        # batcher); it is made again on the other side
        return {k: v for k, v in self.__dict__.items() if k != "logger"}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.logger = common.get_named_logger("TrainBatcher")

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
# Resume snapshots, in medaka_tpu's layout
# ---------------------------------------------------------------------------


def _tree_paths(tree, prefix=()):
    """Leaf paths of a nested dict/list pytree in ``jax.tree_util``'s
    flatten order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _tree_paths(v, prefix + (i,))]
    return [prefix]


def param_leaves(model) -> List[torch.Tensor]:
    """The model's tensors (parameters, and batch norm's running
    statistics, which are buffers here) in the flatten order of the JAX
    parameter pytree ``model.jax_params()``."""
    state = model.state_dict(keep_vars=True)
    # GRUModel's head is an nn.Linear; the pytree names it w and b
    alias = {"linear.w": "linear.weight", "linear.b": "linear.bias"} \
        if "linear.weight" in state else {}
    leaves = []
    for path in _tree_paths(model.jax_params()):
        key = ".".join(map(str, path))
        leaves.append(state[alias.get(key, key)])
    return leaves


def _chain_layout(opt: Optimizer) -> List[str]:
    """The parts of the optax chain state of ``opt``, in ``jax.tree_util``
    flatten order: the clip's "clip.count" and "clip.norms"; adam's and
    nadam's "count", "mu" and "nu" (rmsprop's "nu"; sgd's momentum
    "trace"); the schedule's "schedule.count" when the rate is a
    schedule; rmsprop's momentum "trace". "mu", "nu" and "trace" stand
    for one leaf a parameter leaf."""
    slots = opt.slots()
    out = ["clip.count", "clip.norms"] if opt.clip is not None else []
    if opt.name in ("adam", "nadam"):
        out += ["count", "mu", "nu"]
    elif opt.name == "rmsprop":
        out += ["nu"]
    elif "trace" in slots:
        out += ["trace"]
    if callable(opt.learning_rate):
        out.append("schedule.count")
    if opt.name == "rmsprop" and "trace" in slots:
        out.append("trace")
    return out


def optimizer_leaves(opt: Optimizer, leaves: Sequence[torch.Tensor],
                     params: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """``opt``'s state as the leaves of the optax chain state, in the
    order of :func:`_chain_layout`. ``leaves`` are the pytree's tensors
    (:func:`param_leaves`), ``params`` the list the optimizer's state
    follows; a leaf outside it (a running statistic) has zero state, as
    its gradient is zero in JAX."""
    state = opt.state_dict()
    index = {id(p): i for i, p in enumerate(params)}
    scalars = {"count": state["count"], "schedule.count": state["count"]}
    if state["clip"] is not None:
        scalars["clip.count"] = state["clip"]["count"]
    out = []
    for part in _chain_layout(opt):
        if part == "clip.norms":
            out.append(state["clip"]["norms"].cpu().numpy())
        elif part in scalars:
            out.append(np.asarray(scalars[part], np.int32))
        else:
            out += [state[part][index[id(t)]].cpu().numpy()
                    if id(t) in index else np.zeros(tuple(t.shape), np.float32)
                    for t in leaves]
    return out


def load_optimizer_leaves(opt: Optimizer, arrays: Sequence[np.ndarray],
                          leaves: Sequence[torch.Tensor],
                          params: Sequence[torch.Tensor]):
    """Inverse of :func:`optimizer_leaves`: set ``opt``'s state (after
    its ``init``) from the optax leaves; raises when their number does
    not match this optimizer and model."""
    layout = _chain_layout(opt)
    expected = sum(len(leaves) if part in ("mu", "nu", "trace") else 1
                   for part in layout)
    if len(arrays) != expected:
        raise ValueError(
            "Resume state has {} optimizer leaves but the current model/"
            "optimizer expects {}; cannot resume.".format(len(arrays),
                                                          expected))
    state = opt.state_dict()
    index = {id(p): i for i, p in enumerate(params)}
    arrays = iter(arrays)
    counts = {}
    for part in layout:
        if part in ("mu", "nu", "trace"):
            for t in leaves:
                value = next(arrays)
                if id(t) in index:
                    state[part][index[id(t)]] = value
        elif part == "clip.norms":
            state["clip"]["norms"] = next(arrays)
        else:
            counts[part] = int(next(arrays))
    if "clip.count" in counts:
        state["clip"]["count"] = counts["clip.count"]
    # the optimizer's steps: its own count, the schedule's, or (when the
    # chain holds neither) the clip's
    state["count"] = counts.get("count", counts.get(
        "schedule.count", counts.get("clip.count", state["count"])))
    opt.load_state_dict(state)


def _atomic_write(path: str, write):
    tmp = os.path.join(os.path.dirname(path),
                       "." + os.path.basename(path) + ".tmp")
    with open(tmp, "wb") as fh:
        write(fh)
    os.replace(tmp, path)


def save_resume_state(train_name: str, epoch: int, model, opt: Optimizer,
                      params, best: Dict, best_epoch: int):
    """Write ``resume.npz`` (``p{i}``: the JAX parameter pytree's leaves,
    ``o{i}``: the optax state's leaves, both in flatten order) and
    ``resume.json`` (epoch, best validation loss and accuracy, best
    epoch, leaf counts), each atomically, as ``medaka_tpu.training.
    _save_resume_state`` does."""
    leaves = param_leaves(model)
    arrays = {"p{}".format(i): t.detach().cpu().numpy()
              for i, t in enumerate(leaves)}
    o_leaves = optimizer_leaves(opt, leaves, params)
    arrays.update({"o{}".format(i): a for i, a in enumerate(o_leaves)})
    _atomic_write(os.path.join(train_name, "resume.npz"),
                  lambda fh: np.savez(fh, **arrays))
    meta = {"epoch": epoch, "best_val_loss": float(best["val_loss"]),
            "best_val_acc": float(best["val_acc"]), "best_epoch": best_epoch,
            "n_param_leaves": len(leaves), "n_opt_leaves": len(o_leaves)}
    _atomic_write(os.path.join(train_name, "resume.json"),
                  lambda fh: fh.write(json.dumps(meta).encode()))


def load_resume_state(train_name: str, model, opt: Optimizer, params):
    """Load a snapshot of :func:`save_resume_state` (or of
    ``medaka_tpu``) into ``model`` and ``opt`` (after its ``init``).

    :returns: (next epoch, best dict, best epoch), or None when there is
        no snapshot.
    :raises ValueError: when the snapshot's leaf counts or shapes do not
        match the model and optimizer.
    """
    meta_path = os.path.join(train_name, "resume.json")
    npz_path = os.path.join(train_name, "resume.npz")
    if not (os.path.exists(meta_path) and os.path.exists(npz_path)):
        return None
    with open(meta_path) as fh:
        meta = json.load(fh)
    leaves = param_leaves(model)
    if meta["n_param_leaves"] != len(leaves):
        raise ValueError(
            "Resume state has {} p leaves but the current model/optimizer "
            "expects {}; cannot resume.".format(meta["n_param_leaves"],
                                                len(leaves)))
    with np.load(npz_path) as data:
        p_arrays = [data["p{}".format(i)] for i in range(len(leaves))]
        o_arrays = [data["o{}".format(i)]
                    for i in range(meta["n_opt_leaves"])]
    for t, value in zip(leaves, p_arrays):
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError("Resume state leaf of shape {} for a "
                             "parameter of shape {}; cannot resume.".format(
                                 value.shape, tuple(t.shape)))
    load_optimizer_leaves(opt, o_arrays, leaves, params)
    with torch.no_grad():
        for t, value in zip(leaves, p_arrays):
            t.copy_(torch.from_numpy(np.asarray(value)).to(t.device,
                                                           t.dtype))
    best = {"val_loss": meta["best_val_loss"],
            "val_acc": meta["best_val_acc"]}
    return meta["epoch"] + 1, best, meta["best_epoch"]


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------


def run_epoch(step_fn, batcher, split, epoch, logger, csv_logger=None,
              is_training=True, eval_fn=None, max_batches=None,
              device="cuda", mesh: Optional[parallel.Mesh] = None):
    """One pass over a split; returns (mean loss, accuracy).

    :param max_batches: truncate the epoch after this many batches
        (``--samples_per_training_epoch``).
    :param mesh: the ranks: every rank draws the same global batches and
        takes its data rank's rows (``Mesh.rows``); the step gives the
        global loss and counts.
    """
    total_loss, total_correct, total_count, n_batches = 0.0, 0.0, 0.0, 0
    base_correct = 0.0
    is_counts = batcher.feat_dim == 10 and not batcher.is_read_level
    has_baseline = is_counts or batcher.is_read_level
    rows = mesh.rows(batcher.batch_size) if mesh is not None and \
        mesh.data > 1 else slice(None)
    t0 = now()
    for batch in batcher.batches(split, shuffle=is_training, seed=epoch):
        if max_batches is not None and n_batches >= max_batches:
            break
        # the read-level majority argmax, computed by the loader thread
        # over the global batch, stays on the host
        host_baseline = batch.pop("baseline_pred", None)
        tbatch = {k: torch.from_numpy(v[rows]).to(device)
                  for k, v in batch.items()}
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
            b_c, _b_t = parallel.majority_baseline_accuracy(tbatch, mesh)
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


def training_mesh(batch_size: int, devices, model_parallel: int = 1
                  ) -> parallel.Mesh:
    """The mesh of a training run (``medaka_tpu``'s rule): ``data =
    gcd(batch_size, devices // model_parallel)`` ranks on the data axis,
    each with ``model_parallel`` ranks on the model axis, over the first
    ``data * model_parallel`` devices. Raises as ``make_mesh`` does
    where the devices are too few for the model axis."""
    data = math.gcd(batch_size, len(devices) // model_parallel)
    return parallel.Mesh(devices[:data * model_parallel], data=data,
                         model=model_parallel)


def run_training(
        train_name: str, batcher: TrainBatcher,
        model_dict: Optional[Dict] = None, epochs: int = 10,
        optimizer: str = "nadam", optim_args: Optional[Dict] = None,
        compute_dtype=torch.bfloat16, seed: int = 0,
        early_stop_epochs: int = 20, initial_params=None,
        resume: bool = False, samples_per_epoch: Optional[int] = None,
        use_lr_schedule: bool = True, class_weights=None, device=None,
        devices: Optional[Sequence] = None, model_parallel: int = 1,
        timeout_s: float = parallel.DEFAULT_TIMEOUT_S):
    """Train a consensus model, data-parallel over ``devices``.

    One rank a device of :func:`training_mesh`. One rank runs in this
    process, in a process group of one (nccl on a GPU, gloo on the CPU);
    more are spawned processes (``torch.multiprocessing``, spawn) that
    meet over a ``FileStore`` in ``train_name``. Every rank draws the
    same global batches and takes its rows; loss, gradients, counts and
    batch-norm statistics are global (:mod:`medaka_tpu_torch.parallel`),
    so the run's numbers do not depend on the mesh. Rank 0 alone writes
    ``training.csv``, the checkpoints and the resume snapshot (whole
    weights, whatever the mesh); each spawned rank also writes
    ``rank{r}.json`` (its device, backend and kernel launches). A rank
    that raises or dies makes this raise; every collective waits at most
    ``timeout_s``.

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
    :param resume: continue from ``train_name``'s resume snapshot (the
        epoch after it, its best validation numbers, the weights and
        optimizer state), when there is one.
    :param samples_per_epoch: truncate each training epoch at this many
        samples.
    :param use_lr_schedule: warmup + cosine when True, constant learning
        rate otherwise.
    :param device: "cuda" (every visible GPU, the default), "cuda:i" or
        "cpu", when ``devices`` is None.
    :param devices: the devices, one a rank (a list may repeat a device:
        two ranks on one GPU).
    :param model_parallel: ranks on the model axis (the recurrent weights
        cut by gate rows; the scan instead of the kernels).
    :returns: the trained model (with more than one rank, its last
        checkpoint).
    """
    devices = parallel.resolve_devices(devices, device)
    mesh = training_mesh(batcher.batch_size, devices, model_parallel)
    os.makedirs(train_name, exist_ok=True)
    if model_dict is None:
        model_dict = default_model_dict(batcher)
    config = dict(
        train_name=train_name, model_dict=model_dict, epochs=epochs,
        optimizer=optimizer, optim_args=optim_args,
        compute_dtype=compute_dtype, seed=seed,
        early_stop_epochs=early_stop_epochs, initial_params=initial_params,
        resume=resume, samples_per_epoch=samples_per_epoch,
        use_lr_schedule=use_lr_schedule, class_weights=class_weights)
    common.get_named_logger("Training").info(
        "Training over a %dx%d (data x model) mesh on %s.", mesh.data,
        mesh.model, ", ".join(map(str, mesh.devices)))
    if mesh.size == 1:
        import torch.distributed as dist
        with parallel.process_group(mesh, 0, dist.HashStore(), timeout_s):
            return _train_rank(mesh, batcher, **config)
    store = os.path.join(train_name, ".rendezvous-{}-{}".format(
        os.getpid(), time.time_ns()))
    context = torch.multiprocessing.start_processes(
        _rank_main, args=(mesh, batcher, config, store, timeout_s,
                          logging.getLogger().getEffectiveLevel()),
        nprocs=mesh.size, join=False, start_method="spawn")
    try:
        while not context.join(timeout=1.0):
            pass
    except Exception as e:
        raise RuntimeError("a training rank failed: {}".format(e)) from e
    finally:
        for process in context.processes:
            if process.is_alive():
                process.terminate()
        if os.path.exists(store):
            os.remove(store)
    with open(os.path.join(train_name, "resume.json")) as fh:
        last = json.load(fh)["epoch"]
    return models_mod.load_model(
        os.path.join(train_name, "model-{}.tar.gz".format(last))).model


def default_model_dict(batcher: TrainBatcher) -> Dict:
    """The architecture ``train`` builds without ``--model``: for
    read-level files the reference's ``rl_lstm384`` geometry (its
    options.py:175-182, latent_space_lstm.py:47-59), the dwell channel
    following the encoder; else ``DEFAULT_MODEL_DICT`` at the batcher's
    feature width."""
    if batcher.is_read_level:
        feature_encoder = batcher.meta.get("feature_encoder")
        use_dwells = bool(getattr(
            feature_encoder, "include_dwells", batcher.feat_dim >= 5))
        return {"type": "LatentSpaceLSTM",
                "kwargs": {"lstm_size": 384, "use_dwells": use_dwells}}
    model_dict = dict(models_mod.DEFAULT_MODEL_DICT)
    model_dict["kwargs"] = dict(model_dict["kwargs"])
    model_dict["kwargs"]["num_features"] = batcher.feat_dim
    return model_dict


def _rank_main(rank, mesh, batcher, config, store, timeout_s, log_level):
    """A spawned rank: join the group, train, write ``rank{r}.json``."""
    import torch.distributed as dist

    from medaka_tpu_torch.ops import gru_train, lstm_train
    logging.basicConfig(
        level=log_level if rank == 0 else max(log_level, logging.WARNING),
        format="[%(asctime)s - %(name)s] rank {}: %(message)s".format(rank),
        datefmt="%H:%M:%S")
    if mesh.devices[rank].type == "cpu":
        # the CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    with parallel.process_group(mesh, rank, dist.FileStore(store, mesh.size),
                                timeout_s):
        _train_rank(mesh, batcher, **config)
        report = {"rank": rank, "data_rank": mesh.data_rank,
                  "model_rank": mesh.model_rank, "device": str(mesh.device),
                  "backend": dist.get_backend(), "world": mesh.size,
                  "launches": {**gru_train.LAUNCHES, **lstm_train.LAUNCHES}}
    _atomic_write(os.path.join(config["train_name"],
                               "rank{}.json".format(rank)),
                  lambda fh: fh.write(json.dumps(report).encode()))


def _train_rank(mesh, batcher, train_name, model_dict, epochs, optimizer,
                optim_args, compute_dtype, seed, early_stop_epochs,
                initial_params, resume, samples_per_epoch, use_lr_schedule,
                class_weights):
    """This rank's part of :func:`run_training`; returns its model."""
    logger = common.get_named_logger("Training")
    device = mesh.device
    lead = mesh.rank == 0
    feature_encoder = batcher.meta.get("feature_encoder")
    label_scheme = batcher.meta.get("label_scheme")
    # the random init draws from a generator of its own, seeded
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = models_mod.model_from_dict(model_dict)
    _check_features(model, batcher)
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
    params = list(model.parameters())
    opt.init(params)

    best = {"val_loss": np.inf, "val_acc": -np.inf}
    best_epoch = 0
    first_epoch = 0
    if resume:
        # a snapshot holds whole weights: it loads before the model axis
        # cuts them
        state = load_resume_state(train_name, model, opt, params)
        if state is None:
            logger.info("No resume state in %s; training from scratch.",
                        train_name)
        else:
            first_epoch, best, best_epoch = state
            logger.info("Resuming from epoch %d.", first_epoch)
    parallel.shard_model(model, mesh, opt)
    step_fn = parallel.make_train_step(
        model, opt, compute_dtype=compute_dtype, class_weights=class_weights,
        mesh=mesh)
    eval_fn = make_eval_fn(model, compute_dtype, mesh)
    csv_logger = CSVLogger(os.path.join(train_name, "training.csv")) \
        if lead else None

    def save(name):
        with parallel.unsharded(model, mesh):
            if lead:
                models_mod.save_model(
                    os.path.join(train_name, name + ".tar.gz"), model,
                    feature_encoder=feature_encoder,
                    label_scheme=label_scheme)

    def snapshot(epoch):
        with parallel.unsharded(model, mesh, opt):
            if lead:
                save_resume_state(train_name, epoch, model, opt, params,
                                  best, best_epoch)

    epoch_args = dict(logger=logger, csv_logger=csv_logger, device=device,
                      mesh=mesh)
    try:
        for epoch in range(first_epoch, epochs):
            run_epoch(step_fn, batcher, "train", epoch, is_training=True,
                      max_batches=max_batches, **epoch_args)
            save("model-{}".format(epoch))
            if not batcher.valid_samples:
                snapshot(epoch)
                continue
            val_loss, val_acc = run_epoch(
                step_fn, batcher, "validation", epoch, is_training=False,
                eval_fn=eval_fn, **epoch_args)
            if val_loss < best["val_loss"]:
                best["val_loss"] = val_loss
                best_epoch = epoch
                save("model-best_val_loss")
            if val_acc > best["val_acc"]:
                best["val_acc"] = val_acc
                save("model-best_val_acc")
            snapshot(epoch)
            if epoch - best_epoch >= early_stop_epochs:
                logger.info(
                    "Early stop: no val-loss improvement in %d epochs.",
                    early_stop_epochs)
                break
    finally:
        if csv_logger is not None:
            csv_logger.close()
    return model


def _check_features(model, batcher: TrainBatcher):
    kind = getattr(model, "input_kind", "counts")
    if batcher.is_read_level != (kind == "reads"):
        raise ValueError(
            "Model {} expects {} features but the feature files hold {} "
            "ones.".format(type(model).__name__, kind,
                           "read-level" if batcher.is_read_level
                           else "counts"))


def make_eval_fn(model, compute_dtype, mesh: Optional[parallel.Mesh] = None):
    """The evaluation step of training and validation: ``batch -> (loss,
    n_correct, n_total)`` of the global batch (this rank's rows of it
    given, as to the train step) without gradients, in inference mode."""
    kwargs = parallel._tp_kernel_fence(model, mesh)

    def eval_fn(batch):
        with torch.inference_mode(), parallel.deterministic_convolutions():
            loss, (n_c, n_t) = parallel.cross_entropy_loss(
                model, batch, compute_dtype=compute_dtype, training=False,
                mesh=mesh, apply_kwargs=kwargs)
            return parallel.global_metrics(mesh, loss, n_c, n_t)
    return eval_fn


def run_validation(batcher: TrainBatcher, model_path: str,
                   compute_dtype=torch.bfloat16, device=None):
    """Evaluate a checkpoint on the batcher's validation split, or on all
    its samples when it has none (``medaka_tpu.training.run_validation``,
    reference ``medaka train --validate_only``), through the evaluation
    step training uses.

    :param model_path: a bundle, reference checkpoint or model name.
    :returns: (mean loss, accuracy).
    """
    logger = common.get_named_logger("Training")
    device = common.resolve_device(device)
    model = models_mod.open_model(models_mod.resolve_model(model_path)).model
    _check_features(model, batcher)
    model.to(device)
    if not batcher.valid_samples:
        logger.info(
            "No validation split; evaluating on all provided samples.")
        batcher.valid_samples = batcher.train_samples
    return run_epoch(None, batcher, "validation", 0, logger,
                     is_training=False, eval_fn=make_eval_fn(
                         model, compute_dtype), device=device)


def train(args):
    """CLI entry point for ``medaka_tpu_torch train``.

    ``--validate_only`` evaluates ``--model`` and returns (loss,
    accuracy); ``--model`` names a bundle to warm-start from or an
    architecture TOML (its ``[model]`` table, as ``tools export`` writes
    it) to build with a random init from ``--seed``; ``--resume``
    continues the run in ``--train_name`` from its snapshot.
    """
    if getattr(args, "validate_only", False) and not args.model:
        raise ValueError("--validate_only requires --model.")
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
    devices = parallel.visible_devices(device)
    batcher = TrainBatcher(
        args.features, validation=args.validation_features
        or args.validation_split, seed=args.seed,
        batch_size=args.batch_size, max_samples=args.max_samples,
        max_valid_samples=args.max_valid_samples)
    if getattr(args, "validate_only", False):
        return run_validation(batcher, args.model,
                              compute_dtype=compute_dtype, device=device)
    model_dict = None
    initial_params = None
    if getattr(args, "model", None):
        if args.model.endswith(".toml"):
            model_dict = models_mod.read_toml_architecture(args.model)
        else:
            bundle = models_mod.open_model(
                models_mod.resolve_model(args.model))
            model_dict = bundle.model.to_dict()
            initial_params = bundle.model.jax_params()
    return run_training(
        args.train_name, batcher, model_dict=model_dict,
        epochs=args.epochs, optimizer=args.optimizer,
        optim_args=args.optim_args, seed=args.seed,
        initial_params=initial_params,
        resume=getattr(args, "resume", False),
        samples_per_epoch=getattr(args, "samples_per_training_epoch", None),
        use_lr_schedule=getattr(args, "use_lr_schedule", True),
        compute_dtype=compute_dtype, devices=devices,
        model_parallel=getattr(args, "model_parallel", 1))
