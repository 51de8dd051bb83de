"""Inference engine: BAM -> features -> device batches -> probability HDF5.

Counterpart of ``medaka_tpu/prediction.py`` (``Batch.collate``,
``DataLoader``, ``Predictor``, ``auto_batch_size``, ``run_prediction``,
``plan_work``, ``predict``) for the counts models:

- One static batch shape: every chunk rides in a (B, chunk_len, F) batch
  with a per-row ``lengths`` vector; the recurrences freeze h at padded
  steps, so padding never changes a valid column.
- Threaded host pipeline: ``bam_workers`` featurisation threads feed a
  bounded sample queue; a batcher thread packs fixed arrays; the main
  thread keeps two batches in flight on the device while HDF5 writes run
  on the datastore's writer thread.
- On the GPU, batches travel as bf16 features and come back as f16
  log-probabilities (``exp`` on the host); on the CPU, as float32.

Feature worker processes, sharded output files, the direct-decode route
and multi-device sharding are not ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from timeit import default_timer as now
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from medaka_tpu_torch import common
from medaka_tpu_torch import datastore as datastore_mod
from medaka_tpu_torch import features as features_mod
from medaka_tpu_torch.common import Region, Sample, resolve_device


@dataclasses.dataclass
class Batch:
    """A fixed-shape inference batch.

    ``features`` is (B, T, F) float32; rows beyond ``n_valid`` are zero
    padding. ``lengths`` holds per-row valid column counts.
    """

    features: np.ndarray
    lengths: np.ndarray
    samples: List[Sample]

    @property
    def n_valid(self) -> int:
        """Number of real (non-padding) rows."""
        return len(self.samples)

    @classmethod
    def collate(cls, samples: Sequence[Sample], batch_size: int,
                chunk_len: int) -> "Batch":
        """Pack counts samples into a zero-padded (B, T, F) float32 array."""
        width = samples[0].features.shape[-1]
        lengths = np.zeros((batch_size,), dtype=np.int32)
        feats = np.empty((batch_size, chunk_len, width), dtype=np.float32)
        for i, s in enumerate(samples):
            n = min(s.size, chunk_len)
            feats[i, :n] = s.features[:n]
            if n < chunk_len:
                feats[i, n:] = 0.0
            lengths[i] = n
        if len(samples) < batch_size:
            feats[len(samples):] = 0.0
        return cls(feats, lengths, list(samples))


class DataLoader:
    """Threaded region -> sample -> batch pipeline.

    ``bam_workers`` producer threads featurise regions into a bounded
    sample queue; one batcher thread packs fixed-shape batches. Short
    regions quarantined by the sample generator are featurised unchunked
    and ride in normal batches.
    """

    def __init__(self, bam, regions: Iterable[Region], feature_encoder,
                 batch_size: int = 128, chunk_len: int = 10000,
                 chunk_overlap: int = 1000, bam_workers: int = 2,
                 sample_cache_size: int = 8, batch_cache_size: int = 8):
        """Start the worker and batcher threads."""
        self.logger = common.get_named_logger("DataLoader")
        self.bam = bam
        self.fencoder = feature_encoder
        self.batch_size = batch_size
        self.chunk_len = chunk_len
        self.chunk_overlap = chunk_overlap
        self._sample_q: "queue.Queue" = queue.Queue(
            maxsize=sample_cache_size * batch_size)
        self._batch_q: "queue.Queue" = queue.Queue(maxsize=batch_cache_size)
        self._region_q: "queue.Queue" = queue.Queue()
        for region in regions:
            self._region_q.put(region)
        self._errors: List[BaseException] = []
        self.n_samples = 0
        self.remainder_regions: List[Region] = []
        self._workers = [
            threading.Thread(
                target=self._region_worker, daemon=True,
                name="bam_worker_{}".format(i))
            for i in range(max(1, bam_workers))]
        self._batcher = threading.Thread(
            target=self._batch_worker, daemon=True, name="batcher")
        for t in self._workers:
            t.start()
        self._batcher.start()

    def _region_worker(self):
        try:
            while True:
                try:
                    region = self._region_q.get_nowait()
                except queue.Empty:
                    break
                gen = features_mod.SampleGenerator(
                    self.bam, region, self.fencoder,
                    chunk_len=self.chunk_len,
                    chunk_overlap=self.chunk_overlap)
                for sample in gen.samples:
                    self._sample_q.put(sample)
                # short regions were quarantined: featurize unchunked
                for qregion, _size in gen._quarantined:
                    self.remainder_regions.append(qregion)
                    sub = features_mod.SampleGenerator(
                        self.bam, qregion, self.fencoder,
                        enable_chunking=False)
                    for sample in sub.samples:
                        self._sample_q.put(sample)
        except BaseException as e:  # pragma: no cover - surfaced on join
            self.logger.exception("Featurization worker failed.")
            self._errors.append(e)
        finally:
            self._sample_q.put(None)

    def _batch_worker(self):
        done_workers = 0
        pending: List[Sample] = []

        def add(sample):
            nonlocal pending
            pending.append(sample)
            if len(pending) == self.batch_size:
                self._emit(pending)
                pending = []

        try:
            while done_workers < len(self._workers):
                sample = self._sample_q.get()
                if sample is None:
                    done_workers += 1
                elif sample.size > self.chunk_len:
                    # unchunked sample wider than the static shape: split
                    for piece in sample.chunks(
                            chunk_len=self.chunk_len,
                            overlap=self.chunk_overlap):
                        add(piece)
                else:
                    add(sample)
            if pending:
                self._emit(pending)
        except BaseException as e:  # pragma: no cover
            self.logger.exception("Batcher failed.")
            self._errors.append(e)
        finally:
            self._batch_q.put(None)

    def _emit(self, samples: List[Sample]):
        self.n_samples += len(samples)
        self._batch_q.put(
            Batch.collate(samples, self.batch_size, self.chunk_len))

    def __iter__(self):
        while True:
            batch = self._batch_q.get()
            if batch is None:
                break
            yield batch
        for t in self._workers:
            t.join()
        self._batcher.join()
        if self._errors:
            raise self._errors[0]


class Predictor:
    """Forward pass over fixed-shape batches on one device.

    :param model: a model module holding its weights (e.g. ``GRUModel``).
    :param compute_dtype: torch.bfloat16 (default) or None (float32).
    :param compact_transfer: send bf16 features and fetch f16
        log-probabilities (log space keeps the quality-score precision
        near p=1 that an f16 probability would lose). Default: on for
        bf16 on the GPU, off on the CPU and for full precision.
    :param device: "cuda" (default) or "cpu".
    """

    def __init__(self, model, compute_dtype=torch.bfloat16,
                 compact_transfer: Optional[bool] = None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.compute_dtype = compute_dtype
        if compact_transfer is None:
            compact_transfer = (compute_dtype == torch.bfloat16
                                and self.device.type == "cuda")
        self.compact_transfer = compact_transfer

    def dispatch(self, batch: Batch) -> torch.Tensor:
        """Launch a batch; returns the device tensor of its outputs.

        Launches are asynchronous on the GPU, so the caller can featurise
        and write the previous batch while this one runs.
        """
        feats = torch.from_numpy(batch.features)
        if self.compact_transfer:
            feats = feats.to(torch.bfloat16)
        lengths = torch.from_numpy(batch.lengths).to(self.device)
        with torch.inference_mode():
            x = feats.to(self.device)
            if self.compact_transfer:
                logits = self.model(
                    x.float(), lengths=lengths, normalise=False,
                    compute_dtype=self.compute_dtype)
                return torch.log_softmax(logits, dim=-1).to(torch.float16)
            return self.model(
                x, lengths=lengths, normalise=True,
                compute_dtype=self.compute_dtype)

    def fetch(self, handle: torch.Tensor, n_valid: int) -> np.ndarray:
        """Block on a :meth:`dispatch` handle; (n_valid, T, C) probs."""
        out = handle[:n_valid].cpu().numpy().astype(np.float32)
        if self.compact_transfer:
            out = np.exp(out)
        return out

#: largest automatic batch on the GPU: the split kernels' grid at B=512
#: is 128 blocks (8 columns x 2 directions each), one per SM of an H100
#: (132 SMs); a larger batch widens every block's tile, so each of the
#: chunk_len serial steps gets longer while all SMs are already busy
AUTO_BATCH_CAP = 512


def auto_batch_size(model, device=None, chunk_len: int = 10000,
                    full_precision: bool = False,
                    free_bytes: Optional[int] = None) -> int:
    """Default inference batch size, sized from the port's own buffers.

    On the GPU the split path holds, per batch row, the bf16 features, the
    two (T, H) int8 layer-1 outputs and the two (T, C) f32 logit
    partials; the f32 scan of full-precision runs holds the (T, 3H)
    projections and (T, 2H) outputs of a layer in f32. Half of the free
    device memory (``torch.cuda.mem_get_info``) is budgeted, rounded down
    to a multiple of 64 and capped at :data:`AUTO_BATCH_CAP`. CPU runs
    and non-counts models use 128.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or \
            getattr(model, "input_kind", "counts") != "counts":
        return 128
    hidden = getattr(model, "gru_size", 256)
    classes = getattr(model, "num_classes", 5)
    width = getattr(model, "num_features", 10)
    if free_bytes is None:
        free_bytes = torch.cuda.mem_get_info(resolve_device(device))[0]
    if full_precision:
        per_row = chunk_len * 4 * (width + 3 * hidden + 4 * hidden)
    else:
        per_row = chunk_len * (2 * width + 2 * hidden + 2 * classes * 4)
    batch = (free_bytes // 2 // per_row) // 64 * 64
    return int(max(64, min(AUTO_BATCH_CAP, batch)))


def run_prediction(
        output: str, bam, regions: Sequence[Region], model,
        feature_encoder, label_scheme=None,
        batch_size: Optional[int] = None, chunk_len: int = 10000,
        chunk_overlap: int = 1000, bam_workers: int = 2,
        full_precision: bool = False, save_features: bool = False,
        device=None):
    """Run inference and write probability samples to ``output``.

    :param batch_size: rows per device batch (None: :func:`auto_batch_size`).
    :returns: (n_samples, n_columns) processed.
    """
    logger = common.get_named_logger("PWorker")
    device = resolve_device(device)
    compute_dtype = None if full_precision else torch.bfloat16
    if batch_size is None:
        batch_size = auto_batch_size(
            model, device, chunk_len=chunk_len,
            full_precision=full_precision)
        logger.info("Auto batch size: %d.", batch_size)
    predictor = Predictor(model, compute_dtype=compute_dtype, device=device)
    loader = DataLoader(
        bam, regions, feature_encoder, batch_size=batch_size,
        chunk_len=chunk_len, chunk_overlap=chunk_overlap,
        bam_workers=bam_workers)

    total_region_mbases = sum(r.size for r in regions) / 1e6
    t0 = now()
    tlast = t0
    n_columns = 0
    with datastore_mod.DataStore(output, "a") as ds:
        if feature_encoder is not None:
            ds.set_meta(feature_encoder, "feature_encoder")
        if label_scheme is not None:
            ds.set_meta(label_scheme, "label_scheme")
        ds.set_meta(model.to_dict(), "model_function")

        def drain(pending_batch, handle):
            nonlocal n_columns, tlast
            probs = predictor.fetch(handle, pending_batch.n_valid)
            for i, sample in enumerate(pending_batch.samples):
                n = sample.size
                n_columns += n
                ds.write_sample(sample.amend(
                    features=sample.features if save_features else None,
                    label_probs=probs[i, :n]))
            t1 = now()
            if t1 - tlast > 10:
                tlast = t1
                logger.info(
                    "%.1f%% Done (~%.2f Mbases) in %.1fs",
                    100 * min(1.0, n_columns / 1e6 / max(
                        1e-9, total_region_mbases)),
                    n_columns / 1e6, t1 - t0)

        # two batches in flight: device work overlaps featurisation and
        # HDF5 writes without holding more than two batches of outputs
        max_in_flight = 2
        pending = collections.deque()
        for batch in loader:
            pending.append((batch, predictor.dispatch(batch)))
            if len(pending) > max_in_flight:
                drain(*pending.popleft())
        while pending:
            drain(*pending.popleft())
        ds.write_registry()

    t1 = now()
    logger.info(
        "Processed %d samples (%d columns) in %.2fs (%.0f columns/s).",
        loader.n_samples, n_columns, t1 - t0,
        n_columns / max(1e-9, t1 - t0))
    return loader.n_samples, n_columns


def plan_work(regions, bam, bam_chunk: int = 1_000_000,
              chunk_overlap: int = 1000) -> List[Region]:
    """The deterministic per-run list of sub-regions.

    Regions larger than ``bam_chunk`` are split into pieces overlapping
    by ``chunk_overlap`` columns so chunk joins can be overlap-trimmed at
    stitch time. With ``regions=None`` the whole-contig regions come
    from the BAM header.
    """
    if bam is not None:
        regions = common.get_bam_regions(bam, regions)
    elif regions is None:
        raise ValueError("plan_work needs regions when no BAM is given.")
    work: List[Region] = []
    for region in regions:
        if region.size > bam_chunk:
            work.extend(region.split(
                bam_chunk, overlap=chunk_overlap, fixed_size=False))
        else:
            work.append(region)
    return work


def predict(
        bam, output: str, model_path: Optional[str] = None,
        model=None, feature_encoder=None, label_scheme=None,
        regions: Optional[Sequence[Region]] = None,
        batch_size: Optional[int] = None, chunk_len: int = 10000,
        chunk_overlap: int = 1000, bam_workers: int = 2,
        bam_chunk: int = 1_000_000, full_precision: bool = False,
        encoder_overrides: Optional[Dict] = None,
        save_features: bool = False, device=None):
    """Top-level inference entry: BAM -> probability HDF5.

    Either ``model_path`` (a native bundle) or an explicit model (holding
    its weights) with its feature encoder must be given.

    :param encoder_overrides: attribute overrides applied to the
        feature encoder's read filters (``read_group``, ``min_mapq``,
        ``tag_name``, ``tag_value``, ``tag_keep_missing``).
    :param device: "cuda" (default) or "cpu".
    :returns: (n_samples, n_columns).
    """
    logger = common.get_named_logger("Predict")
    device = resolve_device(device)
    if model_path is not None:
        from medaka_tpu_torch import models as models_mod
        bundle = models_mod.open_model(model_path)
        model = bundle.model
        feature_encoder = feature_encoder or bundle.feature_encoder
        label_scheme = label_scheme or bundle.label_scheme
    if encoder_overrides and feature_encoder is not None:
        for key, value in encoder_overrides.items():
            if not hasattr(feature_encoder, key):
                raise ValueError(
                    "Feature encoder {} has no filter attribute "
                    "{!r}.".format(type(feature_encoder).__name__, key))
            setattr(feature_encoder, key, value)
            logger.info("Encoder override: %s=%r", key, value)
    if model is None or feature_encoder is None:
        raise ValueError(
            "Provide model_path or an explicit model and feature_encoder.")
    model.check_feature_encoder_compatibility(feature_encoder)
    work = plan_work(regions, bam, bam_chunk, chunk_overlap)
    logger.info("Processing %d region chunk(s) on %s.", len(work), device)
    return run_prediction(
        output, bam, work, model, feature_encoder,
        label_scheme=label_scheme, batch_size=batch_size,
        chunk_len=chunk_len, chunk_overlap=chunk_overlap,
        bam_workers=bam_workers, full_precision=full_precision,
        save_features=save_features, device=device)
