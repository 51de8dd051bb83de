"""Inference engine: BAM -> features -> device batches -> probability HDF5,
or straight to a consensus FASTA/FASTQ (the direct route).

Counterpart of ``medaka_tpu/prediction.py`` (``Batch.collate``,
``DataLoader``, ``Predictor``, ``auto_batch_size``, ``run_prediction``,
``run_prediction_direct``, ``plan_work``, ``predict``,
``predict_direct``, ``predict_from_features``) for the counts and
read-level models:

- One static batch shape: every chunk rides in a (B, chunk_len, F)
  batch, or (B, chunk_len, R, C) for read-level features with R the
  batch's read bucket, with a per-row ``lengths`` vector; the
  recurrences freeze their state at padded steps, so padding never
  changes a valid column.
- Threaded host pipeline: ``bam_workers`` featurisation threads (or
  ``feature_processes`` spawned worker processes, which build features
  only and never touch the GPU) feed a bounded sample queue; a batcher
  thread packs fixed arrays; the main thread keeps two batches in flight
  on the device while HDF5 writes run on the datastore's writer thread,
  or on ``output_shards`` spawned writer processes
  (``datastore.ShardedDataStore``).
- On the GPU, float batches travel as bf16 and int8 read-level batches
  as int8 (widened on the device); outputs come back as f16
  log-probabilities (``exp`` on the host). On the CPU, float32.
- The direct route decodes on the device (argmax class and best value,
  after the f16 rounding, so the decode equals the HDF5 route's) and
  streams the decoded samples into ``stitch.DirectStitcher``.
- Data parallelism: :class:`Predictor` keeps a replica of the model on
  each device (every visible GPU by default) and cuts each batch into
  equal row slices, one a replica; the automatic batch is the one-card
  batch times the number of cards. Several processes split the work
  list (``parallel.shard_regions`` of :func:`plan_work`) and write an
  output each, which ``sequence`` merges.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import itertools
import queue
import threading
from timeit import default_timer as now
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from medaka_tpu_torch import common
from medaka_tpu_torch import datastore as datastore_mod
from medaka_tpu_torch import features as features_mod
from medaka_tpu_torch import parallel
from medaka_tpu_torch.common import Region, Sample, resolve_device
from medaka_tpu_torch.models.gru import SPLIT_HIDDEN_MULTIPLE


@dataclasses.dataclass
class Batch:
    """A fixed-shape inference batch.

    ``features`` is (B, T, F) float32 or (B, T, R, C) int8; rows beyond
    ``n_valid`` are zero padding. ``lengths`` holds per-row valid column
    counts.
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
                chunk_len: int, max_reads: Optional[int] = None) -> "Batch":
        """Pack samples into a zero-padded fixed-shape array.

        2-D counts samples give (B, T, F) float32. 3-D read-level samples
        give (B, T, R, C) int8 with R the batch's read bucket: the
        smallest of {max_reads/4, max_reads/2, max_reads} covering its
        deepest sample (``medaka_tpu/prediction.py:77-96``). The model's
        masked mean-pool ignores empty read rows, so the bucket does not
        change the output.
        """
        first = samples[0].features
        width = first.shape[-1]
        lengths = np.zeros((batch_size,), dtype=np.int32)
        if first.ndim == 3:
            actual = max(s.features.shape[1] for s in samples)
            if max_reads:
                reads = next(
                    b for b in (max(1, max_reads // 4),
                                max(1, max_reads // 2), max_reads)
                    if b >= min(actual, max_reads))
            else:
                reads = actual
            feats = np.zeros((batch_size, chunk_len, reads, width),
                             dtype=np.int8)
            for i, s in enumerate(samples):
                n = min(s.size, chunk_len)
                r = min(s.features.shape[1], reads)
                feats[i, :n, :r] = s.features[:n, :r]
                lengths[i] = n
            return cls(feats, lengths, list(samples))
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
    and ride in normal batches. ``feature_processes`` > 0 featurises in
    that many spawned worker processes instead, at most twice as many
    regions in flight, handed on in region order (the same samples and
    region events as the threads); a failed worker raises at the end of
    iteration, as a failed thread does.
    """

    def __init__(self, bam, regions: Iterable[Region], feature_encoder,
                 batch_size: int = 128, chunk_len: int = 10000,
                 chunk_overlap: int = 1000, bam_workers: int = 2,
                 sample_cache_size: int = 8, batch_cache_size: int = 8,
                 feature_processes: int = 0,
                 emit_region_events: bool = False):
        """Start the worker and batcher threads.

        ``emit_region_events=True`` makes iteration also yield
        ``("rdone", region_index)`` markers behind the last batch that can
        hold a region's samples (``medaka_tpu/prediction.py:162-175``); the
        direct route flushes stitch windows on them.
        """
        self.logger = common.get_named_logger("DataLoader")
        self.bam = bam
        self.fencoder = feature_encoder
        self.max_reads = getattr(feature_encoder, "max_reads", None)
        self.batch_size = batch_size
        self.chunk_len = chunk_len
        self.chunk_overlap = chunk_overlap
        self.emit_region_events = emit_region_events
        self._sample_q: "queue.Queue" = queue.Queue(
            maxsize=sample_cache_size * batch_size)
        self._batch_q: "queue.Queue" = queue.Queue(maxsize=batch_cache_size)
        self.regions = list(regions)
        self._region_q: "queue.Queue" = queue.Queue()
        for rid, region in enumerate(self.regions):
            self._region_q.put((rid, region))
        self._errors: List[BaseException] = []
        self.n_samples = 0
        self.remainder_regions: List[Region] = []
        self.feature_processes = feature_processes
        if feature_processes > 0:
            self._workers = [threading.Thread(
                target=self._process_pool_feeder, daemon=True,
                name="feature_proc_feeder")]
        else:
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

    def _process_pool_feeder(self):
        import concurrent.futures
        import multiprocessing

        try:
            ctx = multiprocessing.get_context("spawn")
            with concurrent.futures.ProcessPoolExecutor(
                    self.feature_processes, mp_context=ctx) as ex:
                in_flight = collections.deque()
                regions = iter(enumerate(self.regions))
                exhausted = False
                while in_flight or not exhausted:
                    while not exhausted and \
                            len(in_flight) < 2 * self.feature_processes:
                        item = next(regions, None)
                        if item is None:
                            exhausted = True
                            break
                        rid, region = item
                        in_flight.append((rid, ex.submit(
                            features_mod.featurize_region, self.bam, region,
                            self.fencoder, self.chunk_len,
                            self.chunk_overlap)))
                    if not in_flight:
                        break
                    rid, fut = in_flight.popleft()
                    samples, quarantined = fut.result()
                    for sample in samples:
                        self._sample_q.put((rid, sample))
                    for qregion, qsamples in quarantined:
                        self.remainder_regions.append(qregion)
                        for sample in qsamples:
                            self._sample_q.put((rid, sample))
                    self._sample_q.put(("rdone", rid))
        except BaseException as e:
            self.logger.exception("Featurization process pool failed.")
            self._errors.append(e)
        finally:
            self._sample_q.put(None)

    def _region_worker(self):
        try:
            while True:
                try:
                    rid, region = self._region_q.get_nowait()
                except queue.Empty:
                    break
                gen = features_mod.SampleGenerator(
                    self.bam, region, self.fencoder,
                    chunk_len=self.chunk_len,
                    chunk_overlap=self.chunk_overlap)
                for sample in gen.samples:
                    self._sample_q.put((rid, sample))
                # short regions were quarantined: featurize unchunked
                for qregion, _size in gen._quarantined:
                    self.remainder_regions.append(qregion)
                    sub = features_mod.SampleGenerator(
                        self.bam, qregion, self.fencoder,
                        enable_chunking=False)
                    for sample in sub.samples:
                        self._sample_q.put((rid, sample))
                self._sample_q.put(("rdone", rid))
        except BaseException as e:  # pragma: no cover - surfaced on join
            self.logger.exception("Featurization worker failed.")
            self._errors.append(e)
        finally:
            self._sample_q.put(None)

    def _batch_worker(self):
        done_workers = 0
        pending: List[Sample] = []
        pending_rids: List[int] = []
        held_events: List[int] = []

        def add(rid, sample):
            nonlocal pending, pending_rids
            pending.append(sample)
            pending_rids.append(rid)
            if len(pending) == self.batch_size:
                self._emit(pending)
                pending, pending_rids = [], []
                flush_events()

        def flush_events():
            if self.emit_region_events:
                for done_rid in held_events:
                    self._batch_q.put(("rdone", done_rid))
            held_events.clear()

        try:
            while done_workers < len(self._workers):
                item = self._sample_q.get()
                if item is None:
                    done_workers += 1
                    continue
                rid, payload = item
                if rid == "rdone":
                    # forwarded once no pending sample belongs to the
                    # finished region, else held until the batch holding
                    # those samples is emitted
                    if payload in pending_rids:
                        held_events.append(payload)
                    elif self.emit_region_events:
                        self._batch_q.put(("rdone", payload))
                elif payload.size > self.chunk_len:
                    # unchunked sample wider than the static shape: split
                    for piece in payload.chunks(
                            chunk_len=self.chunk_len,
                            overlap=self.chunk_overlap):
                        add(rid, piece)
                else:
                    add(rid, payload)
            if pending:
                self._emit(pending)
            flush_events()
        except BaseException as e:  # pragma: no cover
            self.logger.exception("Batcher failed.")
            self._errors.append(e)
        finally:
            self._batch_q.put(None)

    def _emit(self, samples: List[Sample]):
        self.n_samples += len(samples)
        self._batch_q.put(Batch.collate(
            samples, self.batch_size, self.chunk_len, self.max_reads))

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


def kernel_launches() -> Dict[str, int]:
    """The inference kernels' launch counts so far, by kernel."""
    from medaka_tpu_torch.ops import bilstm, gru_fullfused, gru_split
    return {**gru_split.LAUNCHES, **gru_fullfused.LAUNCHES,
            **bilstm.LAUNCHES}


class Predictor:
    """Forward pass over fixed-shape batches, data-parallel over devices.

    One replica of the model an entry of ``devices``, each on a CUDA
    stream of its own when there are several (a list may repeat a device:
    replicas then share it). A batch is padded to a multiple of the
    replica count and cut into equal row slices, slice i to replica i
    (``medaka_tpu/prediction.py:441-447``); every replica is launched
    before any is fetched, and the outputs come back in row order. Rows
    are independent, so the outputs do not depend on the replica count.

    :param model: a model module holding its weights (e.g. ``GRUModel``).
    :param compute_dtype: torch.bfloat16 (default) or None (float32).
    :param compact_transfer: send float features as bf16 (integer
        read-level features go as they are) and fetch f16
        log-probabilities (log space keeps the quality-score precision
        near p=1 that an f16 probability would lose). Default: on for
        bf16 on the GPU, off on the CPU and for full precision.
    :param device: "cuda" (every visible GPU, the default), "cuda:i" or
        "cpu", when ``devices`` is None.
    :param devices: the replicas' devices.
    """

    def __init__(self, model, compute_dtype=torch.bfloat16,
                 compact_transfer: Optional[bool] = None, device=None,
                 devices: Optional[Sequence] = None):
        self.devices = parallel.resolve_devices(devices, device)
        self.device = self.devices[0]
        self.model = model.to(self.device).eval()
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d)
                                        for d in self.devices[1:]]
        several = len(self.replicas) > 1
        self.streams = [torch.cuda.Stream(device=d)
                        if several and d.type == "cuda" else None
                        for d in self.devices]
        for d in set(self.devices):
            if several and d.type == "cuda":
                # the replicas' weights are in place before their streams
                # read them
                torch.cuda.synchronize(d)
        #: each replica's kernel launches (:func:`kernel_launches`)
        self.launches = [collections.Counter() for _ in self.replicas]
        self.compute_dtype = compute_dtype
        if compact_transfer is None:
            compact_transfer = (compute_dtype == torch.bfloat16
                                and self.device.type == "cuda")
        self.compact_transfer = compact_transfer

    @staticmethod
    def _on(stream):
        return torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext()

    def dispatch(self, batch: Batch, decode: bool = False):
        """Launch a batch on every replica; returns an opaque handle.

        Launches are asynchronous on the GPU, so the caller can featurise
        and write the previous batch while this one runs. ``decode=True``
        also reduces the outputs on the device to (argmax class uint8,
        best value) per column, after the f16 rounding of compact
        transfer, so the decode equals the one of the fetched
        probabilities (``medaka_tpu/prediction.py:395-404``); fetch that
        handle with :meth:`fetch_decoded`.
        """
        feats, lengths = batch.features, batch.lengths
        n = len(self.replicas)
        pad = (-feats.shape[0]) % n
        if pad:
            feats = np.pad(feats, [(0, pad)] + [(0, 0)] * (feats.ndim - 1))
            lengths = np.pad(lengths, (0, pad))
        per = feats.shape[0] // n
        handle = []
        for i, (replica, stream, device) in enumerate(zip(
                self.replicas, self.streams, self.devices)):
            rows = slice(i * per, (i + 1) * per)
            before = kernel_launches()
            with self._on(stream):
                out = self._forward(replica, device, feats[rows],
                                    lengths[rows])
                if decode:
                    with torch.inference_mode():
                        out = out.argmax(-1).to(torch.uint8), out.amax(-1)
            after = kernel_launches()
            self.launches[i].update({k: after[k] - before[k] for k in after
                                     if after[k] != before[k]})
            handle.append((stream, per, out))
        return handle

    def _forward(self, replica, device, features: np.ndarray,
                 lengths: np.ndarray) -> torch.Tensor:
        feats = torch.from_numpy(features)
        floating = feats.is_floating_point()
        if self.compact_transfer and floating:
            feats = feats.to(torch.bfloat16)
        lengths = torch.from_numpy(lengths).to(device)
        with torch.inference_mode():
            x = feats.to(device)
            if self.compact_transfer:
                # integer features are widened by the model on the device
                logits = replica(
                    x.float() if floating else x, lengths=lengths,
                    normalise=False, compute_dtype=self.compute_dtype)
                return torch.log_softmax(logits, dim=-1).to(torch.float16)
            return replica(
                x, lengths=lengths, normalise=True,
                compute_dtype=self.compute_dtype)

    def _gather(self, handle, n_valid: int, take):
        """``take(out, rows)`` of each replica's first valid rows, on its
        stream, in row order."""
        parts = []
        for i, (stream, per, out) in enumerate(handle):
            rows = min(per, n_valid - i * per)
            if rows > 0:
                with self._on(stream):
                    parts.append(take(out, rows))
        return parts

    def fetch(self, handle, n_valid: int) -> np.ndarray:
        """Block on a :meth:`dispatch` handle; (n_valid, T, C) probs."""
        out = np.concatenate(self._gather(
            handle, n_valid, lambda o, r: o[:r].cpu().numpy())
        ).astype(np.float32)
        if self.compact_transfer:
            out = np.exp(out)
        return out

    def fetch_decoded(self, handle, n_valid: int, phred_fn):
        """Block on a ``dispatch(decode=True)`` handle.

        :param phred_fn: error probability -> phred (the label scheme's
            ``_phred``), run on the host in the numpy arithmetic of the
            HDF5 route's ``decode_consensus``, so the quality characters
            are the same bytes.
        :returns: (classes uint8 (n_valid, T), quality chars uint8).
        """
        parts = self._gather(handle, n_valid, lambda o, r: (
            o[0][:r].cpu().numpy(), o[1][:r].cpu().numpy()))
        classes = np.concatenate([c for c, _ in parts])
        best = np.concatenate([b for _, b in parts]).astype(np.float32)
        if self.compact_transfer:
            best = np.exp(best)
        return classes, phred_fn(1.0 - best).astype("u1") + 33


#: largest automatic batch on the GPU: the split kernels' layer 1 at
#: B=512 is 128 blocks (8 columns x 2 directions each), one per SM of an
#: H100 (132 SMs); a larger batch widens every block's tile, so each of
#: the chunk_len serial steps gets longer while all SMs are already busy.
#: On the card, the batch is also held to what both split kernels run in
#: one wave (``gru_split.wave_batch``).
AUTO_BATCH_CAP = 512


#: smallest automatic batch off the split path (as in medaka_tpu)
OFF_SPLIT_MIN_BATCH = 32
#: largest automatic batch of read-level models (as in medaka_tpu)
READS_BATCH_CAP = 128
#: read-level activations of (chunk_len, max_reads, cnn_size) per batch
#: row alive at once in ``LatentSpaceLSTM.read_features``: a convolution's
#: input and output (its bias, ReLU and batch norm run in place, and the
#: pool multiplies in place), plus one for the convolution's workspace
READS_LIVE_ACTIVATIONS = 3


def auto_batch_size(model, device=None, chunk_len: int = 10000,
                    full_precision: bool = False,
                    free_bytes: Optional[int] = None,
                    max_reads: int = 100) -> int:
    """Default inference batch size, sized from the port's own buffers.

    On the GPU the split path holds, per batch row, the bf16 features, the
    two (T, H) int8 layer-1 outputs and the two (T, C) f32 logit
    partials; the f32 scan of full-precision runs holds the (T, 3H)
    projections and (T, 2H) outputs of a layer in f32. Half of the free
    device memory (``torch.cuda.mem_get_info``) is budgeted, rounded down
    to a multiple of 64 and capped at :data:`AUTO_BATCH_CAP`. On the card
    itself (``free_bytes`` not given), the split path's batch is also held
    to the most rows (a multiple of 32) at which both int8 split kernels
    run all their clusters at once (``gru_split.wave_batch``): 480 on an
    H100, whose 132 SMs hold 30 of layer 2's clusters of 4.

    Models off the split path (not 2 layers, unidirectional, or H not a
    multiple of 128; ``medaka_tpu/prediction.py:526-534``) run the
    fullfused (or fused) stack, which holds per row the bf16 features,
    two live (T, n_dirs H) bf16 inter-layer buffers, the (n_dirs, T, 3H)
    bf16 projection scratch and the (T, C) f32 logits; the same budget,
    never below :data:`OFF_SPLIT_MIN_BATCH`.

    Read-level models hold per row chunk_len x ``max_reads`` x cnn_size
    activations of 2 bytes (4 in full precision), times
    :data:`READS_LIVE_ACTIVATIONS`; the batch is the budget over that, at
    least 1 and at most :data:`READS_BATCH_CAP`. CPU runs use 128.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return 128
    on_card = free_bytes is None
    if on_card:
        free_bytes = torch.cuda.mem_get_info(resolve_device(device))[0]
    if getattr(model, "input_kind", "counts") == "reads":
        per_row = (chunk_len * max_reads * getattr(model, "cnn_size", 128)
                   * (4 if full_precision else 2) * READS_LIVE_ACTIVATIONS)
        return int(max(1, min(READS_BATCH_CAP, free_bytes // 2 // per_row)))
    hidden = getattr(model, "gru_size", 256)
    classes = getattr(model, "num_classes", 5)
    width = getattr(model, "num_features", 10)
    bidirectional = getattr(model, "bidirectional", True)
    split = (bidirectional and getattr(model, "n_layers", 2) == 2
             and hidden % SPLIT_HIDDEN_MULTIPLE == 0)
    smallest = 64
    if full_precision:
        per_row = chunk_len * 4 * (width + 3 * hidden + 4 * hidden)
    elif split:
        per_row = chunk_len * (2 * width + 2 * hidden + 2 * classes * 4)
    else:
        dirs = 2 if bidirectional else 1
        per_row = chunk_len * (2 * width + 2 * dirs * hidden * 2
                               + dirs * 3 * hidden * 2 + classes * 4)
        smallest = OFF_SPLIT_MIN_BATCH
    batch = (free_bytes // 2 // per_row) // 64 * 64
    batch = int(max(smallest, min(AUTO_BATCH_CAP, batch)))
    if split and not full_precision and on_card:
        from medaka_tpu_torch.ops import gru_split
        batch = gru_split.wave_batch(hidden, width, resolve_device(device),
                                     batch, classes=classes)
    return batch


#: each replica's kernel launches in the last run of the pipeline
#: (``Predictor.launches``)
REPLICA_LAUNCHES: List[Dict[str, int]] = []


def replicated_batch_size(model, devices, **kwargs) -> int:
    """The automatic batch over ``devices``: :func:`auto_batch_size` of
    the first device times the number of distinct cards, so each card
    keeps its one-card batch (one wave of the split kernels) however many
    replicas share it; the CPU's batch on the CPU."""
    cards = max(1, parallel.distinct_cards(devices))
    return auto_batch_size(model, devices[0], **kwargs) * cards


def _stream_batches(
        bam, regions: Sequence[Region], model, feature_encoder, write_batch,
        region_done=None, batch_size: Optional[int] = None,
        chunk_len: int = 10000, chunk_overlap: int = 1000,
        bam_workers: int = 2, full_precision: bool = False, devices=None,
        feature_processes: int = 0):
    """Run every batch of ``regions`` through ``model``, two in flight.

    Each batch goes, in order, to ``write_batch(predictor, batch,
    handle)``. With ``region_done`` the batches are dispatched with
    ``decode=True`` and each work region's index goes to
    ``region_done(rid)`` once every batch holding its samples is written.

    :param devices: the replicas' devices (:class:`Predictor`).
    :returns: (n_samples, n_columns) processed.
    """
    logger = common.get_named_logger("PWorker")
    compute_dtype = None if full_precision else torch.bfloat16
    if batch_size is None:
        batch_size = replicated_batch_size(
            model, devices, chunk_len=chunk_len,
            full_precision=full_precision,
            max_reads=getattr(feature_encoder, "max_reads", 100))
        logger.info("Auto batch size: %d.", batch_size)
    predictor = Predictor(model, compute_dtype=compute_dtype,
                          devices=devices)
    decode = region_done is not None
    loader = DataLoader(
        bam, regions, feature_encoder, batch_size=batch_size,
        chunk_len=chunk_len, chunk_overlap=chunk_overlap,
        bam_workers=bam_workers, feature_processes=feature_processes,
        emit_region_events=decode)

    total_region_mbases = sum(r.size for r in regions) / 1e6
    t0 = now()
    tlast = t0
    n_columns = 0

    def drain(item):
        nonlocal n_columns, tlast
        if not isinstance(item[0], Batch):  # ("rdone", rid)
            region_done(item[1])
            return
        write_batch(predictor, *item)
        n_columns += sum(sample.size for sample in item[0].samples)
        t1 = now()
        if t1 - tlast > 10:
            tlast = t1
            logger.info(
                "%.1f%% Done (~%.2f Mbases) in %.1fs",
                100 * min(1.0, n_columns / 1e6 / max(
                    1e-9, total_region_mbases)),
                n_columns / 1e6, t1 - t0)

    # two batches in flight: device work overlaps featurisation and
    # output writes without holding more than two batches of outputs;
    # region events wait in order behind the batches before them
    max_in_flight = 2
    pending = collections.deque()
    in_flight = 0
    for item in loader:
        if not isinstance(item, Batch):
            pending.append(item)
            continue
        pending.append((item, predictor.dispatch(item, decode=decode)))
        in_flight += 1
        while in_flight > max_in_flight:
            head = pending.popleft()
            in_flight -= isinstance(head[0], Batch)
            drain(head)
    while pending:
        drain(pending.popleft())
    REPLICA_LAUNCHES[:] = [dict(c) for c in predictor.launches]

    t1 = now()
    logger.info(
        "Processed %d samples (%d columns) in %.2fs (%.0f columns/s).",
        loader.n_samples, n_columns, t1 - t0,
        n_columns / max(1e-9, t1 - t0))
    return loader.n_samples, n_columns


def run_prediction(
        output: str, bam, regions: Sequence[Region], model,
        feature_encoder, label_scheme=None,
        batch_size: Optional[int] = None, chunk_len: int = 10000,
        chunk_overlap: int = 1000, bam_workers: int = 2,
        full_precision: bool = False, save_features: bool = False,
        device=None, feature_processes: int = 0, output_shards: int = 1,
        devices=None):
    """Run inference and write probability samples to ``output``.

    :param batch_size: rows of a batch over all devices (None:
        :func:`replicated_batch_size`).
    :param device: as :func:`predict`.
    :param devices: the replicas' devices (:class:`Predictor`; None:
        every visible GPU, or ``device``).
    :param feature_processes: featurise in this many worker processes
        instead of ``bam_workers`` threads (:class:`DataLoader`).
    :param output_shards: > 1 writes the samples round-robin over that
        many shard files in writer processes
        (``datastore.ShardedDataStore``); ``output`` then holds the
        metadata and the shard manifest, which ``DataIndex`` expands.
    :returns: (n_samples, n_columns) processed.
    """
    if output_shards > 1:
        store = datastore_mod.ShardedDataStore(output, shards=output_shards)
    else:
        store = datastore_mod.DataStore(output, "a")
    with store as ds:
        if feature_encoder is not None:
            ds.set_meta(feature_encoder, "feature_encoder")
        if label_scheme is not None:
            ds.set_meta(label_scheme, "label_scheme")
        ds.set_meta(model.to_dict(), "model_function")

        def write_batch(predictor, batch, handle):
            probs = predictor.fetch(handle, batch.n_valid)
            for i, sample in enumerate(batch.samples):
                ds.write_sample(sample.amend(
                    features=sample.features if save_features else None,
                    label_probs=probs[i, :sample.size]))

        counts = _stream_batches(
            bam, regions, model, feature_encoder, write_batch,
            batch_size=batch_size, chunk_len=chunk_len,
            chunk_overlap=chunk_overlap, bam_workers=bam_workers,
            full_precision=full_precision,
            devices=parallel.resolve_devices(devices, device),
            feature_processes=feature_processes)
        ds.write_registry()
    return counts


def _check_direct_scheme(label_scheme):
    """Refuse label schemes whose decode is not a plain argmax (commit
    8687591 of medaka_tpu, ``prediction.py:663-677``)."""
    from medaka_tpu_torch.labels import HaploidLabelScheme
    if label_scheme is None:
        raise ValueError(
            "The direct consensus route needs the model bundle's label "
            "scheme (argmax classes are decoded to its symbols).")
    if getattr(type(label_scheme), "decode_consensus", None) is not \
            HaploidLabelScheme.decode_consensus:
        # RLE expands (base, run) classes and diploid has 15 classes:
        # neither is a plain symbols[argmax] decode, so one class byte and
        # one quality byte a column cannot represent them
        raise ValueError(
            "The direct route supports plain haploid consensus decoding "
            "only; {} overrides decode_consensus. Use the HDF5 route "
            "(inference + sequence) for this model.".format(
                type(label_scheme).__name__))


def run_prediction_direct(
        output_fastx: str, bam, regions: Sequence[Region], model,
        feature_encoder, label_scheme, draft_path: str,
        batch_size: Optional[int] = None, chunk_len: int = 10000,
        chunk_overlap: int = 1000, bam_workers: int = 2,
        full_precision: bool = False, min_depth: int = 0,
        fillgaps: bool = True, fill_char: Optional[str] = None,
        qualities: bool = False, device=None, devices=None):
    """Consensus without a probability file: argmax + quality on the device.

    Counterpart of ``medaka_tpu/prediction.py:run_prediction_direct``. The
    device reduces each column to its argmax class and best value, the
    host fetches those and streams decoded samples into
    :class:`stitch.DirectStitcher`; no probability file is written or
    read. The output is byte-identical to :func:`run_prediction` +
    ``stitch.stitch_to_fasta``.

    :returns: (n_samples, n_columns).
    """
    from medaka_tpu_torch import stitch as stitch_mod

    _check_direct_scheme(label_scheme)
    stitcher = stitch_mod.DirectStitcher(
        draft_path, regions, label_scheme, output_fastx,
        min_depth=min_depth, fillgaps=fillgaps, fill_char=fill_char,
        qualities=qualities)

    def write_batch(predictor, batch, handle):
        classes, quals = predictor.fetch_decoded(
            handle, batch.n_valid, label_scheme._phred)
        for i, sample in enumerate(batch.samples):
            n = sample.size
            decoded = np.empty((n, 2), dtype=np.uint8)
            decoded[:, 0] = classes[i, :n]
            decoded[:, 1] = quals[i, :n]
            stitcher.add_sample(sample.amend(
                features=None, labels=None, label_probs=decoded))

    counts = _stream_batches(
        bam, regions, model, feature_encoder, write_batch,
        region_done=stitcher.region_done, batch_size=batch_size,
        chunk_len=chunk_len, chunk_overlap=chunk_overlap,
        bam_workers=bam_workers, full_precision=full_precision,
        devices=parallel.resolve_devices(devices, device))
    stitcher.finish()
    return counts


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


def _resolve_model(model_path, model, feature_encoder, label_scheme):
    """(model, feature encoder, label scheme) of the bundle that
    ``model_path`` (a path or a model name, ``models.resolve_model``)
    names (an explicit encoder or scheme wins), or as given."""
    if model_path is not None:
        from medaka_tpu_torch import models as models_mod
        bundle = models_mod.open_model(models_mod.resolve_model(model_path))
        model = bundle.model
        feature_encoder = feature_encoder or bundle.feature_encoder
        label_scheme = label_scheme or bundle.label_scheme
    if model is None or feature_encoder is None:
        raise ValueError(
            "Provide model_path or an explicit model and feature_encoder.")
    model.check_feature_encoder_compatibility(feature_encoder)
    return model, feature_encoder, label_scheme


def predict(
        bam, output: str, model_path: Optional[str] = None,
        model=None, feature_encoder=None, label_scheme=None,
        regions: Optional[Sequence[Region]] = None,
        batch_size: Optional[int] = None, chunk_len: int = 10000,
        chunk_overlap: int = 1000, bam_workers: int = 2,
        bam_chunk: int = 1_000_000, full_precision: bool = False,
        encoder_overrides: Optional[Dict] = None,
        save_features: bool = False, device=None,
        feature_processes: int = 0, output_shards: int = 1, devices=None):
    """Top-level inference entry: BAM -> probability HDF5.

    Either ``model_path`` (a native bundle) or an explicit model (holding
    its weights) with its feature encoder must be given.

    :param encoder_overrides: attribute overrides applied to the
        feature encoder's read filters (``read_group``, ``min_mapq``,
        ``tag_name``, ``tag_value``, ``tag_keep_missing``).
    :param device: "cuda" (every visible GPU, the default), "cuda:i" or
        "cpu", when ``devices`` is None.
    :param devices: one model replica an entry (:class:`Predictor`).
    :returns: (n_samples, n_columns).
    """
    logger = common.get_named_logger("Predict")
    devices = parallel.resolve_devices(devices, device)
    model, feature_encoder, label_scheme = _resolve_model(
        model_path, model, feature_encoder, label_scheme)
    for key, value in (encoder_overrides or {}).items():
        if not hasattr(feature_encoder, key):
            raise ValueError(
                "Feature encoder {} has no filter attribute "
                "{!r}.".format(type(feature_encoder).__name__, key))
        setattr(feature_encoder, key, value)
        logger.info("Encoder override: %s=%r", key, value)
    if getattr(model, "input_kind", "counts") == "reads" \
            and chunk_len > 2000:
        logger.warning(
            "chunk_len=%d with a read-level model implies very large "
            "(batch, %d, reads, features) device tensors; consider "
            "--chunk_len 1000.", chunk_len, chunk_len)
    work = plan_work(regions, bam, bam_chunk, chunk_overlap)
    logger.info("Processing %d region chunk(s) over %d device(s).",
                len(work), len(devices))
    return run_prediction(
        output, bam, work, model, feature_encoder,
        label_scheme=label_scheme, batch_size=batch_size,
        chunk_len=chunk_len, chunk_overlap=chunk_overlap,
        bam_workers=bam_workers, full_precision=full_precision,
        save_features=save_features, devices=devices,
        feature_processes=feature_processes, output_shards=output_shards)


def predict_from_features(
        inputs, output: str, model_path: Optional[str] = None,
        model=None, batch_size: Optional[int] = None,
        full_precision: bool = False, device=None, devices=None):
    """Run inference over precomputed feature files (no BAM)
    (``medaka_tpu.prediction.predict_from_features``).

    Samples are read back from the feature HDF5s (``features``; shard
    manifests expand) in genomic order, batched at one static chunk
    length, the longest sample's (``DataIndex.max_sample_size``), and
    written to ``output`` with their ``label_probs``.

    :param device: as :func:`predict`.
    :param devices: as :func:`predict`.
    :returns: (n_samples, n_columns).
    """
    logger = common.get_named_logger("PWorker")
    devices = parallel.resolve_devices(devices, device)
    index = datastore_mod.DataIndex(
        list(inputs) if isinstance(inputs, (list, tuple)) else [inputs])
    feature_encoder = index.metadata.get("feature_encoder")
    label_scheme = index.metadata.get("label_scheme")
    if model_path is not None:
        from medaka_tpu_torch import models as models_mod
        bundle = models_mod.open_model(models_mod.resolve_model(model_path))
        model = bundle.model
        feature_encoder = bundle.feature_encoder or feature_encoder
        label_scheme = bundle.label_scheme or label_scheme
    if model is None:
        raise ValueError("Provide model_path or model.")
    compute_dtype = None if full_precision else torch.bfloat16
    predictor = Predictor(model, compute_dtype=compute_dtype,
                          devices=devices)
    samples = index.yield_from_feature_files()
    first = next(samples, None)
    if first is None:
        raise ValueError("No samples found in inputs.")
    chunk_len = max(first.size, index.max_sample_size())
    max_reads = getattr(feature_encoder, "max_reads", None)
    if batch_size is None:
        batch_size = replicated_batch_size(
            model, devices, chunk_len=chunk_len,
            full_precision=full_precision, max_reads=max_reads or 100)
        logger.info("Auto batch size: %d over %d device(s).", batch_size,
                    len(devices))
    n_samples = n_columns = 0
    t0 = now()
    with datastore_mod.DataStore(output, "a") as out_ds:
        if feature_encoder is not None:
            out_ds.set_meta(feature_encoder, "feature_encoder")
        if label_scheme is not None:
            out_ds.set_meta(label_scheme, "label_scheme")
        out_ds.set_meta(model.to_dict(), "model_function")
        stream = itertools.chain([first], samples)
        while True:
            group = list(itertools.islice(stream, batch_size))
            if not group:
                break
            batch = Batch.collate(group, batch_size, chunk_len, max_reads)
            probs = predictor.fetch(predictor.dispatch(batch), len(group))
            for i, sample in enumerate(group):
                n_samples += 1
                n_columns += sample.size
                out_ds.write_sample(sample.amend(
                    features=None, labels=None,
                    label_probs=probs[i, :sample.size]))
        out_ds.write_registry()
    logger.info("Processed %d samples (%d columns) in %.2fs.",
                n_samples, n_columns, now() - t0)
    return n_samples, n_columns


def predict_direct(
        bam, output_fastx: str, draft_path: str,
        model_path: Optional[str] = None, model=None, feature_encoder=None,
        label_scheme=None, regions: Optional[Sequence[Region]] = None,
        batch_size: Optional[int] = None, chunk_len: int = 10000,
        chunk_overlap: int = 1000, bam_workers: int = 2,
        bam_chunk: int = 1_000_000, full_precision: bool = False,
        min_depth: int = 0, fillgaps: bool = True,
        fill_char: Optional[str] = None, qualities: bool = False,
        device=None, devices=None):
    """BAM -> polished FASTA/FASTQ with the decode on the device, no HDF5
    (counterpart of ``medaka_tpu.prediction.predict_direct``).

    Arguments as :func:`predict` and ``stitch.stitch_to_fasta``.

    :returns: (n_samples, n_columns).
    """
    logger = common.get_named_logger("Predict")
    devices = parallel.resolve_devices(devices, device)
    model, feature_encoder, label_scheme = _resolve_model(
        model_path, model, feature_encoder, label_scheme)
    work = plan_work(regions, bam, bam_chunk, chunk_overlap)
    logger.info("Processing %d region chunk(s) over %d device(s) (direct "
                "decode).", len(work), len(devices))
    return run_prediction_direct(
        output_fastx, bam, work, model, feature_encoder, label_scheme,
        draft_path, batch_size=batch_size, chunk_len=chunk_len,
        chunk_overlap=chunk_overlap, bam_workers=bam_workers,
        full_precision=full_precision, min_depth=min_depth,
        fillgaps=fillgaps, fill_char=fill_char, qualities=qualities,
        devices=devices)
