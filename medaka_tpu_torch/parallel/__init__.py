"""Scale-out: the (data, model) mesh of ranks, loss, accuracy and the
training step, on ``torch.distributed``.

Counterpart of ``medaka_tpu/parallel/__init__.py``. JAX lays one program
over a ``Mesh`` of devices and lets GSPMD insert the collectives; here
each rank is a process with one device, and the collectives are written
out:

- ``data``: the batch dimension. Rank r of the data axis takes rows
  ``[r B/d, (r+1) B/d)`` of every global batch. The loss is divided by
  the global mask (or weight) sum, the gradients are summed over the data
  group, the accuracy counts are summed, and a batch-norm model's
  statistics are global (``MaskedBatchStats`` with ``bn_group``), so a
  step gives the same parameters on any mesh.
- ``model``: the recurrent gate dimension. ``w_ih``/``w_hh`` (and 1-D
  ``b_ih``/``b_hh``) are cut by rows (:func:`shard_model`); each step of
  the scan projects this rank's gate rows and gathers the (B, 3H) or
  (B, 4H) gates over the model group (:class:`ModelAxis`). The kernels
  are validated unsharded only, so the model axis runs the plain scan
  (:func:`_tp_kernel_fence`), as ``medaka_tpu`` does.

With one rank nothing here communicates: every reduction is skipped (not
taken over a group of one), so the one-device step keeps its bits.
"""
from __future__ import annotations

import contextlib
import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from medaka_tpu_torch import common

logger = common.get_named_logger("parallel")

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: weight of a batch's statistics in the running batch-norm statistics
#: (torch BatchNorm1d's momentum; ``medaka_tpu`` uses the same)
BN_MOMENTUM = 0.1

#: the longest a collective waits for the other ranks (a rank that died
#: before it makes the others raise, not hang)
DEFAULT_TIMEOUT_S = 600


def visible_devices(device=None) -> List[torch.device]:
    """The devices an entry point spreads over: every visible GPU
    (``cuda:0`` ... ``cuda:{n-1}``) for ``device`` None or "cuda",
    ``[device]`` for a CUDA device with an index, ``["cpu"]`` for the
    CPU. Raises without a GPU unless the CPU is asked for."""
    dev = common.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def resolve_devices(devices=None, device=None) -> List[torch.device]:
    """``devices`` (a list, which may repeat a device) as torch devices,
    each checked as :func:`common.resolve_device` does, or
    :func:`visible_devices` of ``device`` when it is None."""
    if devices is None:
        return visible_devices(device)
    devices = [common.resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("an empty device list")
    return devices


def distinct_cards(devices: Sequence) -> int:
    """The number of distinct CUDA devices in ``devices``."""
    return len({(d.type, d.index or 0) for d in map(torch.device, devices)
                if d.type == "cuda"})


class Mesh:
    """A (data, model) grid of ranks, one device a rank (``make_mesh``).

    Rank ``r`` sits at data index ``r // model`` and model index
    ``r % model`` and runs on ``devices[r]``; a list may repeat a device.
    :meth:`connect` joins this process's rank to the subgroups (after the
    default process group is up): ``model_group``, the ranks that share a
    data slice, and ``data_group``, the ranks that hold the same model
    shard. A group of one rank is None: nothing is reduced over it.

    :raises ValueError: as ``make_mesh`` raises: devices not divisible by
        ``model``, or ``data * model`` not the number of devices.
    """

    def __init__(self, devices=None, data: Optional[int] = None,
                 model: int = 1):
        devices = resolve_devices(devices)
        n = len(devices)
        if data is None:
            if n % model:
                raise ValueError(
                    "{} devices not divisible by model={}".format(n, model))
            data = n // model
        if data * model != n:
            raise ValueError(
                "mesh {}x{} != {} devices".format(data, model, n))
        self.devices = devices
        self.data, self.model = data, model
        self.rank = 0
        self.data_group = None
        self.model_group = None

    @property
    def size(self) -> int:
        """The number of ranks."""
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        """This rank's index on the data axis."""
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        """This rank's index on the model axis."""
        return self.rank % self.model

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[self.rank]

    def backend(self) -> str:
        """nccl when every rank has a GPU of its own, gloo otherwise (two
        ranks on one GPU, or the CPU)."""
        if all(d.type == "cuda" for d in self.devices) and \
                distinct_cards(self.devices) == len(self.devices):
            return "nccl"
        return "gloo"

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` rows."""
        if n % self.data:
            raise ValueError("a batch of {} rows does not split over {} "
                             "data ranks".format(n, self.data))
        per = n // self.data
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def connect(self, rank: int) -> "Mesh":
        """Set this process's rank and make the subgroups. Every rank
        calls it, after ``init_process_group``, since making a group is
        collective."""
        import torch.distributed as dist
        self.rank = rank
        if self.model > 1:
            for d in range(self.data):
                ranks = [d * self.model + m for m in range(self.model)]
                group = dist.new_group(ranks)
                if rank in ranks:
                    self.model_group = group
        if self.data > 1:
            for m in range(self.model):
                ranks = [d * self.model + m for d in range(self.data)]
                group = dist.new_group(ranks)
                if rank in ranks:
                    self.data_group = group
        return self


#: the backend and size of the last process group :func:`process_group`
#: brought up in this process
LAST_GROUP: Dict[str, object] = {}


@contextlib.contextmanager
def process_group(mesh: Mesh, rank: int, store,
                  timeout_s: float = DEFAULT_TIMEOUT_S):
    """The default process group of ``mesh`` (its :meth:`Mesh.backend`)
    for the block, with this process as ``rank`` and ``store`` as the
    rendezvous; every collective waits at most ``timeout_s``. The mesh is
    connected inside and the group destroyed on the way out."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("a default process group is already up in this "
                           "process")
    dev = mesh.devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        mesh.backend(), store=store, rank=rank, world_size=mesh.size,
        timeout=datetime.timedelta(seconds=timeout_s))
    LAST_GROUP.update(backend=dist.get_backend(), size=dist.get_world_size())
    try:
        yield mesh.connect(rank)
    finally:
        dist.destroy_process_group()


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; nothing for a group of one
    (None). gloo takes CUDA tensors for this and ``broadcast`` only."""
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(t, group=group)
    return t


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """The ranks' ``t``, in rank order (through the host where the group
    is gloo and ``t`` on a GPU: gloo gathers host tensors only)."""
    import torch.distributed as dist
    src = t.detach().contiguous()
    if src.is_cuda and dist.get_backend(group) == "gloo":
        return [p.to(t.device) for p in _all_gather(src.cpu(), group)]
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return parts


# ---------------------------------------------------------------------------
# The model axis
# ---------------------------------------------------------------------------


def _spec_for(path: Tuple[str, ...], ndim: int) -> Tuple:
    names = set(path)
    if {"w_ih", "w_hh"} & names:
        return (MODEL_AXIS, None)
    if {"b_ih", "b_hh"} & names and ndim == 1:
        return (MODEL_AXIS,)
    return ()


def params_spec_for_model(model, params) -> Dict:
    """The partition pytree of a JAX-layout parameter pytree: recurrent
    ``w_ih``/``w_hh`` by rows over ``model`` (``("model", None)``), 1-D
    ``b_ih``/``b_hh`` too (``("model",)``), everything else replicated
    (``()``)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(v, path) for v in node]
            return type(node)(out) if isinstance(node, tuple) else out
        return _spec_for(path, node.ndim)

    return walk(params, ())


def _row_slice(n: int, mesh: Mesh) -> slice:
    if n % mesh.model:
        raise ValueError("{} gate rows do not split over model={}".format(
            n, mesh.model))
    per = n // mesh.model
    return slice(mesh.model_rank * per, (mesh.model_rank + 1) * per)


def shard_params(params, mesh: Mesh):
    """This rank's part of a JAX-layout pytree: each leaf that
    :func:`params_spec_for_model` puts on ``model`` cut to the model
    rank's contiguous rows (in JAX's row order), the rest as it is."""
    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(v, s) for v, s in zip(node, spec)]
            return type(node)(out) if isinstance(node, tuple) else out
        return node[_row_slice(node.shape[0], mesh)] if spec else node

    return walk(params, params_spec_for_model(None, params))


def sharded_parameters(model) -> List[bool]:
    """For each of ``model.parameters()``: whether the model axis cuts
    it (its name names a recurrent weight, as in
    :func:`params_spec_for_model`)."""
    return [bool(_spec_for(tuple(name.split(".")), p.ndim))
            for name, p in model.named_parameters()]


@torch.no_grad()
def shard_model(model, mesh: Mesh, optimizer=None):
    """Cut ``model``'s recurrent weights (and ``optimizer``'s state of
    them) to this rank's rows, in place: the parameters stay the same
    objects. Nothing under a model axis of 1."""
    if mesh.model_group is None:
        return model
    params = list(model.parameters())
    for i, (p, cut) in enumerate(zip(params, sharded_parameters(model))):
        if not cut:
            continue
        rows = _row_slice(p.shape[0], mesh)
        p.data = p.data[rows].clone()
        for slot in optimizer.slots() if optimizer is not None else ():
            optimizer.state[slot][i] = optimizer.state[slot][i][rows].clone()
    return model


@contextlib.contextmanager
def unsharded(model, mesh: Optional[Mesh], optimizer=None):
    """Within the block, ``model``'s recurrent weights and ``optimizer``'s
    state of them are whole (gathered over the model group), for a
    checkpoint or a resume snapshot; cut again after it. Collective over
    the model group; nothing under a model axis of 1."""
    if mesh is None or mesh.model_group is None:
        yield model
        return
    params = list(model.parameters())
    saved = []
    with torch.no_grad():
        for i, (p, cut) in enumerate(zip(params, sharded_parameters(model))):
            if not cut:
                continue
            saved.append((i, p.data, {s: optimizer.state[s][i] for s in (
                optimizer.slots() if optimizer is not None else ())}))
            p.data = torch.cat(_all_gather(p.data, mesh.model_group))
            for slot, part in saved[-1][2].items():
                optimizer.state[slot][i] = torch.cat(
                    _all_gather(part, mesh.model_group))
    try:
        yield model
    finally:
        for i, data, slots in saved:
            params[i].data = data
            for slot, part in slots.items():
                optimizer.state[slot][i] = part


class _GatherGates(torch.autograd.Function):
    """The ranks' gate columns side by side (rank order); the gradient
    of this rank's columns is its slice of the upstream gradient, which
    every rank holds whole (the computation after the gather is the same
    on each)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[-1]
        return torch.cat(_all_gather(x, group), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None


class _SumGradients(torch.autograd.Function):
    """The identity, whose gradient is summed over the group: the input
    of a row-sharded product gets the product's gradient from every rank's
    rows (Megatron's "f" operator)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class ModelAxis:
    """What the scans of :mod:`medaka_tpu_torch.ops.rnn` need under a
    model axis: :meth:`enter` before a product with this rank's gate rows,
    :meth:`gates` after it.

    ``torch.distributed.nn.functional.all_gather`` is not used: its
    gradient sums the ranks' copies of the upstream gradient, which here
    are equal (the gates feed the same computation on every rank), so
    it would scale the weights' gradients by the group's size.
    """

    def __init__(self, group):
        self.group = group

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (gradients summed over the group in the backward)."""
        return _SumGradients.apply(x, self.group) if x.requires_grad else x

    def gates(self, x: torch.Tensor) -> torch.Tensor:
        """(..., G/model) gate columns -> (..., G)."""
        return _GatherGates.apply(x, self.group)


def _tp_kernel_fence(model, mesh: Optional[Mesh]) -> Dict:
    """Extra forward kwargs under a model axis above 1: ``fused=False``
    (the kernels see whole weights only; the scan runs on the shards) and
    the :class:`ModelAxis` of the scans, with ``medaka_tpu``'s warning.
    Empty otherwise."""
    if mesh is None or mesh.model <= 1:
        return {}
    logger.warning(
        "model axis size %d > 1: recurrent compute uses the GSPMD scan "
        "path (fused Pallas kernels are validated unsharded only).",
        mesh.model)
    return {"fused": False, "gate_gather": ModelAxis(mesh.model_group)}


def make_sharded_forward(model, mesh: Mesh, compute_dtype=torch.bfloat16):
    """This rank's forward over a global batch (``make_sharded_forward``):
    ``forward(x, lengths)`` runs the rows of this data rank (the batch
    padded to a multiple of the data axis) with the model-axis fence, and
    gathers the probabilities of every data rank, in row order, on the
    host. ``model`` holds this rank's shards (:func:`shard_model`)."""
    fence = _tp_kernel_fence(model, mesh)

    def forward(x, lengths):
        x, lengths = torch.as_tensor(x), torch.as_tensor(lengths)
        n = x.shape[0]
        pad = (-n) % mesh.data
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
            lengths = torch.cat([lengths, lengths.new_zeros(pad)])
        rows = mesh.rows(x.shape[0])
        with torch.inference_mode():
            out = model(x[rows].to(mesh.device),
                        lengths=lengths[rows].to(mesh.device),
                        normalise=True, compute_dtype=compute_dtype, **fence)
        parts = _all_gather(out.cpu(), mesh.data_group) \
            if mesh.data_group is not None else [out.cpu()]
        return torch.cat(parts)[:n]

    return forward


# ---------------------------------------------------------------------------
# Loss, accuracy and the training step
# ---------------------------------------------------------------------------


def deterministic_convolutions():
    """cuDNN flags under which a step repeats bit for bit: deterministic
    convolution algorithms, no autotuning, and float32 convolutions in
    float32 (not TF32). Forward and backward must both run under them:
    the backward's convolutions read the flags when they run."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=False,
                       deterministic=True, allow_tf32=False)


def cross_entropy_loss(model, batch: Dict[str, torch.Tensor],
                       compute_dtype=None, training: bool = True,
                       class_weights=None, bn_stats: Optional[list] = None,
                       mesh: Optional[Mesh] = None,
                       apply_kwargs: Optional[Dict] = None):
    """Masked cross-entropy over a (features, labels, mask, lengths) batch.

    ``labels`` are int class ids; ``mask`` (B, T) excludes padding.

    :param class_weights: optional (num_classes,) per-target-class loss
        weights, normalised like torch's weighted CrossEntropyLoss (sum
        of the weights at the targets in the denominator).
    :param bn_stats: passed to a model with batch norm, which appends its
        batch statistics to it.
    :param mesh: ``batch`` is this data rank's rows of a global batch: the
        denominator is the global one (summed over the data group), so the
        returned loss is this rank's share of the global loss, whose sum
        over the data ranks is the loss of the whole batch. The counts
        stay this rank's.
    :param apply_kwargs: extra keyword arguments of the model's forward.
    :returns: (loss, (n_correct, n_total)), 0-d tensors.
    """
    kwargs = dict(apply_kwargs or {})
    if bn_stats is not None:
        kwargs["bn_stats"] = bn_stats
    logits = model(batch["features"], lengths=batch.get("lengths"),
                   normalise=False, compute_dtype=compute_dtype,
                   training=training, **kwargs)
    loss = masked_cross_entropy(
        logits, batch, class_weights,
        group=mesh.data_group if mesh is not None else None)
    pred = torch.argmax(logits, dim=-1)
    n_correct = ((pred == batch["labels"].long()) * batch["mask"]).sum()
    n_total = batch["mask"].sum()
    return loss, (n_correct, n_total)


def masked_cross_entropy(logits: torch.Tensor, batch: Dict[str, torch.Tensor],
                         class_weights=None, group=None) -> torch.Tensor:
    """The loss of :func:`cross_entropy_loss` from (B, T, C) logits; with
    ``group``, over the denominator summed over it."""
    labels = batch["labels"].long()
    mask = batch["mask"].to(logits.dtype)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    if class_weights is not None:
        w = torch.as_tensor(class_weights, dtype=logp.dtype,
                            device=logp.device)[labels] * mask
        num, den, floor = -(ll * w).sum(), w.sum(), 1e-6
    else:
        num, den, floor = -(ll * mask).sum(), mask.sum(), 1.0
    if group is not None:
        den = all_reduce(den.detach().clone(), group)
    return num / torch.clamp(den, min=floor)


def majority_baseline_accuracy(batch: Dict[str, torch.Tensor],
                               mesh: Optional[Mesh] = None):
    """Argmax-of-counts baseline for 10-channel counts batches;
    returns (n_correct, n_total), summed over the data group of
    ``mesh``."""
    x = batch["features"]
    if x.ndim != 3 or x.shape[-1] != 10:
        return torch.zeros(()), torch.zeros(())
    from medaka_tpu_torch.models.majority import MajorityVoteModel
    pred = torch.argmax(MajorityVoteModel()(x), dim=-1)
    n_correct = ((pred == batch["labels"].long()) * batch["mask"]).sum()
    counts = torch.stack([n_correct.float(), batch["mask"].sum().float()])
    if mesh is not None:
        all_reduce(counts, mesh.data_group)
    return counts[0], counts[1]


def global_metrics(mesh: Optional[Mesh], loss, n_correct, n_total):
    """(loss, n_correct, n_total) of the whole batch from this data
    rank's share (one reduction); as they are with one data rank."""
    if mesh is None or mesh.data_group is None:
        return loss, n_correct, n_total
    packed = all_reduce(torch.stack([loss.detach().float(),
                                     n_correct.float(), n_total.float()]),
                        mesh.data_group)
    return packed[0], packed[1], packed[2]


def make_train_step(model, optimizer, compute_dtype=torch.bfloat16,
                    class_weights: Optional[object] = None,
                    mesh: Optional[Mesh] = None):
    """A training step over this rank's rows of a global batch.

    The step takes a batch of tensors on the model's device, computes the
    loss and its gradients with autograd (under
    :func:`deterministic_convolutions`), sums the gradients over the data
    group (one reduction of all of them), and has ``optimizer`` update
    the model's f32 parameters in place (JAX returns new ones). A model
    with batch norm (``has_batch_stats``) reports its batch statistics,
    global over the data group, and the step then moves each conv layer's
    running mean and variance towards them (:func:`update_running_stats`).
    Under a model axis the optimizer's clip takes the norm of the whole
    (gathered) gradient.

    :param optimizer: a :class:`medaka_tpu_torch.training.Optimizer`.
    :param mesh: the ranks (None: one device, nothing reduced).
    :returns: ``step(batch) -> (loss, n_correct, n_total)`` of the global
        batch.
    """
    params = list(model.parameters())
    collect_bn = getattr(model, "has_batch_stats", False)
    kwargs = _tp_kernel_fence(model, mesh)
    data_group = mesh.data_group if mesh is not None else None
    if collect_bn and data_group is not None:
        kwargs["bn_group"] = data_group
    if mesh is not None and mesh.model_group is not None and \
            optimizer.clip is not None:
        cut = sharded_parameters(model)
        optimizer.clip.reduce_squares = lambda squares: [
            all_reduce(s.clone(), mesh.model_group) if c else s
            for s, c in zip(squares, cut)]

    def step(batch):
        for p in params:
            p.grad = None
        stats = [] if collect_bn else None
        with deterministic_convolutions():
            loss, (n_correct, n_total) = cross_entropy_loss(
                model, batch, compute_dtype=compute_dtype, training=True,
                class_weights=class_weights, bn_stats=stats, mesh=mesh,
                apply_kwargs=kwargs)
            loss.backward()
        if data_group is not None:
            sum_gradients(params, data_group)
        apply_updates(params, optimizer)
        if stats:
            update_running_stats(model, stats)
        return global_metrics(mesh, loss.detach(), n_correct, n_total)

    return step


@torch.no_grad()
def sum_gradients(params, group):
    """Sum the parameters' gradients over ``group``, in one reduction of
    their concatenation."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    offset = 0
    for p, g in zip(params, grads):
        p.grad = flat[offset:offset + g.numel()].view_as(g)
        offset += g.numel()


@torch.no_grad()
def update_running_stats(model, stats):
    """running = (1 - momentum) running + momentum batch (momentum
    ``BN_MOMENTUM``), for each conv
    layer's batch-norm mean and variance (``medaka_tpu/parallel``'s train
    step). They are buffers here, so the optimizer never sees them; in
    JAX they are parameter leaves whose gradients are zero, which adam,
    nadam, rmsprop and sgd leave unchanged, so both end the step with the
    same values."""
    for layer, (mean, var) in zip(model.convs, stats):
        bn = layer["bn"]
        bn.mean.copy_((1 - BN_MOMENTUM) * bn.mean
                      + BN_MOMENTUM * mean.to(bn.mean.dtype))
        bn.var.copy_((1 - BN_MOMENTUM) * bn.var
                     + BN_MOMENTUM * var.to(bn.var.dtype))


@torch.no_grad()
def apply_updates(params, optimizer):
    """Add ``optimizer``'s updates for the parameters' gradients to them,
    in place."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    for p, u in zip(params, optimizer.update(grads)):
        p.add_(u.to(p.dtype))


# ---------------------------------------------------------------------------
# Multi-process inference
# ---------------------------------------------------------------------------


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S):
    """Bring up the process group of a multi-process run.

    A no-op for one process, and a logged no-op without a coordinator:
    each process then takes its share of the work
    (:func:`shard_regions`) and writes its own output, with no collective.
    With ``coordinator`` "host:port" (process 0's address), every process
    joins ``init_process_group`` over TCP: nccl when each process has a
    GPU of its own (as many visible GPUs as processes), gloo otherwise.
    """
    if num_processes is None or num_processes <= 1:
        logger.debug("Single-process run; no process group.")
        return
    if coordinator is None:
        logger.info(
            "Process %d/%d running coordinator-less (region striding "
            "only; outputs merge via DataIndex).",
            process_id, num_processes)
        return
    import torch.distributed as dist
    gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if gpus >= num_processes else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id)
    dist.init_process_group(
        backend, init_method="tcp://{}".format(coordinator),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("Initialized process %d/%d (%s).", process_id,
                num_processes, backend)


def shard_regions(regions, num_hosts: int, host_id: int):
    """Deterministic region -> process assignment for multi-process runs:
    every process sorts the same global list and takes a strided slice,
    so the union over processes is exactly the input and any process
    count gives the same outputs."""
    ordered = sorted(regions, key=lambda r: (r.ref_name, r.start or 0))
    return ordered[host_id::num_hosts]
