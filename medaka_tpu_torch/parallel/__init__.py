"""Loss, accuracy and the single-device training step.

Counterpart of ``cross_entropy_loss``, ``majority_baseline_accuracy`` and
``make_train_step`` (with its running batch-norm statistics) in
``medaka_tpu/parallel/__init__.py``, on one device: the mesh, sharding
and multi-device parts are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

#: weight of a batch's statistics in the running batch-norm statistics
#: (torch BatchNorm1d's momentum; ``medaka_tpu`` uses the same)
BN_MOMENTUM = 0.1


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
                       class_weights=None, bn_stats: Optional[list] = None):
    """Masked cross-entropy over a (features, labels, mask, lengths) batch.

    ``labels`` are int class ids; ``mask`` (B, T) excludes padding.

    :param class_weights: optional (num_classes,) per-target-class loss
        weights, normalised like torch's weighted CrossEntropyLoss (sum
        of the weights at the targets in the denominator).
    :param bn_stats: passed to a model with batch norm, which appends its
        batch statistics to it.
    :returns: (loss, (n_correct, n_total)), 0-d tensors.
    """
    kwargs = {} if bn_stats is None else {"bn_stats": bn_stats}
    logits = model(batch["features"], lengths=batch.get("lengths"),
                   normalise=False, compute_dtype=compute_dtype,
                   training=training, **kwargs)
    loss = masked_cross_entropy(logits, batch, class_weights)
    pred = torch.argmax(logits, dim=-1)
    n_correct = ((pred == batch["labels"].long()) * batch["mask"]).sum()
    n_total = batch["mask"].sum()
    return loss, (n_correct, n_total)


def masked_cross_entropy(logits: torch.Tensor, batch: Dict[str, torch.Tensor],
                         class_weights=None) -> torch.Tensor:
    """The loss of :func:`cross_entropy_loss` from (B, T, C) logits."""
    labels = batch["labels"].long()
    mask = batch["mask"].to(logits.dtype)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    if class_weights is not None:
        w = torch.as_tensor(class_weights, dtype=logp.dtype,
                            device=logp.device)[labels] * mask
        return -(ll * w).sum() / torch.clamp(w.sum(), min=1e-6)
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def majority_baseline_accuracy(batch: Dict[str, torch.Tensor]):
    """Argmax-of-counts baseline for 10-channel counts batches;
    returns (n_correct, n_total)."""
    x = batch["features"]
    if x.ndim != 3 or x.shape[-1] != 10:
        return torch.zeros(()), torch.zeros(())
    from medaka_tpu_torch.models.majority import MajorityVoteModel
    pred = torch.argmax(MajorityVoteModel()(x), dim=-1)
    n_correct = ((pred == batch["labels"].long()) * batch["mask"]).sum()
    return n_correct, batch["mask"].sum()


def make_train_step(model, optimizer, compute_dtype=torch.bfloat16,
                    class_weights: Optional[object] = None):
    """A training step on one device.

    The step takes a batch of tensors on the model's device, computes the
    loss and its gradients with autograd (under
    :func:`deterministic_convolutions`), and has ``optimizer`` update the
    model's f32 parameters in place (JAX returns new ones). A model with
    batch norm (``has_batch_stats``) reports its batch statistics, and the
    step then moves each conv layer's running mean and variance towards
    them (:func:`update_running_stats`).

    :param optimizer: a :class:`medaka_tpu_torch.training.Optimizer`.
    :returns: ``step(batch) -> (loss, n_correct, n_total)``.
    """
    params = list(model.parameters())
    collect_bn = getattr(model, "has_batch_stats", False)

    def step(batch):
        for p in params:
            p.grad = None
        stats = [] if collect_bn else None
        with deterministic_convolutions():
            loss, (n_correct, n_total) = cross_entropy_loss(
                model, batch, compute_dtype=compute_dtype, training=True,
                class_weights=class_weights, bn_stats=stats)
            loss.backward()
        apply_updates(params, optimizer)
        if stats:
            update_running_stats(model, stats)
        return loss.detach(), n_correct, n_total

    return step


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
