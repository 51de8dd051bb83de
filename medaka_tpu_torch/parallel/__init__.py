"""Loss, accuracy and the single-device training step.

Counterpart of ``cross_entropy_loss``, ``majority_baseline_accuracy`` and
``make_train_step`` in ``medaka_tpu/parallel/__init__.py``, on one
device: the mesh, sharding and multi-device parts are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def cross_entropy_loss(model, batch: Dict[str, torch.Tensor],
                       compute_dtype=None, training: bool = True,
                       class_weights=None):
    """Masked cross-entropy over a (features, labels, mask, lengths) batch.

    ``labels`` are int class ids; ``mask`` (B, T) excludes padding.

    :param class_weights: optional (num_classes,) per-target-class loss
        weights, normalised like torch's weighted CrossEntropyLoss (sum
        of the weights at the targets in the denominator).
    :returns: (loss, (n_correct, n_total)), 0-d tensors.
    """
    logits = model(batch["features"], lengths=batch.get("lengths"),
                   normalise=False, compute_dtype=compute_dtype,
                   training=training)
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
    loss and its gradients with autograd, and has ``optimizer`` update
    the model's f32 parameters in place (JAX returns new ones).

    :param optimizer: a :class:`medaka_tpu_torch.training.Optimizer`.
    :returns: ``step(batch) -> (loss, n_correct, n_total)``.
    """
    params = list(model.parameters())

    def step(batch):
        for p in params:
            p.grad = None
        loss, (n_correct, n_total) = cross_entropy_loss(
            model, batch, compute_dtype=compute_dtype, training=True,
            class_weights=class_weights)
        loss.backward()
        apply_updates(params, optimizer)
        return loss.detach(), n_correct, n_total

    return step


@torch.no_grad()
def apply_updates(params, optimizer):
    """Add ``optimizer``'s updates for the parameters' gradients to them,
    in place."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    for p, u in zip(params, optimizer.update(grads)):
        p.add_(u.to(p.dtype))
