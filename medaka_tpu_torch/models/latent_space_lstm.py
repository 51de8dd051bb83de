"""Read-level latent-space LSTM consensus model.

Counterpart of ``medaka_tpu/models/latent_space_lstm.py``: base and
strand embeddings summed, scaled qscores (and optional dwells) appended,
per-read 1-D convolutions along positions with ReLU and batch norm
(running statistics), a masked mean-pool over the non-empty read rows
followed by the linear expansion ``pre_pool``, a 2-layer bidirectional
LSTM (or 4 alternately reversed unidirectional layers) and a float32
linear head.

Weights live in an ``nn.Module`` whose state keys mirror the JAX
parameter pytree with ``.`` for ``/`` (``base_embed``,
``convs.<k>.conv.w``, ``convs.<k>.bn.mean``, ``pre_pool.w``,
``lstm.<k>.fwd.w_ih``, ``linear.b``, ...); :func:`params_from_jax` and
:func:`params_to_jax` carry them across.

Routing mirrors ``LatentSpaceLSTM.apply``: bf16 inference of the
bidirectional stack runs :func:`medaka_tpu_torch.ops.bilstm
.bilstm_stack_fused` (the ``bilstm_fused`` CUDA kernel) on the GPU by
default and its plain version on the CPU when ``fused=True``; otherwise
the masked scan of :mod:`medaka_tpu_torch.ops.rnn` runs. The
unidirectional stack always runs the scan. Training-mode batch norm is
not ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from medaka_tpu_torch.models import _flatten, _unflatten, register_model
from medaka_tpu_torch.ops.bilstm import bilstm_stack_fused
from medaka_tpu_torch.ops.rnn import bilstm_stack, lstm_scan


def _uniform(bound: float, *shape) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound)


class ParamGroup(nn.Module):
    """One node of the parameter pytree: named parameters and, for batch
    norm's running statistics, named buffers."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 buffers: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value))
        for name, value in (buffers or {}).items():
            self.register_buffer(name, value)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        """The node's tensors by name, as the ops take them."""
        out = dict(self.named_parameters(recurse=False))
        out.update(self.named_buffers(recurse=False))
        return out


def _linear(in_f: int, out_f: int) -> ParamGroup:
    k = 1.0 / np.sqrt(in_f)
    return ParamGroup({"w": _uniform(k, out_f, in_f), "b": _uniform(k, out_f)})


def _lstm_direction(in_size: int, hidden: int) -> ParamGroup:
    k = 1.0 / np.sqrt(hidden)
    return ParamGroup({
        "w_ih": _uniform(k, 4 * hidden, in_size),
        "w_hh": _uniform(k, 4 * hidden, hidden),
        "b_ih": _uniform(k, 4 * hidden), "b_hh": _uniform(k, 4 * hidden)})


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """Map the JAX ``LatentSpaceLSTM`` pytree onto a state dict.

    :param params: nested dicts/lists of numpy arrays, as ``medaka_tpu``
        bundles and ``LatentSpaceLSTM.init_params`` hold them.
    :returns: a state dict for :meth:`LatentSpaceLSTM.load_state_dict`.
    """
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in _flatten(params, sep=".").items()}


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`params_from_jax`: a JAX-layout numpy pytree."""
    return _unflatten({k: v.detach().cpu().numpy()
                       for k, v in state.items()}, sep=".")


def _conv1d_f32acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """"SAME" NCW convolution with f32 accumulation, rounded once to
    ``x.dtype`` (``_conv1d_f32acc`` of the JAX module).

    cuDNN accumulates bf16 operands in f32; every other case runs in f32
    with TF32 off and casts the result.
    """
    if x.is_cuda and x.dtype == torch.bfloat16:
        return F.conv1d(x, w.to(x.dtype), padding="same")
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv1d(x.float(), w.to(x.dtype).float(),
                        padding="same").to(x.dtype)


@register_model
class LatentSpaceLSTM(nn.Module):
    """Read-level consensus network; weights as an ``nn.Module``."""

    input_kind = "reads"

    def __init__(self, num_classes=5, lstm_size=128, cnn_size=128,
                 kernel_sizes=(1, 17), pooler_type="mean", pooler_args=None,
                 use_dwells=False, bases_alphabet_size=6,
                 bases_embedding_size=6, bidirectional=True,
                 time_steps=None):
        """Mirror the JAX constructor (``time_steps`` is accepted for
        checkpoint compatibility and ignored)."""
        super().__init__()
        if pooler_type != "mean":
            raise NotImplementedError(
                "Only mean pooling is implemented (as in the reference).")
        self.num_classes = num_classes
        self.lstm_size = lstm_size
        self.cnn_size = cnn_size
        self.kernel_sizes = list(kernel_sizes)
        self.pooler_type = pooler_type
        self.pooler_args = dict(pooler_args or {})
        self.use_dwells = use_dwells
        self.bases_alphabet_size = bases_alphabet_size
        self.bases_embedding_size = bases_embedding_size
        self.bidirectional = bidirectional

        self.base_embed = nn.Parameter(
            torch.randn(bases_alphabet_size, bases_embedding_size))
        self.strand_embed = nn.Parameter(
            torch.randn(3, bases_embedding_size))
        convs = []
        ch_in = bases_embedding_size + 1 + int(use_dwells)
        for ksize in self.kernel_sizes:
            k = 1.0 / np.sqrt(ch_in * ksize)
            convs.append(nn.ModuleDict({
                "conv": ParamGroup({"w": _uniform(k, cnn_size, ch_in, ksize),
                                    "b": _uniform(k, cnn_size)}),
                "bn": ParamGroup(
                    {"scale": torch.ones(cnn_size),
                     "bias": torch.zeros(cnn_size)},
                    {"mean": torch.zeros(cnn_size),
                     "var": torch.ones(cnn_size)})}))
            ch_in = cnn_size
        self.convs = nn.ModuleList(convs)
        self.pre_pool = _linear(cnn_size, lstm_size)
        n_dirs = 2 if bidirectional else 1
        if bidirectional:
            layers = [nn.ModuleDict({
                "fwd": _lstm_direction(lstm_size * (1 if k == 0 else 2),
                                       lstm_size),
                "bwd": _lstm_direction(lstm_size * (1 if k == 0 else 2),
                                       lstm_size)}) for k in range(2)]
        else:
            # 4 alternately reversed single-direction layers (reference
            # ReversibleLSTM stack)
            layers = [nn.ModuleDict({"fwd": _lstm_direction(lstm_size,
                                                            lstm_size)})
                      for _ in range(4)]
        self.lstm = nn.ModuleList(layers)
        self.linear = _linear(lstm_size * n_dirs, num_classes)

    def to_dict(self):
        """Architecture config (the bundle's ``model`` entry)."""
        return {
            "type": "LatentSpaceLSTM",
            "kwargs": {
                "num_classes": self.num_classes,
                "lstm_size": self.lstm_size,
                "cnn_size": self.cnn_size,
                "kernel_sizes": self.kernel_sizes,
                "pooler_type": self.pooler_type,
                "pooler_args": self.pooler_args,
                "use_dwells": self.use_dwells,
                "bases_alphabet_size": self.bases_alphabet_size,
                "bases_embedding_size": self.bases_embedding_size,
                "bidirectional": self.bidirectional,
            }}

    def load_jax_params(self, params):
        """Load a JAX-layout parameter pytree."""
        self.load_state_dict(params_from_jax(params))
        return self

    def jax_params(self) -> Dict:
        """The weights as a JAX-layout numpy pytree (for bundles)."""
        return params_to_jax(self.state_dict())

    def layer_params(self) -> List[Dict[str, Dict[str, torch.Tensor]]]:
        """Per-layer {"fwd"(/"bwd"): {w_ih, w_hh, b_ih, b_hh}} views."""
        return [{d: m.as_dict() for d, m in layer.items()}
                for layer in self.lstm]

    # --- forward, by stage ---

    def read_features(self, x: torch.Tensor, compute_dtype=None):
        """Embeddings, per-read convolutions, ReLU and batch norm.

        :param x: (B, P, R, C) read-level features (int8 or float).
        :returns: ((B*R, cnn_size, P) features in the compute dtype,
            (B, R) bool mask of the non-empty read rows).
        """
        cd = compute_dtype or torch.float32
        B, P, R, C = x.shape
        needed = 5 if self.use_dwells else 4
        if C < needed:
            raise ValueError(
                "Read-level features need {} channels "
                "[base, qual, strand, mapq{}]; got {}.".format(
                    needed, ", dwell" if self.use_dwells else "", C))
        xf = x.float()
        # read rows that hold any data (reference latent_space_lstm.py:164)
        non_empty = xf.abs().sum(dim=(1, 3)) != 0
        emb = (self.base_embed.float()[x[..., 0].long()]
               + self.strand_embed.float()[x[..., 2].long() + 1])
        parts = [emb, (xf[..., 1] / 25.0 - 1.0)[..., None]]
        if self.use_dwells:
            parts.append(xf[..., 4][..., None])
        feats = torch.cat(parts, dim=-1)                     # (B, P, R, F)
        del emb, parts, xf
        feats = feats.permute(0, 2, 3, 1).reshape(B * R, -1, P).to(cd)
        for layer in self.convs:
            conv, bn = layer["conv"], layer["bn"]
            feats = _conv1d_f32acc(feats, conv.w)
            # in place: the same bf16 roundings as the JAX expressions,
            # with one live activation beside the convolution's input
            feats.add_(conv.b.to(cd)[:, None]).relu_()
            rstd = torch.rsqrt(bn.var.to(cd).float() + 1e-5).to(cd)
            feats.sub_(bn.mean.to(cd)[:, None]).mul_(rstd[:, None])
            feats.mul_(bn.scale.to(cd)[:, None]).add_(
                bn.bias.to(cd)[:, None])
        return feats, non_empty

    def pool(self, feats: torch.Tensor, non_empty: torch.Tensor,
             compute_dtype=None) -> torch.Tensor:
        """Masked mean over the non-empty read rows, then ``pre_pool``.

        The pool comes first (``latent_space_lstm.py:381-397``): the
        linear expansion is affine and the pool a masked mean, so they
        commute. Overwrites ``feats``.

        :returns: (B, P, lstm_size) in the compute dtype.
        """
        cd = compute_dtype or torch.float32
        B, R = non_empty.shape
        _, C, P = feats.shape
        mask = non_empty.to(cd)[:, :, None, None]
        denom = torch.clamp(mask.sum(dim=1), min=1.0)
        pooled = feats.view(B, R, C, P).mul_(mask).sum(dim=1) / denom
        w = self.pre_pool.w.to(cd).float()
        return ((pooled.transpose(1, 2).float() @ w.t()).to(cd)
                + self.pre_pool.b.to(cd))

    def recurrent(self, pooled: torch.Tensor, lengths=None,
                  compute_dtype=None, fused: Optional[bool] = None):
        """The LSTM stack; (B, P, lstm_size * n_dirs)."""
        if fused is None:
            fused = compute_dtype == torch.bfloat16 and pooled.is_cuda
        if not self.bidirectional:
            out = pooled
            for i, layer in enumerate(self.lstm):
                # reverse-forward-reverse-forward interleave
                out = lstm_scan(layer["fwd"].as_dict(), out,
                                reverse=(i % 2 == 0),
                                compute_dtype=compute_dtype, lengths=lengths)
            return out
        if fused:
            return bilstm_stack_fused(self.layer_params(), pooled,
                                      lengths=lengths,
                                      compute_dtype=compute_dtype)
        return bilstm_stack(self.layer_params(), pooled,
                            compute_dtype=compute_dtype, lengths=lengths)

    def head(self, out: torch.Tensor) -> torch.Tensor:
        """The float32 linear head: (B, P, num_classes) logits."""
        return out.float() @ self.linear.w.float().t() + self.linear.b.float()

    def forward(self, x: torch.Tensor, lengths=None, normalise: bool = True,
                compute_dtype=None, fused: Optional[bool] = None,
                training: bool = False) -> torch.Tensor:
        """Forward pass.

        :param x: (batch, positions, reads, channels) read-level features;
            channels [base, qual, strand, mapq(, dwell)].
        :param lengths: optional (batch,) valid lengths.
        :param normalise: apply softmax (False: logits).
        :param compute_dtype: None (float32) or torch.bfloat16.
        :param fused: run the bidirectional stack through
            ``bilstm_stack_fused``. Default: on for bf16 on the GPU, off
            on the CPU (where ``fused=True`` runs the kernel's plain
            version).
        :param training: batch-norm batch statistics; not ported.
        :returns: (batch, positions, num_classes) float32.
        """
        if training:
            raise NotImplementedError(
                "Training-mode batch norm and bilstm_stack_trainable "
                "(lstm_pallas, lstm_bwd_pallas) are not ported yet.")
        feats, non_empty = self.read_features(x, compute_dtype)
        pooled = self.pool(feats, non_empty, compute_dtype)
        del feats
        logits = self.head(self.recurrent(pooled, lengths, compute_dtype,
                                          fused))
        if normalise:
            return torch.softmax(logits, dim=-1)
        return logits

    def check_feature_encoder_compatibility(self, fenc):
        """Read-level encoders, single dtype, dwell agreement."""
        from medaka_tpu_torch.features import ReadAlignmentFeatureEncoder
        name = type(self).__name__
        if not isinstance(fenc, ReadAlignmentFeatureEncoder):
            raise ValueError(
                "{} expects a ReadAlignmentFeatureEncoder.".format(name))
        if len(fenc.dtypes) > 1:
            raise NotImplementedError(
                "{} supports only one dtype.".format(name))
        if self.use_dwells and not getattr(fenc, "include_dwells", False):
            raise ValueError(
                "Model expects dwells but the encoder does not include "
                "them.")
