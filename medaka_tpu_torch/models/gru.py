"""Bidirectional GRU consensus model (counts-matrix input).

Counterpart of ``medaka_tpu/models/gru.py``: a stack of (bi)GRU layers
over (batch, positions, features) pileup counts with a linear head and a
softmax at inference. Weights live in an ``nn.Module`` whose state keys
mirror the JAX parameter pytree (``gru.<layer>.<fwd|bwd>.<w_ih|...>``,
``linear.weight``/``linear.bias``); :func:`params_from_jax` and
:func:`params_to_jax` carry them across.

Routing mirrors ``GRUModel.apply``: bf16 inference of a 2-layer
bidirectional stack goes through the split-path kernels on the GPU (by
default) and through their plain versions on the CPU when
``fused=True``; everything else runs the masked scan of
:mod:`medaka_tpu_torch.ops.rnn`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from medaka_tpu_torch.models import register_model
from medaka_tpu_torch.ops.gru_split import bigru_head_fullfused
from medaka_tpu_torch.ops.rnn import bigru_stack

_GATE_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")


class GRUDirection(nn.Module):
    """Parameters of one direction of one GRU layer (gate order r, z, n)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        k = 1.0 / np.sqrt(hidden_size)

        def param(*shape):
            return nn.Parameter(torch.empty(shape).uniform_(-k, k))

        self.w_ih = param(3 * hidden_size, input_size)
        self.w_hh = param(3 * hidden_size, hidden_size)
        self.b_ih = param(3 * hidden_size)
        self.b_hh = param(3 * hidden_size)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        """{w_ih, w_hh, b_ih, b_hh} as the ops take them."""
        return {k: getattr(self, k) for k in _GATE_KEYS}


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """Map the JAX pytree {"gru": [...], "linear": {w, b}} onto a state dict.

    :param params: nested dicts/lists of numpy arrays, as
        ``medaka_tpu`` bundles and ``GRUModel.init_params`` hold them.
    :returns: a state dict for :class:`GRUModel.load_state_dict`.
    """
    state = {}
    for k, layer in enumerate(params["gru"]):
        for direction, p in layer.items():
            for key in _GATE_KEYS:
                state["gru.{}.{}.{}".format(k, direction, key)] = \
                    torch.as_tensor(np.asarray(p[key], dtype=np.float32))
    state["linear.weight"] = torch.as_tensor(
        np.asarray(params["linear"]["w"], dtype=np.float32))
    state["linear.bias"] = torch.as_tensor(
        np.asarray(params["linear"]["b"], dtype=np.float32))
    return state


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`params_from_jax`: a JAX-layout numpy pytree."""
    layers: List[Dict] = []
    for name, value in state.items():
        parts = name.split(".")
        if parts[0] != "gru":
            continue
        k = int(parts[1])
        while len(layers) <= k:
            layers.append({})
        layers[k].setdefault(parts[2], {})[parts[3]] = \
            value.detach().cpu().numpy()
    return {"gru": layers, "linear": {
        "w": state["linear.weight"].detach().cpu().numpy(),
        "b": state["linear.bias"].detach().cpu().numpy()}}


@register_model
class GRUModel(nn.Module):
    """biGRU consensus network; weights as an ``nn.Module``."""

    input_kind = "counts"

    def __init__(self, num_features=10, num_classes=5, gru_size=128,
                 n_layers=2, bidirectional=True, time_steps=None,
                 classify_activation=None):
        """Mirror the JAX constructor (``time_steps`` and
        ``classify_activation`` are accepted for checkpoint compatibility
        and ignored)."""
        super().__init__()
        self.num_features = num_features
        self.num_classes = num_classes
        self.gru_size = gru_size
        self.n_layers = n_layers
        self.bidirectional = bidirectional
        n_dirs = 2 if bidirectional else 1
        layers = []
        for k in range(n_layers):
            in_size = num_features if k == 0 else gru_size * n_dirs
            dirs = {"fwd": GRUDirection(in_size, gru_size)}
            if bidirectional:
                dirs["bwd"] = GRUDirection(in_size, gru_size)
            layers.append(nn.ModuleDict(dirs))
        self.gru = nn.ModuleList(layers)
        self.linear = nn.Linear(gru_size * n_dirs, num_classes)

    def to_dict(self):
        """Architecture config (the bundle's ``model`` entry)."""
        return {
            "type": "GRUModel",
            "kwargs": {
                "num_features": self.num_features,
                "num_classes": self.num_classes,
                "gru_size": self.gru_size,
                "n_layers": self.n_layers,
                "bidirectional": self.bidirectional,
            }}

    def load_jax_params(self, params):
        """Load a JAX-layout parameter pytree."""
        self.load_state_dict(params_from_jax(params))
        return self

    def layer_params(self) -> List[Dict[str, Dict[str, torch.Tensor]]]:
        """Per-layer {"fwd"/"bwd": {w_ih, ...}} views of the weights."""
        return [{d: m.as_dict() for d, m in layer.items()}
                for layer in self.gru]

    def head_params(self) -> Dict[str, torch.Tensor]:
        """{"w": (C, 2H), "b": (C,)}."""
        return {"w": self.linear.weight, "b": self.linear.bias}

    def forward(self, x: torch.Tensor, lengths=None, normalise: bool = True,
                compute_dtype=None, fused: Optional[bool] = None,
                recurrent_quant: Optional[str] = None) -> torch.Tensor:
        """Forward pass.

        :param x: (batch, positions, num_features) counts features.
        :param lengths: optional (batch,) valid lengths.
        :param normalise: apply softmax (False: logits).
        :param compute_dtype: None (float32) or torch.bfloat16.
        :param fused: use the split-path kernels. Default: on for bf16
            inference on the GPU, off on the CPU (where ``fused=True``
            runs the kernels' plain versions).
        :param recurrent_quant: None/"int8" (int8 split path) or "none"
            (bf16 split path).
        :returns: (batch, positions, num_classes) float32.
        """
        if fused is None:
            fused = compute_dtype == torch.bfloat16 and x.is_cuda
        if fused:
            if not (self.bidirectional and self.n_layers == 2
                    and compute_dtype == torch.bfloat16
                    and recurrent_quant in (None, "int8", "none")):
                raise NotImplementedError(
                    "Only the split-path kernels (2-layer bidirectional, "
                    "bf16) are ported; the fused kernels for this "
                    "configuration (pallas_gru.bigru_pallas_fullfused and "
                    "relatives) are not ported yet.")
            logits = bigru_head_fullfused(
                self.layer_params(), self.head_params(), x,
                lengths=lengths, quant=recurrent_quant != "none",
                device=x.device)
        else:
            feats = bigru_stack(
                self.layer_params(), x, bidirectional=self.bidirectional,
                compute_dtype=compute_dtype, lengths=lengths)
            logits = (feats.float() @ self.linear.weight.float().t()
                      + self.linear.bias.float())
        if normalise:
            return torch.softmax(logits, dim=-1)
        return logits

    def check_feature_encoder_compatibility(self, fenc):
        """Counts-style encoders only."""
        from medaka_tpu_torch.features import CountsFeatureEncoder
        if not isinstance(fenc, CountsFeatureEncoder):
            raise ValueError(
                "{} is not a valid feature encoder for GRUModel.".format(
                    type(fenc)))
