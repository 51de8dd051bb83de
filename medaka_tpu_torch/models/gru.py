"""Bidirectional GRU consensus model (counts-matrix input).

Counterpart of ``medaka_tpu/models/gru.py``: a stack of (bi)GRU layers
over (batch, positions, features) pileup counts with a linear head and a
softmax at inference. Weights live in an ``nn.Module`` whose state keys
mirror the JAX parameter pytree (``gru.<layer>.<fwd|bwd>.<w_ih|...>``,
``linear.weight``/``linear.bias``); :func:`params_from_jax` and
:func:`params_to_jax` carry them across.

Routing mirrors ``GRUModel.apply`` branch by branch (:func:`fused_route`):
fused bf16 inference of a 2-layer bidirectional stack goes through the
split-path kernels on the GPU (by default) where JAX takes them (batch >=
32, hidden a multiple of 128; :func:`takes_split_path`), and through their
plain versions on the CPU at any batch, as JAX's ``interpret=True`` does.
Every other fused bidirectional inference runs the fullfused kernels
(:func:`medaka_tpu_torch.ops.gru_fullfused.bigru_stack_fullfused`, in the
mode ``recurrent_quant`` selects), and a fused unidirectional stack runs
``bigru_stack_fused`` (``gru_fwd``); both end in the f32 head. Training
(``training=True``) with ``fused`` goes through the trainable kernel pair
of :mod:`medaka_tpu_torch.ops.gru_train`. The CPU runs every kernel's
plain version. Everything else runs the masked scan of
:mod:`medaka_tpu_torch.ops.rnn`, under autograd when training.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from medaka_tpu_torch.models import TorchState, register_model, state_array
from medaka_tpu_torch.ops.gru_fullfused import QUANT_MODES, \
    bigru_stack_fullfused, bigru_stack_fused
from medaka_tpu_torch.ops.gru_split import bigru_head_fullfused
from medaka_tpu_torch.ops.gru_train import bigru_stack_trainable
from medaka_tpu_torch.ops.rnn import bigru_stack

_GATE_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")
#: torch.nn.GRU's and nn.LSTM's names of the same tensors
_TORCH_NAMES = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih",
                "b_hh": "bias_hh"}


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


#: smallest batch and hidden-size multiple for which JAX runs the split
#: kernels (``medaka_tpu/models/gru.py:162-169``)
SPLIT_MIN_BATCH = 32
SPLIT_HIDDEN_MULTIPLE = 128


def takes_split_path(batch: int, hidden: int, on_cpu: bool) -> bool:
    """Whether a fused bf16 2-layer bidirectional stack runs the split
    kernels, as ``GRUModel.apply`` in ``medaka_tpu/models/gru.py`` decides.

    JAX runs them for batches of at least 32 rows and hidden sizes that
    are multiples of 128, and runs ``bigru_stack_fullfused`` otherwise;
    under ``interpret=True`` it takes the split path at any shape. The
    port's CPU route (the kernels' plain versions) is the counterpart of
    ``interpret=True``.
    """
    return on_cpu or (batch >= SPLIT_MIN_BATCH
                      and hidden % SPLIT_HIDDEN_MULTIPLE == 0)


def fused_route(batch: int, hidden: int, n_layers: int, bidirectional: bool,
                recurrent_quant: Optional[str], device,
                compute_dtype=torch.bfloat16) -> str:
    """Which kernels fused inference runs, as ``GRUModel.apply`` decides
    (``medaka_tpu/models/gru.py:162-196``).

    :returns: "split" (``bigru_head_fullfused``: a 2-layer bidirectional
        bf16 stack with ``recurrent_quant`` None, "int8" or "none" that
        :func:`takes_split_path`), "fullfused" (any other bidirectional
        stack: ``bigru_stack_fullfused``) or "fused" (a unidirectional
        stack: ``bigru_stack_fused``). The last two end in the f32 head.
    """
    if recurrent_quant not in QUANT_MODES:
        raise ValueError("unknown recurrent_quant {!r}".format(
            recurrent_quant))
    on_cpu = torch.device(device).type != "cuda"
    if (bidirectional and n_layers == 2 and compute_dtype == torch.bfloat16
            and recurrent_quant in (None, "int8", "none")
            and takes_split_path(batch, hidden, on_cpu)):
        return "split"
    return "fullfused" if bidirectional else "fused"


@register_model
class GRUModel(TorchState, nn.Module):
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

    def jax_params(self) -> Dict:
        """The weights as a JAX-layout numpy pytree (for bundles)."""
        return params_to_jax(self.state_dict())

    def params_from_torch_state(self, state: Dict) -> Dict:
        """Map a ``torch.nn.GRU`` + ``Linear`` state dict (the reference
        checkpoint's ``gru.weight_ih_l{k}[_reverse]``, ...,
        ``linear.weight``/``linear.bias``) onto the JAX pytree
        (``medaka_tpu``'s ``GRUModel.params_from_torch_state``)."""
        layers = []
        for k in range(self.n_layers):
            layer = {}
            for key, suffix in (("fwd", ""), ("bwd", "_reverse")):
                if key == "bwd" and not self.bidirectional:
                    continue
                layer[key] = {
                    g: state_array(state, "gru.{}_l{}{}".format(
                        _TORCH_NAMES[g], k, suffix)) for g in _GATE_KEYS}
            layers.append(layer)
        return {"gru": layers, "linear": {
            "w": state_array(state, "linear.weight"),
            "b": state_array(state, "linear.bias")}}

    @staticmethod
    def torch_state_from_params(params: Dict) -> Dict[str, np.ndarray]:
        """Inverse of :meth:`params_from_torch_state` (numpy arrays)."""
        state = {}
        for k, layer in enumerate(params["gru"]):
            for key, suffix in (("fwd", ""), ("bwd", "_reverse")):
                for g in _GATE_KEYS if key in layer else ():
                    state["gru.{}_l{}{}".format(_TORCH_NAMES[g], k, suffix)] \
                        = np.asarray(layer[key][g])
        state["linear.weight"] = np.asarray(params["linear"]["w"])
        state["linear.bias"] = np.asarray(params["linear"]["b"])
        return state

    def layer_params(self) -> List[Dict[str, Dict[str, torch.Tensor]]]:
        """Per-layer {"fwd"/"bwd": {w_ih, ...}} views of the weights."""
        return [{d: m.as_dict() for d, m in layer.items()}
                for layer in self.gru]

    def head_params(self) -> Dict[str, torch.Tensor]:
        """{"w": (C, 2H), "b": (C,)}."""
        return {"w": self.linear.weight, "b": self.linear.bias}

    def forward(self, x: torch.Tensor, lengths=None, normalise: bool = True,
                compute_dtype=None, fused: Optional[bool] = None,
                recurrent_quant: Optional[str] = None,
                training: bool = False, gate_gather=None) -> torch.Tensor:
        """Forward pass.

        :param x: (batch, positions, num_features) counts features.
        :param lengths: optional (batch,) valid lengths.
        :param normalise: apply softmax (False: logits).
        :param compute_dtype: None (float32) or torch.bfloat16.
        :param fused: use the kernels. Default: on for bf16 on the GPU,
            off on the CPU (where ``fused=True`` runs the kernels' plain
            versions).
        :param recurrent_quant: inference only. None/"int8" (int8 split
            path) or "none" (bf16 split path); off the split path None and
            "none" run the f32-gates fullfused kernel, "int8" the int8
            one, "bf16_gates" and "staggered" their fullfused modes (see
            :func:`fused_route`).
        :param training: differentiable route: with ``fused`` the
            trainable kernel pair (bf16 even when ``compute_dtype`` is
            None, as in JAX), else the scan under autograd.
        :param gate_gather: a ``parallel.ModelAxis`` when the recurrent
            weights hold this rank's gate rows (``parallel.shard_model``):
            the scan runs on them, whatever ``fused`` says.
        :returns: (batch, positions, num_classes) float32.
        """
        if gate_gather is not None:
            fused = False
        elif fused is None:
            fused = compute_dtype == torch.bfloat16 and x.is_cuda
        route = None
        if fused and not training:
            route = fused_route(x.shape[0], self.gru_size, self.n_layers,
                                self.bidirectional, recurrent_quant,
                                "cuda" if x.is_cuda else "cpu",
                                compute_dtype)
        if route == "split":
            logits = bigru_head_fullfused(
                self.layer_params(), self.head_params(), x,
                lengths=lengths, quant=recurrent_quant != "none",
                device=x.device)
        else:
            if fused and training:
                feats = bigru_stack_trainable(
                    self.layer_params(), x, lengths=lengths,
                    compute_dtype=compute_dtype,
                    bidirectional=self.bidirectional)
            elif route == "fullfused":
                feats = bigru_stack_fullfused(
                    self.layer_params(), x, lengths=lengths,
                    recurrent_quant=recurrent_quant, device=x.device)
            elif route == "fused":
                feats = bigru_stack_fused(
                    self.layer_params(), x, bidirectional=False,
                    lengths=lengths, device=x.device)
            else:
                feats = bigru_stack(
                    self.layer_params(), x, bidirectional=self.bidirectional,
                    compute_dtype=compute_dtype, lengths=lengths,
                    gather=gate_gather)
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
