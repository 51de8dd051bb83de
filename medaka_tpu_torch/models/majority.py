"""Majority-vote baseline model (no learned parameters).

Counterpart of ``medaka_tpu/models/majority.py``. ``train`` logs its
accuracy beside the model's on counts batches; ``prediction.predict``
runs it as a model (the smolecule and tandem workflows' tests do).
"""
from __future__ import annotations

import torch

from medaka_tpu_torch.common import PLP_BASES
from medaka_tpu_torch.models import TorchState, register_model

_B2I = {b: i for i, b in enumerate(PLP_BASES)}


@register_model
class MajorityVoteModel(TorchState):
    """Argmax over strand-summed normalised base counts."""

    input_kind = "counts"

    def __init__(self, time_steps=None, **kwargs):
        """No parameters; kwargs accepted for config compatibility."""
        self.num_classes = 5

    def to_dict(self):
        """Architecture config."""
        return {"type": "MajorityVoteModel", "kwargs": {}}

    def jax_params(self):
        """No parameters (the bundle's weights are empty)."""
        return {}

    def load_jax_params(self, params):
        """No parameters to load."""
        return self

    def params_from_torch_state(self, state):
        """No parameters to import."""
        return {}

    def torch_state_from_params(self, params):
        """No parameters to export."""
        return {}

    def to(self, device):
        """No weights to move (``prediction.Predictor`` places a model)."""
        return self

    def eval(self):
        """No training mode (``prediction.Predictor`` sets eval)."""
        return self

    def __call__(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """Class probabilities (del, A, C, G, T) by direct vote counting."""
        bases = (x[..., _B2I["a"]:_B2I["t"] + 1]
                 + x[..., _B2I["A"]:_B2I["T"] + 1])
        dels = (x[..., _B2I["d"]:_B2I["d"] + 1]
                + x[..., _B2I["D"]:_B2I["D"] + 1])
        out = torch.cat([dels, bases], dim=-1)
        pad = 1.0 - out.sum(dim=-1, keepdim=True)
        return torch.cat([out[..., :1] + pad, out[..., 1:]], dim=-1)

    def check_feature_encoder_compatibility(self, fenc):
        """Counts-style encoders only."""
        from medaka_tpu_torch.features import CountsFeatureEncoder
        if not isinstance(fenc, CountsFeatureEncoder):
            raise ValueError(
                "{} is not a valid feature encoder for "
                "MajorityVoteModel.".format(type(fenc)))
