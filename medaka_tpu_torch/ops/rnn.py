"""Masked GRU and LSTM scans in plain PyTorch (torch.nn gate semantics).

Counterpart of ``gru_scan``/``bigru_stack`` and ``lstm_scan``/
``bilstm_stack`` in ``medaka_tpu/ops/rnn.py``. Gate order is (r, z, n)
for the GRU and (i, f, g, o) for the LSTM; the carry freezes at
t >= length, so outputs on the valid prefix equal an unpadded run. With
``compute_dtype=None`` everything runs in float32; with bfloat16 the
inputs, weights and biases are cast first and every step runs in bf16, as
the JAX scans do. These are the CPU routes of ``GRUModel`` and
``LatentSpaceLSTM`` and their full-precision routes on the GPU; both
scans also run under autograd, the f32 training routes of ``GRUModel``
and ``LatentSpaceLSTM`` (the counterpart of JAX autodiff through
``bigru_stack`` and ``bilstm_stack``).

Under a model axis (``parallel.ModelAxis`` as ``gather``) the weights
hold this rank's gate rows: each product with them is gathered to the
whole gates, so every rank runs the same recurrence on them.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def gru_scan(params: Dict[str, torch.Tensor], x: torch.Tensor,
             reverse: bool = False, compute_dtype=None,
             lengths=None, gather=None) -> torch.Tensor:
    """Run one GRU direction over a batch.

    :param params: w_ih (3H, in), w_hh (3H, H), b_ih, b_hh.
    :param x: (batch, time, features).
    :param reverse: walk time backwards (outputs stay time-aligned).
    :param compute_dtype: None (float32) or e.g. torch.bfloat16.
    :param lengths: optional (batch,) valid lengths.
    :param gather: a ``parallel.ModelAxis`` when the weights hold this
        rank's gate rows.
    :returns: (batch, time, hidden).
    """
    dtype = torch.float32 if compute_dtype is None else compute_dtype
    x = x.to(dtype)
    w_ih, w_hh, b_ih, b_hh = (
        params[k].to(device=x.device, dtype=dtype)
        for k in ("w_ih", "w_hh", "b_ih", "b_hh"))
    batch, steps, _ = x.shape
    hidden = w_hh.shape[1]
    x_proj = _project(x, w_ih, b_ih, gather)
    w_hh_t = w_hh.t()
    h = torch.zeros((batch, hidden), dtype=dtype, device=x.device)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=x.device).reshape(batch, 1)
    order = range(steps - 1, -1, -1) if reverse else range(steps)
    # the steps' outputs are stacked once at the end (not written into a
    # preallocated tensor), so autograd records one node for them: the
    # f32 training route differentiates through this scan
    outs = []
    for t in order:
        hp = _recur(h, w_hh_t, b_hh, gather)
        xr, xz, xn = x_proj[:, t].chunk(3, dim=-1)
        hr, hz, hn = hp.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        h = h_new if lengths is None else torch.where(t < lengths, h_new, h)
        outs.append(h)
    if reverse:
        outs.reverse()
    if not outs:
        return torch.empty((batch, 0, hidden), dtype=dtype, device=x.device)
    return torch.stack(outs, dim=1)


def _project(x, w_ih, b_ih, gather):
    """The input projection (B, T, G) of the gate rows the weights hold,
    gathered to all gates under a model axis."""
    if gather is None:
        return torch.einsum("bti,hi->bth", x, w_ih) + b_ih
    return gather.gates(torch.einsum("bti,hi->bth", gather.enter(x), w_ih)
                        + b_ih)


def _recur(h, w_hh_t, b_hh, gather):
    """The recurrent product of a step, as :func:`_project`."""
    if gather is None:
        return h @ w_hh_t + b_hh
    return gather.gates(gather.enter(h) @ w_hh_t + b_hh)


def bigru_stack(layers: Sequence[Dict], x: torch.Tensor,
                bidirectional: bool = True, compute_dtype=None,
                lengths=None, gather=None) -> torch.Tensor:
    """Apply a stack of (bi)GRU layers; see :func:`gru_scan`.

    :param layers: per-layer {"fwd": params, "bwd": params} dicts.
    :returns: (batch, time, hidden * n_dirs) features of the last layer.
    """
    out = x
    for layer in layers:
        fwd = gru_scan(layer["fwd"], out, reverse=False,
                       compute_dtype=compute_dtype, lengths=lengths,
                       gather=gather)
        if bidirectional:
            bwd = gru_scan(layer["bwd"], out, reverse=True,
                           compute_dtype=compute_dtype, lengths=lengths,
                           gather=gather)
            out = torch.cat([fwd, bwd], dim=-1)
        else:
            out = fwd
    return out


def lstm_scan(params: Dict[str, torch.Tensor], x: torch.Tensor,
              reverse: bool = False, compute_dtype=None,
              lengths=None, gather=None) -> torch.Tensor:
    """Run one LSTM direction over a batch (gate order i, f, g, o).

    :param params: w_ih (4H, in), w_hh (4H, H), b_ih, b_hh.
    :param x: (batch, time, features).
    :param reverse: walk time backwards (outputs stay time-aligned).
    :param compute_dtype: None (float32) or e.g. torch.bfloat16.
    :param lengths: optional (batch,) valid lengths; h and c freeze at
        padded steps.
    :param gather: as :func:`gru_scan`.
    :returns: (batch, time, hidden).
    """
    dtype = torch.float32 if compute_dtype is None else compute_dtype
    x = x.to(dtype)
    w_ih, w_hh, b_ih, b_hh = (
        params[k].to(device=x.device, dtype=dtype)
        for k in ("w_ih", "w_hh", "b_ih", "b_hh"))
    batch, steps, _ = x.shape
    hidden = w_hh.shape[1]
    x_proj = _project(x, w_ih, b_ih, gather)
    w_hh_t = w_hh.t()
    h = torch.zeros((batch, hidden), dtype=dtype, device=x.device)
    c = torch.zeros_like(h)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=x.device).reshape(batch, 1)
    order = range(steps - 1, -1, -1) if reverse else range(steps)
    # stacked once at the end, as in gru_scan: the f32 training route of
    # LatentSpaceLSTM differentiates through this scan
    outs = []
    for t in order:
        gates = x_proj[:, t] + _recur(h, w_hh_t, b_hh, gather)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        if lengths is None:
            h, c = h_new, c_new
        else:
            valid = t < lengths
            h = torch.where(valid, h_new, h)
            c = torch.where(valid, c_new, c)
        outs.append(h)
    if reverse:
        outs.reverse()
    if not outs:
        return torch.empty((batch, 0, hidden), dtype=dtype, device=x.device)
    return torch.stack(outs, dim=1)


def bilstm_stack(layers: Sequence[Dict], x: torch.Tensor,
                 bidirectional: bool = True, compute_dtype=None,
                 lengths=None, gather=None) -> torch.Tensor:
    """Apply a stack of (bi)LSTM layers; see :func:`lstm_scan`.

    :param layers: per-layer {"fwd": params, "bwd": params} dicts.
    :returns: (batch, time, hidden * n_dirs) features of the last layer.
    """
    out = x
    for layer in layers:
        fwd = lstm_scan(layer["fwd"], out, reverse=False,
                        compute_dtype=compute_dtype, lengths=lengths,
                        gather=gather)
        if bidirectional:
            bwd = lstm_scan(layer["bwd"], out, reverse=True,
                            compute_dtype=compute_dtype, lengths=lengths,
                            gather=gather)
            out = torch.cat([fwd, bwd], dim=-1)
        else:
            out = fwd
    return out
