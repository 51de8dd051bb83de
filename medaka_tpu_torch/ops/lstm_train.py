"""Trainable LSTM directions: forward and backward kernels joined by autograd.

Counterpart of the "Trainable LSTM" section of
``medaka_tpu/ops/pallas_gru.py`` (``lstm_pallas``, ``lstm_bwd_pallas``,
``lstm_dir_trainable``, ``bilstm_stack_trainable``). Two CUDA kernels in
``csrc/lstm_train.cu`` replace two TPU kernels:

- :func:`lstm_fwd` (TPU kernel ``lstm_pallas``): one LSTM direction over
  pre-projected inputs (gates i, f, g, o), f32 h and c frozen where
  t >= length, bf16 outputs and the f32 cell states;
  :func:`lstm_fwd_plain` is its plain version.
- :func:`lstm_bwd` (TPU kernel ``lstm_bwd_pallas``): its backward, which
  recomputes the gates from the forward's bf16 outputs and f32 cell
  states, carries dh and dc through time and returns ``dxp`` and
  ``dW_hh``/``db_hh`` summed over the batch and time in a fixed order;
  :func:`lstm_bwd_plain` is its plain version.
- :class:`LSTMDirection`: the ``torch.autograd.Function`` joining them
  (``lstm_dir_trainable``), and :func:`bilstm_stack_trainable`, the stack
  (input projections in PyTorch: f32 accumulation plus the f32 ``b_ih``,
  cast once to the compute dtype, as the JAX function computes them).

The step loop, the tiling and the weight layouts are those of
:mod:`medaka_tpu_torch.ops.gru_train`, whose helpers this module shares.
Each wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from medaka_tpu_torch.ops import cuda_build
from medaka_tpu_torch.ops.gru_train import (
    _choose, _cols_layout, _h_prev, _order, _rows_layout, _sigmoid,
    _split_count, project)

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"lstm_fwd": 0, "lstm_bwd": 0}

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int


def reset_launches():
    """Set the launch counts to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _gates(gates, H):
    """sigmoid(i), sigmoid(f), tanh(g), sigmoid(o) of (B, 4H) f32 gates."""
    return (_sigmoid(gates[:, :H]), _sigmoid(gates[:, H:2 * H]),
            torch.tanh(gates[:, 2 * H:3 * H]), _sigmoid(gates[:, 3 * H:]))


def lstm_fwd_plain(x_proj, w_hh, b_hh, lengths, reverse=False):
    """Plain version of :func:`lstm_fwd` (same arguments).

    On a CUDA device it needs ``torch.backends.cuda.matmul.allow_tf32``
    off (the default) to compute the recurrent product in f32.
    """
    T, B, G = x_proj.shape
    H = G // 4
    dev = x_proj.device
    w_t = w_hh.to(device=dev, dtype=torch.bfloat16).float().t()   # (H, 4H)
    b = b_hh.to(dev).float()
    lens = lengths.to(device=dev, dtype=torch.int32).reshape(B, 1)
    h = torch.zeros((B, H), dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    out = torch.empty((T, B, H), dtype=torch.bfloat16, device=dev)
    c_out = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    for t in _order(T, reverse):
        gates = h.to(torch.bfloat16).float() @ w_t + b + x_proj[t].float()
        gi, gf, gg, go = _gates(gates, H)
        c_new = gf * c + gi * gg
        h_new = go * torch.tanh(c_new)
        valid = t < lens
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        out[t] = h.to(torch.bfloat16)
        c_out[t] = c
    return out, c_out


def lstm_bwd_plain(x_proj, h_out, c_out, dh_out, w_hh, b_hh, lengths,
                   reverse=False):
    """Plain version of :func:`lstm_bwd` (same arguments)."""
    T, B, G = x_proj.shape
    H = G // 4
    dev = x_proj.device
    w = w_hh.to(device=dev, dtype=torch.bfloat16).float()           # (4H, H)
    w_t = w.t()
    b = b_hh.to(dev).float()
    lens = lengths.to(device=dev, dtype=torch.int32).reshape(B, 1)
    h_prev = _h_prev(h_out.to(torch.bfloat16), reverse)
    c_prev = _h_prev(c_out.float(), reverse)
    dh = torch.zeros((B, H), dtype=torch.float32, device=dev)
    dc = torch.zeros_like(dh)
    dxp = torch.empty((T, B, G), dtype=torch.float32, device=dev)
    dw = torch.zeros((G, H), dtype=torch.float32, device=dev)
    db = torch.zeros((G,), dtype=torch.float32, device=dev)
    # the backward walks opposite to the forward
    for t in _order(T, not reverse):
        hp = h_prev[t].float()
        cp = c_prev[t]
        dh = dh + dh_out[t].float()
        gi, gf, gg, go = _gates(hp @ w_t + b + x_proj[t].float(), H)
        c_t = gf * cp + gi * gg
        th = torch.tanh(c_t)
        valid = (t < lens).float()
        do_pre = (dh * th) * go * (1.0 - go)
        dc_tot = dc + dh * go * (1.0 - th * th)
        di_pre = (dc_tot * gg) * gi * (1.0 - gi)
        df_pre = (dc_tot * cp) * gf * (1.0 - gf)
        dg_pre = (dc_tot * gi) * (1.0 - gg * gg)
        dgates = torch.cat([di_pre, df_pre, dg_pre, do_pre], dim=-1) * valid
        dxp[t] = dgates
        dg_b = dgates.to(torch.bfloat16).float()
        dw += dg_b.t() @ hp
        db += dgates.sum(0)
        dh = dg_b @ w + dh * (1.0 - valid)
        dc = dc_tot * gf * valid + dc * (1.0 - valid)
    return dxp, dw, db


def build():
    """Compile (if needed) and load the kernel library; returns it."""
    lib = cuda_build.load_library("lstm_train.cu")
    if not getattr(lib, "_medaka_typed", False):
        lib.lstm_fwd_launch.argtypes = [_VOIDP] * 6 + [_INT] * 7 + [_VOIDP]
        lib.lstm_fwd_launch.restype = _INT
        lib.lstm_bwd_launch.argtypes = [_VOIDP] * 14 + [_INT] * 8 + [_VOIDP]
        lib.lstm_bwd_launch.restype = _INT
        for name in ("lstm_fwd_smem", "lstm_bwd_smem"):
            fn = getattr(lib, name)
            fn.argtypes = [_INT] * 3
            fn.restype = ctypes.c_size_t
        lib.lstm_train_error_string.argtypes = [_INT]
        lib.lstm_train_error_string.restype = ctypes.c_char_p
        lib._medaka_typed = True
    return lib


def _raise(lib, name, err):
    raise RuntimeError("{} launch failed: {} (cudaError {})".format(
        name, lib.lstm_train_error_string(err).decode(), err))


def _launch_fwd(x_proj, w_hh, b_hh, lengths, reverse):
    T, B, G = x_proj.shape
    H = G // 4
    cuda_build.check_inputs("lstm_fwd", H, [
        (x_proj, (T, B, G), torch.bfloat16), (w_hh, (G, H), None),
        (b_hh, (G,), None), (lengths, (B,), None)])
    dev = x_proj.device
    out = torch.empty((T, B, H), dtype=torch.bfloat16, device=dev)
    c_out = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    if T == 0 or B == 0:
        return out, c_out
    lib = build()
    try:
        cpt, nq, w_smem, _ = _choose(lib, lib.lstm_fwd_smem, B, H, dev)
    except ValueError as e:
        raise ValueError("lstm_fwd: {}".format(e)) from None
    x_proj = x_proj.contiguous()
    w_rows = _rows_layout(w_hh)
    b_hh = b_hh.float().contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lstm_fwd_launch(
        x_proj.data_ptr(), w_rows.data_ptr(), b_hh.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), c_out.data_ptr(), T, B, H, cpt,
        nq, int(w_smem), int(reverse), stream)
    if err != 0:
        _raise(lib, "lstm_fwd", err)
    LAUNCHES["lstm_fwd"] += 1
    return out, c_out


def lstm_fwd(x_proj, w_hh, b_hh, lengths, reverse=False):
    """One LSTM direction over pre-projected inputs.

    :param x_proj: (T, B, 4H) bf16 projections ``x W_ih^T + b_ih``.
    :param w_hh: (4H, H) recurrent weights; cast to bf16.
    :param b_hh: (4H,) recurrent bias, used in f32.
    :param lengths: (B,) valid lengths; h and c freeze at t >= length.
    :param reverse: walk time back to front (outputs in natural order).
    :returns: ((T, B, H) bf16 outputs, (T, B, H) f32 cell states).
    """
    if x_proj.is_cuda:
        return _launch_fwd(x_proj, w_hh, b_hh, lengths, reverse)
    return lstm_fwd_plain(x_proj, w_hh, b_hh, lengths, reverse)


def _launch_bwd(x_proj, h_out, c_out, dh_out, w_hh, b_hh, lengths, reverse):
    T, B, G = x_proj.shape
    H = G // 4
    cuda_build.check_inputs("lstm_bwd", H, [
        (x_proj, (T, B, G), torch.bfloat16),
        (h_out, (T, B, H), torch.bfloat16),
        (c_out, (T, B, H), torch.float32),
        (dh_out, (T, B, H), torch.float32), (w_hh, (G, H), None),
        (b_hh, (G,), None), (lengths, (B,), None)])
    dev = x_proj.device
    dxp = torch.empty((T, B, G), dtype=torch.float32, device=dev)
    dw = torch.zeros((G, H), dtype=torch.float32, device=dev)
    db = torch.zeros((G,), dtype=torch.float32, device=dev)
    if T == 0 or B == 0:
        return dxp, dw, db
    lib = build()
    try:
        cpt, nq, w_smem, n_sm = _choose(lib, lib.lstm_bwd_smem, B, H, dev)
    except ValueError as e:
        raise ValueError("lstm_bwd: {}".format(e)) from None
    splits = _split_count(B, T, H, n_sm, gates=4)
    parts = -(-B // (cpt * nq)) * nq
    # scratch: bf16(dgates) for the dW tiles, per-(block, q) db_hh sums
    # and per-split dW_hh tiles, all summed in a fixed order by the kernels
    dg = torch.empty((T, B, G), dtype=torch.bfloat16, device=dev)
    db_part = torch.empty((parts, G), dtype=torch.float32, device=dev)
    dw_part = torch.empty((splits, G, H), dtype=torch.float32, device=dev)
    x_proj = x_proj.contiguous()
    h_out = h_out.contiguous()
    c_out = c_out.contiguous()
    dh_out = dh_out.contiguous()
    w_rows = _rows_layout(w_hh)
    w_cols = _cols_layout(w_hh)
    b_hh = b_hh.float().contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lstm_bwd_launch(
        x_proj.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        dh_out.data_ptr(), w_rows.data_ptr(), w_cols.data_ptr(),
        b_hh.data_ptr(), lengths.data_ptr(), dxp.data_ptr(), dg.data_ptr(),
        db_part.data_ptr(), dw_part.data_ptr(), dw.data_ptr(), db.data_ptr(),
        T, B, H, cpt, nq, int(w_smem), int(reverse), splits, stream)
    if err != 0:
        _raise(lib, "lstm_bwd", err)
    LAUNCHES["lstm_bwd"] += 1
    return dxp, dw, db


def lstm_bwd(x_proj, h_out, c_out, dh_out, w_hh, b_hh, lengths,
             reverse=False):
    """Backward of :func:`lstm_fwd` for one direction.

    :param x_proj: (T, B, 4H) bf16 forward projections.
    :param h_out: (T, B, H) bf16 forward outputs.
    :param c_out: (T, B, H) f32 forward cell states.
    :param dh_out: (T, B, H) f32 gradients at the outputs.
    :param w_hh, b_hh, lengths, reverse: as for :func:`lstm_fwd`.
    :returns: (dxp (T, B, 4H) f32, dW_hh (4H, H) f32, db_hh (4H,) f32).
    """
    if x_proj.is_cuda:
        return _launch_bwd(x_proj, h_out, c_out, dh_out, w_hh, b_hh, lengths,
                           reverse)
    return lstm_bwd_plain(x_proj, h_out, c_out, dh_out, w_hh, b_hh, lengths,
                          reverse)


class LSTMDirection(torch.autograd.Function):
    """Differentiable LSTM direction: :func:`lstm_fwd` forward,
    :func:`lstm_bwd` backward (``lstm_dir_trainable``)."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, b_hh, lengths, reverse=False,
                plain=False):
        """(T, B, 4H) projections -> (T, B, H) bf16 outputs.

        ``plain`` runs the kernels' plain versions on any device, to hold
        a step through the kernels against the same step without them.
        """
        xb = x_proj.to(torch.bfloat16)
        fwd = lstm_fwd_plain if plain else lstm_fwd
        out, c_out = fwd(xb, w_hh, b_hh, lengths, reverse)
        ctx.save_for_backward(xb, out, c_out, w_hh, b_hh, lengths)
        ctx.reverse = reverse
        ctx.plain = plain
        ctx.x_dtype = x_proj.dtype
        return out

    @staticmethod
    def backward(ctx, grad_out):
        """Gradients for x_proj (its dtype), w_hh and b_hh (theirs)."""
        xb, out, c_out, w_hh, b_hh, lengths = ctx.saved_tensors
        bwd = lstm_bwd_plain if ctx.plain else lstm_bwd
        dxp, dw, db = bwd(xb, out, c_out, grad_out.float().contiguous(),
                          w_hh, b_hh, lengths, ctx.reverse)
        return (dxp.to(ctx.x_dtype), dw.to(w_hh.dtype), db.to(b_hh.dtype),
                None, None, None)


def bilstm_stack_trainable(layers: Sequence[Dict], x: torch.Tensor,
                           lengths=None, compute_dtype=torch.bfloat16,
                           bidirectional: bool = True,
                           plain: bool = False) -> torch.Tensor:
    """Differentiable LSTM stack through :class:`LSTMDirection`.

    Counterpart of ``pallas_gru.bilstm_stack_trainable``: bidirectional
    stacks concatenate the forward and backward directions of each layer;
    unidirectional stacks run one direction a layer, reversed on even
    layers (the reference's ReversibleLSTM interleave of
    ``LatentSpaceLSTM``). The input projections stay in PyTorch
    (:func:`~medaka_tpu_torch.ops.gru_train.project`: f32 accumulation
    plus the f32 ``b_ih``, cast once, not the inference stack's
    ``bilstm.project``), the recurrences run the kernel pair.

    :param layers: per-layer {"fwd"[, "bwd"]} dicts of w_ih, w_hh, b_ih,
        b_hh.
    :param x: (B, T, F) batch-major inputs.
    :param lengths: (B,) valid lengths (None: all T).
    :param compute_dtype: dtype of the projections and outputs (None or
        bf16: bf16).
    :param plain: the kernels' plain versions on any device (see
        :class:`LSTMDirection`).
    :returns: (B, T, H * n_dirs) features of the last layer.
    """
    cd = compute_dtype or torch.bfloat16
    B, T, _ = x.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32)
    lengths = torch.as_tensor(lengths).to(device=x.device, dtype=torch.int32)
    out = x.transpose(0, 1).to(cd)                       # (T, B, F)
    for li, layer in enumerate(layers):
        dirs_of = ((("fwd", False), ("bwd", True)) if bidirectional
                   else (("fwd", li % 2 == 0),))
        dirs = []
        for key, reverse in dirs_of:
            p = layer[key]
            x_proj = project(out, p["w_ih"], p["b_ih"], cd)
            dirs.append(LSTMDirection.apply(
                x_proj, p["w_hh"], p["b_hh"], lengths, reverse, plain))
        out = dirs[0] if len(dirs) == 1 else torch.cat(dirs, dim=-1)
    return out.transpose(0, 1)
