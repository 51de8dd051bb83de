"""Fused bidirectional LSTM over pre-projected inputs (read-level models).

Counterpart of the fused bi-LSTM section of ``medaka_tpu/ops/pallas_gru.py``
(``_bilstm_kernel``, ``bilstm_pallas``, ``bilstm_stack_fused``). One CUDA
kernel (``csrc/bilstm.cu``) replaces TPU kernel ``bilstm_pallas``:

- :func:`bilstm_fused`: both LSTM directions of one layer, gates i, f,
  g, o, an f32 h/c carry frozen where t >= length, bf16 outputs. It runs
  the LSTM cluster forward of ``csrc/lstm_fwd.cuh`` (shared with
  ``lstm_train.lstm_fwd``) with both directions' clusters in one grid:
  W_hh cut into per-block slices (``lstm_train.w_slices``), the geometry
  from :func:`geometry` (the LSTM layout, both directions).
- :func:`bilstm_fused_plain`: its plain PyTorch version, a step loop
  repeating the kernel's arithmetic.
- :func:`bilstm_stack_fused`: the stack: per layer the input
  projections in PyTorch (bf16 operands, f32 accumulation, then bf16 plus
  a bf16 ``b_ih``, as the JAX function computes them outside its
  kernel), then the kernel.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from medaka_tpu_torch.ops import cuda_build, lstm_train, rnn_cluster

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"bilstm_fused": 0}

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int


def reset_launches():
    """Set the launch count to 0."""
    LAUNCHES["bilstm_fused"] = 0


def _sigmoid(v: torch.Tensor) -> torch.Tensor:
    # the kernel's 1 / (1 + expf(-v)), op for op
    return 1.0 / (1.0 + torch.exp(-v))


def bilstm_fused_plain(x_proj_f, x_proj_b, w_hh, b_hh, lengths):
    """Plain version of :func:`bilstm_fused` (same arguments)."""
    T, B, G = x_proj_f.shape
    H = G // 4
    dev = x_proj_f.device
    w_t = w_hh.to(torch.bfloat16).float().transpose(1, 2)   # (2, H, 4H)
    b = b_hh.float().reshape(2, 1, G)
    h = torch.zeros((2, B, H), dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    out = torch.empty((2, T, B, H), dtype=torch.bfloat16, device=dev)
    lens = lengths.to(device=dev, dtype=torch.int32).reshape(1, B, 1)
    i_ = torch.arange(T, dtype=torch.int32, device=dev)
    times = torch.stack([i_, T - 1 - i_], dim=1).reshape(T, 2, 1, 1)
    for i in range(T):
        tb = T - 1 - i
        xp = torch.stack([x_proj_f[i], x_proj_b[tb]]).float()
        gates = torch.bmm(h.to(torch.bfloat16).float(), w_t) + b + xp
        gi = _sigmoid(gates[..., :H])
        gf = _sigmoid(gates[..., H:2 * H])
        gg = torch.tanh(gates[..., 2 * H:3 * H])
        go = _sigmoid(gates[..., 3 * H:])
        c_new = gf * c + gi * gg
        h_new = go * torch.tanh(c_new)
        valid = lens > times[i]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        hb = h.to(torch.bfloat16)
        out[0, i] = hb[0]
        out[1, tb] = hb[1]
    return out[0], out[1]


def build():
    """Compile (if needed) and load the kernel library; returns it."""
    lib = cuda_build.load_library("bilstm.cu")
    if not getattr(lib, "_medaka_typed", False):
        lib.bilstm_launch.argtypes = [_VOIDP] * 7 + [_INT] * 5 + [_VOIDP]
        lib.bilstm_launch.restype = _INT
        lib.bilstm_smem.argtypes = [_INT] * 3
        lib.bilstm_smem.restype = ctypes.c_size_t
        lib.bilstm_max_clusters.argtypes = [_INT] * 3
        lib.bilstm_max_clusters.restype = _INT
        lib.bilstm_error_string.argtypes = [_INT]
        lib.bilstm_error_string.restype = ctypes.c_char_p
        lib._medaka_typed = True
    return lib


def _raise(lib, err):
    raise RuntimeError("bilstm_fused launch failed: {} (cudaError {})".format(
        lib.bilstm_error_string(err).decode(), err))


def geometry(H: int, B: int, dev):
    """(C, BT, shared memory bytes, resident clusters) with which
    :func:`bilstm_fused` launches at hidden size H and batch B on CUDA
    device ``dev``: both directions' clusters in one grid
    (:func:`rnn_cluster.choose_geometry` with the LSTM layout: clusters of
    2 at H=128, which step faster than one block holding all of W_hh on an
    H100, PERF.md), its resident-cluster queries cached."""
    lib = build()

    def query(cluster, columns):
        n = lib.bilstm_max_clusters(cluster, columns, H)
        if n < 0:
            _raise(lib, -n)
        return n

    return rnn_cluster.geometry(rnn_cluster.LSTM, "fwd", H, B, dev, query,
                                cuda_build.SMEM_LIMIT, "bilstm_fused",
                                directions=2)


def w_slices(w_hh: torch.Tensor, cluster: int) -> torch.Tensor:
    """(2, 4H, H) W_hh -> (2, C, 4U, Hp) bf16: each direction's
    :func:`lstm_train.w_slices`."""
    return torch.stack([lstm_train.w_slices(w, cluster) for w in w_hh])


def _launch(x_proj_f, x_proj_b, w_hh, b_hh, lengths, cluster=None):
    """``cluster``: a (C, BT) geometry in place of :func:`geometry`'s (for
    timing other cluster sizes)."""
    T, B, G = x_proj_f.shape
    H = G // 4
    cuda_build.check_inputs("bilstm_fused", H, [
        (x_proj_f, (T, B, G), torch.bfloat16),
        (x_proj_b, (T, B, G), torch.bfloat16),
        (w_hh, (2, G, H), None), (b_hh, (2, G), None), (lengths, (B,), None)])
    dev = x_proj_f.device
    out_f = torch.empty((T, B, H), dtype=torch.bfloat16, device=dev)
    out_b = torch.empty_like(out_f)
    if T == 0 or B == 0:
        return out_f, out_b
    lib = build()
    C, BT = cluster or geometry(H, B, dev)[:2]
    x_proj_f = x_proj_f.contiguous()
    x_proj_b = x_proj_b.contiguous()
    w_sl = w_slices(w_hh, C)
    b_hh = b_hh.float().contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.bilstm_launch(
        x_proj_f.data_ptr(), x_proj_b.data_ptr(), w_sl.data_ptr(),
        b_hh.data_ptr(), lengths.data_ptr(), out_f.data_ptr(),
        out_b.data_ptr(), T, B, H, C, BT, stream)
    if err != 0:
        _raise(lib, err)
    LAUNCHES["bilstm_fused"] += 1
    return out_f, out_b


def bilstm_fused(x_proj_f, x_proj_b, w_hh, b_hh, lengths):
    """Both LSTM directions of one layer over pre-projected inputs.

    :param x_proj_f, x_proj_b: (T, B, 4H) bf16 projections
        ``x W_ih^T + b_ih`` of each direction.
    :param w_hh: (2, 4H, H) recurrent weights (fwd, bwd); cast to bf16.
    :param b_hh: (2, 4H) recurrent biases, used in f32.
    :param lengths: (B,) valid lengths; h and c freeze at t >= length.
    :returns: (out_f, out_b), each (T, B, H) bf16.
    """
    if x_proj_f.is_cuda:
        return _launch(x_proj_f, x_proj_b, w_hh, b_hh, lengths)
    return bilstm_fused_plain(x_proj_f, x_proj_b, w_hh, b_hh, lengths)


def project(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w^T`` with f32 accumulation, cast to ``compute_dtype``, plus
    ``b`` in ``compute_dtype`` (``pallas_gru.py:472-479``)."""
    cd = compute_dtype
    acc = torch.matmul(x.to(cd).float(), w.to(cd).float().t())
    return acc.to(cd) + b.to(device=x.device, dtype=cd)


def bilstm_stack_fused(layers: Sequence[Dict], x: torch.Tensor,
                       lengths=None, compute_dtype=torch.bfloat16,
                       device=None) -> torch.Tensor:
    """Bidirectional LSTM stack through :func:`bilstm_fused`.

    Counterpart of ``pallas_gru.bilstm_stack_fused``.

    :param layers: per-layer {"fwd", "bwd"} dicts of w_ih, w_hh, b_ih,
        b_hh.
    :param x: (B, T, F) batch-major inputs.
    :param lengths: (B,) valid lengths (None: all T).
    :param compute_dtype: dtype of the projections and outputs (bf16).
    :param device: where to run (default: ``x``'s device).
    :returns: (B, T, 2H) bf16 features of the last layer.
    """
    cd = compute_dtype or torch.bfloat16
    x = torch.as_tensor(x)
    if device is not None:
        x = x.to(device)
    B, T, _ = x.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32)
    lengths = torch.as_tensor(lengths).to(device=x.device, dtype=torch.int32)
    out = x.transpose(0, 1).to(cd)                       # (T, B, F)
    for layer in layers:
        fwd, bwd = layer["fwd"], layer["bwd"]
        xp_f = project(out, fwd["w_ih"], fwd["b_ih"], cd)
        xp_b = project(out, bwd["w_ih"], bwd["b_ih"], cd)
        w_hh = torch.stack([fwd["w_hh"], bwd["w_hh"]]).to(x.device)
        b_hh = torch.stack([fwd["b_hh"], bwd["b_hh"]]).to(x.device)
        out_f, out_b = bilstm_fused(xp_f, xp_b, w_hh, b_hh, lengths)
        out = torch.cat([out_f, out_b], dim=-1)
    return out.transpose(0, 1)
