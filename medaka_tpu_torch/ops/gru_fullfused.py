"""Bidirectional GRU layers off the split path (inference).

Counterpart of the fused bi-GRU sections of
``medaka_tpu/ops/pallas_gru.py``: ``bigru_pallas`` and
``bigru_stack_fused`` (:165-332), ``bigru_pallas_fullfused``,
``bigru_pallas_fullfused_int8`` and ``bigru_stack_fullfused``
(:494-954). One CUDA source, ``csrc/gru_fullfused.cu``, covers the three
TPU kernels:

- :func:`bigru_pallas_fullfused` (TPU kernel ``bigru_pallas_fullfused``):
  one bi-GRU layer with the input projection computed by the kernel's own
  projection stage, ``bf16(f32(x W_ih^T) + b_ih)``, then both directions'
  recurrences in one launch. ``gates_bf16=False`` runs f32 gates over a
  bf16 W_hh; ``gates_bf16=True`` rounds the recurrent pre-activations and
  every gate operation to bf16 with the TPU kernel's exp(-|v|) forms of
  sigmoid and tanh. ``schedule="staggered"`` is the TPU kernel's
  software-pipelined instruction order with the f32 gates' numerics (JAX
  pins the two bit for bit, ``tests/test_pallas_gru.py``): it runs the
  f32-gates mode here.
- :func:`bigru_pallas_fullfused_int8` (``bigru_pallas_fullfused_int8``):
  the same with an int8 W_hh, per-column scales (``_quantize_cols``) and h
  quantised as round(127 h).
- :func:`bigru_pallas` (``bigru_pallas``, ``bigru_fused`` here): the
  f32-gates recurrence over projections computed outside (in
  :func:`bigru_stack_fused` they are rounded to bf16 before the bf16
  ``b_ih`` is added, as JAX does).

:func:`bigru_stack_fullfused` and :func:`bigru_stack_fused` run stacks of
any depth; the unidirectional branch of :func:`bigru_stack_fused` runs
``ops.gru_train.gru_fwd`` (TPU kernel ``gru_pallas``).

Every launch runs the cluster recurrence (``csrc/gru_rec.cuh``
``gru_cluster_fwd_kernel``, as ``gru_fwd`` does: W_hh split over a
thread-block cluster's shared memory, the step's product on the tensor
cores, int8 on ``mma.sync`` s8, the bf16-gates mode's f64 sums on the FP64
tensor cores), whose geometry :func:`cluster_geometry` chooses with
``ops/rnn_cluster.py``. The f32-gates and int8 modes project on the tensor
cores (``bigru_proj_mma_kernel``, :func:`project`); the bf16-gates mode on
the CUDA cores (``bigru_proj_kernel``), summing in the plain version's
order. Every kernel mode has a plain PyTorch version here that repeats its
arithmetic step by step. A wrapper runs the plain version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.
The kernels take any hidden size up to 512: one that is not a multiple of
32 is padded with zero units, which stay exactly 0 and add exact zeros.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from medaka_tpu_torch.common import resolve_device
from medaka_tpu_torch.ops import cuda_build, rnn_cluster
from medaka_tpu_torch.ops.gru_train import _sigmoid, gru_fwd

#: recurrence numerics of each kernel mode (csrc/gru_rec.cuh NUM_*)
NUMERICS = {"f32_gates": 0, "bf16_gates": 1, "int8": 2}
#: kernel launches since the last :func:`reset_launches`; "bigru_project"
#: counts the tensor-core projection stage (each f32-gates and int8
#: fullfused launch, and :func:`project`), "bigru_int8_recurrence" the
#: int8 recurrence launched alone (:func:`int8_recurrence`)
LAUNCHES: Dict[str, int] = {
    "bigru_fullfused": 0, "bigru_fullfused_int8": 0, "bigru_fused": 0,
    "bigru_project": 0, "bigru_int8_recurrence": 0}
#: the same launches by numerics mode, keyed "<kernel>/<mode>"
MODE_LAUNCHES: Dict[str, int] = {
    "bigru_fullfused/f32_gates": 0, "bigru_fullfused/bf16_gates": 0,
    "bigru_fullfused_int8/int8": 0, "bigru_fused/f32_gates": 0}
#: largest hidden size the kernels take (the cluster recurrence: 16 blocks
#: of at most 32 units in the bf16-gates and int8 modes)
MAX_HIDDEN = 512
#: ``recurrent_quant`` of :func:`bigru_stack_fullfused` -> kernel mode
#: (``pallas_gru.py:933-944``; None and "none" run the default kernel)
QUANT_MODES = {None: "f32_gates", "none": "f32_gates", "int8": "int8",
               "bf16_gates": "bf16_gates", "staggered": "f32_gates"}

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int


def reset_launches():
    """Set every launch count to 0."""
    for counts in (LAUNCHES, MODE_LAUNCHES):
        for key in counts:
            counts[key] = 0


def _quantize_cols(w: torch.Tensor):
    """Per-output-column int8 quantisation of stacked (..., K, N) weights
    (``pallas_gru.bigru_pallas_fullfused_int8`` :870-874).

    Returns (int8 weights, f32 scales (..., 1, N)); the scale folds the
    activations' fixed 1/127, so int32 products times the scale give
    ``h @ w`` for h quantised as round(127 h). Rounds half to even.
    """
    w = w.float()
    col = torch.amax(w.abs(), dim=-2, keepdim=True) / 127.0
    col = torch.clamp(col, min=1e-12)
    w_q = torch.round(w / col).to(torch.int8)
    return w_q, (col / 127.0).float()


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float()


def _sigmoid_bf16(v: torch.Tensor) -> torch.Tensor:
    """bf16 sigmoid in the exp(-|v|) form (``pallas_gru.py:545-549``)."""
    e = torch.exp(-v.abs())
    pos = 1.0 / (1.0 + e)
    return torch.where(v >= 0, pos, 1.0 - pos)


def _tanh_bf16(v: torch.Tensor) -> torch.Tensor:
    """bf16 tanh in the exp(-2|v|) form (``pallas_gru.py:551-556``)."""
    e = torch.exp(-2.0 * v.abs())
    mag = (1.0 - e) / (1.0 + e)
    return torch.where(v >= 0, mag, -mag)


def _gates_bf16(hp, xp, h):
    """The bf16-gates mode's update from the recurrent pre-activations hp
    (f32, b_hh added), the bf16 projections xp and the carry h: every
    operation rounded to bf16 (``pallas_gru.py:539-558``)."""
    H = h.shape[-1]
    hp = hp.to(torch.bfloat16)
    r = _sigmoid_bf16(xp[..., :H] + hp[..., :H])
    z = _sigmoid_bf16(xp[..., H:2 * H] + hp[..., H:2 * H])
    n = _tanh_bf16(xp[..., 2 * H:] + r * hp[..., 2 * H:])
    return ((1.0 - z) * n + z * h.to(torch.bfloat16)).float()


def _cell(h, xp, w_t, sc, b, mode):
    """One step of both directions: h (2, B, H) f32, xp (2, B, 3H) bf16."""
    H = h.shape[-1]
    if mode == "int8":
        # int8 values times int8 values summed over H <= 512 stay below
        # 2^24, so the f32 product is the exact int32 result
        hp = torch.bmm(torch.round(h * 127.0), w_t) * sc + b
    elif mode == "bf16_gates":
        # summed in f64 and rounded once to f32, as the kernel does: the
        # bf16 carry would amplify an order-dependent f32 rounding
        hp = torch.bmm(_bf16(h).double(), w_t.double()).float() + b
        return _gates_bf16(hp, xp, h)
    else:
        hp = torch.bmm(_bf16(h), w_t) + b
    xf = xp.float()
    r = _sigmoid(xf[..., :H] + hp[..., :H])
    z = _sigmoid(xf[..., H:2 * H] + hp[..., H:2 * H])
    n = torch.tanh(xf[..., 2 * H:] + r * hp[..., 2 * H:])
    return (1.0 - z) * n + z * h


def _recurrent_weights(w_hh, mode, device):
    """(W_hh^T (2, H, 3H) as the plain versions multiply it, scales)."""
    if mode == "int8":
        w_q, sc = _quantize_cols(w_hh.to(device).float().transpose(1, 2))
        return w_q.float(), sc
    w_t = _bf16(w_hh.to(device)).transpose(1, 2)
    return w_t, torch.ones((2, 1, w_t.shape[-1]), device=device)


def recurrence_plain(xp_f, xp_b, w_hh, b_hh, lengths, mode="f32_gates"):
    """Both directions over bf16 projections xp_f, xp_b (T, B, 3H).

    The recurrence of every kernel mode, step by step: the forward
    direction freezes h at t >= length, the backward keeps h = 0 until
    t < length. Returns (T, B, 2H) bf16: [forward h | backward h].
    """
    T, B, G = xp_f.shape
    H = G // 3
    dev = xp_f.device
    w_t, sc = _recurrent_weights(w_hh, mode, dev)
    b = b_hh.to(dev).float().reshape(2, 1, G)
    lens = lengths.to(device=dev, dtype=torch.int32).reshape(1, B, 1)
    i = torch.arange(T, dtype=torch.int32, device=dev)
    times = torch.stack([i, T - 1 - i], dim=1).reshape(T, 2, 1, 1)
    h = torch.zeros((2, B, H), dtype=torch.float32, device=dev)
    out = torch.empty((T, B, 2 * H), dtype=torch.bfloat16, device=dev)
    for step in range(T):
        tb = T - 1 - step
        xp = torch.stack([xp_f[step], xp_b[tb]]).to(torch.bfloat16)
        nh = _cell(h, xp, w_t, sc, b, mode)
        h = torch.where(lens > times[step], nh, h)
        hb = h.to(torch.bfloat16)
        out[step, :, :H] = hb[0]
        out[tb, :, H:] = hb[1]
    return out


def project_plain(x, w_ih, b_ih):
    """The projection stage: (2, T, B, 3H) bf16 ``bf16(f32(x W_ih^T) +
    b_ih)`` of bf16 x and W_ih, the f32 bias added before the rounding
    (``pallas_gru.py:527-534``).

    The sum runs over the inputs in order, as the bf16-gates mode's CUDA
    core stage does: a bf16 x bf16 product is exact in f32, so each add
    rounds once, as its fmaf does, and the two agree bit for bit. The
    tensor-core stage of the other modes sums in its own order: an element
    can differ by one bf16 rounding.
    """
    xf = _bf16(x)
    w = _bf16(w_ih.to(x.device))[:, None, None]          # (2, 1, 1, G, IN)
    acc = torch.zeros((2,) + x.shape[:2] + (w.shape[-2],), device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + xf[..., k, None] * w[..., k]
    return (acc + b_ih.to(x.device).float()[:, None, None]).to(
        torch.bfloat16)


def bigru_fullfused_plain(x, w_ih, b_ih, w_hh, b_hh, lengths,
                          mode="f32_gates"):
    """Plain version of the fullfused kernels: (T, B, 2H) bf16."""
    xp = project_plain(x, w_ih, b_ih)
    return recurrence_plain(xp[0], xp[1], w_hh, b_hh, lengths, mode)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def build():
    """Compile (if needed) and load the kernel library; returns it."""
    lib = cuda_build.load_library("gru_fullfused.cu")
    if not getattr(lib, "_medaka_typed", False):
        lib.bigru_fullfused_launch.argtypes = (
            [_VOIDP] * 10 + [_INT] * 8 + [_VOIDP])
        lib.bigru_fullfused_launch.restype = _INT
        lib.bigru_fused_launch.argtypes = [_VOIDP] * 7 + [_INT] * 6 + [_VOIDP]
        lib.bigru_fused_launch.restype = _INT
        lib.bigru_int8_rec_launch.argtypes = (
            [_VOIDP] * 8 + [_INT] * 6 + [_VOIDP])
        lib.bigru_int8_rec_launch.restype = _INT
        lib.bigru_project_launch.argtypes = (
            [_VOIDP] * 4 + [ctypes.c_longlong] + [_INT] * 2 + [_VOIDP])
        lib.bigru_project_launch.restype = _INT
        lib.bigru_cluster_smem.argtypes = [_INT] * 4
        lib.bigru_cluster_smem.restype = ctypes.c_size_t
        lib.bigru_max_clusters.argtypes = [_INT] * 4
        lib.bigru_max_clusters.restype = _INT
        lib.gru_fullfused_error_string.argtypes = [_INT]
        lib.gru_fullfused_error_string.restype = ctypes.c_char_p
        lib._medaka_typed = True
    return lib


#: the cluster recurrence's layout of each mode (``csrc/gru_rec.cuh``)
CLUSTER_LAYOUTS = {"f32_gates": rnn_cluster.GRU,
                   "bf16_gates": rnn_cluster.GRU_BF16G,
                   "int8": rnn_cluster.GRU_INT8}


def cluster_geometry(hidden: int, batch: int, device,
                     kernel: str = "bigru_fullfused", mode: str = None):
    """(C, BT, shared memory bytes, resident clusters) with which a launch
    of the cluster recurrence (``kernel``: "bigru_fullfused" in ``mode``
    "f32_gates" (the default) or "bf16_gates", "bigru_fused", or
    "bigru_fullfused_int8") runs at (padded) hidden size ``hidden`` and
    batch ``batch`` on CUDA device ``device``: both directions' clusters
    in one grid (:func:`rnn_cluster.choose_geometry` with the mode's
    layout); raises, naming the kernel and the geometry, when no cluster
    can be resident."""
    lib = build()
    if kernel == "bigru_fullfused_int8":
        mode = "int8"
    mode = mode or "f32_gates"
    num = NUMERICS[mode]
    name = kernel if mode != "bf16_gates" else kernel + "/" + mode

    def query(cluster, columns):
        n = lib.bigru_max_clusters(num, cluster, columns, hidden)
        if n < 0:
            _raise(lib, name, -n)
        return n

    return rnn_cluster.geometry(CLUSTER_LAYOUTS[mode], "fwd", hidden, batch,
                                device, query, cuda_build.SMEM_LIMIT, name,
                                directions=2)


def _cluster_operand(w_hh, cluster, mode="f32_gates"):
    """(2, 3H, H) W_hh -> (2, C, 3U, Hp) slices of both directions: bf16,
    or in mode "int8" the int8 values of :func:`_quantize_cols` with their
    scales (2, C, 3U) f32 in the same rows (None in the other modes)."""
    layout = CLUSTER_LAYOUTS[mode]
    if mode != "int8":
        return torch.stack([rnn_cluster.w_slices(layout, w, cluster)
                            for w in w_hh]), None
    w_q, sc = _quantize_cols(w_hh.float().transpose(1, 2))
    rows = w_q.transpose(1, 2)                                 # (2, 3H, H)
    return (torch.stack([rnn_cluster.w_slices(layout, w, cluster)
                         for w in rows]),
            torch.stack([rnn_cluster.row_slices(layout, v.reshape(-1), cluster)
                         for v in sc]).contiguous())


def _padded(hidden: int) -> int:
    return -(-hidden // 32) * 32


def _pad_gates(v: torch.Tensor, hidden: int, padded: int, dim: int):
    """Pad each of the 3 gate blocks along ``dim`` from hidden to padded."""
    if padded == hidden:
        return v
    shape = list(v.shape)
    parts = v.reshape(shape[:dim] + [3, hidden] + shape[dim + 1:])
    pad = [0, 0] * (len(shape) - dim - 1) + [0, padded - hidden]
    parts = torch.nn.functional.pad(parts, pad)
    return parts.reshape(shape[:dim] + [3 * padded] + shape[dim + 1:])


def _pad_recurrent(w_hh, b_hh, hidden, padded):
    """(2, 3H, H), (2, 3H) -> (2, 3Hp, Hp), (2, 3Hp) with zero units."""
    w = _pad_gates(w_hh, hidden, padded, 1)
    w = torch.nn.functional.pad(w, [0, padded - hidden])
    return w, _pad_gates(b_hh, hidden, padded, 1)


def _raise(lib, name, err):
    raise RuntimeError("{} launch failed: {} (cudaError {})".format(
        name, lib.gru_fullfused_error_string(err).decode(), err))


def _check_hidden(name, hidden):
    if hidden > MAX_HIDDEN or hidden < 1:
        raise ValueError(
            "{}: hidden size {} is outside 1..{}".format(name, hidden,
                                                          MAX_HIDDEN))


def _unpad(out, T, B, hidden, padded):
    if padded == hidden:
        return out
    return out.reshape(T, B, 2, padded)[..., :hidden].reshape(
        T, B, 2 * hidden)


def _launch_fullfused(x, w_ih, b_ih, w_hh, b_hh, lengths, mode,
                      cluster=None):
    """``cluster``: a (C, BT) geometry in place of :func:`cluster_geometry`'s
    (for timing other cluster sizes)."""
    T, B, IN = x.shape
    H = w_hh.shape[-1]
    kernel = "bigru_fullfused_int8" if mode == "int8" else "bigru_fullfused"
    _check_hidden(kernel, H)
    Hp = _padded(H)
    G = 3 * H
    cuda_build.check_inputs(kernel, Hp, [
        (x, (T, B, IN), torch.bfloat16), (w_ih, (2, G, IN), None),
        (b_ih, (2, G), None), (w_hh, (2, G, H), None), (b_hh, (2, G), None),
        (lengths, (B,), None)])
    dev = x.device
    out = torch.empty((T, B, 2 * Hp), dtype=torch.bfloat16, device=dev)
    if T == 0 or B == 0:
        return _unpad(out, T, B, H, Hp)
    lib = build()
    w_ih = _pad_gates(w_ih.to(torch.bfloat16), H, Hp, 1).contiguous()
    b_ih = _pad_gates(b_ih.float(), H, Hp, 1).contiguous()
    w_hh, b_hh = _pad_recurrent(w_hh.float(), b_hh.float(), H, Hp)
    cols = cluster or cluster_geometry(Hp, B, dev, kernel, mode)[:2]
    w_op, scale = _cluster_operand(w_hh, cols[0], mode)
    b_hh = b_hh.contiguous()
    x = x.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    xp = torch.empty((2, T, B, 3 * Hp), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.bigru_fullfused_launch(
        x.data_ptr(), w_ih.data_ptr(), b_ih.data_ptr(), w_op.data_ptr(),
        None if scale is None else scale.data_ptr(), b_hh.data_ptr(),
        lengths.data_ptr(), xp.data_ptr(), out.data_ptr(),
        out[..., Hp:].data_ptr(), 2 * Hp, T, B, IN, Hp, cols[0], cols[1],
        NUMERICS[mode], stream)
    if err != 0:
        _raise(lib, kernel, err)
    LAUNCHES[kernel] += 1
    MODE_LAUNCHES["{}/{}".format(kernel, mode)] += 1
    if mode != "bf16_gates":
        LAUNCHES["bigru_project"] += 1
    return _unpad(out, T, B, H, Hp)


def _launch_project(x, w_ih, b_ih):
    T, B, IN = x.shape
    G = w_ih.shape[1]
    if G % 2 or w_ih.shape != (2, G, IN) or b_ih.shape != (2, G):
        raise ValueError("bigru_project: expected w_ih (2, G, {}) and b_ih "
                         "(2, G) with G even, got {} and {}".format(
                             IN, tuple(w_ih.shape), tuple(b_ih.shape)))
    xp = torch.empty((2, T, B, G), dtype=torch.bfloat16, device=x.device)
    if T == 0 or B == 0:
        return xp
    lib = build()
    x = x.to(torch.bfloat16).contiguous()
    w_ih = w_ih.to(x.device, torch.bfloat16).contiguous()
    b_ih = b_ih.to(x.device, torch.float32).contiguous()
    err = lib.bigru_project_launch(
        x.data_ptr(), w_ih.data_ptr(), b_ih.data_ptr(), xp.data_ptr(),
        T * B, IN, G, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        _raise(lib, "bigru_project", err)
    LAUNCHES["bigru_project"] += 1
    return xp


def _launch_int8_recurrence(xp_f, xp_b, w_hh, b_hh, lengths, cluster=None):
    T, B, G = xp_f.shape
    H = G // 3
    _check_hidden("bigru_fullfused_int8", H)
    Hp = _padded(H)
    cuda_build.check_inputs("bigru_fullfused_int8", Hp, [
        (xp_f, (T, B, G), torch.bfloat16),
        (xp_b, (T, B, G), torch.bfloat16), (w_hh, (2, G, H), None),
        (b_hh, (2, G), None), (lengths, (B,), None)])
    dev = xp_f.device
    out = torch.empty((T, B, 2 * Hp), dtype=torch.bfloat16, device=dev)
    if T == 0 or B == 0:
        return _unpad(out, T, B, H, Hp)
    lib = build()
    cols = cluster or cluster_geometry(Hp, B, dev,
                                       "bigru_fullfused_int8")[:2]
    xp_f = _pad_gates(xp_f, H, Hp, 2).contiguous()
    xp_b = _pad_gates(xp_b, H, Hp, 2).contiguous()
    w_hh, b_hh = _pad_recurrent(w_hh.float(), b_hh.float(), H, Hp)
    w_op, scale = _cluster_operand(w_hh, cols[0], "int8")
    b_hh = b_hh.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    err = lib.bigru_int8_rec_launch(
        xp_f.data_ptr(), xp_b.data_ptr(), w_op.data_ptr(), scale.data_ptr(),
        b_hh.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        out[..., Hp:].data_ptr(), 2 * Hp, T, B, Hp, cols[0], cols[1],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _raise(lib, "bigru_fullfused_int8", err)
    LAUNCHES["bigru_int8_recurrence"] += 1
    return _unpad(out, T, B, H, Hp)


def _launch_fused(x_proj_f, x_proj_b, w_hh, b_hh, lengths):
    T, B, G = x_proj_f.shape
    H = G // 3
    _check_hidden("bigru_fused", H)
    Hp = _padded(H)
    cuda_build.check_inputs("bigru_fused", Hp, [
        (x_proj_f, (T, B, G), torch.bfloat16),
        (x_proj_b, (T, B, G), torch.bfloat16), (w_hh, (2, G, H), None),
        (b_hh, (2, G), None), (lengths, (B,), None)])
    dev = x_proj_f.device
    out = torch.empty((T, B, 2 * Hp), dtype=torch.bfloat16, device=dev)
    if T == 0 or B == 0:
        return _unpad(out, T, B, H, Hp)
    lib = build()
    cluster, columns = cluster_geometry(Hp, B, dev, "bigru_fused")[:2]
    xp_f = _pad_gates(x_proj_f, H, Hp, 2).contiguous()
    xp_b = _pad_gates(x_proj_b, H, Hp, 2).contiguous()
    w_hh, b_hh = _pad_recurrent(w_hh.float(), b_hh.float(), H, Hp)
    w_op = _cluster_operand(w_hh, cluster)[0]
    b_hh = b_hh.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.bigru_fused_launch(
        xp_f.data_ptr(), xp_b.data_ptr(), w_op.data_ptr(), b_hh.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), out[..., Hp:].data_ptr(), 2 * Hp,
        T, B, Hp, cluster, columns, stream)
    if err != 0:
        _raise(lib, "bigru_fused", err)
    LAUNCHES["bigru_fused"] += 1
    MODE_LAUNCHES["bigru_fused/f32_gates"] += 1
    return _unpad(out, T, B, H, Hp)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _full_lengths(lengths, B, T, device):
    if lengths is None:
        return torch.full((B,), T, dtype=torch.int32, device=device)
    return torch.as_tensor(lengths).to(device=device, dtype=torch.int32)


def fullfused_layer(x, w_ih, b_ih, w_hh, b_hh, lengths, mode="f32_gates"):
    """One bi-GRU layer with its input projection: (T, B, 2H) bf16.

    :param x: (T, B, IN) bf16 time-major layer input.
    :param w_ih: (2, 3H, IN) input weights (fwd, bwd), used in bf16.
    :param b_ih, b_hh: (2, 3H) biases, used in f32.
    :param w_hh: (2, 3H, H) recurrent weights: bf16, or int8 per-column
        quantised in mode "int8".
    :param lengths: (B,) int32 valid lengths.
    :param mode: "f32_gates", "bf16_gates" or "int8".
    :returns: (T, B, 2H) bf16 [forward h | backward h].
    """
    if mode not in NUMERICS:
        raise ValueError("unknown mode {!r}".format(mode))
    if x.is_cuda:
        return _launch_fullfused(x, w_ih, b_ih, w_hh, b_hh, lengths, mode)
    return bigru_fullfused_plain(x, w_ih, b_ih, w_hh, b_hh, lengths, mode)


def project(x, w_ih, b_ih):
    """The projection stage of the f32-gates and int8 modes: (2, T, B, 3H)
    bf16 ``bf16(f32(x W_ih^T) + b_ih)`` of (T, B, IN) bf16 x, (2, 3H, IN)
    W_ih (used in bf16) and (2, 3H) b_ih (f32). On a CUDA tensor the
    tensor-core stage alone (``bigru_proj_mma_kernel``); on the CPU
    :func:`project_plain`."""
    if x.is_cuda:
        return _launch_project(x, w_ih, b_ih)
    return project_plain(x, w_ih, b_ih)


def int8_recurrence(x_proj_f, x_proj_b, w_hh, b_hh, lengths):
    """The int8 mode's recurrence alone over bf16 projections (T, B, 3H):
    (T, B, 2H) bf16 [forward h | backward h]. On a CUDA tensor the cluster
    recurrence of ``bigru_fullfused_int8`` without its projection stage
    (for its checks and timings); on the CPU
    :func:`recurrence_plain` in mode "int8"."""
    if x_proj_f.is_cuda:
        return _launch_int8_recurrence(x_proj_f, x_proj_b, w_hh, b_hh,
                                       lengths)
    return recurrence_plain(x_proj_f, x_proj_b, w_hh, b_hh, lengths, "int8")


def fused_layer(x_proj_f, x_proj_b, w_hh, b_hh, lengths):
    """Both directions over projections computed outside, f32 gates:
    (T, B, 2H) bf16 [forward h | backward h]."""
    if x_proj_f.is_cuda:
        return _launch_fused(x_proj_f, x_proj_b, w_hh, b_hh, lengths)
    return recurrence_plain(x_proj_f, x_proj_b, w_hh, b_hh, lengths)


def _split(out):
    H = out.shape[-1] // 2
    return out[..., :H], out[..., H:]


def bigru_pallas_fullfused(x, w_ih, b_ih, w_hh, b_hh, lengths=None,
                           gates_bf16: bool = False,
                           schedule: str = "sequential"):
    """One bi-GRU layer with the input projection in the kernel.

    Counterpart of ``pallas_gru.bigru_pallas_fullfused``; arguments as
    :func:`fullfused_layer`. ``schedule`` "sequential" or "staggered" (the
    same numerics here).

    :returns: ((T, B, H) fwd, (T, B, H) bwd) bf16 outputs.
    """
    if schedule not in ("sequential", "staggered"):
        raise ValueError("unknown schedule {!r}".format(schedule))
    T, B, _ = x.shape
    lengths = _full_lengths(lengths, B, T, x.device)
    mode = "bf16_gates" if gates_bf16 and schedule == "sequential" \
        else "f32_gates"
    return _split(fullfused_layer(x, w_ih, b_ih, w_hh, b_hh, lengths, mode))


def bigru_pallas_fullfused_int8(x, w_ih, b_ih, w_hh, b_hh, lengths=None):
    """:func:`bigru_pallas_fullfused` with an int8 recurrence
    (``pallas_gru.bigru_pallas_fullfused_int8``)."""
    T, B, _ = x.shape
    lengths = _full_lengths(lengths, B, T, x.device)
    return _split(fullfused_layer(x, w_ih, b_ih, w_hh, b_hh, lengths,
                                  "int8"))


def bigru_pallas(x_proj_f, x_proj_b, w_hh, b_hh, lengths=None):
    """Both directions of one layer over projections computed outside
    (``pallas_gru.bigru_pallas``), f32 gates.

    :param x_proj_f, x_proj_b: (T, B, 3H) bf16 projections.
    :param w_hh: (2, 3H, H), used in bf16; :param b_hh: (2, 3H), f32.
    :returns: ((T, B, H) fwd, (T, B, H) bwd) bf16 outputs.
    """
    T, B, _ = x_proj_f.shape
    lengths = _full_lengths(lengths, B, T, x_proj_f.device)
    return _split(fused_layer(x_proj_f, x_proj_b, w_hh, b_hh, lengths))


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------


def _as_tensor(v, device):
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _stacked(layer, key, device):
    return torch.stack([_as_tensor(layer["fwd"][key], device),
                        _as_tensor(layer["bwd"][key], device)])


def _time_major(x, lengths, device):
    device = resolve_device(device)
    x = torch.as_tensor(x).to(device)
    B, T = x.shape[:2]
    return (x.transpose(0, 1).to(torch.bfloat16).contiguous(),
            _full_lengths(lengths, B, T, device), device)


def bigru_stack_fullfused(layers: Sequence[Dict], x, lengths=None,
                          recurrent_quant: Optional[str] = None,
                          device=None) -> torch.Tensor:
    """Bi-GRU stack of any depth through the fullfused kernels.

    Counterpart of ``pallas_gru.bigru_stack_fullfused`` (bf16 compute).

    :param layers: per-layer {"fwd", "bwd"} dicts of w_ih, w_hh, b_ih,
        b_hh.
    :param x: (B, T, F) batch-major input.
    :param lengths: (B,) valid lengths (None: all T).
    :param recurrent_quant: None or "none" (f32 gates), "int8",
        "bf16_gates" or "staggered" (f32 gates), as JAX selects.
    :param device: "cuda" (default) or "cpu"; the CPU runs the kernels'
        plain versions.
    :returns: (B, T, 2H) bf16 features of the last layer.
    """
    if recurrent_quant not in QUANT_MODES:
        raise ValueError("unknown recurrent_quant {!r}".format(
            recurrent_quant))
    mode = QUANT_MODES[recurrent_quant]
    out, lengths, device = _time_major(x, lengths, device)
    for layer in layers:
        out = fullfused_layer(
            out, _stacked(layer, "w_ih", device),
            _stacked(layer, "b_ih", device), _stacked(layer, "w_hh", device),
            _stacked(layer, "b_hh", device), lengths, mode)
    return out.transpose(0, 1)


def project_fused(x, w_ih, b_ih):
    """``bigru_stack_fused``'s projection: f32 accumulation of bf16 x and
    W_ih rounded to bf16, then the bf16 ``b_ih`` added in bf16
    (``pallas_gru.py:308-313``)."""
    acc = torch.matmul(_bf16(x), _bf16(w_ih.to(x.device)).t())
    return acc.to(torch.bfloat16) + b_ih.to(x.device, torch.bfloat16)


def bigru_stack_fused(layers: Sequence[Dict], x, bidirectional: bool = True,
                      lengths=None, device=None) -> torch.Tensor:
    """(Bi)GRU stack over projections computed in PyTorch.

    Counterpart of ``pallas_gru.bigru_stack_fused`` (bf16 compute): the
    bidirectional branch runs :func:`bigru_pallas`, the unidirectional one
    ``gru_train.gru_fwd`` (TPU kernel ``gru_pallas``).

    :returns: (B, T, H * n_dirs) bf16 features of the last layer.
    """
    out, lengths, device = _time_major(x, lengths, device)
    for layer in layers:
        if bidirectional:
            fwd, bwd = layer["fwd"], layer["bwd"]
            xp_f = project_fused(out, _as_tensor(fwd["w_ih"], device),
                                 _as_tensor(fwd["b_ih"], device))
            xp_b = project_fused(out, _as_tensor(bwd["w_ih"], device),
                                 _as_tensor(bwd["b_ih"], device))
            out = fused_layer(xp_f, xp_b, _stacked(layer, "w_hh", device),
                              _stacked(layer, "b_hh", device), lengths)
        else:
            p = layer["fwd"]
            x_proj = project_fused(out, _as_tensor(p["w_ih"], device),
                                   _as_tensor(p["b_ih"], device))
            out = gru_fwd(x_proj, _as_tensor(p["w_hh"], device),
                          _as_tensor(p["b_hh"], device), lengths)
    return out.transpose(0, 1)
