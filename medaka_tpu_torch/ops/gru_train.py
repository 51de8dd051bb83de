"""Trainable GRU directions: forward and backward kernels joined by autograd.

Counterpart of the "Backward kernel + custom VJP" section of
``medaka_tpu/ops/pallas_gru.py`` (``gru_pallas``, ``gru_bwd_pallas``,
``gru_dir_trainable``, ``bigru_stack_trainable``). Two CUDA kernels in
``csrc/gru_train.cu`` replace two TPU kernels:

- :func:`gru_fwd` (TPU kernel ``gru_pallas``): one GRU direction over
  pre-projected inputs, an f32 carry frozen where t >= length, bf16
  outputs; :func:`gru_fwd_plain` is its plain version.
- :func:`gru_bwd` (TPU kernel ``gru_bwd_pallas``): its backward, which
  recomputes the gates from the forward's bf16 outputs and returns
  ``dxp`` and ``dW_hh``/``db_hh`` summed over the batch and time in a
  fixed order; :func:`gru_bwd_plain` is its plain version.
- :class:`GRUDirection`: the ``torch.autograd.Function`` joining them
  (``gru_dir_trainable``), and :func:`bigru_stack_trainable`, the stack
  (input projections in PyTorch, f32 accumulation plus the f32 ``b_ih``,
  cast once to the compute dtype, as the JAX function computes them).

Both kernels run one tile of batch columns on a thread-block cluster
whose blocks keep W_hh's gate rows of their hidden units in shared memory
and run the step's products on the tensor cores (the forward is
``csrc/gru_rec.cuh``'s cluster recurrence, shared with
``ops/gru_fullfused.py``; the backward ``csrc/gru_train.cu``'s);
:func:`fwd_geometry` and :func:`bwd_geometry` choose the clusters with
``ops/rnn_cluster.py``. Each wrapper runs its plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from medaka_tpu_torch.ops import cuda_build, rnn_cluster

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"gru_fwd": 0, "gru_bwd": 0}

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int


def reset_launches():
    """Set the launch counts to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sigmoid(v: torch.Tensor) -> torch.Tensor:
    # the kernels' 1 / (1 + expf(-v)), op for op
    return 1.0 / (1.0 + torch.exp(-v))


def _order(T: int, reverse: bool):
    return range(T - 1, -1, -1) if reverse else range(T)


def _gates(xp, hp, H):
    """r, z, n and hp_n of one step (f32), as both kernels compute them."""
    r = _sigmoid(xp[:, :H] + hp[:, :H])
    z = _sigmoid(xp[:, H:2 * H] + hp[:, H:2 * H])
    hn = hp[:, 2 * H:]
    n = torch.tanh(xp[:, 2 * H:] + r * hn)
    return r, z, n, hn


def gru_fwd_plain(x_proj, w_hh, b_hh, lengths, reverse=False):
    """Plain version of :func:`gru_fwd` (same arguments).

    On a CUDA device it needs ``torch.backends.cuda.matmul.allow_tf32``
    off (the default) to compute the recurrent product in f32.
    """
    T, B, G = x_proj.shape
    H = G // 3
    dev = x_proj.device
    w_t = w_hh.to(device=dev, dtype=torch.bfloat16).float().t()   # (H, 3H)
    b = b_hh.to(dev).float()
    lens = lengths.to(device=dev, dtype=torch.int32).reshape(B, 1)
    h = torch.zeros((B, H), dtype=torch.float32, device=dev)
    out = torch.empty((T, B, H), dtype=torch.bfloat16, device=dev)
    for t in _order(T, reverse):
        hp = h.to(torch.bfloat16).float() @ w_t + b
        r, z, n, _ = _gates(x_proj[t].float(), hp, H)
        h_new = (1.0 - z) * n + z * h
        h = torch.where(t < lens, h_new, h)
        out[t] = h.to(torch.bfloat16)
    return out


def _h_prev(h_out, reverse):
    """h_{t-1} of each step in the forward's own order: h_out shifted by
    one step, zero at the recurrence start (``pallas_gru.py:1720-1726``)."""
    zero = torch.zeros_like(h_out[:1])
    if reverse:
        return torch.cat([h_out[1:], zero])
    return torch.cat([zero, h_out[:-1]])


def gru_bwd_plain(x_proj, h_out, dh_out, w_hh, b_hh, lengths, reverse=False):
    """Plain version of :func:`gru_bwd` (same arguments)."""
    T, B, G = x_proj.shape
    H = G // 3
    dev = x_proj.device
    w = w_hh.to(device=dev, dtype=torch.bfloat16).float()           # (3H, H)
    w_t = w.t()
    b = b_hh.to(dev).float()
    lens = lengths.to(device=dev, dtype=torch.int32).reshape(B, 1)
    h_prev = _h_prev(h_out.to(torch.bfloat16), reverse)
    dh = torch.zeros((B, H), dtype=torch.float32, device=dev)
    dxp = torch.empty((T, B, G), dtype=torch.float32, device=dev)
    dw = torch.zeros((G, H), dtype=torch.float32, device=dev)
    db = torch.zeros((G,), dtype=torch.float32, device=dev)
    # the backward walks opposite to the forward
    for t in _order(T, not reverse):
        hp_t = h_prev[t].float()
        dh = dh + dh_out[t].float()
        hp = hp_t @ w_t + b
        r, z, n, hn = _gates(x_proj[t].float(), hp, H)
        valid = (t < lens).float()
        dh_eff = dh * valid
        dn = dh_eff * (1.0 - z)
        dz = dh_eff * (hp_t - n)
        dn_pre = dn * (1.0 - n * n)
        dr = dn_pre * hn
        dz_pre = dz * z * (1.0 - z)
        dr_pre = dr * r * (1.0 - r)
        dhp = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1)
        dxp[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        dhp_b = dhp.to(torch.bfloat16).float()
        dw += dhp_b.t() @ hp_t
        db += dhp.sum(0)
        dh = dh_eff * z + dhp_b @ w + dh * (1.0 - valid)
    return dxp, dw, db


def build():
    """Compile (if needed) and load the kernel library; returns it."""
    lib = cuda_build.load_library("gru_train.cu")
    if not getattr(lib, "_medaka_typed", False):
        lib.gru_fwd_launch.argtypes = [_VOIDP] * 5 + [_INT] * 6 + [_VOIDP]
        lib.gru_fwd_launch.restype = _INT
        lib.gru_bwd_launch.argtypes = [_VOIDP] * 12 + [_INT] * 7 + [_VOIDP]
        lib.gru_bwd_launch.restype = _INT
        for name in ("gru_fwd_cluster_smem", "gru_bwd_smem"):
            fn = getattr(lib, name)
            fn.argtypes = [_INT] * 3
            fn.restype = ctypes.c_size_t
        for name in ("gru_fwd_max_clusters", "gru_bwd_max_clusters"):
            fn = getattr(lib, name)
            fn.argtypes = [_INT] * 3
            fn.restype = _INT
        lib.gru_train_error_string.argtypes = [_INT]
        lib.gru_train_error_string.restype = ctypes.c_char_p
        lib._medaka_typed = True
    return lib


def _split_count(batch, steps, hidden, n_sm, gates=3):
    """dW_hh partial tiles over (t, b) (``rnn_dw_kernel``, 128 x 128
    tiles of 8 warps): enough blocks for about 2 on each SM, and at least
    1024 (t, b) rows a split."""
    tiles = -(-gates * hidden // 128) * -(-hidden // 128)
    return max(1, min(-(-2 * n_sm // tiles), -(-steps * batch // 1024)))


def _geometry(kind: str, H: int, B: int, dev):
    lib = build()
    name = "gru_" + kind
    max_clusters = getattr(lib, name + "_max_clusters")

    def query(cluster, columns):
        n = max_clusters(cluster, columns, H)
        if n < 0:
            _raise(lib, name, -n)
        return n

    return rnn_cluster.geometry(rnn_cluster.GRU, kind, H, B, dev, query,
                                cuda_build.SMEM_LIMIT, name)


def fwd_geometry(H: int, B: int, dev) -> Tuple[int, int, int, int]:
    """(C, BT, shared memory bytes, resident clusters) with which
    ``gru_fwd`` launches the cluster recurrence, one direction, at hidden
    size H and batch B on CUDA device ``dev``
    (:func:`rnn_cluster.choose_geometry` with the GRU's row order); raises
    when no cluster can be resident."""
    return _geometry("fwd", H, B, dev)


def bwd_geometry(H: int, B: int, dev) -> Tuple[int, int, int, int]:
    """(C, BT, shared memory bytes, resident clusters) with which
    ``gru_bwd`` launches its cluster recurrence at hidden size H and batch
    B on CUDA device ``dev`` (:func:`rnn_cluster.choose_geometry` with the
    GRU's row order)."""
    return _geometry("bwd", H, B, dev)


def _raise(lib, name, err):
    raise RuntimeError("{} launch failed: {} (cudaError {})".format(
        name, lib.gru_train_error_string(err).decode(), err))


def _launch_fwd(x_proj, w_hh, b_hh, lengths, reverse):
    T, B, G = x_proj.shape
    H = G // 3
    cuda_build.check_inputs("gru_fwd", H, [
        (x_proj, (T, B, G), torch.bfloat16), (w_hh, (G, H), None),
        (b_hh, (G,), None), (lengths, (B,), None)])
    out = torch.empty((T, B, H), dtype=torch.bfloat16, device=x_proj.device)
    if T == 0 or B == 0:
        return out
    lib = build()
    cluster, columns = fwd_geometry(H, B, x_proj.device)[:2]
    x_proj = x_proj.contiguous()
    w_sl = rnn_cluster.w_slices(rnn_cluster.GRU, w_hh, cluster)
    b_hh = b_hh.float().contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(x_proj.device).cuda_stream
    err = lib.gru_fwd_launch(
        x_proj.data_ptr(), w_sl.data_ptr(), b_hh.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), T, B, H, cluster, columns,
        int(reverse), stream)
    if err != 0:
        _raise(lib, "gru_fwd", err)
    LAUNCHES["gru_fwd"] += 1
    return out


def gru_fwd(x_proj, w_hh, b_hh, lengths, reverse=False):
    """One GRU direction over pre-projected inputs.

    :param x_proj: (T, B, 3H) bf16 projections ``x W_ih^T + b_ih``.
    :param w_hh: (3H, H) recurrent weights; cast to bf16.
    :param b_hh: (3H,) recurrent bias, used in f32.
    :param lengths: (B,) valid lengths; h freezes at t >= length.
    :param reverse: walk time back to front (outputs in natural order).
    :returns: (T, B, H) bf16 outputs.
    """
    if x_proj.is_cuda:
        return _launch_fwd(x_proj, w_hh, b_hh, lengths, reverse)
    return gru_fwd_plain(x_proj, w_hh, b_hh, lengths, reverse)


def _launch_bwd(x_proj, h_out, dh_out, w_hh, b_hh, lengths, reverse):
    T, B, G = x_proj.shape
    H = G // 3
    cuda_build.check_inputs("gru_bwd", H, [
        (x_proj, (T, B, G), torch.bfloat16),
        (h_out, (T, B, H), torch.bfloat16),
        (dh_out, (T, B, H), torch.float32), (w_hh, (G, H), None),
        (b_hh, (G,), None), (lengths, (B,), None)])
    dev = x_proj.device
    dxp = torch.empty((T, B, G), dtype=torch.float32, device=dev)
    dw = torch.zeros((G, H), dtype=torch.float32, device=dev)
    db = torch.zeros((G,), dtype=torch.float32, device=dev)
    if T == 0 or B == 0:
        return dxp, dw, db
    lib = build()
    cluster, columns = bwd_geometry(H, B, dev)[:2]
    splits = _split_count(B, T, H, cuda_build.sm_count(dev))
    # scratch: bf16(dhp) for the dW tiles, per-cluster db_hh sums and
    # per-split dW_hh tiles, all summed in a fixed order by the kernels
    dhp = torch.empty((T, B, G), dtype=torch.bfloat16, device=dev)
    db_part = torch.empty((-(-B // columns), G), dtype=torch.float32,
                          device=dev)
    dw_part = torch.empty((splits, G, H), dtype=torch.float32, device=dev)
    x_proj = x_proj.contiguous()
    h_out = h_out.contiguous()
    dh_out = dh_out.contiguous()
    w_sl = rnn_cluster.w_slices(rnn_cluster.GRU, w_hh, cluster)
    b_hh = b_hh.float().contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.gru_bwd_launch(
        x_proj.data_ptr(), h_out.data_ptr(), dh_out.data_ptr(),
        w_sl.data_ptr(), b_hh.data_ptr(), lengths.data_ptr(), dxp.data_ptr(),
        dhp.data_ptr(), db_part.data_ptr(), dw_part.data_ptr(), dw.data_ptr(),
        db.data_ptr(), T, B, H, cluster, columns, int(reverse), splits,
        stream)
    if err != 0:
        _raise(lib, "gru_bwd", err)
    LAUNCHES["gru_bwd"] += 1
    return dxp, dw, db


def gru_bwd(x_proj, h_out, dh_out, w_hh, b_hh, lengths, reverse=False):
    """Backward of :func:`gru_fwd` for one direction.

    :param x_proj: (T, B, 3H) bf16 forward projections.
    :param h_out: (T, B, H) bf16 forward outputs.
    :param dh_out: (T, B, H) f32 gradients at the outputs.
    :param w_hh, b_hh, lengths, reverse: as for :func:`gru_fwd`.
    :returns: (dxp (T, B, 3H) f32, dW_hh (3H, H) f32, db_hh (3H,) f32).
    """
    if x_proj.is_cuda:
        return _launch_bwd(x_proj, h_out, dh_out, w_hh, b_hh, lengths,
                           reverse)
    return gru_bwd_plain(x_proj, h_out, dh_out, w_hh, b_hh, lengths, reverse)


class GRUDirection(torch.autograd.Function):
    """Differentiable GRU direction: :func:`gru_fwd` forward,
    :func:`gru_bwd` backward (``gru_dir_trainable``)."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, b_hh, lengths, reverse=False,
                plain=False):
        """(T, B, 3H) projections -> (T, B, H) bf16 outputs.

        ``plain`` runs the kernels' plain versions on any device, to hold
        a step through the kernels against the same step without them.
        """
        xb = x_proj.to(torch.bfloat16)
        fwd = gru_fwd_plain if plain else gru_fwd
        out = fwd(xb, w_hh, b_hh, lengths, reverse)
        ctx.save_for_backward(xb, out, w_hh, b_hh, lengths)
        ctx.reverse = reverse
        ctx.plain = plain
        ctx.x_dtype = x_proj.dtype
        return out

    @staticmethod
    def backward(ctx, grad_out):
        """Gradients for x_proj (its dtype), w_hh and b_hh (theirs)."""
        xb, out, w_hh, b_hh, lengths = ctx.saved_tensors
        bwd = gru_bwd_plain if ctx.plain else gru_bwd
        dxp, dw, db = bwd(xb, out, grad_out.float().contiguous(), w_hh,
                          b_hh, lengths, ctx.reverse)
        return (dxp.to(ctx.x_dtype), dw.to(w_hh.dtype), db.to(b_hh.dtype),
                None, None, None)


def project(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``(x @ w^T + b)`` with ``x`` and ``w`` in ``compute_dtype``, f32
    accumulation and the f32 bias, cast once to ``compute_dtype``
    (``pallas_gru.py:1834-1838``)."""
    cd = compute_dtype
    acc = torch.matmul(x.to(cd).float(), w.to(cd).float().t())
    return (acc + b.to(x.device).float()).to(cd)


def bigru_stack_trainable(layers: Sequence[Dict], x: torch.Tensor,
                          lengths=None, compute_dtype=torch.bfloat16,
                          bidirectional: bool = True,
                          plain: bool = False) -> torch.Tensor:
    """Differentiable (bi)GRU stack through :class:`GRUDirection`.

    Counterpart of ``pallas_gru.bigru_stack_trainable``: the input
    projections stay in PyTorch (autograd gives the gradients of w_ih,
    b_ih and the layer's input through them), the recurrences run the
    kernel pair.

    :param layers: per-layer {"fwd"[, "bwd"]} dicts of w_ih, w_hh, b_ih,
        b_hh.
    :param x: (B, T, F) batch-major inputs.
    :param lengths: (B,) valid lengths (None: all T).
    :param compute_dtype: dtype of the projections and outputs (None or
        bf16: bf16).
    :param plain: the kernels' plain versions on any device (see
        :class:`GRUDirection`).
    :returns: (B, T, H * n_dirs) features of the last layer.
    """
    cd = compute_dtype or torch.bfloat16
    B, T, _ = x.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32)
    lengths = torch.as_tensor(lengths).to(device=x.device, dtype=torch.int32)
    out = x.transpose(0, 1).to(cd)                       # (T, B, F)
    dirs_of = (("fwd", False), ("bwd", True)) if bidirectional \
        else (("fwd", False),)
    for layer in layers:
        dirs = []
        for key, reverse in dirs_of:
            p = layer[key]
            x_proj = project(out, p["w_ih"], p["b_ih"], cd)
            dirs.append(GRUDirection.apply(
                x_proj, p["w_hh"], p["b_hh"], lengths, reverse, plain))
        out = dirs[0] if len(dirs) == 1 else torch.cat(dirs, dim=-1)
    return out.transpose(0, 1)
