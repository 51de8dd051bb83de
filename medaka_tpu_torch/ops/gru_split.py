"""Split-path 2-layer bidirectional GRU + linear head (the inference path).

Counterpart of the split-path section of ``medaka_tpu/ops/pallas_gru.py``
(``_bigru_l1_split_kernel`` … ``bigru_head_fullfused``). Two CUDA kernels
(``csrc/gru_split.cu``) cover the four TPU kernels, each parametrised by a
numerics mode:

- ``gru_l1_split``: layer 1, both directions; ``mode="t"`` reproduces
  ``bigru_l1_split_t`` and ``mode="rows"`` reproduces ``bigru_l1_split``.
- ``gru_l2head_split``: layer 2 with the linear head fused; ``"t"``
  reproduces ``bigru_l2head_t`` and ``"rows"`` reproduces
  ``bigru_l2head``.

Both kernels run thread-block clusters whose blocks keep their units'
rows of every weight in shared memory. With int8 quantisation (the
default) the step's products run on the tensor cores (``mma.sync`` int8,
exact); where ``quant=False`` they run on the FP64 tensor cores
(``mma.sync`` f64) over bf16 slices in shared memory, widened as they
load. :func:`geometry` chooses the cluster
size and the columns a cluster (``rnn_cluster.SPLIT`` and
``SPLIT_BF16``), and :func:`l1_operands` / :func:`l2_operands` cut the
weights into the kernels' slices. One shape has no cluster: bf16 layer 2
where its W_hh and W_ih slices outgrow a block at every cluster size (H=384
and 512), which runs the per-block kernel on the CUDA cores
(:func:`l2_route`).

The modes differ in arithmetic, not layout. ``"t"`` keeps the layer
input projections in f32, runs the quantised gates in bf16 tanh form and
uses one merged per-row scale for the layer-2 projection. ``"rows"``
rounds the projections to bf16, runs f32 sigmoid/tanh gates and scales
the two halves of the layer-2 projection separately. ``quant=False`` runs
bf16 weights and activations in both, and sums every product of the
recurrence (W_hh h, layer 1's W_ih x, layer 2's W_ih [prev_f; prev_b]
over all 2H at once) exactly: in f64, rounded once to f32, before its
bias is added in f32. That is the sum which the TPU kernels' bf16 x bf16
dot with f32 accumulation (``pallas_gru.py:1363-1364``) approximates in
an order it does not specify; bf16 values and their products are exact
in f64, and so is a sum of up to 1,024 of them but in the rarest cases
(products some 28 binades apart), so the sum, and its f32, do not depend
on the order in which a kernel adds the products.

Every kernel has a plain PyTorch version here that repeats its arithmetic
step by step, int8 casts and bf16 roundings included. A wrapper runs the
plain version only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from medaka_tpu_torch.common import resolve_device
from medaka_tpu_torch.ops import cuda_build, rnn_cluster

MODES = {"t": 0, "rows": 1}
#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"gru_l1_split": 0, "gru_l2head_split": 0}
#: the same launches by numerics mode, keyed "<kernel>/<mode>"
MODE_LAUNCHES: Dict[str, int] = {
    "{}/{}".format(k, m): 0 for k in LAUNCHES for m in MODES}
#: batch size from which the "t" numerics are used (the TPU layout
#: crossover of ``pallas_gru.bigru_head_fullfused``)
T_MODE_MIN_BATCH = 192


def reset_launches():
    """Set every launch count to 0."""
    for counts in (LAUNCHES, MODE_LAUNCHES):
        for key in counts:
            counts[key] = 0


# ---------------------------------------------------------------------------
# int8 weight quantisation (pallas_gru._quantize_cols / _quantize_rows)
# ---------------------------------------------------------------------------


def _quantize_cols(w: torch.Tensor):
    """Per-output-column int8 quantisation of stacked (..., K, N) weights.

    Returns (int8 weights, f32 scales (..., 1, N)); the scale folds the
    activations' fixed 1/127, so int32 products times the scale give
    ``h @ w`` for h quantised as round(127 h).
    """
    w = w.float()
    col = torch.amax(w.abs(), dim=-2, keepdim=True) / 127.0
    col = torch.clamp(col, min=1e-12)
    w_q = torch.round(w / col).to(torch.int8)
    return w_q, (col / 127.0).float()


def _quantize_rows(w: torch.Tensor):
    """Per-output-row int8 quantisation of stacked (..., N, K) weights."""
    w = w.float()
    row = torch.amax(w.abs(), dim=-1, keepdim=True) / 127.0
    row = torch.clamp(row, min=1e-12)
    w_q = torch.round(w / row).to(torch.int8)
    return w_q, (row / 127.0).float()


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float()


def _sum64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)`` of bf16 values summed in f64 and rounded once to
    f32: the exact sum, whatever the order (the module docstring)."""
    return torch.bmm(a.double(), b.double()).float()


def _cell(h, xp, w_t, sc, b, hidden, mode, quant):
    """One step of both directions: h (2, B, H), xp (2, B, 3H) f32."""
    if quant:
        # int8 values times int8 values summed over K <= 512 stay below
        # 2^24, so the f32 product is the exact int32 result
        hq = torch.round(h * 127.0)
        hp = torch.bmm(hq, w_t) * sc + b
    else:
        hp = _sum64(_bf16(h), w_t) + b
    H = hidden
    if quant and mode == "t":
        rz_in = (xp[..., :2 * H] + hp[..., :2 * H]).to(torch.bfloat16)
        rz = 0.5 * (1.0 + torch.tanh(rz_in * 0.5))   # bf16 arithmetic
        r = rz[..., :H].float()
        z = rz[..., H:].float()
        n = torch.tanh(
            (xp[..., 2 * H:] + r * hp[..., 2 * H:]).to(torch.bfloat16)
        ).float()
    else:
        r = torch.sigmoid(xp[..., :H] + hp[..., :H])
        z = torch.sigmoid(xp[..., H:2 * H] + hp[..., H:2 * H])
        n = torch.tanh(xp[..., 2 * H:] + r * hp[..., 2 * H:])
    return (1.0 - z) * n + z * h


def _step_times(T, device):
    """(T, 2, 1, 1): the time index of step i for the fwd and bwd walk."""
    i = torch.arange(T, dtype=torch.int32, device=device)
    return torch.stack([i, T - 1 - i], dim=1).reshape(T, 2, 1, 1)


def gru_l1_split_plain(x, lengths, w_ih, b_ih, w_hh, hh_scale, b_hh,
                       mode: str, quant: bool):
    """Plain version of :func:`gru_l1_split` (same arguments)."""
    T, B, _ = x.shape
    H = w_hh.shape[-1]
    dev = x.device
    w_ih_t = w_ih.float().transpose(1, 2)
    w_hh_t = w_hh.float().transpose(1, 2)
    sc = hh_scale.float().reshape(2, 1, 3 * H)
    bi = b_ih.float().reshape(2, 1, 3 * H)
    bh = b_hh.float().reshape(2, 1, 3 * H)
    out_dtype = torch.int8 if quant else torch.bfloat16
    out = torch.empty((2, T, B, H), dtype=out_dtype, device=dev)
    h = torch.zeros((2, B, H), dtype=torch.float32, device=dev)
    qmax = torch.zeros((), device=dev)
    xf = x.float()
    lens = lengths.to(device=dev, dtype=torch.int32).reshape(1, B, 1)
    times = _step_times(T, dev)
    for i in range(T):
        tb = T - 1 - i
        xs = torch.stack([xf[i], xf[tb]])
        xp = (torch.bmm(xs, w_ih_t) if quant else _sum64(xs, w_ih_t)) + bi
        if mode == "rows":
            xp = _bf16(xp)
        nh = _cell(h, xp, w_hh_t, sc, bh, H, mode, quant)
        mask = lens > times[i]
        h = torch.where(mask, nh, h)
        if quant:
            q = torch.round(h * 127.0)
            qmax = torch.maximum(qmax, q.abs().max())
            q = q.to(torch.int8)
        else:
            q = h.to(torch.bfloat16)
        out[0, i] = q[0]
        out[1, tb] = q[1]
    if quant and float(qmax) > 127.0:
        raise ArithmeticError("round(127 h) left the int8 range")
    return out[0], out[1]


def gru_l2head_split_plain(prev_f, prev_b, lengths, w_in, in_scale, b_ih,
                           w_hh, hh_scale, b_hh, w_head, mode: str,
                           quant: bool):
    """Plain version of :func:`gru_l2head_split` (same arguments)."""
    T, B, H = prev_f.shape
    C = w_head.shape[1]
    dev = prev_f.device
    w_in_f = w_in.float()
    w_in_t = w_in_f.transpose(1, 2)
    wa_t = w_in_f[:, :, :H].transpose(1, 2)
    wb_t = w_in_f[:, :, H:].transpose(1, 2)
    sa = in_scale[:, 0].float().reshape(2, 1, 3 * H)
    sb = in_scale[:, 1].float().reshape(2, 1, 3 * H)
    bi = b_ih.float().reshape(2, 1, 3 * H)
    w_hh_t = w_hh.float().transpose(1, 2)
    sc = hh_scale.float().reshape(2, 1, 3 * H)
    bh = b_hh.float().reshape(2, 1, 3 * H)
    wh_t = _bf16(w_head).transpose(1, 2)                   # (2, H, C)
    lg = torch.empty((2, B, T, C), dtype=torch.float32, device=dev)
    h = torch.zeros((2, B, H), dtype=torch.float32, device=dev)
    pf, pb = prev_f.float(), prev_b.float()
    lens = lengths.to(device=dev, dtype=torch.int32).reshape(1, B, 1)
    times = _step_times(T, dev)
    for i in range(T):
        tb = T - 1 - i
        in_a = torch.stack([pf[i], pf[tb]])
        in_b = torch.stack([pb[i], pb[tb]])
        if not quant:
            # one f64 sum over all 2H inputs
            xp = _sum64(torch.cat([in_a, in_b], dim=-1), w_in_t) + bi
            if mode == "rows":
                xp = _bf16(xp)
        else:
            acc_a = torch.bmm(in_a, wa_t)
            acc_b = torch.bmm(in_b, wb_t)
            if mode == "t":
                xp = (acc_a + acc_b) * sa + bi
            else:
                xp = _bf16((acc_a * sa + acc_b * sb) + bi)
        nh = _cell(h, xp, w_hh_t, sc, bh, H, mode, quant)
        mask = lens > times[i]
        h = torch.where(mask, nh, h)
        part = torch.bmm(_bf16(h), wh_t)                  # (2, B, C)
        lg[0, :, i] = part[0]
        lg[1, :, tb] = part[1]
    return lg[0], lg[1]


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
#: kernel of each kind of the cluster geometry
_KERNELS = {"l1": "gru_l1_split", "l2": "gru_l2head_split"}
#: the cluster layout of each numerics: int8 (``quant``) or bf16
_LAYOUTS = {True: rnn_cluster.SPLIT, False: rnn_cluster.SPLIT_BF16}


def build():
    """Compile (if needed) and load the kernel library; returns it."""
    lib = cuda_build.load_library("gru_split.cu")
    if not getattr(lib, "_medaka_typed", False):
        # the cluster kernels' functions take the numerics first: int8
        # (s8 = 1) or bf16 (0)
        lib.gru_l1_split_cluster_launch.argtypes = (
            [_INT] + [_VOIDP] * 7 + [_INT] * 7 + [_VOIDP])
        lib.gru_l1_split_cluster_launch.restype = _INT
        lib.gru_l2head_split_cluster_launch.argtypes = (
            [_INT] + [_VOIDP] * 9 + [_INT] * 7 + [_VOIDP])
        lib.gru_l2head_split_cluster_launch.restype = _INT
        lib.gru_split_smem.argtypes = [_INT] * 7
        lib.gru_split_smem.restype = ctypes.c_size_t
        lib.gru_split_max_clusters.argtypes = [_INT] * 8
        lib.gru_split_max_clusters.restype = _INT
        lib.gru_l2head_split_launch.argtypes = (
            [_VOIDP] * 10 + [_INT] * 7 + [_VOIDP])
        lib.gru_l2head_split_launch.restype = _INT
        lib.gru_l2head_split_smem.argtypes = [_INT] * 4
        lib.gru_l2head_split_smem.restype = ctypes.c_size_t
        lib.gru_split_error_string.argtypes = [_INT]
        lib.gru_split_error_string.restype = ctypes.c_char_p
        lib._medaka_typed = True
    return lib


def _check(lib, err: int, name: str):
    if err != 0:
        raise RuntimeError("{} launch failed: {} (cudaError {})".format(
            name, lib.gru_split_error_string(err).decode(), err))


def geometry(kind: str, H: int, B: int, dev, mode: str = "t",
             inputs: int = 0, classes: int = rnn_cluster.DEFAULT_CLASSES,
             quant: bool = True) -> Tuple[int, int, int, int]:
    """(C, BT, shared memory bytes, resident clusters) with which the
    int8 (``quant``) or bf16 cluster kernel of ``gru_l1_split`` (kind "l1",
    ``inputs`` features) or ``gru_l2head_split`` ("l2", ``classes`` head
    classes) launches at hidden size H and batch B on CUDA device ``dev``:
    both directions' clusters in one grid
    (:func:`rnn_cluster.choose_geometry` with the ``SPLIT`` or
    ``SPLIT_BF16`` layout); raises, naming the kernel, its mode and the
    geometry, when no cluster size fits or no cluster can be resident."""
    lib = build()
    name = _KERNELS[kind]

    def query(cluster, columns):
        n = lib.gru_split_max_clusters(int(quant), int(kind == "l2"),
                                       MODES[mode], cluster, columns, H,
                                       inputs, classes)
        if n < 0:
            _check(lib, -n, name)
        return n

    return rnn_cluster.geometry(
        _LAYOUTS[quant], kind, H, B, dev, query, cuda_build.SMEM_LIMIT,
        "{}/{}".format(name, mode) + ("" if quant else "/bf16"),
        directions=2, inputs=inputs, classes=classes)


def l2_route(H: int, classes: int, quant: bool) -> str:
    """The kernel that runs layer 2 at hidden size H with ``classes`` head
    classes: "cluster", or "per-block" for bf16 where no cluster size holds
    a block's W_hh and W_ih slices (H=384 and 512), decided from the shape
    alone."""
    if quant or rnn_cluster.fitting_clusters(
            rnn_cluster.SPLIT_BF16, "l2", H, cuda_build.SMEM_LIMIT,
            classes=classes):
        return "cluster"
    return "per-block"


def wave_batch(H: int, inputs: int, dev, limit: int, step: int = 32,
               classes: int = rnn_cluster.DEFAULT_CLASSES) -> int:
    """The largest batch, a multiple of ``step`` up to ``limit``, at which
    the int8 ``gru_l1_split`` (``inputs`` features) and ``gru_l2head_split``
    (``classes`` head classes) each run all their clusters at once (one
    wave) on CUDA device ``dev``, in the numerics mode that batch takes;
    ``step`` where none does."""
    for batch in range(limit // step * step, step - 1, -step):
        mode = split_mode(batch)
        if all(2 * -(-batch // geo[1]) <= geo[3] for geo in (
                geometry("l1", H, batch, dev, mode, inputs),
                geometry("l2", H, batch, dev, mode, classes=classes))):
            return batch
    return step


def _row_constants(cluster, *rows):
    """(2, 3H) per-row constants -> (2, C, len(rows), 3U) f32 in the int8
    slices' row order."""
    return torch.stack([torch.stack([
        rnn_cluster.row_slices(rnn_cluster.SPLIT, v[d].float(), cluster)
        for v in rows], dim=1) for d in range(2)]).contiguous()


def _slices(w, cluster, fn, quant=True):
    return torch.stack([fn(_LAYOUTS[quant], v, cluster) for v in w])


def l1_operands(x, w_ih, b_ih, w_hh, hh_scale, b_hh, cluster,
                quant: bool = True):
    """Layer 1's operands as the int8 (``quant``) or bf16 cluster kernel
    reads them on clusters of ``cluster`` blocks (every weight in the
    slices' row order): x (T, B, IN padded to 8) bf16, w_ih (2, C, 3U, IN
    rounded up to even) bf16, w_hh (2, C, 3U, Hp) int8 or bf16, rowc (2,
    C, 3, 3U) f32 (hh_scale, b_hh, b_ih); the padding is zeros."""
    IN = x.shape[-1]
    pad = torch.nn.functional.pad
    return {
        # features zero-padded to 16 bytes a column, for cp.async
        "x": pad(x.to(torch.bfloat16), (0, -IN % 8)).contiguous(),
        # rows of 32-bit feature pairs
        "w_ih": pad(_slices(w_ih.to(torch.bfloat16), cluster,
                            rnn_cluster.row_slices), (0, IN % 2)).contiguous(),
        "w_hh": _slices(w_hh, cluster, rnn_cluster.w_slices, quant),
        "rowc": _row_constants(cluster, hh_scale, b_hh, b_ih)}


def l2_operands(w_in, in_scale, b_ih, w_hh, hh_scale, b_hh, w_head,
                cluster, quant: bool = True):
    """Layer 2's operands as the int8 (``quant``) or bf16 cluster kernel
    reads them on clusters of ``cluster`` blocks: w_in (2, C, 3U, 2H) and
    w_hh (2, C, 3U, Hp), int8 or bf16, rowc (2, C, 5, 3U) f32 (hh_scale,
    b_hh, b_ih, the halves' input scales), w_head (2, C, 16 HT, U) bf16
    (W_head^T in HT = ``rnn_cluster.head_tiles`` m16 tiles: row k is class
    k of unit j = r U + u of block r; classes past C and padded units
    zero)."""
    H = w_hh.shape[-1]
    U = rnn_cluster.units_per_block(_LAYOUTS[quant], H, cluster)
    rows = 16 * rnn_cluster.head_tiles(w_head.shape[1])
    wh = torch.zeros((2, rows, cluster * U), dtype=torch.bfloat16,
                     device=w_head.device)
    wh[:, :w_head.shape[1], :H] = w_head.to(torch.bfloat16)
    wdt = torch.int8 if quant else torch.bfloat16
    return {
        "w_in": _slices(w_in.to(wdt), cluster, rnn_cluster.row_slices),
        "w_hh": _slices(w_hh, cluster, rnn_cluster.w_slices, quant),
        "rowc": _row_constants(cluster, hh_scale, b_hh, b_ih,
                               in_scale[:, 0], in_scale[:, 1]),
        "w_head": wh.reshape(2, rows, cluster, U).transpose(1, 2)
        .contiguous()}


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_l1(x, lengths, w_ih, b_ih, w_hh, hh_scale, b_hh, mode, quant,
               cluster=None):
    """Launch layer 1's int8 (``quant``) or bf16 cluster kernel;
    ``cluster`` = (C, BT) replaces the geometry :func:`geometry` chooses
    (``chip_ab.py`` times others)."""
    T, B, IN = x.shape
    H = w_hh.shape[-1]
    G3 = 3 * H
    cuda_build.check_inputs("gru_l1_split", H, [
        (x, (T, B, IN), None), (lengths, (B,), None),
        (w_ih, (2, G3, IN), None), (b_ih, (2, G3), None),
        (w_hh, (2, G3, H), torch.int8 if quant else torch.bfloat16),
        (hh_scale, (2, G3), None), (b_hh, (2, G3), None)])
    out_dtype = torch.int8 if quant else torch.bfloat16
    out_f = torch.empty((T, B, H), dtype=out_dtype, device=x.device)
    out_b = torch.empty((T, B, H), dtype=out_dtype, device=x.device)
    if T == 0 or B == 0:
        return out_f, out_b
    lib = build()
    lengths = lengths.to(torch.int32).contiguous()
    C, BT = cluster or geometry("l1", H, B, x.device, mode, IN,
                                quant=quant)[:2]
    op = l1_operands(x, w_ih, b_ih, w_hh, hh_scale, b_hh, C, quant)
    err = lib.gru_l1_split_cluster_launch(
        int(quant), op["x"].data_ptr(), lengths.data_ptr(),
        op["w_ih"].data_ptr(), op["rowc"].data_ptr(), op["w_hh"].data_ptr(),
        out_f.data_ptr(), out_b.data_ptr(), T, B, IN, H, C, BT, MODES[mode],
        _stream(x))
    _check(lib, err, "gru_l1_split")
    LAUNCHES["gru_l1_split"] += 1
    MODE_LAUNCHES["gru_l1_split/" + mode] += 1
    return out_f, out_b


def _launch_l2(prev_f, prev_b, lengths, w_in, in_scale, b_ih, w_hh,
               hh_scale, b_hh, w_head, mode, quant, cluster=None):
    """Launch layer 2 + head: the int8 (``quant``) or bf16 cluster kernel,
    or the per-block kernel where :func:`l2_route` says so; ``cluster`` =
    (C, BT) replaces the cluster geometry :func:`geometry` chooses."""
    T, B, H = prev_f.shape
    C = w_head.shape[1]
    G3 = 3 * H
    wdt = torch.int8 if quant else torch.bfloat16
    cuda_build.check_inputs("gru_l2head_split", H, [
        (prev_f, (T, B, H), wdt), (prev_b, (T, B, H), wdt),
        (lengths, (B,), None), (w_in, (2, G3, 2 * H), wdt),
        (in_scale, (2, 2, G3), None), (b_ih, (2, G3), None),
        (w_hh, (2, G3, H), wdt), (hh_scale, (2, G3), None),
        (b_hh, (2, G3), None), (w_head, (2, C, H), None)])
    if C > rnn_cluster.HEAD_CLASSES:
        raise ValueError("gru_l2head_split: at most {} classes, got "
                         "{}".format(rnn_cluster.HEAD_CLASSES, C))
    lg_f = torch.empty((B, T, C), dtype=torch.float32, device=prev_f.device)
    lg_b = torch.empty((B, T, C), dtype=torch.float32, device=prev_f.device)
    if T == 0 or B == 0:
        return lg_f, lg_b
    lib = build()
    prev_f = prev_f.contiguous()
    prev_b = prev_b.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    if l2_route(H, C, quant) == "cluster":
        cl, BT = cluster or geometry("l2", H, B, prev_f.device, mode,
                                     classes=C, quant=quant)[:2]
        op = l2_operands(w_in, in_scale, b_ih, w_hh, hh_scale, b_hh, w_head,
                         cl, quant)
        err = lib.gru_l2head_split_cluster_launch(
            int(quant), prev_f.data_ptr(), prev_b.data_ptr(),
            lengths.data_ptr(), op["w_in"].data_ptr(), op["rowc"].data_ptr(),
            op["w_hh"].data_ptr(), op["w_head"].data_ptr(), lg_f.data_ptr(),
            lg_b.data_ptr(), T, B, H, C, cl, BT, MODES[mode],
            _stream(prev_f))
    else:
        cpt, nq = cuda_build.tile_shape(B, cuda_build.sm_count(prev_f.device))
        while nq * H > 512:
            nq //= 2
        smem = lib.gru_l2head_split_smem(cpt, nq, H, C)
        if smem > cuda_build.SMEM_LIMIT:
            raise ValueError("gru_l2head_split: needs {} bytes of shared "
                             "memory (limit {})".format(
                                 smem, cuda_build.SMEM_LIMIT))
        w_in_il = cuda_build.interleave_chunks(w_in.contiguous())
        w_hh_il = cuda_build.interleave_chunks(w_hh.contiguous())
        b_ih, b_hh = [t.float().contiguous() for t in (b_ih, b_hh)]
        w_head_f = _bf16(w_head).contiguous()
        err = lib.gru_l2head_split_launch(
            prev_f.data_ptr(), prev_b.data_ptr(), lengths.data_ptr(),
            w_in_il.data_ptr(), b_ih.data_ptr(), w_hh_il.data_ptr(),
            b_hh.data_ptr(), w_head_f.data_ptr(), lg_f.data_ptr(),
            lg_b.data_ptr(), T, B, H, C, cpt, nq, MODES[mode],
            _stream(prev_f))
    _check(lib, err, "gru_l2head_split")
    LAUNCHES["gru_l2head_split"] += 1
    MODE_LAUNCHES["gru_l2head_split/" + mode] += 1
    return lg_f, lg_b


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def gru_l1_split(x, lengths, w_ih, b_ih, w_hh, hh_scale, b_hh,
                 mode: str = "t", quant: bool = True):
    """Layer 1 of the split path, both directions.

    :param x: (T, B, IN) bf16 time-major input.
    :param lengths: (B,) int32 valid lengths; h freezes at t >= length.
    :param w_ih: (2, 3H, IN) bf16 input weights (fwd, bwd).
    :param b_ih, b_hh: (2, 3H) f32 biases.
    :param w_hh: (2, 3H, H) int8 per-row quantised (``quant``) or bf16.
    :param hh_scale: (2, 3H) f32 per-row scales (ones when not ``quant``).
    :param mode: "t" or "rows" numerics (see the module docstring).
    :returns: (out_f, out_b), each (T, B, H): int8 round(127 h) when
        ``quant``, else bf16 h.
    """
    if mode not in MODES:
        raise ValueError("mode must be 't' or 'rows', got {!r}".format(mode))
    if x.is_cuda:
        return _launch_l1(x, lengths, w_ih, b_ih, w_hh, hh_scale, b_hh,
                          mode, quant)
    return gru_l1_split_plain(x, lengths, w_ih, b_ih, w_hh, hh_scale, b_hh,
                              mode, quant)


def gru_l2head_split(prev_f, prev_b, lengths, w_in, in_scale, b_ih, w_hh,
                     hh_scale, b_hh, w_head, mode: str = "t",
                     quant: bool = True):
    """Layer 2 + linear head of the split path: per-direction logits.

    :param prev_f, prev_b: (T, B, H) layer-1 outputs (int8 when
        ``quant``, else bf16).
    :param w_in: (2, 3H, 2H) layer-2 input weights; columns [:H] act on
        prev_f and [H:] on prev_b. int8 when ``quant``, else bf16.
    :param in_scale: (2, 2, 3H) f32 scales of the two column halves. Mode
        "t" reads the first half's (the merged per-row scale).
    :param w_head: (2, C, H) head weights of each direction's half, C at
        most ``rnn_cluster.HEAD_CLASSES`` (64) on the card.
    :returns: (lg_f, lg_b), each (B, T, C) f32; the caller adds both and
        the head bias.
    """
    if mode not in MODES:
        raise ValueError("mode must be 't' or 'rows', got {!r}".format(mode))
    if prev_f.is_cuda:
        return _launch_l2(prev_f, prev_b, lengths, w_in, in_scale, b_ih,
                          w_hh, hh_scale, b_hh, w_head, mode, quant)
    return gru_l2head_split_plain(prev_f, prev_b, lengths, w_in, in_scale,
                                  b_ih, w_hh, hh_scale, b_hh, w_head, mode,
                                  quant)


# ---------------------------------------------------------------------------
# the 2-layer stack
# ---------------------------------------------------------------------------


def _as_tensor(v, device):
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _stack(layer, key, device):
    return torch.stack([_as_tensor(layer["fwd"][key], device),
                        _as_tensor(layer["bwd"][key], device)])


def prepare_split_weights(layers: Sequence[Dict], head: Dict, mode: str,
                          quant: bool, device) -> Dict[str, torch.Tensor]:
    """Cast and quantise the stack's weights as the kernels take them."""
    l1, l2 = layers
    w_hh1 = _stack(l1, "w_hh", device)
    H = w_hh1.shape[-1]
    w_hh2 = _stack(l2, "w_hh", device)
    w_ih2 = _stack(l2, "w_ih", device)
    ones = torch.ones((2, 3 * H), dtype=torch.float32, device=device)
    if quant:
        w_hh1, sc1 = _quantize_rows(w_hh1)
        w_hh2, sc2 = _quantize_rows(w_hh2)
        sc1, sc2 = sc1[..., 0], sc2[..., 0]
        if mode == "t":
            w_in, s = _quantize_rows(w_ih2)
            in_scale = torch.stack([s[..., 0], s[..., 0]], dim=1)
        else:
            # per-column scales of the transposed halves
            # (pallas_gru.bigru_l2head) = per-row scales of each half
            qa, sa = _quantize_rows(w_ih2[:, :, :H])
            qb, sb = _quantize_rows(w_ih2[:, :, H:])
            w_in = torch.cat([qa, qb], dim=-1)
            in_scale = torch.stack([sa[..., 0], sb[..., 0]], dim=1)
    else:
        w_hh1 = w_hh1.to(torch.bfloat16)
        w_hh2 = w_hh2.to(torch.bfloat16)
        w_in = w_ih2.to(torch.bfloat16)
        sc1 = sc2 = ones
        in_scale = torch.stack([ones, ones], dim=1)
    w_head = _as_tensor(head["w"], device)
    return {
        "w_ih1": _stack(l1, "w_ih", device).to(torch.bfloat16),
        "b_ih1": _stack(l1, "b_ih", device), "w_hh1": w_hh1, "sc1": sc1,
        "b_hh1": _stack(l1, "b_hh", device),
        "w_in2": w_in, "in_scale2": in_scale,
        "b_ih2": _stack(l2, "b_ih", device), "w_hh2": w_hh2, "sc2": sc2,
        "b_hh2": _stack(l2, "b_hh", device),
        "w_head": torch.stack([w_head[:, :H], w_head[:, H:]]).to(
            torch.bfloat16),
        "b_head": _as_tensor(head["b"], device),
    }


def split_mode(batch: int, layout: Optional[str] = None) -> str:
    """Numerics mode: explicit ``layout`` or by batch size as JAX picks."""
    if layout is None:
        return "t" if batch >= T_MODE_MIN_BATCH else "rows"
    if layout in ("t", "transposed"):
        return "t"
    if layout == "rows":
        return "rows"
    raise ValueError("unknown layout {!r}".format(layout))


def bigru_head_fullfused(layers, head, x, lengths=None, quant: bool = True,
                         layout: Optional[str] = None,
                         device=None) -> torch.Tensor:
    """2-layer bi-GRU + linear head through the split kernels.

    Counterpart of ``pallas_gru.bigru_head_fullfused``.

    :param layers: two {"fwd", "bwd"} dicts of w_ih, w_hh, b_ih, b_hh.
    :param head: {"w": (C, 2H), "b": (C,)}.
    :param x: (B, T, F) batch-major features.
    :param lengths: (B,) valid lengths (None: all T).
    :param quant: int8 inter-layer activations, projections and
        recurrences; False runs bf16 throughout.
    :param layout: "transposed"/"t" or "rows" numerics; None picks "t"
        for B >= 192 as the JAX function does.
    :param device: "cuda" (default) or "cpu"; the CPU runs the kernels'
        plain versions.
    :returns: (B, T, C) float32 logits.
    """
    if len(layers) != 2:
        raise ValueError(
            "split path is specialised to 2-layer stacks; got {}".format(
                len(layers)))
    device = resolve_device(device)
    x = torch.as_tensor(x).to(device)
    B, T, _ = x.shape
    mode = split_mode(B, layout)
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=device)
    lengths = torch.as_tensor(lengths).to(device=device, dtype=torch.int32)
    w = prepare_split_weights(layers, head, mode, quant, device)
    xt = x.transpose(0, 1).to(torch.bfloat16).contiguous()
    out_f, out_b = gru_l1_split(
        xt, lengths, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["sc1"],
        w["b_hh1"], mode=mode, quant=quant)
    lg_f, lg_b = gru_l2head_split(
        out_f, out_b, lengths, w["w_in2"], w["in_scale2"], w["b_ih2"],
        w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"], mode=mode,
        quant=quant)
    return lg_f + lg_b + w["b_head"]
