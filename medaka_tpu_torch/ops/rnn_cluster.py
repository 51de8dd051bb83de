"""Host side of the cluster recurrences: launch geometry and W_hh slices.

The cluster recurrences (``csrc/rnn_train.cuh`` ``ClusterGeo``:
``lstm_fwd``/``lstm_bwd`` in ``csrc/lstm_train.cu``, the GRU backward in
``csrc/gru_train.cu``, the GRU forward of every f32-gates launch,
``gru_fwd``, ``bigru_fused`` and ``bigru_fullfused``, in
``csrc/gru_rec.cuh``) run one tile of BT batch columns of one direction on
a thread-block cluster of C blocks. Block r keeps the gate rows of its U
hidden units of W_hh in shared memory for the whole walk. A
:class:`Layout` says how many gate rows a unit has and how many units a
warp's unit group holds; everything here is pure Python, mirrors the
kernels' byte counts, and is tested on the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

#: cluster sizes, in the order tried (above 8 needs the non-portable size)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
#: batch columns a cluster, in the order tried
TILE_COLUMNS = (8, 16, 32)
#: hidden units of a block at most
MAX_UNITS = 64
#: threads of a block at most
MAX_THREADS = 512


class Layout(NamedTuple):
    """The row order of a kernel's W_hh slices.

    Unit group q of a block (``group`` units) holds rows
    ``q * gates * group + g * group + u`` (gate g, unit u).
    """
    gates: int
    group: int
    #: the forward stages an f32 cell state beside h (the LSTM)
    cell: bool


#: gates i, f, g, o; 8-unit groups: rows q*32 + g*8 + u
LSTM = Layout(gates=4, group=8, cell=True)
#: gates r, z, n; 16-unit groups: rows q*48 + g*16 + u (three m16 tiles)
GRU = Layout(gates=3, group=16, cell=False)


def units_per_block(layout: Layout, hidden: int, cluster: int) -> int:
    """Hidden units of one block: H over the cluster, rounded up to a
    multiple of the unit group (the padded units are zero rows)."""
    per = cluster * layout.group
    return -(-hidden // per) * layout.group


def _align16(v: int) -> int:
    return (v + 15) & ~15


def threads(layout: Layout, hidden: int, cluster: int, columns: int) -> int:
    """Threads of a block: a warp for each unit group and 8 (BT=8) or 16
    columns."""
    warps = units_per_block(layout, hidden, cluster) // layout.group
    return 32 * warps * (columns // min(columns, 16))


def smem_bytes(layout: Layout, kind: str, cluster: int, columns: int,
               hidden: int) -> int:
    """Dynamic shared memory of one block of a forward (kind "fwd") or
    backward ("bwd") cluster recurrence, as the kernel carves it
    (``ClusterGeo`` in ``csrc/rnn_train.cuh``)."""
    U = units_per_block(layout, hidden, cluster)
    ldw = cluster * U + 8        # padded bf16 row of W and of h
    nbytes = (_align16(layout.gates * U * ldw * 2)   # W_hh slice
              + _align16(2 * columns * ldw * 2))     # h (h_prev) x 2
    if kind == "fwd":
        # staged bf16 h (and the LSTM's f32 c) of the block's units
        return (nbytes + _align16(columns * U * 2)
                + (_align16(columns * U * 4) if layout.cell else 0))
    # bf16 dgates [BT][gates U + 8] and the dh partials [2][C][U][BT] f32
    return (nbytes + _align16(columns * (layout.gates * U + 8) * 2)
            + _align16(2 * cluster * U * columns * 4))


def choose_geometry(layout: Layout, kind: str, hidden: int, batch: int,
                    smem_limit: int,
                    max_clusters: Callable[[int, int, int], int],
                    directions: int = 1, name: str = "the launch"):
    """(C, BT, shared memory bytes) of a launch.

    C is the smallest cluster size whose block holds at most
    :data:`MAX_UNITS` units and fits ``smem_limit`` at the smallest tile;
    BT the smallest tile of :data:`TILE_COLUMNS` whose ``directions`` x
    ceil(B / BT) clusters are all resident at once (one wave), else the
    largest that fits. ``max_clusters(C, BT, smem)`` is how many clusters
    the card holds at once (``cudaOccupancyMaxActiveClusters``; about the
    SM count over C); a value below 1 raises, naming ``name`` (the kernel)
    and the geometry.
    """
    if hidden % 32 or not 0 < hidden <= 512:
        raise ValueError("hidden size {} must be a multiple of 32 and at "
                         "most 512".format(hidden))
    for cluster in CLUSTER_SIZES:
        if units_per_block(layout, hidden, cluster) <= MAX_UNITS and \
                smem_bytes(layout, kind, cluster, TILE_COLUMNS[0],
                           hidden) <= smem_limit:
            break
    else:
        raise ValueError("no cluster size fits H={} in {} bytes of shared "
                         "memory".format(hidden, smem_limit))
    best = None
    for columns in TILE_COLUMNS:
        smem = smem_bytes(layout, kind, cluster, columns, hidden)
        if smem > smem_limit:
            break
        resident = max_clusters(cluster, columns, smem)
        if resident < 1:
            raise RuntimeError(
                "{}: no cluster of {} blocks of {} columns with {} bytes of "
                "shared memory can be resident (cudaOccupancyMaxActiveClusters"
                " gave {})".format(name, cluster, columns, smem, resident))
        best = (cluster, columns, smem)
        if directions * -(-batch // columns) <= resident:
            break
    return best


def w_slices(layout: Layout, w_hh: torch.Tensor,
             cluster: int) -> torch.Tensor:
    """(gates H, H) W_hh -> (C, gates U, Hp) bf16: block r's gate rows, in
    the kernels' order.

    Unit j = r U + q group + u (Hp = C U units, those at H and above zero)
    has its gate g at row q gates group + g group + u of slice r; columns
    k >= H are zero.
    """
    H = w_hh.shape[1]
    G = layout.gates
    U = units_per_block(layout, H, cluster)
    Hp = cluster * U
    w = torch.zeros((G, Hp, Hp), dtype=torch.bfloat16, device=w_hh.device)
    w[:, :H, :H] = w_hh.to(torch.bfloat16).reshape(G, H, H)
    w = w.reshape(G, cluster, U // layout.group, layout.group, Hp)
    return w.permute(1, 2, 0, 3, 4).reshape(cluster, G * U, Hp).contiguous()


_RESIDENT: Dict[Tuple, int] = {}


def geometry(layout: Layout, kind: str, H: int, B: int, dev,
             query: Callable[[int, int], int], smem_limit: int,
             key: str, directions: int = 1) -> Tuple[int, int, int, int]:
    """(C, BT, shared memory bytes, resident clusters) of a launch on CUDA
    device ``dev``: :func:`choose_geometry` with the card's resident
    clusters ``query(C, BT)`` (the library's
    ``cudaOccupancyMaxActiveClusters``; it raises on a CUDA error), cached
    under ``key`` (the kernel's name)."""
    dev = torch.device(dev)

    def resident(cluster, columns, smem):
        k = (key, cluster, columns, H, dev.index)
        if k not in _RESIDENT:
            _RESIDENT[k] = query(cluster, columns)
        return _RESIDENT[k]

    with torch.cuda.device(dev):
        cluster, columns, smem = choose_geometry(
            layout, kind, H, B, smem_limit, resident, directions, key)
        return cluster, columns, smem, resident(cluster, columns, smem)
