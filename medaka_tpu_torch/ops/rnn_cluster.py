"""Host side of the cluster recurrences: launch geometry and W_hh slices.

The cluster recurrences (``csrc/rnn_train.cuh`` ``ClusterGeo``:
``lstm_fwd``/``lstm_bwd`` in ``csrc/lstm_train.cu``, the GRU backward in
``csrc/gru_train.cu``, the GRU forward of ``gru_fwd``, ``bigru_fused`` and
every ``bigru_fullfused`` mode in ``csrc/gru_rec.cuh``) run one tile of BT
batch columns of one direction on a thread-block cluster of C blocks. Block r keeps the gate rows of its U
hidden units of W_hh in shared memory for the whole walk. A
:class:`Layout` says how many gate rows a unit has and how many units a
warp's unit group holds; everything here is pure Python, mirrors the
kernels' byte counts, and is tested on the CPU.

The split kernels (``csrc/gru_split.cu``: ``gru_l1_split`` kind "l1",
``gru_l2head_split`` kind "l2") run the same cluster design with blocks of
up to 256 units and larger clusters where they buy one wave, with int8
weights (:data:`SPLIT`) or, where ``quant=False``, bf16 ones
(:data:`SPLIT_BF16`); ``bigru_fullfused_int8`` runs the GRU
forward with int8 weights in the same row order (:data:`GRU_INT8`), the
bf16-gates mode of ``bigru_fullfused`` with bf16 weights widened to f64 on
the FP64 tensor cores (:data:`GRU_BF16G`).
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
#: threads of a block at most by kind, where the kernel asks for fewer
#: (``gru_l2head_split`` keeps more of each step in registers)
KIND_MAX_THREADS = {"l2": 256}
#: head classes the layer-2 split kernel holds at most (``HEAD_MAX``: four
#: m16 tiles of W_head^T in its mma.sync head product)
HEAD_CLASSES = 64
#: layer 2's head classes where a caller names none: the haploid scheme's
DEFAULT_CLASSES = 5


class Layout(NamedTuple):
    """The row order of a kernel's weight slices and its limits.

    Unit group q of a block (``group`` units) holds rows
    ``q * gates * group + g * group + u`` (gate g, unit u).
    """
    gates: int
    group: int
    #: the forward stages an f32 cell state beside h (the LSTM)
    cell: bool
    #: bytes of a weight in the slices: 2 (bf16) or 1 (int8)
    wbytes: int = 2
    #: hidden units of a block at most
    max_units: int = MAX_UNITS
    #: batch columns a cluster, in the order tried
    tiles: Tuple[int, ...] = TILE_COLUMNS
    #: where no tile runs in one wave at the smallest cluster, try larger
    #: clusters (fewer units a block, more columns a cluster) first
    widen: bool = False
    #: threads of a block at most
    max_threads: int = MAX_THREADS
    #: try cluster sizes in order of a block's share of the step's product
    #: (its units times the padded H), least first, each as ``widen``
    #: tries them; else the smallest first
    least_work: bool = False
    #: where a cluster of 2 or more blocks runs the batch in one wave at
    #: the smallest tile, double it while a block keeps this many units at
    #: least, the wider blocks fit what the card holds at the narrower
    #: geometry (SMs that would idle) and the wider clusters still run in
    #: one wave; 0: never
    spread_units: int = 0


#: gates i, f, g, o; 8-unit groups: rows q*32 + g*8 + u
LSTM = Layout(gates=4, group=8, cell=True)
#: gates r, z, n; 16-unit groups: rows q*48 + g*16 + u (three m16 tiles)
GRU = Layout(gates=3, group=16, cell=False)
#: the split kernels' int8 mode: the GRU's rows, int8 slices of W_hh (K =
#: Hp) and, in layer 2, of W_ih (K = 2H), up to 256 units a block (C = 1
#: at H <= 256 in layer 1) and 64 columns a cluster
SPLIT = Layout(gates=3, group=16, cell=False, wbytes=1, max_units=256,
               tiles=(8, 16, 32, 64), widen=True)
#: the split kernels' bf16 mode (``quant=False``): SPLIT's rows and tiles
#: with bf16 slices and h, twice the bytes a row (clusters of 2 in layer 1
#: and 8 in layer 2 at H=256), 256 threads a block at most in both layers
#: (a thread's f64 accumulators), and one n8 tile a warp in layer 2
#: (twice the warps: 332 ms against 411 with two tiles at B=480 on an
#: H100, PERF.md). Small batches spread to 64 units a block: layer 1 at
#: H=256 and B <= 128 on clusters of 4, 8 columns (52.6 ms against 71.0
#: on clusters of 2 at B=32, T=10000; 8 and 16 blocks gain nothing more;
#: PERF.md)
SPLIT_BF16 = SPLIT._replace(wbytes=2, max_threads=256, spread_units=64)
#: the int8 GRU forward of ``bigru_fullfused_int8`` (``csrc/gru_rec.cuh``,
#: NUM_INT8): SPLIT's rows and int8 slices, 256 threads a block at most
#: (each warp keeps its rows of W_hh in registers). At most 32 units a
#: block: clusters of 8 at H=256, which step as fast as 16 and faster than
#: 2 or 4 on an H100 at B=16 and over one column (PERF.md), and every
#: H <= 512 fits
GRU_INT8 = Layout(gates=3, group=16, cell=False, wbytes=1, max_units=32,
                  max_threads=256)
#: the bf16-gates GRU forward of ``bigru_fullfused`` (``csrc/gru_rec.cuh``,
#: NUM_BF16G): the GRU's rows and bf16 slices, widened to f64 as they load;
#: the step's f64 product on the FP64 tensor cores is what it waits on, so
#: the cluster that gives a block the least of it comes first (16 units,
#: clusters of 16 at H=256; 32 units, the most, at H=512), in one wave
#: where that fits
GRU_BF16G = Layout(gates=3, group=16, cell=False, max_units=32,
                   max_threads=256, widen=True, least_work=True)


def units_per_block(layout: Layout, hidden: int, cluster: int) -> int:
    """Hidden units of one block: H over the cluster, rounded up to a
    multiple of the unit group (the padded units are zero rows)."""
    per = cluster * layout.group
    return -(-hidden // per) * layout.group


def _align16(v: int) -> int:
    return (v + 15) & ~15


def threads(layout: Layout, hidden: int, cluster: int, columns: int,
            kind: str = "") -> int:
    """Threads of a block: a warp for each unit group and 16 columns, or 8
    (BT=8, and bf16 layer 2: kind "l2" with 2-byte weights, as
    ``SplitGeo`` in ``csrc/gru_split.cu`` sets it)."""
    warps = units_per_block(layout, hidden, cluster) // layout.group
    one_tile = kind == "l2" and layout.wbytes == 2
    tile = 8 if one_tile else min(columns, 16)
    return 32 * warps * (columns // tile)


def gate_split(layout: Layout, hidden: int, cluster: int,
               columns: int) -> int:
    """Warps of a (unit group, column tile) of the GRU forward: the most of
    4, 2 and 1 whose block stays within 256 threads (``gru_gate_split`` in
    ``csrc/gru_rec.cuh``)."""
    base = threads(layout, hidden, cluster, columns)
    for share in (4, 2):
        if base * share <= 256:
            return share
    return 1


def _bf16g_smem_bytes(cluster: int, columns: int, hidden: int) -> int:
    """The bf16-gates forward's shared memory (``gru_cluster_fwd_smem`` in
    ``csrc/gru_rec.cuh``): the W slice and h [2][BT] in bf16 rows of Hp +
    16, the f64 partial sums of the S warps of each tile, the staged bf16
    h, two mbarriers."""
    U = units_per_block(GRU_BF16G, hidden, cluster)
    Hp = cluster * U
    nt = 2 if columns >= 16 else 1
    tiles = (U // 16) * (columns // (8 * nt))
    share = gate_split(GRU_BF16G, hidden, cluster, columns)
    row = 2 * Hp + 32
    part = share * tiles * 12 * nt * 32 * 8 if share > 1 else 0
    return (_align16(3 * U * row) + _align16(2 * columns * row)
            + _align16(part) + _align16(columns * U * 2) + 16)


def max_threads(kind: str, layout: Layout = None) -> int:
    """Threads of a block at most for a kernel of ``kind`` (and
    ``layout``)."""
    most = KIND_MAX_THREADS.get(kind, MAX_THREADS)
    return most if layout is None else min(most, layout.max_threads)


def head_slot(classes: int) -> int:
    """Partial logits a column keeps in layer 2's slot: the class count
    rounded up to 8 (``head_slot`` in ``csrc/gru_split.cu``)."""
    if not 0 < classes <= HEAD_CLASSES:
        raise ValueError("gru_l2head_split: 1 to {} classes, got {}".format(
            HEAD_CLASSES, classes))
    return -(-classes // 8) * 8


def head_tiles(classes: int) -> int:
    """m16 tiles of W_head^T in layer 2's head product: the class count
    over 16, rounded up (``head_tiles`` in ``csrc/gru_split.cu``)."""
    return -(-head_slot(classes) // 16)


def smem_bytes(layout: Layout, kind: str, cluster: int, columns: int,
               hidden: int, inputs: int = 0,
               classes: int = DEFAULT_CLASSES) -> int:
    """Dynamic shared memory of one block of a forward (kind "fwd") or
    backward ("bwd") cluster recurrence, as the kernel carves it
    (``ClusterGeo`` in ``csrc/rnn_train.cuh``), or of the split kernels'
    layer 1 (kind "l1", ``inputs`` features) or layer 2 + head ("l2",
    ``classes`` classes) (``SplitGeo`` in ``csrc/gru_split.cu``)."""
    U = units_per_block(layout, hidden, cluster)
    if kind in ("l1", "l2"):
        return _split_smem_bytes(layout, kind, cluster, columns, hidden,
                                 inputs, classes, U)
    if layout is GRU_BF16G:
        return _bf16g_smem_bytes(cluster, columns, hidden)
    if layout.wbytes == 1:
        # the int8 GRU forward: W_hh slice and h [2][BT] in int8 rows of
        # Hp + 16 bytes, the staged int8 h, the staged bf16 h, two
        # mbarriers
        row = cluster * U + 16
        return (_align16(layout.gates * U * row) + _align16(2 * columns * row)
                + _align16(columns * U) + _align16(columns * U * 2) + 16)
    ldw = cluster * U + 8        # padded bf16 row of W and of h
    nbytes = (_align16(layout.gates * U * ldw * 2)   # W_hh slice
              + _align16(2 * columns * ldw * 2))     # h (h_prev) x 2
    if kind == "fwd":
        # staged bf16 h (and the LSTM's f32 c) of the block's units and
        # the h exchange's two mbarriers
        return (nbytes + _align16(columns * U * 2)
                + (_align16(columns * U * 4) if layout.cell else 0) + 16)
    # bf16 dgates [BT][gates U + 8] and the dh partials [2][C][U][BT] f32
    return (nbytes + _align16(columns * (layout.gates * U + 8) * 2)
            + _align16(2 * cluster * U * columns * 4))


def _split_smem_bytes(layout, kind, cluster, columns, hidden, inputs,
                      classes, U):
    rows = layout.gates * U
    wb = layout.wbytes
    ldh = wb * cluster * U + 16  # padded row (bytes) of W_hh and of h
    ldi = 2 * wb * hidden + 16   # padded row of W_ih and the input
    nbytes = (_align16(rows * ldh) + _align16(2 * columns * ldh)
              + (_align16(columns * U * wb) if cluster > 1 else 0))
    if kind == "l1":
        # bf16 W_ih [3U][IN rounded up to even] and x [2][BT][IN padded
        # to 8]
        even = -(-inputs // 2) * 2
        padded = -(-inputs // 8) * 8
        return (nbytes + _align16(rows * even * 2)
                + _align16(2 * columns * padded * 2))
    # W_ih slice, [prev_f; prev_b] x 2 (int8) or x 1 (bf16), the head's
    # bf16 operands (bf16(h) x 2 and W_head^T, 16 rows a tile, of U + 8)
    # and the blocks' f32 partial logits of the block's ceil(BT / C)
    # columns, head_slot of them a column
    share = -(-columns // cluster)
    buffers = 2 if wb == 1 else 1
    return (nbytes + _align16(rows * ldi)
            + _align16(buffers * columns * ldi)
            + _align16((2 * columns + 16 * head_tiles(classes)) * (U + 8)
                       * 2)
            + (_align16(2 * cluster * share * head_slot(classes) * 4)
               if cluster > 1 else 0))


def _fits(layout, kind, hidden, cluster, columns, smem_limit, inputs,
          classes):
    """A block of C=``cluster`` and BT=``columns`` holds at most
    ``layout.max_units`` units, the kind's threads and ``smem_limit``
    bytes."""
    return (units_per_block(layout, hidden, cluster) <= layout.max_units
            and threads(layout, hidden, cluster, columns, kind)
            <= max_threads(kind, layout)
            and smem_bytes(layout, kind, cluster, columns, hidden, inputs,
                           classes) <= smem_limit)


def fitting_clusters(layout: Layout, kind: str, hidden: int,
                     smem_limit: int, inputs: int = 0,
                     classes: int = DEFAULT_CLASSES):
    """The cluster sizes whose blocks fit at the layout's smallest tile,
    in the order tried; empty where none does (a shape the kernel cannot
    run)."""
    return [c for c in CLUSTER_SIZES
            if _fits(layout, kind, hidden, c, layout.tiles[0], smem_limit,
                     inputs, classes)]


def choose_geometry(layout: Layout, kind: str, hidden: int, batch: int,
                    smem_limit: int,
                    max_clusters: Callable[[int, int, int], int],
                    directions: int = 1, name: str = "the launch",
                    inputs: int = 0, classes: int = DEFAULT_CLASSES):
    """(C, BT, shared memory bytes) of a launch.

    C is the smallest cluster size whose block holds at most
    ``layout.max_units`` units and fits ``smem_limit`` and the kind's
    threads at the smallest tile; BT the smallest tile of
    ``layout.tiles`` whose ``directions`` x ceil(B / BT) clusters are all
    resident at once (one wave), else the largest that fits. Where the
    layout ``widen``s and no tile runs in one wave, the next larger
    cluster sizes are tried the same way, in order, before that fallback;
    where it asks for ``least_work``, the cluster sizes are taken in order
    of a block's share of the step's product (its units times the padded
    H), least first; where it sets ``spread_units``, a small batch's
    one-wave geometry takes larger clusters as that field says.
    ``max_clusters(C, BT, smem)`` is how many clusters the card holds at
    once (``cudaOccupancyMaxActiveClusters``; about the SM count over C); a
    value below 1 raises, naming ``name`` (the kernel) and the geometry.
    ``inputs`` is layer 1's feature count (kind "l1"), ``classes``
    layer 2's head classes (kind "l2").
    """
    if hidden % 32 or not 0 < hidden <= 512:
        raise ValueError("hidden size {} must be a multiple of 32 and at "
                         "most 512".format(hidden))

    def fits(cluster, columns):
        return _fits(layout, kind, hidden, cluster, columns, smem_limit,
                     inputs, classes)

    def spread(choice, resident):
        cluster, columns, smem = choice
        tiles = directions * -(-batch // columns)
        while (layout.spread_units and cluster > 1
               and columns == layout.tiles[0]
               and 2 * cluster in CLUSTER_SIZES
               and units_per_block(layout, hidden, 2 * cluster)
               >= layout.spread_units
               and tiles * 2 * cluster <= resident * cluster
               and fits(2 * cluster, columns)):
            wider = smem_bytes(layout, kind, 2 * cluster, columns, hidden,
                               inputs, classes)
            wide_resident = max_clusters(2 * cluster, columns, wider)
            if tiles > wide_resident:
                break
            cluster, smem, resident = 2 * cluster, wider, wide_resident
        return cluster, columns, smem

    clusters = fitting_clusters(layout, kind, hidden, smem_limit, inputs,
                                classes)
    if layout.least_work:
        clusters.sort(key=lambda c: (
            c * units_per_block(layout, hidden, c) ** 2, c))
    if not clusters:
        raise ValueError("{}: no cluster size fits H={} in {} bytes of "
                         "shared memory".format(name, hidden, smem_limit))
    fallback = None
    for cluster in clusters if layout.widen else clusters[:1]:
        best = None
        for columns in layout.tiles:
            if not fits(cluster, columns):
                break
            smem = smem_bytes(layout, kind, cluster, columns, hidden, inputs,
                              classes)
            resident = max_clusters(cluster, columns, smem)
            if resident < 1:
                raise RuntimeError(
                    "{}: no cluster of {} blocks of {} columns with {} bytes "
                    "of shared memory can be resident (cudaOccupancyMax"
                    "ActiveClusters gave {})".format(
                        name, cluster, columns, smem, resident))
            best = (cluster, columns, smem)
            if directions * -(-batch // columns) <= resident:
                return spread(best, resident)
        fallback = fallback or best
    return fallback


def row_slices(layout: Layout, v: torch.Tensor,
               cluster: int) -> torch.Tensor:
    """(gates H, ...) rows -> (C, gates U, ...): block r's gate rows, in the
    kernels' order, zero for the padded units.

    Unit j = r U + q group + u (Hp = C U units, those at H and above zero)
    has its gate g at row q gates group + g group + u of slice r.
    """
    G = layout.gates
    H = v.shape[0] // G
    U = units_per_block(layout, H, cluster)
    rest = tuple(v.shape[1:])
    out = v.new_zeros((G, cluster * U) + rest)
    out[:, :H] = v.reshape((G, H) + rest)
    out = out.reshape((G, cluster, U // layout.group, layout.group) + rest)
    order = (1, 2, 0, 3) + tuple(range(4, out.dim()))
    return out.permute(order).reshape((cluster, G * U) + rest).contiguous()


def w_slices(layout: Layout, w_hh: torch.Tensor,
             cluster: int) -> torch.Tensor:
    """(gates H, H) W_hh -> (C, gates U, Hp): block r's gate rows, in the
    kernels' order (:func:`row_slices`), bf16 or, where the layout's
    weights are int8 (``wbytes`` 1), the int8 values as given; columns
    k >= H are zero.
    """
    H = w_hh.shape[1]
    Hp = cluster * units_per_block(layout, H, cluster)
    dtype = torch.int8 if layout.wbytes == 1 else torch.bfloat16
    w = torch.zeros((w_hh.shape[0], Hp), dtype=dtype, device=w_hh.device)
    w[:, :H] = w_hh.to(dtype)
    return row_slices(layout, w, cluster)


_RESIDENT: Dict[Tuple, int] = {}


def geometry(layout: Layout, kind: str, H: int, B: int, dev,
             query: Callable[[int, int], int], smem_limit: int,
             key: str, directions: int = 1, inputs: int = 0,
             classes: int = DEFAULT_CLASSES) -> Tuple[int, int, int, int]:
    """(C, BT, shared memory bytes, resident clusters) of a launch on CUDA
    device ``dev``: :func:`choose_geometry` with the card's resident
    clusters ``query(C, BT)`` (the library's
    ``cudaOccupancyMaxActiveClusters``; it raises on a CUDA error), cached
    under ``key`` (the kernel's name, and its mode where the kernel has
    modes), ``inputs`` and ``classes``."""
    dev = torch.device(dev)

    def resident(cluster, columns, smem):
        k = (key, cluster, columns, H, inputs, classes, dev.index)
        if k not in _RESIDENT:
            _RESIDENT[k] = query(cluster, columns)
        return _RESIDENT[k]

    with torch.cuda.device(dev):
        cluster, columns, smem = choose_geometry(
            layout, kind, H, B, smem_limit, resident, directions, key,
            inputs, classes)
        return cluster, columns, smem, resident(cluster, columns, smem)
