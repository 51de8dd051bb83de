#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

Run from the root of a checkout, on a machine with an NVIDIA GPU, the
CUDA toolkit (``nvcc``) and PyTorch for CUDA:

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the script when it fails:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``medaka_tpu_torch/csrc`` with ``nvcc``
   (one process per source, all at once), and the host-side pileup and
   read-matrix library with ``g++``;
3. hold the split-path GRU kernels against their plain PyTorch versions
   at full width (H=256, 10 features, 5 classes, T=2000, ragged lengths)
   in all four numerics combinations: mode "t" at B=256 and mode "rows"
   at B=64, each with int8 quantisation on and off; hold the bi-LSTM
   kernel against its plain version at H=128 (B=128, T=1000) and H=384
   (B=32, T=500), ragged lengths, random weights;
4. write a synthetic 0.5 Mb BAM at depth 20 and its draft;
5. the counts main path: ``medaka_tpu_torch inference`` with the bundled
   ``gru256_lambda_demo_model_pt`` at chunk_len 10000 and the automatic
   batch, then ``sequence``, through the CLI entry point in this process
   with the split kernels' launch counts set to 0 just before;
6. check its output: finite probabilities that sum to 1, the consensus
   identity to the draft, and the int8 kernels against the float32 scan
   on eight real chunks;
7. at its shape, hold each split kernel against its plain version and
   time it beside its plain version, the cuDNN ``nn.GRU`` yardstick and
   its bound; the same for mode "rows" on 64 rows;
8. the read-level main path: ``inference`` with the bundled
   ``rl_lstm128_lambda_demo`` at chunk_len 1000, overlap 100 and the
   automatic batch, then ``sequence``, with the bi-LSTM kernel's launch
   count set to 0 just before; the same output checks;
9. on one full batch of that path: the model through the kernel against
   the model through the kernel's plain version, a stage breakdown
   (CUDA events), and the kernel's time beside its plain version, its
   serial floor (one column), the cuDNN ``nn.LSTM`` yardstick and its
   bound;
10. hold the GRU training kernels (``gru_fwd``, ``gru_bwd``) against
    their plain versions at full width (H=256, B=128, T=1000, ragged
    lengths, random weights, both directions), and ``gru_bwd`` against
    itself run again (bit for bit);
11. the training path: a truth BAM for the synthetic genome, then
    ``features --truth`` and ``train`` (counts ``GRUModel`` at full width,
    batch 128, 2 epochs, bf16) through the CLI entry point, with the
    training kernels' launch counts set to 0 just before ``train``; check
    the losses (finite, falling), 4 launches of each kernel a step, a
    second run from the same seed (the same losses), and that the last
    checkpoint serves ``inference`` + ``sequence``;
12. on one full batch of that data: one train step through the kernels
    against the same step through their plain versions, a stage
    breakdown of a step (CUDA events), the step's wall time, and each
    kernel's time beside its plain version, its serial floor, the cuDNN
    ``nn.GRU`` yardstick and its bound;
13. hold the LSTM training kernels (``lstm_fwd``, ``lstm_bwd``) against
    their plain versions at H=384 (L2 route) and H=128 (the forward's
    shared-memory route), B=128, T=1000, ragged lengths, random weights,
    both directions, and ``lstm_bwd`` against itself run again (bit for
    bit);
14. the read-level training path: a 0.5 Mb synthetic BAM with move
    tables (dwells) and its truth BAM, ``features --truth
    --feature_encoder ReadAlignmentFeatureEncoder`` at the encoder's
    defaults (max_reads 100, dwells), then ``train`` with no ``--model``
    (the full-width ``LatentSpaceLSTM``: lstm_size 384, cnn_size 128,
    kernel sizes 1 and 17), batch 128, 2 epochs, bf16, through the CLI
    entry point, with the LSTM kernels' launch counts set to 0 just
    before ``train``; check the losses (finite, falling), 4 launches of
    each kernel a step, the batch-norm running statistics moved off
    (0, 1), a second run from the same seed (the same losses), and that
    the last checkpoint serves ``inference`` + ``sequence``;
15. on one full batch of that data (B=128, T=1000, 100 reads, H=384):
    one train step through the kernels against the same step through
    their plain versions, a stage breakdown (CUDA events), the step's
    wall time, device-busy share and peak memory, and each LSTM kernel's
    time beside its plain version, its serial floor, the cuDNN
    ``nn.LSTM`` yardstick and its bound; print one ``kernels`` JSON line.

The last line of standard output is the device JSON object. The script
imports nothing of JAX and nothing of the ``medaka_tpu`` package.
"""
import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(HERE, "medaka_tpu", "data",
                     "gru256_lambda_demo_model_pt.tar.gz")
RL_MODEL = os.path.join(HERE, "medaka_tpu", "data",
                        "rl_lstm128_lambda_demo.tar.gz")
KERNEL_SOURCE = "medaka_tpu_torch/csrc/gru_split.cu"
BILSTM_SOURCE = "medaka_tpu_torch/csrc/bilstm.cu"
TRAIN_SOURCE = "medaka_tpu_torch/csrc/gru_train.cu"
LSTM_TRAIN_SOURCE = "medaka_tpu_torch/csrc/lstm_train.cu"
REPLACES = {
    "gru_l1_split": "medaka_tpu/ops/pallas_gru.py:1371 "
                    "(_bigru_l1_split_t_kernel, mode t); :982 "
                    "(_bigru_l1_split_kernel, mode rows)",
    "gru_l2head_split": "medaka_tpu/ops/pallas_gru.py:1452 "
                        "(_bigru_l2head_t_kernel, mode t); :1055 "
                        "(_bigru_l2head_kernel, mode rows)",
    "bilstm_fused": "medaka_tpu/ops/pallas_gru.py:340 _bilstm_kernel "
                    "(bilstm_pallas :400)",
    "gru_fwd": "medaka_tpu/ops/pallas_gru.py:56 _gru_kernel (gru_pallas "
               ":105)",
    "gru_bwd": "medaka_tpu/ops/pallas_gru.py:1615 _gru_bwd_kernel "
               "(gru_bwd_pallas :1696)",
    "lstm_fwd": "medaka_tpu/ops/pallas_gru.py:1852 _lstm_kernel "
                "(lstm_pallas :1905)",
    "lstm_bwd": "medaka_tpu/ops/pallas_gru.py:1966 _lstm_bwd_kernel "
                "(lstm_bwd_pallas :2042)",
}
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 op/s,
# bf16 flop/s, f32 flop/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
# bi-LSTM kernel vs its plain version: the same operations, f32 sums of
# the recurrent product in another order, which can move one bf16
# rounding of h: one bf16 step for |h| < 1
TOL_LSTM = 2.0 ** -8
# f32 operations per hidden unit and step besides the product: 8 gate
# adds, 3 sigmoids of 4 and 2 tanh of 1, 3 for c, 1 for h
LSTM_ELEMENTWISE_OPS = 26
# kernel vs plain version: both do the same operations; only the order of
# f32 sums differs (cuBLAS vs a sequential loop), which can move one
# round(127 h) or bf16 cast across a rounding boundary
TOL_L1 = {True: 1.0, False: 2.0 ** -7}   # one int8 step / one bf16 ulp
TOL_L1_MEAN = 1e-3
TOL_LOGIT = 1e-3
TOL_PROB = 1e-3
MIN_ARGMAX_AGREEMENT = 0.9999
# int8 split path vs the float32 scan on real chunks of T=10000: the
# quantisation error, not a kernel fault (the kernels match their plain
# versions). Mean and argmax agreement carry the check; the max is the
# worst of ~80,000 columns, where a near-tie moves the most probability.
TOL_SCAN_PROB_MAX = 5e-2
TOL_SCAN_PROB_MEAN = 1e-3
MIN_SCAN_ARGMAX_AGREEMENT = 0.999
# GRU training kernels vs their plain versions: the same operations, f32
# sums (the recurrent products, dW_hh, db_hh) in another order, which can
# move a bf16 rounding: forward outputs within one bf16 step, mean 1e-3;
# backward dxp, dW_hh, db_hh within 1e-3 of each tensor's largest
# magnitude. One train step through the kernels vs through the plain
# versions: loss within 1e-5 relative, each gradient within 1e-2 of its
# largest magnitude.
TOL_GRU_FWD = 2.0 ** -8
TOL_GRU_BWD = 1e-3
TOL_STEP_LOSS = 1e-5
TOL_STEP_GRAD = 1e-2
# f32 operations per hidden unit and step besides the products: forward
# 3 bias adds, 2 gate adds, 2 sigmoids of 4, r hp_n and its add, tanh, 4
# for h; backward the same gates (16) and 25 for the gradients, db_hh and
# dh
GRU_FWD_ELEMENTWISE_OPS = 20
GRU_BWD_ELEMENTWISE_OPS = 41
# LSTM training kernels vs their plain versions: the same operations, f32
# sums in another order: h within one bf16 step (mean 1e-3), c within
# 1e-3 of its largest magnitude; dxp, dW_hh, db_hh within 1e-3 of each
# tensor's largest magnitude (TOL_GRU_BWD). f32 operations per hidden
# unit and step besides the products: forward as LSTM_ELEMENTWISE_OPS;
# backward the same gates (21), c and tanh(c) (4), dc_tot and the four
# gate gradients (21), the valid masks (4), db_hh (4), the carried dh and
# dc (8) and the upstream add (1)
TOL_LSTM_C = 1e-3
LSTM_BWD_ELEMENTWISE_OPS = 63
# one read-level train step through the kernels vs through the plain
# versions: loss within TOL_STEP_LOSS, the LSTM stack's and the head's
# gradients within TOL_STEP_GRAD. Below the stack the gradient flows in
# bf16 (dxp is cast to the projections' bf16): the kernels' f32 sums in
# another order move some of those roundings by one step, and the conv,
# batch-norm and embedding gradients are sums over every read and
# position that cancel, so a small leaf can differ by a few percent of
# its largest element (2% on an H100 in the card tests); each of those
# leaves must point the same way
MIN_UPSTREAM_COSINE = 0.999


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def phase(name):
    log("== {}".format(name))
    t0 = time.perf_counter()
    yield
    log("   {} done in {:.1f} s".format(name, time.perf_counter() - t0))


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps=3, warmup=1):
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def yardstick_ms(features, width, depth, hidden, dev):
    """Time cuDNN's bf16 ``nn.GRU(width, hidden, depth, bidirectional)``.

    Layer 1 (``width`` = number of features) runs over ``features``; a
    layer over another width runs over zeros of that width and shape.
    """
    import torch
    rows, T, IN = features.shape
    x = (torch.from_numpy(features).to(dev, torch.bfloat16) if width == IN
         else torch.zeros((rows, T, width), dtype=torch.bfloat16,
                          device=dev))
    gru = torch.nn.GRU(width, hidden, depth, batch_first=True,
                       bidirectional=True).to(dev, torch.bfloat16)
    gru.flatten_parameters()   # one weight buffer, no copy on every call
    try:
        return cuda_ms(lambda: gru(x))
    finally:
        del gru, x
        torch.cuda.empty_cache()


def random_net(rng, hidden=256, features=10, classes=5):
    import torch

    def direction(in_size):
        k = 1.0 / hidden ** 0.5
        return {name: torch.from_numpy(
            rng.uniform(-k, k, shape).astype("float32"))
            for name, shape in (("w_ih", (3 * hidden, in_size)),
                                ("w_hh", (3 * hidden, hidden)),
                                ("b_ih", (3 * hidden,)),
                                ("b_hh", (3 * hidden,)))}
    layers = [{"fwd": direction(features), "bwd": direction(features)},
              {"fwd": direction(2 * hidden), "bwd": direction(2 * hidden)}]
    k = 1.0 / (2 * hidden) ** 0.5
    head = {"w": torch.from_numpy(
                rng.uniform(-k, k, (classes, 2 * hidden)).astype("float32")),
            "b": torch.from_numpy(
                rng.uniform(-k, k, (classes,)).astype("float32"))}
    return layers, head


def run_layers(gru_split, w, xt, lengths, mode, quant, plain):
    """Layer 1 then layer 2 + head, by kernel or by plain version."""
    l1 = gru_split.gru_l1_split_plain if plain else gru_split.gru_l1_split
    l2 = (gru_split.gru_l2head_split_plain if plain
          else gru_split.gru_l2head_split)
    out_f, out_b = l1(xt, lengths, w["w_ih1"], w["b_ih1"], w["w_hh1"],
                      w["sc1"], w["b_hh1"], mode=mode, quant=quant)
    lg_f, lg_b = l2(out_f, out_b, lengths, w["w_in2"], w["in_scale2"],
                    w["b_ih2"], w["w_hh2"], w["sc2"], w["b_hh2"],
                    w["w_head"], mode=mode, quant=quant)
    return (out_f, out_b), (lg_f, lg_b)


def compare_kernels(gru_split, w, xt, lengths, mode, quant):
    """Each kernel against its plain version on the same inputs.

    Returns (l1 max err, l2 max logit err, network stats, kernel outputs).
    """
    import torch
    T, B, _ = xt.shape
    (kf, kb), (kl_f, kl_b) = run_layers(gru_split, w, xt, lengths, mode,
                                        quant, plain=False)
    pf, pb = gru_split.gru_l1_split_plain(
        xt, lengths, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["sc1"],
        w["b_hh1"], mode=mode, quant=quant)
    # layer 2's plain version on the kernel's own layer-1 outputs
    ql_f, ql_b = gru_split.gru_l2head_split_plain(
        kf, kb, lengths, w["w_in2"], w["in_scale2"], w["b_ih2"],
        w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"], mode=mode,
        quant=quant)
    torch.cuda.synchronize()
    valid = (torch.arange(T, device=xt.device)[None, :]
             < lengths[:, None].long())
    l1_err = max((a.float() - b.float()).abs().max().item()
                 for a, b in ((kf, pf), (kb, pb)))
    l1_mean = max((a.float() - b.float()).abs().mean().item()
                  for a, b in ((kf, pf), (kb, pb)))
    l2_err = max((a - b).abs()[valid].max().item()
                 for a, b in ((kl_f, ql_f), (kl_b, ql_b)))
    if l1_err > TOL_L1[quant] or l1_mean > TOL_L1_MEAN:
        raise AssertionError("gru_l1_split disagrees with its plain version:"
                             " max {} mean {}".format(l1_err, l1_mean))
    if l2_err > TOL_LOGIT:
        raise AssertionError("gru_l2head_split disagrees with its plain "
                             "version: max logit diff {}".format(l2_err))
    # the whole network, kernel path against plain path
    _, (pl_f, pl_b) = run_layers(gru_split, w, xt, lengths, mode, quant,
                                 plain=True)
    b_head = w["b_head"]
    pk = torch.softmax(kl_f + kl_b + b_head, -1)[valid]
    pp = torch.softmax(pl_f + pl_b + b_head, -1)[valid]
    diff = (pk - pp).abs()
    stats = {"max": diff.max().item(), "mean": diff.mean().item(),
             "argmax_agreement": (pk.argmax(-1) == pp.argmax(-1)).float()
             .mean().item()}
    if stats["max"] > TOL_PROB or \
            stats["argmax_agreement"] < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(
            "kernel path disagrees with the plain path: {}".format(stats))
    return l1_err, l2_err, stats, (kf, kb)


def bound(kind, B, H, IN, C, lengths_sum):
    """Least time (ms) for one call (int8), and what bounds it.

    Bytes and operations are both counted over the valid columns of this
    run's data (``lengths_sum`` of them): a padded column is neither read
    nor computed, and its output holds no result that any consumer reads.
    Bytes: every valid input column and the weights read once, every
    valid output column written once, over the memory rate. Operations:
    int8 multiply-adds at the int8 peak, bf16 ones at the bf16 peak.
    """
    dirs = 2
    weights_f32 = dirs * 3 * 3 * H * 4          # two biases + scales
    if kind == "gru_l1_split":
        nbytes = (lengths_sum * IN * 2 + B * 4 + dirs * 3 * H * IN * 2
                  + dirs * 3 * H * H + weights_f32 + dirs * lengths_sum * H)
        int8_macs = dirs * lengths_sum * 3 * H * H
        bf16_macs = dirs * lengths_sum * 3 * H * IN
    else:
        nbytes = (dirs * lengths_sum * H + B * 4 + dirs * 3 * H * 2 * H
                  + dirs * 3 * H * H + weights_f32 + dirs * 2 * 3 * H * 4
                  + dirs * C * H * 4 + dirs * lengths_sum * C * 4)
        int8_macs = dirs * lengths_sum * (3 * H * 2 * H + 3 * H * H)
        bf16_macs = dirs * lengths_sum * C * H
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (2 * int8_macs / PEAK_INT8 + 2 * bf16_macs / PEAK_BF16) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def check_probabilities(datastore, hdf):
    """Finite (n, 5) probabilities summing to 1 in every sample of
    ``hdf``; returns (samples, columns)."""
    import numpy as np
    index = datastore.DataIndex(hdf)
    n_columns = 0
    with datastore.DataStore(hdf) as ds:
        for name, _ in index.samples:
            probs = ds.load_sample(name).label_probs
            if probs.ndim != 2 or probs.shape[1] != 5 or \
                    not np.all(np.isfinite(probs)):
                raise AssertionError("bad probabilities " + name)
            if np.abs(probs.sum(-1) - 1).max() > 1e-2:
                raise AssertionError("probabilities do not sum to 1")
            n_columns += probs.shape[0]
    return len(index.samples), n_columns


def consensus_identity(testing, fasta, draft):
    """(identity to the draft, edits, consensus length); the edits are the
    upper bound of ``testing.greedy_edit_count``."""
    from medaka_tpu_torch.io.fastx import FastaReader
    with FastaReader(draft) as fr:
        draft_seq = fr.fetch("synth")
    with FastaReader(fasta) as fr:
        consensus = fr.fetch("synth")
    edits = testing.greedy_edit_count(consensus.encode(), draft_seq.encode())
    return 1.0 - edits / len(draft_seq), edits, len(consensus)


def random_lstm_inputs(rng, H, B, T, dev):
    """bilstm_fused arguments: bf16 projections, uniform weights and
    biases as torch initialises them, ragged lengths (the first full)."""
    import torch
    k = 1.0 / H ** 0.5

    def uniform(lo, hi, shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype("float32"))

    lengths = torch.from_numpy(rng.integers(T // 2, T + 1, B).astype("int32"))
    lengths[0] = T
    return (uniform(-2, 2, (T, B, 4 * H)).to(dev, torch.bfloat16),
            uniform(-2, 2, (T, B, 4 * H)).to(dev, torch.bfloat16),
            uniform(-k, k, (2, 4 * H, H)).to(dev),
            uniform(-k, k, (2, 4 * H)).to(dev), lengths.to(dev))


def compare_bilstm(bilstm, args):
    """bilstm_fused against its plain version on the same inputs, both
    directions; returns (max, mean) absolute difference."""
    import torch
    got = bilstm.bilstm_fused(*args)
    want = bilstm.bilstm_fused_plain(*args)
    torch.cuda.synchronize()
    diffs = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
    err = max(d.max().item() for d in diffs)
    mean = max(d.mean().item() for d in diffs)
    if err > TOL_LSTM or mean > TOL_L1_MEAN:
        raise AssertionError("bilstm_fused disagrees with its plain version:"
                             " max {} mean {}".format(err, mean))
    return err, mean


def timed_stage(events, name, fn):
    """``fn()``; with an ``events`` list, between two CUDA events appended
    to it as (name, start, stop)."""
    import torch
    if events is None:
        return fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    events.append((name, start, stop))
    return out


def read_level_stages(model, bilstm, x, lengths, plain=False, events=None):
    """``LatentSpaceLSTM``'s bf16 forward stage by stage, the LSTM stack as
    ``bilstm_stack_fused`` runs it; returns the logits.

    :param plain: run the kernel's plain version in its place.
    :param events: a list to which (stage, start, stop) CUDA events are
        appended.
    """
    import torch
    cd = torch.bfloat16
    layer_fn = bilstm.bilstm_fused_plain if plain else bilstm.bilstm_fused

    def stage(name, fn, *args):
        return timed_stage(events, name, lambda: fn(*args))

    def projections(out, fwd, bwd):
        return (bilstm.project(out, fwd["w_ih"], fwd["b_ih"], cd),
                bilstm.project(out, bwd["w_ih"], bwd["b_ih"], cd))

    feats, non_empty = stage("embed + convs + BN", model.read_features, x,
                             cd)
    pooled = stage("mean-pool + pre_pool", model.pool, feats, non_empty, cd)
    del feats
    out = pooled.transpose(0, 1)
    for k, layer in enumerate(model.layer_params(), start=1):
        fwd, bwd = layer["fwd"], layer["bwd"]
        xp_f, xp_b = stage("projections, layer {}".format(k), projections,
                           out, fwd, bwd)
        w_hh = torch.stack([fwd["w_hh"], bwd["w_hh"]])
        b_hh = torch.stack([fwd["b_hh"], bwd["b_hh"]])
        out_f, out_b = stage("bilstm_fused, layer {}".format(k), layer_fn,
                             xp_f, xp_b, w_hh, b_hh, lengths)
        out = torch.cat([out_f, out_b], dim=-1)
    return stage("head", model.head, out.transpose(0, 1))


def bilstm_bound(B, H, lengths_sum):
    """Least time (ms) of one bilstm_fused call, and what bounds it.

    Counted over the valid columns (``lengths_sum``), as for the split
    kernels. Bytes: both directions' bf16 projections read and bf16
    outputs written once, the f32 W_hh and b_hh and the lengths read
    once, over the memory rate. Operations: the recurrent products
    (2 x 4H x H multiply-adds per direction, column and step) at the bf16
    tensor-core peak, plus LSTM_ELEMENTWISE_OPS f32 operations per unit,
    direction and step at the f32 peak.
    """
    G = 4 * H
    nbytes = (2 * lengths_sum * G * 2 + 2 * lengths_sum * H * 2
              + 2 * G * H * 4 + 2 * G * 4 + B * 4)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (2 * 2 * lengths_sum * G * H / PEAK_BF16
             + 2 * lengths_sum * H * LSTM_ELEMENTWISE_OPS / PEAK_F32) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def train_bound(name, B, H, lengths_sum):
    """Least time (ms) of one gru_fwd, gru_bwd, lstm_fwd or lstm_bwd call,
    what bounds it, and the bytes counted.

    Counted over the valid columns (``lengths_sum``), as for the other
    kernels. A forward reads the bf16 projections and writes the bf16
    outputs (the LSTM also its f32 cell states); a backward reads the bf16
    projections and outputs (the LSTM also the f32 cell states) and the
    f32 upstream gradient and writes the f32 dxp; all read the f32 W_hh,
    b_hh and the lengths, and a backward writes dW_hh and db_hh, once.
    Operations: the recurrent products (one in a forward; in a backward
    the recomputed gates, the dh product and dW_hh), 2 x G x H each per
    column (G = 3H gate rows for the GRU, 4H for the LSTM), at the bf16
    tensor-core peak, plus the f32 gate arithmetic at the f32 peak.
    """
    lstm = name.startswith("lstm")
    G = (4 if lstm else 3) * H
    cells = H * 4 if lstm else 0
    weights = G * H * 4 + G * 4 + B * 4
    if name.endswith("fwd"):
        nbytes = lengths_sum * (G * 2 + H * 2 + cells) + weights
        products = 1
        elementwise = LSTM_ELEMENTWISE_OPS if lstm else \
            GRU_FWD_ELEMENTWISE_OPS
    else:
        nbytes = (lengths_sum * (G * 2 + H * 2 + cells + H * 4 + G * 4)
                  + weights + G * H * 4 + G * 4)
        products = 3
        elementwise = LSTM_BWD_ELEMENTWISE_OPS if lstm else \
            GRU_BWD_ELEMENTWISE_OPS
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (products * 2 * lengths_sum * G * H / PEAK_BF16
             + lengths_sum * H * elementwise / PEAK_F32) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes
    return t_ops, "operations", nbytes


def random_direction(rng, H, B, T, dev, gates=3):
    """gru_fwd (``gates`` 3) or lstm_fwd (4) arguments and an upstream
    gradient: bf16 projections, uniform weights and biases as torch
    initialises them, ragged lengths (the first full)."""
    import torch
    k = 1.0 / H ** 0.5

    def uniform(lo, hi, shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype("float32"))

    lengths = torch.from_numpy(rng.integers(T // 2, T + 1, B).astype("int32"))
    lengths[0] = T
    dh_out = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        "float32")).to(dev, torch.bfloat16).float()
    return (uniform(-2, 2, (T, B, gates * H)).to(dev, torch.bfloat16),
            uniform(-k, k, (gates * H, H)).to(dev),
            uniform(-k, k, (gates * H,)).to(dev), lengths.to(dev), dh_out)


def compare_gru_train(gru_train, xp, w_hh, b_hh, lengths, dh_out, reverse):
    """gru_fwd and gru_bwd against their plain versions (the backward on
    the kernel's forward outputs), and gru_bwd against itself; returns
    {"fwd_max", "fwd_mean", "dxp", "dW_hh", "db_hh"} (backward: largest
    difference over the tensor's largest magnitude)."""
    import torch
    out = gru_train.gru_fwd(xp, w_hh, b_hh, lengths, reverse)
    ref = gru_train.gru_fwd_plain(xp, w_hh, b_hh, lengths, reverse)
    got = gru_train.gru_bwd(xp, out, dh_out, w_hh, b_hh, lengths, reverse)
    want = gru_train.gru_bwd_plain(xp, out, dh_out, w_hh, b_hh, lengths,
                                   reverse)
    again = gru_train.gru_bwd(xp, out, dh_out, w_hh, b_hh, lengths, reverse)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    stats = {"fwd_max": diff.max().item(), "fwd_mean": diff.mean().item()}
    for name, g, w in zip(("dxp", "dW_hh", "db_hh"), got, want):
        stats[name] = ((g - w).abs().max() / w.abs().max()).item()
    if stats["fwd_max"] > TOL_GRU_FWD or stats["fwd_mean"] > TOL_L1_MEAN:
        raise AssertionError("gru_fwd disagrees with its plain version: "
                             "{}".format(stats))
    if max(stats["dxp"], stats["dW_hh"], stats["db_hh"]) > TOL_GRU_BWD:
        raise AssertionError("gru_bwd disagrees with its plain version: "
                             "{}".format(stats))
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError("gru_bwd does not repeat bit for bit")
    return stats


def staged_train_step(model, optimizer, batch, gru_train, parallel,
                      events=None, plain=False, update=True):
    """One bf16 train step of ``GRUModel`` stage by stage, as
    ``parallel.make_train_step`` runs it; returns the loss.

    :param events: a list to which (stage, start, stop) CUDA events are
        appended.
    :param plain: the training kernels' plain versions in their place.
    :param update: apply the optimizer (else leave the gradients).
    """
    import torch
    cd = torch.bfloat16

    def stage(name, fn):
        return timed_stage(events, name, fn)

    params = list(model.parameters())
    for p in params:
        p.grad = None
    lengths = batch["lengths"]
    out = batch["features"].transpose(0, 1).to(cd)
    for layer in model.layer_params():
        dirs = (("fwd", False), ("bwd", True))
        xps = stage("projections", lambda out=out, layer=layer: [
            gru_train.project(out, layer[d]["w_ih"], layer[d]["b_ih"], cd)
            for d, _ in dirs])
        out = stage("gru_fwd x4", lambda xps=xps, layer=layer: torch.cat([
            gru_train.GRUDirection.apply(
                xp, layer[d]["w_hh"], layer[d]["b_hh"], lengths, rev, plain)
            for xp, (d, rev) in zip(xps, dirs)], dim=-1))
    feats = out.transpose(0, 1)

    def head_loss():
        logits = (feats.float() @ model.linear.weight.float().t()
                  + model.linear.bias.float())
        return parallel.masked_cross_entropy(logits, batch)

    loss = stage("head + loss", head_loss)
    stage("backward (gru_bwd x4, projection gradients)", loss.backward)
    if update:
        stage("optimizer (clip + adam)",
              lambda: parallel.apply_updates(params, optimizer))
    return loss


def profile_step(step, step_s):
    """Device time by CUDA kernel over one call of ``step`` (the profiler's
    CUPTI trace), and the device's busy share of the step's wall time
    ``step_s``; a profiler that cannot trace the card is reported, not
    fatal (the CUDA-event stages stand)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        by_kernel = {}
        for evt in prof.key_averages():
            # kernels only: an operator's own row repeats its kernels' time
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
            if us > 0:
                name = evt.key.replace("(anonymous namespace)::", "")
                name = name.split("(")[0][:80]
                by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3
    except Exception as e:   # the measurement tool, not the program
        log("   torch.profiler could not trace the card: {}".format(e))
        return None
    device_ms = sum(by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    out = {"device_ms": device_ms,
           "device_busy_share": device_ms / (step_s * 1e3),
           "top_kernels_ms": top}
    log("   profiler: device time {:.2f} ms ({:.1%} of the step's wall "
        "time); by kernel: {}".format(device_ms, out["device_busy_share"],
                                     json.dumps(top)))
    return out


def training_phases(seed, work, bam, draft, dev, rng, agreement, modules):
    """The training path and its measurements (phases 11 and 12); returns
    the ``kernels`` rows of gru_fwd and gru_bwd."""
    import numpy as np
    import torch
    cli, datastore, gru_train, parallel, training = (
        modules[k] for k in ("cli", "datastore", "gru_train", "parallel",
                             "training"))
    from medaka_tpu_torch import testing
    from medaka_tpu_torch.models.gru import GRUModel
    truth = os.path.join(work, "truth.bam")
    train_hdf = os.path.join(work, "train.hdf")
    with phase("training data: truth BAM + features --truth"):
        testing.create_truth_bam(truth, draft)
        if cli.main(["features", bam, train_hdf, "--truth", truth,
                     "--quiet"]) != 0:
            raise AssertionError("features failed")
    train_cmd = ["train", train_hdf, "--batch_size", "128", "--epochs", "2",
                 "--optimizer", "adam", "--optim_args", "learning_rate=1e-3",
                 "--seed", str(seed), "--quiet"]
    run = os.path.join(work, "run")
    with phase("training path: train, 2 epochs at batch 128"):
        gru_train.reset_launches()
        t0 = time.perf_counter()
        if cli.main(train_cmd + ["--train_name", run]) != 0:
            raise AssertionError("train failed")
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = dict(gru_train.LAUNCHES)
    with open(os.path.join(run, "training.csv")) as fh:
        csv_rows = [line.split(",") for line in fh.read().splitlines()]
    header, csv_rows = csv_rows[0], csv_rows[1:]
    col = {name: i for i, name in enumerate(header)}
    losses = [float(r[col["loss"]]) for r in csv_rows]
    train_losses = [float(r[col["loss"]]) for r in csv_rows
                    if r[col["split"]] == "train"]
    steps = len(train_losses)
    log("   {} train steps in {:.1f} s; launches {}; train losses {}; "
        "validation losses {}".format(
            steps, t_train, launches, train_losses,
            [float(r[col["loss"]]) for r in csv_rows
             if r[col["split"]] == "validation"]))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("a logged loss is not finite")
    if not train_losses[-1] < train_losses[0]:
        raise AssertionError("the training loss did not fall")
    if launches != {"gru_fwd": 4 * steps, "gru_bwd": 4 * steps}:
        raise AssertionError("expected 4 launches of each training kernel "
                             "a step, got {}".format(launches))

    with phase("training path: the same run again"):
        again = os.path.join(work, "again")
        if cli.main(train_cmd + ["--train_name", again]) != 0:
            raise AssertionError("second train failed")
        with open(os.path.join(again, "training.csv")) as fh:
            rows2 = [line.split(",") for line in fh.read().splitlines()[1:]]
        keep = [col[k] for k in ("split", "epoch", "batch", "loss", "acc")]
        if [[r[i] for i in keep] for r in rows2] != \
                [[r[i] for i in keep] for r in csv_rows]:
            raise AssertionError("a second run from the same seed logged "
                                 "other losses")
        log("   the same {} losses and accuracies".format(len(rows2)))

    with phase("training path: the last checkpoint serves"):
        ckpt = os.path.join(run, "model-1.tar.gz")
        hdf = os.path.join(work, "trained_probs.hdf")
        fasta = os.path.join(work, "trained.fasta")
        if cli.main(["inference", bam, hdf, "--model", ckpt]) != 0 or \
                cli.main(["sequence", hdf, draft, fasta]) != 0:
            raise AssertionError("the trained checkpoint did not serve")
        n_samples, n_columns = check_probabilities(datastore, hdf)
        identity, edits, cons_len = consensus_identity(testing, fasta, draft)
        log("   {} samples, {} columns of finite probabilities; consensus "
            "{} bp, identity to the draft {:.6f} after {} steps".format(
                n_samples, n_columns, cons_len, identity, steps))

    batcher = training.TrainBatcher([train_hdf], batch_size=128, seed=seed)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(batcher.batches("train", seed=0)).items()}
    B, T = batch["features"].shape[:2]
    lengths_sum = int(batch["lengths"].sum())
    with phase("one train step at B=128 T=1000: kernels vs plain"):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = GRUModel(gru_size=256).to(dev)
        H = model.gru_size
        with torch.no_grad():
            loss_direct, _ = parallel.cross_entropy_loss(
                model, batch, compute_dtype=torch.bfloat16, training=True)
        results = {}
        for plain in (False, True):
            loss = staged_train_step(model, None, batch, gru_train, parallel,
                                     plain=plain, update=False)
            results[plain] = (loss.item(), {
                n: p.grad.clone() for n, p in model.named_parameters()})
        if loss_direct.item() != results[False][0]:
            raise AssertionError("the staged step's loss differs from the "
                                 "model's")
        loss_k, grads_k = results[False]
        loss_p, grads_p = results[True]
        step_stats = {"loss_kernels": loss_k, "loss_plain": loss_p,
                      "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
                      "grad_rel_max": max(
                          ((grads_k[n] - g).abs().max() / g.abs().max())
                          .item() for n, g in grads_p.items())}
        log("   " + json.dumps(step_stats))
        if step_stats["loss_rel"] > TOL_STEP_LOSS or \
                step_stats["grad_rel_max"] > TOL_STEP_GRAD:
            raise AssertionError("the step through the kernels disagrees "
                                 "with the step through the plain versions")
        del results, grads_k, grads_p

    with phase("train step: stage breakdown, wall time"):
        opt = training.build_optimizer("adam", None,
                                       {"learning_rate": 1e-3})
        step_fn = parallel.make_train_step(model, opt)
        for _ in range(2):
            step_fn(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step_fn(batch)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / 3
        events = []
        staged_train_step(model, opt, batch, gru_train, parallel,
                          events=events)
        torch.cuda.synchronize()
        stages = {}
        for name, start, stop in events:
            stages[name] = stages.get(name, 0.0) + start.elapsed_time(stop)
        log("   stage breakdown (ms): " + json.dumps(stages))
        log("   step wall time {:.2f} ms: {:.0f} trained columns/s "
            "({} valid columns)".format(step_s * 1e3, lengths_sum / step_s,
                                        lengths_sum))
        profile = profile_step(lambda: step_fn(batch), step_s)

    with phase("training kernels at B=128 T=1000: timings"):
        layer1, layer2 = model.layer_params()
        with torch.no_grad():
            x1 = batch["features"].transpose(0, 1).to(torch.bfloat16)
            lens = batch["lengths"]
            h1 = torch.cat([gru_train.gru_fwd(
                gru_train.project(x1, layer1[d]["w_ih"], layer1[d]["b_ih"]),
                layer1[d]["w_hh"], layer1[d]["b_hh"], lens, rev)
                for d, rev in (("fwd", False), ("bwd", True))], dim=-1)
            p2 = layer2["fwd"]
            xp = gru_train.project(h1, p2["w_ih"], p2["b_ih"])
            w_hh, b_hh = p2["w_hh"].detach(), p2["b_hh"].detach()
            out = gru_train.gru_fwd(xp, w_hh, b_hh, lens)
            dh_out = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
                "float32")).to(dev, torch.bfloat16).float()
            main_stats = compare_gru_train(gru_train, xp, w_hh, b_hh, lens,
                                           dh_out, False)
            one = (xp[:, :1].contiguous(), lens[:1])
            out1 = gru_train.gru_fwd(one[0], w_hh, b_hh, one[1])
            calls = {
                "gru_fwd": (
                    lambda: gru_train.gru_fwd(xp, w_hh, b_hh, lens),
                    lambda: gru_train.gru_fwd_plain(xp, w_hh, b_hh, lens),
                    lambda: gru_train.gru_fwd(one[0], w_hh, b_hh, one[1])),
                "gru_bwd": (
                    lambda: gru_train.gru_bwd(xp, out, dh_out, w_hh, b_hh,
                                              lens),
                    lambda: gru_train.gru_bwd_plain(xp, out, dh_out, w_hh,
                                                    b_hh, lens),
                    lambda: gru_train.gru_bwd(one[0], out1, dh_out[:, :1]
                                              .contiguous(), w_hh, b_hh,
                                              one[1])),
            }
            timed = {name: (cuda_ms(k), cuda_ms(pl, reps=1, warmup=0),
                            cuda_ms(o)) for name, (k, pl, o) in calls.items()}
        # yardstick (the port never calls it): cuDNN's bf16 GRU, one
        # direction over layer 2's inputs, its input projection included
        gru = torch.nn.GRU(2 * H, H, 1).to(dev, torch.bfloat16)
        gru.flatten_parameters()
        x2 = h1.detach().clone().requires_grad_(True)
        with torch.no_grad():
            lib_fwd = cuda_ms(lambda: gru(x2))
        g_out = torch.ones((T, B, H), dtype=torch.bfloat16, device=dev)
        lib_params = [x2] + list(gru.parameters())
        lib_fwd_bwd = cuda_ms(lambda: torch.autograd.grad(
            gru(x2)[0], lib_params, g_out))
        del gru, x2
        log("   torch.nn.GRU({}, {}, 1) bf16 (cuDNN) over the same {} rows, "
            "its input projection included: forward {:.2f} ms, forward + "
            "backward {:.2f} ms".format(2 * H, H, B, lib_fwd, lib_fwd_bwd))

    rows = []
    for name in ("gru_fwd", "gru_bwd"):
        ms, plain_ms, floor_ms = timed[name]
        bound_ms, bound_by, nbytes = train_bound(name, B, H, lengths_sum)
        if name == "gru_fwd":
            err = max([agreement[d]["fwd_max"] for d in agreement]
                      + [main_stats["fwd_max"]])
        else:
            err = max(agreement[d][k] for d in agreement
                      for k in ("dxp", "dW_hh", "db_hh"))
            err = max(err, main_stats["dxp"], main_stats["dW_hh"],
                      main_stats["db_hh"])
        rows.append({
            "name": name, "route": "cuda", "source": TRAIN_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_per_step": launches[name] // steps,
            "max_abs_err": err,
            "err_measure": ("max abs difference of bf16 outputs"
                            if name == "gru_fwd" else
                            "max abs difference over the tensor's max "
                            "magnitude, worst of dxp, dW_hh, db_hh"),
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": nbytes,
            "library_ms": lib_fwd if name == "gru_fwd" else None,
            "library": (
                "torch.nn.GRU({0}, {1}, 1) bf16 (cuDNN) forward over the "
                "same {2} rows, its input projection included: {3:.2f} ms"
                .format(2 * H, H, B, lib_fwd) if name == "gru_fwd" else
                "no PyTorch call computes a GRU's backward alone; "
                "torch.nn.GRU({0}, {1}, 1) bf16 (cuDNN) forward + backward "
                "(autograd.grad for input and weights) over the same {2} "
                "rows: {3:.2f} ms".format(2 * H, H, B, lib_fwd_bwd)),
            "library_fwd_bwd_ms": lib_fwd_bwd,
            "serial_floor_ms": floor_ms,
            "shape": {"B": B, "T": T, "H": H, "valid_columns": lengths_sum,
                      "layer": 2, "direction": "forward"},
            "agreement": {"random_weights": agreement,
                          "main_shape": main_stats},
        })
        log("   {}: {:.3f} ms (plain {:.1f} ms, bound {:.4f} ms by {}, one "
            "column {:.3f} ms; {})".format(name, ms, plain_ms, bound_ms,
                                           bound_by, floor_ms,
                                           rows[-1]["library"]))
    # one train step's numbers, once, on the first of the two rows
    rows[0]["train_step"] = {
        "vs_plain": step_stats, "stages_ms": stages, "profile": profile,
        "wall_ms": step_s * 1e3,
        "trained_columns_per_s": lengths_sum / step_s,
        "steps_in_run": steps}
    return rows


def compare_lstm_train(lstm_train, xp, w_hh, b_hh, lengths, dh_out,
                       reverse):
    """lstm_fwd and lstm_bwd against their plain versions (the backward on
    the kernel's forward outputs), and lstm_bwd against itself; returns
    {"fwd_max", "fwd_mean", "c", "dxp", "dW_hh", "db_hh"} (c and the
    backward: largest difference over the tensor's largest magnitude)."""
    import torch
    out, c_out = lstm_train.lstm_fwd(xp, w_hh, b_hh, lengths, reverse)
    ref, c_ref = lstm_train.lstm_fwd_plain(xp, w_hh, b_hh, lengths, reverse)
    args = (xp, out, c_out, dh_out, w_hh, b_hh, lengths, reverse)
    got = lstm_train.lstm_bwd(*args)
    want = lstm_train.lstm_bwd_plain(*args)
    again = lstm_train.lstm_bwd(*args)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    stats = {"fwd_max": diff.max().item(), "fwd_mean": diff.mean().item(),
             "c": ((c_out - c_ref).abs().max() / c_ref.abs().max()).item()}
    for name, g, w in zip(("dxp", "dW_hh", "db_hh"), got, want):
        stats[name] = ((g - w).abs().max() / w.abs().max()).item()
    if stats["fwd_max"] > TOL_GRU_FWD or stats["fwd_mean"] > TOL_L1_MEAN \
            or stats["c"] > TOL_LSTM_C:
        raise AssertionError("lstm_fwd disagrees with its plain version: "
                             "{}".format(stats))
    if max(stats["dxp"], stats["dW_hh"], stats["db_hh"]) > TOL_GRU_BWD:
        raise AssertionError("lstm_bwd disagrees with its plain version: "
                             "{}".format(stats))
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError("lstm_bwd does not repeat bit for bit")
    return stats


def staged_rl_train_step(model, optimizer, batch, lstm_train, parallel,
                         events=None, plain=False, update=True):
    """One bf16 train step of the bidirectional ``LatentSpaceLSTM`` stage
    by stage, as ``parallel.make_train_step`` runs it (the forward of
    ``forward(training=True)`` with ``lstm_train.bilstm_stack_trainable``
    written out); returns the loss.

    :param events: a list to which (stage, start, stop) CUDA events are
        appended.
    :param plain: the LSTM kernels' plain versions in their place.
    :param update: apply the optimizer and the running statistics (else
        leave the gradients).
    """
    import torch
    cd = torch.bfloat16

    def stage(name, fn):
        return timed_stage(events, name, fn)

    params = list(model.parameters())
    for p in params:
        p.grad = None
    stats = []
    lengths = batch["lengths"].to(torch.int32)
    dirs = (("fwd", False), ("bwd", True))
    with parallel.deterministic_convolutions():
        feats, non_empty = stage(
            "embeddings + convs + BN statistics",
            lambda: model.read_features(batch["features"], cd, True, stats))
        pooled = stage("pool + pre_pool",
                       lambda: model.pool(feats, non_empty, cd))
        del feats
        out = pooled.transpose(0, 1).to(cd)
        for layer in model.layer_params():
            xps = stage("projections", lambda out=out, layer=layer: [
                lstm_train.project(out, layer[d]["w_ih"], layer[d]["b_ih"],
                                   cd) for d, _ in dirs])
            out = stage("lstm_fwd x4", lambda xps=xps, layer=layer: torch.cat(
                [lstm_train.LSTMDirection.apply(
                    xp, layer[d]["w_hh"], layer[d]["b_hh"], lengths, rev,
                    plain) for xp, (d, rev) in zip(xps, dirs)], dim=-1))
        feats_out = out.transpose(0, 1)
        loss = stage("head + loss", lambda: parallel.masked_cross_entropy(
            model.head(feats_out), batch))
        stage("backward (lstm_bwd x4, conv, BN and projection gradients)",
              loss.backward)
    if update:
        def finish():
            parallel.apply_updates(params, optimizer)
            parallel.update_running_stats(model, stats)
        stage("optimizer (clip + adam) + running statistics", finish)
    return loss


def read_level_training_phases(seed, work, dev, rng, agreement, modules):
    """The read-level training path and its measurements (phases 14 and
    15); returns the ``kernels`` rows of lstm_fwd and lstm_bwd."""
    import torch
    cli, datastore, lstm_train, models, parallel, training = (
        modules[k] for k in ("cli", "datastore", "lstm_train", "models",
                             "parallel", "training"))
    from medaka_tpu_torch import testing
    from medaka_tpu_torch.models.latent_space_lstm import LatentSpaceLSTM
    with phase("read-level training data: 0.5 Mb BAM with move tables, "
               "truth BAM, features --truth"):
        bam, draft = testing.create_synth_bam(
            os.path.join(work, "rl_reads.bam"), ref_mb=0.5, depth=20,
            seed=seed, move_tables=True)
        truth = testing.create_truth_bam(os.path.join(work, "rl_truth.bam"),
                                         draft)
        train_hdf = os.path.join(work, "rl_train.hdf")
        if cli.main(["features", bam, train_hdf, "--truth", truth,
                     "--feature_encoder", "ReadAlignmentFeatureEncoder",
                     "--quiet"]) != 0:
            raise AssertionError("read-level features failed")
    train_cmd = ["train", train_hdf, "--batch_size", "128", "--epochs", "2",
                 "--optimizer", "adam", "--optim_args", "learning_rate=1e-3",
                 "--seed", str(seed), "--quiet"]
    run = os.path.join(work, "rl_run")
    with phase("read-level training path: train, 2 epochs at batch 128"):
        torch.cuda.empty_cache()
        lstm_train.reset_launches()
        t0 = time.perf_counter()
        if cli.main(train_cmd + ["--train_name", run]) != 0:
            raise AssertionError("read-level train failed")
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = dict(lstm_train.LAUNCHES)
    with open(os.path.join(run, "training.csv")) as fh:
        csv_rows = [line.split(",") for line in fh.read().splitlines()]
    header, csv_rows = csv_rows[0], csv_rows[1:]
    col = {name: i for i, name in enumerate(header)}
    losses = [float(r[col["loss"]]) for r in csv_rows]
    train_losses = [float(r[col["loss"]]) for r in csv_rows
                    if r[col["split"]] == "train"]
    steps = len(train_losses)
    log("   {} train steps in {:.1f} s; launches {}; train losses {}; "
        "validation losses {}; baseline accuracy {}".format(
            steps, t_train, launches, train_losses,
            [float(r[col["loss"]]) for r in csv_rows
             if r[col["split"]] == "validation"],
            [r[col["baseline_acc"]] for r in csv_rows]))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("a logged read-level loss is not finite")
    if not train_losses[-1] < train_losses[0]:
        raise AssertionError("the read-level training loss did not fall")
    if launches != {"lstm_fwd": 4 * steps, "lstm_bwd": 4 * steps}:
        raise AssertionError("expected 4 launches of each LSTM training "
                             "kernel a step, got {}".format(launches))
    ckpt = os.path.join(run, "model-1.tar.gz")
    trained = models.load_model(ckpt).model
    geometry = trained.to_dict()["kwargs"]
    log("   trained model: {}".format(json.dumps(geometry)))
    if (geometry["lstm_size"], geometry["cnn_size"],
            geometry["kernel_sizes"], geometry["use_dwells"]) != \
            (384, 128, [1, 17], True):
        raise AssertionError("train did not build the full-width default")
    running = []
    for k, layer in enumerate(trained.convs):
        bn = layer["bn"]
        running.append({"layer": k, "mean_abs": bn.mean.abs().mean().item(),
                        "var_mean": bn.var.mean().item()})
        if torch.equal(bn.mean, torch.zeros_like(bn.mean)) or \
                torch.equal(bn.var, torch.ones_like(bn.var)):
            raise AssertionError("the running statistics of conv layer {} "
                                 "did not move".format(k))
    log("   batch-norm running statistics: {}".format(json.dumps(running)))
    del trained

    with phase("read-level training path: the same run again"):
        again = os.path.join(work, "rl_again")
        if cli.main(train_cmd + ["--train_name", again]) != 0:
            raise AssertionError("second read-level train failed")
        with open(os.path.join(again, "training.csv")) as fh:
            rows2 = [line.split(",") for line in fh.read().splitlines()[1:]]
        keep = [col[k] for k in ("split", "epoch", "batch", "loss", "acc")]
        if [[r[i] for i in keep] for r in rows2] != \
                [[r[i] for i in keep] for r in csv_rows]:
            raise AssertionError(
                "a second read-level run from the same seed logged other "
                "losses: {} vs {}".format([r[col["loss"]] for r in rows2],
                                          [r[col["loss"]] for r in csv_rows]))
        log("   the same {} losses and accuracies".format(len(rows2)))

    with phase("read-level training path: the last checkpoint serves"):
        hdf = os.path.join(work, "rl_trained_probs.hdf")
        fasta = os.path.join(work, "rl_trained.fasta")
        if cli.main(["inference", bam, hdf, "--model", ckpt, "--chunk_len",
                     "1000", "--chunk_ovlp", "100"]) != 0 or \
                cli.main(["sequence", hdf, draft, fasta]) != 0:
            raise AssertionError("the read-level checkpoint did not serve")
        n_samples, n_columns = check_probabilities(datastore, hdf)
        identity, edits, cons_len = consensus_identity(testing, fasta, draft)
        log("   {} samples, {} columns of finite probabilities; consensus "
            "{} bp, identity to the draft {:.6f} after {} steps".format(
                n_samples, n_columns, cons_len, identity, steps))

    batcher = training.TrainBatcher([train_hdf], batch_size=128, seed=seed)
    host = next(batcher.batches("train", seed=0))
    host.pop("baseline_pred")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    B, T, R = batch["features"].shape[:3]
    lengths_sum = int(batch["lengths"].sum())
    torch.cuda.empty_cache()
    with phase("one read-level train step at B=128 T=1000 R=100 H=384: "
               "kernels vs plain"):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = LatentSpaceLSTM(lstm_size=384, use_dwells=True).to(dev)
        H = model.lstm_size
        with parallel.deterministic_convolutions():
            loss_direct = parallel.cross_entropy_loss(
                model, batch, compute_dtype=torch.bfloat16,
                training=True)[0].item()
        results = {}
        for plain in (False, True):
            loss = staged_rl_train_step(model, None, batch, lstm_train,
                                        parallel, plain=plain, update=False)
            results[plain] = (loss.item(), {
                n: p.grad.clone() for n, p in model.named_parameters()})
        # the same operations in the same order: the same loss, within the
        # f32 rounding of a reduction that a library may split otherwise
        if abs(loss_direct - results[False][0]) > 1e-6 * abs(loss_direct):
            raise AssertionError("the staged read-level step's loss {} "
                                 "differs from the model's {}".format(
                                     results[False][0], loss_direct))
        loss_k, grads_k = results[False]
        loss_p, grads_p = results[True]

        def rel(n):
            g = grads_p[n]
            return ((grads_k[n] - g).abs().max() / g.abs().max()).item()

        def cosine(n):
            a = grads_k[n].double().flatten()
            b = grads_p[n].double().flatten()
            return (a @ b / (a.norm() * b.norm()).clamp(min=1e-300)).item()

        stack = [n for n in grads_p if n.startswith(("lstm.", "linear."))]
        upstream = [n for n in grads_p if n not in stack]
        step_stats = {"loss_kernels": loss_k, "loss_plain": loss_p,
                      "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
                      "grad_rel_max": max(rel(n) for n in stack),
                      "upstream_grad_rel_max": max(rel(n) for n in upstream),
                      "upstream_grad_cosine_min": min(
                          cosine(n) for n in upstream)}
        log("   " + json.dumps(step_stats))
        if step_stats["loss_rel"] > TOL_STEP_LOSS or \
                step_stats["grad_rel_max"] > TOL_STEP_GRAD or \
                step_stats["upstream_grad_cosine_min"] < MIN_UPSTREAM_COSINE:
            raise AssertionError("the read-level step through the kernels "
                                 "disagrees with the step through the "
                                 "plain versions")
        del results, grads_k, grads_p

    with phase("read-level train step: stage breakdown, wall time, memory"):
        opt = training.build_optimizer("adam", None,
                                       {"learning_rate": 1e-3})
        step_fn = parallel.make_train_step(model, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_fn(batch)
        torch.cuda.synchronize()
        peak_bytes = torch.cuda.max_memory_allocated()
        step_fn(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step_fn(batch)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / 3
        events = []
        staged_rl_train_step(model, opt, batch, lstm_train, parallel,
                             events=events)
        torch.cuda.synchronize()
        stages = {}
        for name, start, stop in events:
            stages[name] = stages.get(name, 0.0) + start.elapsed_time(stop)
        log("   stage breakdown (ms): " + json.dumps(stages))
        log("   step wall time {:.2f} ms: {:.0f} trained columns/s ({} "
            "valid columns); peak memory {:.2f} GB".format(
                step_s * 1e3, lengths_sum / step_s, lengths_sum,
                peak_bytes / 1e9))
        profile = profile_step(lambda: step_fn(batch), step_s)

    with phase("LSTM training kernels at B=128 T=1000 H=384: timings"):
        dirs = (("fwd", False), ("bwd", True))
        layer1, layer2 = model.layer_params()
        with torch.no_grad():
            with parallel.deterministic_convolutions():
                feats, non_empty = model.read_features(
                    batch["features"], torch.bfloat16, True)
                pooled = model.pool(feats, non_empty, torch.bfloat16)
            del feats
            lens = batch["lengths"]
            x1 = pooled.transpose(0, 1)
            h1 = torch.cat([lstm_train.lstm_fwd(
                lstm_train.project(x1, layer1[d]["w_ih"], layer1[d]["b_ih"]),
                layer1[d]["w_hh"], layer1[d]["b_hh"], lens, rev)[0]
                for d, rev in dirs], dim=-1)
            p2 = layer2["fwd"]
            xp = lstm_train.project(h1, p2["w_ih"], p2["b_ih"])
            w_hh, b_hh = p2["w_hh"].detach(), p2["b_hh"].detach()
            out, c_out = lstm_train.lstm_fwd(xp, w_hh, b_hh, lens)
            dh_out = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
                "float32")).to(dev, torch.bfloat16).float()
            main_stats = compare_lstm_train(lstm_train, xp, w_hh, b_hh, lens,
                                            dh_out, False)
            one = (xp[:, :1].contiguous(), lens[:1])
            out1, c1 = lstm_train.lstm_fwd(one[0], w_hh, b_hh, one[1])
            bargs = (xp, out, c_out, dh_out, w_hh, b_hh, lens)
            calls = {
                "lstm_fwd": (
                    lambda: lstm_train.lstm_fwd(xp, w_hh, b_hh, lens),
                    lambda: lstm_train.lstm_fwd_plain(xp, w_hh, b_hh, lens),
                    lambda: lstm_train.lstm_fwd(one[0], w_hh, b_hh, one[1])),
                "lstm_bwd": (
                    lambda: lstm_train.lstm_bwd(*bargs),
                    lambda: lstm_train.lstm_bwd_plain(*bargs),
                    lambda: lstm_train.lstm_bwd(
                        one[0], out1, c1, dh_out[:, :1].contiguous(), w_hh,
                        b_hh, one[1])),
            }
            timed = {name: (cuda_ms(k), cuda_ms(pl, reps=1, warmup=0),
                            cuda_ms(o)) for name, (k, pl, o) in calls.items()}
        # yardstick (the port never calls it): cuDNN's bf16 LSTM, one
        # direction over layer 2's inputs, its input projection included
        lstm = torch.nn.LSTM(2 * H, H, 1).to(dev, torch.bfloat16)
        lstm.flatten_parameters()
        x2 = h1.detach().clone().requires_grad_(True)
        with torch.no_grad():
            lib_fwd = cuda_ms(lambda: lstm(x2))
        g_out = torch.ones((T, B, H), dtype=torch.bfloat16, device=dev)
        lib_params = [x2] + list(lstm.parameters())
        lib_fwd_bwd = cuda_ms(lambda: torch.autograd.grad(
            lstm(x2)[0], lib_params, g_out))
        del lstm, x2
        log("   torch.nn.LSTM({}, {}, 1) bf16 (cuDNN) over the same {} rows, "
            "its input projection included: forward {:.2f} ms, forward + "
            "backward {:.2f} ms".format(2 * H, H, B, lib_fwd, lib_fwd_bwd))

    rows = []
    for name in ("lstm_fwd", "lstm_bwd"):
        ms, plain_ms, floor_ms = timed[name]
        bound_ms, bound_by, nbytes = train_bound(name, B, H, lengths_sum)
        if name == "lstm_fwd":
            err = max([agreement[k]["fwd_max"] for k in agreement]
                      + [main_stats["fwd_max"]])
            c_err = max([agreement[k]["c"] for k in agreement]
                        + [main_stats["c"]])
        else:
            err = max(agreement[k][t] for k in agreement
                      for t in ("dxp", "dW_hh", "db_hh"))
            err = max(err, main_stats["dxp"], main_stats["dW_hh"],
                      main_stats["db_hh"])
        rows.append({
            "name": name, "route": "cuda", "source": LSTM_TRAIN_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_per_step": launches[name] // steps,
            "max_abs_err": err,
            "err_measure": ("max abs difference of bf16 outputs (h)"
                            if name == "lstm_fwd" else
                            "max abs difference over the tensor's max "
                            "magnitude, worst of dxp, dW_hh, db_hh"),
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": nbytes,
            "library_ms": lib_fwd if name == "lstm_fwd" else None,
            "library": (
                "torch.nn.LSTM({0}, {1}, 1) bf16 (cuDNN) forward over the "
                "same {2} rows, its input projection included: {3:.2f} ms"
                .format(2 * H, H, B, lib_fwd) if name == "lstm_fwd" else
                "no PyTorch call computes an LSTM's backward alone; "
                "torch.nn.LSTM({0}, {1}, 1) bf16 (cuDNN) forward + backward "
                "(autograd.grad for input and weights) over the same {2} "
                "rows: {3:.2f} ms".format(2 * H, H, B, lib_fwd_bwd)),
            "library_fwd_bwd_ms": lib_fwd_bwd,
            "serial_floor_ms": floor_ms,
            "shape": {"B": B, "T": T, "H": H, "reads": R,
                      "valid_columns": lengths_sum, "layer": 2,
                      "direction": "forward"},
            "agreement": {"random_weights": agreement,
                          "main_shape": main_stats},
        })
        if name == "lstm_fwd":
            rows[-1]["c_rel_err"] = c_err
        log("   {}: {:.3f} ms (plain {:.1f} ms, bound {:.4f} ms by {}, one "
            "column {:.3f} ms; {})".format(name, ms, plain_ms, bound_ms,
                                           bound_by, floor_ms,
                                           rows[-1]["library"]))
    rows[0]["train_step"] = {
        "vs_plain": step_stats, "stages_ms": stages, "profile": profile,
        "wall_ms": step_s * 1e3, "peak_memory_bytes": peak_bytes,
        "trained_columns_per_s": lengths_sum / step_s,
        "steps_in_run": steps, "run_s": t_train,
        "batchnorm_running": running}
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random inputs and weights")
    args = parser.parse_args(argv)
    seed = args.seed

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 1
    import numpy as np

    sys.path.insert(0, HERE)
    from medaka_tpu_torch import cli, datastore, features, models, \
        native, parallel, prediction, testing, training
    from medaka_tpu_torch.ops import bilstm, cuda_build, gru_split, \
        gru_train, lstm_train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    card = card_line()
    log("card:", card)

    with phase("build"):
        # one nvcc for each kernel source and the g++ build of the
        # host-side pileup and read-matrix library, all at once, so that
        # no one-time build lands in a main path's timing
        def timed(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0

        def native_build():
            if not native.available():
                raise AssertionError("the native library did not build")

        builds = {"nvcc gru_split.cu": gru_split.build,
                  "nvcc bilstm.cu": bilstm.build,
                  "nvcc gru_train.cu": gru_train.build,
                  "nvcc lstm_train.cu": lstm_train.build,
                  "g++ native": native_build}
        with ThreadPoolExecutor(len(builds)) as pool:
            futures = {name: pool.submit(timed, fn)
                       for name, fn in builds.items()}
            for name, future in futures.items():
                log("   {} build {:.1f} s".format(name, future.result()))
        for source, text in cuda_build.BUILD_LOGS.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log("  ", source, line.strip())

    with phase("kernels vs plain versions, T=2000, four combinations"):
        layers, head = random_net(rng)
        T = 2000
        for mode, B in (("t", 256), ("rows", 64)):
            for quant in (True, False):
                x = torch.from_numpy(rng.random((B, T, 10)).astype("float32"))
                lengths = torch.from_numpy(
                    rng.integers(T // 2, T + 1, B).astype("int32"))
                lengths[0] = T
                w = gru_split.prepare_split_weights(layers, head, mode,
                                                    quant, dev)
                xt = x.transpose(0, 1).to(torch.bfloat16).contiguous().to(dev)
                l1_err, l2_err, stats, _ = compare_kernels(
                    gru_split, w, xt, lengths.to(dev), mode, quant)
                log("   mode={} B={} quant={}: l1 max {:.3g}, l2 logit max "
                    "{:.3g}; probs max {:.3g} mean {:.3g}, argmax "
                    "agreement {:.6f}".format(
                        mode, B, quant, l1_err, l2_err, stats["max"],
                        stats["mean"], stats["argmax_agreement"]))

    with phase("bi-LSTM kernel vs plain version, H=128 and H=384"):
        for H, B, T in ((128, 128, 1000), (384, 32, 500)):
            err, mean = compare_bilstm(
                bilstm, random_lstm_inputs(rng, H, B, T, dev))
            log("   H={} B={} T={}: max {:.3g}, mean {:.3g}".format(
                H, B, T, err, mean))

    train_agreement = {}
    with phase("training kernels vs plain versions, H=256 B=128 T=1000"):
        for reverse in (False, True):
            stats = compare_gru_train(
                gru_train, *random_direction(rng, 256, 128, 1000, dev),
                reverse)
            log("   reverse={}: gru_fwd max {:.3g} mean {:.3g}; gru_bwd "
                "relative max dxp {:.3g}, dW_hh {:.3g}, db_hh {:.3g}; "
                "repeat bit-identical".format(
                    reverse, stats["fwd_max"], stats["fwd_mean"],
                    stats["dxp"], stats["dW_hh"], stats["db_hh"]))
            train_agreement["reverse" if reverse else "forward"] = stats

    lstm_agreement = {}
    with phase("LSTM training kernels vs plain versions, H=384 and H=128, "
               "B=128 T=1000"):
        for H in (384, 128):
            for reverse in (False, True):
                stats = compare_lstm_train(
                    lstm_train, *random_direction(rng, H, 128, 1000, dev,
                                                  gates=4), reverse)
                log("   H={} reverse={}: lstm_fwd h max {:.3g} mean {:.3g}, "
                    "c relative {:.3g}; lstm_bwd relative max dxp {:.3g}, "
                    "dW_hh {:.3g}, db_hh {:.3g}; repeat bit-identical".format(
                        H, reverse, stats["fwd_max"], stats["fwd_mean"],
                        stats["c"], stats["dxp"], stats["dW_hh"],
                        stats["db_hh"]))
                lstm_agreement["H{}_{}".format(
                    H, "reverse" if reverse else "forward")] = stats
        torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with phase("synthetic BAM, 0.5 Mb at depth 20"):
            bam, draft = testing.create_synth_bam(
                os.path.join(work, "reads.bam"), ref_mb=0.5, depth=20,
                seed=seed)
        bundle = models.load_model(MODEL)
        batch = prediction.auto_batch_size(bundle.model, dev)
        log("   automatic batch {} (mode {})".format(
            batch, gru_split.split_mode(batch)))
        if gru_split.split_mode(batch) != "t":
            raise AssertionError("the main path must run mode t")

        hdf = os.path.join(work, "probs.hdf")
        fasta = os.path.join(work, "consensus.fasta")
        with phase("main path: inference + sequence"):
            gru_split.reset_launches()
            t0 = time.perf_counter()
            if cli.main(["inference", bam, hdf, "--model", MODEL]) != 0:
                raise AssertionError("inference failed")
            torch.cuda.synchronize()
            t_inference = time.perf_counter() - t0
            launches = dict(gru_split.LAUNCHES)
            mode_launches = dict(gru_split.MODE_LAUNCHES)
            if cli.main(["sequence", hdf, draft, fasta]) != 0:
                raise AssertionError("sequence failed")
        log("   launches on the main path:", launches, mode_launches)
        if min(launches.values()) < 1 or min(
                mode_launches[name + "/t"] for name in launches) < 1:
            raise AssertionError("a kernel of the main path never launched")

        with phase("check the output"):
            n_samples, n_columns = check_probabilities(datastore, hdf)
            # the int8 kernels ("t") against the float32 scan, 8 chunks
            region = prediction.plan_work(None, bam)[0]
            samples = features.SampleGenerator(
                bam, region, bundle.feature_encoder, chunk_len=10000,
                chunk_overlap=1000).samples[:8]
            small = prediction.Batch.collate(samples, len(samples), 10000)
            x8 = torch.from_numpy(small.features).to(dev)
            len8 = torch.from_numpy(small.lengths).to(dev)
            model = bundle.model.to(dev)
            with torch.inference_mode():
                ref = model(x8, lengths=len8, compute_dtype=None)
                got = torch.softmax(gru_split.bigru_head_fullfused(
                    model.layer_params(), model.head_params(), x8, len8,
                    layout="t", device=dev), -1)
            valid = (torch.arange(10000, device=dev)[None, :]
                     < len8[:, None].long())
            diff = (got - ref).abs()[valid]
            agree = (got.argmax(-1) == ref.argmax(-1))[valid].float().mean()
            log("   int8 kernels vs float32 scan on 8 chunks: probs max "
                "{:.3g} mean {:.3g}, argmax agreement {:.6f}".format(
                    diff.max().item(), diff.mean().item(), agree.item()))
            if diff.max().item() > TOL_SCAN_PROB_MAX or \
                    diff.mean().item() > TOL_SCAN_PROB_MEAN or \
                    agree.item() < MIN_SCAN_ARGMAX_AGREEMENT:
                raise AssertionError("kernels vs scan exceed the int8 bars")

            identity, edits, cons_len = consensus_identity(testing, fasta,
                                                           draft)
            log("   {} samples, {} columns in {:.2f} s of inference: {:.0f} "
                "columns/s; consensus {} bp, identity to the draft {:.6f} "
                "({} edits by greedy walk)".format(
                    n_samples, n_columns, t_inference,
                    n_columns / t_inference, cons_len, identity, edits))
            if identity < 0.99:
                raise AssertionError("consensus identity {} < 0.99".format(
                    identity))

        with phase("main-path shapes: kernels vs plain, timings"):
            samples = []
            for region in prediction.plan_work(None, bam):
                samples.extend(features.SampleGenerator(
                    bam, region, bundle.feature_encoder, chunk_len=10000,
                    chunk_overlap=1000).samples)
            main_batch = prediction.Batch.collate(
                samples[:batch], batch, 10000)
            T, B, H, IN, C = 10000, batch, 256, 10, 5
            # yardsticks first, while the card's memory is free: cuDNN
            # bi-GRU layers in bf16 (the port never calls them), each over
            # the main batch or, where cuDNN runs out of the card's memory
            # there, over the largest half, quarter, ... of it that fits
            library = {
                "gru_l1_split": (IN, 1), "gru_l2head_split": (2 * H, 1),
                "network": (IN, 2)}
            library_ms, library_rows = {}, {}
            with torch.inference_mode():
                for name, (width, depth) in library.items():
                    rows_ = B
                    while True:
                        try:
                            library_ms[name] = yardstick_ms(
                                main_batch.features[:rows_], width, depth,
                                H, dev)
                            break
                        except torch.cuda.OutOfMemoryError as e:
                            torch.cuda.empty_cache()
                            log("   torch.nn.GRU({}, {}, {}, bidirectional="
                                "True) over {} rows: out of memory: {}"
                                .format(width, H, depth, rows_,
                                        str(e).splitlines()[0]))
                            if rows_ == 1:
                                raise
                            rows_ //= 2
                    library_rows[name] = rows_
                    log("   torch.nn.GRU({}, {}, {}, bidirectional=True) "
                        "bf16 (cuDNN) over {} rows: {:.2f} ms".format(
                            width, H, depth, rows_, library_ms[name]))
            xt = torch.from_numpy(main_batch.features).to(torch.bfloat16) \
                .transpose(0, 1).contiguous().to(dev)
            lens = torch.from_numpy(main_batch.lengths).to(dev)
            w = gru_split.prepare_split_weights(
                model.layer_params(), model.head_params(), "t", True, dev)
            l1_err, l2_err, stats, (kf, kb) = compare_kernels(
                gru_split, w, xt, lens, "t", True)
            log("   B={} T={}: l1 max {:.3g}, l2 logit max {:.3g}; probs "
                "max {:.3g} mean {:.3g}, argmax agreement {:.6f}".format(
                    B, T, l1_err, l2_err, stats["max"], stats["mean"],
                    stats["argmax_agreement"]))
            l1_args = (xt, lens, w["w_ih1"], w["b_ih1"], w["w_hh1"],
                       w["sc1"], w["b_hh1"])
            l2_args = (kf, kb, lens, w["w_in2"], w["in_scale2"], w["b_ih2"],
                       w["w_hh2"], w["sc2"], w["b_hh2"], w["w_head"])
            # the serial floor: the same kernels over one batch column
            one_x, one_len = xt[:, :1].contiguous(), lens[:1]
            f1, b1 = gru_split.gru_l1_split(one_x, one_len, *l1_args[2:],
                                            mode="t")
            calls = {
                "gru_l1_split": (
                    lambda: gru_split.gru_l1_split(*l1_args, mode="t"),
                    lambda: gru_split.gru_l1_split_plain(
                        *l1_args, mode="t", quant=True),
                    lambda: gru_split.gru_l1_split(
                        one_x, one_len, *l1_args[2:], mode="t"), l1_err),
                "gru_l2head_split": (
                    lambda: gru_split.gru_l2head_split(*l2_args, mode="t"),
                    lambda: gru_split.gru_l2head_split_plain(
                        *l2_args, mode="t", quant=True),
                    lambda: gru_split.gru_l2head_split(
                        f1, b1, one_len, *l2_args[3:], mode="t"), l2_err),
            }
            lengths_sum = int(main_batch.lengths.sum())
            rows = []
            with torch.inference_mode():
                for name, (kernel, plain, one, err) in calls.items():
                    ms = cuda_ms(kernel)
                    plain_ms = cuda_ms(plain, reps=1, warmup=0)
                    bound_ms, bound_by = bound(name, B, H, IN, C,
                                               lengths_sum)
                    lib_desc = "torch.nn.GRU({}, {}, 1, bidirectional=True) " \
                        "bf16 (cuDNN) over {} rows".format(
                            library[name][0], H, library_rows[name])
                    rows.append({
                        "name": name, "route": "cuda",
                        "source": KERNEL_SOURCE,
                        "replaces": REPLACES[name],
                        "launches": launches[name],
                        "launches_by_mode": {
                            m: mode_launches[name + "/" + m]
                            for m in gru_split.MODES},
                        "max_abs_err": err, "ms": ms, "kernel_ms": ms,
                        "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        # one call computing the same function on the same
                        # inputs: cuDNN's layer 1 over the whole batch; no
                        # single PyTorch call computes layer 2 + the head
                        "library_ms": library_ms[name]
                        if name == "gru_l1_split" and
                        library_rows[name] == B else None,
                        "library": "{}: {:.2f} ms".format(
                            lib_desc, library_ms[name]),
                        "network_library_ms": library_ms["network"],
                        "network_library": "torch.nn.GRU({}, {}, 2, "
                                           "bidirectional=True) bf16 (cuDNN) "
                                           "over {} rows".format(
                                               IN, H,
                                               library_rows["network"]),
                        "serial_floor_ms": cuda_ms(one),
                        "shape": {"B": B, "T": T, "H": H,
                                  "valid_columns": lengths_sum},
                    })
                    log("   {}: {:.2f} ms (plain {:.1f} ms, bound {:.3f} ms "
                        "by {}, one column {:.2f} ms; {})".format(
                            name, ms, plain_ms, bound_ms, bound_by,
                            rows[-1]["serial_floor_ms"],
                            rows[-1]["library"]))
            log("   whole network yardstick: {} {:.2f} ms; kernels over {} "
                "rows {:.2f} ms".format(
                    rows[0]["network_library"], library_ms["network"], B,
                    rows[0]["ms"] + rows[1]["ms"]))

            # mode "rows" (TPU kernels #3 and #4) is what batches below 192
            # run; the main path does not reach it, so it is held against
            # its plain version and timed on the batch's first 64 rows
            RB = 64
            xr, lr = xt[:, :RB].contiguous(), lens[:RB].contiguous()
            wr = gru_split.prepare_split_weights(
                model.layer_params(), model.head_params(), "rows", True, dev)
            r1_err, r2_err, rstats, (rf, rb) = compare_kernels(
                gru_split, wr, xr, lr, "rows", True)
            log("   mode rows, B={} T={}: l1 max {:.3g}, l2 logit max "
                "{:.3g}; probs max {:.3g}, argmax agreement {:.6f}".format(
                    RB, T, r1_err, r2_err, rstats["max"],
                    rstats["argmax_agreement"]))
            r_sum = int(main_batch.lengths[:RB].sum())
            r_args = (
                (xr, lr, wr["w_ih1"], wr["b_ih1"], wr["w_hh1"], wr["sc1"],
                 wr["b_hh1"]),
                (rf, rb, lr, wr["w_in2"], wr["in_scale2"], wr["b_ih2"],
                 wr["w_hh2"], wr["sc2"], wr["b_hh2"], wr["w_head"]))
            kernels = ((gru_split.gru_l1_split, gru_split.gru_l1_split_plain,
                        r1_err, IN),
                       (gru_split.gru_l2head_split,
                        gru_split.gru_l2head_split_plain, r2_err, 2 * H))
            with torch.inference_mode():
                for row, call_args, (fn, plain_fn, err, width) in zip(
                        rows, r_args, kernels):
                    lib_ms = yardstick_ms(main_batch.features[:RB], width,
                                          1, H, dev)
                    bound_ms, bound_by = bound(row["name"], RB, H, IN, C,
                                               r_sum)
                    row["rows_mode"] = {
                        "B": RB, "valid_columns": r_sum,
                        "launches": mode_launches[row["name"] + "/rows"],
                        "max_abs_err": err,
                        "ms": cuda_ms(lambda: fn(*call_args, mode="rows")),
                        "plain_ms": cuda_ms(lambda: plain_fn(
                            *call_args, mode="rows", quant=True),
                            reps=1, warmup=0),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library": "torch.nn.GRU({}, {}, 1, bidirectional="
                                   "True) bf16 (cuDNN) over {} rows: {:.2f} "
                                   "ms".format(width, H, RB, lib_ms)}
                    log("   {} mode rows: {}".format(
                        row["name"], json.dumps(row["rows_mode"])))

        torch.cuda.empty_cache()
        rl_bundle = models.load_model(RL_MODEL)
        max_reads = rl_bundle.feature_encoder.max_reads
        rl_batch = prediction.auto_batch_size(
            rl_bundle.model, dev, chunk_len=1000, max_reads=max_reads)
        log("   read-level automatic batch {}".format(rl_batch))
        rl_hdf = os.path.join(work, "rl_probs.hdf")
        rl_fasta = os.path.join(work, "rl_consensus.fasta")
        with phase("read-level main path: inference + sequence"):
            bilstm.reset_launches()
            t0 = time.perf_counter()
            if cli.main(["inference", bam, rl_hdf, "--model", RL_MODEL,
                         "--chunk_len", "1000", "--chunk_ovlp", "100"]) != 0:
                raise AssertionError("read-level inference failed")
            torch.cuda.synchronize()
            t_rl = time.perf_counter() - t0
            rl_launches = bilstm.LAUNCHES["bilstm_fused"]
            if cli.main(["sequence", rl_hdf, draft, rl_fasta]) != 0:
                raise AssertionError("read-level sequence failed")
        log("   launches on the read-level path:", dict(bilstm.LAUNCHES))

        with phase("check the read-level output"):
            rl_samples, rl_columns = check_probabilities(datastore, rl_hdf)
            n_batches = math.ceil(rl_samples / rl_batch)
            if rl_launches != 2 * n_batches:
                raise AssertionError(
                    "bilstm_fused launched {} times for {} batches (2 "
                    "layers each)".format(rl_launches, n_batches))
            rl_identity, rl_edits, rl_len = consensus_identity(
                testing, rl_fasta, draft)
            log("   {} samples, {} columns in {:.2f} s of inference: {:.0f} "
                "columns/s; consensus {} bp, identity to the draft {:.6f} "
                "({} edits by greedy walk)".format(
                    rl_samples, rl_columns, t_rl, rl_columns / t_rl, rl_len,
                    rl_identity, rl_edits))
            if rl_identity < 0.99:
                raise AssertionError("read-level consensus identity {} < "
                                     "0.99".format(rl_identity))

        with phase("read-level batch: kernel vs plain, stages, timings"):
            region = prediction.plan_work(None, bam)[0]
            samples = features.SampleGenerator(
                bam, region, rl_bundle.feature_encoder, chunk_len=1000,
                chunk_overlap=100).samples[:rl_batch]
            rl_main = prediction.Batch.collate(samples, rl_batch, 1000,
                                               max_reads)
            x = torch.from_numpy(rl_main.features).to(dev)
            lens = torch.from_numpy(rl_main.lengths).to(dev)
            B, T, R = x.shape[0], x.shape[1], x.shape[2]
            H = rl_bundle.model.lstm_size
            model = rl_bundle.model.to(dev).eval()
            valid = (torch.arange(T, device=dev)[None, :]
                     < lens[:, None].long())
            with torch.inference_mode():
                direct = model(x, lengths=lens, normalise=False,
                               compute_dtype=torch.bfloat16)
                staged = read_level_stages(model, bilstm, x, lens)
                plain = read_level_stages(model, bilstm, x, lens, plain=True)
            if not torch.equal(direct, staged):
                raise AssertionError("the staged forward differs from the "
                                     "model's")
            pk, pp = torch.softmax(staged, -1)[valid], \
                torch.softmax(plain, -1)[valid]
            diff = (pk - pp).abs()
            rl_stats = {"max": diff.max().item(), "mean": diff.mean().item(),
                        "argmax_agreement": (pk.argmax(-1) == pp.argmax(-1))
                        .float().mean().item()}
            log("   B={} T={} R={}: model through the kernel vs through its "
                "plain version: probs max {:.3g} mean {:.3g}, argmax "
                "agreement {:.6f}".format(B, T, R, rl_stats["max"],
                                          rl_stats["mean"],
                                          rl_stats["argmax_agreement"]))
            if rl_stats["max"] > TOL_PROB or \
                    rl_stats["argmax_agreement"] < MIN_ARGMAX_AGREEMENT:
                raise AssertionError("read-level kernel path disagrees with "
                                     "the plain path: {}".format(rl_stats))

            # stage breakdown of one batch (after the warm-up above)
            events = []
            with torch.inference_mode():
                read_level_stages(model, bilstm, x, lens, events=events)
            torch.cuda.synchronize()
            stages = {}
            for name, start, stop in events:
                stages[name] = stages.get(name, 0.0) + start.elapsed_time(stop)
            log("   stage breakdown (ms): " + json.dumps(stages))

            # the kernel at the main path's shape: layer 1's inputs
            with torch.inference_mode():
                feats, non_empty = model.read_features(x, torch.bfloat16)
                pooled = model.pool(feats, non_empty, torch.bfloat16)
                del feats
                layer = model.layer_params()[0]
                fwd, bwd = layer["fwd"], layer["bwd"]
                pooled_t = pooled.transpose(0, 1)
                xp_f = bilstm.project(pooled_t, fwd["w_ih"], fwd["b_ih"])
                xp_b = bilstm.project(pooled_t, bwd["w_ih"], bwd["b_ih"])
                largs = (xp_f, xp_b, torch.stack([fwd["w_hh"], bwd["w_hh"]]),
                         torch.stack([fwd["b_hh"], bwd["b_hh"]]), lens)
                err, mean = compare_bilstm(bilstm, largs)
                one = (xp_f[:, :1].contiguous(), xp_b[:, :1].contiguous(),
                       largs[2], largs[3], lens[:1])
                lstm_ms = cuda_ms(lambda: bilstm.bilstm_fused(*largs))
                lstm_plain_ms = cuda_ms(
                    lambda: bilstm.bilstm_fused_plain(*largs), reps=1,
                    warmup=0)
                floor_ms = cuda_ms(lambda: bilstm.bilstm_fused(*one))
                # yardstick (the port never calls it): cuDNN's bi-LSTM
                # over the same rows, its input projection included
                lstm = torch.nn.LSTM(H, H, 1, batch_first=True,
                                     bidirectional=True).to(dev,
                                                            torch.bfloat16)
                lstm.flatten_parameters()
                lib_ms = cuda_ms(lambda: lstm(pooled))
                del lstm
            lstm_sum = int(rl_main.lengths.sum())
            bound_ms, bound_by = bilstm_bound(B, H, lstm_sum)
            rows.append({
                "name": "bilstm_fused", "route": "cuda",
                "source": BILSTM_SOURCE, "replaces": REPLACES["bilstm_fused"],
                "launches": rl_launches, "max_abs_err": err,
                "mean_abs_err": mean, "ms": lstm_ms, "kernel_ms": lstm_ms,
                "plain_ms": lstm_plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms,
                "library": "torch.nn.LSTM({0}, {0}, 1, bidirectional=True) "
                           "bf16 (cuDNN) over the same {1} rows, its input "
                           "projection included: {2:.2f} ms".format(
                               H, B, lib_ms),
                "serial_floor_ms": floor_ms,
                "shape": {"B": B, "T": T, "H": H, "reads": R,
                          "valid_columns": lstm_sum},
                "model_vs_plain": rl_stats, "stages_ms": stages,
                "read_level_columns_per_s": rl_columns / t_rl,
            })
            log("   bilstm_fused: {:.3f} ms per layer (plain {:.1f} ms, "
                "bound {:.4f} ms by {}, one column {:.3f} ms; {})".format(
                    lstm_ms, lstm_plain_ms, bound_ms, bound_by, floor_ms,
                    rows[-1]["library"]))

        del model, x, pooled, pooled_t, xp_f, xp_b, largs, one
        torch.cuda.empty_cache()
        rows.extend(training_phases(
            seed, work, bam, draft, dev, rng, train_agreement, modules={
                "cli": cli, "datastore": datastore, "gru_train": gru_train,
                "parallel": parallel, "training": training}))
        torch.cuda.empty_cache()
        rows.extend(read_level_training_phases(
            seed, work, dev, rng, lstm_agreement, modules={
                "cli": cli, "datastore": datastore, "lstm_train": lstm_train,
                "models": models, "parallel": parallel,
                "training": training}))
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)

    log("card:", card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
