#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the root of a checkout, on a machine with an NVIDIA GPU, the
CUDA toolkit (``nvcc``) and PyTorch for CUDA:

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the script when it fails:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``medaka_tpu_torch/csrc`` with ``nvcc``,
   and the host-side pileup library with ``g++``;
3. hold both kernels against their plain PyTorch versions at full width
   (H=256, 10 features, 5 classes, T=2000, ragged lengths) in all four
   numerics combinations: mode "t" at B=256 and mode "rows" at B=64,
   each with int8 quantisation on and off;
4. write a synthetic 0.5 Mb BAM at depth 20 and its draft;
5. the main path: ``medaka_tpu_torch inference`` with the bundled
   ``gru256_lambda_demo_model_pt`` at chunk_len 10000 and the automatic
   batch, then ``sequence``, through the CLI entry point in this process
   with every kernel launch count set to 0 just before;
6. check the output: finite probabilities that sum to 1, the consensus
   identity to the draft, and the int8 kernels against the float32 scan
   on eight real chunks;
7. at the main path's shape, hold each kernel against its plain version
   and time it beside its plain version, the cuDNN ``nn.GRU`` yardstick
   and its bound; the same for mode "rows" on 64 rows; print one
   ``kernels`` JSON line.

The last line of standard output is the device JSON object. The script
imports nothing of JAX and nothing of the ``medaka_tpu`` package.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(HERE, "medaka_tpu", "data",
                     "gru256_lambda_demo_model_pt.tar.gz")
KERNEL_SOURCE = "medaka_tpu_torch/csrc/gru_split.cu"
REPLACES = {
    "gru_l1_split": "medaka_tpu/ops/pallas_gru.py:1371 "
                    "(_bigru_l1_split_t_kernel, mode t); :982 "
                    "(_bigru_l1_split_kernel, mode rows)",
    "gru_l2head_split": "medaka_tpu/ops/pallas_gru.py:1452 "
                        "(_bigru_l2head_t_kernel, mode t); :1055 "
                        "(_bigru_l2head_kernel, mode rows)",
}
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 op/s,
# bf16 flop/s
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random inputs and weights")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 1
    import numpy as np

    sys.path.insert(0, HERE)
    from medaka_tpu_torch import cli, datastore, features, models, \
        native, prediction, testing
    from medaka_tpu_torch.io.fastx import FastaReader
    from medaka_tpu_torch.ops import cuda_build, gru_split

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    card = card_line()
    log("card:", card)

    with phase("build"):
        t0 = time.perf_counter()
        gru_split.build()
        log("   nvcc build {:.1f} s".format(time.perf_counter() - t0))
        # the host-side pileup library too, so that its one-time g++
        # build does not land in the main path's timing
        t0 = time.perf_counter()
        if not native.available():
            raise AssertionError("the native pileup library did not build")
        log("   g++ build {:.1f} s".format(time.perf_counter() - t0))
        for text in cuda_build.BUILD_LOGS.values():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log("  ", line.strip())

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

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with phase("synthetic BAM, 0.5 Mb at depth 20"):
            bam, draft = testing.create_synth_bam(
                os.path.join(work, "reads.bam"), ref_mb=0.5, depth=20,
                seed=args.seed)
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

            with FastaReader(draft) as fr:
                draft_seq = fr.fetch("synth")
            with FastaReader(fasta) as fr:
                consensus = fr.fetch("synth")
            edits = testing.greedy_edit_count(consensus.encode(),
                                              draft_seq.encode())
            identity = 1.0 - edits / len(draft_seq)
            log("   {} samples, {} columns in {:.2f} s of inference: {:.0f} "
                "columns/s; consensus {} bp, identity to the draft {:.6f} "
                "({} edits by greedy walk)".format(
                    len(index.samples), n_columns, t_inference,
                    n_columns / t_inference, len(consensus), identity,
                    edits))
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
                for row, args, (fn, plain_fn, err, width) in zip(
                        rows, r_args, kernels):
                    lib_ms = yardstick_ms(main_batch.features[:RB], width,
                                          1, H, dev)
                    bound_ms, bound_by = bound(row["name"], RB, H, IN, C,
                                               r_sum)
                    row["rows_mode"] = {
                        "B": RB, "valid_columns": r_sum,
                        "launches": mode_launches[row["name"] + "/rows"],
                        "max_abs_err": err,
                        "ms": cuda_ms(lambda: fn(*args, mode="rows")),
                        "plain_ms": cuda_ms(lambda: plain_fn(
                            *args, mode="rows", quant=True),
                            reps=1, warmup=0),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library": "torch.nn.GRU({}, {}, 1, bidirectional="
                                   "True) bf16 (cuDNN) over {} rows: {:.2f} "
                                   "ms".format(width, H, RB, lib_ms)}
                    log("   {} mode rows: {}".format(
                        row["name"], json.dumps(row["rows_mode"])))
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
