#!/usr/bin/env python3
"""Hold the port's CUDA kernels of two source trees against each other on
one GPU: their outputs on the same inputs, and the times of the GRU
forward recurrences.

    python3 chip_ab.py run --tree DIR --out FILE.pt [--seed N]
    python3 chip_ab.py compare A.pt B.pt [C.pt ...]

``run`` builds the kernels of the checkout at DIR (its
``medaka_tpu_torch/csrc``, one ``nvcc`` a source, all at once), runs
every kernel wrapper once on inputs made from the seed and saves the
outputs, one bf16 train step of the counts ``GRUModel`` (H=256, B=128,
T=1000, random features and labels) through the kernels against the same
step through their plain versions (the loss's relative difference and
the largest gradient difference over the gradient's largest magnitude),
and the times (CUDA events, 5 launches after one warm-up) of
``gru_fwd`` at B=128, T=1000, H=256 (the counts training step's shape),
over one column and at H=96, B=31, T=500, and of ``bigru_fused`` at B=16,
T=10000, H=256 (the batch-16 path's layer 2), over one column and at
H=96, B=31, T=500, and of the split kernels ``gru_l1_split`` and
``gru_l2head_split`` (int8, H=256, T=10000): mode "t" at B=512 and at
B=480 (the automatic batch where both run in one wave), mode "rows" at
B=64 and 32, and over one column in both modes, and bf16
(``quant=False``) in mode "t" at B=480 and over one column and in mode
"rows" at B=64 and 32 (where the tree runs bf16 on clusters, also on the
cluster geometries of ``BF16_SWEEPS`` beside the chooser's, each held to
the chooser's outputs); where the tree has the cluster
geometry of the int8 split kernels, also layer 1 on clusters of 4 blocks
(64 units a block) at the same shapes, and each launch's geometry; the
int8, f32-gates and bf16-gates fullfused launches at B=16, T=10000,
H=256, IN=512 and over one column, with the profiler's split into
projection stage and recurrence, and where the tree has the int8 cluster recurrence, that
recurrence alone on clusters of 2, 4, 8 and 16 blocks; ``bilstm_fused`` at
B=128, T=1000, H=128 and over one column (on clusters of 1, 2 and 4
blocks where the tree has the LSTM cluster forward). The fullfused
layers are also run over inputs whose projections are exact in f32, so
that the trees' recurrences see the same projections.
bf16 ``gru_l2head_split`` at H=384 and 512 (the per-block kernel) is
timed in mode "t" at B=192 and 480, T=1000.
``compare`` prints, for each output, whether every file holds the same
bits as the first that has it (a split-only run beside whole ones lacks
the other kernels' outputs: null there), the largest difference where
not, and the train
steps' agreement and the times side by side; the bf16 split kernels'
outputs (layer 1, and layer 2 on the plain layer 1's outputs, which are
the same in every tree) must stay within the card's bars of the first
file's, or it exits 1. Give the trees their turns
in one call, on one card (A, B, B, A), since cards and calls differ.
``run --split-only`` runs and times the split kernels alone.

Needs a CUDA GPU and ``nvcc``; imports nothing of JAX or ``medaka_tpu``.
"""
import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
#: the shapes (B, mode) at which the bf16 split kernels are timed, and the
#: cluster geometries (C, BT) of layer 1 and of layer 2 timed there beside
#: the chooser's (H=256, T=10000)
_SMALL = (((2, 8), (4, 8), (8, 8), (16, 8)), ((8, 8), (16, 8)))
BF16_SWEEPS = {(480, "t"): (((4, 32),), ((8, 16), (16, 64))),
               (64, "rows"): _SMALL, (32, "rows"): _SMALL, (1, "t"): _SMALL}


def run(tree, out_path, seed, split_only=False):
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA GPU is available", file=sys.stderr)
        return 1
    import chip_smoke as cs          # this checkout's inputs and timers
    sys.path.insert(0, os.path.abspath(tree))
    import medaka_tpu_torch
    from medaka_tpu_torch.ops import bilstm, gru_fullfused, gru_split, \
        gru_train, lstm_train
    print("chip_ab: the port from {}".format(
        os.path.dirname(medaka_tpu_torch.__file__)), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    mods = (gru_split, bilstm, gru_train, lstm_train, gru_fullfused)
    with ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda m: m.build(), mods))
    rng = np.random.default_rng(seed)
    outputs, times, step = {}, {}, {}

    def keep(key, value):
        if isinstance(value, (tuple, list)):
            for i, v in enumerate(value):
                keep("{}[{}]".format(key, i), v)
        else:
            outputs[key] = value.detach().cpu()

    # the split kernels, both modes, int8 on and off
    layers, head = cs.random_net(rng)
    T, B = 300, 48
    x = torch.from_numpy(rng.random((B, T, 10)).astype("float32"))
    xt = x.transpose(0, 1).to(torch.bfloat16).contiguous().to(dev)
    lens = torch.from_numpy(rng.integers(T // 2, T + 1, B).astype("int32"))
    lens[0] = T
    lens = lens.to(dev)
    for mode in ("t", "rows"):
        for quant in (True, False):
            w = gru_split.prepare_split_weights(layers, head, mode, quant, dev)
            (kf, kb), logits = cs.run_layers(gru_split, w, xt, lens, mode,
                                             quant)
            keep("gru_split/{}/{}/l1".format(mode, quant), (kf, kb))
            keep("gru_split/{}/{}/l2head".format(mode, quant), logits)
            if not quant:
                # bf16 layer 2 on the plain layer 1's outputs, the same
                # bits in every tree (the plain versions are the same)
                pf, pb = gru_split.gru_l1_split_plain(
                    xt, lens, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["sc1"],
                    w["b_hh1"], mode=mode, quant=False)
                keep("gru_split_bf16/{}/l2head_on_plain_l1".format(mode),
                     gru_split.gru_l2head_split(
                         pf, pb, lens, w["w_in2"], w["in_scale2"],
                         w["b_ih2"], w["w_hh2"], w["sc2"], w["b_hh2"],
                         w["w_head"], mode=mode, quant=False))
    def timed(name, fn):
        times[name] = cs.cuda_ms(fn, reps=5)
        print("   {}: {:.3f} ms".format(name, times[name]), flush=True)

    profiles = {}
    if not split_only:
        # the bi-LSTM inference kernel
        keep("bilstm_fused", bilstm.bilstm_fused(
            *cs.random_lstm_inputs(rng, 128, 64, 300, dev)))
        # the LSTM training pair, both directions
        for H in (384, 128):
            for reverse in (False, True):
                xp, w_hh, b_hh, ln, dh = cs.random_direction(
                    rng, H, 64, 200, dev, gates=4)
                h, c = lstm_train.lstm_fwd(xp, w_hh, b_hh, ln, reverse)
                keep("lstm_fwd/H{}/{}".format(H, reverse), (h, c))
                keep("lstm_bwd/H{}/{}".format(H, reverse), lstm_train.lstm_bwd(
                    xp, h, c, dh, w_hh, b_hh, ln, reverse))
        # the GRU training pair; gru_bwd on the plain forward's outputs, so
        # that it sees the same inputs whatever gru_fwd gives
        for H, B, T in ((256, 128, 200), (96, 31, 100)):
            for reverse in (False, True):
                xp, w_hh, b_hh, ln, dh = cs.random_direction(rng, H, B, T, dev)
                keep("gru_fwd/H{}/{}".format(H, reverse),
                     gru_train.gru_fwd(xp, w_hh, b_hh, ln, reverse))
                h = gru_train.gru_fwd_plain(xp, w_hh, b_hh, ln, reverse)
                keep("gru_bwd/H{}/{}".format(H, reverse), gru_train.gru_bwd(
                    xp, h, dh, w_hh, b_hh, ln, reverse))
        # the fullfused modes over inputs whose projections are exact in f32
        # (x in quarters, W_ih in 64ths, b_ih in 256ths: every partial sum is
        # a multiple of 1/256 below 2^14 in magnitude), so that every tree's
        # projection stage gives the same bf16 projections whatever the order
        # of its sums: the recurrences are compared over the same inputs
        for H, B, T in ((256, 16, 300), (96, 31, 200)):
            ln = torch.from_numpy(rng.integers(1, T + 1, B).astype("int32"))
            ln[0], ln[1] = T, 0
            ln = ln.to(dev)
            k = 1.0 / H ** 0.5
            for IN in (10, 2 * H):
                x = torch.from_numpy(rng.integers(-4, 5, (T, B, IN)).astype(
                    "float32") / 4).to(dev, torch.bfloat16)
                w = (torch.from_numpy(rng.integers(
                        -8, 9, (2, 3 * H, IN)).astype("float32") / 64).to(
                            dev),
                     torch.from_numpy(rng.integers(-16, 17, (2, 3 * H)).astype(
                         "float32") / 256).to(dev),
                     torch.from_numpy(rng.uniform(-k, k, (2, 3 * H, H)).astype(
                         "float32")).to(dev),
                     torch.from_numpy(rng.uniform(-k, k, (2, 3 * H)).astype(
                         "float32")).to(dev))
                for mode in ("f32_gates", "bf16_gates", "int8"):
                    kernel, _ = cs.fullfused_calls(gru_fullfused, mode, x,
                                                   w, ln)
                    keep("exact_projections/{}/H{}/IN{}".format(mode, H, IN),
                         kernel())
        # the fullfused modes and bigru_fused, layer 1 and layer 2 inputs
        for H, B, T in ((256, 16, 500), (96, 31, 200)):
            ln = torch.from_numpy(rng.integers(1, T + 1, B).astype("int32"))
            ln[0], ln[1] = T, 0
            ln = ln.to(dev)
            for IN in (10, 2 * H):
                x = torch.from_numpy(rng.uniform(-1, 1, (T, B, IN)).astype(
                    "float32")).to(dev, torch.bfloat16)
                w = cs.random_bigru_layer(rng, H, IN, dev)
                for mode in ("f32_gates", "bf16_gates", "int8", "fused"):
                    kernel, _ = cs.fullfused_calls(gru_fullfused, mode, x,
                                                   w, ln)
                    keep("{}/H{}/IN{}".format(
                        "bigru_fused" if mode == "fused"
                        else "bigru_fullfused/" + mode, H, IN), kernel())

        # one train step through the kernels vs through their plain versions
        from medaka_tpu_torch import parallel
        from medaka_tpu_torch.models.gru import GRUModel
        B, T = 128, 1000
        ln = rng.integers(T // 2, T + 1, B).astype("int32")
        ln[0] = T
        batch = {k: torch.from_numpy(v).to(dev) for k, v in (
            ("features", rng.random((B, T, 10)).astype("float32")),
            ("labels", rng.integers(0, 5, (B, T)).astype("int32")),
            ("mask", (np.arange(T)[None, :] < ln[:, None]).astype("float32")),
            ("lengths", ln))}
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = GRUModel(gru_size=256).to(dev)
        losses, grads = {}, {}
        for plain in (False, True):
            losses[plain] = cs.staged_train_step(
                model, None, batch, gru_train, parallel, plain=plain,
                update=False).item()
            grads[plain] = {n: p.grad.clone()
                            for n, p in model.named_parameters()}
        step["loss_rel"] = (abs(losses[False] - losses[True])
                            / abs(losses[True]))
        step["grad_rel_max"] = max(
            ((grads[False][n] - g).abs().max() / g.abs().max()).item()
            for n, g in grads[True].items())
        print("   train step, kernels vs plain: {}".format(json.dumps(step)),
              flush=True)
        del model, grads, batch

        for H, B, T in ((256, 128, 1000), (256, 1, 1000), (96, 31, 500)):
            xp, w_hh, b_hh, ln, _ = cs.random_direction(rng, H, B, T, dev)
            timed("gru_fwd/H{}_B{}_T{}".format(H, B, T),
                  lambda: gru_train.gru_fwd(xp, w_hh, b_hh, ln))
        for H, B, T in ((256, 16, 10000), (256, 1, 10000), (96, 31, 500)):
            xp, w_hh, b_hh, ln, _ = cs.random_direction(rng, H, B, T, dev)
            w2, b2 = torch.stack([w_hh, w_hh.flip(0)]), torch.stack([b_hh] * 2)
            xp_b = xp.flip(-1).contiguous()
            timed("bigru_fused/H{}_B{}_T{}".format(H, B, T),
                  lambda: gru_fullfused.fused_layer(xp, xp_b, w2, b2, ln))
            del xp, xp_b
        # the fullfused launches at the batch-16 path's layer 2 (B=16,
        # T=10000, H=256, IN=512) and over one column: the whole launch (CUDA
        # events) and the profiler's split into the projection stage and the
        # recurrence; on a tree with the int8 cluster recurrence, that
        # recurrence alone on clusters of 2-16 blocks; on a tree with the
        # bf16-gates cluster recurrence, the bf16-gates launch on clusters of 8
        # and 16 blocks and tiles of 8 and 16 columns
        T, H, IN = 10000, 256, 512
        k = 1.0 / H ** 0.5
        w = tuple(torch.from_numpy(rng.uniform(-k, k, shape).astype(
            "float32")).to(dev) for shape in ((2, 3 * H, IN), (2, 3 * H),
                                              (2, 3 * H, H), (2, 3 * H)))
        for B in (16, 1):
            x = torch.from_numpy(rng.uniform(-1, 1, (T, B, IN)).astype(
                "float32")).to(dev, torch.bfloat16)
            ln = torch.full((B,), T, dtype=torch.int32, device=dev)
            for mode in ("int8", "f32_gates", "bf16_gates"):
                key = "bigru_fullfused/{}/B{}_T{}".format(mode, B, T)
                kernel, _ = cs.fullfused_calls(gru_fullfused, mode, x, w, ln)
                timed(key, kernel)
                by_kernel = (cs.kernels_ms(kernel) or cs.kernels_ms(kernel)
                             or {})
                split = {"projection": sum(v for n, v in by_kernel.items()
                                           if "proj" in n),
                         "recurrence": sum(v for n, v in by_kernel.items()
                                           if "gru_rec_kernel" in n or
                                           "gru_cluster_fwd_kernel" in n),
                         "kernels": sorted(n for n in by_kernel
                                           if "proj" in n or "gru_" in n)}
                profiles[key] = split
                print("   {} profile: {}".format(key, json.dumps(split)),
                      flush=True)
            if hasattr(gru_fullfused, "_launch_int8_recurrence"):
                xp = gru_fullfused.project(x, w[0], w[1])
                for C in (2, 4, 8, 16):
                    timed("int8_recurrence_C{}/B{}_T{}".format(C, B, T),
                          lambda: gru_fullfused._launch_int8_recurrence(
                              xp[0], xp[1], w[2], w[3], ln, cluster=(C, 8)))
                del xp
            if "bf16_gates" in getattr(gru_fullfused, "CLUSTER_LAYOUTS", {}):
                for C, BT in ((16, 8), (8, 8), (16, 16), (8, 16)):
                    timed("bf16_gates_C{}_BT{}/B{}_T{}".format(C, BT, B, T),
                          lambda: gru_fullfused._launch_fullfused(
                              x, *w, ln, "bf16_gates", cluster=(C, BT)))
            del x
        # bilstm_fused at the read-level path's shape (B=128, T=1000, H=128)
        # and over one column; on a tree with the LSTM cluster forward, on
        # clusters of 1, 2 and 4 blocks too
        T = 1000
        for B in (128, 1):
            args = cs.random_lstm_inputs(rng, 128, B, T, dev)
            args = args[:4] + (torch.full((B,), T, dtype=torch.int32,
                                          device=dev),)
            timed("bilstm_fused/B{}_T{}".format(B, T),
                  lambda: bilstm.bilstm_fused(*args))
            if hasattr(bilstm, "geometry"):
                for C in (1, 2, 4):
                    timed("bilstm_fused_C{}/B{}_T{}".format(C, B, T),
                          lambda: bilstm._launch(*args, cluster=(C, 8)))
    # the split kernels at the inference path's shapes (random net, full
    # lengths); layer 2 on layer 1's outputs
    layers, head = cs.random_net(rng)
    geometries, sweeps = {}, {}
    T = 10000
    for B, mode in ((512, "t"), (480, "t"), (64, "rows"), (32, "rows"),
                    (1, "t"), (1, "rows")):
        xt = torch.from_numpy(rng.random((T, B, 10)).astype(
            "float32")).to(dev, torch.bfloat16)
        ln = torch.full((B,), T, dtype=torch.int32, device=dev)
        w = gru_split.prepare_split_weights(layers, head, mode, True, dev)
        a1 = (xt, ln, w["w_ih1"], w["b_ih1"], w["w_hh1"], w["sc1"],
              w["b_hh1"])
        f, b = gru_split.gru_l1_split(*a1, mode=mode)
        a2 = (f, b, ln, w["w_in2"], w["in_scale2"], w["b_ih2"], w["w_hh2"],
              w["sc2"], w["b_hh2"], w["w_head"])
        shape = "B{}_T{}_{}".format(B, T, mode)
        timed("gru_l1_split/" + shape,
              lambda: gru_split.gru_l1_split(*a1, mode=mode))
        timed("gru_l2head_split/" + shape,
              lambda: gru_split.gru_l2head_split(*a2, mode=mode))
        if hasattr(gru_split, "geometry"):
            for kind, name in (("l1", "gru_l1_split"),
                               ("l2", "gru_l2head_split")):
                geometries[name + "/" + shape] = gru_split.geometry(
                    kind, 256, B, dev, mode, 10 if kind == "l1" else 0)
            # layer 1 with 64 units a block (clusters of 4, 8 columns)
            timed("gru_l1_split_C4/" + shape,
                  lambda: gru_split._launch_l1(*a1, mode=mode, quant=True,
                                               cluster=(4, 8)))
        if (B, mode) in BF16_SWEEPS:
            # the bf16 kernels (quant=False) at the same shape
            wb = gru_split.prepare_split_weights(layers, head, mode, False,
                                                 dev)
            b1 = (xt, ln, wb["w_ih1"], wb["b_ih1"], wb["w_hh1"], wb["sc1"],
                  wb["b_hh1"])
            fq, bq = gru_split.gru_l1_split(*b1, mode=mode, quant=False)
            b2 = (fq, bq, ln, wb["w_in2"], wb["in_scale2"], wb["b_ih2"],
                  wb["w_hh2"], wb["sc2"], wb["b_hh2"], wb["w_head"])
            timed("gru_l1_split_bf16/" + shape,
                  lambda: gru_split.gru_l1_split(*b1, mode=mode,
                                                 quant=False))
            timed("gru_l2head_split_bf16/" + shape,
                  lambda: gru_split.gru_l2head_split(*b2, mode=mode,
                                                     quant=False))
            if hasattr(gru_split, "l2_route"):
                # where the tree runs bf16 on clusters: geometries (C, BT)
                # beside the chooser's, each held to the chooser's outputs
                # (layer 1 bit for bit: every geometry's sums are exact;
                # the logits differ by the head's sum over a cluster's
                # blocks)
                l1_cl, l2_cl = BF16_SWEEPS[B, mode]
                for kind, name in (("l1", "gru_l1_split_bf16"),
                                   ("l2", "gru_l2head_split_bf16")):
                    geometries[name + "/" + shape] = gru_split.geometry(
                        kind, 256, B, dev, mode, 10 if kind == "l1" else 0,
                        quant=False)
                lg = gru_split.gru_l2head_split(*b2, mode=mode, quant=False)
                for cl in l1_cl:
                    key = "gru_l1_split_bf16_C{}_BT{}/{}".format(*cl, shape)
                    timed(key, lambda: gru_split._launch_l1(
                        *b1, mode=mode, quant=False, cluster=cl))
                    got = gru_split._launch_l1(*b1, mode=mode, quant=False,
                                               cluster=cl)
                    sweeps[key] = all(torch.equal(g, r) for g, r in
                                      zip(got, (fq, bq)))
                for cl in l2_cl:
                    key = "gru_l2head_split_bf16_C{}_BT{}/{}".format(
                        *cl, shape)
                    timed(key, lambda: gru_split._launch_l2(
                        *b2, mode=mode, quant=False, cluster=cl))
                    got = gru_split._launch_l2(*b2, mode=mode, quant=False,
                                               cluster=cl)
                    sweeps[key] = max((g - r).abs().max().item()
                                      for g, r in zip(got, lg))
            del wb, b1, b2, fq, bq
        del xt, f, b, a1, a2
    # bf16 layer 2 at H=384 and 512 (the per-block kernel where the tree
    # routes these widths to it) in mode "t": at B=192 two columns a
    # thread, at B=480 four
    T = 1000
    for H in (384, 512):
        layers, head = cs.random_net(rng, hidden=H)
        wb = gru_split.prepare_split_weights(layers, head, "t", False, dev)
        for B in (192, 480):
            xt = torch.from_numpy(rng.random((T, B, 10)).astype(
                "float32")).to(dev, torch.bfloat16)
            ln = torch.full((B,), T, dtype=torch.int32, device=dev)
            fq, bq = gru_split.gru_l1_split(
                xt, ln, wb["w_ih1"], wb["b_ih1"], wb["w_hh1"], wb["sc1"],
                wb["b_hh1"], mode="t", quant=False)
            b2 = (fq, bq, ln, wb["w_in2"], wb["in_scale2"], wb["b_ih2"],
                  wb["w_hh2"], wb["sc2"], wb["b_hh2"], wb["w_head"])
            timed("gru_l2head_split_bf16/H{}_B{}_T{}_t".format(H, B, T),
                  lambda: gru_split.gru_l2head_split(*b2, mode="t",
                                                     quant=False))
            del xt, fq, bq, b2
        del wb
    if geometries:
        print("   split geometries (C, BT, shared memory, resident "
              "clusters): {}".format(json.dumps(geometries)), flush=True)
    if sweeps:
        print("   bf16 geometries against the chooser's: layer 1 the same "
              "bits, layer 2 the logits' largest difference: {}".format(
                  json.dumps(sweeps)), flush=True)
    torch.cuda.synchronize()
    torch.save({"tree": os.path.abspath(tree), "card": cs.card_line(),
                "outputs": outputs, "times": times, "train_step": step,
                "split_geometry": geometries, "bf16_sweeps": sweeps,
                "profiles": profiles},
               out_path)
    print("chip_ab: {} outputs, {} times of {} -> {}".format(
        len(outputs), len(times), tree, out_path))
    return 0


def compare(paths):
    import torch
    runs = [torch.load(p) for p in paths]
    report = {"runs": [{"file": p, "tree": r["tree"], "card": r["card"]}
                       for p, r in zip(paths, runs)],
              "outputs": {}, "times_ms": {},
              "train_step_vs_plain": [r["train_step"] for r in runs]}
    # a key missing from the first file (a whole run after a split-only
    # one) is held to the first file that has it; null where a file lacks
    # the key
    refs = {}
    for r in runs:
        for key, value in r["outputs"].items():
            refs.setdefault(key, (r, value))
    for key, (holder, ref) in refs.items():
        row = []
        for r in runs[1:]:
            got = r["outputs"].get(key)
            if got is None or r is holder:
                row.append(None)
            elif torch.equal(got, ref):
                row.append("identical")
            else:
                row.append((got.float() - ref.float()).abs().max().item())
        report["outputs"][key] = row
    keys = sorted({k for r in runs for k in r["times"]})
    for key in keys:
        report["times_ms"][key] = [r["times"].get(key) for r in runs]
    report["split_geometry"] = [r.get("split_geometry", {}) for r in runs]
    report["profiles_ms"] = [r.get("profiles", {}) for r in runs]
    report["bf16_sweeps"] = [r.get("bf16_sweeps", {}) for r in runs]
    differ = sorted(k for k, row in report["outputs"].items()
                    if any(v not in ("identical", None) for v in row))
    print(json.dumps(report, indent=1))
    print("outputs that differ from the first file's: {}".format(
        json.dumps(differ)))
    # the int8 layer 2's logits may differ by the order of the head's sum,
    # the bf16 split kernels' outputs by their sums' order (checked below),
    # the f32-gates and int8 fullfused layers over random inputs by the
    # order of the projection stage's sums (one bf16 step of a
    # projection), and bilstm_fused (the LSTM cluster forward since PR 10)
    # by the order of its recurrent product's f32 sums; every other
    # output, the fullfused layers over exact projections included, must
    # repeat the first file's bits
    others = [k for k in differ
              if not (k.startswith("gru_split/") and "/True/l2head" in k)
              and "/False/" not in k
              and not k.startswith(("bigru_fullfused/f32_gates/",
                                    "bigru_fullfused/int8/",
                                    "bilstm_fused", "gru_split_bf16/"))]
    print("outputs other than the int8 logits, the bf16 split kernels', "
          "the fullfused layers over random projections and bilstm_fused "
          "that differ: {}".format(json.dumps(others)))
    # the bf16 split kernels' outputs may move by their sums' order within
    # the card's bars: layer 1 one bf16 step (2^-7, mean 1e-3), layer 2's
    # logits on the same (plain) layer-1 outputs 1e-3; the logits chained
    # on each tree's own layer 1 are reported above
    outside = []
    for key, (holder, ref) in refs.items():
        if "/False/l1" in key:
            most, mean = 2.0 ** -7, 1e-3
        elif key.startswith("gru_split_bf16/"):
            most, mean = 1e-3, None
        else:
            continue
        for r in runs[1:]:
            if r is holder or key not in r["outputs"]:
                continue
            diff = (r["outputs"][key].float() - ref.float()).abs()
            if diff.max().item() > most or (
                    mean is not None and diff.mean().item() > mean):
                outside.append([key, r["tree"], diff.max().item(),
                                diff.mean().item()])
    # a swept geometry's layer 1 repeats the chooser's bits, its logits
    # stay within 1e-3 of the chooser's
    for r in runs:
        for key, v in r.get("bf16_sweeps", {}).items():
            if v is False or (v is not True and v > 1e-3):
                outside.append([key, r["tree"], v])
    print("bf16 split outputs outside the bars of the first file's, or "
          "geometries away from the chooser's: {}".format(
              json.dumps(outside)))
    return 1 if outside else 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="run one tree's kernels, save outputs")
    r.add_argument("--tree", default=HERE, help="checkout to load the "
                   "port from (default: this one)")
    r.add_argument("--out", required=True, help="file of the outputs")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--split-only", action="store_true", help="run and time "
                   "the split kernels alone")
    c = sub.add_parser("compare", help="compare saved runs")
    c.add_argument("files", nargs="+")
    args = parser.parse_args(argv)
    if args.cmd == "run":
        return run(args.tree, args.out, args.seed, args.split_only)
    return compare(args.files)


if __name__ == "__main__":
    sys.exit(main())
