#!/usr/bin/env python3
"""Time one source tree's end-to-end paths on one GPU, for holding two
trees against each other in one call:

    python3 chip_ab_paths.py TREE WORK OUT.json

The paths: counts inference through the CLI (``inference`` with the
bundled ``gru256_lambda_demo`` model on a synthetic 0.5 Mb BAM at depth
20, seed 0; three runs, the first one cold), the same with
``--output_shards 4 --feature_processes 4`` (two runs), and the counts
train step through ``parallel.make_train_step`` (``GRUModel`` H=256,
bf16, adam, the first batch of 128 rows of the BAM's ``features
--truth``; 10 steps after 3 warm-up steps, wall milliseconds each).
The BAM and features are made in WORK once and reused by the next run.
Run the parent and the change in turns (A, B, B, A) in one call, each in
a fresh process, and print the card's name and power limit beside them.
"""
import concurrent.futures
import json
import os
import sys
import time


def main(argv):
    tree, work, out_path = (os.path.abspath(a) for a in argv[:3])
    sys.path.insert(0, tree)
    import torch
    from medaka_tpu_torch import cli, parallel, testing, training
    from medaka_tpu_torch.models.gru import GRUModel
    from medaka_tpu_torch.ops import gru_split, gru_train
    if not os.path.dirname(cli.__file__).startswith(tree):
        raise RuntimeError("imported {} instead of {}'s".format(
            cli.__file__, tree))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for future in [pool.submit(f) for f in (gru_split.build,
                                                gru_train.build)]:
            future.result()
    res = {"tree": tree, "build_s": time.perf_counter() - t0,
           "inference_s": [], "sharded_s": []}
    model_path = os.path.join(tree, "medaka_tpu", "data",
                              "gru256_lambda_demo_model_pt.tar.gz")
    os.makedirs(work, exist_ok=True)
    bam = os.path.join(work, "reads.bam")
    train_hdf = os.path.join(work, "train.hdf")
    if not os.path.exists(train_hdf):
        bam, draft = testing.create_synth_bam(bam, ref_mb=0.5, depth=20,
                                              seed=0)
        truth = testing.create_truth_bam(os.path.join(work, "truth.bam"),
                                         draft)
        if cli.main(["features", bam, train_hdf, "--truth", truth,
                     "--quiet"]) != 0:
            raise RuntimeError("features failed")
    tag = "{}_{}".format(os.path.basename(tree), os.getpid())
    for key, reps, extra in (
            ("inference_s", 3, []),
            ("sharded_s", 2, ["--output_shards", "4",
                              "--feature_processes", "4"])):
        for i in range(reps):
            out = os.path.join(work, "{}_{}_{}.hdf".format(key, tag, i))
            t0 = time.perf_counter()
            if cli.main(["inference", bam, out, "--model", model_path,
                         "--quiet"] + extra) != 0:
                raise RuntimeError("inference failed")
            torch.cuda.synchronize()
            res[key].append(time.perf_counter() - t0)
    batcher = training.TrainBatcher([train_hdf], batch_size=128, seed=0)
    host = next(batcher.batches("train", seed=0))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in host.items()}
    torch.manual_seed(0)
    model = GRUModel(gru_size=256).to("cuda")
    opt = training.build_optimizer("adam", None, {"learning_rate": 1e-3})
    opt.init(list(model.parameters()))
    step = parallel.make_train_step(model, opt, compute_dtype=torch.bfloat16)
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    res["step_ms"] = []
    for _ in range(10):
        t0 = time.perf_counter()
        loss, _, _ = step(batch)
        float(loss)
        res["step_ms"].append((time.perf_counter() - t0) * 1e3)
    with open(out_path, "w") as fh:
        json.dump(res, fh)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
