"""Rank processes for tests/test_torch_parallel.py (no JAX).

:func:`pool_main` is one rank of a gloo world that runs jobs sent to it
over a queue, so one set of spawned processes serves every multi-rank
case of a test module. Every rank of the world runs every job: making a
group is collective, and the ranks outside a job's mesh then return
None. A job's result, or its traceback, goes back over the results
queue as ``(rank, ok, value)``.
"""
import datetime
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from medaka_tpu_torch import models, parallel, training

#: the longest a collective of a job waits for the other ranks
TIMEOUT_S = 120


def pool_main(rank, world, store, jobs, results):
    """Join the gloo world over ``store`` and run jobs until None."""
    if "jax" in sys.modules:
        raise RuntimeError("a port rank imported JAX")
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        while True:
            job = jobs.get()
            if job is None:
                break
            name, kwargs = job
            try:
                results.put((rank, True, JOBS[name](rank, **kwargs)))
            except Exception:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def _mesh(rank, data, model):
    mesh = parallel.Mesh(["cpu"] * (data * model), data=data, model=model)
    mesh.connect(rank)
    return mesh if rank < mesh.size else None


def _build(model_dict, params):
    model = models.model_from_dict(model_dict)
    model.load_jax_params(params)
    return model


def job_step(rank, data, model, model_dict, params, batch, optimizer, lr,
             clip, steps, class_weights=None):
    """``steps`` train steps of the mesh (data, model) on ``batch`` (the
    global batch: each rank takes its rows); returns the global losses,
    the whole parameters after the steps (JAX layout), the clip's norms
    and the counts of the last step."""
    mesh = _mesh(rank, data, model)
    if mesh is None:
        return None
    net = _build(model_dict, params)
    opt = training.Optimizer(optimizer, lr, clip=clip)
    params_list = list(net.parameters())
    opt.init(params_list)
    parallel.shard_model(net, mesh, opt)
    step = parallel.make_train_step(net, opt, compute_dtype=None,
                                    class_weights=class_weights, mesh=mesh)
    rows = mesh.rows(batch["features"].shape[0])
    local = {k: torch.from_numpy(np.asarray(v)[rows])
             for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        loss, n_c, n_t = step(local)
        losses.append(float(loss))
    with parallel.unsharded(net, mesh, opt):
        out = {"losses": losses, "counts": (float(n_c), float(n_t)),
               "params": net.jax_params(),
               "norms": opt.clip.norms[:steps].numpy().copy()
               if opt.clip is not None else None,
               "mu": [t.numpy().copy() for t in opt.state.get("mu", [])]}
    return out


def job_forward(rank, data, model, model_dict, params, x, lengths):
    """The f32 forward of the mesh (data, model) over the global batch
    (``parallel.make_sharded_forward``); rank 0 returns the
    probabilities."""
    mesh = _mesh(rank, data, model)
    if mesh is None:
        return None
    net = _build(model_dict, params)
    parallel.shard_model(net, mesh)
    probs = parallel.make_sharded_forward(net, mesh, compute_dtype=None)(
        torch.from_numpy(x), torch.from_numpy(lengths))
    return probs.numpy() if rank == 0 else None


JOBS = {"step": job_step, "forward": job_forward}
