"""Worker for the localhost-coordinator test of test_torch_multihost.py
(no JAX).

Usage: python torch_multihost_worker.py <coordinator> <num_processes> \
    <process_id> <result_file>

Each process joins the process group through
``parallel.initialize_distributed`` (gloo on the CPU), then all-gathers
the process ids, so the test exercises a real collective over the
coordinator's TCP rendezvous. The result goes to ``result_file``: gloo
may write to fd 1 mid-line.
"""
import sys

import torch
import torch.distributed as dist

from medaka_tpu_torch import parallel


def main():
    coord, n, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    if "jax" in sys.modules:
        raise RuntimeError("the port's process imported JAX")
    parallel.initialize_distributed(coord, n, pid, timeout_s=60)
    assert dist.get_world_size() == n and dist.get_rank() == pid
    parts = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(parts, torch.tensor([pid]))
    vals = sorted(int(p) for p in parts)
    assert vals == list(range(n)), vals
    backend = dist.get_backend()
    dist.destroy_process_group()
    with open(sys.argv[4], "w") as fh:
        fh.write("DIST_OK {} {} {}\n".format(pid, vals, backend))


if __name__ == "__main__":
    main()
