"""Data parallel over processes (counterpart of
gen_adversarial_tpu/core/distributed.py, and of core/mesh.py's data axis):
one process per GPU, started by torchrun, joined by `torch.distributed`.

The JAX package runs one process per host over a device mesh; the port runs
one process per device, as the reference's torchrun launch does
(classifier/train.py:334-348). So the JAX `--n-devices k` is k processes
here: `torchrun --nproc-per-node k -m <cli> ... --distributed`, and a count
of devices above 1 inside one process raises (`check_n_devices`).

- `maybe_initialize` joins the process group from torchrun's environment
  (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): nccl where CUDA
  is available, gloo on the CPU. Without that environment it exits with a
  message: a run that asked for --distributed never falls back to one
  process quietly.
- `process_shard` is (rank, world), (0, 1) without a group.
- `allgather_lists` concatenates each rank's list of floats, process-major
  (the reference's all_gather + torch.cat, test_defense.py:239-253).
- `all_reduce_sum` is differentiable: its gradient is the all-reduced
  cotangent (what SyncBatchNorm does), so a quantity computed from every
  rank's batch, such as models/batchnorm.py's training moments, passes its
  gradient back to every rank.
- `wrap_ddp` wraps a model in DistributedDataParallel, whose backward
  averages the gradients over the ranks.

The group's timeout bounds how long a collective waits for the slowest
rank: the harness's ranks meet only once, after their shards.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch import nn

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
DEFAULT_TIMEOUT_S = 600.0


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def maybe_initialize(backend: str | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join torchrun's process group (once; a second call keeps the first
    group) and return whether the world has more than one process. nccl
    sets this process's GPU to cuda:LOCAL_RANK first."""
    if not initialized():
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise SystemExit(
                "--distributed asked for, but this process was not started by torchrun "
                f"(no {', '.join(missing)} in the environment): run "
                "`torchrun --nproc-per-node <processes> -m <module> ... --distributed`")
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size() > 1


def process_shard() -> tuple[int, int]:
    """(rank, world size), (0, 1) when no group is initialized."""
    if not initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def data_parallel_shard(distributed: bool, who: str) -> tuple[int, int]:
    """(rank, world size) of a run that asked for data parallelism, (0, 1)
    of one that did not; asking without an initialized group raises rather
    than run the whole job in every process."""
    if not distributed:
        return 0, 1
    if not initialized():
        raise RuntimeError(f"{who}: distributed=True, but no process group is initialized "
                           "(call core.distributed.maybe_initialize() under torchrun first, "
                           "as the CLIs do with --distributed)")
    return process_shard()


def is_rank0() -> bool:
    return process_shard()[0] == 0


def multi_process() -> bool:
    """Whether a process group of more than one process is active."""
    return process_shard()[1] > 1


def local_device(device) -> torch.device:
    """torch.device(device), a bare 'cuda' made cuda:LOCAL_RANK under
    torchrun (one GPU a process); an explicit index stays."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def check_n_devices(n_devices: int | None, module: str) -> None:
    """More than one device inside one process raises, naming the torchrun
    command that runs the same job: the port's data parallelism is one
    process per GPU."""
    if n_devices is not None and n_devices > 1:
        raise ValueError(
            f"n_devices={n_devices} in one process: the port runs data parallel as one "
            f"process per GPU; run `torchrun --nproc-per-node {n_devices} -m {module} ... "
            "--distributed` instead")


def allgather_lists(values: list) -> list:
    """Every rank's list concatenated in rank order (lists may differ in
    length); the list itself at world size 1."""
    rank, world = process_shard()
    if world <= 1:
        return list(values)
    gathered = [None] * world
    dist.all_gather_object(gathered, list(values))
    return [v for part in gathered for v in part]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks, differentiable (the gradient is the sum
    of the ranks' cotangents)."""
    return _AllReduceSum.apply(x)


def wrap_ddp(model: nn.Module) -> nn.Module:
    """The model in DistributedDataParallel over the initialized group
    (gradients averaged over the ranks in the backward). Buffers are not
    broadcast at each forward: models/batchnorm.py computes its running
    statistics from the global batch, the same on every rank."""
    param = next(model.parameters())
    device_ids = [param.device] if param.is_cuda else None
    return nn.parallel.DistributedDataParallel(model, device_ids=device_ids,
                                               broadcast_buffers=False)
