"""Device meshes for (data, model) layouts, and the counted collectives.

Port of turbo_whisper_workspace_tpu/parallel/mesh.py. A mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group (or a subset of them), with dims ("data",
"model"): "data" splits the batch of windows (DP), "model" splits
attention heads and MLP hidden units (TP). The process group must be
up first: `parallel.infer.maybe_initialize_distributed` starts it from
torchrun's environment, and tests and scripts call
`torch.distributed.init_process_group` themselves (gloo on the CPU,
NCCL on the card; `BACKENDS`).

Every collective the port's parallel code issues goes through
`all_reduce`, `all_gather` or `broadcast` here, which count it in
`collective_counts`: the counter takes the place of the JAX package's
count of collectives in a compiled program's HLO. A group of one rank
issues nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..pipeline.transcriber import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = {"cpu": "gloo", "cuda": "nccl"}

# collective → calls issued since the last reset_collective_counts()
collective_counts = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


def reset_collective_counts() -> None:
    for name in collective_counts:
        collective_counts[name] = 0


def make_mesh(model_parallel: int = 1, data_parallel: int = -1,
              device_type: str = "cuda", ranks: list[int] | None = None) -> DeviceMesh:
    """A (data_parallel, model_parallel) mesh over `ranks` (default: the
    whole world), rank-major: ranks r·tp .. r·tp + tp − 1 form data row
    r. Every rank of the world must call this, members or not (a rank
    outside `ranks` gets `get_coordinate() is None`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "maybe_initialize_distributed() or init_process_group first")
    resolve_device(device_type)
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    n = len(ranks)
    if model_parallel <= 0:
        model_parallel = 1
    if data_parallel <= 0:
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(f"mesh {data_parallel}x{model_parallel} != {n} ranks")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(data_parallel, model_parallel)
    return DeviceMesh(device_type, grid, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def data_sharding(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a batch that every rank holds whole: the
    leading axis split evenly over the data axis (a view)."""
    dp = mesh.size(0)
    if x.shape[0] % dp:
        raise ValueError(f"batch {x.shape[0]} not divisible by data axis {dp}")
    n = x.shape[0] // dp
    i = mesh.get_local_rank(DATA_AXIS)
    return x[i * n:(i + 1) * n]


def replicated(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """Make x whole and equal on every rank of the mesh: the value of the
    mesh's first rank, broadcast down each data column and then along
    each model row, in place. Returns x."""
    d, m = mesh.get_coordinate()
    grid = mesh.mesh
    broadcast(x, int(grid[0, m]), mesh.get_group(DATA_AXIS))
    broadcast(x, int(grid[d, 0]), mesh.get_group(MODEL_AXIS))
    return x


# ---------------------------------------------------------------------------
# counted collectives


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce x over `group` in place (a sum by default); returns x."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(x, op=op, group=group)
        collective_counts["all_reduce"] += 1
    return x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' x (equal shapes) concatenated along `dim`, in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    collective_counts["all_gather"] += 1
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """x from global rank `src` to every rank of `group`, in place."""
    if dist.get_world_size(group) > 1:
        dist.broadcast(x, src=src, group=group)
        collective_counts["broadcast"] += 1
    return x


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, gradient summed over the group
    backward (the input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: summed over the group forward, identity backward
    (the output of a row-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.mark_dirty(x)
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum x over `group`, in place (x must be a fresh result)."""
    return _ReduceFromGroup.apply(x, group)
