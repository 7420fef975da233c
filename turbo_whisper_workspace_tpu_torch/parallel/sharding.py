"""Megatron-style tensor-parallel sharding of the Whisper module.

Port of turbo_whisper_workspace_tpu/parallel/sharding.py, on the port's
state-dict names with the JAX package's rule:

* column-parallel, `q`, `k`, `v`, `fc1` (and a Llama's `gate`, `up`):
  each rank holds a slice of the output features, in nn.Linear's
  (out, in) layout the weight's rows and the bias;
* row-parallel, `out`, `fc2` (`down`): each rank holds a slice of the
  input features, the weight's columns; the partial products are summed
  over the model group and the bias, replicated, is added once after
  the sum;
* everything else (LayerNorms, embeddings, convs, positions) replicated.

The attention projections' slices fall on head boundaries, so each rank
runs the ordinary per-head kernels on its own H/tp heads: its blocks'
and decoder's head counts are the rank-local ones. Where the JAX package
leaves the collectives to GSPMD, the layers here issue them: a
column-parallel layer's input passes Megatron's f (identity forward,
gradient summed backward) and a row-parallel layer's output Megatron's
g (summed forward, identity backward), so a training step's gradients
are right too.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from .mesh import MODEL_AXIS, all_gather, copy_to_group, reduce_from_group

COLUMN = {"q", "k", "v", "fc1", "gate", "up"}
ROW = {"out", "fc2", "down"}


def _spec_for(name: str) -> int | None:
    *_, module, leaf = name.split(".")
    if module in COLUMN:
        return 0
    if module in ROW and leaf == "weight":
        return 1
    return None


def param_specs(model: nn.Module) -> dict[str, int | None]:
    """State-dict name → the dim split over the model axis (0: rows of a
    column-parallel weight, or its bias; 1: columns of a row-parallel
    weight), or None for a tensor every rank holds whole."""
    return {name: _spec_for(name) for name in model.state_dict()}


class ColumnParallelLinear(nn.Module):
    """A rank's slice of an nn.Linear's output features."""

    def __init__(self, full: nn.Linear, rank: int, tp: int, group):
        super().__init__()
        self.weight = nn.Parameter(full.weight.chunk(tp, 0)[rank].clone(),
                                   requires_grad=full.weight.requires_grad)
        self.bias = None if full.bias is None else nn.Parameter(
            full.bias.chunk(tp, 0)[rank].clone(), requires_grad=full.bias.requires_grad)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(copy_to_group(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """A rank's slice of an nn.Linear's input features; the partial
    products are summed over the model group, then the bias is added."""

    def __init__(self, full: nn.Linear, rank: int, tp: int, group):
        super().__init__()
        self.weight = nn.Parameter(full.weight.chunk(tp, 1)[rank].clone(),
                                   requires_grad=full.weight.requires_grad)
        self.bias = nn.Parameter(full.bias.clone(), requires_grad=full.bias.requires_grad)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and x.dtype != torch.float32 and not x.requires_grad:
            # bf16 operands, f32 partial sums summed across the ranks in
            # f32, one rounding after the bias: the unsharded layer's
            # rounding (its GEMM adds the bias to the f32 sums); mm's
            # out_dtype has no derivative, so a training step sums in
            # the activation dtype
            part = torch.mm(x.reshape(-1, x.shape[-1]), self.weight.t(),
                            out_dtype=torch.float32)
        else:
            part = F.linear(x, self.weight)
        out = reduce_from_group(part, self.group) + self.bias
        return out.reshape(*x.shape[:-1], -1).to(x.dtype)


def shard_params(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """This rank's module: a copy of `model` whose column- and
    row-parallel linears hold the rank's slices over the mesh's model
    axis, and whose attention blocks and decoder count the rank's heads.
    With a model axis of 1 the model itself is returned, unchanged."""
    tp = mesh.size(1)
    if tp == 1:
        return model
    rank = mesh.get_local_rank(MODEL_AXIS)
    group = mesh.get_group(MODEL_AXIS)
    local = copy.deepcopy(model)
    for mod in list(local.modules()):
        n_head = getattr(mod, "n_head", None)
        if n_head is not None:
            if n_head % tp:
                raise ValueError(f"{n_head} heads do not split over a model axis of {tp}")
            mod.n_head = n_head // tp
        for name, child in list(mod.named_children()):
            if isinstance(child, nn.Linear) and name in COLUMN | ROW:
                cls = ColumnParallelLinear if name in COLUMN else RowParallelLinear
                setattr(mod, name, cls(child, rank, tp, group))
    return local


def gather_state_dict(local: nn.Module, mesh: DeviceMesh) -> dict[str, torch.Tensor]:
    """The inverse of shard_params: the whole model's state dict, each
    sharded tensor gathered over the model axis (every rank gets it)."""
    group = mesh.get_group(MODEL_AXIS)
    specs = param_specs(local)
    return {name: t if specs[name] is None else all_gather(t, group, specs[name])
            for name, t in local.state_dict().items()}


def cache_spec(dims, mesh: DeviceMesh, batch: int, max_len: int) -> tuple[int, ...]:
    """The rank-local bf16 self-KV cache shape (L, B/dp, T, D/tp): the
    batch over the data axis, the features (heads) over the model axis."""
    dp, tp = mesh.size(0), mesh.size(1)
    if batch % dp or dims.n_text_head % tp:
        raise ValueError(f"batch {batch} / {dims.n_text_head} heads do not split "
                         f"over a {dp}x{tp} mesh")
    return (dims.n_text_layer, batch // dp, max_len, dims.n_text_state // tp)

