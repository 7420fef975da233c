"""Sharded training step (fine-tuning): teacher-forced cross-entropy.

Port of turbo_whisper_workspace_tpu/parallel/train.py. The trained
tensors are every parameter and the encoder's sinusoidal `pos_emb`,
which is a leaf of the JAX package's parameter tree (optax updates it)
and a buffer here. The default optimizer is torch.optim.AdamW with
optax.adamw's defaults: betas (0.9, 0.999), eps 1e-8, weight decay 1e-4
(AdamW's own default is 1e-2).

Over a (data, model) mesh each rank takes its rows of the batch and its
shard of the model (sharding.shard_params, whose Megatron f/g operators
make the tensor-parallel gradients right). The loss is normalised by
the whole batch's mask count, not each rank's, so the data ranks' losses
and gradients sum to the batch's; the gradients are summed over the
data axis before the optimizer steps.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models import whisper as wm
from .infer import put_dp
from .mesh import DATA_AXIS, all_reduce, replicated
from .sharding import shard_params


def cross_entropy_loss(model: wm.Whisper, mel: torch.Tensor, tokens: torch.Tensor,
                       loss_mask: torch.Tensor,
                       denom: torch.Tensor | None = None) -> torch.Tensor:
    """Teacher-forced next-token CE. tokens (B, T): inputs tokens[:, :-1]
    predict targets tokens[:, 1:]; loss_mask (B, T-1) zeroes padding.
    The sum is divided by `denom` (default: loss_mask's count, at least
    1); a data-parallel rank passes the whole batch's."""
    logits = model(mel, tokens[:, :-1])
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None])[..., 0]
    if denom is None:
        denom = loss_mask.sum().clamp_min(1.0)
    return (nll * loss_mask).sum() / denom


def trained_tensors(model: wm.Whisper) -> list[torch.Tensor]:
    """Every parameter, then the encoder's pos_emb buffer."""
    return list(model.parameters()) + [model.encoder.pos_emb]


def make_train_step(model: wm.Whisper, mesh: DeviceMesh, optimizer=None,
                    learning_rate: float = 1e-5):
    """Build (init_fn, step_fn) over the mesh.

    init_fn() → (module, optimizer): `model` made equal to the mesh's
    first rank's, then this rank's shard of it (with a model axis of 1,
    `model` itself, trained in place), its trained tensors requiring
    grad, and `optimizer(tensors)` (default AdamW at `learning_rate`
    with optax.adamw's defaults) over them.

    step_fn(module, optimizer, mel, tokens, loss_mask) → (module,
    optimizer, loss): one step on the batch (every rank passes the whole
    batch; each data rank takes its rows); loss is the batch's."""

    def init_fn():
        with torch.no_grad():
            for t in model.state_dict().values():
                replicated(mesh, t)
        local = shard_params(model, mesh)
        tensors = trained_tensors(local)
        for t in tensors:
            t.requires_grad_(True)
        opt = (optimizer(tensors) if optimizer is not None else torch.optim.AdamW(
            tensors, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4))
        return local, opt

    def step_fn(local: wm.Whisper, opt, mel, tokens, loss_mask):
        device = local.decoder.token_emb.device
        loss_mask = torch.as_tensor(loss_mask)
        denom = loss_mask.sum().clamp_min(1.0).to(device)
        opt.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(local, put_dp(mesh, mel, device),
                                  put_dp(mesh, tokens, device).long(),
                                  put_dp(mesh, loss_mask, device), denom=denom)
        loss.backward()
        group = mesh.get_group(DATA_AXIS)
        if mesh.size(0) > 1:
            tensors = [p for g in opt.param_groups for p in g["params"]]
            flat = all_reduce(torch.cat([t.grad.reshape(-1) for t in tensors]), group)
            for t, g in zip(tensors, flat.split([t.numel() for t in tensors])):
                t.grad.copy_(g.view_as(t.grad))
        opt.step()
        return local, opt, all_reduce(loss.detach().clone(), group)

    return init_fn, step_fn
