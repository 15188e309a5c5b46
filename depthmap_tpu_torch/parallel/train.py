"""The sharded fine-tuning step for the depth models.

Port of ``depthmap_tpu/parallel/train.py``: the reference's SILog and
gradient-matching losses (dzoedepth/trainers/loss.py:42-135) drive one
step of a model whose batch is split on the mesh's "data" axis and whose
ViT blocks are split on its "model" axis (``mesh.shard_params``).

The JAX loss is one loss over the global batch: the mean and the variance
of g = log(pred) - log(target) run over every pixel of every data shard.
A per-rank SILog averaged over the ranks is another loss, so with more
than one data rank both losses are computed from sums all-reduced by a
differentiable all-reduce (``mesh.AllReduceSum``), the variance in two
passes (the mean first, then the sum of (g - mean)^2).
That all-reduce's backward sums the ranks' gradients of the same global
loss, which makes each rank's gradient W times its share; averaging the
parameters' gradients over the W data ranks, as DDP does, then gives the
global batch's gradient exactly.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch
import torch.nn as nn

from depthmap_tpu_torch.parallel.mesh import (AllReduceSum, module_device,
                                              shard_params)


def _global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group`` (differentiable); x itself without one."""
    return x if group is None else AllReduceSum.apply(x, group)


def _world(group) -> int:
    if group is None:
        return 1
    import torch.distributed as dist
    return dist.get_world_size(group)


def silog_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 0.15,
               eps: float = 1e-6, group=None) -> torch.Tensor:
    """Scale-invariant log loss (reference dzoedepth/trainers/loss.py:42)
    over the batch, and over ``group``'s equal shards of it where given.
    The variance is the unbiased (ddof = 1) one, torch.var's default."""
    g = torch.log(pred + eps) - torch.log(target + eps)
    if group is None:
        dg = torch.var(g) + beta * torch.mean(g) ** 2
    else:
        n = g.numel() * _world(group)
        mean = _global_sum(g.sum(), group) / n
        var = _global_sum(((g - mean) ** 2).sum(), group) / (n - 1)
        dg = var + beta * mean ** 2
    return 10.0 * torch.sqrt(dg)


def grad_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                 group=None) -> torch.Tensor:
    """Gradient-matching L1 loss (reference dzoedepth/trainers/loss.py:110)
    on (B, H, W) maps: the mean |d/dy| and |d/dx| differences over the
    batch, and over ``group``'s equal shards of it where given."""
    def grads(x):
        return x[:, 1:, :] - x[:, :-1, :], x[:, :, 1:] - x[:, :, :-1]

    world = _world(group)
    total = 0.0
    for p, t in zip(grads(pred), grads(target)):
        d = (p - t).abs()
        total = total + _global_sum(d.sum(), group) / (d.numel() * world)
    return total


def depth_loss(pred: torch.Tensor, target: torch.Tensor,
               group=None) -> torch.Tensor:
    """The JAX step's loss: SILog on max(pred, 0) + 1e-3 plus 0.1 x the
    gradient loss on pred (torch.maximum splits the gradient of a tie as
    jnp.maximum does)."""
    pos = torch.maximum(pred, torch.zeros_like(pred)) + 1e-3
    return silog_loss(pos, target, group=group) + \
        0.1 * grad_l1_loss(pred, target, group=group)


def make_train_step(model: nn.Module,
                    optimizer: Callable[[Iterable[nn.Parameter]],
                                        torch.optim.Optimizer],
                    mesh=None):
    """``shard_and_jit``'s twin: splits ``model``'s ViT blocks over
    ``mesh``'s "model" axis (in place), builds the optimizer on its
    parameters (``optimizer(params)``, e.g.
    ``functools.partial(torch.optim.Adam, lr=1e-4)``) and returns
    ``step(images, targets) -> loss``: images (B, 3, H, W) and targets
    (B, H, W), the global batch, of which each data rank takes its equal
    shard.  A step zeroes the gradients, runs the model in eval mode with
    grad on (JAX's ``train=False``: BatchNorm on its running statistics),
    takes the global loss, backpropagates, averages the gradients over the
    data axis and updates in place, marking every parameter written (a
    fused optimizer leaves the version counters that the caches of
    ``mesh.replica`` and ``StdConv`` key on as they were); the gradients
    stay on the parameters until the next step.  Without a mesh the step
    runs in this process alone.  Every process builds the model from the same weights."""
    from depthmap_tpu_torch.pipeline.depth import set_fp32_precision
    dev = module_device(model)
    set_fp32_precision(dev)
    model.eval()
    data_group, data_rank, data_size = None, 0, 1
    if mesh is not None:
        data_size = mesh["data"].size()
        data_rank = mesh["data"].get_local_rank()
        if data_size > 1:
            data_group = mesh["data"].get_group()
        shard_params(model, mesh)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = optimizer(params)

    def step(images: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        per, rem = divmod(images.shape[0], data_size)
        assert rem == 0 and per > 0, (images.shape[0], data_size)
        lo = data_rank * per
        x = images[lo:lo + per].to(dev, torch.float32)
        t = targets[lo:lo + per].to(dev, torch.float32)
        opt.zero_grad(set_to_none=True)
        loss = depth_loss(model(x), t, data_group)
        loss.backward()
        if data_group is not None:
            import torch.distributed as dist
            for p in params:
                if p.grad is not None:
                    dist.all_reduce(p.grad, group=data_group)
                    p.grad /= data_size
        opt.step()
        for p in params:
            torch.autograd.graph.increment_version(p)
        return loss.detach()

    step.model = model
    return step
