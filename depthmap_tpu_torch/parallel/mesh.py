"""Devices, the (data, model) mesh, the Megatron placement policy, and the
split of a batch over a list of devices.

Port of ``depthmap_tpu/parallel/mesh.py``.  ``local_devices`` is
``jax.devices()``'s counterpart; ``make_mesh`` a ``DeviceMesh`` named
("data", "model") over the initialized process group (NCCL on the card,
gloo on the CPU).  ``param_placement`` is the JAX policy keyed by
state-dict name, as PartitionSpec-like tuples: a 2-D weight of a layer
named ``qkv`` / ``fc1`` is column-split, ("model", None) of torch's
(out, in) layout (the transpose of flax's (in, out) kernel that
``P(None, "model")`` splits on its last axis); one of ``proj`` / ``fc2``
row-split, (None, "model"); everything else (the patch embedding's 4-D
conv ``proj`` too) replicated, ().

``shard_params`` carries that policy out on the ViT blocks with Megatron's
f / g operators written out, where XLA reshards in the global view:

- ``qkv``'s output rows are [q | k | v], so a contiguous split would give
  rank 0 all of q and half of k, and the local reshape to (3, heads, D)
  would mix heads.  Each rank takes whole heads with their own q, k and v:
  the split of the (3, H, D, C) view on H.  The column-split layers'
  biases (``qkv.bias``, BEiT's ``q_bias`` / ``k_bias`` / ``v_bias``,
  ``fc1.bias``) follow their weight's split: replicated in JAX, which is
  right only in the global view.
- The attention runs on the rank's H / tp heads, with BEiT's bias (or,
  in the streamed tier, the resized table's head columns) sliced to them;
  the rel-pos table stays replicated.  The input of the attention
  and of the MLP passes f (identity forward, an all-reduce of its gradient
  over "model"), so the table's and the input's gradients sum the ranks'
  heads.
- ``proj`` and ``fc2`` sum their partial products over "model" with g (an
  all-reduce forward, identity backward), then add their bias once.

State-dict keys stay the checkpoint's; ``full_state_dict`` gathers the
shards back into the full tensors.
"""
from __future__ import annotations

import copy
import os
import re
import weakref
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from depthmap_tpu_torch.models.attention import RelBiasSpec

_COL_PARALLEL = re.compile(r"(qkv|fc1)$")
_ROW_PARALLEL = re.compile(r"(proj|fc2)$")


def canonical(device) -> torch.device:
    """A torch.device with its index: "cuda" is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(device="cuda") -> List[torch.device]:
    """Every visible card for a CUDA ``device`` (``jax.devices()``'s
    counterpart), else ``[device]``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def init_process_group(rank: int, world_size: int, store_dir: str,
                       device_type: str = "cuda",
                       timeout_s: float = 300.0) -> None:
    """Join a process group of ``world_size`` through a file store in
    ``store_dir`` (an empty directory of the caller's; no port is taken):
    NCCL for "cuda", each rank on card ``rank`` modulo the count; gloo for
    "cpu".  Every collective times out after ``timeout_s``."""
    import torch.distributed as dist
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method="file://" + os.path.join(store_dir, "store"),
        rank=rank, world_size=world_size,
        timeout=timedelta(seconds=timeout_s))


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device_type: str = "cuda"):
    """(data, model) DeviceMesh over the initialized process group: data =
    batch, model = the tensor split.  ``n_devices`` (default: the world
    size) must be the world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.mesh.init_process_group)")
    n = dist.get_world_size() if n_devices is None else n_devices
    assert n % model_parallel == 0, (n, model_parallel)
    return init_device_mesh(device_type, (n // model_parallel,
                                          model_parallel),
                            mesh_dim_names=("data", "model"))


def param_placement(name: str, tensor: torch.Tensor) -> tuple:
    """The placement of one parameter, keyed by its state-dict name, as a
    PartitionSpec-like tuple of mesh axis names per dim: ("model", None)
    for a column split of torch's (out, in) weight, (None, "model") for a
    row split, () replicated.  Only 2-D Linear weights split (PatchEmbed's
    conv is also named "proj"; splitting a 4-D conv kernel would split its
    spatial or channel axes for no gain)."""
    parts = name.split(".")
    owner = parts[-2] if len(parts) >= 2 else ""
    if tensor.dim() == 2 and _COL_PARALLEL.search(owner):
        return ("model", None)
    if tensor.dim() == 2 and _ROW_PARALLEL.search(owner):
        return (None, "model")
    return ()


def tree_placements(state_dict: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """``param_placement`` of every entry of a state dict."""
    return {k: param_placement(k, v) for k, v in state_dict.items()}


# -- tensor parallelism: Megatron's f and g ---------------------------------

class _CopyToModel(torch.autograd.Function):
    """f: identity forward, all-reduce of the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """g: all-reduce forward over the group, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class AllReduceSum(torch.autograd.Function):
    """A sum over the group whose backward sums the gradients over it too
    (``torch.distributed.nn.functional.all_reduce``'s rule, which torch
    2.13 deprecates): every rank's copy of the sum feeds its own loss."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class RowParallelLinear(nn.Linear):
    """A row-split Linear: the rank's slice of the input features times its
    columns of the weight, summed over the model group (g), then the bias
    once."""

    tp_group = None

    def forward(self, x):
        out = _ReduceFromModel.apply(F.linear(x, self.weight), self.tp_group)
        return out if self.bias is None else out + self.bias


def _attn_pre_hook(mod, args):
    """f on the attention's input; BEiT's bias through f, then its rank's
    heads: axis -3 of a (1, H, N, N) bias, the last axis of a streamed
    block's (T, H) table (``RelBiasSpec``)."""
    x, *rest = args
    x = _CopyToModel.apply(x, mod.tp_group)
    if rest and rest[0] is not None:
        start, count = mod.tp_heads
        bias = rest[0]
        if isinstance(bias, RelBiasSpec):
            rest[0] = RelBiasSpec(_CopyToModel.apply(
                bias.table, mod.tp_group).narrow(-1, start, count),
                bias.gh, bias.gw)
        else:
            rest[0] = _CopyToModel.apply(bias, mod.tp_group).narrow(
                -3, start, count)
    return (x, *rest)


def _mlp_pre_hook(mod, args):
    return (_CopyToModel.apply(args[0], mod.tp_group), *args[1:])


def _replace(owner: nn.Module, name: str, value: torch.Tensor) -> None:
    """Set ``owner.name`` (a parameter or a buffer) to ``value``."""
    if name in owner._parameters:
        owner._parameters[name] = nn.Parameter(
            value.detach().clone(),
            requires_grad=owner._parameters[name].requires_grad)
    else:
        owner._buffers[name] = value.detach().clone()


def shard_params(module: nn.Module, mesh) -> Dict[str, tuple]:
    """Split ``module``'s parameters over ``mesh``'s "model" axis in place,
    as ``tree_placements`` places them (see the module docstring): a
    column-split ``qkv`` by whole heads, with its attention's q / k / v
    biases, any other column-split layer (``fc1``) on its output rows with
    its bias, each with f on its parent's input; then each row-split layer
    (``proj``, ``fc2``) on its input columns, summed over the axis by g.
    Returns the layout (state-dict name -> how its shard was cut), also
    kept as ``module.tp_layout``.  Raises where a row-split layer's parent
    has no column-split layer."""
    tp = mesh["model"].size()
    layout: Dict[str, tuple] = {}
    module.tp_layout = layout
    if tp == 1:
        return layout
    rank = mesh["model"].get_local_rank()
    group = mesh["model"].get_group()
    modules = dict(module.named_modules())
    rows = []
    for key, spec in tree_placements(dict(module.named_parameters())).items():
        if not spec:
            continue
        name = key.rsplit(".", 1)[0]
        parent_name, _, leaf = name.rpartition(".")
        parent = modules[parent_name]
        if spec.index("model") == 1:
            rows.append((name, parent))
            continue
        parent.tp_group = group
        if leaf == "qkv":
            _shard_heads(parent, parent_name, rank, tp, layout)
            parent.register_forward_pre_hook(_attn_pre_hook)
        else:
            layer = modules[name]
            for p in ("weight", "bias"):
                t = getattr(layer, p)
                if t is not None:
                    _replace(layer, p, t.chunk(tp, 0)[rank])
                    layout[f"{name}.{p}"] = ("dim", 0, tp, tuple(t.shape))
            parent.register_forward_pre_hook(_mlp_pre_hook)
    for name, parent in rows:
        if getattr(parent, "tp_group", None) is not group:
            raise ValueError(f"{name} is row-split, but no layer beside it "
                             "is column-split")
        layer = modules[name]
        w = layer.weight
        _replace(layer, "weight", w.chunk(tp, 1)[rank])
        layout[f"{name}.weight"] = ("dim", 1, tp, tuple(w.shape))
        layer.__class__ = RowParallelLinear
        layer.tp_group = group
    return layout


def _shard_heads(attn: nn.Module, name: str, rank: int, tp: int,
                 layout: Dict[str, tuple]) -> None:
    """The rank's whole heads of ``attn``'s qkv weight and bias and of
    BEiT's q / k / v biases: the (3, H, D, C) view split on H."""
    heads = attn.num_heads
    assert heads % tp == 0, (name, heads, tp)
    h = heads // tp
    pre = f"{name}." if name else ""
    qkv = attn.qkv
    for owner, leaf, lead in ((qkv, "weight", 3), (qkv, "bias", 3),
                              (attn, "q_bias", 1), (attn, "k_bias", 1),
                              (attn, "v_bias", 1)):
        t = getattr(owner, leaf, None)
        if t is None:
            continue
        full = t.reshape(lead, heads, -1, *t.shape[1:])
        _replace(owner, leaf, full[:, rank * h:(rank + 1) * h]
                 .reshape(-1, *t.shape[1:]))
        key = f"{pre}qkv.{leaf}" if owner is qkv else f"{pre}{leaf}"
        layout[key] = ("heads", lead, heads, tuple(t.shape))
    attn.num_heads = h
    attn.tp_heads = (rank * h, h)


def gather_shard(local: torch.Tensor, how: tuple, group) -> torch.Tensor:
    """The full tensor from each rank's ``local`` shard, cut as ``how``
    (an entry of ``shard_params``'s layout)."""
    import torch.distributed as dist
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(
        group))]
    dist.all_gather(parts, local.contiguous(), group=group)
    kind, axis, count, shape = how
    if kind == "dim":
        return torch.cat(parts, axis)
    rest = shape[1:]
    return torch.cat([p.reshape(axis, count // len(parts), -1, *rest)
                      for p in parts], 1).reshape(shape)


def full_state_dict(module: nn.Module, mesh=None,
                    grads: bool = False) -> Dict[str, torch.Tensor]:
    """The module's state dict (``grads``: its parameters' gradients, zeros
    where a parameter has none) with every tensor-parallel shard gathered
    over ``mesh``'s "model" axis: the checkpoint's keys and shapes."""
    layout = getattr(module, "tp_layout", {})
    if grads:
        src = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
               for k, p in module.named_parameters()}
    else:
        src = module.state_dict()
    out = {}
    for k, v in src.items():
        v = v.detach()
        if k in layout:
            v = gather_shard(v, layout[k], mesh["model"].get_group())
        out[k] = v.clone()
    return out


# -- the split of a batch over devices --------------------------------------

_REPLICAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def module_device(module: nn.Module) -> torch.device:
    for t in module.parameters():
        return t.device
    return torch.device("cpu")


def _weights_stamp(module: nn.Module) -> tuple:
    """What changes when a tensor of ``module`` is replaced or written in
    place (a load, an optimizer step)."""
    return tuple((t.data_ptr(), t._version) for t in
                 (*module.parameters(), *module.buffers()))


def replica(module: nn.Module, device) -> nn.Module:
    """``module`` itself on its own device; elsewhere a copy on ``device``,
    made from the module as it is and kept until its weights change (a
    new tensor or an in-place write, which bumps its version counter)."""
    device = canonical(device)
    if canonical(module_device(module)) == device:
        return module
    stamp = _weights_stamp(module)
    copies = _REPLICAS.setdefault(module, {})
    if device not in copies or copies[device][0] != stamp:
        copies[device] = (stamp, copy.deepcopy(module).to(device))
    return copies[device][1]


def split_run(fn: Callable[..., torch.Tensor], devices: Optional[Sequence],
              *xs: torch.Tensor, pad: bool = False) -> torch.Tensor:
    """``fn(*shards)`` over the tensors ``xs`` split on dim 0 into
    len(devices) equal shards, shard i moved to ``devices[i]`` (every
    shard launched before any output is gathered); the outputs back on the
    first tensor's device, in order.  The split needs two or more devices
    and a count they divide, else ``fn(*xs)`` runs once; with ``pad`` the
    count is padded with zeros to a multiple of them and the padded rows'
    outputs dropped.  A list may repeat a device."""
    count, n = xs[0].shape[0], len(devices or ())
    if pad and n > 1 and count % n:
        more = n - count % n
        xs = tuple(torch.cat([x, x.new_zeros(more, *x.shape[1:])])
                   for x in xs)
    if n < 2 or xs[0].shape[0] < n or xs[0].shape[0] % n:
        return fn(*xs)[:count]
    outs = [fn(*(p.to(d) for p in parts))
            for d, *parts in zip(devices, *(x.chunk(n) for x in xs))]
    return torch.cat([o.to(xs[0].device) for o in outs])[:count]
