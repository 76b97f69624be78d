"""Tensor-parallel FFNs over a 2-D (data, model) mesh (port of
`optispeech_tpu/parallel/tp.py`). Inference only, as in JAX.

JAX's rule, by parameter path: the layers whose path holds `pwconv1`,
`w_1` or `linear_1` are split by column (output features, with their
bias), those whose path holds `pwconv2`, `w_2` or `linear_2` by row (input
features; the bias stays whole), everything else is replicated. In the
port:
- a `Linear` (ConvNeXt's `pwconv1` / `pwconv2` in the encoder, the decoder
  and the WaveNeXt trunk, and WaveNeXt's head `linear_1` / `linear_2`) goes
  through `ColwiseParallel` / `RowwiseParallel` on the `model` axis: its
  weight becomes a DTensor sharded over that axis, and the row-parallel
  output is all-reduced;
- a `Conv1d` FFN (the transformer's and the conformer's `w_1` / `w_2`, of
  kernel size 1) has no DTensor strategy that splits its channels, so
  `distribute_module` places its weight as a DTensor sharded over the
  output channels (`w_1`, its bias too) or the input channels (`w_2`), and
  its forward convolves the local shard by hand; `w_2`'s partial sums are
  all-reduced over the `model` axis before its bias is added.
A ConvNeXt block whose `pwconv1.weight` is a DTensor runs unfused
(`models/modules/convnext.py`): the fused kernel takes the whole
intermediate width.
"""

import types

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from .mesh import _mesh_device_type, _require_group

COLUMN_NAMES = ("pwconv1", "w_1", "linear_1")
ROW_NAMES = ("pwconv2", "w_2", "linear_2")


def make_2d_mesh(n_data: int, n_model: int):
    """The (data, model) mesh over every rank of the group: n_data x n_model
    must equal the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_group()
    world = dist.get_world_size()
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} ranks, the "
                         f"group has {world}")
    return init_device_mesh(_mesh_device_type(), (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def split_of(name: str):
    """"column", "row" or None for the module at dotted path `name`."""
    parts = name.split(".")
    if any(n in p for p in parts for n in COLUMN_NAMES):
        return "column"
    if any(n in p for p in parts for n in ROW_NAMES):
        return "row"
    return None


def is_sharded(tensor) -> bool:
    """True for a DTensor (a parameter placed by `shard_params_tp`)."""
    from torch.distributed.tensor import DTensor

    return isinstance(tensor, DTensor)


def _conv_local(conv, x, bias):
    """`core.Conv1d.forward` on the local shard of the weight."""
    w = conv.weight.to_local()
    cd = conv.compute_dtype
    if cd == torch.float32:
        return F.conv1d(x, w, bias, conv.stride, conv.padding, conv.dilation, conv.groups)
    y = F.conv1d(x.to(cd), w.to(cd), None, conv.stride, conv.padding, conv.dilation,
                 conv.groups)
    return y if bias is None else y + bias.to(cd)[:, None]


def _column_conv_forward(conv, x):
    """Replicated input -> this rank's output channels."""
    return _conv_local(conv, x, None if conv.bias is None else conv.bias.to_local())


def _row_conv_forward(conv, x):
    """This rank's input channels -> the whole output, summed over the
    `model` axis, then the bias."""
    y = _conv_local(conv, x, None)
    dist.all_reduce(y, group=conv.tp_group)
    if conv.bias is None:
        return y
    bias = conv.bias.full_tensor()
    return y + (bias if conv.compute_dtype == torch.float32 else bias.to(y.dtype))[:, None]


def _shard_conv(conv: nn.Conv1d, tp_mesh, split: str):
    from torch.distributed.tensor import Replicate, Shard, distribute_module, distribute_tensor

    if conv.groups != 1:
        raise ValueError("only a dense Conv1d FFN is split by channels")
    weight_dim = 0 if split == "column" else 1

    def partition(_name, module, mesh):
        if module is not conv:
            return
        module.register_parameter("weight", nn.Parameter(
            distribute_tensor(module.weight.detach(), mesh, [Shard(weight_dim)]),
            requires_grad=False))
        if module.bias is not None:
            place = [Shard(0)] if split == "column" else [Replicate()]
            module.register_parameter("bias", nn.Parameter(
                distribute_tensor(module.bias.detach(), mesh, place), requires_grad=False))

    distribute_module(conv, tp_mesh, partition)
    conv.tp_group = tp_mesh.get_group()
    forward = _column_conv_forward if split == "column" else _row_conv_forward
    conv.forward = types.MethodType(forward, conv)


def shard_params_tp(module: nn.Module, mesh) -> nn.Module:
    """Split `module`'s FFNs over the mesh's `model` axis by JAX's name rule,
    in place (the rest stays replicated). Returns the module."""
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    tp_mesh = mesh["model"]
    plan = {}
    for name, sub in module.named_modules():
        split = split_of(name) if name else None
        if split is None:
            continue
        if isinstance(sub, nn.Linear):
            plan[name] = ColwiseParallel() if split == "column" else RowwiseParallel()
        elif isinstance(sub, nn.Conv1d):
            _shard_conv(sub, tp_mesh, split)
    parallelize_module(module, tp_mesh, plan)
    return module


def replicate_tp(module: nn.Module, mesh) -> nn.Module:
    """Give every rank of the mesh the first rank's unsharded parameters and
    buffers (broadcast in place). Returns the module."""
    src = int(mesh.mesh.flatten()[0])
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            if not is_sharded(t):
                dist.broadcast(t.data, src=src)
    return module
