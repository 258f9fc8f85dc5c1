"""Load the JAX package's flax variable trees into the port's modules.

`variables` is the tree as nested dicts of numpy arrays
(`{"params": ..., "batch_stats": ..., "noise": ..., "buffers": ...}`, e.g.
`jax.tree.map(np.asarray, v)`); nothing here imports JAX. Each flax leaf is
found in the module by name: a flax name like `dec_cells_1_0_0` resolves to
an attribute of that name or to key `1_0_0` of the ModuleDict attribute
`dec_cells`, and a flax list entry like `convs_3` to item 3 of the
ModuleList attribute `convs`. Layouts change as flax -> torch needs:

- convolution kernels HWIO -> OIHW (a depthwise (5,5,1,C) becomes (C,1,5,5),
  a grouped (3,3,width/groups,width) becomes (width,width/groups,3,3), the
  layout of nn.Conv2d(groups=groups)); the NVAE flow cells' `MaskedConv2d`
  is an nn.Conv2d and maps the same way (its depthwise `conv1` (5,5,1,hidden)
  -> (hidden,1,5,5)), its mask applied at each call and not stored;
- Dense kernels (in, out) -> Linear weights (out, in);
- BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var;
- LayerNorm scale/bias -> weight/bias (same layout); the Style-Transformer's
  Dense layers (`linear1`, `linear2`) are Dense kernels as above;
- the NVAE's `const_prior` NHWC -> NCHW;
- StyleGAN2: `EqualLinear.weight` (in, out) -> (out, in),
  `ModulatedConv2d.weight` and the discriminator's `EqualConv2d.weight`
  HWIO -> OIHW (its `bias` and `ConvLayer.activate_bias` as they are), the
  generator's `const_input`
  (1, 4, 4, C) -> (1, C, 4, 4), `ToRGB.bias` (1, 1, 1, 3) -> (1, 3, 1, 1),
  the fixed `noise_{i}` maps (collection `noise`) (1, H, W, 1) -> (1, 1, H, W);
  `NoiseInjection.weight`, `activate_bias`, `PReLU.alpha` and `latent_avg`
  (collection `buffers`) keep their layout;
- Style-Transformer: the attention leaves `in_proj_weight` (3D, D),
  `in_proj_bias`, `out_proj_weight` (D, D) and `out_proj_bias` are already in
  torch's (out, in) layout and keep it (no Dense transpose), as do the
  learned query `GradualStyleEncoder.z` (1, n_styles, 512) and
  `StyleTransformer.latent_avg` (n_styles, 512; collection `buffers`);
- A-VAE (models/avae/model.py): the equalized `weight` leaves of
  `AEqualConv2d` and `FusedDownsample` HWIO -> OIHW, of `FusedUpsample`
  (k, k, I, O) -> (I, O, k, k) (`conv_transpose2d`'s layout), of
  `AEqualLinear` (in, out) -> (out, in), `ANoiseInjection.weight`
  (1, 1, 1, C) -> (1, C, 1, 1), `StyledConvBlock.const_input` NHWC -> NCHW.
  These rules go by the owning module's class, so they never meet
  StyleGAN2's leaves of the same names;
- ND-VAE (models/ndvae/model.py): flax Conv, Dense and BatchNorm leaves as
  above (its depthwise `dw` (5, 5, 1, E) -> (E, 1, 5, 5), with its bias),
  and the decoder constant `h` NHWC -> NCHW.

Every parameter and buffer of the module must be set exactly once, with the
exact shape, or a ValueError says which one is wrong. A leaf may also be a
torch tensor (a bfloat16 leaf of `core/checkpoint.load_variables`); it is
cast to the module's dtype as it is copied.

`to_jax_variables` is the inverse: the module's parameters and buffers as the
flax tree (numpy arrays in flax's layouts), which `core/checkpoint.py` writes
and flax reads.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}
_LN_LEAVES = {"scale": "weight", "bias": "bias"}


def _child(module: nn.Module, name: str) -> nn.Module:
    if name in module._modules:
        return module._modules[name]
    for attr, sub in module._modules.items():
        if not name.startswith(attr + "_"):
            continue
        key = name[len(attr) + 1:]
        if isinstance(sub, nn.ModuleDict) and key in sub:
            return sub[key]
        if isinstance(sub, nn.ModuleList) and key.isdigit() and int(key) < len(sub):
            return sub[int(key)]
    raise ValueError(f"no submodule for flax name {name!r} in {type(module).__name__}")


def _leaves(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v if isinstance(v, torch.Tensor) else np.asarray(v)


def _permute(a, *axes):
    """a numpy array's or a tensor's dims in the order `axes`."""
    return a.permute(*axes) if isinstance(a, torch.Tensor) else a.transpose(axes)


def _t(a):
    return _permute(a, 1, 0)


def _hwio_to_oihw(a):
    return _permute(a, 3, 2, 0, 1)


def _nhwc_to_nchw(a):
    return _permute(a, 0, 3, 1, 2)


def _oihw_to_hwio(a):
    return _permute(a, 2, 3, 1, 0)


def _nchw_to_nhwc(a):
    return _permute(a, 0, 2, 3, 1)


def _hwio_to_iohw(a):
    return _permute(a, 2, 3, 0, 1)


def _iohw_to_hwio(a):
    return _permute(a, 2, 3, 0, 1)


def _same(a):
    return a


# each layout change of the flax -> torch direction and its inverse
_INVERSE = {_same: _same, _t: _t, _hwio_to_oihw: _oihw_to_hwio, _nhwc_to_nchw: _nchw_to_nhwc,
            _hwio_to_iohw: _iohw_to_hwio}


# leaves of the port's own modules, by (class name, flax leaf name)
_MODULE_LEAVES = {
    ("EqualLinear", "weight"): _t,
    ("EqualLinear", "bias"): _same,
    ("ModulatedConv2d", "weight"): _hwio_to_oihw,
    ("EqualConv2d", "weight"): _hwio_to_oihw,
    ("EqualConv2d", "bias"): _same,
    ("ConvLayer", "activate_bias"): _same,
    ("Generator", "const_input"): _nhwc_to_nchw,
    ("ToRGB", "bias"): _nhwc_to_nchw,
    ("NoiseInjection", "weight"): _same,
    ("StyledConv", "activate_bias"): _same,
    ("PReLU", "alpha"): _same,
    ("PSP", "latent_avg"): _same,
    ("TorchMHA", "in_proj_weight"): _same,
    ("TorchMHA", "in_proj_bias"): _same,
    ("TorchMHA", "out_proj_weight"): _same,
    ("TorchMHA", "out_proj_bias"): _same,
    ("GradualStyleEncoder", "z"): _same,
    ("StyleTransformer", "latent_avg"): _same,
    ("AEqualConv2d", "weight"): _hwio_to_oihw,
    ("AEqualConv2d", "bias"): _same,
    ("FusedDownsample", "weight"): _hwio_to_oihw,
    ("FusedDownsample", "bias"): _same,
    ("FusedUpsample", "weight"): _hwio_to_iohw,
    ("FusedUpsample", "bias"): _same,
    ("AEqualLinear", "weight"): _t,
    ("AEqualLinear", "bias"): _same,
    ("ANoiseInjection", "weight"): _nhwc_to_nchw,
    ("StyledConvBlock", "const_input"): _nhwc_to_nchw,
    ("DefenceNVAE", "h"): _nhwc_to_nchw,
}


def _target(module: nn.Module, collection: str, names: tuple, leaf: str):
    """(owning torch module, attribute name, flax -> torch layout change)."""
    owner = module
    for name in names:
        owner = _child(owner, name)
    if isinstance(owner, nn.modules.batchnorm._BatchNorm):
        return owner, _BN_LEAVES[leaf], _same
    if isinstance(owner, nn.LayerNorm):
        return owner, _LN_LEAVES[leaf], _same
    if isinstance(owner, nn.Conv2d):
        if leaf == "kernel":
            return owner, "weight", _hwio_to_oihw
        return owner, leaf, _same
    if isinstance(owner, nn.Linear):
        if leaf == "kernel":
            return owner, "weight", _t
        return owner, leaf, _same
    if leaf == "const_prior":
        return owner, leaf, _nhwc_to_nchw
    if collection == "noise" and type(owner).__name__ == "Generator":
        return owner, leaf, _nhwc_to_nchw
    rule = _MODULE_LEAVES.get((type(owner).__name__, leaf))
    if rule is not None:
        return owner, leaf, rule
    raise ValueError(f"no rule for flax leaf {'/'.join(names + (leaf,))} "
                     f"on {type(owner).__name__}")


@torch.no_grad()
def from_jax_variables(variables: Mapping, module: nn.Module) -> nn.Module:
    """Copy a flax variable tree into `module` in place; returns it."""
    done = {}
    for collection in ("params", "batch_stats", "noise", "buffers"):
        for path, arr in _leaves(variables.get(collection, {})):
            owner, attr, layout = _target(module, collection, path[:-1], path[-1])
            dest = getattr(owner, attr, None)
            if not isinstance(dest, torch.Tensor):
                raise ValueError(f"flax leaf {collection}/{'/'.join(path)}: "
                                 f"{type(owner).__name__} has no tensor {attr!r}")
            src = arr if isinstance(arr, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(arr))
            if tuple(dest.shape) != tuple(layout(src).shape):
                raise ValueError(f"{'/'.join(path)}: flax {tuple(arr.shape)} -> torch "
                                 f"{tuple(layout(src).shape)}, module has {tuple(dest.shape)}")
            if id(dest) in done:
                raise ValueError(f"{collection}/{'/'.join(path)} sets the tensor that "
                                 f"{done[id(dest)]} already set")
            # moved as stored, then transposed where the module lives (on the
            # card, not in a host copy of a large matrix)
            dest.copy_(layout(src.to(dest.device)))
            done[id(dest)] = f"{collection}/{'/'.join(path)}"
    missing = [name for name, t in list(module.named_parameters())
               + list(module.named_buffers())
               if id(t) not in done and not name.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"not in the flax tree: {missing[:8]}"
                         + (" ..." if len(missing) > 8 else ""))
    return module


def _torch_leaf(owner: nn.Module, attr: str):
    """(collection, flax leaf name, torch layout -> flax layout) of a tensor,
    the inverse of `_target`."""
    kind = type(owner).__name__
    if isinstance(owner, nn.modules.batchnorm._BatchNorm):
        leaf = {v: k for k, v in _BN_LEAVES.items()}[attr]
        return ("batch_stats" if leaf in ("mean", "var") else "params"), leaf, _same
    if isinstance(owner, nn.LayerNorm):
        return "params", {v: k for k, v in _LN_LEAVES.items()}[attr], _same
    if isinstance(owner, nn.Conv2d) and attr == "weight":
        return "params", "kernel", _oihw_to_hwio
    if isinstance(owner, nn.Linear) and attr == "weight":
        return "params", "kernel", _t
    if isinstance(owner, (nn.Conv2d, nn.Linear)):
        return "params", attr, _same
    if attr == "const_prior":
        return "params", attr, _nchw_to_nhwc
    if kind == "Generator" and attr.startswith("noise_"):
        return "noise", attr, _nchw_to_nhwc
    rule = _MODULE_LEAVES.get((kind, attr))
    if rule is None:
        raise ValueError(f"no flax leaf for {kind}.{attr}")
    return ("buffers" if attr == "latent_avg" else "params"), attr, _INVERSE[rule]


def _flax_modules(module: nn.Module, path=()):
    """(flax module path, module) of every module: a ModuleDict item `key` of
    attribute `attr` is flax's `attr_key`, a ModuleList item i `attr_i`."""
    yield path, module
    for name, sub in module._modules.items():
        if isinstance(sub, (nn.ModuleDict, nn.ModuleList)):
            items = sub.items() if isinstance(sub, nn.ModuleDict) else enumerate(sub)
            for key, item in items:
                yield from _flax_modules(item, path + (f"{name}_{key}",))
        elif sub is not None:
            yield from _flax_modules(sub, path + (name,))


@torch.no_grad()
def to_jax_variables(module: nn.Module) -> dict:
    """The flax variable tree of `module` (the inverse of `from_jax_variables`):
    nested dicts of numpy arrays on the host (bfloat16 tensors for bfloat16
    weights), in flax's layouts."""
    tree: dict = {}
    done = set()
    for path, owner in _flax_modules(module):
        tensors = list(owner._parameters.items()) + list(owner._buffers.items())
        for attr, t in tensors:
            if t is None or attr == "num_batches_tracked" or id(t) in done:
                continue
            done.add(id(t))
            collection, leaf, layout = _torch_leaf(owner, attr)
            node = tree.setdefault(collection, {})
            for name in path:
                node = node.setdefault(name, {})
            host = t.detach().cpu()
            # numpy has no bfloat16: such leaves stay tensors (core/checkpoint writes them)
            node[leaf] = layout(host if host.dtype == torch.bfloat16 else host.numpy())
    return tree
