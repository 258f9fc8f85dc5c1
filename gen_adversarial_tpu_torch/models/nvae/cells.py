"""NVAE building-block cells on NCHW tensors (counterpart of
gen_adversarial_tpu/models/nvae/cells.py). In eval mode every BatchNorm uses
its running statistics; under `module.train()` every BatchNorm normalises
with the batch's statistics and updates its running ones as flax does
(`models/batchnorm.py`: momentum 0.95 in flax's terms, the biased variance).

Submodule names follow the JAX package's variable tree (`bn0`, `conv_expand`,
`conv_depthwise`, `se.linear_1`, `skip.conv`, ...), so `core/convert.py` maps
weights by name. In eval mode the decoder cell's BN-SiLU-DW5x5-BN-SiLU
segment goes through the fused kernel `ops/depthwise.depthwise_silu_segment`
(K1), whose affines fold the running statistics; in training it is computed
from PyTorch ops with batch statistics, off the kernel, as the JAX package's
`conv` mode trains.
The normalizing-flow cells (`make_ar_mask`, `MaskedConv2d`, `NFCell`,
`NFBlock`) are plain PyTorch: the purify path applies them to each latent
after its mix when the configuration sets `num_nf_cells`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gen_adversarial_tpu_torch.models.batchnorm import BatchNorm2d
from gen_adversarial_tpu_torch.ops.depthwise import depthwise_silu_segment
from gen_adversarial_tpu_torch.ops.image import upsample_bilinear2x


def _bn(ch: int, device) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=1e-5, momentum=0.05, device=device)


_BN_TENSORS = ("weight", "bias", "running_mean", "running_var")


def bn_affine(bn: nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BatchNorm as a per-channel affine: s = gamma/sqrt(var+eps),
    b = beta - mean*s."""
    s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return s, bn.bias - bn.running_mean * s


class Conv1x1(nn.Conv2d):
    """1x1 convolution, optionally strided (a strided 1x1 conv is the
    JAX package's subsample-then-project)."""

    def __init__(self, in_ch: int, out_ch: int, use_bias: bool = True,
                 stride: int = 1, device=None):
        super().__init__(in_ch, out_ch, 1, stride=stride, bias=use_bias, device=device)


class SE(nn.Module):
    """Squeeze-and-excitation gate."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        hidden = max(channels // 16, 4)
        self.linear_1 = nn.Linear(channels, hidden, device=device)
        self.linear_2 = nn.Linear(hidden, channels, device=device)

    def forward(self, x):
        se = x.mean(dim=(2, 3))
        se = torch.sigmoid(self.linear_2(F.relu(self.linear_1(se))))
        return x * se[:, :, None, None]


class SkipDown(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int, device=None):
        super().__init__()
        self.conv = Conv1x1(in_ch, out_ch, stride=stride, device=device)

    def forward(self, x):
        return self.conv(F.silu(x))


class SkipUp(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.conv = Conv1x1(in_ch, out_ch, device=device)

    def forward(self, x):
        return self.conv(upsample_bilinear2x(x))


class ResidualCellEncoder(nn.Module):
    """(BN-SiLU-conv3x3) x2 + SE, with a 0.1-scaled residual."""

    def __init__(self, in_ch: int, out_ch: int, downsampling: bool, use_se: bool,
                 device=None):
        super().__init__()
        stride = 2 if downsampling else 1
        self.bn0 = _bn(in_ch, device)
        self.conv0 = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, device=device)
        self.bn1 = _bn(out_ch, device)
        self.conv1 = nn.Conv2d(out_ch, out_ch, 3, padding=1, device=device)
        self.se = SE(out_ch, device) if use_se else None
        self.skip = SkipDown(in_ch, out_ch, stride, device) if downsampling else None

    def forward(self, x):
        r = self.conv0(F.silu(self.bn0(x)))
        r = self.conv1(F.silu(self.bn1(r)))
        if self.se is not None:
            r = self.se(r)
        skip = self.skip(x) if self.skip is not None else x
        return skip + 0.1 * r


class ResidualCellDecoder(nn.Module):
    """MBConv-style cell: BN -> 1x1 expand -> BN-SiLU-DW5x5-BN-SiLU segment
    -> 1x1 project -> BN -> SE, optional nearest x2 upsampling, 0.1-scaled
    residual. The segment is K1 in eval mode and plain PyTorch with batch
    statistics in training."""

    def __init__(self, in_ch: int, out_ch: int, upsampling: bool, use_se: bool,
                 hidden_mul: int = 6, device=None):
        super().__init__()
        hidden = in_ch * hidden_mul
        self.upsampling = upsampling
        self.bn0 = _bn(in_ch, device)
        self.conv_expand = Conv1x1(in_ch, hidden, use_bias=False, device=device)
        self.bn1 = _bn(hidden, device)
        # holds the depthwise taps as (C, 1, 5, 5); the segment applies them
        self.conv_depthwise = nn.Conv2d(hidden, hidden, 5, padding=2, groups=hidden,
                                        bias=False, device=device)
        self.bn2 = _bn(hidden, device)
        self.conv_project = Conv1x1(hidden, out_ch, use_bias=False, device=device)
        self.bn3 = _bn(out_ch, device)
        self.se = SE(out_ch, device) if use_se else None
        self.skip = SkipUp(in_ch, out_ch, device) if upsampling else None
        self._segment_cache = None  # see segment_args

    def _segment_sources(self):
        return (self.conv_depthwise.weight, *(getattr(bn, name) for bn in (self.bn1, self.bn2)
                                              for name in _BN_TENSORS))

    def segment_args(self):
        """(taps (5,5,C), s1, b1, s2, b2) for `depthwise_silu_segment`, in
        float32 (the kernel's weights): the affines are taken in the
        weights' dtype, then widened, as the wrapper would. Made once and
        reused while every source tensor is the same object with the same
        version and storage, so an in-place change
        (`copy_`, `load_state_dict`, `from_jax_variables`), `.to()` or
        `defense_astype` makes them anew: a decode launches the kernel
        with no small casts around it. Not cached where they are
        differentiated (a weight that requires grad, or a torch.func
        transform's tensor)."""
        sources = self._segment_sources()
        # a cast or a move gives a tensor new storage: its pointer changes
        key = tuple((t._version, t.data_ptr()) for t in sources)
        cached = self._segment_cache
        if cached is not None and cached[0] == key and all(
                a is b for a, b in zip(cached[1], sources)):
            return cached[2]
        w = self.conv_depthwise.weight
        taps = w.reshape(w.shape[0], 25).t().reshape(5, 5, w.shape[0])
        args = tuple(t.float().contiguous()
                     for t in (taps, *bn_affine(self.bn1), *bn_affine(self.bn2)))
        wrapped = torch._C._functorch.is_functorch_wrapped_tensor
        if not any(t.requires_grad or wrapped(t) for t in sources):
            self._segment_cache = (key, sources, args)
        return args

    def forward(self, x):
        r = x
        if self.upsampling:
            r = F.interpolate(r, scale_factor=2, mode="nearest")
        r = self.conv_expand(self.bn0(r))
        if self.training:
            r = F.silu(self.bn1(r))
            r = F.conv2d(r, self.conv_depthwise.weight, padding=2, groups=r.shape[1])
            r = F.silu(self.bn2(r))
        else:
            r = r.contiguous(memory_format=torch.channels_last)
            r = depthwise_silu_segment(r, *self.segment_args())
        r = self.bn3(self.conv_project(r))
        if self.se is not None:
            r = self.se(r)
        skip = self.skip(x) if self.skip is not None else x
        return skip + 0.1 * r


class EncCombinerCell(nn.Module):
    """x_enc + conv1x1(x_dec)."""

    def __init__(self, dec_ch: int, out_ch: int, device=None):
        super().__init__()
        self.conv = Conv1x1(dec_ch, out_ch, device=device)

    def forward(self, x_enc, x_dec):
        return x_enc + self.conv(x_dec)


class DecCombinerCell(nn.Module):
    """conv1x1(concat(x, z))."""

    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.conv = Conv1x1(in_ch, out_ch, device=device)

    def forward(self, x, z):
        return self.conv(torch.cat([x, z], dim=1))


def make_ar_mask(kh: int, kw: int, mirror: bool, zero_diag: bool) -> np.ndarray:
    """Autoregressive kernel mask, (kh, kw) float32: the flattened taps' first
    half kept, the centre tap INCLUDED exactly when zero_diag is True
    (`half = (kh*kw)//2 + int(zero_diag)`, the reference's own quirk, which
    every flow-equipped checkpoint depends on), optionally mirrored."""
    mask = np.ones((kh * kw,), np.float32)
    half = (kh * kw) // 2 + int(zero_diag)
    mask[half:] = 0
    if mirror:
        mask = mask[::-1].copy()
    return mask.reshape(kh, kw)


class MaskedConv2d(nn.Conv2d):
    """k x k convolution (padding k // 2) whose kernel is multiplied by the
    autoregressive mask at every call, as in the JAX package, so a converted
    kernel with non-zero masked taps still gives its result. `groups` =
    channels is the flow cell's depthwise conv1."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, mirror: bool,
                 zero_diag: bool, groups: int = 1, device=None):
        super().__init__(in_ch, out_ch, kernel_size, padding=kernel_size // 2,
                         groups=groups, device=device)
        self.mask_np = make_ar_mask(kernel_size, kernel_size, mirror, zero_diag)
        self._masks: dict = {}  # the mask as a tensor, by (device, dtype)

    def forward(self, x):
        w = self.weight
        mask = self._masks.get((w.device, w.dtype))
        if mask is None:
            mask = torch.tensor(self.mask_np, dtype=w.dtype, device=w.device)
            self._masks[(w.device, w.dtype)] = mask
        return F.conv2d(x, w * mask, self.bias, padding=self.padding, groups=self.groups)


class NFCell(nn.Module):
    """z - (masked conv3x3 -> ELU -> masked depthwise 5x5 -> ELU -> masked
    conv1x1)(z)."""

    def __init__(self, num_z: int, mirror: bool, device=None):
        super().__init__()
        hidden = num_z * 6
        self.conv0 = MaskedConv2d(num_z, hidden, 3, mirror, zero_diag=True, device=device)
        self.conv1 = MaskedConv2d(hidden, hidden, 5, mirror, zero_diag=False,
                                  groups=hidden, device=device)
        self.conv2 = MaskedConv2d(hidden, num_z, 1, mirror, zero_diag=False, device=device)

    def forward(self, z):
        h = F.elu(self.conv0(z))
        h = F.elu(self.conv1(h))
        return z - self.conv2(h)


class NFBlock(nn.Module):
    """Two flow cells: `cell1` not mirrored, then `cell2` mirrored."""

    def __init__(self, num_z: int, device=None):
        super().__init__()
        self.cell1 = NFCell(num_z, mirror=False, device=device)
        self.cell2 = NFCell(num_z, mirror=True, device=device)

    def forward(self, z):
        return self.cell2(self.cell1(z))
