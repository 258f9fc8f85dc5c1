"""upfirdn2d: upsample -> FIR filter -> downsample, in plain PyTorch on NCHW
tensors (counterpart of gen_adversarial_tpu/ops/upfirdn2d.py).

Same semantics as the JAX function: `pad` is (pad0, pad1) on both spatial
axes, the output size is (in * up + pad0 + pad1 - taps) // down + 1, and the
filter is a true convolution (taps flipped). A 1-D kernel is the separable
factor, used as it is on each axis in two passes (height, then width); a 2-D
kernel runs as one depthwise convolution. Zero insertion puts up - 1 zeros
after each element, as lhs dilation plus the extra up - 1 trailing pad does in
the JAX version. Negative pads crop.

The hot blur sites (up = down = 1) of the StyleGAN2 generator go through the
K2 kernel (ops/upfirdn.py), whose plain version is this function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def make_fir_kernel(k) -> torch.Tensor:
    """Normalized 2-D FIR kernel from a 1-D or 2-D tap list: a 1-D list
    becomes its outer product; the kernel sums to 1."""
    k = torch.as_tensor(k, dtype=torch.float32)
    if k.dim() == 1:
        k = torch.outer(k, k)
    return k / k.sum()


def _zero_insert(x: torch.Tensor, up: int, dims: tuple) -> torch.Tensor:
    """up - 1 zeros after each element along each of `dims` (2 and/or 3)."""
    if up == 1:
        return x
    shape = list(x.shape)
    for d in dims:
        shape[d] *= up
    out = x.new_zeros(shape)
    index = [slice(None)] * 4
    for d in dims:
        index[d] = slice(None, None, up)
    out[tuple(index)] = x
    return out


def _upfirdn1d(x, kernel1d, up, down, pad0, pad1, dim):
    """up/FIR/down along one spatial dim (2: height, 3: width) of NCHW x."""
    c = x.shape[1]
    k = torch.flip(kernel1d, (0,)).to(x.dtype)
    x = _zero_insert(x, up, (dim,))
    if dim == 2:
        x = F.pad(x, (0, 0, pad0, pad1))
        w, stride = k.view(1, 1, -1, 1), (down, 1)
    else:
        x = F.pad(x, (pad0, pad1, 0, 0))
        w, stride = k.view(1, 1, 1, -1), (1, down)
    return F.conv2d(x, w.expand(c, 1, *w.shape[2:]), stride=stride, groups=c)


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: tuple = (0, 0)) -> torch.Tensor:
    """upfirdn2d on (B, C, H, W) images; `kernel` is the 1-D separable factor
    or a 2-D kernel (see the module docstring)."""
    pad0, pad1 = pad
    kernel = torch.as_tensor(kernel, dtype=torch.float32, device=x.device)
    if kernel.dim() == 1:
        x = _upfirdn1d(x, kernel, up, down, pad0, pad1, dim=2)
        return _upfirdn1d(x, kernel, up, down, pad0, pad1, dim=3)
    c = x.shape[1]
    k = torch.flip(kernel, (0, 1)).to(x.dtype)
    x = _zero_insert(x, up, (2, 3))
    x = F.pad(x, (pad0, pad1, pad0, pad1))
    return F.conv2d(x, k.expand(c, 1, *k.shape), stride=down, groups=c)
