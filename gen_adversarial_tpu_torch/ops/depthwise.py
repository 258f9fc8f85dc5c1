"""The NVAE decoder cell's fused segment,
    y = silu(DW5x5(silu(x * s0 + b0)) * s1 + b1),
as a hand-written CUDA kernel for Hopper (`csrc/depthwise_segment.cu`).

Replaces the Pallas TPU kernel of gen_adversarial_tpu/ops/pallas_depthwise.py
(`depthwise_silu_segment`, body `_kernel`). Its one job is to keep the
intermediate silu(x*s0+b0) out of device memory: per element one read of x
and one write of y. What bounds it on an H100 is instruction issue before
memory, so the kernel stages a tile and its 2-pixel halo by TMA (no copy
addresses or bounds checks in any thread), uses a five-instruction SiLU, and
takes 16x16 tiles (the whole 8x8 map at H = 8) to cut the halo's repeated
first SiLUs (see the source's header).

`x` is an NCHW tensor in `torch.channels_last` memory format (the kernel
reads it as NHWC), float32 or bfloat16 (the model's dtype, which y keeps),
with C a multiple of 4 in float32 and of 8 in bfloat16 on a CUDA tensor (the
TMA's row pitch of 16 bytes); `taps` is (5, 5, C) in the XLA correlation
convention (no flip), like the JAX function; the four affines are (C,). The
taps and affines may come in either dtype: the wrapper casts them to
float32, as the Pallas kernel does at load, and the segment computes in
float32 inside and rounds y once.

On a CUDA tensor `depthwise_silu_segment` launches the kernel of x's dtype
(`gat_depthwise_segment_f32` or `_bf16`) or raises; a CPU tensor takes
`depthwise_silu_segment_plain`. No dtype is widened to reach another
kernel. The gradient is a `torch.autograd.Function` that works under
torch.func (grad, vjp, vmap): its backward mirrors the JAX custom VJP
`_seg_bwd` in plain PyTorch ops in x's dtype, as the JAX backward is plain
XLA in the model's dtype, and computes only the cotangents asked for;
its vmap rule folds a vmapped x into N (one launch), as a JAX batching rule
would.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

TAPS = 5
PAD = 2
SOURCE = "depthwise_segment"

# the kernel's C entry point and its channel multiple (a 16-byte TMA row
# pitch) for each dtype it takes
ENTRY = {torch.float32: ("gat_depthwise_segment_f32", 4),
         torch.bfloat16: ("gat_depthwise_segment_bf16", 8)}

# kernel launches since the last reset, by the dtype of x (one build of the
# kernel each); the plain version never counts. `launches` is their sum.
launches_by_dtype = dict.fromkeys(ENTRY, 0)


def reset_launches() -> None:
    launches_by_dtype.update(dict.fromkeys(ENTRY, 0))


def __getattr__(name: str):
    if name == "launches":
        return sum(launches_by_dtype.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def taps_oihw(taps: torch.Tensor) -> torch.Tensor:
    """(5, 5, C) correlation taps -> F.conv2d's depthwise (C, 1, 5, 5)."""
    return taps.permute(2, 0, 1).unsqueeze(1)


def _affine(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def depthwise_silu_segment_plain(x, taps, s0, b0, s1, b1):
    """The segment in plain PyTorch: silu, depthwise conv (padding 2), silu,
    in float32 (a bfloat16 x is widened and y rounded once, at the end, as
    in the Pallas kernel); y in x's dtype."""
    taps, s0, b0, s1, b1 = (t.float() for t in (taps, s0, b0, s1, b1))
    r = F.silu(x.float() * _affine(s0) + _affine(b0))
    r = F.conv2d(r, taps_oihw(taps), padding=PAD, groups=x.shape[1])
    return F.silu(r * _affine(s1) + _affine(b1)).to(x.dtype)


_lib_handle = None


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signatures of a built `csrc/depthwise_segment.cu` (or
    of another version of it, as an A/B builds) on `lib`; returns `lib`."""
    for name, _ in ENTRY.values():
        if hasattr(lib, name):  # an earlier source (an A/B) has float32 only
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    lib.gat_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gat_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lib():
    """The built library with its C signatures declared (built at first use)."""
    global _lib_handle
    if _lib_handle is None:
        from gen_adversarial_tpu_torch.core.cuda_build import load
        _lib_handle = declare(load(SOURCE)[SOURCE].lib)
    return _lib_handle


def _check(x, taps, s0, b0, s1, b1):
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got shape {tuple(x.shape)}")
    c = x.shape[1]
    if tuple(taps.shape) != (TAPS, TAPS, c):
        raise ValueError(f"taps must be ({TAPS}, {TAPS}, {c}), got {tuple(taps.shape)}")
    for name, v in (("s0", s0), ("b0", b0), ("s1", s1), ("b1", b1)):
        if tuple(v.shape) != (c,):
            raise ValueError(f"{name} must be ({c},), got {tuple(v.shape)}")
    tensors = (x, taps, s0, b0, s1, b1)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all arguments must be on one device")
    if any(t.dtype not in ENTRY for t in tensors):
        raise TypeError("the segment takes float32 or bfloat16 tensors, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")


def _launch(x, taps, s0, b0, s1, b1, lib=None):
    # layout checks here, on the tensors the kernel gets: under torch.func.vmap
    # the public function sees batched tensors, whose layout cannot be asked.
    # `lib`: another build of the kernel (`declare`d), as an A/B launches it
    n, c, h, w = x.shape
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be contiguous in torch.channels_last format")
    if not all(t.is_contiguous() for t in (taps, s0, b0, s1, b1)):
        raise ValueError("taps and affines must be contiguous")
    if x.dtype not in ENTRY or any(t.dtype != torch.float32 for t in (taps, s0, b0, s1, b1)):
        raise TypeError("the kernel takes a float32 or bfloat16 x and float32 taps and affines")
    entry, width = ENTRY[x.dtype]
    if c % width or x.data_ptr() % 16:
        raise ValueError(f"the kernel's TMA staging needs C a multiple of {width} in {x.dtype} "
                         f"and x 16-byte aligned, got C={c}")
    if n > 65535:
        raise ValueError(f"batch {n} exceeds the kernel's grid limit 65535")
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if x.numel() == 0:
        return y
    if lib is None:
        lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, entry)(
        x.data_ptr(), taps.data_ptr(), s0.data_ptr(), b0.data_ptr(),
        s1.data_ptr(), b1.data_ptr(), y.data_ptr(), n, h, w, c,
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        stream)
    if rc != 0:
        raise RuntimeError("depthwise_segment kernel launch failed: "
                           + lib.gat_cuda_error_string(rc).decode())
    launches_by_dtype[x.dtype] += 1
    return y


def _dsilu(a):
    s = torch.sigmoid(a)
    return s * (1 + a * (1 - s))


class _Segment(torch.autograd.Function):
    """The segment with the JAX VJP `_seg_bwd` as its backward; usable under
    torch.func (grad, vjp, vmap)."""

    @staticmethod
    def forward(x, taps, s0, b0, s1, b1):
        if x.is_cuda:
            return _launch(x, taps, s0, b0, s1, b1)
        return depthwise_silu_segment_plain(x, taps, s0, b0, s1, b1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        # recompute, as the JAX VJP `_seg_bwd` does, in x's dtype (the float32
        # weights narrowed to it: the JAX backward runs in the model's dtype);
        # only the cotangents asked for (an attack freezes the weights and
        # pulls dx alone), each in its input's dtype
        x, *weights = ctx.saved_tensors
        taps, s0, b0, s1, b1 = (t.to(x.dtype) for t in weights)
        need_x, need_taps, need_s0, need_b0, need_s1, need_b1 = ctx.needs_input_grad
        c = x.shape[1]
        wk = taps_oihw(taps)
        a0 = x * _affine(s0) + _affine(b0)
        xa = F.silu(a0)
        acc = F.conv2d(xa, wk, padding=PAD, groups=c)
        gi = g * _dsilu(acc * _affine(s1) + _affine(b1))
        dims = (0, 2, 3)
        dx = dtaps = ds0 = db0 = None
        ds1 = (gi * acc).sum(dims) if need_s1 else None
        db1 = gi.sum(dims) if need_b1 else None
        if need_x or need_taps or need_s0 or need_b0:
            dacc = gi * _affine(s1)
        if need_x or need_s0 or need_b0:
            # the transpose of a correlation: the same depthwise, flipped taps
            dxa = F.conv2d(dacc, wk.flip(2, 3), padding=PAD, groups=c)
            gx0 = dxa * _dsilu(a0)
            dx = gx0 * _affine(s0) if need_x else None
            ds0 = (gx0 * x).sum(dims) if need_s0 else None
            db0 = gx0.sum(dims) if need_b0 else None
        if need_taps:
            # d taps[dy, dx, c] = sum over n, h, w of xa_pad[h+dy, w+dx] * dacc[h, w]
            xap = F.pad(xa, (PAD, PAD, PAD, PAD))
            h, w = x.shape[2], x.shape[3]
            dtaps = torch.stack([
                torch.stack([(xap[:, :, i:i + h, j:j + w] * dacc).sum(dims)
                             for j in range(TAPS)])
                for i in range(TAPS)])
        return (dx, *(None if d is None else d.to(w.dtype)
                      for d, w in zip((dtaps, ds0, db0, ds1, db1), weights)))

    @staticmethod
    def vmap(info, in_dims, x, taps, s0, b0, s1, b1):
        # the counterpart of a JAX batching rule: a vmapped x alone folds
        # into N (one launch); vmapped weights loop over the vmapped dim
        x_dim, *w_dims = in_dims
        if all(d is None for d in w_dims):
            xb = x.movedim(x_dim, 0)
            folded = xb.flatten(0, 1).contiguous(memory_format=torch.channels_last)
            y = _Segment.apply(folded, taps, s0, b0, s1, b1)
            return y.unflatten(0, xb.shape[:2]), 0
        args = (x, taps, s0, b0, s1, b1)
        outs = []
        for i in range(info.batch_size):
            xi, *wi = [a if d is None else a.select(d, i) for a, d in zip(args, in_dims)]
            outs.append(_Segment.apply(xi.contiguous(memory_format=torch.channels_last),
                                       *(w.contiguous() for w in wi)))
        return torch.stack(outs), 0


def depthwise_silu_segment(x, taps, s0, b0, s1, b1):
    """silu(DW5x5(silu(x*s0+b0)) * s1 + b1) in one pass; differentiable.

    x: (N, C, H, W), float32 or bfloat16, channels_last on CUDA; taps
    (5, 5, C); affines (C,), cast to float32 here (the decoder cells hand
    them over as float32 already). A CUDA tensor launches the kernel of x's
    dtype (or raises); a CPU tensor runs the plain version. Where nothing is
    differentiated (no tensor requires grad under grad mode, no torch.func
    transform) a CUDA call launches without the autograd Function's host
    cost, tens of µs a launch on a path the host sets the pace of."""
    _check(x, taps, s0, b0, s1, b1)
    args = (x, *(t if t.dtype == torch.float32 else t.float() for t in (taps, s0, b0, s1, b1)))
    if x.is_cuda and not torch._C._are_functorch_transforms_active() and not (
            torch.is_grad_enabled() and any(t.requires_grad for t in args)):
        return _launch(*args)
    return _Segment.apply(*args)
