"""The StyleGAN2 separable FIR blur, upfirdn2d(x, taps, up=1, down=1, pad),
as a hand-written CUDA kernel for Hopper (`csrc/upfirdn_blur.cu`, K2).

Replaces the Pallas TPU kernel of gen_adversarial_tpu/ops/pallas_upfirdn.py
(`pallas_blur` / `pallas_blur_diff`, body `_blur_kernel`). What bounds it on
an H100 is memory: per element about one read of x and one write of y
(8 bytes in float32, 4 in bfloat16) against 2 * taps multiply-adds. The
kernel reads x once with its halo, zero-padding at the edges as it loads (no
padded copy of x), runs the vertical then the horizontal pass on chip, and
writes y once. Both builds move 16 bytes a lane in every load and store,
four channels in float32 and eight in bfloat16; a width that is not a
multiple of 4 (float32) or 8 (bfloat16), or an x or y that is not 16-byte
aligned, takes a masked path of the same sums (see the source's header).

`x` is an NCHW tensor in `torch.channels_last` memory format (the kernel
reads it as NHWC), float32 or bfloat16 (the model's dtype, which y keeps;
the sums are float32 in both, and a bfloat16 y is rounded once, as it is
stored, by the kernel and by the plain version alike). `taps` are the 1-D
separable factor as host numbers (Python floats or a numpy array), in
upfirdn order: the kernel flips them, as the JAX function does. `pad` is
(pad0, pad1) on both spatial axes.

On a CUDA tensor `upfirdn_blur` launches the kernel of x's dtype
(`gat_upfirdn_blur_f32` or `_bf16`) or raises; a CPU tensor takes
`blur_plain`. The gradient (`torch.autograd.Function`) is the JAX custom
VJP `_blur_bwd`: the same blur of the cotangent with the taps flipped and
pad (taps - 1 - pad0, taps - 1 - pad1), through the same kernel. The taps
are fixed constants and get no cotangent. The Function works under
torch.func (grad, vjp, vmap); its vmap rule folds the vmapped dim into N, as
`pallas_blur`'s custom_vmap rule does, so vmap over a vjp (an attack's class
gradients) reaches the kernel as one launch. A call that autograd does not
record (no gradient wanted, no torch.func transform) skips the Function,
whose `apply` costs more host time than a small site's kernel takes on the
card.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from gen_adversarial_tpu_torch.ops.upfirdn2d import upfirdn2d

SOURCE = "upfirdn_blur"
KERNEL_TAPS = (3, 4)  # the taps counts the kernel is instantiated for
# the kernel's C entry point for each dtype it takes
ENTRY = {torch.float32: "gat_upfirdn_blur_f32", torch.bfloat16: "gat_upfirdn_blur_bf16"}

# kernel launches since the last reset, by the dtype of x (one build of the
# kernel each); the plain version never counts. `launches` is their sum.
launches_by_dtype = dict.fromkeys(ENTRY, 0)


def reset_launches() -> None:
    launches_by_dtype.update(dict.fromkeys(ENTRY, 0))


def __getattr__(name: str):
    if name == "launches":
        return sum(launches_by_dtype.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def out_size(size: int, taps: int, pad: Sequence[int]) -> int:
    return size + pad[0] + pad[1] - taps + 1


def blur_plain(x: torch.Tensor, taps, pad: Sequence[int]) -> torch.Tensor:
    """The blur in plain PyTorch: two 1-D depthwise convolutions with flipped
    taps after zero padding (ops/upfirdn2d.upfirdn2d with a 1-D kernel), in
    float32 (a bfloat16 x is widened, and y rounded once at the end, as the
    kernel does); y in x's dtype."""
    k = torch.tensor([float(t) for t in taps], dtype=torch.float32, device=x.device)
    wide = x.float() if x.dtype == torch.bfloat16 else x
    return upfirdn2d(wide, k, up=1, down=1, pad=tuple(pad)).to(x.dtype)


_lib_handle = None


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signatures of a built `csrc/upfirdn_blur.cu` (or of
    another version of it, as an A/B builds) on `lib`; returns `lib`."""
    for name in ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
            + [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
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


def _check(x: torch.Tensor, taps: tuple, pad: Sequence[int]) -> tuple[int, int]:
    """The output's height and width; raises on what the blur does not take
    (on a CUDA tensor, on what the kernel does not take)."""
    shape = x.shape
    if len(shape) != 4:
        raise ValueError(f"x must be (N, C, H, W), got shape {tuple(shape)}")
    if len(pad) != 2:
        raise ValueError(f"pad must be (pad0, pad1), got {pad}")
    grow = pad[0] + pad[1] - len(taps) + 1  # out_size - size
    h_out, w_out = shape[2] + grow, shape[3] + grow
    if h_out <= 0 or w_out <= 0:
        raise ValueError(f"{len(taps)} taps with pad {tuple(pad)} leave no output "
                         f"of a {shape[2]}x{shape[3]} image")
    if x.is_cuda:
        if x.dtype not in ENTRY:
            raise TypeError(f"the blur kernel takes float32 or bfloat16 tensors, got {x.dtype}")
        if len(taps) not in KERNEL_TAPS:
            raise ValueError(f"the blur kernel takes {KERNEL_TAPS} taps, got {len(taps)}")
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("x must be contiguous in torch.channels_last format")
        if shape[0] > 65535:
            raise ValueError(f"batch {shape[0]} exceeds the kernel's grid limit 65535")
    return h_out, w_out


_host_taps: dict[tuple, ctypes.Array] = {}  # the taps as C floats, made once per value


def _launch(x: torch.Tensor, taps: tuple, pad: Sequence[int], lib=None) -> torch.Tensor:
    # `lib`: another build of the kernel (`declare`d), as an A/B launches it.
    # Every step here is host time a small site pays in full: y comes from
    # empty_strided (half the cost of empty with a memory_format) and the
    # stream from the raw query (a tenth of torch.cuda.current_stream's)
    h_out, w_out = _check(x, taps, pad)
    n, c, h, w = x.shape
    y = torch.empty_strided((n, c, h_out, w_out), (h_out * w_out * c, 1, w_out * c, c),
                            device=x.device, dtype=x.dtype)
    if n == 0 or c == 0:
        return y
    if lib is None:
        lib = _lib()
    host_taps = _host_taps.get(taps)
    if host_taps is None:
        host_taps = _host_taps[taps] = (ctypes.c_float * len(taps))(*taps)
    device = x.get_device()
    rc = getattr(lib, ENTRY[x.dtype])(
        x.data_ptr(), y.data_ptr(), n, h, w, c, pad[0], pad[1], host_taps, len(taps), device,
        torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError("upfirdn_blur kernel launch failed: "
                           + lib.gat_cuda_error_string(rc).decode())
    launches_by_dtype[x.dtype] += 1
    return y


def _forward(x: torch.Tensor, taps: tuple, pad: tuple, relayout: bool) -> torch.Tensor:
    if not x.is_cuda:
        _check(x, taps, pad)
        return blur_plain(x, taps, pad)
    if relayout:
        x = x.contiguous(memory_format=torch.channels_last)
    return _launch(x, taps, pad)


class _Blur(torch.autograd.Function):
    """The blur with the JAX VJP `_blur_bwd` as its backward; usable under
    torch.func (grad, vjp, vmap). `relayout` makes a CUDA input channels_last
    before the layout check: the backward's cotangent comes in whatever
    layout autograd gives it, and a folded vmap batch is a new tensor."""

    @staticmethod
    def forward(x, taps, pad, relayout):
        return _forward(x, taps, pad, relayout)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.taps, ctx.pad, _ = inputs

    @staticmethod
    def backward(ctx, g):
        # the transposed blur: flipped taps, pad (taps-1-pad0, taps-1-pad1),
        # through apply, so that a batched cotangent (vmap over a vjp) takes
        # the vmap rule below and reaches the kernel folded into N
        t = len(ctx.taps)
        gpad = (t - 1 - ctx.pad[0], t - 1 - ctx.pad[1])
        return _Blur.apply(g, ctx.taps[::-1], gpad, True), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, taps, pad, relayout):
        # the counterpart of `pallas_blur`'s custom_vmap rule: fold the
        # vmapped dim into N, one launch
        xb = x.movedim(in_dims[0], 0)
        y = _Blur.apply(xb.flatten(0, 1), taps, pad, True)
        return y.unflatten(0, xb.shape[:2]), 0


def upfirdn_blur(x: torch.Tensor, taps, pad: Sequence[int]) -> torch.Tensor:
    """upfirdn2d(x, taps, up=1, down=1, pad) in one pass; differentiable in x.

    x: (N, C, H, W), float32 or bfloat16, channels_last on CUDA. A CUDA
    tensor launches the kernel of its dtype (or raises); a CPU tensor runs the
    plain version."""
    taps, pad = tuple(map(float, taps)), tuple(map(int, pad))
    if (x.requires_grad and torch.is_grad_enabled()) or \
            torch._C._are_functorch_transforms_active():
        return _Blur.apply(x, taps, pad, False)
    # nothing records this call: skip the Function, whose apply alone costs
    # more host time than a small site's kernel takes on the card
    return _forward(x, taps, pad, False)
