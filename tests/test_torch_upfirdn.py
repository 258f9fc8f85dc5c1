"""The port's upfirdn2d and the K2 blur wrapper (ops/upfirdn.py) against the
JAX package on the CPU: the blur's plain version against the TPU kernel's
own semantics (`pallas_blur` in interpret mode, run as
tests/test_pallas_upfirdn.py runs it) and against JAX `upfirdn2d`; its
x-gradient through the port's autograd path against `jax.grad` of
`pallas_blur_diff`; the autograd Function under torch.func (grad against
jax.grad, vjp + vmap over cotangents and vmap of the forward against a
loop); and upfirdn2d with up/down sampling. Asymmetric taps are
used beside the binomial ones, whose symmetry would hide a missing flip.
Inputs come from a numpy seed; the port is NCHW, JAX NHWC.

Tolerance: 1e-6 absolute and relative, as in the JAX test: at most 16
float32 products of O(1) values, summed in the same order."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import grad, vjp, vmap

from gen_adversarial_tpu.ops.pallas_upfirdn import pallas_blur, pallas_blur_diff
from gen_adversarial_tpu.ops.upfirdn2d import make_fir_kernel as jax_make_fir_kernel
from gen_adversarial_tpu.ops.upfirdn2d import upfirdn2d as jax_upfirdn2d
from gen_adversarial_tpu_torch.ops import upfirdn as k2
from gen_adversarial_tpu_torch.ops.upfirdn2d import make_fir_kernel, upfirdn2d
from tests.torch_port_helpers import rel_l2, to_nchw, to_nhwc

TOL = dict(rtol=1e-6, atol=1e-6)
BINOMIAL4 = np.array([1.0, 3.0, 3.0, 1.0]) / 8.0
ASYM4 = np.array([1.0, 2.0, 3.0, 4.0]) / 10.0
BINOMIAL3 = np.array([1.0, 2.0, 1.0]) / 4.0
ASYM3 = np.array([1.0, 2.0, 4.0]) / 7.0


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape,taps,pad", [
    ((2, 9, 9, 32), BINOMIAL4, (1, 1)),    # the generator's up-conv blur
    ((2, 9, 9, 32), ASYM4, (1, 1)),
    ((1, 13, 7, 96), ASYM4, (2, 1)),       # ragged H != W, C not a lane multiple
    ((1, 12, 10, 3), BINOMIAL4, (2, 2)),   # RGB width
    ((2, 11, 6, 32), ASYM3, (2, 2)),
    ((1, 8, 8, 3), BINOMIAL3, (1, 1)),
    ((1, 7, 9, 96), ASYM3, (2, 1)),
    ((2, 16, 16, 64), BINOMIAL4, (2, 2)),  # the discriminator's blur before a stride-2 conv
    ((2, 16, 16, 64), BINOMIAL4, (1, 1)),  # and on its skip path
    ((1, 12, 15, 64), ASYM4, (-1, 2)),     # a negative pad crops
])
def test_blur_plain_matches_pallas_and_upfirdn2d(shape, taps, pad):
    x = _x(shape)
    k = jnp.asarray(taps.astype(np.float32))
    # the TPU kernel pads and does not crop: a negative pad is a crop of x
    lo, hi = max(0, -pad[0]), max(0, -pad[1])
    cropped = x[:, lo:shape[1] - hi, lo:shape[2] - hi]
    want_pallas = pallas_blur(jnp.asarray(cropped), k, pad=(max(0, pad[0]), max(0, pad[1])),
                              interpret=True)
    want_xla = jax_upfirdn2d(jnp.asarray(x), k, up=1, down=1, pad=pad)
    tx = to_nchw(x)
    before = k2.launches
    got = k2.upfirdn_blur(tx, taps.astype(np.float32), pad)
    assert k2.launches == before  # a CPU tensor takes the plain version
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want_pallas), **TOL)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want_xla), **TOL)
    np.testing.assert_array_equal(to_nhwc(got), to_nhwc(k2.blur_plain(tx, taps, pad)))


@pytest.mark.parametrize("taps,pad", [(ASYM4, (1, 1)), (ASYM4, (2, 1)), (BINOMIAL4, (2, 2)),
                                      (ASYM3, (1, 1))])
def test_blur_x_gradient_matches_pallas_blur_diff(taps, pad):
    """d/dx sum(sin(blur(x))): the port's autograd backward (the transposed
    blur) against jax.grad through the Pallas kernel's custom VJP."""
    x = _x((2, 10, 7, 8), seed=2)
    k = jnp.asarray(taps.astype(np.float32))
    want = jax.grad(lambda v: jnp.sum(jnp.sin(pallas_blur_diff(v, k, pad, True))))(
        jnp.asarray(x))
    tx = to_nchw(x).requires_grad_()
    torch.sin(k2.upfirdn_blur(tx, taps.astype(np.float32), pad)).sum().backward()
    np.testing.assert_allclose(to_nhwc(tx.grad), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("taps,pad", [(ASYM4, (2, 1)), (ASYM3, (1, 1))])
def test_func_grad_matches_pallas_blur_diff(taps, pad):
    """torch.func.grad (the Function's setup_context and its backward, which
    calls the Function again) against jax.grad through the custom VJP."""
    x = _x((2, 10, 7, 8), seed=4)
    k = jnp.asarray(taps.astype(np.float32))
    want = jax.grad(lambda v: jnp.sum(jnp.sin(pallas_blur_diff(v, k, pad, True))))(
        jnp.asarray(x))
    got = grad(lambda v: torch.sin(k2.upfirdn_blur(v, taps.astype(np.float32), pad)).sum())(
        to_nchw(x))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("transform", ["vjp_vmap", "vmap_forward"])
def test_func_vmap_matches_a_loop(transform):
    """vmap of the vjp over K = 3 cotangents (the batched cotangent goes
    through the vmap rule, folded into N) and vmap of the forward over a
    batched x, against a loop of single calls."""
    taps, pad = ASYM4.astype(np.float32), (2, 1)
    rng = np.random.RandomState(5)
    x = to_nchw(_x((2, 9, 6, 8), seed=5))

    def fn(v):
        return k2.upfirdn_blur(v, taps, pad)

    if transform == "vjp_vmap":
        y, vjp_fn = vjp(fn, x)
        batch = torch.tensor(rng.randn(3, *y.shape).astype(np.float32))
        got = vmap(vjp_fn)(batch)[0]
        want = torch.stack([vjp_fn(g)[0] for g in batch])
    else:
        batch = torch.tensor(rng.randn(3, *x.shape).astype(np.float32))
        got = vmap(fn)(batch)
        want = torch.stack([fn(v) for v in batch])
    torch.testing.assert_close(got, want, **TOL)


# bfloat16: asymmetric taps that bfloat16 holds exactly (the Pallas kernel
# casts its taps to the image's dtype, the port keeps them float32)
ASYM4_BF16 = np.array([1.0, 2.0, 3.0, 2.0]) / 8.0
ASYM3_BF16 = np.array([1.0, 3.0, 4.0]) / 8.0
# the port against Pallas in bfloat16: torch's bfloat16 rtol of
# assert_close, 2 to 4 bfloat16 ulps
BF16_RTOL = 1.6e-2


@pytest.mark.parametrize("taps,pad", [(ASYM4_BF16, (1, 1)), (ASYM4_BF16, (2, 1)),
                                      (ASYM3_BF16, (2, 2))])
def test_bf16_blur_and_x_gradient_against_pallas_interpret(taps, pad):
    """The blur and its x-gradient on bfloat16 inputs: the port's plain
    version (float32 sums, y rounded once) and `pallas_blur` /
    `pallas_blur_diff` in interpret mode (bfloat16 scratch: every
    multiply-add rounds), each against the float32 result on the same
    bfloat16-rounded inputs. The port is at most as far from it as Pallas
    is, and within BF16_RTOL of Pallas (relative L2)."""
    x16 = jnp.asarray(_x((2, 10, 7, 8), seed=6), jnp.bfloat16)
    x = np.asarray(x16.astype(jnp.float32))
    k = jnp.asarray(taps.astype(np.float32))
    h, w = (k2.out_size(n, len(taps), pad) for n in (10, 7))
    g16 = jnp.asarray(_x((2, h, w, 8), seed=7), jnp.bfloat16)
    g = np.asarray(g16.astype(jnp.float32))
    ref, ref_vjp = jax.vjp(lambda v: pallas_blur_diff(v, k, pad, True), jnp.asarray(x))
    ref_dx = ref_vjp(jnp.asarray(g))[0]
    out16, vjp16 = jax.vjp(lambda v: pallas_blur_diff(v, k.astype(jnp.bfloat16), pad, True),
                           x16)
    (dx16,) = vjp16(g16)
    assert out16.dtype == dx16.dtype == jnp.bfloat16
    tx = to_nchw(x).to(torch.bfloat16).requires_grad_()
    got = k2.upfirdn_blur(tx, taps.astype(np.float32), pad)
    (got_dx,) = torch.autograd.grad(got, tx, to_nchw(g).to(torch.bfloat16))
    assert got.dtype == got_dx.dtype == torch.bfloat16
    for port, pallas, want in ((got, out16, ref), (got_dx, dx16, ref_dx)):
        port = to_nhwc(port.float())
        pallas, want = np.asarray(pallas.astype(jnp.float32)), np.asarray(want)
        assert rel_l2(port, want) <= rel_l2(pallas, want)
        assert rel_l2(port, pallas) <= BF16_RTOL


@pytest.mark.parametrize("up,down,pad,kernel_2d", [
    (2, 1, (2, 1), False),   # ToRGB's skip upsample
    (2, 1, (2, 1), True),
    (1, 2, (1, 1), False),   # the downsample blur
    (1, 2, (1, 1), True),
    (2, 2, (0, -1), False),  # a negative pad crops
])
def test_upfirdn2d_matches_jax(up, down, pad, kernel_2d):
    x = _x((2, 7, 9, 5), seed=3)
    taps = ASYM4.astype(np.float32)
    kernel = np.outer(taps, BINOMIAL4).astype(np.float32) if kernel_2d else taps
    want = jax_upfirdn2d(jnp.asarray(x), jnp.asarray(kernel), up=up, down=down, pad=pad)
    got = upfirdn2d(to_nchw(x), torch.tensor(kernel), up=up, down=down, pad=pad)
    assert to_nhwc(got).shape == want.shape
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **TOL)


def test_make_fir_kernel_matches_jax():
    for k in ([1, 3, 3, 1], [1, 2, 3, 4], [[1, 2], [3, 4]]):
        np.testing.assert_allclose(make_fir_kernel(k).numpy(),
                                   np.asarray(jax_make_fir_kernel(k)), **TOL)


def test_blur_wrapper_rejects_empty_output():
    with pytest.raises(ValueError, match="no output"):
        k2.upfirdn_blur(torch.zeros(1, 2, 2, 2), BINOMIAL4, (0, 0))


def test_blur_goes_through_the_function_only_when_autograd_records():
    """A call that autograd records takes the Function (its backward is the
    transposed blur); one it does not record (under no_grad, or an x that
    wants no gradient) skips it and returns the same values with no graph."""
    x = to_nchw(_x((1, 9, 9, 8), seed=6))
    taps, pad = ASYM4.astype(np.float32), (2, 1)
    xr = x.clone().requires_grad_()
    recorded = k2.upfirdn_blur(xr, taps, pad)
    assert type(recorded.grad_fn).__name__ == "_BlurBackward"
    with torch.no_grad():
        under_no_grad = k2.upfirdn_blur(xr, taps, pad)
    unrecorded = k2.upfirdn_blur(x, taps, pad)
    for y in (under_no_grad, unrecorded):
        assert y.grad_fn is None and not y.requires_grad
        assert torch.equal(y, recorded.detach())
