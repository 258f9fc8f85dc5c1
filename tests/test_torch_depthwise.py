"""The port's fused decoder segment (gen_adversarial_tpu_torch/ops/depthwise.py)
against the JAX package's: the plain version and the autograd backward on
the CPU against `reference_segment` and the Pallas kernel in interpret mode
(forward, and all six cotangents against jax.vjp). The autograd Function
under torch.func (grad, vjp + vmap over cotangents, vmap of the forward
over x or over the taps) against jax.grad and a loop, and the x-only
backward that skips the weight cotangents. The CUDA kernel itself is
compared with the plain version on the card by tests/test_torch_gpu.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import grad, vjp, vmap

from gen_adversarial_tpu.ops.pallas_depthwise import (
    depthwise_silu_segment as jax_segment, reference_segment)
from gen_adversarial_tpu_torch.ops import depthwise as k1
from tests.torch_port_helpers import assert_within_bf16_gap

# float32 on both sides; the depthwise sums 25 products in another order
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
# cotangents reduce over N*H*W (up to 512 terms of O(10) values) in another
# order: relative 1e-5 of the largest term
BWD_TOL = dict(rtol=2e-5, atol=2e-4)


def _inputs(c, b=2, h=8, w=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    taps = (rng.randn(5, 5, c) * 0.2).astype(np.float32)
    aff = [(rng.randn(c) * 0.5 + 1.0).astype(np.float32) for _ in range(4)]
    return [x, taps, *aff]


def _torch_args(args, requires_grad=False):
    x = torch.tensor(args[0]).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    rest = [torch.tensor(a) for a in args[1:]]
    out = [x, *rest]
    for t in out:
        t.requires_grad_(requires_grad)
    return out


def _jax_fn(kind):
    if kind == "reference":
        return reference_segment
    return lambda *a: jax_segment(*a, True)  # Pallas kernel, interpret mode


@pytest.mark.parametrize("c,kind", [(96, "reference"), (128, "reference"),
                                    (128, "pallas_interpret")])
def test_forward_matches_jax(c, kind):
    args = _inputs(c, seed=c)
    want = np.asarray(_jax_fn(kind)(*map(jnp.asarray, args)))
    got = k1.depthwise_silu_segment(*_torch_args(args))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **FWD_TOL)
    plain = k1.depthwise_silu_segment_plain(*_torch_args(args))
    np.testing.assert_allclose(plain.permute(0, 2, 3, 1).numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("c,kind", [(96, "reference"), (128, "pallas_interpret")])
def test_six_cotangents_match_jax_vjp(c, kind):
    """dx, dtaps, ds0, db0, ds1, db1 of the autograd Function against
    jax.vjp (autodiff of the reference; the custom VJP of the kernel)."""
    args = _inputs(c, seed=10 + c)
    g = np.random.RandomState(99).randn(*args[0].shape).astype(np.float32)
    _, vjp = jax.vjp(_jax_fn(kind), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    targs = _torch_args(args, requires_grad=True)
    y = k1.depthwise_silu_segment(*targs)
    y.backward(torch.tensor(g).permute(0, 3, 1, 2))
    got = [targs[0].grad.permute(0, 2, 3, 1)] + [t.grad for t in targs[1:]]
    for name, w_, g_ in zip(("dx", "dtaps", "ds0", "db0", "ds1", "db1"), want, got):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), err_msg=name, **BWD_TOL)


def test_func_grad_matches_jax_grad():
    """torch.func.grad of sum(sin(segment(x))) in x against jax.grad of the
    Pallas kernel (interpret mode, which takes 128-lane widths)."""
    args = _inputs(128, seed=3)
    want = jax.grad(lambda v: jnp.sum(jnp.sin(_jax_fn("pallas_interpret")(
        v, *map(jnp.asarray, args[1:])))))(jnp.asarray(args[0]))
    x, *w = _torch_args(args)
    got = grad(lambda v: k1.depthwise_silu_segment(v, *w).sin().sum())(x)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **BWD_TOL)


# vmap against a loop: the same plain ops on folded or sliced batches
LOOP_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("primals", ["x", "x_taps_affines"])
def test_vjp_vmapped_over_cotangents_matches_a_loop(primals):
    """torch.func.vjp, then vmap of its vjp_fn over K = 3 cotangents (what
    an attack's class gradients do) against a loop of single vjps."""
    x, *w = _torch_args(_inputs(24, h=6, w=7, seed=4))
    if primals == "x":
        y, vjp_fn = vjp(lambda v: k1.depthwise_silu_segment(v, *w), x)
    else:
        y, vjp_fn = vjp(k1.depthwise_silu_segment, x, *w)
    gs = torch.tensor(np.random.RandomState(5).randn(3, *y.shape).astype(np.float32))
    batched = vmap(vjp_fn)(gs)
    looped = [vjp_fn(g) for g in gs]
    assert len(batched) == (1 if primals == "x" else 6)
    for i, b in enumerate(batched):
        torch.testing.assert_close(b, torch.stack([l[i] for l in looped]), **LOOP_TOL)


@pytest.mark.parametrize("batched", ["x", "taps", "x_and_s1"])
def test_vmap_of_forward_matches_a_loop(batched):
    """vmap of the forward over a batched x (folded into N: one call) and
    over batched taps or affines (a loop of calls) against a Python loop."""
    rng = np.random.RandomState(6)
    x, taps, s0, b0, s1, b1 = _torch_args(_inputs(16, h=5, w=9, seed=6))
    xs = torch.tensor(rng.randn(3, *x.shape).astype(np.float32))
    ts = torch.tensor((rng.randn(3, *taps.shape) * 0.2).astype(np.float32))
    s1s = torch.tensor((rng.randn(3, 16) * 0.5 + 1).astype(np.float32))
    if batched == "x":
        fn, ins = (lambda v: k1.depthwise_silu_segment(v, taps, s0, b0, s1, b1)), (xs,)
    elif batched == "taps":
        fn, ins = (lambda t: k1.depthwise_silu_segment(x, t, s0, b0, s1, b1)), (ts,)
    else:
        fn, ins = (lambda v, a: k1.depthwise_silu_segment(v, taps, s0, b0, a, b1)), (xs, s1s)
    want = torch.stack([fn(*(i[k] for i in ins)) for k in range(3)])
    torch.testing.assert_close(vmap(fn)(*ins), want, **LOOP_TOL)


@pytest.mark.parametrize("route", ["autograd_grad", "func_vjp", "vmap_autograd_grad"])
def test_x_only_backward_skips_the_weight_cotangents(monkeypatch, route):
    """With only x differentiated (an attack: frozen weights), the backward
    returns None for the five weight cotangents and the same dx as the
    six-cotangent backward. ctx.needs_input_grad is set by autograd on one
    route and by torch.func on the other: both are checked, and
    torch.autograd.grad under torch.func.vmap over two cotangents (the
    attacks' class gradients: the backward runs once, batched)."""
    args = _inputs(32, seed=8)
    g = torch.tensor(np.random.RandomState(9).randn(2, 32, 8, 8).astype(np.float32))
    returned = []
    backward = k1._Segment.backward

    def spy(ctx, g_):
        out = backward(ctx, g_)
        returned.append(out)
        return out

    monkeypatch.setattr(k1._Segment, "backward", staticmethod(spy))
    x, *w = _torch_args(args)
    if route == "autograd_grad":
        x.requires_grad_()
        (dx,) = torch.autograd.grad(k1.depthwise_silu_segment(x, *w), x, g)
    elif route == "func_vjp":
        _, vjp_fn = vjp(lambda v: k1.depthwise_silu_segment(v, *w), x)
        (dx,) = vjp_fn(g)
    else:
        x.requires_grad_()
        y = k1.depthwise_silu_segment(x, *w)
        dxs = vmap(lambda ct: torch.autograd.grad(y, x, ct)[0])(torch.stack([g, 2 * g]))
        dx = dxs[0]
        torch.testing.assert_close(dxs[1], 2 * dx, **LOOP_TOL)
    assert len(returned) == 1
    assert returned[0][0] is not None
    assert all(r is None for r in returned[0][1:])
    full = _torch_args(args, requires_grad=True)
    k1.depthwise_silu_segment(*full).backward(g)
    assert len(returned) == 2 and all(r is not None for r in returned[1])
    torch.testing.assert_close(dx, full[0].grad, rtol=0, atol=0)


# bfloat16 forward against the Pallas kernel in bfloat16 (interpret mode):
# both compute in float32 inside and round y once; torch's bfloat16
# defaults of assert_close (rtol 1.6e-2, 2 to 4 bfloat16 ulps; atol 1e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1e-5)


def _bf16(args):
    """The inputs rounded to bfloat16: numpy float32 arrays for JAX (cast
    there) and the port's tensors."""
    rounded = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in args]
    return [jnp.asarray(a, jnp.bfloat16) for a in rounded], [
        t.to(torch.bfloat16) for t in _torch_args(rounded)]


def test_bf16_forward_matches_pallas_interpret():
    """The plain version on bfloat16 inputs (C = 128, the Pallas kernel's
    lane width) against the Pallas kernel in interpret mode on the same
    bfloat16 inputs; y is bfloat16 on both sides."""
    jargs, targs = _bf16(_inputs(128, seed=21))
    want = _jax_fn("pallas_interpret")(*jargs)
    assert want.dtype == jnp.bfloat16
    got = k1.depthwise_silu_segment(*targs)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.permute(0, 2, 3, 1).float(),
                               torch.tensor(np.asarray(want.astype(jnp.float32))), **BF16_TOL)


def test_bf16_x_only_backward_within_jax_bf16_gap():
    """dx of the segment in bfloat16 (the weights frozen, as an attack
    differentiates it): the port's backward in bfloat16 and jax.vjp of the
    Pallas kernel's custom VJP on the same bfloat16 inputs, each against the
    float32 VJP of those inputs. They round at other places: the JAX VJP
    rounds after each of its shift-sums' 25 multiply-adds (1.0e-2 relative
    L2 from float32), the port's depthwise convolutions sum in float32 and
    round once (6.4e-3), so elementwise they differ by up to 2 % of the
    largest entry. The port may be at most BF16_GAP_FACTOR x as far from
    float32 as JAX is."""
    args = _inputs(128, seed=22)
    jargs, targs = _bf16(args)
    g = np.random.RandomState(23).randn(*jargs[0].shape).astype(np.float32)
    jg = jnp.asarray(g, jnp.bfloat16)
    _, vjp_fn = jax.vjp(lambda v: _jax_fn("pallas_interpret")(v, *jargs[1:]), jargs[0])
    (want16,) = vjp_fn(jg)
    assert want16.dtype == jnp.bfloat16
    wide = [a.astype(jnp.float32) for a in jargs]
    _, vjp32 = jax.vjp(lambda v: reference_segment(v, *wide[1:]), wide[0])
    (want32,) = vjp32(jg.astype(jnp.float32))
    x, *w = targs
    x.requires_grad_(True)
    (got,) = torch.autograd.grad(k1.depthwise_silu_segment(x, *w), x,
                                 torch.tensor(np.asarray(jg.astype(jnp.float32)))
                                 .permute(0, 3, 1, 2).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert_within_bf16_gap(got.permute(0, 2, 3, 1).float().numpy(),
                           np.asarray(want16.astype(jnp.float32)), np.asarray(want32), "dx")


def test_ragged_spatial_size_matches_jax():
    """Spatial sizes that are not multiples of the kernel's tiles."""
    args = _inputs(24, b=1, h=5, w=13, seed=7)
    want = np.asarray(reference_segment(*map(jnp.asarray, args)))
    got = k1.depthwise_silu_segment(*_torch_args(args))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **FWD_TOL)


def test_cpu_tensor_takes_the_plain_version_and_counts_nothing():
    k1.reset_launches()
    k1.depthwise_silu_segment(*_torch_args(_inputs(32)))
    assert k1.launches == 0


@pytest.mark.parametrize("bad", ["taps_shape", "affine_shape", "dtype", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, taps, s0, b0, s1, b1 = _torch_args(_inputs(32))
    if bad == "taps_shape":
        taps = taps[:3]
    elif bad == "affine_shape":
        s1 = s1[:16]
    elif bad == "dtype":
        x = x.double()
    else:
        x = x[0]
    with pytest.raises((ValueError, TypeError)):
        k1.depthwise_silu_segment(x, taps, s0, b0, s1, b1)



@pytest.mark.parametrize("log,want", [
    ("ptxas info    : Used 48 registers, used 1 barriers, 18432 bytes smem\n"
     "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n",
     {"registers": 48, "smem_bytes": 18432, "spill_bytes": 0}),
    ("    176 bytes stack frame, 176 bytes spill stores, 176 bytes spill loads\n"
     "ptxas info    : Used 80 registers, used 1 barriers, 176 bytes cumulative stack "
     "size, 36864 bytes smem\n",
     {"registers": 80, "smem_bytes": 36864, "spill_bytes": 352}),
])
def test_ptxas_summary(log, want):
    from gen_adversarial_tpu_torch.core.cuda_build import ptxas_summary
    assert ptxas_summary(log) == want


def test_library_name_follows_the_source(tmp_path):
    """An edited source builds anew: the library's name hashes its text."""
    from gen_adversarial_tpu_torch.core import cuda_build
    src = tmp_path / "k.cu"
    src.write_text("int a;")
    first = cuda_build._target(src)
    src.write_text("int b;")
    assert cuda_build._target(src) != first
    assert first.parent == cuda_build.BUILD_DIR


def test_missing_nvcc_is_reported(monkeypatch, tmp_path):
    from gen_adversarial_tpu_torch.core import cuda_build
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()
