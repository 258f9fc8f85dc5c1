"""Tests of the PyTorch port that need a CUDA card (marker `gpu`); each
skips without one. This file imports neither JAX nor the JAX package, so it
also runs on a machine that has only PyTorch:

    python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest` skips tests/conftest.py, which sets up JAX for the other
tests.)"""

import copy

import numpy as np
import pytest
import torch
from torch.func import vjp, vmap

from gen_adversarial_tpu_torch.core.precision import BF16_GAP_FACTOR
from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.flagship import flagship
from gen_adversarial_tpu_torch.models.nvae.model import NVAEConfig, eps_shapes
from gen_adversarial_tpu_torch.models.stylegan2.generator import GENERATOR_CHANNELS
from gen_adversarial_tpu_torch.ops import depthwise as k1
from gen_adversarial_tpu_torch.ops import upfirdn as k2

# float32 kernel vs plain: 25 products summed in another order
K1_TOL = dict(rtol=1e-5, atol=1e-5)
# float32 blur vs plain: at most 16 products, summed in the same order
K2_TOL = dict(rtol=1e-5, atol=1e-5)
# a whole small defense, GPU vs CPU: ~30 float32 layers in other orders
DEFENSE_TOL = dict(rtol=1e-4, atol=1e-5)
# bfloat16 kernel vs its plain version: both sum in float32 and round y once,
# so they differ by at most one bfloat16 ulp (2**-8 relative; torch's
# bfloat16 defaults of assert_close)
BF16_TOL = dict(rtol=1.6e-2, atol=1e-5)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# (C, H) of the flagship's decoder segments (NVAEConfig.decoder_segment_shapes)
FLAGSHIP_SEGMENTS = [(1536, 8), (1536, 16), (768, 16), (768, 32), (384, 32), (192, 64),
                     (96, 64)]


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """The kernel against its plain version at the flagship's seven shapes
    (N = 4), a ragged width and size, and batch 1."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(4, c, h, h) for c, h in FLAGSHIP_SEGMENTS] + [(1, 40, 13, 5), (1, 96, 64, 64),
                                                             (3, 44, 17, 33)]
    for n, c, h, w in shapes:
        x = torch.randn(n, c, h, w, device="cuda", generator=gen).contiguous(
            memory_format=torch.channels_last)
        taps = torch.randn(5, 5, c, device="cuda", generator=gen) * 0.2
        aff = [torch.randn(c, device="cuda", generator=gen) * 0.5 + 1 for _ in range(4)]
        before = k1.launches
        got = k1.depthwise_silu_segment(x, taps, *aff)
        torch.cuda.synchronize()
        assert k1.launches == before + 1
        torch.testing.assert_close(got, k1.depthwise_silu_segment_plain(x, taps, *aff),
                                   **K1_TOL)


@pytest.mark.gpu
def test_cuda_segment_gradients_match_cpu():
    """The six cotangents through the kernel's forward on the card against
    the plain path on the CPU (the backward is plain torch ops on both)."""
    _need_card()
    rng = np.random.RandomState(5)
    n, c, h = 2, 96, 16
    args = [rng.randn(n, c, h, h), rng.randn(5, 5, c) * 0.2,
            *(rng.randn(c) * 0.5 + 1 for _ in range(4))]
    g = torch.tensor(rng.randn(n, c, h, h).astype(np.float32))
    grads = {}
    for dev in ("cpu", "cuda"):
        ts = [torch.tensor(a.astype(np.float32), device=dev) for a in args]
        ts[0] = ts[0].contiguous(memory_format=torch.channels_last)
        for t in ts:
            t.requires_grad_()
        k1.depthwise_silu_segment(*ts).backward(g.to(dev))
        grads[dev] = [t.grad.cpu() for t in ts]
    for want, got in zip(grads["cpu"], grads["cuda"]):
        # sums over N*H*W = 512 terms in another order
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_wrapper_rejects_non_channels_last_input():
    _need_card()
    x = torch.randn(1, 32, 8, 8, device="cuda")
    taps = torch.randn(5, 5, 32, device="cuda")
    aff = [torch.ones(32, device="cuda") for _ in range(4)]
    with pytest.raises(ValueError):
        k1.depthwise_silu_segment(x, taps, *aff)


@pytest.mark.gpu
def test_cuda_wrapper_refuses_widths_the_tma_cannot_stage():
    """The kernel stages x by TMA, whose row pitch (C x 4 bytes) must be a
    multiple of 16: other widths are refused, not staged another way."""
    _need_card()
    x = torch.randn(1, 6, 8, 8, device="cuda").contiguous(memory_format=torch.channels_last)
    taps = torch.randn(5, 5, 6, device="cuda")
    aff = [torch.ones(6, device="cuda") for _ in range(4)]
    with pytest.raises(ValueError, match="multiple of 4"):
        k1.depthwise_silu_segment(x, taps, *aff)


@pytest.mark.gpu
def test_cuda_x_only_backward_matches_cpu():
    """With the weights frozen (an attack), the backward computes dx alone;
    on the card it agrees with the CPU one."""
    _need_card()
    rng = np.random.RandomState(6)
    n, c, h = 2, 96, 16
    args = [rng.randn(n, c, h, h), rng.randn(5, 5, c) * 0.2,
            *(rng.randn(c) * 0.5 + 1 for _ in range(4))]
    g = torch.tensor(rng.randn(n, c, h, h).astype(np.float32))
    dx = {}
    for dev in ("cpu", "cuda"):
        x, *w = [torch.tensor(a.astype(np.float32), device=dev) for a in args]
        x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
        (dx[dev],) = torch.autograd.grad(k1.depthwise_silu_segment(x, *w), x, g.to(dev))
    torch.testing.assert_close(dx["cuda"].cpu(), dx["cpu"], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_cuda_func_vjp_vmapped_over_cotangents_matches_a_loop():
    """torch.func.vjp through K1 and K2 on the card, then vmap of the vjp_fn
    over 3 cotangents, against a loop of single vjps. K2's backward is the
    kernel again: the batched cotangent reaches it folded into N, one launch.
    vmap of K1's forward over a batched x is one launch too."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = _channels_last((2, 96, 16, 16), gen)
    taps = torch.randn(5, 5, 96, device="cuda", generator=gen) * 0.2
    aff = [torch.randn(96, device="cuda", generator=gen) * 0.5 + 1 for _ in range(4)]

    def seg(v):
        return k1.depthwise_silu_segment(v, taps, *aff)

    before = k1.launches
    y, vjp_fn = vjp(seg, x)
    gs = torch.randn(3, *y.shape, device="cuda", generator=gen)
    batched = vmap(vjp_fn)(gs)[0]
    assert k1.launches == before + 1
    torch.testing.assert_close(batched, torch.stack([vjp_fn(g)[0] for g in gs]),
                               rtol=1e-5, atol=1e-6)
    xs = torch.randn(3, 2, 96, 16, 16, device="cuda", generator=gen)
    before = k1.launches
    got = vmap(seg)(xs)
    assert k1.launches == before + 1
    torch.testing.assert_close(
        got, torch.stack([k1.depthwise_silu_segment_plain(v, taps, *aff) for v in xs]),
        **K1_TOL)

    x = _channels_last((2, 64, 21, 18), gen)
    taps2, pad = (0.1, 0.2, 0.3, 0.4), (2, 1)
    before = k2.launches
    y, vjp_fn = vjp(lambda v: k2.upfirdn_blur(v, taps2, pad), x)
    gs = torch.randn(3, *y.shape, device="cuda", generator=gen)
    batched = vmap(vjp_fn)(gs)[0]
    assert k2.launches == before + 2  # the forward, one folded backward
    torch.testing.assert_close(batched, torch.stack([vjp_fn(g)[0] for g in gs]), **K2_TOL)
    xp = x.clone().requires_grad_()
    yp = k2.blur_plain(xp, taps2, pad)
    want = torch.stack([torch.autograd.grad(yp, xp, g, retain_graph=True)[0] for g in gs])
    torch.testing.assert_close(batched, want, **K2_TOL)


@pytest.mark.gpu
def test_small_defense_on_gpu_matches_cpu():
    """The same small defense, weights and draws on the GPU (kernel path) and
    the CPU (plain path)."""
    _need_card()
    cfg = NVAEConfig(resolution=32, initial_channels=8, num_scales=2,
                     num_groups_per_scale=2, is_adaptive=False, num_cells_per_group=1,
                     num_latent_per_group=4, num_mixtures=3)
    kw = dict(initial_noise_eps=2.0, seed=3, cfg=cfg, vgg_plan=(16, "M", 32, "M"),
              n_classes=10)
    cpu = flagship(device="cpu", **kw)
    gpu = flagship(device="cuda", **kw)
    gpu.load_state_dict(cpu.state_dict())
    eot, b = 4, 2
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.rand(b, 32, 32, 3).astype(np.float32))
    shapes = [(eot * b, 32, 32, 3)] + eps_shapes(cfg, eot * b)
    draws = [torch.tensor(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    before = k1.launches
    with torch.no_grad():
        want = eot_wrap(cpu, eot)(x, draws)
        got = eot_wrap(gpu, eot)(x.cuda(), draws).cpu()
    assert k1.launches - before == len(cfg.decoder_segment_shapes())
    torch.testing.assert_close(got, want, **DEFENSE_TOL)


def _channels_last(shape, gen):
    return torch.randn(*shape, device="cuda", generator=gen).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.gpu
def test_cuda_blur_matches_plain_version():
    """K2 against its plain version: the generator's up-conv blur at a
    narrow and a wide width, ragged sizes and channel counts, 3 taps, other
    pads, and asymmetric taps (a missing flip shows there)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    up = (0.25, 0.75, 0.75, 0.25)
    for shape, taps, pad in [((4, 512, 17, 17), up, (1, 1)),
                             ((2, 32, 65, 65), up, (1, 1)),
                             ((3, 40, 13, 29), (0.1, 0.2, 0.3, 0.4), (2, 1)),
                             ((1, 3, 8, 8), (0.25, 0.5, 0.25), (2, 2)),
                             ((2, 96, 19, 7), (1 / 7, 2 / 7, 4 / 7), (1, 1))]:
        x = _channels_last(shape, gen)
        before = k2.launches
        got = k2.upfirdn_blur(x, taps, pad)
        torch.cuda.synchronize()
        assert k2.launches == before + 1
        torch.testing.assert_close(got, k2.blur_plain(x, taps, pad), **K2_TOL)


@pytest.mark.gpu
def test_cuda_blur_backward_matches_plain_autograd():
    """The backward launches the same kernel (flipped taps, transposed
    pads); it agrees with autograd through the plain version, also at the
    discriminator's width and pads, at a crop and at 5 images."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    asym = (0.1, 0.2, 0.3, 0.4)
    for shape, taps, pad in [((2, 64, 21, 18), asym, (1, 1)), ((2, 64, 21, 18), asym, (2, 1)),
                             ((2, 64, 21, 18), (1 / 7, 2 / 7, 4 / 7), (2, 2)),
                             ((4, 512, 16, 16), (1 / 8, 3 / 8, 3 / 8, 1 / 8), (2, 2)),
                             ((5, 32, 33, 20), asym, (1, 1)),
                             ((1, 64, 19, 19), (1 / 7, 2 / 7, 4 / 7), (-1, 2))]:
        x = _channels_last(shape, gen)
        out = k2.out_size(shape[2], len(taps), pad), k2.out_size(shape[3], len(taps), pad)
        g = _channels_last((shape[0], shape[1], *out), gen)
        xk = x.clone().requires_grad_()
        before = k2.launches
        k2.upfirdn_blur(xk, taps, pad).backward(g)
        assert k2.launches == before + 2
        xp = x.clone().requires_grad_()
        k2.blur_plain(xp, taps, pad).backward(g)
        torch.testing.assert_close(xk.grad, xp.grad, **K2_TOL)


def _offset_copy(x):
    """x's values in channels_last storage that starts 4 bytes past a 16-byte
    boundary: the float32 vector path needs x 16-byte aligned, so this copy
    takes the masked path."""
    n, c, h, w = x.shape
    flat = torch.empty(n * h * w * c + 1, device=x.device, dtype=x.dtype)
    out = flat[1:].view(n, h, w, c).permute(0, 3, 1, 2)
    out.copy_(x)
    assert out.is_contiguous(memory_format=torch.channels_last) and out.data_ptr() % 16 == 4
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("c", [32, 64, 512])
def test_cuda_blur_f32_vector_path_matches_plain_version(c):
    """The float32 vector path (C a multiple of 4, x and y 16-byte aligned)
    against the plain version at the generators' and the discriminator's
    widths, 3 and 4 taps, pads (1, 1), (2, 2) and a crop (-1, 2), one and
    five images, sizes that leave partial tiles; one launch counted a call,
    whether autograd records it or not."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(13)
    for n in (1, 5):
        for taps in ((1 / 8, 3 / 8, 3 / 8, 1 / 8), (0.1, 0.2, 0.3, 0.4), (1 / 7, 2 / 7, 4 / 7)):
            for pad in ((1, 1), (2, 2), (-1, 2)):
                x = _channels_last((n, c, 19, 37), gen)
                want = k2.blur_plain(x, taps, pad)
                before = k2.launches
                got = k2.upfirdn_blur(x, taps, pad)
                assert k2.launches == before + 1
                torch.testing.assert_close(got, want, **K2_TOL)
                recorded = k2.upfirdn_blur(x.clone().requires_grad_(), taps, pad)
                assert k2.launches == before + 2
                assert torch.equal(recorded.detach(), got), (n, taps, pad)


@pytest.mark.gpu
def test_cuda_blur_f32_vector_and_masked_paths_are_bit_identical():
    """The same values through the vector path and through the masked path
    (an x 4 bytes past alignment; and C = 35, not a multiple of 4, against
    the first 35 channels of C = 36) give the same bits: both sum in the same
    order."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(14)
    for shape, taps, pad in [((2, 32, 33, 33), (1 / 8, 3 / 8, 3 / 8, 1 / 8), (1, 1)),
                             ((3, 512, 9, 9), (1 / 8, 3 / 8, 3 / 8, 1 / 8), (2, 2)),
                             ((1, 64, 20, 45), (0.1, 0.2, 0.3, 0.4), (-1, 2)),
                             ((2, 36, 17, 17), (1 / 7, 2 / 7, 4 / 7), (1, 1))]:
        x = _channels_last(shape, gen)
        vector = k2.upfirdn_blur(x, taps, pad)
        before = k2.launches
        masked = k2.upfirdn_blur(_offset_copy(x), taps, pad)
        assert k2.launches == before + 1
        assert torch.equal(vector, masked), (shape, taps, pad)
    x = _channels_last((2, 36, 21, 30), gen)
    narrow = x[:, :35].contiguous(memory_format=torch.channels_last)
    for taps, pad in [((0.1, 0.2, 0.3, 0.4), (2, 2)), ((1 / 7, 2 / 7, 4 / 7), (-1, 2))]:
        assert torch.equal(k2.upfirdn_blur(x, taps, pad)[:, :35],
                           k2.upfirdn_blur(narrow, taps, pad)), (taps, pad)


@pytest.mark.gpu
def test_cuda_blur_past_2_to_the_31_elements():
    """The 1024-px site of the gender call: x (64, 32, 1025, 1025) holds
    2.15e9 elements, past what a 32-bit offset addresses. The first and the
    last images (offsets past 2**31) against the plain version."""
    _need_card()
    shape = (64, 32, 1025, 1025)
    need = 2 * 4 * 64 * 32 * 1025 * 1025 + 2 * 4 * 4 * 32 * 1025 * 1025
    if torch.cuda.mem_get_info()[0] < need * 1.2:
        pytest.skip(f"needs {need / 2**30:.1f} GiB of free device memory")
    x = _channels_last(shape, torch.Generator(device="cuda").manual_seed(3))
    assert x.numel() > 2 ** 31 - 1
    taps, pad = (0.25, 0.75, 0.75, 0.25), (1, 1)
    got = k2.upfirdn_blur(x, taps, pad)
    torch.cuda.synchronize()
    for part in (slice(0, 2), slice(62, 64)):
        torch.testing.assert_close(got[part], k2.blur_plain(x[part], taps, pad), **K2_TOL)


@pytest.mark.gpu
def test_cuda_bf16_kernels_match_plain_versions():
    """The bfloat16 builds of K1 (at the flagship's seven shapes, N = 4, and
    ragged sizes with widths that are multiples of 8) and of K2 (the
    up-conv blur, ragged sizes, asymmetric and 3-tap filters) against their
    plain versions, which widen to float32 and round once."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = [(4, c, h, h) for c, h in FLAGSHIP_SEGMENTS] + [(1, 40, 13, 5), (3, 48, 17, 33)]
    for n, c, h, w in shapes:
        x = _channels_last((n, c, h, w), gen).bfloat16()
        taps = (torch.randn(5, 5, c, device="cuda", generator=gen) * 0.2).bfloat16()
        aff = [(torch.randn(c, device="cuda", generator=gen) * 0.5 + 1).bfloat16()
               for _ in range(4)]
        before = k1.launches
        got = k1.depthwise_silu_segment(x, taps, *aff)
        torch.cuda.synchronize()
        assert k1.launches == before + 1 and got.dtype == torch.bfloat16
        torch.testing.assert_close(got, k1.depthwise_silu_segment_plain(x, taps, *aff),
                                   **BF16_TOL)
    up = (0.25, 0.75, 0.75, 0.25)
    for shape, taps, pad in [((4, 512, 17, 17), up, (1, 1)), ((2, 32, 65, 65), up, (1, 1)),
                             ((3, 40, 13, 29), (0.1, 0.2, 0.3, 0.4), (2, 1)),
                             ((2, 96, 19, 7), (1 / 7, 2 / 7, 4 / 7), (1, 1))]:
        x = _channels_last(shape, gen).bfloat16()
        before = k2.launches
        got = k2.upfirdn_blur(x, taps, pad)
        torch.cuda.synchronize()
        assert k2.launches == before + 1 and got.dtype == torch.bfloat16
        torch.testing.assert_close(got, k2.blur_plain(x, taps, pad), **BF16_TOL)
        # the backward: the bfloat16 kernel again
        xk = x.clone().requires_grad_()
        g = _channels_last(tuple(got.shape), gen).bfloat16()
        k2.upfirdn_blur(xk, taps, pad).backward(g)
        xp = x.clone().requires_grad_()
        k2.blur_plain(xp, taps, pad).backward(g)
        torch.testing.assert_close(xk.grad, xp.grad, **BF16_TOL)


def _assert_within_one_ulp(got, want, what):
    """Every element within one bfloat16 spacing of want (2**-7 of its
    binade) or within the float32 kernels' absolute tolerance (1e-5 of the
    output's scale): near 0 the two float32 sums' orders alone differ by
    more spacings than one."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    spacing = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    atol = 1e-5 * max(1.0, want.abs().max().item())
    bad = ((d > spacing) & (d > atol)).sum().item()
    assert bad == 0, f"{what}: {bad} elements beyond one ulp, max abs err {d.max().item()}"


# K2's sites on the main paths: (C, H_in) of the blur after each up-conv of
# the 1024-px (gender) and the 512-px (cars) generator
K2_PATH_SITES = [(GENERATOR_CHANNELS[r], r + 1) for r in (2 ** i for i in range(3, 11))]


@pytest.mark.gpu
def test_cuda_bf16_redesigned_builds_on_every_path_shape():
    """The bfloat16 builds at every shape their paths give them, at a small
    batch: K1 at the flagship's seven shapes within one bfloat16 ulp of its
    plain version; K2 at every gender and cars site (the cars sites are the
    gender ones up to 512 px) bit-identical to its plain version, which sums
    in float32 in the same order and rounds once."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    for c, h in FLAGSHIP_SEGMENTS:
        x = _channels_last((2, c, h, h), gen).bfloat16()
        taps = torch.randn(5, 5, c, device="cuda", generator=gen) * 0.2
        aff = [torch.randn(c, device="cuda", generator=gen) * 0.5 + 1 for _ in range(4)]
        got = k1.depthwise_silu_segment(x, taps, *aff)
        _assert_within_one_ulp(got, k1.depthwise_silu_segment_plain(x, taps, *aff), (c, h))
    taps = tuple(2.0 * t / 8 for t in (1, 3, 3, 1))
    for c, h in K2_PATH_SITES:
        x = _channels_last((2, c, h, h), gen).bfloat16()
        before = k2.launches_by_dtype[torch.bfloat16]
        got = k2.upfirdn_blur(x, taps, (1, 1))
        assert k2.launches_by_dtype[torch.bfloat16] == before + 1
        assert torch.equal(got, k2.blur_plain(x, taps, (1, 1))), (c, h)


@pytest.mark.gpu
def test_cuda_bf16_redesigned_builds_ragged():
    """The ragged cases of the bfloat16 builds: K2 at channel counts that are
    not multiples of 8 (the masked scalar path) or of 32 (a partial channel
    tile), pads (2, 2) and negative pads, 3 taps, 8-px maps and sizes that
    leave partial tiles, bit-identical; K1 at widths that are multiples of 8
    but not of 32, and sizes that leave partial tiles, within one ulp; both
    under torch.func.vmap, whose rule folds the batch into N (one launch)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(12)
    asym = (0.1, 0.2, 0.3, 0.4)
    for shape, taps, pad in [((2, 3, 9, 9), asym, (1, 1)), ((1, 13, 20, 37), asym, (2, 2)),
                             ((2, 45, 33, 31), (1 / 7, 2 / 7, 4 / 7), (1, 1)),
                             ((2, 40, 8, 8), asym, (2, 2)), ((1, 72, 31, 70), asym, (-1, 2)),
                             ((3, 24, 17, 17), (1 / 7, 2 / 7, 4 / 7), (0, -1)),
                             ((1, 512, 9, 9), asym, (1, 1))]:
        x = _channels_last(shape, gen).bfloat16()
        got = k2.upfirdn_blur(x, taps, pad)
        assert torch.equal(got, k2.blur_plain(x, taps, pad)), (shape, taps, pad)
    for n, c, h, w in [(1, 40, 13, 5), (3, 48, 17, 33), (2, 72, 8, 8), (1, 200, 37, 21)]:
        x = _channels_last((n, c, h, w), gen).bfloat16()
        taps = torch.randn(5, 5, c, device="cuda", generator=gen) * 0.2
        aff = [torch.randn(c, device="cuda", generator=gen) * 0.5 + 1 for _ in range(4)]
        got = k1.depthwise_silu_segment(x, taps, *aff)
        _assert_within_one_ulp(got, k1.depthwise_silu_segment_plain(x, taps, *aff), (c, h, w))
    # vmap over a leading dim: one launch each, as the plain version per slice
    xs = torch.randn(3, 2, 40, 17, 17, device="cuda", generator=gen).bfloat16()
    before = k2.launches
    got = torch.func.vmap(lambda v: k2.upfirdn_blur(v, asym, (1, 1)))(xs)
    assert k2.launches == before + 1
    assert torch.equal(got, torch.stack([k2.blur_plain(v, asym, (1, 1)) for v in xs]))
    taps = torch.randn(5, 5, 40, device="cuda", generator=gen) * 0.2
    aff = [torch.randn(40, device="cuda", generator=gen) * 0.5 + 1 for _ in range(4)]
    before = k1.launches
    got = torch.func.vmap(lambda v: k1.depthwise_silu_segment(v, taps, *aff))(xs)
    assert k1.launches == before + 1
    want = torch.stack([k1.depthwise_silu_segment_plain(v, taps, *aff) for v in xs])
    _assert_within_one_ulp(got, want, "vmap")


@pytest.mark.gpu
def test_cuda_bf16_segment_refuses_what_it_cannot_stage():
    """In bfloat16 a TMA row pitch of C x 2 bytes is a multiple of 16 only
    for C a multiple of 8: C = 12 is refused (float32 takes it), not staged
    another way nor widened to float32. float16 and float64 are refused."""
    _need_card()
    x = torch.randn(1, 12, 8, 8, device="cuda").contiguous(memory_format=torch.channels_last)
    taps = torch.randn(5, 5, 12, device="cuda")
    aff = [torch.ones(12, device="cuda") for _ in range(4)]
    k1.depthwise_silu_segment(x, taps, *aff)
    before = k1.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        k1.depthwise_silu_segment(x.bfloat16(), taps, *aff)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            k1.depthwise_silu_segment(x.to(dtype), taps, *aff)
        with pytest.raises(TypeError):
            k2.upfirdn_blur(x.to(dtype), (0.25, 0.75, 0.75, 0.25), (1, 1))
    assert k1.launches == before


@pytest.mark.gpu
def test_small_bf16_defense_on_gpu_against_cpu():
    """The small ids defense of test_small_defense_on_gpu_matches_cpu (its
    hidden widths 192, 96, 48 and 24 are multiples of 8) in bfloat16 on the
    card: its logits at most BF16_GAP_FACTOR x as far from the CPU's float32
    ones as the CPU's own bfloat16 run is, and through K1."""
    from gen_adversarial_tpu_torch.core.precision import defense_astype
    _need_card()
    cfg = NVAEConfig(resolution=32, initial_channels=8, num_scales=2,
                     num_groups_per_scale=2, is_adaptive=False, num_cells_per_group=1,
                     num_latent_per_group=4, num_mixtures=3)
    kw = dict(initial_noise_eps=2.0, seed=3, cfg=cfg, vgg_plan=(16, "M", 32, "M"),
              n_classes=10)
    # one build and its deep copies, each computing from its own weights
    cpu = flagship(device="cpu", **kw)
    cpu16, gpu = copy.deepcopy(cpu), copy.deepcopy(cpu).cuda()
    eot, b = 4, 2
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.rand(b, 32, 32, 3).astype(np.float32))
    shapes = [(eot * b, 32, 32, 3)] + eps_shapes(cfg, eot * b)
    draws = [torch.tensor(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    with torch.no_grad():
        want = eot_wrap(cpu, eot)(x, draws)
        cpu16 = eot_wrap(defense_astype(cpu16), eot)(x, draws)
        before = k1.launches
        got = eot_wrap(defense_astype(gpu), eot)(x.cuda(), draws).cpu()
    assert k1.launches - before == len(cfg.decoder_segment_shapes())
    assert got.dtype == torch.float32
    gap = (cpu16 - want).abs().max().item()
    assert (got - want).abs().max().item() <= BF16_GAP_FACTOR * gap


@pytest.mark.gpu
def test_small_train_steps_on_gpu_match_cpu():
    """One make_nvae_train_step step of a small NVAE (input noise, the same
    draws) and one train_step of a small VGG (the same augmentation) on the
    card and on the CPU from the same weights: the loss, the gradients and
    the running statistics within 1e-4 relative; the trained NVAE's eval
    decode then launches K1 once a decoder cell (the training step none)."""
    _need_card()
    from gen_adversarial_tpu_torch.core.init import flax_init_
    from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
    from gen_adversarial_tpu_torch.models.nvae.model import NVAE
    from gen_adversarial_tpu_torch.train import augment
    from gen_adversarial_tpu_torch.train import classifier as train_clf
    from gen_adversarial_tpu_torch.train import nvae as train_nvae

    def rel(got, want):
        return ((got.double().cpu() - want.double()).abs().max()
                / want.double().abs().max().clamp(min=1e-12)).item()

    gen = torch.Generator().manual_seed(3)
    cfg = NVAEConfig(resolution=16, initial_channels=8, num_scales=2, num_groups_per_scale=2,
                     is_adaptive=False, num_cells_per_group=1, num_latent_per_group=4,
                     num_mixtures=3)
    cpu = flax_init_(NVAE(cfg, device="cpu"), gen)
    x = torch.rand((2, 16, 16, 3), generator=gen)
    draws = [torch.randn((2, 16, 16, 3), generator=gen)]
    draws += [torch.randn(s, generator=gen) for s in eps_shapes(cfg, 2)]
    out = {}
    for where, model in (("cpu", cpu), ("cuda", copy.deepcopy(cpu).to("cuda"))):
        _, step = train_nvae.make_nvae_train_step(model, 6e-3, 100, input_noise=0.03)
        k1.reset_launches()
        with torch.backends.mkldnn.flags(enabled=False):
            loss = step({"image": x}, list(draws), 5)[0].item()
        assert k1.launches == 0
        out[where] = (loss, {n: p.grad for n, p in model.named_parameters()},
                      {n: b for n, b in model.named_buffers() if b.is_floating_point()})
    (want_loss, want_g, want_b), (got_loss, got_g, got_b) = out["cpu"], out["cuda"]
    assert abs(got_loss - want_loss) <= 1e-4 * abs(want_loss)
    scale = max(g.abs().max().item() for g in want_g.values())
    assert max((got_g[n].cpu() - want_g[n]).abs().max().item() for n in want_g) <= 1e-4 * scale
    assert max(rel(got_b[n], want_b[n]) for n in want_b) <= 1e-4
    gpu = copy.deepcopy(cpu).to("cuda").eval().requires_grad_(False)
    k1.reset_launches()
    with torch.no_grad():
        gpu.reconstruct(x.cuda(), deterministic=True)
    assert k1.launches == len(cfg.decoder_segment_shapes())

    vgg = flax_init_(VGG11BN(10, plan=(8, "M", 16, "M", 16, "M"), device="cpu"), gen)
    batch = {"image": torch.rand((4, 16, 16, 3), generator=gen),
             "label": torch.randint(0, 10, (4,), generator=gen)}
    params = augment.draw_augment(gen, 4)

    def fixed(images, generator):
        out = augment.apply_augment(images, {k: v.to(images.device) for k, v in params.items()})
        return (out - 0.5) / 0.5

    for where, model in (("cpu", vgg), ("cuda", copy.deepcopy(vgg).to("cuda"))):
        with torch.backends.mkldnn.flags(enabled=False):
            loss = train_clf.train_step(train_clf.create_train_state(model, 0.01), batch,
                                        None, augment=fixed).item()
        out[where] = (loss, {k: v for k, v in model.state_dict().items()
                             if v.is_floating_point()})
    (want_loss, want), (got_loss, got) = out["cpu"], out["cuda"]
    assert abs(got_loss - want_loss) <= 1e-4 * abs(want_loss)
    assert max(rel(got[k], want[k]) for k in want) <= 1e-4
