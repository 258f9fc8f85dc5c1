"""Tests of the PyTorch port that need a CUDA card (marker `gpu`); each
skips without one. This file imports neither JAX nor the JAX package, so it
also runs on a machine that has only PyTorch:

    python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest` skips tests/conftest.py, which sets up JAX for the other
tests.)"""

import numpy as np
import pytest
import torch

from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.flagship import flagship
from gen_adversarial_tpu_torch.models.nvae.model import NVAEConfig, eps_shapes
from gen_adversarial_tpu_torch.ops import depthwise as k1
from gen_adversarial_tpu_torch.ops import upfirdn as k2

# float32 kernel vs plain: 25 products summed in another order
K1_TOL = dict(rtol=1e-5, atol=1e-5)
# float32 blur vs plain: at most 16 products, summed in the same order
K2_TOL = dict(rtol=1e-5, atol=1e-5)
# a whole small defense, GPU vs CPU: ~30 float32 layers in other orders
DEFENSE_TOL = dict(rtol=1e-4, atol=1e-5)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """The kernel against its plain version at flagship widths, a ragged
    width and size, and batch 1."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, c, h, w in [(4, 1536, 8, 8), (4, 192, 64, 64), (1, 40, 13, 5)]:
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
    pads); it agrees with autograd through the plain version."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    for taps, pad in [((0.1, 0.2, 0.3, 0.4), (1, 1)), ((0.1, 0.2, 0.3, 0.4), (2, 1)),
                      ((1 / 7, 2 / 7, 4 / 7), (2, 2))]:
        x = _channels_last((2, 64, 21, 18), gen)
        out = k2.out_size(21, len(taps), pad), k2.out_size(18, len(taps), pad)
        g = _channels_last((2, 64, *out), gen)
        xk = x.clone().requires_grad_()
        before = k2.launches
        k2.upfirdn_blur(xk, taps, pad).backward(g)
        assert k2.launches == before + 2
        xp = x.clone().requires_grad_()
        k2.blur_plain(xp, taps, pad).backward(g)
        torch.testing.assert_close(xk.grad, xp.grad, **K2_TOL)


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
