"""The port's StyleGAN2 layers, generator and discriminator, the E4E encoder
and the PSP container against the JAX package on the CPU, on the same random
variables (tests/torch_port_helpers.random_variables) and the same inputs
from a numpy seed: ModulatedConv2d (up-convolution with its K2 blur, stride
1, the downsample branch, and per-sample weights_delta in all three),
StyledConv with its noise, ToRGB with its skip upsample, EqualConv2d,
ConvLayer (with and without downsample, activation and bias), ResBlock,
downsample_fir, the style MLP, a 32-px generator with its fixed noise
buffers and with its options (mean_latent, truncation, style mixing,
randomize_noise with replayed draws, weights_deltas, return_latents), the
discriminator's forward and input gradient, and Encoder4Editing /
PSP.encode / PSP.decode at stylegan_size 32 on a 64-px input. At these sizes
the JAX generator keeps its logical layout (its phase-domain top block only
serves blocks of fewer than 128 channels, at 512 px and up); no GAT_*
variable is set.

The port is NCHW, JAX NHWC."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gen_adversarial_tpu.models.e4e.encoder import Encoder4Editing as JaxE4E
from gen_adversarial_tpu.models.e4e.psp import PSP as JaxPSP
from gen_adversarial_tpu.models.stylegan2 import layers as jlayers
from gen_adversarial_tpu.models.stylegan2.discriminator import Discriminator as JaxDiscriminator
from gen_adversarial_tpu.models.stylegan2.generator import Generator as JaxGenerator
from gen_adversarial_tpu.models.stylegan2.layers import ModulatedConv2d as JaxModConv
from gen_adversarial_tpu.models.stylegan2.layers import StyledConv as JaxStyledConv
from gen_adversarial_tpu.models.stylegan2.layers import ToRGB as JaxToRGB
from gen_adversarial_tpu.ops.image import resize_bilinear as jax_resize_bilinear
from gen_adversarial_tpu_torch.models.e4e.encoder import Encoder4Editing
from gen_adversarial_tpu_torch.models.e4e.psp import PSP
from gen_adversarial_tpu_torch.models.stylegan2 import layers
from gen_adversarial_tpu_torch.models.stylegan2.discriminator import Discriminator
from gen_adversarial_tpu_torch.models.stylegan2.generator import Generator
from gen_adversarial_tpu_torch.models.stylegan2.layers import ModulatedConv2d, StyledConv, ToRGB
from gen_adversarial_tpu_torch.ops import upfirdn as k2
from gen_adversarial_tpu_torch.ops.image import resize_bilinear
from tests.torch_port_helpers import load_port, no_onednn, one_torch_thread  # noqa: F401
from tests.torch_port_helpers import random_variables, rel_err, to_nchw, to_nhwc

SIZE = 32  # n_latent 8: the coarse, middle and fine style heads all run
B = 2
KEY = jax.random.PRNGKey(0)
# one layer: a few hundred float32 products per output in another order
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
# the generator: 7 modulated convolutions with demodulation, outputs O(1)
GEN_TOL = dict(rtol=1e-4, atol=1e-4)
# the encoder: ~60 float32 convolution layers (IR-SE-50 + the style heads),
# codes O(1)
ENC_TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_layer(module, *args, seed):
    variables = random_variables(jax.eval_shape(lambda: module.init(KEY, *args)), seed)
    return variables, module.apply(variables, *args)


@pytest.mark.parametrize("upsample", [True, False])
def test_modulated_conv_matches_jax(upsample):
    x, style = _rand((B, 8, 8, 16), 0), _rand((B, 512), 1)
    variables, want = _jax_layer(JaxModConv(8, 3, upsample=upsample), jnp.asarray(x),
                                 jnp.asarray(style), seed=2)
    port = load_port(ModulatedConv2d(16, 8, 3, upsample=upsample), variables)
    before = k2.launches
    with torch.no_grad():
        got = port(to_nchw(x), torch.tensor(style))
    assert k2.launches == before  # the CPU runs the blur's plain version
    assert to_nhwc(got).shape == ((B, 16, 16, 8) if upsample else (B, 8, 8, 8))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **LAYER_TOL)


def _delta_nchw(delta):
    """A JAX weights_delta (B, k, k, in, out) in the port's (B, out, in, k, k)."""
    return torch.tensor(np.ascontiguousarray(np.transpose(delta, (0, 4, 3, 1, 2))))


@pytest.mark.parametrize("mode", ["up", "down", "plain"])
@pytest.mark.parametrize("delta", [False, True], ids=["shared", "weights_delta"])
def test_modulated_conv_branches_match_jax(mode, delta):
    """The downsample branch (K2's pad (2, 2) blur, then stride 2) and the
    per-sample weights_delta path in all three forms (the blur before the
    grouped convolution when downsampling, after it when upsampling)."""
    x, style = _rand((B, 8, 8, 16), 30), _rand((B, 512), 31)
    module = JaxModConv(8, 3, upsample=mode == "up", downsample=mode == "down")
    args = [jnp.asarray(x), jnp.asarray(style)]
    d = 0.3 * _rand((B, 3, 3, 16, 8), 32) if delta else None
    variables, want = _jax_layer(module, *args, *([jnp.asarray(d)] if delta else []), seed=33)
    port = load_port(ModulatedConv2d(16, 8, 3, upsample=mode == "up",
                                     downsample=mode == "down"), variables)
    with torch.no_grad():
        got = port(to_nchw(x), torch.tensor(style), _delta_nchw(d) if delta else None)
    side = {"up": 16, "down": 4, "plain": 8}[mode]
    assert to_nhwc(got).shape == (B, side, side, 8)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **LAYER_TOL)


# (kernel, downsample, activate, bias): conv_in / conv1, conv2, skip, and the
# scaled leaky ReLU and plain-bias forms
CONV_LAYERS = [(1, False, True, True), (3, False, True, True), (3, True, True, True),
               (1, True, False, False), (3, True, True, False), (3, False, False, True)]


@pytest.mark.parametrize("k,downsample,activate,bias", CONV_LAYERS)
def test_conv_layer_matches_jax(k, downsample, activate, bias):
    x = _rand((B, 8, 8, 6), 34)
    module = jlayers.ConvLayer(5, k, downsample=downsample, use_bias=bias, activate=activate)
    variables, want = _jax_layer(module, jnp.asarray(x), seed=35)
    port = load_port(layers.ConvLayer(6, 5, k, downsample=downsample, bias=bias,
                                      activate=activate), variables)
    with torch.no_grad():
        got = port(to_nchw(x))
    assert to_nhwc(got).shape == (B, 4 if downsample else 8, 4 if downsample else 8, 5)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **LAYER_TOL)


def test_res_block_equal_conv_and_downsample_fir_match_jax():
    x = _rand((B, 8, 8, 6), 36)
    variables, want = _jax_layer(jlayers.ResBlock(10), jnp.asarray(x), seed=37)
    port = load_port(layers.ResBlock(6, 10), variables)
    econv = jlayers.EqualConv2d(5, 3, stride=2, padding=1)
    evars, ewant = _jax_layer(econv, jnp.asarray(x), seed=38)
    eport = load_port(layers.EqualConv2d(6, 5, 3, stride=2, padding=1), evars)
    fir_want = jlayers.downsample_fir(jnp.asarray(x), (1, 3, 3, 1))
    with torch.no_grad():
        got, egot = port(to_nchw(x)), eport(to_nchw(x))
        fir = layers.downsample_fir(to_nchw(x), (1, 3, 3, 1))
    assert to_nhwc(got).shape == (B, 4, 4, 10)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(to_nhwc(egot), np.asarray(ewant), **LAYER_TOL)
    assert to_nhwc(fir).shape == (B, 4, 4, 6)
    np.testing.assert_allclose(to_nhwc(fir), np.asarray(fir_want), **LAYER_TOL)


def test_styled_conv_with_noise_matches_jax():
    x, style, noise = _rand((B, 8, 8, 16), 3), _rand((B, 512), 4), _rand((1, 16, 16, 1), 5)
    module = JaxStyledConv(8, 3, upsample=True)
    variables = random_variables(jax.eval_shape(
        lambda: module.init(KEY, jnp.asarray(x), jnp.asarray(style), jnp.asarray(noise))), 6)
    assert np.all(variables["params"]["noise"]["weight"] != 0)
    want = module.apply(variables, jnp.asarray(x), jnp.asarray(style), jnp.asarray(noise))
    port = load_port(StyledConv(16, 8, upsample=True), variables)
    with torch.no_grad():
        got = port(to_nchw(x), torch.tensor(style), to_nchw(noise))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **LAYER_TOL)


def test_to_rgb_with_skip_matches_jax():
    x, style, skip = _rand((B, 16, 16, 8), 7), _rand((B, 512), 8), _rand((B, 8, 8, 3), 9)
    variables, want = _jax_layer(JaxToRGB(), jnp.asarray(x), jnp.asarray(style),
                                 jnp.asarray(skip), seed=10)
    port = load_port(ToRGB(8), variables)
    with torch.no_grad():
        got = port(to_nchw(x), torch.tensor(style), to_nchw(skip))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("out_hw", [(16, 12), (5, 7)])
def test_resize_bilinear_matches_jax(align_corners, out_hw):
    """Both conventions, up and down (the E4E pyramid upsamples with
    align_corners=True)."""
    x = _rand((B, 8, 6, 4), 17)
    want = jax_resize_bilinear(jnp.asarray(x), *out_hw, align_corners=align_corners)
    got = resize_bilinear(to_nchw(x), *out_hw, align_corners=align_corners)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **LAYER_TOL)


@pytest.fixture(scope="module")
def psp():
    """JAX PSP(32) variables (every submodule, through PSP.init_all on a
    64-px input) and the port PSP with them loaded."""
    jpsp = JaxPSP(stylegan_size=SIZE)
    x0 = jnp.zeros((1, 64, 64, 3))
    variables = random_variables(jax.eval_shape(
        lambda: jpsp.init(KEY, x0, method=JaxPSP.init_all)), 11)
    return jpsp, variables, load_port(PSP(SIZE, device="cpu"), variables)


def _sub(variables, name):
    return {col: tree[name] for col, tree in variables.items() if name in tree}


def test_generator_and_style_mlp_match_jax(psp):
    """The generator alone, on its subtree of the PSP variables: the w-code
    forward with the fixed noise buffers, and the style MLP."""
    _, variables, port_psp = psp
    gvars = _sub(variables, "decoder")
    jgen = JaxGenerator(SIZE, 512, 8, channel_multiplier=2)
    port = load_port(Generator(SIZE, device="cpu"), gvars)
    codes = _rand((B, jgen.n_latent, 512), 12) * 0.5
    z = _rand((4, 512), 13)
    want, _ = jgen.apply(gvars, [jnp.asarray(codes)], input_is_latent=True,
                         randomize_noise=False)
    want_w = jgen.apply(gvars, jnp.asarray(z), method=JaxGenerator.run_style)
    with torch.no_grad():
        got, latents = port([torch.tensor(codes)], input_is_latent=True, randomize_noise=False)
        got_w = port.run_style(torch.tensor(z))
    assert latents is None
    assert to_nhwc(got).shape == (B, SIZE, SIZE, 3)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **GEN_TOL)
    # 8 equalized layers, w of O(1)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **GEN_TOL)
    assert float(np.abs(np.asarray(want_w)).mean()) > 0.1


def test_encoder_matches_jax(psp):
    _, variables, _ = psp
    evars = _sub(variables, "encoder")
    x = _rand((B, 64, 64, 3), 14)
    want = JaxE4E(SIZE).apply(evars, jnp.asarray(x))
    port = load_port(Encoder4Editing(SIZE, device="cpu"), evars)
    with torch.no_grad():
        got = port(to_nchw(x))
    assert got.shape == (B, 8, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENC_TOL)


def test_psp_encode_decode_style_match_jax(psp):
    jpsp, variables, port = psp
    x = _rand((B, 64, 64, 3), 15)
    codes = jpsp.apply(variables, jnp.asarray(x), method=JaxPSP.encode)
    images = jpsp.apply(variables, codes, method=JaxPSP.decode)
    z = _rand((3, 512), 16)
    w = jpsp.apply(variables, jnp.asarray(z), method=JaxPSP.style)
    with torch.no_grad():
        got_codes = port.encode(to_nchw(x))
        got_images = port.decode(torch.tensor(np.asarray(codes)))
        got_w = port.style(torch.tensor(z))
    np.testing.assert_allclose(got_codes.numpy(), np.asarray(codes), **ENC_TOL)
    assert to_nhwc(got_images).shape == (B, 256, 256, 3)
    np.testing.assert_allclose(to_nhwc(got_images), np.asarray(images), **GEN_TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(w), **GEN_TOL)


@pytest.fixture(scope="module")
def generator_pair():
    """A 32-px JAX generator's variables (style MLP included) and the port
    generator with them loaded."""
    jgen = JaxGenerator(SIZE, 512, 8, channel_multiplier=2)
    z = jnp.zeros((1, 512))
    variables = random_variables(jax.eval_shape(
        lambda: jgen.init(KEY, [z], randomize_noise=False)), 40)
    return jgen, variables, load_port(Generator(SIZE, device="cpu"), variables)


def test_generator_options_match_jax(generator_pair):
    """mean_latent (JAX's draws replayed), z codes through the style MLP
    truncated towards it, two styles mixed at inject_index 3, fresh noise
    from JAX's keys replayed in layer order, a weights_delta on the first
    block's up-convolution and the latents returned; and the refusals of
    mixing without inject_index and of randomize_noise without draws."""
    jgen, variables, port = generator_pair
    key = jax.random.PRNGKey(41)
    mean = jgen.apply(variables, key, 64, method=JaxGenerator.mean_latent)
    z_mean = np.asarray(jax.random.normal(key, (64, 512)))
    z1, z2 = _rand((B, 512), 42), _rand((B, 512), 43)
    noise_key = jax.random.PRNGKey(44)
    keys = jax.random.split(noise_key, jgen.num_layers)
    noise = [to_nchw(jax.random.normal(keys[i], (B, 2 ** ((i + 5) // 2),
                                                 2 ** ((i + 5) // 2), 1)))
             for i in range(jgen.num_layers)]
    deltas = [None] * (jgen.num_layers + jgen.log_size - 1)
    delta = 0.2 * _rand((B, 3, 3, 512, 512), 45)
    deltas[2] = jnp.asarray(delta)
    want, want_latent = jgen.apply(
        variables, [jnp.asarray(z1), jnp.asarray(z2)], inject_index=3, truncation=0.7,
        truncation_latent=mean, noise_key=noise_key, weights_deltas=deltas,
        return_latents=True)
    with torch.no_grad():
        got_mean = port.mean_latent(64, [torch.tensor(z_mean)])
        got, latent = port([torch.tensor(z1), torch.tensor(z2)], inject_index=3,
                           truncation=0.7, truncation_latent=got_mean, noise_draws=noise,
                           weights_deltas=[None, None, _delta_nchw(delta)]
                           + [None] * (len(deltas) - 3), return_latents=True)
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(mean), **GEN_TOL)
    np.testing.assert_allclose(latent.numpy(), np.asarray(want_latent), **GEN_TOL)
    assert to_nhwc(got).shape == (B, SIZE, SIZE, 3)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **GEN_TOL)
    with pytest.raises(ValueError, match="inject_index"):
        port([torch.tensor(z1), torch.tensor(z2)], randomize_noise=False)
    with pytest.raises(ValueError, match="noise_draws"):
        port([torch.tensor(z1)])
    assert len(port.make_noise(torch.Generator().manual_seed(0))) == jgen.num_layers


DISC_SIZE = 16  # two ResBlocks, 512 channels; XLA:CPU's float64 convolutions are slow
# float64 against float64: the same function, rounding apart
F64_RTOL = 1e-10


@pytest.fixture(scope="module")
def discriminator_pair():
    jdisc = JaxDiscriminator(DISC_SIZE)
    variables = random_variables(jax.eval_shape(
        lambda: jdisc.init(KEY, jnp.zeros((4, DISC_SIZE, DISC_SIZE, 3)))), 46)
    return jdisc, variables, load_port(Discriminator(DISC_SIZE, device="cpu"), variables)


class _Branches:
    """Records each leaky ReLU's branch (input > 0) of a run in call order;
    `replay` makes a later run take those branches, counting the elements
    whose own sign would have chosen the other one. A float32 and a float64
    run take different slopes where an input lies within rounding of 0 (as
    the A-VAE's do, tests/test_torch_competitor_train.py), and the gradient
    then differs by that element's share; on one run's branches the two
    differ by rounding alone."""

    def __init__(self, monkeypatch):
        self.masks, self.replay, self.changed = [], None, 0
        fused, scaled = layers.fused_leaky_relu, layers.scaled_leaky_relu
        monkeypatch.setattr(layers, "fused_leaky_relu",
                            lambda x, bias: self._pick(fused(x, bias), x + bias.view(
                                1, -1, *([1] * (x.dim() - 2)))))
        monkeypatch.setattr(layers, "scaled_leaky_relu", lambda x: self._pick(scaled(x), x))

    def _pick(self, y, pre):
        sign = pre.detach() > 0
        if self.replay is None:
            self.masks.append(sign)
            return y
        mask = next(self.replay)
        self.changed += int((mask != sign).sum())
        return torch.where(mask, pre, 0.2 * pre) * np.sqrt(2.0)


@pytest.mark.usefixtures("no_onednn", "one_torch_thread")
def test_discriminator_forward_and_input_gradient_match_jax(discriminator_pair, monkeypatch):
    """Batch 4 (one stddev group): the logits; the input gradient of their
    sum in float64 against JAX's float64 (the same function), and in float32
    within twice JAX's own float32-vs-float64 distance of the float64
    gradient taken on the float32 run's leaky-ReLU branches (JAX jitted once
    in each dtype). oneDNN is off: its float32 convolutions round twice as
    far from float64 as XLA's and torch's plain ones do (1.7e-6 against
    8.5e-7 here). One torch thread: torch's plain CPU convolutions on every
    core of every test worker at once took this test from 16 s alone to
    15 minutes in the whole suite."""
    jdisc, variables, port = discriminator_pair
    x = np.random.RandomState(47).rand(4, DISC_SIZE, DISC_SIZE, 3).astype(np.float32) * 2 - 1
    logits = jax.jit(jdisc.apply)(variables, jnp.asarray(x))
    jgrad = jax.jit(jax.grad(lambda v, inp: jdisc.apply(v, inp).sum(), argnums=1))
    want = np.asarray(jgrad(variables, jnp.asarray(x)))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        want64 = np.asarray(jgrad(v64, jnp.asarray(x.astype(np.float64))))
    assert want64.dtype == np.float64

    def port_grad(module, dtype):
        xt = to_nchw(x).to(dtype).requires_grad_(True)
        out = module(xt)
        out.sum().backward()
        return out.detach(), to_nhwc(xt.grad)

    branches = _Branches(monkeypatch)
    got, grad32 = port_grad(port, torch.float32)
    port64 = copy.deepcopy(port).double()
    _, grad64 = port_grad(port64, torch.float64)
    branches.replay = iter(branches.masks)
    _, grad64_on_branches = port_grad(port64, torch.float64)
    assert got.shape == (4, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), **GEN_TOL)
    gap, err64 = rel_err(want, want64), rel_err(grad64, want64)
    err = rel_err(grad32, grad64_on_branches)
    print(f"port float64 vs JAX float64 {err64:.3e}; JAX float32 vs float64 {gap:.3e}; "
          f"port float32 vs float64 {rel_err(grad32, grad64):.3e}, on its branches {err:.3e}"
          f"({branches.changed} branches changed)")
    assert err64 <= F64_RTOL
    assert 0 < gap < 1e-2
    assert err <= 2 * gap, (err, gap)
