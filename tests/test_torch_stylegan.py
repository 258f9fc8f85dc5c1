"""The port's StyleGAN2 layers and generator, the E4E encoder and the PSP
container against the JAX package on the CPU, on the same random variables
(tests/torch_port_helpers.random_variables) and the same inputs from a numpy
seed: ModulatedConv2d (up-convolution with its K2 blur, and stride 1),
StyledConv with its noise, ToRGB with its skip upsample, the style MLP, a
32-px generator with its fixed noise buffers, and Encoder4Editing /
PSP.encode / PSP.decode at stylegan_size 32 on a 64-px input. At these sizes
the JAX generator keeps its logical layout (its phase-domain top block only
serves blocks of fewer than 128 channels, at 512 px and up); no GAT_*
variable is set.

The port is NCHW, JAX NHWC."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gen_adversarial_tpu.models.e4e.encoder import Encoder4Editing as JaxE4E
from gen_adversarial_tpu.models.e4e.psp import PSP as JaxPSP
from gen_adversarial_tpu.models.stylegan2.generator import Generator as JaxGenerator
from gen_adversarial_tpu.models.stylegan2.layers import ModulatedConv2d as JaxModConv
from gen_adversarial_tpu.models.stylegan2.layers import StyledConv as JaxStyledConv
from gen_adversarial_tpu.models.stylegan2.layers import ToRGB as JaxToRGB
from gen_adversarial_tpu.ops.image import resize_bilinear as jax_resize_bilinear
from gen_adversarial_tpu_torch.models.e4e.encoder import Encoder4Editing
from gen_adversarial_tpu_torch.models.e4e.psp import PSP
from gen_adversarial_tpu_torch.models.stylegan2.generator import Generator
from gen_adversarial_tpu_torch.models.stylegan2.layers import ModulatedConv2d, StyledConv, ToRGB
from gen_adversarial_tpu_torch.ops import upfirdn as k2
from gen_adversarial_tpu_torch.ops.image import resize_bilinear
from tests.torch_port_helpers import load_port, random_variables, to_nchw, to_nhwc

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
        got = port(torch.tensor(codes))
        got_w = port.run_style(torch.tensor(z))
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
