"""The port's Style-Transformer against the JAX package on the CPU, on the
same random variables (tests/torch_port_helpers.random_variables) and the
same inputs from a numpy seed: TorchMHA (packed qkv, 4 heads, queries and
keys of different lengths), the post-norm TransformerDecoderLayer, the
GradualStyleEncoder (full-width IR-SE-50 trunk and pyramid, three decoder
layers) on a 64 x 96 input, and the StyleTransformer container's encode,
decode and style at output_size 32 (8 styles; the JAX decode keeps its
logical layout below 512 px). Also the convert rules for the new leaves.

The port is NCHW, JAX NHWC; tokens are (B, L, 512) on both sides."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gen_adversarial_tpu.models.style_transformer.encoder import (
    GradualStyleEncoder as JaxGradualStyleEncoder)
from gen_adversarial_tpu.models.style_transformer.encoder import TorchMHA as JaxTorchMHA
from gen_adversarial_tpu.models.style_transformer.encoder import (
    TransformerDecoderLayer as JaxDecoderLayer)
from gen_adversarial_tpu.models.style_transformer.model import (
    StyleTransformer as JaxStyleTransformer)
from gen_adversarial_tpu_torch.models.style_transformer.encoder import (
    GradualStyleEncoder, TorchMHA, TransformerDecoderLayer, tokens)
from gen_adversarial_tpu_torch.models.style_transformer.model import StyleTransformer
from tests.torch_port_helpers import load_port, random_variables, to_nchw, to_nhwc

KEY = jax.random.PRNGKey(0)
B = 2
D = 512
SIZE = 32  # 8 styles
# one attention or decoder layer: 512-long float32 dot products in another
# order, outputs O(1)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
# the encoder: ~60 float32 convolution layers (IR-SE-50 and the pyramid),
# then three decoder layers; codes O(1)
ENC_TOL = dict(rtol=1e-4, atol=1e-4)
# the generator: as tests/test_torch_stylegan.py's GEN_TOL
GEN_TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_mha_matches_jax_with_queries_and_keys_of_other_lengths():
    q, kv = _rand((B, 5, D), 0), _rand((B, 12, D), 1)
    module = JaxTorchMHA(num_heads=4)
    args = (jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv))
    variables = random_variables(jax.eval_shape(lambda: module.init(KEY, *args)), 2)
    want = module.apply(variables, *args)
    port = load_port(TorchMHA(device="cpu"), variables)
    with torch.no_grad():
        got = port(torch.tensor(q), torch.tensor(kv), torch.tensor(kv))
    assert got.shape == (B, 5, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_mha_leaves_keep_the_torch_layout():
    """The four attention leaves load unchanged: no Dense transpose."""
    module = JaxTorchMHA(num_heads=4)
    x = jnp.zeros((1, 3, D))
    variables = random_variables(jax.eval_shape(lambda: module.init(KEY, x, x, x)), 3)
    port = load_port(TorchMHA(device="cpu"), variables)
    for name, leaf in variables["params"].items():
        np.testing.assert_array_equal(getattr(port, name).detach().numpy(), leaf)


def test_decoder_layer_matches_jax():
    tgt, memory = _rand((B, 6, D), 4), _rand((B, 20, D), 5)
    module = JaxDecoderLayer()
    args = (jnp.asarray(tgt), jnp.asarray(memory))
    variables = random_variables(jax.eval_shape(lambda: module.init(KEY, *args)), 6)
    want = module.apply(variables, *args)
    port = load_port(TransformerDecoderLayer(device="cpu"), variables)
    with torch.no_grad():
        got = port(torch.tensor(tgt), torch.tensor(memory))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_tokens_are_row_major_over_the_pixels():
    f = _rand((B, 3, 4, 8), 7)  # NHWC
    np.testing.assert_array_equal(tokens(to_nchw(f)).numpy(), f.reshape(B, 12, 8))


def test_gradual_style_encoder_matches_jax():
    """A 64 x 96 input: memories of 6, 24 and 96 tokens."""
    x = np.random.RandomState(8).rand(B, 64, 96, 3).astype(np.float32) * 2 - 1
    query = _rand((B, 8, D), 9)
    module = JaxGradualStyleEncoder(n_styles=8)
    args = (jnp.asarray(x), jnp.asarray(query))
    variables = random_variables(jax.eval_shape(lambda: module.init(KEY, *args)), 10)
    want = module.apply(variables, *args)
    port = load_port(GradualStyleEncoder(8, device="cpu"), variables)
    with torch.no_grad():
        got = port(to_nchw(x), torch.tensor(query))
    assert got.shape == (B, 8, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENC_TOL)


@pytest.fixture(scope="module")
def trans():
    jtrans = JaxStyleTransformer(output_size=SIZE)
    variables = random_variables(jax.eval_shape(
        lambda: jtrans.init(KEY, jnp.zeros((1, 64, 64, 3)))), 11)
    assert variables["buffers"]["latent_avg"].shape == (8, D)
    assert variables["params"]["encoder"]["z"].shape == (1, 8, D)
    return jtrans, variables, load_port(StyleTransformer(SIZE, device="cpu"), variables)


def test_style_transformer_encode_matches_jax(trans):
    jtrans, variables, port = trans
    x = np.random.RandomState(12).rand(B, 64, 96, 3).astype(np.float32) * 2 - 1
    want = jtrans.apply(variables, jnp.asarray(x), method=JaxStyleTransformer.encode)
    with torch.no_grad():
        got = port.encode(to_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENC_TOL)


def test_style_transformer_decode_and_style_match_jax(trans):
    jtrans, variables, port = trans
    codes, z = _rand((B, 8, D), 13) * 0.5, _rand((3, D), 14)
    want = jtrans.apply(variables, jnp.asarray(codes), method=JaxStyleTransformer.decode)
    want_w = jtrans.apply(variables, jnp.asarray(z), method=JaxStyleTransformer.style)
    with torch.no_grad():
        got = port.decode(torch.tensor(codes))
        got_w = port.style(torch.tensor(z))
    assert to_nhwc(got).shape == (B, 256, 256, 3)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **GEN_TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **GEN_TOL)
