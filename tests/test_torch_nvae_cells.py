"""The port's NVAE building blocks against the JAX package's on the CPU:
distributions, image ops, and the encoder and decoder cells (weights carried
over by gen_adversarial_tpu_torch/core/convert.py). The JAX decoder cell
runs its default formulation (GAT_NVAE_BN_FOLD=1, GAT_NVAE_DW=conv); the
port's unfolded BNs plus the fused segment agree with it by linearity, up to
float32 rounding."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gen_adversarial_tpu.models.nvae import cells as jcells
from gen_adversarial_tpu.models.nvae import distributions as jdist
from gen_adversarial_tpu.ops import image as jimage
from gen_adversarial_tpu_torch.models.nvae import cells as tcells
from gen_adversarial_tpu_torch.models.nvae import distributions as tdist
from gen_adversarial_tpu_torch.ops import image as timage
from tests.torch_port_helpers import load_port, random_variables, to_nchw, to_nhwc

# float32 elementwise math: a few ulps
ELEM_TOL = dict(rtol=1e-6, atol=1e-6)
# float32 convolutions (3x3 / 1x1 / depthwise) summed in another order
CELL_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _jax_cell_defaults(monkeypatch):
    monkeypatch.setenv("GAT_NVAE_BN_FOLD", "1")
    monkeypatch.setenv("GAT_NVAE_DW", "conv")
    monkeypatch.delenv("GAT_NVAE_PW", raising=False)


def test_soft_clamp_and_normal_sample_given_eps():
    rng = np.random.RandomState(0)
    mu, log_sig, eps = (rng.randn(2, 4, 4, 3).astype(np.float32) * 4 for _ in range(3))
    jn = jdist.Normal(jnp.asarray(mu), jnp.asarray(log_sig), temp=0.6)
    tn = tdist.Normal(to_nchw(mu), to_nchw(log_sig), temp=0.6)
    np.testing.assert_allclose(to_nhwc(tn.mu), np.asarray(jn.mu), **ELEM_TOL)
    np.testing.assert_allclose(to_nhwc(tn.sigma), np.asarray(jn.sigma), **ELEM_TOL)
    np.testing.assert_allclose(to_nhwc(tn.sample_given_eps(to_nchw(eps))),
                               np.asarray(jn.sample_given_eps(jnp.asarray(eps))),
                               **ELEM_TOL)
    sample, drawn = tn.sample(tdist.Draws([to_nchw(eps)]))
    np.testing.assert_array_equal(to_nhwc(drawn), eps)
    np.testing.assert_allclose(to_nhwc(sample), np.asarray(jn.sample_given_eps(jnp.asarray(eps))),
                               **ELEM_TOL)


def test_draws_replay_checks_shapes_and_exhaustion():
    like = torch.zeros(1)
    draws = tdist.Draws([torch.zeros(2, 3)])
    with pytest.raises(ValueError):
        draws.normal((3, 2), like)
    with pytest.raises(ValueError):
        draws.normal((2, 3), like)
    gen_draw = tdist.Draws(torch.Generator().manual_seed(0)).normal((2, 3), like)
    assert gen_draw.shape == (2, 3)


def test_disc_mix_logistic_mean_channel_packing():
    """The '(n c)' packing: M logits, then 9 values per mixture."""
    m = 4
    params = np.random.RandomState(1).randn(2, 5, 6, m + 9 * m).astype(np.float32) * 2
    want = jdist.DiscMixLogistic(jnp.asarray(params)).mean()
    got = tdist.DiscMixLogistic(to_nchw(params)).mean()
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **CELL_TOL)


def test_clamp01_forward_and_tie_gradient():
    x = np.array([-0.5, 0.0, 0.3, 1.0, 1.5], np.float32)
    want, vjp = jax.vjp(jimage.clamp01, jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    got = timage.clamp01(t)
    got.backward(torch.ones(5))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(vjp(jnp.ones(5))[0]))


def test_bilinear_align_corners_and_adaptive_pool():
    x = np.random.RandomState(2).randn(2, 5, 7, 3).astype(np.float32)
    want = jimage.resize_bilinear(jnp.asarray(x), 10, 14, align_corners=True)
    np.testing.assert_allclose(to_nhwc(timage.upsample_bilinear2x(to_nchw(x))),
                               np.asarray(want), **CELL_TOL)
    small = x[:, :2, :2]
    want = jimage.adaptive_avg_pool_general(jnp.asarray(small), 7, 7)
    np.testing.assert_allclose(to_nhwc(timage.adaptive_avg_pool_general(to_nchw(small), 7, 7)),
                               np.asarray(want), **ELEM_TOL)


def _compare(jmod, tmod, inputs, seed):
    jin = [jnp.asarray(a) for a in inputs]
    variables = random_variables(
        jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jin)), seed)
    want = jmod.apply(variables, *jin)
    tmod = load_port(tmod, variables)
    with torch.no_grad():
        got = tmod(*[to_nchw(a) for a in inputs])
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **CELL_TOL)


@pytest.mark.parametrize("downsampling", [False, True])
def test_encoder_cell(downsampling):
    cin, cout = 16, 32 if downsampling else 16
    x = np.random.RandomState(3).randn(2, 8, 8, cin).astype(np.float32)
    _compare(jcells.ResidualCellEncoder(cout, downsampling=downsampling, use_se=True),
             tcells.ResidualCellEncoder(cin, cout, downsampling, True, device="cpu"),
             [x], seed=4 + downsampling)


@pytest.mark.parametrize("upsampling,hidden_mul,use_se", [
    (False, 6, True), (True, 6, True), (True, 3, True), (False, 3, False)])
def test_decoder_cell(upsampling, hidden_mul, use_se):
    cin = 16
    cout = cin // 2 if upsampling else cin
    x = np.random.RandomState(5).randn(2, 8, 8, cin).astype(np.float32)
    _compare(jcells.ResidualCellDecoder(cin, cout, upsampling=upsampling, use_se=use_se,
                                        hidden_mul=hidden_mul),
             tcells.ResidualCellDecoder(cin, cout, upsampling, use_se, hidden_mul,
                                        device="cpu"),
             [x], seed=6)


def test_decoder_cell_input_gradient():
    """The cell's input gradient, through the segment's autograd backward."""
    cin = 16
    x = np.random.RandomState(7).randn(2, 8, 8, cin).astype(np.float32)
    jmod = jcells.ResidualCellDecoder(cin, cin, upsampling=False, use_se=True)
    variables = random_variables(
        jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))), 8)
    want = jax.grad(lambda a: jnp.sum(jmod.apply(variables, a) ** 2))(jnp.asarray(x))
    tmod = load_port(tcells.ResidualCellDecoder(cin, cin, False, True, device="cpu"),
                     variables)
    tx = to_nchw(x).requires_grad_()
    (tmod(tx) ** 2).sum().backward()
    np.testing.assert_allclose(to_nhwc(tx.grad), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_combiner_cells():
    rng = np.random.RandomState(9)
    a, b = (rng.randn(2, 4, 4, 8).astype(np.float32) for _ in range(2))
    z = rng.randn(2, 4, 4, 3).astype(np.float32)
    _compare(jcells.EncCombinerCell(8), tcells.EncCombinerCell(8, 8, device="cpu"),
             [a, b], seed=10)
    _compare(jcells.DecCombinerCell(8), tcells.DecCombinerCell(11, 8, device="cpu"),
             [a, z], seed=11)
