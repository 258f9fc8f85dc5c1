"""The rest of the port's defense layer against the JAX package on the CPU:
the gaussian blur (separable, reflect-padded, kornia's normalization) and
the reference's kernel-size formula; the bare classifier; the two ablations
(L2-ball noise, blur); and MLVGMDefense's input blur, `preds_only=False` and
`get_purified`, on both EoT routes. The classifier is the cars one (a
one-block-per-stage ResNeXt at 128 px, random variables from a numpy seed);
MLVGMDefense runs a small elementwise purifier written twice, so these tests
hold the defense layer itself, not a generator. Input noise is drawn by
numpy and replayed on both sides."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from gen_adversarial_tpu.defenses.ablations import GaussianBlurDefense as JaxBlurDefense
from gen_adversarial_tpu.defenses.ablations import GaussianNoiseDefense as JaxNoiseDefense
from gen_adversarial_tpu.defenses.base import ClassifierDefense as JaxClassifierDefense
from gen_adversarial_tpu.defenses.base import MLVGMDefense as JaxDefense
from gen_adversarial_tpu.defenses.base import blur_kernel_size as jax_blur_kernel_size
from gen_adversarial_tpu.defenses.base import make_classifier_apply as jax_classifier_apply
from gen_adversarial_tpu.defenses.eot import eot_wrap as jax_eot_wrap
from gen_adversarial_tpu.defenses.purify import _compose
from gen_adversarial_tpu.models.classifiers import ResNetBackbone as JaxResNet
from gen_adversarial_tpu.ops.blur import gaussian_blur2d as jax_gaussian_blur2d
from gen_adversarial_tpu_torch.defenses.ablations import (
    GaussianBlurDefense, GaussianNoiseDefense)
from gen_adversarial_tpu_torch.defenses.base import (
    ClassifierDefense, MLVGMDefense, blur_kernel_size, make_classifier_apply)
from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.models.classifiers import ResNetBackbone
from gen_adversarial_tpu_torch.ops.blur import gaussian_blur2d
from tests.torch_port_helpers import keyed_normal_call, load_port, random_variables

KEY = jax.random.PRNGKey(0)
B = 2
IMAGE = 128
N_CLASSES = 4
# the blur: 2 x 31 float32 products per output in another order
BLUR_TOL = dict(rtol=1e-5, atol=1e-6)
# blur, noise, the elementwise purifier, then ~17 float32 convolution layers;
# logits O(1)
DEFENSE_TOL = dict(rtol=1e-4, atol=1e-5)


def _images(seed, b=B, size=IMAGE):
    x = np.random.RandomState(seed).rand(b, size, size, 3).astype(np.float32)
    x[0, 0, :4] = [[-0.2, 0.5, 1.3]] * 4  # out of the box: the clamp matters
    return x


@pytest.mark.parametrize("h,k", [(32, 3), (64, 15), (128, 31), (256, 255)])
def test_blur_kernel_size_keeps_the_reference_formula(h, k):
    assert blur_kernel_size(h) == jax_blur_kernel_size(h) == k


@pytest.mark.parametrize("size,k", [(IMAGE, 31), (12, 4)])
def test_gaussian_blur_matches_jax(size, k):
    """The cars kernel (31 at 128 px), and an even size, whose window kornia
    shifts by half a sample and pads (k - 1) // 2 before, k // 2 after."""
    x = _images(1, size=size)
    want = jax_gaussian_blur2d(jnp.asarray(x), k, 1.0)
    got = gaussian_blur2d(torch.tensor(x), k, 1.0)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLUR_TOL)


@pytest.fixture(scope="module")
def clf():
    """The JAX and port one-block-per-stage ResNeXt, same weights, with the
    0.5 / 0.5 classifier normalization."""
    jclf = JaxResNet(n_classes=N_CLASSES, layers=(1, 1, 1, 1), groups=32, base_width=4)
    variables = random_variables(jax.eval_shape(
        lambda: jclf.init(KEY, jnp.zeros((1, IMAGE, IMAGE, 3)), train=False)), 2)
    port = load_port(ResNetBackbone(N_CLASSES, layers=(1, 1, 1, 1), groups=32, base_width=4,
                                    device="cpu"), variables)
    return dict(jvars=variables, japply=jax_classifier_apply(jclf), port=port,
                tapply=make_classifier_apply(port))


def _check(want, got, purified_want=None, purified_got=None):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEFENSE_TOL)
    if purified_want is not None:
        assert purified_got.dtype == torch.float32
        np.testing.assert_allclose(purified_got.numpy(), np.asarray(purified_want),
                                   **DEFENSE_TOL)


def test_classifier_defense_matches_jax(clf):
    x = _images(3)
    jdef = JaxClassifierDefense(clf["jvars"], clf["japply"])
    want, purified = jdef(KEY, jnp.asarray(x), preds_only=False)
    tdef = ClassifierDefense(clf["port"], clf["tapply"])
    with torch.no_grad():
        got, got_purified = tdef(torch.tensor(x), preds_only=False)
        _check(want, tdef(torch.tensor(x)), purified, got_purified)
        _check(want, got)
    np.testing.assert_array_equal(tdef.get_purified(torch.tensor(x)).numpy(), x)


def _replay_normal(monkeypatch, arrays):
    """jax.random.normal returns these numpy arrays, in call order."""
    it = iter(arrays)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(next(it), dtype))


def test_gaussian_noise_defense_matches_jax(clf, monkeypatch):
    """eps 4.0 (gender and cars): logits, the purified image, get_purified."""
    x = _images(4)
    noise = np.random.RandomState(5).standard_normal(x.shape).astype(np.float32)
    _replay_normal(monkeypatch, [noise, noise])
    jdef = JaxNoiseDefense(clf["jvars"], clf["japply"], eps=4.0)
    want, purified = jdef(KEY, jnp.asarray(x), preds_only=False)
    want_purified = jdef.get_purified(KEY, jnp.asarray(x))
    tdef = GaussianNoiseDefense(clf["port"], clf["tapply"], eps=4.0)
    with torch.no_grad():
        got, got_purified = tdef(torch.tensor(x), [torch.tensor(noise)], preds_only=False)
    _check(want, got, purified, got_purified)
    np.testing.assert_allclose(tdef.get_purified(torch.tensor(x), [torch.tensor(noise)]),
                               np.asarray(want_purified), **DEFENSE_TOL)


def test_gaussian_noise_defense_under_eot_folds_its_draws(clf):
    """The EoT wrapper folds 2 draws into the batch: its mean equals the mean
    of the two single calls with the same draws."""
    x = torch.tensor(_images(6))
    noise = torch.tensor(np.random.RandomState(7).standard_normal(
        (2 * B, IMAGE, IMAGE, 3)).astype(np.float32))
    tdef = GaussianNoiseDefense(clf["port"], clf["tapply"], eps=4.0)
    with torch.no_grad():
        got = eot_wrap(tdef, eot_steps=2)(x, [noise])
        want = (tdef(x, [noise[:B]]) + tdef(x, [noise[B:]])) / 2
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_gaussian_blur_defense_matches_jax(clf):
    """image_size 128: the 31-tap kernel."""
    x = _images(8)
    jdef = JaxBlurDefense(clf["jvars"], clf["japply"], image_size=IMAGE)
    want, purified = jdef(KEY, jnp.asarray(x), preds_only=False)
    tdef = GaussianBlurDefense(clf["port"], clf["tapply"], image_size=IMAGE)
    with torch.no_grad():
        got, got_purified = tdef(torch.tensor(x), preds_only=False)
    _check(want, got, purified, got_purified)
    np.testing.assert_allclose(tdef.get_purified(torch.tensor(x)).numpy(),
                               np.asarray(purified), **DEFENSE_TOL)


SCALE = 0.9  # the small purifier: encode x * SCALE, decode tanh(state) * alphas[0]


def _blur_pair(clf, noise_eps):
    """The JAX and the port MLVGMDefense with the input blur of a 128-px
    image, normalize_before_purify, and the small elementwise purifier."""
    alphas = np.asarray([0.7, 0.2], np.float32)
    enc = lambda v, x: x * v["scale"]
    dec = lambda v, a, key, s: jnp.tanh(s) * a[0]
    jdef = JaxDefense(
        purify_variables={"scale": jnp.float32(SCALE)}, classifier_variables=clf["jvars"],
        alphas=jnp.asarray(alphas), purify_apply=_compose(enc, dec),
        purify_encode_apply=enc, purify_decode_apply=dec, classifier_apply=clf["japply"],
        image_size=IMAGE, initial_noise_eps=noise_eps, apply_blur=True,
        normalize_before_purify=True)
    tdef = MLVGMDefense(
        nn.Identity(), clf["port"], torch.tensor(alphas), lambda x: x * SCALE,
        lambda a, s, draws: torch.tanh(s) * a[0], clf["tapply"],
        initial_noise_eps=noise_eps, normalize_before_purify=True, apply_blur=True,
        image_size=IMAGE)
    return jdef, tdef


@pytest.mark.parametrize("noise_eps", [4.0, 0.0])
def test_mlvgm_defense_blur_and_outputs_match_jax(clf, monkeypatch, noise_eps):
    """Blur (31 taps) before the noise; `preds_only=False` gives (logits,
    purified) in float32, and `get_purified` the purified image; at eps 0.0
    the shared-encode route (purify_state + state_call) gives the same."""
    x = _images(9)
    noise = np.random.RandomState(10).standard_normal(x.shape).astype(np.float32)
    _replay_normal(monkeypatch, [noise] * 2 if noise_eps > 0 else [])
    jdef, tdef = _blur_pair(clf, noise_eps)
    want, purified = jdef(KEY, jnp.asarray(x), preds_only=False)
    want_purified = jdef.get_purified(KEY, jnp.asarray(x))
    draws = [torch.tensor(noise)] if noise_eps > 0 else []
    with torch.no_grad():
        got, got_purified = tdef(torch.tensor(x), draws, preds_only=False)
        _check(want, got, purified, got_purified)
        np.testing.assert_allclose(tdef.get_purified(torch.tensor(x), list(draws)).numpy(),
                                   np.asarray(want_purified), **DEFENSE_TOL)
        if noise_eps == 0:
            state = tdef.purify_state(torch.tensor(x))
            logits, shared = tdef.state_call(state, [], preds_only=False)
            _check(want, logits, purified, shared)


def test_mlvgm_defense_with_blur_under_eot_matches_jax(clf):
    """EoT-2 at eps 4.0 with the input blur: the JAX vmap over keys against
    the port's folded batch, the draws replayed by key."""
    x = _images(11)
    rng = np.random.RandomState(12)
    noise = [rng.standard_normal(x.shape).astype(np.float32) for _ in range(2)]
    key = jax.random.PRNGKey(13)
    # the small purifier draws nothing: each EoT draw asks for its noise only
    jax_call = keyed_normal_call(key, [(n, None) for n in noise])
    jdef, tdef = _blur_pair(clf, 4.0)
    want = jax_call(lambda: jax_eot_wrap(jdef, eot_steps=2)(key, jnp.asarray(x)))
    with torch.no_grad():
        got = eot_wrap(tdef, eot_steps=2)(torch.tensor(x), [torch.tensor(np.concatenate(noise))])
    _check(want, got)
