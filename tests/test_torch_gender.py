"""The port's gender slice against the JAX package on the CPU: ResNet50 with
the projector head, and the gender defense end to end (MLVGMDefense with
normalize_before_purify + the E4E purify split + EoT) at a reduced size:
a 32-px generator (full-width IR-SE-50 encoder, 8 styles) on 64-px images,
a one-block-per-stage ResNet, EoT-4, batch 2. The input noise and the E4E
mix noise are drawn by numpy and replayed on both sides, as
tests/test_torch_slice.py replays the NVAE eps; and the defense's input
gradient (torch.func.vjp against jax.vjp, with a bound measured from JAX's
own float32-vs-float64 gap). Also: the 18 alphas against the YAML config,
and a CPU rehearsal of the factory."""

import copy
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import vjp

from gen_adversarial_tpu.core.config import DefenseConfig
from gen_adversarial_tpu.core.precision import defense_astype as jax_defense_astype
from gen_adversarial_tpu.defenses.base import MLVGMDefense as JaxDefense
from gen_adversarial_tpu.defenses.base import make_classifier_apply as jax_classifier_apply
from gen_adversarial_tpu.defenses.eot import eot_wrap as jax_eot_wrap
from gen_adversarial_tpu.defenses.purify import _compose
from gen_adversarial_tpu.defenses.purify import make_e4e_purify_split as jax_split
from gen_adversarial_tpu.models.classifiers import ResNet50 as JaxResNet50
from gen_adversarial_tpu.models.classifiers import ResNetBackbone as JaxResNet
from gen_adversarial_tpu.models.e4e.psp import PSP as JaxPSP
from gen_adversarial_tpu_torch.core.precision import defense_astype
from gen_adversarial_tpu_torch.defenses.base import MLVGMDefense, make_classifier_apply
from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.defenses.purify import make_e4e_purify_split
from gen_adversarial_tpu_torch.gender import GENDER_ALPHAS, gender_alphas, gender_defense
from gen_adversarial_tpu_torch.models.classifiers import ResNet50, ResNetBackbone
from gen_adversarial_tpu_torch.models.e4e.psp import PSP
from gen_adversarial_tpu_torch.ops import upfirdn as k2
from tests.torch_port_helpers import (
    keyed_normal_call, load_port, random_variables, rel_err, to_nchw)

REPO = Path(__file__).resolve().parent.parent
SIZE = 32
IMAGE = 64
B = 2
KEY = jax.random.PRNGKey(0)
SMALL_LAYERS = (1, 1, 1, 1)
# ResNet50: ~50 float32 convolution layers in another summation order,
# logits O(1)
CLF_TOL = dict(rtol=1e-4, atol=1e-5)
# the defense: encoder (~60 layers), generator, ResNet, then an EoT mean
DEFENSE_TOL = dict(rtol=1e-4, atol=1e-5)


def _images(seed, size=IMAGE):
    x = np.random.RandomState(seed).rand(B, size, size, 3).astype(np.float32)
    x[0, 0, :4] = [[-0.2, 0.5, 1.3]] * 4  # out of the box: the clamp matters
    return x


def test_resnet50_matches_jax():
    x = np.random.RandomState(1).randn(B, IMAGE, IMAGE, 3).astype(np.float32)
    jclf = JaxResNet50(n_classes=2)
    variables = random_variables(jax.eval_shape(
        lambda: jclf.init(KEY, jnp.asarray(x), train=False)), 2)
    want = jclf.apply(variables, jnp.asarray(x), train=False)
    port = load_port(ResNet50(2, device="cpu"), variables)
    with torch.no_grad():
        got = port(to_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLF_TOL)


@pytest.fixture(scope="module")
def models():
    return build_models()


def build_models():
    """JAX and port PSP(32) + a one-block-per-stage ResNet, same weights."""
    jpsp = JaxPSP(stylegan_size=SIZE)
    psp_vars = random_variables(jax.eval_shape(
        lambda: jpsp.init(KEY, jnp.zeros((1, IMAGE, IMAGE, 3)), method=JaxPSP.init_all)), 3)
    jclf = JaxResNet(n_classes=2, layers=SMALL_LAYERS)
    clf_vars = random_variables(jax.eval_shape(
        lambda: jclf.init(KEY, jnp.zeros((1, 256, 256, 3)), train=False)), 4)
    return dict(jpsp=jpsp, psp_vars=psp_vars, jclf=jclf, clf_vars=clf_vars,
                tpsp=load_port(PSP(SIZE, device="cpu"), psp_vars),
                tclf=load_port(ResNetBackbone(2, layers=SMALL_LAYERS, device="cpu"), clf_vars),
                alphas=gender_alphas(8))


def _gender_pair(models, noise_eps, chunk, eot=4, float64=False, bf16=False):
    """The JAX and the port gender defense (MLVGMDefense + the E4E split +
    eot_wrap, normalize_before_purify) with the same numpy draws. JAX draws
    inside a vmap over keys, so `jax_call(fn)` runs fn with jax.random.normal
    looking the draw's key up in a table of the numpy draws
    (keyed_normal_call); the port replays
    the same draws folded into its batch, draw-major (the mix noise
    (n_codes, B, 512) on its batch axis 1), chunk by chunk. `float64` gives
    the JAX side float64 variables (build and call it inside
    jax.enable_x64(True)). `bf16` casts both defenses with their package's
    defense_astype (the port's on copies of its modules). Returns
    (jax_net(defense, x), the JAX defense,
    jax_call, port_net(x)): jax_net takes the defense as an argument, so a
    jit of it compiles the weights as inputs, not as constants."""
    n_codes = 8
    rng = np.random.RandomState(6)
    noise = [rng.standard_normal((B, IMAGE, IMAGE, 3)).astype(np.float32) for _ in range(eot)]
    mix = [rng.standard_normal((n_codes, B, 512)).astype(np.float32) for _ in range(eot)]
    key = jax.random.PRNGKey(7)
    jax_call = keyed_normal_call(key, [(noise[d], mix[d]) for d in range(eot)])

    cast = (lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)) if float64 else (
        lambda t: t)
    enc, dec = jax_split(models["jpsp"])
    jdef = JaxDefense(
        purify_variables=cast(models["psp_vars"]),
        classifier_variables=cast(models["clf_vars"]),
        alphas=jnp.asarray(cast(models["alphas"])), purify_apply=_compose(enc, dec),
        purify_encode_apply=enc, purify_decode_apply=dec,
        classifier_apply=jax_classifier_apply(models["jclf"]), image_size=IMAGE,
        initial_noise_eps=noise_eps, normalize_before_purify=True)
    if bf16:
        jdef = jax_defense_astype(jdef)

    per = chunk or eot
    draws = []
    for c0 in range(0, eot, per):
        ds = range(c0, c0 + per)
        if noise_eps > 0:
            draws.append(np.concatenate([noise[d] for d in ds]))
        draws.append(np.concatenate([mix[d] for d in ds], axis=1))
    tpsp, tclf = models["tpsp"], models["tclf"]
    tenc, tdec = make_e4e_purify_split(tpsp)
    tdef = MLVGMDefense(
        tpsp, tclf, torch.tensor(models["alphas"]), tenc, tdec,
        make_classifier_apply(tclf), initial_noise_eps=noise_eps,
        normalize_before_purify=True)
    if bf16:  # a cast copy: the float32 modules stay the fixture's
        tdef = defense_astype(copy.deepcopy(tdef))
    tnet = eot_wrap(tdef, eot_steps=eot, chunk=chunk)
    return ((lambda d, x: jax_eot_wrap(d, eot_steps=eot, chunk=chunk)(key, x)), jdef,
            jax_call, (lambda x: tnet(x, [torch.tensor(d) for d in draws])))


@pytest.mark.parametrize("noise_eps,chunk", [(4.0, None), (0.0, None), (4.0, 2)])
def test_gender_defense_matches_jax(models, noise_eps, chunk):
    """MLVGMDefense + the E4E split + eot_wrap, EoT 4, every draw made by
    numpy on both sides (see _gender_pair)."""
    jnet, jdef, jax_call, tnet = _gender_pair(models, noise_eps, chunk)
    x = _images(5)
    want = jax_call(lambda: jax.jit(jnet)(jdef, jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(torch.tensor(x))
    assert np.all(np.isfinite(np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEFENSE_TOL)


def test_gender_defense_input_gradient_matches_jax(models):
    """The input gradient of the EoT-4 gender defense (eps 4.0) under a
    numpy-seeded cotangent on the logits: torch.func.vjp through the port
    (K2's autograd Function inside) against jax.vjp. With random weights this
    gradient is ill-conditioned in float32 (the logits agree to 1e-7, the
    gradient does not), so the bound is measured here: the JAX package's own
    float32 result against its float64 result on the same weights and draws
    (jax.enable_x64 as a context, never the global flag). If the port's
    float32 is no farther from float64 than JAX's, the two float32 results
    differ by at most twice that gap."""
    x = _images(5)
    g = np.random.RandomState(9).randn(B, 2).astype(np.float32)

    def jax_grad(float64):
        jnet, jdef, jax_call, _ = _gender_pair(models, 4.0, None, float64=float64)
        # the defense returns float32 logits either way (its last cast)
        xs = jnp.asarray(x.astype(np.float64 if float64 else np.float32))
        grad = jax.jit(lambda d, v, c: jax.vjp(lambda u: jnet(d, u), v)[1](c)[0])
        return np.asarray(jax_call(lambda: grad(jdef, xs, jnp.asarray(g))))

    want = jax_grad(False)
    with jax.enable_x64(True):
        want64 = jax_grad(True)
    assert want64.dtype == np.float64
    gap = rel_err(want, want64)
    *_, tnet = _gender_pair(models, 4.0, None)
    _, vjp_fn = vjp(tnet, torch.tensor(x))
    (got,) = vjp_fn(torch.tensor(g))
    assert np.all(np.isfinite(want)) and np.abs(want).max() > 0
    err = rel_err(got.detach().numpy(), want)
    print(f"JAX float32 vs float64 {gap:.3e}; port vs JAX float32 {err:.3e}; "
          f"port vs JAX float64 {rel_err(got.detach().numpy(), want64):.3e}")
    assert 0 < gap < 1e-2
    assert err <= 2 * gap


def test_gender_alphas_match_the_config():
    cfg = DefenseConfig.from_yaml(REPO / "configs" / "ours_cosine_noise_gender.yaml")
    np.testing.assert_array_equal(
        gender_alphas(), np.asarray(cfg.interpolation_alphas, np.float32)
        * np.float32(cfg.alpha_attenuation))
    assert len(GENDER_ALPHAS) == 18
    assert cfg.initial_noise_eps == 4.0 and not cfg.gaussian_blur_input


def test_gender_rehearsal_at_reduced_size():
    """The factory on the CPU at a 32-px generator and a one-block-per-stage
    ResNet: EoT-2 logits (2, 2), finite; a CPU tensor launches no kernel."""
    defense = gender_defense(device="cpu", stylegan_size=SIZE, classifier_layers=SMALL_LAYERS)
    assert defense.normalize_before_purify and defense.initial_noise_eps == 4.0
    x = torch.rand(B, IMAGE, IMAGE, 3, generator=torch.Generator().manual_seed(0))
    before = k2.launches
    with torch.no_grad():
        logits = eot_wrap(defense, eot_steps=2)(x, torch.Generator().manual_seed(1))
    assert k2.launches == before
    assert logits.shape == (B, 2)
    assert torch.isfinite(logits).all()
