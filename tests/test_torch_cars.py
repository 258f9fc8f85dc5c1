"""The port's cars slice against the JAX package on the CPU: ResNeXt50-32x4d
with the projector head (and the grouped-convolution layout rule it needs),
and the cars defense end to end (MLVGMDefense with normalize_before_purify +
the Style-Transformer purify split + EoT) at a reduced size: a 16-px
generator (6 styles; full-width IR-SE-50 encoder, which always sees the
192 x 256 crop of the 256-px resize) on 128-px images, a
one-block-per-stage ResNeXt, EoT-2, batch 2. The input noise and the mix
noise are drawn by numpy and replayed on both sides; and the defense's input
gradient (torch.func.vjp against jax.vjp, with a bound measured from JAX's
own float32-vs-float64 gap). Also: the 16 alphas against the YAML config,
and a CPU rehearsal of the factory."""

import copy
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn
from torch import nn
from torch.func import vjp

from gen_adversarial_tpu.core.config import DefenseConfig
from gen_adversarial_tpu.core.precision import defense_astype as jax_defense_astype
from gen_adversarial_tpu.defenses.base import MLVGMDefense as JaxDefense
from gen_adversarial_tpu.defenses.base import make_classifier_apply as jax_classifier_apply
from gen_adversarial_tpu.defenses.eot import eot_wrap as jax_eot_wrap
from gen_adversarial_tpu.defenses.purify import _compose
from gen_adversarial_tpu.defenses.purify import make_trans_purify_split as jax_split
from gen_adversarial_tpu.models.classifiers import ResNetBackbone as JaxResNet
from gen_adversarial_tpu.models.style_transformer.model import (
    StyleTransformer as JaxStyleTransformer)
from gen_adversarial_tpu_torch.cars import (
    CARS_ALPHAS, IMAGE_SIZE, N_CLASSES, cars_alphas, cars_defense)
from gen_adversarial_tpu_torch.core.precision import defense_astype
from gen_adversarial_tpu_torch.defenses.base import MLVGMDefense, make_classifier_apply
from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.defenses.purify import make_trans_purify_split
from gen_adversarial_tpu_torch.models.classifiers import ResNetBackbone, ResNeXt50
from gen_adversarial_tpu_torch.models.style_transformer.model import StyleTransformer
from gen_adversarial_tpu_torch.ops import upfirdn as k2
from tests.torch_port_helpers import (
    keyed_normal_call, load_port, random_variables, rel_err, to_nchw)

REPO = Path(__file__).resolve().parent.parent
SIZE = 16  # 6 styles: the float64 JAX gradient pays for every generator layer
N_CODES = 6
B = 2
EOT = 2
KEY = jax.random.PRNGKey(0)
SMALL_LAYERS = (1, 1, 1, 1)
# ResNeXt: ~17 float32 convolution layers in another summation order, logits O(1)
CLF_TOL = dict(rtol=1e-4, atol=1e-5)
# the defense: encoder (~60 layers + 3 attention layers), generator, ResNeXt,
# then an EoT mean
DEFENSE_TOL = dict(rtol=1e-4, atol=1e-5)
# the input gradient in float32: how many times JAX's own float32-vs-float64
# gap the port's float32 gradient may lie from JAX's float64 one (measured
# 2.16; see the gradient test)
F32_GAP_FACTOR = 3.0


def _images(seed, b=B):
    x = np.random.RandomState(seed).rand(b, IMAGE_SIZE, IMAGE_SIZE, 3).astype(np.float32)
    x[0, 0, :4] = [[-0.2, 0.5, 1.3]] * 4  # out of the box: the clamp matters
    return x


def test_grouped_conv_kernel_converts_to_the_grouped_torch_layout():
    """A flax kernel of a 4-group convolution, HWIO (3, 3, in/4, out), loads
    as OIHW (out, in/4, 3, 3), the layout nn.Conv2d(groups=4) computes with:
    asymmetric random taps, so a missing flip or a wrong group order shows."""
    x = np.random.RandomState(0).randn(B, 9, 7, 16).astype(np.float32)
    module = fnn.Conv(8, (3, 3), padding=1, feature_group_count=4)
    variables = random_variables(jax.eval_shape(lambda: module.init(KEY, jnp.asarray(x))), 1)
    assert variables["params"]["kernel"].shape == (3, 3, 4, 8)
    want = module.apply(variables, jnp.asarray(x))
    port = load_port(nn.Conv2d(16, 8, 3, padding=1, groups=4), variables)
    assert port.weight.shape == (8, 4, 3, 3)
    with torch.no_grad():
        got = port(to_nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_resnext50_matches_jax():
    """groups 32, base width 4 at 64 px, one block per stage."""
    x = np.random.RandomState(1).randn(B, 64, 64, 3).astype(np.float32)
    jclf = JaxResNet(n_classes=N_CLASSES, layers=SMALL_LAYERS, groups=32, base_width=4)
    variables = random_variables(jax.eval_shape(
        lambda: jclf.init(KEY, jnp.asarray(x), train=False)), 2)
    assert variables["params"]["layer1_0"]["conv2"]["kernel"].shape == (3, 3, 4, 128)
    want = jclf.apply(variables, jnp.asarray(x), train=False)
    port = load_port(ResNetBackbone(N_CLASSES, layers=SMALL_LAYERS, groups=32, base_width=4,
                                    device="cpu"), variables)
    assert port.layer4_0.conv2.weight.shape == (1024, 32, 3, 3)
    with torch.no_grad():
        got = port(to_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLF_TOL)


def test_resnext50_has_the_torchvision_widths():
    with torch.device("meta"):
        clf = ResNeXt50(N_CLASSES, device="meta")
    assert clf.layer1_0.conv2.groups == 32 and clf.layer1_0.conv2.in_channels == 128
    assert clf.layer4_2.conv3.out_channels == 2048
    assert sum(p.numel() for p in clf.parameters()) == 27_186_500


@pytest.fixture(scope="module")
def models():
    return build_models()


def build_models():
    """JAX and port StyleTransformer(16) + a one-block-per-stage ResNeXt,
    same weights."""
    jtrans = JaxStyleTransformer(output_size=SIZE)
    trans_vars = random_variables(jax.eval_shape(
        lambda: jtrans.init(KEY, jnp.zeros((1, 64, 64, 3)))), 3)
    jclf = JaxResNet(n_classes=N_CLASSES, layers=SMALL_LAYERS, groups=32, base_width=4)
    clf_vars = random_variables(jax.eval_shape(
        lambda: jclf.init(KEY, jnp.zeros((1, IMAGE_SIZE, IMAGE_SIZE, 3)), train=False)), 4)
    return dict(jtrans=jtrans, trans_vars=trans_vars, jclf=jclf, clf_vars=clf_vars,
                ttrans=load_port(StyleTransformer(SIZE, device="cpu"), trans_vars),
                tclf=load_port(ResNetBackbone(N_CLASSES, layers=SMALL_LAYERS, groups=32,
                                              base_width=4, device="cpu"), clf_vars),
                alphas=cars_alphas(N_CODES))


def _cars_pair(models, noise_eps, b=B, float64=False, bf16=False):
    """The JAX and the port cars defense (MLVGMDefense + the Style-Transformer
    split + eot_wrap over EOT draws, normalize_before_purify) with the same
    numpy draws: the JAX side looks each draw up by its key
    (keyed_normal_call), the port replays them folded into its batch,
    draw-major (the mix noise (n_codes, B, 512) on its batch axis 1).
    `float64` gives both sides float64 weights and draws (build and call the
    JAX side inside jax.enable_x64(True)). `bf16` casts both defenses with
    their package's defense_astype (the port's on copies of its modules).
    Returns (jax_net(defense, x), the JAX defense,
    jax_call, port_net(x)): jax_net takes the defense as an argument, so a
    jit of it compiles the weights as inputs, not as constants."""
    rng = np.random.RandomState(6)
    noise = [rng.standard_normal((b, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
             for _ in range(EOT)]
    mix = [rng.standard_normal((N_CODES, b, 512)).astype(np.float32) for _ in range(EOT)]
    key = jax.random.PRNGKey(7)
    jax_call = keyed_normal_call(
        key, [(noise[d] if noise_eps > 0 else None, mix[d]) for d in range(EOT)])

    cast = (lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)) if float64 else (
        lambda t: t)
    enc, dec = jax_split(models["jtrans"])
    jdef = JaxDefense(
        purify_variables=cast(models["trans_vars"]),
        classifier_variables=cast(models["clf_vars"]),
        alphas=jnp.asarray(cast(models["alphas"])), purify_apply=_compose(enc, dec),
        purify_encode_apply=enc, purify_decode_apply=dec,
        classifier_apply=jax_classifier_apply(models["jclf"]), image_size=IMAGE_SIZE,
        initial_noise_eps=noise_eps, normalize_before_purify=True)
    if bf16:
        jdef = jax_defense_astype(jdef)

    dtype = torch.float64 if float64 else torch.float32
    draws = ([np.concatenate(noise)] if noise_eps > 0 else []) + [np.concatenate(mix, axis=1)]
    ttrans, tclf = models["ttrans"], models["tclf"]
    tenc, tdec = make_trans_purify_split(ttrans)
    tdef = MLVGMDefense(
        ttrans, tclf, torch.tensor(models["alphas"]), tenc, tdec,
        make_classifier_apply(tclf), initial_noise_eps=noise_eps,
        normalize_before_purify=True, image_size=IMAGE_SIZE)
    # cast copies: the float32 modules stay the fixture's
    if float64:
        tdef = copy.deepcopy(tdef).double()
    if bf16:
        tdef = defense_astype(copy.deepcopy(tdef))
    tnet = eot_wrap(tdef, eot_steps=EOT)
    return ((lambda d, x: jax_eot_wrap(d, eot_steps=EOT)(key, x)), jdef, jax_call,
            (lambda x: tnet(x, [torch.tensor(d, dtype=dtype) for d in draws])))


@pytest.mark.parametrize("noise_eps", [4.0, 0.0])
def test_cars_defense_matches_jax(models, noise_eps):
    """EoT-2, batch 2, every draw made by numpy on both sides; eps 0.0 takes
    the shared-encode route on both sides."""
    jnet, jdef, jax_call, tnet = _cars_pair(models, noise_eps)
    x = _images(5)
    want = jax_call(lambda: jax.jit(jnet)(jdef, jnp.asarray(x)))
    before = k2.launches
    with torch.no_grad():
        got = tnet(torch.tensor(x))
    assert k2.launches == before  # the CPU runs the blur's plain version
    assert np.all(np.isfinite(np.asarray(want))) and want.shape == (B, N_CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEFENSE_TOL)


def test_cars_defense_input_gradient_matches_jax(models):
    """The input gradient of the EoT-2 cars defense at eps 0.0, batch 1,
    under a numpy-seeded cotangent on the logits: torch.func.vjp through the
    port (K2's autograd Function inside) against jax.vjp.

    In float64 on both sides the two gradients are the same math, held to
    1e-6 relative (measured 1.7e-7). In float32 this random-weight gradient
    is ill-conditioned: nearly all of its float32 error comes from the
    IR-SE-50 trunk at 192 x 256 (measured by running the port's pieces in
    float64 one at a time), and two float32 implementations land at
    different distances from float64 (the port's 2.9e-3 to 8.4e-3 over three
    cotangents, with or without oneDNN). So the float32 bound is measured
    here, as for gender: JAX's own float32-vs-float64 gap on the same weights
    and draws (jax.enable_x64 as a context), and the port's float32 gradient
    may be at most F32_GAP_FACTOR times as far from JAX's float64 one."""
    x = _images(5, b=1)
    g = np.random.RandomState(9).randn(1, N_CLASSES).astype(np.float32)

    def jax_grad(float64):
        jnet, jdef, jax_call, _ = _cars_pair(models, 0.0, b=1, float64=float64)
        xs = jnp.asarray(x.astype(np.float64 if float64 else np.float32))
        grad = jax.jit(lambda d, v, c: jax.vjp(lambda u: jnet(d, u), v)[1](c)[0])
        return np.asarray(jax_call(lambda: grad(jdef, xs, jnp.asarray(g))))

    def port_grad(float64):
        *_, tnet = _cars_pair(models, 0.0, b=1, float64=float64)
        _, vjp_fn = vjp(tnet, torch.tensor(x, dtype=torch.float64 if float64 else None))
        return vjp_fn(torch.tensor(g))[0].detach().numpy()

    want = jax_grad(False)
    with jax.enable_x64(True):
        want64 = jax_grad(True)
    assert want64.dtype == np.float64
    assert np.all(np.isfinite(want)) and np.abs(want).max() > 0
    gap = rel_err(want, want64)
    got, got64 = port_grad(False), port_grad(True)
    assert got64.dtype == np.float64
    err, err64 = rel_err(got, want64), rel_err(got64, want64)
    print(f"JAX float32 vs float64 {gap:.3e}; port float32 vs JAX float64 {err:.3e} "
          f"(vs JAX float32 {rel_err(got, want):.3e}); float64 both sides {err64:.3e}")
    assert err64 <= 1e-6
    assert 0 < gap < 1e-2
    assert err <= F32_GAP_FACTOR * gap


def test_cars_alphas_match_the_config():
    cfg = DefenseConfig.from_yaml(REPO / "configs" / "ours_cosine_noise_cars.yaml")
    np.testing.assert_array_equal(
        cars_alphas(), np.asarray(cfg.interpolation_alphas, np.float32)
        * np.float32(cfg.alpha_attenuation))
    assert len(CARS_ALPHAS) == 16 and cfg.alpha_attenuation == 0.7
    assert cfg.initial_noise_eps == 4.0 and not cfg.gaussian_blur_input


def test_cars_rehearsal_at_reduced_size():
    """The factory on the CPU at a 16-px generator and a one-block-per-stage
    ResNeXt: EoT-2 logits (2, 4), finite; a CPU tensor launches no kernel."""
    defense = cars_defense(device="cpu", output_size=SIZE, classifier_layers=SMALL_LAYERS)
    assert defense.normalize_before_purify and defense.initial_noise_eps == 4.0
    assert defense.image_size == IMAGE_SIZE and not defense.apply_blur
    assert defense.alphas.shape == (N_CODES,)
    x = torch.rand(B, IMAGE_SIZE, IMAGE_SIZE, 3, generator=torch.Generator().manual_seed(0))
    before = k2.launches
    with torch.no_grad():
        logits = eot_wrap(defense, eot_steps=2)(x, torch.Generator().manual_seed(1))
    assert k2.launches == before
    assert logits.shape == (B, N_CLASSES)
    assert torch.isfinite(logits).all()
