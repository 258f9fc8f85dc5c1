"""The port's bfloat16 path (gen_adversarial_tpu_torch/core/precision.py and
the defenses' compute_dtype) on the CPU, the counterpart of
tests/test_precision.py on the same 16-px NVAE defense with its flat linear
classifier (random variables from a numpy seed, loaded into both packages;
every draw made by numpy and replayed on both sides).

- The contract: defense_astype casts every floating parameter and buffer
  once and sets compute_dtype; logits and purified images come back as
  float32, on both EoT routes and under remat, whose recorded draws are
  bfloat16; the ablations keep float32 on weights rounded to bfloat16 and
  match the JAX package's defense_astype of the same ablation.
- The port's bfloat16 defense against its float32 one, with
  tests/test_precision.py's thresholds (EoT logits, argmax agreement, FGSM
  bounds).
- The port's bfloat16 forward and input gradient against the JAX package's
  bfloat16 ones: bfloat16 rounds at other places in the two frameworks, so
  the port's result may be at most BF16_GAP_FACTOR x as far from JAX's
  float32 one as JAX's own bfloat16 result is, measured here.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn
from torch.func import vjp

from gen_adversarial_tpu.core.precision import defense_astype as jax_astype
from gen_adversarial_tpu.defenses.ablations import GaussianBlurDefense as JaxBlurDefense
from gen_adversarial_tpu.defenses.ablations import GaussianNoiseDefense as JaxNoiseDefense
from gen_adversarial_tpu.defenses.base import MLVGMDefense as JaxDefense
from gen_adversarial_tpu.defenses.base import make_classifier_apply as jax_classifier_apply
from gen_adversarial_tpu.defenses.eot import eot_wrap as jax_eot_wrap
from gen_adversarial_tpu.defenses.purify import _compose
from gen_adversarial_tpu.defenses.purify import make_nvae_purify_split as jax_split
from gen_adversarial_tpu.models.classifiers import VGG11BN as JaxVGG
from gen_adversarial_tpu.models.nvae.model import NVAE as JaxNVAE
from gen_adversarial_tpu.models.nvae.model import NVAEConfig as JaxNVAEConfig
from gen_adversarial_tpu_torch.attacks import fgsm_attack
from gen_adversarial_tpu_torch.core.precision import cast_floating, defense_astype
from gen_adversarial_tpu_torch.defenses import base
from gen_adversarial_tpu_torch.defenses.ablations import (
    GaussianBlurDefense, GaussianNoiseDefense)
from gen_adversarial_tpu_torch.defenses.base import (
    ClassifierDefense, MLVGMDefense, make_classifier_apply)
from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.defenses.purify import make_nvae_purify_split
from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
from gen_adversarial_tpu_torch.models.nvae.model import NVAE, NVAEConfig, eps_shapes
from tests.torch_port_helpers import (  # noqa: F401 (one_torch_thread: a fixture)
    assert_within_bf16_gap, keyed_normal_call, load_port, one_torch_thread, random_variables)

BF16 = torch.bfloat16
# tests/test_precision.py's NVAE
CFG = dict(resolution=16, initial_channels=4, n_pre_post_blocks=1, n_pre_post_cells=1,
           num_scales=2, num_groups_per_scale=2, min_groups_per_scale=1,
           num_cells_per_group=1, num_latent_per_group=2, num_mixtures=3)
N_CLASSES = 8
TEMP = 0.6
EPS = 0.5  # tests/test_precision.py's initial_noise_eps
KEY = jax.random.PRNGKey(3)
# tests/test_precision.py's bounds of bfloat16 against float32: mean logit
# error against the logits' spread, argmax agreement, FGSM success agreement
# and bound difference where both succeed
LOGIT_ERR_OVER_SPREAD = 0.15
MIN_AGREEMENT = 0.875
FGSM_SUCCESS_AGREEMENT = 5 / 6
FGSM_BOUND_TOL = 0.3

pytestmark = pytest.mark.usefixtures("one_torch_thread")


class _Flat(nn.Module):
    """tests/test_precision.py's classifier: flattened NHWC image @ W."""

    def __init__(self, w: np.ndarray):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(w), requires_grad=False)

    def forward(self, x):
        return x.reshape(x.shape[0], -1) @ self.w


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = JaxNVAEConfig(**CFG), NVAEConfig(**CFG)
    jnvae = JaxNVAE(jcfg)
    x0 = jnp.zeros((1, 16, 16, 3))
    variables = random_variables(jax.eval_shape(
        lambda: jnvae.init({"params": KEY}, x0, KEY)), 1)
    w = (np.random.RandomState(0).randn(16 * 16 * 3, N_CLASSES) * 0.05).astype(np.float32)
    alphas = np.linspace(0.1, 0.7, tcfg.n_latents).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jnvae=jnvae, variables=variables, w=w, alphas=alphas)


def port_defense(s, eps=EPS, dtype=None, remat=False):
    """A new port defense (its own modules) from the JAX variables, cast by
    defense_astype when `dtype` is given."""
    nvae = load_port(NVAE(s["tcfg"], device="cpu"), s["variables"])
    clf = _Flat(s["w"])
    enc, dec = make_nvae_purify_split(nvae, TEMP)
    defense = MLVGMDefense(nvae, clf, torch.tensor(s["alphas"]), enc, dec, clf,
                           initial_noise_eps=eps, image_size=16, remat=remat)
    return defense_astype(defense, dtype) if dtype is not None else defense


def jax_defense(s, bf16=False):
    enc, dec = jax_split(s["jnvae"], TEMP)
    defense = JaxDefense(
        purify_variables=s["variables"], classifier_variables=jnp.asarray(s["w"]),
        alphas=jnp.asarray(s["alphas"]), purify_apply=_compose(enc, dec),
        purify_encode_apply=enc, purify_decode_apply=dec,
        classifier_apply=lambda v, x: x.reshape(x.shape[0], -1) @ v, image_size=16,
        initial_noise_eps=EPS, normalize_before_purify=False)
    return jax_astype(defense) if bf16 else defense


def draws(s, eot, b, seed, eps=EPS):
    """numpy draws of an EoT call: (the port's, folded into its batch
    draw-major: the input noise, then z_0 and each group's eps; the JAX
    side's per-draw pairs for keyed_normal_call, NHWC)."""
    rng = np.random.RandomState(seed)
    noise = [rng.standard_normal((b, 16, 16, 3)).astype(np.float32) for _ in range(eot)]
    eps_d = [[rng.standard_normal(sh).astype(np.float32) for sh in eps_shapes(s["tcfg"], b)]
             for _ in range(eot)]
    port = ([np.concatenate(noise)] if eps > 0 else []) + [
        np.concatenate([e[j] for e in eps_d]) for j in range(len(eps_d[0]))]
    per_draw = [(noise[d] if eps > 0 else None, [e.transpose(0, 2, 3, 1) for e in eps_d[d]])
                for d in range(eot)]
    return [torch.tensor(a) for a in port], per_draw


def _images(seed, b):
    return np.random.RandomState(seed).rand(b, 16, 16, 3).astype(np.float32)


def test_defense_astype_casts_every_weight_once_and_keeps_the_float32_contract(setup):
    """Every floating parameter and buffer bfloat16 (the BN statistics, the
    alphas buffer, the constant prior), compute_dtype set, and float32 out
    of forward, get_purified, preds_only=False and, at eps 0, the shared
    encode's state_call; cast_floating on a tensor and an integer tensor."""
    d16 = port_defense(setup, dtype=BF16)
    assert d16.compute_dtype == BF16
    floating = [(n, t) for n, t in [*d16.named_parameters(), *d16.named_buffers()]
                if t.is_floating_point()]
    names = {n for n, _ in floating}
    assert {"alphas", "purifier.const_prior", "classifier.w"} <= names
    assert any(n.endswith("running_var") for n in names)
    assert all(t.dtype == BF16 for _, t in floating), [
        n for n, t in floating if t.dtype != BF16]
    x = torch.tensor(_images(1, 2))
    port_draws, _ = draws(setup, 2, 2, 2)
    with torch.no_grad():
        logits = eot_wrap(d16, 2)(x, port_draws)
        single = port_draws[0][:2], *(e[:2] for e in port_draws[1:])
        out, purified = d16(x, list(single), preds_only=False)
        again = d16.get_purified(x, list(single))
    assert logits.dtype == out.dtype == purified.dtype == again.dtype == torch.float32
    torch.testing.assert_close(again, purified, rtol=0, atol=0)
    shared = port_defense(setup, eps=0.0, dtype=BF16)
    with torch.no_grad():
        feats, top = shared.purify_state(x)
        logits0, purified0 = shared.state_call((feats, top), list(single[1:]),
                                               preds_only=False)
    assert top.dtype == BF16 and all(f.dtype == BF16 for f in feats.values())
    assert logits0.dtype == purified0.dtype == torch.float32
    assert cast_floating(x).dtype == BF16
    assert cast_floating(torch.arange(3)).dtype == torch.int64
    flat = _Flat(setup["w"])
    bare = defense_astype(ClassifierDefense(flat, flat))
    assert bare.compute_dtype == BF16 and flat.w.dtype == BF16
    assert bare(x).dtype == torch.float32


def test_remat_records_bf16_draws_and_keeps_the_gradient(setup, monkeypatch):
    """Under remat the checkpointed region takes the bfloat16 image, records
    its draws in bfloat16 and replays them: the input gradient equals the
    one without remat."""
    recorded = []
    inner = base.RecordingDraws.normal

    def spy(self, shape, like):
        eps = inner(self, shape, like)
        recorded.append(eps.dtype)
        return eps

    monkeypatch.setattr(base.RecordingDraws, "normal", spy)
    x = torch.tensor(_images(3, 2))
    port_draws, _ = draws(setup, 2, 2, 4)
    g = torch.tensor(np.random.RandomState(5).randn(2, N_CLASSES).astype(np.float32))
    grads = {}
    for remat in (False, True):
        v = x.clone().requires_grad_(True)
        logits = eot_wrap(port_defense(setup, dtype=BF16, remat=remat), 2)(v, port_draws)
        (grads[remat],) = torch.autograd.grad(logits, v, g)
    assert recorded and all(dt == BF16 for dt in recorded)
    assert grads[True].dtype == torch.float32
    torch.testing.assert_close(grads[True], grads[False], rtol=0, atol=0)


def test_bf16_defense_close_to_f32(setup):
    """tests/test_precision.py's EoT-16 check, port bfloat16 against port
    float32 on identical draws: mean logit error under 0.15 x the logits'
    spread, at most 1 in 8 argmax flips."""
    x = torch.tensor(_images(1, 8))
    port_draws, _ = draws(setup, 16, 8, 6)
    with torch.no_grad():
        logits32 = eot_wrap(port_defense(setup), 16)(x, port_draws)
        logits16 = eot_wrap(port_defense(setup, dtype=BF16), 16)(x, port_draws)
    assert logits16.dtype == torch.float32
    spread = logits32.std().item()
    err = (logits16 - logits32).abs().mean().item()
    assert err < LOGIT_ERR_OVER_SPREAD * spread, (err, spread)
    agree = (logits16.argmax(1) == logits32.argmax(1)).float().mean().item()
    assert agree >= MIN_AGREEMENT, agree


def test_bf16_fgsm_bounds_close_to_f32(setup):
    """tests/test_precision.py's FGSM check: the bfloat16 and float32
    defenses under the same frozen draws (EoT-8); success flags agree on 5
    of 6 images and bounds within 0.3 where both succeed."""
    x = torch.tensor(_images(2, 6))
    y = torch.arange(6) % N_CLASSES
    port_draws, _ = draws(setup, 8, 6, 7)
    out = {}
    for dtype in (None, BF16):
        net = eot_wrap(port_defense(setup, dtype=dtype), 8)
        out[dtype] = fgsm_attack(lambda v, _, net=net: net(v, port_draws), x, y,
                                   torch.Generator(), 3.0)
    (s32, b32, a32), (s16, b16, a16) = out[None], out[BF16]
    assert a16.dtype == torch.float32
    assert (s32 == s16).float().mean().item() >= FGSM_SUCCESS_AGREEMENT
    both = s32 & s16
    if both.any():
        assert (b32 - b16)[both].abs().max().item() < FGSM_BOUND_TOL


def _jax_net(eot):
    return jax.jit(lambda d, v: jax_eot_wrap(d, eot_steps=eot)(KEY, v))


def test_bf16_forward_within_jax_bf16_gap(setup):
    """EoT-4 logits, batch 2: the port's bfloat16 against JAX's float32, at
    most BF16_GAP_FACTOR x as far as JAX's bfloat16."""
    x = _images(4, 2)
    port_draws, per_draw = draws(setup, 4, 2, 8)
    jax_call = keyed_normal_call(KEY, per_draw)
    net = _jax_net(4)
    want = {bf16: np.asarray(jax_call(lambda: net(jax_defense(setup, bf16), jnp.asarray(x))))
            for bf16 in (False, True)}
    assert want[True].dtype == np.float32
    with torch.no_grad():
        got = eot_wrap(port_defense(setup, dtype=BF16), 4)(torch.tensor(x), port_draws)
        got32 = eot_wrap(port_defense(setup), 4)(torch.tensor(x), port_draws)
    # the float32 sides agree (the draws reach both)
    np.testing.assert_allclose(got32.numpy(), want[False], rtol=1e-4, atol=1e-5)
    assert_within_bf16_gap(got.numpy(), want[True], want[False], "EoT-4 logits")


def test_bf16_input_gradient_within_jax_bf16_gap(setup):
    """The input gradient of the EoT-4 defense under a numpy cotangent:
    torch.func.vjp through the port's bfloat16 defense (K1's backward in
    bfloat16) against jax.vjp of JAX's, by the same gap rule."""
    x = _images(5, 2)
    g = np.random.RandomState(9).randn(2, N_CLASSES).astype(np.float32)
    port_draws, per_draw = draws(setup, 4, 2, 10)
    jax_call = keyed_normal_call(KEY, per_draw)
    net = _jax_net(4)
    grad = jax.jit(lambda d, v, c: jax.vjp(lambda u: net(d, u), v)[1](c)[0])
    want = {bf16: np.asarray(jax_call(lambda: grad(jax_defense(setup, bf16), jnp.asarray(x),
                                                    jnp.asarray(g))))
            for bf16 in (False, True)}
    tnet = eot_wrap(port_defense(setup, dtype=BF16), 4)
    _, vjp_fn = vjp(lambda v: tnet(v, port_draws), torch.tensor(x))
    (got,) = vjp_fn(torch.tensor(g))
    assert got.dtype == torch.float32 and np.all(np.isfinite(want[False]))
    assert_within_bf16_gap(got.detach().numpy(), want[True], want[False], "input gradient")


@pytest.fixture(scope="module")
def vgg():
    """A narrow VGG11-BN at 16 px (convolutions and BatchNorms: what dtype
    promotion has to carry through), the JAX variables and the plan."""
    plan = (8, "M", 16, "M")
    jclf = JaxVGG(n_classes=N_CLASSES, plan=plan)
    variables = random_variables(jax.eval_shape(
        lambda: jclf.init(KEY, jnp.zeros((1, 16, 16, 3)), train=False)), 2)
    return dict(jclf=jclf, variables=variables, plan=plan)


@pytest.mark.parametrize("kind", ["noise", "blur"])
def test_ablations_round_their_weights_and_compute_in_float32(vgg, kind, monkeypatch):
    """An ablation has no compute_dtype: defense_astype leaves its weights
    float32, rounded to bfloat16, and it computes in float32: exactly the
    float32 ablation on those rounded weights. Against the JAX package's
    defense_astype of the same ablation, whose float32 inputs promote the
    pipeline back to float32, it is held by the gap rule: flax's BatchNorm
    takes rsqrt(var + eps) * scale in the weights' dtype before the
    promotion, so JAX's bfloat16 ablation rounds there too, and the two do
    not agree to float32 precision."""
    x = _images(6, 2)
    noise = np.random.RandomState(7).standard_normal(x.shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    japply = jax_classifier_apply(vgg["jclf"])
    jdef = (JaxNoiseDefense(vgg["variables"], japply, eps=2.0) if kind == "noise"
            else JaxBlurDefense(vgg["variables"], japply, image_size=16))
    want16 = np.asarray(jax_astype(jdef)(KEY, jnp.asarray(x)))
    want32 = np.asarray(jdef(KEY, jnp.asarray(x)))
    assert want16.dtype == np.float32

    def port(round_by_hand=False):
        clf = load_port(VGG11BN(N_CLASSES, plan=vgg["plan"], device="cpu"), vgg["variables"])
        if round_by_hand:
            with torch.no_grad():
                for t in clf.state_dict().values():
                    if t.is_floating_point():
                        t.copy_(t.to(BF16).float())
        tapply = make_classifier_apply(clf)
        return clf, (GaussianNoiseDefense(clf, tapply, eps=2.0) if kind == "noise"
                     else GaussianBlurDefense(clf, tapply, image_size=16))

    clf, tdef = port()
    raw = {n: t.clone() for n, t in clf.state_dict().items()}
    assert defense_astype(tdef) is tdef and tdef.compute_dtype is None
    rounded = {n: t for n, t in clf.state_dict().items() if t.is_floating_point()}
    assert all(t.dtype == torch.float32 for t in rounded.values())
    assert any(not torch.equal(t, raw[n]) for n, t in rounded.items())
    for name, t in rounded.items():
        torch.testing.assert_close(t, raw[name].to(BF16).float(), rtol=0, atol=0)
    with torch.no_grad():
        got = tdef(torch.tensor(x), [torch.tensor(noise)])
        by_hand = port(round_by_hand=True)[1](torch.tensor(x), [torch.tensor(noise)])
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, by_hand, rtol=0, atol=0)
    assert_within_bf16_gap(got.numpy(), want16, want32, f"{kind} ablation logits")
