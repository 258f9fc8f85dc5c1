"""The port's competitor defenses against the JAX package on the CPU: the
A-VAE's parts (the fused up-convolution also against conv_transpose2d), its
64-px generator and critic, the ND-VAE at scales 2 and 1 in train and eval
mode, both defenses under EoT, their bfloat16 contract, and the TRADES
functions on a tiny VGG. Weights are random from a numpy seed, loaded
through core/convert.from_jax_variables; every draw is made by numpy and
replayed on both sides (the JAX side's through its keys)."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

import gen_adversarial_tpu.models.avae.model as javae
import gen_adversarial_tpu_torch.models.avae.model as tavae
from gen_adversarial_tpu.core.precision import defense_astype as jax_astype
from gen_adversarial_tpu.defenses import competitors as jcomp
from gen_adversarial_tpu.defenses.base import make_classifier_apply as jax_clf_apply
from gen_adversarial_tpu.defenses.eot import eot_wrap as jax_eot
from gen_adversarial_tpu.models.classifiers import VGG11BN as JaxVGG
from gen_adversarial_tpu.models.ndvae.model import DefenceNVAE as JaxNDVAE
from gen_adversarial_tpu_torch.core.precision import defense_astype
from gen_adversarial_tpu_torch.defenses import competitors as tcomp
from gen_adversarial_tpu_torch.defenses.base import make_classifier_apply
from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
from gen_adversarial_tpu_torch.models.ndvae.model import DefenceNVAE
from gen_adversarial_tpu_torch.models.nvae.distributions import Draws, RecordingDraws
from tests.torch_port_helpers import (  # noqa: F401 (fixtures)
    TINY_PLAN, assert_within_bf16_gap, grads_as_jax, keyed_normal_call,
    keyed_normal_table, load_port, no_onednn, one_torch_thread, random_variables, rel_err,
    to_nchw, to_nhwc)

pytestmark = pytest.mark.usefixtures("one_torch_thread", "no_onednn")

# a few float32 layers summed in another order
PART_TOL = dict(rtol=1e-5, atol=1e-5)
# a whole generator, critic, ND-VAE or defense: tens of float32 layers in
# another summation order, relative to the output's largest value
MODEL_RTOL = 1e-4
# input gradients, relative to the largest element of the reference's
GRAD_RTOL = 1e-4
# the port's float64 input gradients against JAX's float64 ones
F64_GRAD_RTOL = 1e-10
B = 2
N_CLASSES = 4


def _vjp_pair(jfn, tfn, x, cot):
    """(JAX out, port out, JAX input gradient, port input gradient) of a
    function on NHWC x under the cotangent `cot` (NHWC); tfn takes NCHW."""
    want, jvjp = jax.vjp(jfn, jnp.asarray(x))
    (want_g,) = jvjp(jnp.asarray(cot))
    xt = to_nchw(x).requires_grad_(True)
    got = tfn(xt)
    (got_g,) = torch.autograd.grad(got, xt, to_nchw(cot))
    return np.asarray(want), to_nhwc(got), np.asarray(want_g), to_nhwc(got_g)


def _assert_model_close(got, want, rtol=MODEL_RTOL):
    assert rel_err(got, want) <= rtol, rel_err(got, want)


def _assert_grad_close(port_grad, jax_grad, monkeypatch):
    """An A-VAE input gradient: the port's float32 one, `port_grad(
    torch.float32)`, within GRAD_RTOL of the port's float64 one on the
    float32 run's leaky-ReLU branches, and the port's float64 one within
    F64_GRAD_RTOL of JAX's, `jax_grad(jnp.float64)`.

    A float32 and a float64 run take different slopes where a leaky ReLU's
    input lies within rounding of 0: over 12 seeds one such element put the
    64-px critic's float32 input gradient 1.5e-2 and 4.6e-3 (relative) from
    float64 at two seeds, and JAX's 4.4e-2 at a third, while on the float32
    run's branches the port's came within 1.4e-6 at every seed
    (tests/torch_avae_branch_sweep.py)."""
    with tavae.leaky_relu_branches() as masks:
        got32 = port_grad(torch.float32)
    with tavae.leaky_relu_branches(masks) as changed:
        got64_on_branches = port_grad(torch.float64)
    # the JAX blur's taps are a float32 constant; float64 needs float64 taps
    monkeypatch.setattr(javae, "BINOMIAL3", javae.BINOMIAL3.astype(np.float64))
    with jax.enable_x64(True):
        want64 = jax_grad(jnp.float64)
    got64 = port_grad(torch.float64)
    err64, err = rel_err(got64, want64), rel_err(got32, got64_on_branches)
    print(f"float64 vs JAX float64 {err64:.1e}; float32 vs float64 {rel_err(got32, got64):.1e}, "
          f"on its branches {err:.1e} ({int(sum(changed))} branches changed)")
    assert err64 <= F64_GRAD_RTOL, err64
    assert err <= GRAD_RTOL, err


def _cast(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


PARTS = {
    "conv_s2": (lambda: javae.AEqualConv2d(8, 3, stride=2, padding=1),
                lambda: tavae.AEqualConv2d(4, 8, 3, stride=2, padding=1), (B, 9, 9, 4)),
    "conv_1x1": (lambda: javae.AEqualConv2d(3, 1), lambda: tavae.AEqualConv2d(6, 3, 1),
                 (B, 5, 5, 6)),
    "fused_up_p1": (lambda: javae.FusedUpsample(5, 3, 1), lambda: tavae.FusedUpsample(4, 5, 3, 1),
                    (B, 6, 6, 4)),
    "fused_up_p0": (lambda: javae.FusedUpsample(5, 4, 0), lambda: tavae.FusedUpsample(3, 5, 4, 0),
                    (B, 5, 5, 3)),
    "fused_down_p1": (lambda: javae.FusedDownsample(5, 3, 1),
                      lambda: tavae.FusedDownsample(4, 5, 3, 1), (B, 8, 8, 4)),
}


@pytest.mark.parametrize("name", sorted(PARTS))
def test_avae_conv_parts_match_jax(name):
    """Equalized convolutions, forward and input gradient; their weights
    N(0, 1) as flax initializes them, scaled at the call."""
    jmod, tmod, shape = PARTS[name]
    rng = np.random.RandomState(0)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = jmod()
    variables = random_variables(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), 1)
    tm = load_port(tmod(), variables)
    want = jm.apply(variables, jnp.asarray(x))
    cot = rng.standard_normal(want.shape).astype(np.float32)
    want, got, want_g, got_g = _vjp_pair(lambda v: jm.apply(variables, v), tm, x, cot)
    np.testing.assert_allclose(got, want, **PART_TOL)
    np.testing.assert_allclose(got_g, want_g, **PART_TOL)


@pytest.mark.parametrize("k,padding", [(3, 1), (4, 0), (3, 0)])
def test_fused_upsample_is_conv_transpose2d(k, padding):
    """JAX's FusedUpsample (a convolution of the 2x-dilated input with the
    flipped smoothed kernel) equals conv_transpose2d with the smoothed kernel
    in (I, O, k + 1, k + 1), stride 2 and the same padding."""
    rng = np.random.RandomState(k + padding)
    x = rng.standard_normal((B, 5, 5, 3)).astype(np.float32)
    jm = javae.FusedUpsample(4, k, padding)
    variables = random_variables(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), 2)
    w = np.asarray(variables["params"]["weight"], np.float64) * np.sqrt(2.0 / (3 * k * k))
    w = np.pad(w, ((1, 1), (1, 1), (0, 0), (0, 0)))
    wk = (w[1:, 1:] + w[:-1, 1:] + w[1:, :-1] + w[:-1, :-1]) / 4.0   # (k+1, k+1, I, O)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    w_iohw = torch.tensor(wk.transpose(2, 3, 0, 1), dtype=torch.float32)
    got = F.conv_transpose2d(to_nchw(x), w_iohw,
                             torch.tensor(np.asarray(variables["params"]["bias"])),
                             stride=2, padding=padding)
    assert got.shape[2] == 2 * 5 - 2 - 2 * padding + k + 1
    np.testing.assert_allclose(to_nhwc(got), want, **PART_TOL)


def test_avae_functional_parts_match_jax():
    """blur3, instance_norm, noise injection and AdaIN, forward and input
    gradient."""
    rng = np.random.RandomState(3)
    x = rng.standard_normal((B, 6, 6, 5)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    for jfn, tfn in ((javae.blur3, tavae.blur3), (javae.instance_norm, tavae.instance_norm)):
        want, got, want_g, got_g = _vjp_pair(jfn, tfn, x, cot)
        np.testing.assert_allclose(got, want, **PART_TOL)
        np.testing.assert_allclose(got_g, want_g, **PART_TOL)

    noise = rng.standard_normal((B, 6, 6, 1)).astype(np.float32)
    jm = javae.ANoiseInjection()
    variables = random_variables(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(noise))), 4)
    tm = load_port(tavae.ANoiseInjection(5), variables)
    want, got, want_g, got_g = _vjp_pair(lambda v: jm.apply(variables, v, jnp.asarray(noise)),
                                         lambda v: tm(v, to_nchw(noise)), x, cot)
    np.testing.assert_allclose(got, want, **PART_TOL)
    np.testing.assert_allclose(got_g, want_g, **PART_TOL)

    style = rng.standard_normal((B, 512)).astype(np.float32)
    jm = javae.AdaptiveInstanceNorm()
    variables = random_variables(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(style))), 5)
    tm = load_port(tavae.AdaptiveInstanceNorm(5), variables)
    want, got, want_g, got_g = _vjp_pair(lambda v: jm.apply(variables, v, jnp.asarray(style)),
                                         lambda v: tm(v, torch.tensor(style)), x, cot)
    np.testing.assert_allclose(got, want, **PART_TOL)
    np.testing.assert_allclose(got_g, want_g, **PART_TOL)


AVAE_SIZE = 64
AVAE_KERNEL = 2


def _avae_draws(rng, batch, size=AVAE_SIZE):
    """NHWC noise maps, one a progression step, and the eps (B, 4, 4, 512)."""
    noise = [rng.standard_normal((batch, 4 * 2 ** i, 4 * 2 ** i, 1)).astype(np.float32)
             for i in range(len(tavae.avae_generator_plan(size)))]
    return noise, rng.standard_normal((batch, 4, 4, 512)).astype(np.float32)


@pytest.fixture(scope="module")
def avae_pair():
    jm = javae.StyledGenerator(AVAE_SIZE)
    x0 = jnp.zeros((1, AVAE_SIZE // AVAE_KERNEL, AVAE_SIZE // AVAE_KERNEL, 3))
    variables = random_variables(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), x0, jax.random.PRNGKey(0))), 7)
    tm = load_port(tavae.StyledGenerator(AVAE_SIZE, device="cpu"), variables)
    return jm, variables, tm


def test_styled_generator_matches_jax(avae_pair, monkeypatch):
    """The 64-px A-VAE from the same draws: (mu, logvar, image) in training
    (temperature 1), the image at inference (temperature 0.6) and its input
    gradient (_assert_grad_close)."""
    jm, variables, tm = avae_pair
    rng = np.random.RandomState(11)
    x = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    noise, eps = _avae_draws(rng, 1)
    key = jax.random.PRNGKey(5)
    jax_call = keyed_normal_table([(jax.random.split(key)[1], eps)])
    draws = [torch.tensor(n).permute(0, 3, 1, 2) for n in noise] + [to_nchw(eps)]
    jnoise = [jnp.asarray(n) for n in noise]

    want = jax_call(lambda: jax.jit(lambda v, xx, nn: jm.apply(v, xx, key, noise=nn))(
        variables, jnp.asarray(x), jnoise))
    with torch.no_grad():
        got = tm(to_nchw(x), Draws(list(draws)))
    for g, w in zip(got, want):
        _assert_model_close(to_nhwc(g), np.asarray(w))

    @jax.jit
    def jax_vjp(v, xx, nn, cc):
        out, f_vjp = jax.vjp(lambda u: jm.apply(v, u, key, noise=nn, inference=True), xx)
        return out, f_vjp(cc)[0]

    cot = rng.standard_normal((1, AVAE_SIZE, AVAE_SIZE, 3)).astype(np.float32)
    want, _ = jax_call(lambda: jax_vjp(variables, jnp.asarray(x), jnoise, jnp.asarray(cot)))
    with torch.no_grad():
        got = tm(to_nchw(x), Draws(list(draws)), inference=True)
    assert got.shape == (1, 3, AVAE_SIZE, AVAE_SIZE)
    _assert_model_close(to_nhwc(got), np.asarray(want))

    def port_grad(dt):
        xt = to_nchw(x).to(dt).requires_grad_(True)
        out = copy.deepcopy(tm).to(dt)(xt, Draws(list(draws)), inference=True)
        return to_nhwc(torch.autograd.grad(out, xt, to_nchw(cot).to(dt))[0])

    def jax_grad(dt):
        return np.asarray(jax_call(lambda: jax_vjp(
            _cast(variables, dt), jnp.asarray(x, dt), [jnp.asarray(n, dt) for n in noise],
            jnp.asarray(cot, dt))[1]), np.float64)

    _assert_grad_close(port_grad, jax_grad, monkeypatch)


def test_avae_discriminator_matches_jax(monkeypatch):
    """The 64-px critic's score, and its input gradient (_assert_grad_close:
    at this seed one leaky ReLU input within rounding of 0 puts the port's
    float32 gradient 2.9e-3 from float64, on its own branches 1e-6)."""
    jm = javae.AVAEDiscriminator(64)
    rng = np.random.RandomState(12)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    variables = random_variables(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), 8)
    tm = load_port(tavae.AVAEDiscriminator(64, device="cpu"), variables)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(to_nchw(x))
    assert got.shape == (1, 1)
    _assert_model_close(got.numpy(), np.asarray(want))
    cot = rng.standard_normal((1, 1))

    def port_grad(dt):
        xt = to_nchw(x).to(dt).requires_grad_(True)
        out = copy.deepcopy(tm).to(dt)(xt)
        return to_nhwc(torch.autograd.grad(out, xt, torch.tensor(cot, dtype=dt))[0])

    def jax_grad(dt):
        _, f_vjp = jax.vjp(lambda u: jm.apply(_cast(variables, dt), u), jnp.asarray(x, dt))
        return np.asarray(f_vjp(jnp.asarray(cot, dt))[0])

    _assert_grad_close(port_grad, jax_grad, monkeypatch)


ND_SIZE = 32


def _nd_kwargs(scales):
    return dict(x_channels=3, encoding_channels=4, pre_proc_groups=2, scales=scales,
                groups=2 if scales == 1 else 1, cells=2, input_dim=ND_SIZE)


def _nd_pair(scales, seed=9):
    jm = JaxNDVAE(**_nd_kwargs(scales))
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, ND_SIZE, ND_SIZE, 3)), jax.random.PRNGKey(0))), seed)
    tm = load_port(DefenceNVAE(**_nd_kwargs(scales), device="cpu"), variables)
    return jm, variables, tm


def _nd_draws(tm, x, seed):
    """The sampler eps of one forward of x (NCHW tensors), from a seeded
    generator."""
    rec = RecordingDraws(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        tm.eval()(to_nchw(x), rec)
    return rec.record


@pytest.mark.parametrize("scales", [2, 1])
@pytest.mark.parametrize("train", [False, True])
def test_ndvae_forward_matches_jax(scales, train):
    """logits, log_q, log_p, the KL terms, (train) the running statistics
    the forward leaves, and (eval) purify and the logits' input gradient."""
    jm, variables, tm = _nd_pair(scales)
    rng = np.random.RandomState(13 + scales)
    x = rng.uniform(-0.05, 1.05, (B, ND_SIZE, ND_SIZE, 3)).astype(np.float32)
    record = _nd_draws(tm, x, 21)
    assert len(record) == scales + 1
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, scales + 2)
    jax_call = keyed_normal_table(list(zip(keys, [to_nhwc(e) for e in record])))

    if train:
        want, updates = jax_call(lambda: jax.jit(lambda v, xx: jm.apply(
            v, xx, key, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x)))
        tm.train()
    else:
        want = jax_call(lambda: jax.jit(lambda v, xx: jm.apply(v, xx, key))(
            variables, jnp.asarray(x)))
    with torch.no_grad():
        logits, log_q, log_p, kl_all = tm(to_nchw(x), Draws(list(record)))
    _assert_model_close(to_nhwc(logits), np.asarray(want[0]))
    for got, w in [(log_q, want[1]), (log_p, want[2])] + list(zip(kl_all, want[3])):
        _assert_model_close(got.numpy(), np.asarray(w))
    if train:
        from gen_adversarial_tpu_torch.core.convert import to_jax_variables
        got_stats = to_jax_variables(tm)["batch_stats"]
        flat_w = jax.tree_util.tree_leaves_with_path(updates["batch_stats"])
        for path, w in flat_w:
            node = got_stats
            for k in path:
                node = node[k.key]
            np.testing.assert_allclose(node, np.asarray(w), rtol=1e-4, atol=1e-5)
        return

    cot = rng.standard_normal(np.asarray(want[0]).shape).astype(np.float32)

    @jax.jit
    def jax_purify_vjp(v, xx, cc):
        return (jm.apply(v, xx, key, method=JaxNDVAE.purify),
                jax.vjp(lambda u: jm.apply(v, u, key)[0], xx)[1](cc)[0])

    want_p, want_g = jax_call(lambda: jax_purify_vjp(variables, jnp.asarray(x),
                                                     jnp.asarray(cot)))
    with torch.no_grad():
        got_p = tm.purify(to_nchw(x), Draws(list(record)))
    _assert_model_close(to_nhwc(got_p), np.asarray(want_p))
    xt = to_nchw(x).requires_grad_(True)
    (got_g,) = torch.autograd.grad(tm(xt, Draws(list(record)))[0], xt, to_nchw(cot))
    assert rel_err(to_nhwc(got_g), np.asarray(want_g)) <= GRAD_RTOL


def _vgg_pair(seed=17, size=64):
    jm = JaxVGG(n_classes=N_CLASSES, plan=TINY_PLAN)
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False)), seed)
    tm = load_port(VGG11BN(N_CLASSES, plan=TINY_PLAN, device="cpu"), variables)
    return jm, variables, tm


EOT = 2


def _avae_defenses(avae_pair, batch=1):
    jm, variables, tm = avae_pair
    jclf, clf_vars, tclf = _vgg_pair()
    jdef = jcomp.AVaeDefense(variables, clf_vars, jm, jax_clf_apply(jclf), AVAE_KERNEL)
    tdef = tcomp.AVaeDefense(tm, tclf, make_classifier_apply(tclf), AVAE_KERNEL)
    rng = np.random.RandomState(19)
    per_draw = [_avae_draws(rng, batch) for _ in range(EOT)]
    draws = [torch.tensor(np.concatenate([d[0][i] for d in per_draw])).permute(0, 3, 1, 2)
             for i in range(len(per_draw[0][0]))]
    draws.append(to_nchw(np.concatenate([d[1] for d in per_draw])))
    return jdef, tdef, per_draw, draws


def _nd_defenses(scales=2):
    jm, variables, tm = _nd_pair(scales, seed=23)
    jclf, clf_vars, tclf = _vgg_pair(size=ND_SIZE)
    jdef = jcomp.NDVaeDefense(variables, clf_vars, jm, jax_clf_apply(jclf), 0.1)
    tdef = tcomp.NDVaeDefense(tm, tclf, make_classifier_apply(tclf), 0.1)
    rng = np.random.RandomState(29)
    noise = [rng.standard_normal((B, ND_SIZE, ND_SIZE, 3)).astype(np.float32)
             for _ in range(EOT)]
    x = rng.rand(B * EOT, ND_SIZE, ND_SIZE, 3).astype(np.float32)
    eps = _nd_draws(tm, x, 31)  # shapes of a folded batch
    per_draw = [(noise[d], [to_nhwc(e[d * B:(d + 1) * B]) for e in eps] + [None])
                for d in range(EOT)]
    draws = [torch.tensor(np.concatenate(noise))] + eps
    return jdef, tdef, per_draw, draws


def _eot_check(jdef, tdef, per_draw, draws, x, monkeypatch=None):
    """EoT logits and their input gradient, JAX against the port (the
    gradient by _assert_grad_close where monkeypatch is given); returns the
    port's logits."""
    key = jax.random.PRNGKey(41)
    jax_call = keyed_normal_call(key, per_draw)
    rng = np.random.RandomState(43)
    cot = rng.standard_normal((x.shape[0], N_CLASSES)).astype(np.float32)

    @jax.jit
    def jax_vjp(d, xx, cc):
        out, f_vjp = jax.vjp(lambda u: jax_eot(d, EOT)(key, u), xx)
        return out, f_vjp(cc)[0]

    want, want_g = jax_call(lambda: jax_vjp(jdef, jnp.asarray(x), jnp.asarray(cot)))

    def port_grad(dt, keep=None):
        xt = torch.tensor(x, dtype=dt).requires_grad_(True)
        d = tdef if dt == torch.float32 else copy.deepcopy(tdef).to(dt)
        got = eot_wrap(d, EOT)(xt, Draws(list(draws)))
        if keep is not None:
            keep.append(got.detach().numpy())
        return torch.autograd.grad(got, xt, torch.tensor(cot, dtype=dt))[0].numpy()

    got = []
    if monkeypatch is None:
        assert rel_err(port_grad(torch.float32, got), np.asarray(want_g)) <= GRAD_RTOL
    else:
        _assert_grad_close(lambda dt: port_grad(dt, got if dt == torch.float32 else None),
                           lambda dt: np.asarray(jax_call(lambda: jax_vjp(
                               _cast(jdef, dt), jnp.asarray(x, dt), jnp.asarray(cot, dt))[1])),
                           monkeypatch)
    _assert_model_close(got[0], np.asarray(want))
    return got[0]


def test_avae_defense_under_eot_matches_jax(avae_pair, monkeypatch):
    jdef, tdef, per_draw, draws = _avae_defenses(avae_pair)
    x = np.random.RandomState(47).rand(1, AVAE_SIZE, AVAE_SIZE, 3).astype(np.float32)
    _eot_check(jdef, tdef, per_draw, draws, x, monkeypatch)
    assert not tdef.supports_shared_encode
    # JAX's A-VAE cannot run in bfloat16 where its weights are traced (the
    # attacks and the harness pass the defense to jit as an argument); the
    # port refuses the cast
    jax16 = jax_astype(jdef, jnp.bfloat16)
    with pytest.raises(TypeError, match="same dtypes"):
        jax.jit(lambda d, xx: jax_eot(d, EOT)(jax.random.PRNGKey(0), xx))(
            jax16, jnp.asarray(x))
    with pytest.raises(TypeError, match="A-VAE does not run in bfloat16"):
        defense_astype(copy.deepcopy(tdef), torch.bfloat16)


def test_ndvae_defense_under_eot_and_bf16_match_jax():
    jdef, tdef, per_draw, draws = _nd_defenses()
    x = np.random.RandomState(53).rand(B, ND_SIZE, ND_SIZE, 3).astype(np.float32)
    got32 = _eot_check(jdef, tdef, per_draw, draws, x)
    # bfloat16: JAX rounds the weights and computes in float32 (flax promotes
    # the float32 input), except each BatchNorm's coefficient rsqrt(var +
    # eps) * scale, which it computes from its bfloat16 statistics in
    # bfloat16 (XLA's jit and JAX's op-by-op run round those differently).
    # The port computes in float32 on the rounded weights: JAX's float32
    # defense on rounded leaves, and within the bfloat16 gap of JAX's
    # bfloat16 defense
    key = jax.random.PRNGKey(41)
    jax_call = keyed_normal_call(key, per_draw)
    jnet = jax.jit(lambda d, xx: jax_eot(d, EOT)(key, xx))
    want16 = np.asarray(jax_call(lambda: jnet(jax_astype(jdef, jnp.bfloat16), jnp.asarray(x))))
    want32 = np.asarray(jax_call(lambda: jnet(jdef, jnp.asarray(x))))
    want_rounded = np.asarray(jax_call(lambda: jnet(
        _cast(_cast(jdef, jnp.bfloat16), jnp.float32), jnp.asarray(x))))
    t16 = defense_astype(copy.deepcopy(tdef), torch.bfloat16)
    with torch.no_grad():
        got16 = eot_wrap(t16, EOT)(torch.tensor(x), Draws(list(draws))).numpy()
    assert got16.dtype == np.float32 and want16.dtype == np.float32
    _assert_model_close(got16, want_rounded)
    assert rel_err(got16, got32) > 10 * MODEL_RTOL, rel_err(got16, got32)
    assert_within_bf16_gap(got16, want16, want32, "ND-VAE defense bfloat16")
    # the float32 defense kept its weights: the cast was made on a copy
    with torch.no_grad():
        again = eot_wrap(tdef, EOT)(torch.tensor(x), Draws(list(draws)))
    np.testing.assert_array_equal(again.numpy(), got32)


def test_competitor_deep_copies_own_their_weights(avae_pair):
    """A deep copy of either defense computes from its own purifier and
    classifier: zeroing the copy's changes its logits, not the original's."""
    x = np.random.RandomState(59).rand(B, ND_SIZE, ND_SIZE, 3).astype(np.float32)
    for (_, tdef, _, draws), size in ((_avae_defenses(avae_pair, B), AVAE_SIZE),
                                      (_nd_defenses(), ND_SIZE)):
        xi = torch.tensor(np.resize(x, (B, size, size, 3)))
        with torch.no_grad():
            before = eot_wrap(tdef, EOT)(xi, Draws(list(draws)))
            twin = copy.deepcopy(tdef)
            assert twin.classifier_apply.model is twin.classifier
            for p in list(twin.purifier.parameters()) + list(twin.classifier.parameters()):
                p.zero_()
            after = eot_wrap(tdef, EOT)(xi, Draws(list(draws)))
            changed = eot_wrap(twin, EOT)(xi, Draws(list(draws)))
        np.testing.assert_array_equal(after.numpy(), before.numpy())
        assert not np.allclose(changed.numpy(), before.numpy())


# ---- TRADES ----------------------------------------------------------------
# In float64 on both sides: TRADES starts from a 0.001 x N(0, 1) perturbation,
# where the KL is ~1e-8, below float32's resolution of its O(1) terms, so
# the first L2 direction is rounding noise in float32 in either package.

TRADES_SIZE = 32
TRADES_B = 2
TRADES_STEPS = 3
# float64 through a few layers and the inner loop's steps
TRADES_TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def trades_world():
    """A tiny VGG over 4 classes on both sides, in float64; model_fn zeroes
    sample 0's image, so its KL gradient is exactly 0 (the L2 loop's
    random-direction branch)."""
    jm, variables, tm = _vgg_pair(61, TRADES_SIZE)
    variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    tm = tm.double()
    mask = np.ones((TRADES_B, 1, 1, 1))
    mask[0] = 0.0
    rng = np.random.RandomState(67)
    x = rng.rand(TRADES_B, TRADES_SIZE, TRADES_SIZE, 3)
    y = rng.randint(0, N_CLASSES, TRADES_B)
    draws = [rng.standard_normal(x.shape) for _ in range(TRADES_STEPS + 1)]
    return jm, variables, tm, mask, x, y, draws


def _trades_fns(world, variables=None):
    jm, v, tm, mask, *_ = world
    v = v if variables is None else variables
    return (lambda z: jm.apply(v, z * mask, train=False),
            lambda z: tm((z * torch.tensor(mask)).permute(0, 3, 1, 2)))


def _norm(z):
    return (z - 0.5) / 0.5


def test_trades_inner_l2_matches_jax(trades_world):
    *_, x, _, draws = trades_world
    jfn, tfn = _trades_fns(trades_world)
    key = jax.random.PRNGKey(71)
    with jax.enable_x64(True):
        jax_call = keyed_normal_table(list(zip(jax.random.split(key, TRADES_STEPS + 1), draws)))
        want = np.asarray(jax_call(lambda: jcomp.trades_inner_l2(
            jfn, key, jnp.asarray(x), 2.0, TRADES_STEPS, _norm)))
    got = tcomp.trades_inner_l2(tfn, [torch.tensor(d) for d in draws], torch.tensor(x), 2.0,
                                TRADES_STEPS, _norm).numpy()
    np.testing.assert_allclose(got, want, **TRADES_TOL)
    # sample 0 moved along the replayed random directions (its gradient is 0)
    assert not np.allclose(got[0], x[0], atol=1e-3)
    assert np.all(np.sqrt(np.sum((got - x) ** 2, axis=(1, 2, 3))) <= 2.0 + 1e-9)


def test_trades_inner_linf_matches_jax(trades_world):
    *_, x, _, draws = trades_world
    jfn, tfn = _trades_fns(trades_world)
    key = jax.random.PRNGKey(73)
    with jax.enable_x64(True):
        jax_call = keyed_normal_table([(key, draws[0])])
        want = np.asarray(jax_call(lambda: jcomp.trades_inner_linf(
            jfn, key, jnp.asarray(x), 0.03, 0.01, TRADES_STEPS, _norm)))
    got = tcomp.trades_inner_linf(tfn, [torch.tensor(draws[0])], torch.tensor(x), 0.03, 0.01,
                                  TRADES_STEPS, _norm).numpy()
    np.testing.assert_allclose(got, want, **TRADES_TOL)
    assert np.abs(got - x).max() <= 0.03 + 1e-9


@pytest.mark.parametrize("distance", ["l_2", "l_inf", "none"])
def test_trades_loss_and_its_parameter_gradient_match_jax(trades_world, distance):
    jm, variables, tm, mask, x, y, draws = trades_world
    key = jax.random.PRNGKey(79)
    if distance == "l_2":
        entries, port_draws = list(zip(jax.random.split(key, TRADES_STEPS + 1), draws)), draws
    else:
        entries, port_draws = [(key, draws[0])], draws[:1]
    eps = 2.0 if distance == "l_2" else 0.03

    def jloss(params):
        jfn, _ = _trades_fns(trades_world, {**variables, "params": params})
        return jcomp.trades_loss(jfn, key, jnp.asarray(x), jnp.asarray(y), 0.01, eps,
                                 TRADES_STEPS, 1.5, distance, _norm)

    with jax.enable_x64(True):
        jax_call = keyed_normal_table(entries)
        want, want_g = jax_call(lambda: jax.value_and_grad(jloss)(variables["params"]))
        want, want_g = float(want), jax.tree.map(np.asarray, want_g)
    tm.zero_grad()
    _, tfn = _trades_fns(trades_world)
    got = tcomp.trades_loss(tfn, [torch.tensor(d) for d in port_draws], torch.tensor(x),
                            torch.tensor(y).long(), 0.01, eps, TRADES_STEPS, 1.5, distance,
                            _norm)
    got.backward()
    np.testing.assert_allclose(got.item(), want, rtol=1e-9)
    got_g = grads_as_jax(tm)
    scale = max(np.abs(g).max() for g in jax.tree_util.tree_leaves(want_g))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_g),
                            jax.tree_util.tree_leaves(got_g)):
        assert np.abs(np.asarray(g) - w).max() <= 1e-9 * scale, path


def test_kl_div_sum_matches_jax():
    rng = np.random.RandomState(83)
    logits = rng.standard_normal((3, 5)).astype(np.float32)
    p = np.asarray(jax.nn.softmax(jnp.asarray(rng.standard_normal((3, 5)) * 30.0), axis=1),
                   np.float32)
    want = jcomp.kl_div_sum(jax.nn.log_softmax(jnp.asarray(logits), axis=1), jnp.asarray(p))
    got = tcomp.kl_div_sum(torch.log_softmax(torch.tensor(logits), dim=1), torch.tensor(p))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
