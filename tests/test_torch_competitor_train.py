"""The port's competitor trainers against the JAX package on the CPU: the
A-VAE's WGAN-GP d_step (its gradient penalty a double backward), g_step and
accumulate, the ND-VAE's train step (scales 2, balanced and plain KL; scales
1 raising in both packages) and kl_balancer_coeff, and the TRADES step.

The steps run in float64 on both sides, with their real optimizers: a first
Adam or Adamax step is lr x G / (|G| + eps), which turns float32 noise in a
near-zero gradient into a step of either sign, and TRADES' inner loop starts
where the KL is below float32's resolution; in float64 both are exact to
rounding, so the parameters after a step are compared directly. Weights
are random from a numpy seed; every draw is numpy's, replayed through the
JAX side's keys."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import gen_adversarial_tpu.models.avae.model as javae
from gen_adversarial_tpu.models.classifiers import VGG11BN as JaxVGG
from gen_adversarial_tpu.models.ndvae.model import DefenceNVAE as JaxNDVAE
from gen_adversarial_tpu.train import avae as javae_train
from gen_adversarial_tpu.train import ndvae as jndvae_train
from gen_adversarial_tpu.train.classifier import TrainState as JaxTrainState
from gen_adversarial_tpu.train.trades import make_trades_train_step as jax_trades_step
from gen_adversarial_tpu_torch.core.convert import from_jax_variables, to_jax_variables
from gen_adversarial_tpu_torch.models.avae import model as tavae_model
from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
from gen_adversarial_tpu_torch.models.ndvae.model import DefenceNVAE
from gen_adversarial_tpu_torch.models.nvae.distributions import RecordingDraws
from gen_adversarial_tpu_torch.train import avae as tavae_train
from gen_adversarial_tpu_torch.train import ndvae as tndvae_train
from gen_adversarial_tpu_torch.train.classifier import create_train_state
from gen_adversarial_tpu_torch.train.trades import make_trades_train_step
from tests.torch_port_helpers import (  # noqa: F401 (fixtures)
    TINY_PLAN, keyed_normal_table, no_onednn, one_torch_thread,
    random_variables)

pytestmark = pytest.mark.usefixtures("one_torch_thread", "no_onednn")

# float64 through a network, a double backward and one optimizer step. A
# first Adam(ax) step is lr x G / (|G| + eps): where a true gradient is 0 (a
# bias before an InstanceNorm or a training BatchNorm) float64 rounding noise
# still moves the parameter by up to ~1e-5 x lr. So each parameter is held
# by the gradient its step implies, G = eps a / (1 - |a|) for a = (p0 - p1) /
# lr, within STEP_GRAD_RTOL of the tree's largest implied gradient, unless
# the parameters themselves agree within STEP_ATOL.
STEP_ATOL = 1e-12
STEP_GRAD_RTOL = 1e-6
# losses, the SGD step and running statistics, relative
F64_RTOL = 1e-9
# JAX's align_corners resize (the ND-VAE's upsampling skip) builds its
# interpolation weights in float32, so its float64 ND-VAE differs from a
# float64 one by ~1e-7 (relative)
ND_RTOL = 1e-6
LR = 1e-3
B = 2


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


def _leaf(tree: dict, path):
    for k in path:
        tree = tree[k.key]
    return np.asarray(tree)


def _assert_tree_close(got: dict, want, atol=0.0, rtol=F64_RTOL):
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(_leaf(got, path), np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _assert_step_close(got: dict, want, before, lr_of, eps, grad_rtol=STEP_GRAD_RTOL):
    """Parameters after one first Adam(ax) step, by the gradient each implies
    (see STEP_ATOL)."""
    def implied(p0, p1, lr):
        a = np.clip((p0 - p1) / lr, -1 + 1e-15, 1 - 1e-15)
        return eps * a / (1 - np.abs(a))

    leaves = []
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        p0, lr = _leaf(before, path), lr_of(jax.tree_util.keystr(path))
        leaves.append((path, _leaf(got, path), np.asarray(w), implied(p0, np.asarray(w), lr),
                       p0, lr))
    scale = max(np.abs(g).max() for _, _, _, g, _, _ in leaves)
    for path, p_got, p_want, g_want, p0, lr in leaves:
        bad = (np.abs(p_got - p_want) > STEP_ATOL) & (
            np.abs(implied(p0, p_got, lr) - g_want) > grad_rtol * scale)
        assert not bad.any(), (jax.tree_util.keystr(path), np.abs(p_got - p_want).max())


# ---- A-VAE ------------------------------------------------------------------

SIZE, KERNEL = 64, 2
# XLA:CPU's float64 convolutions are slow: the A-VAE steps take one image
AVAE_B = 1


def _uniform_patch(monkeypatch, value):
    """jax.random.uniform of the penalty's (AVAE_B, 1, 1, 1) shape gives `value`."""
    real = jax.random.uniform

    def fake(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        dtype = jnp.result_type(float) if dtype is None else dtype  # float64 under x64
        if tuple(shape) == value.shape:
            return jnp.asarray(value, dtype)
        return real(key, shape, dtype, minval, maxval)

    monkeypatch.setattr(jax.random, "uniform", fake)


@pytest.fixture(scope="module")
def avae_world():
    """JAX's trainers, float64 variables and optimizer states, and the port's
    trainers holding the same weights in float64."""
    gen, disc, init, d_step, g_step, accumulate = javae_train.make_avae_trainers(SIZE, KERNEL, LR)
    g_vars, g_opt, d_vars, d_opt = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), AVAE_B))
    g_vars = random_variables(g_vars, 1)
    d_vars = random_variables(d_vars, 2)
    g_vars, d_vars = _f64(jax.tree.map(np.asarray, g_vars)), _f64(jax.tree.map(np.asarray,
                                                                            d_vars))
    trainers = tavae_train.make_avae_trainers(SIZE, KERNEL, LR, device="cpu")
    from_jax_variables(g_vars, trainers.gen)
    from_jax_variables(d_vars, trainers.disc)
    trainers.gen.double()
    trainers.disc.double()
    rng = np.random.RandomState(3)
    real = rng.uniform(-1, 1, (AVAE_B, SIZE, SIZE, 3))
    return dict(jax=(d_step, g_step, accumulate), g_vars=g_vars, d_vars=d_vars,
                g_opt=_zeros(g_opt), d_opt=_zeros(d_opt), trainers=trainers, real=real,
                rng=rng)


def _zeros(shapes):
    """A fresh optimizer state (zero moments and count) in float64."""
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float64 if jnp.issubdtype(
        s.dtype, jnp.floating) else s.dtype), shapes)


def _gen_draws(rng, key):
    """Numpy draws of one generator call under `key`: JAX's table entries
    and the port's list (NCHW)."""
    k_noise, k_eps = jax.random.split(key)
    noise = [rng.standard_normal((AVAE_B, 4 * 2 ** i, 4 * 2 ** i, 1))
             for i in range(len(javae.avae_generator_plan(SIZE)))]
    eps = rng.standard_normal((AVAE_B, 4, 4, 512))
    entries = list(zip(jax.random.split(k_noise, len(noise)), noise)) + [(k_eps, eps)]
    port = [torch.tensor(n).permute(0, 3, 1, 2) for n in noise]
    return entries, port + [torch.tensor(eps).permute(0, 3, 1, 2)]


def _nchw(a):
    return torch.tensor(a).permute(0, 3, 1, 2)


def _f64_blur(monkeypatch):
    # the JAX blur's taps are a float32 constant; float64 needs float64 taps
    monkeypatch.setattr(javae, "BINOMIAL3", javae.BINOMIAL3.astype(np.float64))


def test_avae_d_step_matches_jax(avae_world, monkeypatch):
    """One critic step: the WGAN loss, the gradient penalty and the critic's
    parameters after Adam, from the same weights and draws."""
    w = avae_world
    _f64_blur(monkeypatch)
    d_step = w["jax"][0]
    key = jax.random.PRNGKey(11)
    kf, _ = jax.random.split(key)
    entries, port_draws = _gen_draws(w["rng"], kf)
    mix = w["rng"].uniform(0, 1, (AVAE_B, 1, 1, 1))
    _uniform_patch(monkeypatch, mix)
    with jax.enable_x64(True):
        new_d, _, wgan, gp = keyed_normal_table(entries)(lambda: d_step(
            w["d_vars"], w["d_opt"], w["g_vars"], jnp.asarray(w["real"]), key))
        new_d = jax.tree.map(np.asarray, new_d)
    t = w["trainers"]
    got_wgan, got_gp = t.d_step(_nchw(w["real"]), port_draws + [torch.tensor(mix)])
    np.testing.assert_allclose(got_wgan.item(), float(wgan), rtol=F64_RTOL)
    np.testing.assert_allclose(got_gp.item(), float(gp), rtol=F64_RTOL)
    assert float(gp) > 0
    _assert_step_close(to_jax_variables(t.disc)["params"], new_d["params"],
                       w["d_vars"]["params"], lambda path: LR, 1e-8)
    w["d_vars"] = new_d  # the g_step runs against the updated critic


def test_avae_g_step_and_accumulate_match_jax(avae_world, monkeypatch):
    """One generator step (KL + adversarial loss, the style MLP at lr x
    0.01) and the EMA shadow's update, after the d_step's critic."""
    w = avae_world
    _f64_blur(monkeypatch)
    _, g_step, accumulate = w["jax"]
    key = jax.random.PRNGKey(13)
    entries, port_draws = _gen_draws(w["rng"], key)
    with jax.enable_x64(True):
        new_g, _, rec, kl = keyed_normal_table(entries)(lambda: g_step(
            w["g_vars"], w["g_opt"], w["d_vars"], jnp.asarray(w["real"]), key))
        ema = jax.tree.map(np.asarray, accumulate(w["g_vars"]["params"], new_g["params"]))
        new_g = jax.tree.map(np.asarray, new_g)
    t = w["trainers"]
    # the port's critic as JAX's (the d_step test leaves them equal)
    from_jax_variables(w["d_vars"], t.disc)
    import copy
    shadow = copy.deepcopy(t.gen)
    got_rec, got_kl = t.g_step(_nchw(w["real"]), port_draws)
    np.testing.assert_allclose(got_rec.item(), float(rec), rtol=F64_RTOL)
    np.testing.assert_allclose(got_kl.item(), float(kl), rtol=F64_RTOL)
    got = to_jax_variables(t.gen)["params"]
    _assert_step_close(got, new_g["params"], w["g_vars"]["params"],
                       lambda path: LR * (0.01 if "style_layers" in path else 1.0), 1e-8)
    # the style MLP moved at lr x 0.01, the rest at lr
    style = np.abs(got["style_layers_1"]["weight"]
                   - w["g_vars"]["params"]["style_layers_1"]["weight"]).max()
    conv = np.abs(got["generator"]["progression_1"]["conv2"]["weight"]
                  - w["g_vars"]["params"]["generator"]["progression_1"]["conv2"]["weight"]).max()
    assert style <= 1.01 * LR * 0.01 and 0.5 * LR <= conv <= 1.01 * LR
    t.accumulate(shadow)
    _assert_tree_close(to_jax_variables(shadow)["params"], ema, atol=1e-13, rtol=0)


# float32 against float64 through the WGAN-GP steps (the double backward
# included), on the float32 run's leaky-ReLU branches: losses and gradients
# relative to the loss and to the module's largest gradient
STEP32_RTOL = 1e-4


def test_avae_float32_steps_match_float64_on_their_branches():
    """A float32 d_step and g_step, as cli/train_avae takes them, against the
    same steps in float64 from the same weights and draws, whose leaky ReLUs
    take the float32 run's branches (models/avae/model.leaky_relu_branches):
    where an input lies within rounding of 0 the two precisions take
    different slopes, and the gradients then differ by up to 3.1e-2, on the
    float32 run's branches by up to 2.4e-5 (12 seeds at batch 1,
    tests/torch_avae_branch_sweep.py)."""
    t32 = tavae_train.make_avae_trainers(SIZE, KERNEL, LR, device="cpu")
    t32.init(torch.Generator().manual_seed(5))
    t64 = tavae_train.make_avae_trainers(SIZE, KERNEL, LR, device="cpu")
    t64.gen.load_state_dict(t32.gen.state_dict())
    t64.disc.load_state_dict(t32.disc.state_dict())
    t64.gen.double()
    t64.disc.double()
    real = torch.rand(2, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(6)) * 2 - 1
    d_rec = RecordingDraws(torch.Generator().manual_seed(7))
    g_rec = RecordingDraws(torch.Generator().manual_seed(8))

    def steps(t, x, masks):
        """(losses, (critic gradients, generator gradients), branches)."""
        replay = masks is not None
        with tavae_model.leaky_relu_branches(masks) as taken:
            d_losses = t.d_step(x, list(d_rec.record) if replay else d_rec)
            d_grads = [p.grad.clone() for p in t.disc.parameters()]
            g_losses = t.g_step(x, list(g_rec.record) if replay else g_rec)
        g_grads = [p.grad.clone() for p in t.gen.parameters()]
        return [*d_losses, *g_losses], (d_grads, g_grads), taken

    l32, grads32, masks = steps(t32, real, None)
    l64, grads64, changed = steps(t64, real.double(), masks)
    print(f"{sum(int(n) for n in changed)} branches changed")
    for got, want in zip(l32, l64):
        assert abs(got.item() - want.item()) <= STEP32_RTOL * abs(want.item()), (got, want)
    for got, want in zip(grads32, grads64):
        scale = max(g.abs().max().item() for g in want)
        err = max((g.double() - w).abs().max().item() for g, w in zip(got, want)) / scale
        assert err <= STEP32_RTOL, err


# ---- ND-VAE -----------------------------------------------------------------

ND_SIZE = 32
# FGSM adversaries as PNGs, pixels that may differ by 1 (see the test)
FGSM_PIXEL_SHARE = 1e-3


def _nd_kwargs(scales):
    return dict(x_channels=3, encoding_channels=4, pre_proc_groups=2, scales=scales,
                groups=1, cells=2, input_dim=ND_SIZE)


def _recorded_eps(model, x, seed):
    """The sampler eps a forward of NCHW x draws, from a seeded generator."""
    rec = RecordingDraws(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.eval()(x, rec)
    return rec.record


@pytest.mark.parametrize("global_step", [0, 100])
def test_ndvae_train_step_matches_jax(global_step):
    """One Adamax step at scales 2: step 0 anneals the KL (beta 1e-4, the
    balanced terms), step 100 of 100 sums it (beta 1). Loss, recon, KL,
    parameters and running statistics."""
    jm = JaxNDVAE(**_nd_kwargs(2))
    variables = _f64(jax.tree.map(np.asarray, random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, ND_SIZE, ND_SIZE, 3)), jax.random.PRNGKey(0))), 5)))
    tm = from_jax_variables(variables, DefenceNVAE(**_nd_kwargs(2), device="cpu")).double()
    rng = np.random.RandomState(7)
    clean = rng.rand(B, ND_SIZE, ND_SIZE, 3)
    adv = np.clip(clean + 0.05 * rng.standard_normal(clean.shape), 0, 1)
    eps = _recorded_eps(tm, torch.tensor(adv).permute(0, 3, 1, 2), 9)
    key = jax.random.PRNGKey(3)
    entries = list(zip(jax.random.split(key, 4), [e.permute(0, 2, 3, 1).numpy() for e in eps]))
    with jax.enable_x64(True):
        tx, step = jndvae_train.make_ndvae_train_step(jm, lr=1e-2, num_total_iter=100)
        opt = tx.init(variables["params"])
        new_vars, _, loss, recon, kl = keyed_normal_table(entries)(lambda: step(
            variables, opt, {"x_adv": jnp.asarray(adv), "x_orig": jnp.asarray(clean)}, key,
            jnp.float64(global_step)))
        new_vars = jax.tree.map(np.asarray, new_vars)
    _, tstep = tndvae_train.make_ndvae_train_step(tm, lr=1e-2, num_total_iter=100)
    got = tstep({"x_adv": torch.tensor(adv), "x_orig": torch.tensor(clean)}, list(eps),
                global_step)
    for g, w in zip(got, (loss, recon, kl)):
        np.testing.assert_allclose(g.item(), float(w), rtol=ND_RTOL)
    tree = to_jax_variables(tm)
    _assert_step_close(tree["params"], new_vars["params"], variables["params"],
                       lambda path: 1e-2, 1e-3, ND_RTOL)
    _assert_tree_close(tree["batch_stats"], new_vars["batch_stats"], atol=ND_RTOL * 0.1,
                       rtol=ND_RTOL)


def test_ndvae_train_step_at_one_scale_raises_in_both_packages():
    """scales 1 (the ids config, the celeba64 recipe): the balanced KL's
    alpha[1:] is empty. JAX fails while tracing the step; the port when it
    makes it."""
    jm = JaxNDVAE(**_nd_kwargs(1))
    variables = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, ND_SIZE, ND_SIZE, 3)), jax.random.PRNGKey(0)))
    tx, step = jndvae_train.make_ndvae_train_step(jm, lr=1e-2, num_total_iter=100)
    x = jnp.zeros((B, ND_SIZE, ND_SIZE, 3))
    with pytest.raises((TypeError, ValueError)):
        jax.eval_shape(step, variables, jax.eval_shape(tx.init, variables["params"]),
                       {"x_adv": x, "x_orig": x}, jax.random.PRNGKey(1), jnp.float32(0))
    with pytest.raises(ValueError, match="at least 2 scales"):
        tndvae_train.make_ndvae_train_step(DefenceNVAE(**_nd_kwargs(1), device="cpu"),
                                           lr=1e-2, num_total_iter=100)


def test_generate_fgsm_dataset_matches_jax(tmp_path):
    """FGSM adversaries of a folder of PNGs (two classes, 32 px) against a
    tiny VGG, written by both packages: the same files (the sources with a
    .png suffix, in their class folders), their pixels the
    truncated (adv * 255) of float32 adversaries that differ by rounding, so
    a pixel may stand 1 apart where its value lies within rounding of an
    integer (at most FGSM_PIXEL_SHARE of them)."""
    from PIL import Image

    from gen_adversarial_tpu.data.datasets import ImageLabelDataset as JaxDataset
    from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset

    rng = np.random.RandomState(9)
    for cls in ("a", "b"):
        (tmp_path / "data" / cls).mkdir(parents=True)
        for i in range(3):
            Image.fromarray((rng.rand(32, 32, 3) * 255).astype(np.uint8)).save(
                tmp_path / "data" / cls / f"{i}.png")
    jm = JaxVGG(n_classes=2, plan=TINY_PLAN)
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)), 10)
    tm = from_jax_variables(jax.tree.map(np.asarray, variables),
                            VGG11BN(2, plan=TINY_PLAN, device="cpu")).eval()
    jndvae_train.generate_fgsm_dataset(
        lambda x: jm.apply(variables, (x - 0.5) / 0.5, train=False),
        JaxDataset(str(tmp_path / "data"), 32), 2.0, str(tmp_path / "jax"), batch_size=4)
    tndvae_train.generate_fgsm_dataset(
        lambda x: tm(((x - 0.5) / 0.5).permute(0, 3, 1, 2)),
        ImageLabelDataset(str(tmp_path / "data"), 32), 2.0, str(tmp_path / "port"),
        batch_size=4, device="cpu")
    names = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.png"))
    assert len(names) == 6
    assert names == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*.png"))
    moved = 0
    for name in names:
        want = np.asarray(Image.open(tmp_path / "jax" / name), np.int32)
        got = np.asarray(Image.open(tmp_path / "port" / name), np.int32)
        src = np.asarray(Image.open(tmp_path / "data" / name), np.int32)
        assert np.abs(got - want).max() <= 1
        assert np.mean(got != want) <= FGSM_PIXEL_SHARE
        moved += int(np.any(want != src))
    assert moved > 0  # FGSM leaves an image that is already misclassified as it is


@pytest.mark.parametrize("scales", [1, 2, 3])
def test_kl_balancer_coeff_matches_jax(scales):
    want = np.asarray(jndvae_train.kl_balancer_coeff(scales, scales))
    got = tndvae_train.kl_balancer_coeff(scales, scales)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ---- TRADES -----------------------------------------------------------------

TRADES_SIZE = 32
TRADES_STEPS = 3


def test_trades_step_matches_jax():
    """One TRADES step on a tiny VGG (ids recipe: eps 2.0, beta 1.0; 3 inner
    steps): the loss, the parameters after SGD with momentum and the
    running statistics after its two training-mode forwards."""
    jm = JaxVGG(n_classes=4, plan=TINY_PLAN)
    variables = _f64(jax.tree.map(np.asarray, random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, TRADES_SIZE, TRADES_SIZE, 3)), train=False)), 3)))
    tm = from_jax_variables(variables, VGG11BN(4, plan=TINY_PLAN, device="cpu")).double()
    rng = np.random.RandomState(17)
    x = rng.rand(4, TRADES_SIZE, TRADES_SIZE, 3)
    y = rng.randint(0, 4, 4)
    draws = [rng.standard_normal(x.shape) for _ in range(TRADES_STEPS + 1)]
    key = jax.random.PRNGKey(19)
    with jax.enable_x64(True):
        state = JaxTrainState.create(apply_fn=jm.apply, params=variables["params"],
                                     tx=optax.sgd(0.01, momentum=0.9),
                                     batch_stats=variables["batch_stats"])
        step = jax_trades_step(beta=1.0, epsilon=2.0, perturb_steps=TRADES_STEPS)
        state, loss = keyed_normal_table(list(zip(jax.random.split(key, TRADES_STEPS + 1),
                                                  draws)))(
            lambda: step(state, {"image": jnp.asarray(x), "label": jnp.asarray(y)}, key))
        want_params = jax.tree.map(np.asarray, state.params)
        want_stats = jax.tree.map(np.asarray, state.batch_stats)
    tstate = create_train_state(tm, 0.01)
    got = make_trades_train_step(1.0, 2.0, TRADES_STEPS)(
        tstate, {"image": x, "label": y}, [torch.tensor(d) for d in draws])
    np.testing.assert_allclose(got.item(), float(loss), rtol=F64_RTOL)
    tree = to_jax_variables(tm)
    # SGD's first step is p - lr G: no amplification
    _assert_tree_close(tree["params"], want_params, atol=1e-12)
    _assert_tree_close(tree["batch_stats"], want_stats)
    assert tstate.step == 1
