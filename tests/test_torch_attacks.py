"""The port's attacks (gen_adversarial_tpu_torch/attacks) against the JAX
package's on the CPU: the attack math (projection_l2 on rows that take each
of its branches, l2_norm / normalize, the DLR loss), class_grads through a
small conv classifier (chunked and unchunked, and the torch.autograd route
against torch.func) and through K2's batching rule, every attack against its JAX twin on the deterministic
linear net of tests/test_attack_parity.py (NHWC flattened in NCHW order),
with the same numpy noise injected on both sides where an attack draws, the
staged AutoAttack against the monolithic one, the attack suites, and FAB and
DeepFool in their default blocks (utils.class_block) against one block."""

import dataclasses
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import vjp, vmap

from gen_adversarial_tpu import attacks as jattacks
from gen_adversarial_tpu.attacks.apgd import _check_schedule as jax_check_schedule
from gen_adversarial_tpu.attacks.apgd import dlr_loss as jax_dlr_loss
from gen_adversarial_tpu.attacks.utils import class_grads as jax_class_grads
from gen_adversarial_tpu.core.config import ATTACK_SUITES as JAX_SUITES
from gen_adversarial_tpu.defenses.base import ClassifierDefense as JaxClassifierDefense
from gen_adversarial_tpu.defenses.base import make_classifier_apply as jax_classifier_apply
from gen_adversarial_tpu.models.classifiers import VGG11BN as JaxVGG
from gen_adversarial_tpu_torch import attacks
from gen_adversarial_tpu_torch.attacks import utils
from gen_adversarial_tpu_torch.attacks.apgd import _check_schedule, dlr_loss
from gen_adversarial_tpu_torch.core.config import ATTACK_SUITES
from gen_adversarial_tpu_torch.defenses.base import ClassifierDefense, make_classifier_apply
from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.eval.factory import build_attacks
from gen_adversarial_tpu_torch.flagship import flagship
from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
from gen_adversarial_tpu_torch.models.nvae.model import NVAEConfig
from gen_adversarial_tpu_torch.ops import upfirdn as k2
from tests.torch_port_helpers import (  # noqa: F401 (one_torch_thread: a fixture)
    load_port, one_torch_thread, random_variables)

# one torch thread (see the fixture): the suite runs several workers on few cores
pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the module, which the package's `autoattack` function shadows
autoattack_module = importlib.import_module("gen_adversarial_tpu_torch.attacks.autoattack")

KEY = jax.random.PRNGKey(0)
SHAPE = (4, 4, 3)  # H, W, C
D = int(np.prod(SHAPE))
N_CLASSES = 5
B = 4


# ---- the attack math -------------------------------------------------------

def _branches(t, w, b):
    """Which branch of projection_l2 each row takes (c4: the plain hyperplane
    projection, c3: the box corner, c2: the binary search), recomputed from
    the reference's formulas in float64."""
    c = (w * t).sum(1) - b[:, 0]
    sign = np.where(c >= 0, 1.0, -1.0)
    w, c = w * sign[:, None], c * sign
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.clip(np.maximum(t / w, (t - 1) / w), -1e12, 1e12)
    r = np.where(np.abs(w) < 1e-8, 1e12, r)
    r = np.where(r == -1e12, 1e12, r)
    rs0 = np.sort(r, 1)[:, 0]
    rs0 = np.where(rs0 == 1e12, 0.0, rs0)
    d = -(r * w) * (np.abs(w) > 1e-8)
    c4 = -(w ** 2).sum(1) * rs0 + c < 0
    c3 = (d * w).sum(1) + c > 0
    return c4, c3 & ~c4, ~(c4 | c3)


@pytest.mark.parametrize("d_dim", [20, 48])
def test_projection_l2_matches_jax(d_dim):
    """Rows with every branch: the offset b scaled from near the point's own
    w.t (c4) to far beyond the box (c3), with entries of |w| < 1e-8 in
    some rows. float32 on both sides, the same sort (stable) and sums in
    another order: 1e-5."""
    rng = np.random.RandomState(d_dim)
    n = 48
    t = rng.rand(n, d_dim).astype(np.float32)
    w = rng.randn(n, d_dim).astype(np.float32)
    w[::4, :3] = 0.0        # |w| < 1e-8: masked out of d
    w[1::4, 3] = 1e-9
    scale = np.repeat([0.01, 0.5, 2.0, 20.0], n // 4)[rng.permutation(n)]
    b = ((w * t).sum(1) + scale * rng.randn(n) * np.sqrt(d_dim))[:, None].astype(np.float32)
    c4, c3, c2 = _branches(t.astype(np.float64), w.astype(np.float64), b.astype(np.float64))
    assert c4.sum() >= 3 and c3.sum() >= 3 and c2.sum() >= 3
    want = np.asarray(jattacks.projection_l2(jnp.asarray(t), jnp.asarray(w), jnp.asarray(b)))
    got = attacks.projection_l2(torch.tensor(t), torch.tensor(w), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[np.abs(w) < 1e-8] == 0)


def test_l2_norm_normalize_and_dlr_loss_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 4, 5, 2).astype(np.float32)
    x[1] = 0.0  # normalize's floor
    np.testing.assert_allclose(attacks.l2_norm(torch.tensor(x)).numpy(),
                               np.asarray(jattacks.l2_norm(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(attacks.normalize(torch.tensor(x)).numpy(),
                               np.asarray(jattacks.normalize(jnp.asarray(x))), rtol=1e-6)
    logits = rng.randn(6, 5).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 4, int(np.argmax(logits[5]))])
    np.testing.assert_allclose(
        dlr_loss(torch.tensor(logits), torch.tensor(labels)).numpy(),
        np.asarray(jax_dlr_loss(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
    with pytest.raises(AttributeError):
        dlr_loss(torch.zeros(2, 3), torch.zeros(2, dtype=torch.long))


@pytest.mark.parametrize("n_iter", [4, 10, 64, 100])
def test_apgd_checkpoint_schedule_matches_jax(n_iter):
    assert _check_schedule(n_iter) == jax_check_schedule(n_iter).tolist()


# ---- class_grads through a small conv classifier ---------------------------

CLF_PLAN = (8, "M", 16, "M", 16, "M")
CLF_CLASSES = 7
CLF_SIZE = 16
# ~10 float32 layers forward and back in other summation orders, relative to
# the largest entry
GRAD_RTOL = 1e-5
# chunked against unchunked: the vmap over a block folds it into the batch
# of every convolution of the backward, and another batch may sum in
# another order (measured 1.9e-6 on the small gender defense)
CHUNK_RTOL = 1e-5


@pytest.fixture(scope="module")
def classifier():
    """The JAX and port ClassifierDefense over a narrow VGG11-BN, same
    weights, with the 0.5 / 0.5 classifier normalization."""
    jclf = JaxVGG(n_classes=CLF_CLASSES, plan=CLF_PLAN)
    variables = random_variables(jax.eval_shape(
        lambda: jclf.init(KEY, jnp.zeros((1, CLF_SIZE, CLF_SIZE, 3)), train=False)), 2)
    port = load_port(VGG11BN(CLF_CLASSES, plan=CLF_PLAN, device="cpu"), variables)
    jdef = JaxClassifierDefense(variables, jax_classifier_apply(jclf))
    tdef = ClassifierDefense(port, make_classifier_apply(port))
    x = np.random.RandomState(5).rand(3, CLF_SIZE, CLF_SIZE, 3).astype(np.float32)
    return dict(jnet=lambda k, v: jdef(k, v), tnet=lambda v, d: tdef(v, d), x=x)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("selected,chunk", [(False, None), (False, 3), (True, None), (True, 2)],
                         ids=["all", "all-chunk3", "top3", "top3-chunk2"])
def test_class_grads_match_jax(classifier, selected, chunk):
    """All 7 classes (chunk 3: blocks of 3 + 3 + 1 padded) or the top 3 of
    each sample (chunk 2: 2 + 1 padded), port against JAX; and the chunked
    port result equal to the unchunked one."""
    x = classifier["x"]
    jl, _ = jax_class_grads(classifier["jnet"], KEY, jnp.asarray(x))
    idx = np.argsort(-np.asarray(jl), axis=1, kind="stable")[:, :3] if selected else None
    jidx = None if idx is None else jnp.asarray(idx)
    tidx = None if idx is None else torch.tensor(idx)
    want_l, want = jax_class_grads(classifier["jnet"], KEY, jnp.asarray(x), jidx)
    got_l, got = attacks.class_grads(classifier["tnet"], torch.tensor(x), None, tidx,
                                     cotangent_chunk=chunk)
    assert got.shape == ((3 if selected else CLF_CLASSES), 3, CLF_SIZE, CLF_SIZE, 3)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-5, atol=1e-6)
    assert _rel(got, want) <= GRAD_RTOL
    if chunk is not None:
        _, whole = attacks.class_grads(classifier["tnet"], torch.tensor(x), None, tidx)
        assert _rel(got, whole) <= CHUNK_RTOL


def test_class_grads_autograd_route_matches_func_vjp(classifier):
    """Without remat, the torch.autograd route (torch.autograd.grad under
    torch.func.vmap) gives what torch.func.vjp + vmap over the one-hot
    cotangents gives."""
    x = torch.tensor(classifier["x"])
    tnet = classifier["tnet"]
    _, got = attacks.class_grads(tnet, x, None)
    logits, vjp_fn = vjp(lambda v: tnet(v, None), x)
    onehots = torch.eye(CLF_CLASSES)[:, None, :].expand(CLF_CLASSES, 3, CLF_CLASSES)
    (want,) = vmap(vjp_fn)(onehots)
    assert _rel(got, want.detach()) <= 1e-6


def test_class_grads_reach_the_blur_kernels_batching_rule(monkeypatch):
    """K2's backward applies its Function again; under class_grads that call
    must take the Function's vmap rule, which folds the cotangents into N
    for one launch on the card (torch.autograd.grad's is_grads_batched uses
    an older vmap that skips the rule and hands the kernel a batched
    tensor)."""
    seen = []
    rule = k2._Blur.vmap

    def spy(info, in_dims, *args):
        seen.append(info.batch_size)
        return rule(info, in_dims, *args)

    monkeypatch.setattr(k2._Blur, "vmap", staticmethod(spy))
    w = torch.tensor(np.random.RandomState(3).randn(8 * 8 * 4, 5).astype(np.float32))

    def net(x, draws):
        y = k2.upfirdn_blur(x.permute(0, 3, 1, 2), (0.25, 0.75, 0.75, 0.25), (1, 1))
        return y.reshape(x.shape[0], -1) @ w

    x = torch.tensor(np.random.RandomState(4).rand(2, 9, 9, 4).astype(np.float32))
    _, grads = attacks.class_grads(net, x, None, cotangent_chunk=3)
    assert seen == [3, 3] and grads.shape == (5, 2, 9, 9, 4)
    for c in range(5):
        v = x.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(net(v, None)[:, c].sum(), v)
        torch.testing.assert_close(grads[c], want, rtol=1e-5, atol=1e-6)


# ---- every attack on the deterministic linear net --------------------------

@pytest.fixture(scope="module")
def linear():
    """The linear net of tests/test_attack_parity.py written twice (NHWC
    input, flattened in NCHW order), and B samples of moderate margin."""
    rng = np.random.RandomState(0)
    w = rng.randn(D, N_CLASSES).astype(np.float32)
    bias = (rng.randn(N_CLASSES) * 0.1).astype(np.float32)
    wj, bj = jnp.asarray(w), jnp.asarray(bias)
    wt, bt = torch.tensor(w), torch.tensor(bias)

    def sample(seed):
        r = np.random.RandomState(seed)
        for _ in range(50):
            x = r.rand(1, 3, 4, 4).astype(np.float32) * 0.6 + 0.2
            logits = x.reshape(-1) @ w + bias
            y = int(np.argmax(logits))
            margin = min((logits[y] - logits[c]) / np.linalg.norm(w[:, y] - w[:, c])
                         for c in range(N_CLASSES) if c != y)
            if 0.05 < margin < 0.5:
                return x, y
        raise RuntimeError("no sample found")

    xs, ys = zip(*[sample(s) for s in (6, 7, 8, 9)])
    return dict(
        jnet=lambda k, x: jnp.transpose(x, (0, 3, 1, 2)).reshape(x.shape[0], -1) @ wj + bj,
        tnet=lambda x, draws: x.permute(0, 3, 1, 2).reshape(x.shape[0], -1) @ wt + bt,
        x=np.concatenate(xs).transpose(0, 2, 3, 1).copy(), y=np.asarray(ys))


def _keyed_normal(table):
    """jax.random.normal replaced by a lookup of the key in `table` (key
    bytes -> array), traceable (C&W draws inside a lax.scan); other keys
    give NaN and fail the test."""
    keys = jnp.asarray(np.stack([np.frombuffer(k, np.uint32) for k in table]))
    vals = jnp.asarray(np.stack(list(table.values())))

    def fake_normal(k, shape=(), dtype=jnp.float32):
        match = jnp.all(keys == k, axis=-1)
        return jnp.where(jnp.any(match), vals[jnp.argmax(match)], jnp.nan).astype(dtype)

    return fake_normal


def _with_normal(fake, fn):
    real = jax.random.normal
    jax.random.normal = fake
    try:
        return fn()
    finally:
        jax.random.normal = real


def _replayed_normal(replay):
    """jax.random.normal replaced by the next array of `replay` for its
    shape, in call order (APGD draws once per call, outside its loop)."""
    real = jax.random.normal

    def fake_normal(k, shape=(), dtype=jnp.float32):
        if replay and tuple(shape) == replay[0].shape:
            return jnp.asarray(replay.pop(0), dtype)
        return real(k, shape, dtype)

    return fake_normal


def _noise(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, *SHAPE).astype(np.float32) for _ in range(n)]


def _run_fgsm(jnet, tnet, x, y):
    return (jattacks.fgsm_attack(KEY, jnet, x, y, 0.5),
            attacks.fgsm_attack(tnet, torch.tensor(np.asarray(x)), torch.tensor(np.asarray(y)),
                                torch.Generator(), 0.5))


def _run_deepfool(jnet, tnet, x, y):
    kw = dict(num_classes=N_CLASSES, overshoot=0.02, max_iter=50)
    return (jattacks.deepfool_attack(KEY, jnet, x, y, **kw),
            attacks.deepfool_attack(tnet, torch.tensor(np.asarray(x)),
                                    torch.tensor(np.asarray(y)), torch.Generator(), **kw))


def _run_cw(jnet, tnet, x, y):
    """Two restarts, each with its numpy noise: JAX draws it with the second
    of the four keys split from the restart's key."""
    kw = dict(c=1.0, kappa=0.0, steps=25, lr=1e-2, n_restarts=2, early_stopping_steps=5)
    noise = _noise(21, 2)
    table = {np.asarray(jax.random.split(rk, 4)[1]).tobytes(): n
             for rk, n in zip(jax.random.split(KEY, 2), noise)}
    want = _with_normal(_keyed_normal(table),
                        lambda: jattacks.cw_attack(KEY, jnet, x, y, **kw))
    got = attacks.cw_attack(tnet, torch.tensor(np.asarray(x)), torch.tensor(np.asarray(y)),
                            [torch.tensor(n) for n in noise], **kw)
    return want, got


def _run_apgd(ce, n_iter):
    def run(jnet, tnet, x, y):
        noise = _noise(31, 1)
        want = _with_normal(_replayed_normal(list(noise)), lambda: jattacks.apgd_attack(
            KEY, jnet, x, y, n_iter, 0.75, 1.0, ce))
        got = attacks.apgd_attack(tnet, torch.tensor(np.asarray(x)), torch.tensor(np.asarray(y)),
                                  [torch.tensor(noise[0])], n_iter, 0.75, 1.0, ce)
        return want, got
    return run


def _run_fab(jnet, tnet, x, y):
    kw = dict(n_iter=20, alpha_max=0.1, eta=1.05, beta=0.9)
    return (jattacks.fab_attack(KEY, jnet, x, y, **kw),
            attacks.fab_attack(tnet, torch.tensor(np.asarray(x)), torch.tensor(np.asarray(y)),
                               torch.Generator(), **kw))


def _run_autoattack(jnet, tnet, x, y):
    """The six APGD stages each draw their start in stage order on both
    sides (a replayed source is shared by the stages)."""
    noise = _noise(41, 6)
    want = _with_normal(_replayed_normal(list(noise)), lambda: jattacks.autoattack(
        KEY, jnet, x, y, n_classes=N_CLASSES))
    got = attacks.autoattack(tnet, torch.tensor(np.asarray(x)), torch.tensor(np.asarray(y)),
                             [torch.tensor(n) for n in noise], n_classes=N_CLASSES)
    return want, got


# float32 on both sides, matrix products summed in another order: bounds and
# adversarial images to 1e-5. APGD-CE runs 10 iterations: past that, on this
# net, its CE loss sits at its maximum on the sphere, `loss > best_loss`
# compares values equal to float32 rounding, and the two sides keep other
# best points (1e-4 apart at 20 iterations); APGD-DLR stays apart by 4e-7
# over 30.
ATTACK_TOL = dict(rtol=1e-5, atol=1e-5)
RUNS = {"fgsm": _run_fgsm, "deepfool": _run_deepfool, "cw": _run_cw,
        "apgd_ce": _run_apgd(True, 10), "apgd_dlr": _run_apgd(False, 30), "fab": _run_fab,
        "autoattack": _run_autoattack}


@pytest.mark.parametrize("name", list(RUNS))
def test_attack_matches_jax_on_linear_net(linear, name):
    x, y = jnp.asarray(linear["x"]), jnp.asarray(linear["y"])
    want, got = RUNS[name](linear["jnet"], linear["tnet"], x, y)
    s, bound, adv = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(got[0].numpy(), s)
    assert s.any(), "no sample succeeded: the comparison would be empty"
    np.testing.assert_allclose(got[1].numpy(), bound, **ATTACK_TOL)
    np.testing.assert_allclose(got[2].numpy(), adv, **ATTACK_TOL)
    assert got[2].shape == (B, *SHAPE) and got[1].dtype == torch.float32


def test_staged_autoattack_equals_monolithic(linear, monkeypatch):
    """A stochastic net (the linear net of a noisy input) and a generator:
    the staged ensemble skips the APGD stages whose samples are all solved,
    and still gives exactly the monolithic result, because every stage
    draws from a generator of its own."""
    tnet = linear["tnet"]

    def noisy(x, draws):
        return tnet(x + 0.01 * draws.normal(x.shape, x), None)

    calls = []
    real_apgd = autoattack_module.apgd_attack

    def counting_apgd(*args, **kw):
        calls.append(args[6])
        return real_apgd(*args, **kw)

    monkeypatch.setattr(autoattack_module, "apgd_attack", counting_apgd)
    x, y = torch.tensor(linear["x"]), torch.tensor(linear["y"])
    mono = attacks.autoattack(noisy, x, y, torch.Generator().manual_seed(3), n_classes=N_CLASSES)
    n_mono, calls[:] = len(calls), []
    staged = attacks.make_staged_autoattack(N_CLASSES)(noisy, x, y,
                                                       torch.Generator().manual_seed(3))
    assert n_mono == 6 and len(calls) < n_mono, (n_mono, calls)
    for a, b in zip(mono, staged):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_attack_suites_and_build_attacks_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in ATTACK_SUITES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SUITES.items()}
    for experiment, n_classes in (("ids", 100), ("gender", 2), ("cars", 4)):
        suite = build_attacks(experiment, n_classes, deepfool_chunk=4, fab_chunk=5)
        s = ATTACK_SUITES[experiment]
        assert suite["deepfool"].keywords == dict(
            num_classes=s.deepfool_num_classes, overshoot=s.deepfool_overshoot,
            max_iter=s.deepfool_max_iter, cotangent_chunk=4)
        assert suite["c&w"].keywords == dict(
            c=s.cw_c, kappa=s.cw_kappa, steps=s.cw_steps, lr=s.cw_lr,
            n_restarts=s.cw_n_restarts, early_stopping_steps=s.cw_early_stopping_steps)
        assert suite["autoattack"].keywords == dict(n_classes=n_classes, cotangent_chunk=5)


@pytest.fixture(scope="module")
def small_ids_net():
    """A small ids defense over 100 classes (a 32-px NVAE of 2 x 2 groups, a
    tiny VGG) under EoT-2."""
    cfg = NVAEConfig(resolution=32, initial_channels=8, num_scales=2, num_groups_per_scale=2,
                     is_adaptive=False, num_cells_per_group=1, num_latent_per_group=4,
                     num_mixtures=3)
    plan = (4, "M", 8, "M", 8, 8, "M", 8, 8, "M", 8, 8, "M")
    return eot_wrap(flagship(device="cpu", cfg=cfg, vgg_plan=plan, n_classes=100, seed=1), 2)


# the attack, its images, its classes, the default block at that batch, and
# the one-block chunk (FAB's None; DeepFool's None is now the default block)
DEFAULT_BLOCK_CASES = {"fab": (2, 100, 8, None), "deepfool": (8, 8, 2, 8)}


def test_fab_default_block_equals_one_block(small_ids_net, monkeypatch):
    _default_block_equals_one_block(small_ids_net, monkeypatch, "fab")


def test_deepfool_default_block_equals_one_block(small_ids_net, monkeypatch):
    _default_block_equals_one_block(small_ids_net, monkeypatch, "deepfool")


def _default_block_equals_one_block(small_ids_net, monkeypatch, attack):
    """FAB and DeepFool on the small ids defense, from the same draws, with
    the default block where none is given (utils.class_block: 16 cotangent
    samples a backward, so 8 of FAB's 100 classes at a batch of 2 and 2 of
    DeepFool's 8 at the CLI's batch of 8) as with one block of every class;
    FAB called with the block as autoattack._run passes it (2 steps),
    DeepFool with none (3 steps). Neither finds an adversary on this random
    defense at these depths, so their iterates are held too: each step's
    point, logits and class gradients, recorded at utils.class_grads with the
    block each run took. DeepFool's success, bounds, images, step count and
    iterates are equal exactly (the blocks' gradients came out bit for bit
    the same here); FAB's images and iterates within CHUNK_RTOL."""
    n_images, n_classes, block, one_block = DEFAULT_BLOCK_CASES[attack]
    assert utils.class_block(n_classes, n_images) == block
    net = small_ids_net
    x = torch.tensor(np.random.RandomState(4).rand(n_images, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        y = net(x, torch.Generator().manual_seed(2)).argmax(1)
    module = importlib.import_module(f"gen_adversarial_tpu_torch.attacks.{attack}")
    class_grads, steps = module.class_grads, []

    def recorded(net, x_i, draws, *args, **kw):
        logits, grads = class_grads(net, x_i, draws, *args, **kw)
        steps[-1].append((kw["cotangent_chunk"], x_i, logits, grads))
        return logits, grads

    monkeypatch.setattr(module, "class_grads", recorded)
    runs = []
    for chunk in (None, one_block) if attack == "deepfool" else (block, None):
        steps.append([])
        if attack == "fab":
            runs.append(autoattack_module.fab_attack(
                net, x, y, torch.Generator().manual_seed(5), n_iter=2, cotangent_chunk=chunk))
        else:
            runs.append(attacks.deepfool_attack(
                net, x, y, torch.Generator().manual_seed(5), num_classes=n_classes,
                max_iter=3, return_iters=True, cotangent_chunk=chunk))
    (got_s, got_b, got_a, *got_n), (want_s, want_b, want_a, *want_n) = runs
    assert [s[0] for s in steps[0]] == [block] * len(steps[0])
    assert [s[0] for s in steps[1]] == [one_block] * len(steps[1])
    assert len(steps[0]) == len(steps[1]) == (3 if attack == "deepfool" else 2)
    assert got_n == want_n == ([3] if attack == "deepfool" else [])
    assert torch.equal(got_s, want_s) and torch.equal(got_b, want_b)
    tol = 0.0 if attack == "deepfool" else CHUNK_RTOL
    torch.testing.assert_close(got_a, want_a, rtol=0, atol=tol)
    assert (steps[0][-1][1] - x).abs().max() > 0.01  # the last step's point moved
    for got, want in zip(steps[0], steps[1]):
        for g, w in zip(got[1:], want[1:]):
            assert (g - w).abs().max() <= tol * w.abs().max()
