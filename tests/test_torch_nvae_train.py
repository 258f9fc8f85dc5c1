"""The port's NVAE training pieces against the JAX package on the CPU: the
Normal's log density and KL, the discretized logistic mixture's log_prob
(at the asymmetric edges) and sample, the training forward with and without
flow cells and the batch statistics it leaves, reconstruction_loss, sample,
reconstruct in both modes, and one full make_nvae_train_step step (Adamax)
at beta < 1 and beta = 1 with input noise.

Weights are carried over by core/convert.from_jax_variables. Every draw is
JAX's own: each key's normals and uniforms are computed with
jax.random.normal / uniform as the JAX code splits them, and replayed into
the port through a `Draws` list (NHWC -> NCHW where the port is NCHW)."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gen_adversarial_tpu.models.nvae import distributions as jdist
from gen_adversarial_tpu.models.nvae.model import NVAE as JaxNVAE
from gen_adversarial_tpu.models.nvae.model import NVAEConfig as JaxNVAEConfig
from gen_adversarial_tpu.train import nvae as jtrain
from gen_adversarial_tpu_torch.core.convert import to_jax_variables
from gen_adversarial_tpu_torch.models.nvae import cells as tcells
from gen_adversarial_tpu_torch.models.nvae import distributions as tdist
from gen_adversarial_tpu_torch.models.nvae.model import NVAE, NVAEConfig, eps_shapes
from gen_adversarial_tpu_torch.train import nvae as ttrain
from gen_adversarial_tpu_torch.models import batchnorm
from tests.torch_port_helpers import (  # noqa: F401 (fixtures)
    assert_bn_buffers_close, bn_buffer_errors, load_port, no_onednn, nvae_train_step,
    one_torch_thread, random_variables, rel_err, small_nvae_train_case)

pytestmark = pytest.mark.usefixtures("one_torch_thread", "no_onednn")

CFG = dict(resolution=16, initial_channels=8, n_pre_post_blocks=1, n_pre_post_cells=2,
           num_scales=2, num_groups_per_scale=2, is_adaptive=False,
           num_cells_per_group=1, num_latent_per_group=4, num_mixtures=3)
B = 2
# elementwise densities in float32, one op order apart
DIST_TOL = dict(rtol=1e-5, atol=1e-5)
# ~30 float32 convolution layers in another summation order (the logits, the
# KL sums over a group's latents, the images), and batch statistics over them
FORWARD_TOL = dict(rtol=1e-4, atol=1e-4)
# the loss, and the parameters after one Adamax step at lr 6e-3 (see
# _assert_first_adamax_step_close)
STEP_TOL = dict(rtol=1e-4, atol=2e-5)
LR, ADAMAX_EPS = 6e-3, 1e-3
# a gradient element recovered from the step, against the largest gradient:
# float32 noise of sums over every pixel of the batch
GRAD_NOISE = 1e-5


def _nchw(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _assert_trees_close(got: dict, want, what: str, **tol):
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    assert flat
    for path, w in flat:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), err_msg=f"{what} {path}",
                                   **tol)


def _assert_first_adamax_step_close(before, got, want, grad_scale):
    """The parameters after a first Adamax step (decay 1e-4 in the gradient
    G), port against JAX. The step is p - lr * G / (|G| + eps): where |G|
    is far above eps every element moves by lr and the two agree within
    STEP_TOL; where G is near or below eps the step magnifies G's float32
    noise (the loss sums over every pixel, its gradients reach hundreds, and
    biases followed by a training BatchNorm have a true gradient of 0 that
    is all noise), so there each side's G, recovered from its step as
    eps * a / (1 - |a|) with a = (p - p') / lr, must agree within
    GRAD_NOISE x the largest gradient."""
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    for path, w in flat:
        g, p0 = got, before
        for k in path:
            g, p0 = g[k.key], p0[k.key]
        g, w, p0 = (np.asarray(a, np.float64) for a in (g, w, p0))
        close = np.abs(g - w) <= STEP_TOL["atol"] + STEP_TOL["rtol"] * np.abs(w)
        # |a| rounds to 1 in float32 where |G| >> eps; there `close` holds
        a_got, a_want = (np.clip((p0 - v) / LR, -0.999999, 0.999999) for v in (g, w))
        g_got = ADAMAX_EPS * a_got / (1 - np.abs(a_got))
        g_want = ADAMAX_EPS * a_want / (1 - np.abs(a_want))
        close |= np.abs(g_got - g_want) <= GRAD_NOISE * grad_scale
        assert close.all(), (path, np.abs(g - w).max(), np.abs(g_got - g_want)[~close].max(),
                             grad_scale)


def _latent_normals(key, cfg, batch, n_keys):
    """JAX's posterior / prior normals: key split into n_keys, one draw a
    group in draw order, NCHW tensors."""
    keys = jax.random.split(key, n_keys)
    return [_nchw(jax.random.normal(k, (s[0], s[2], s[3], s[1])))
            for k, s in zip(keys, eps_shapes(cfg, batch))]


def _mixture_uniforms(key, b, h, w, m):
    """JAX's DiscMixLogistic.sample uniforms from its key: the gumbel ones
    (B, H, W, M) and the logistic ones (B, H, W, 3), NCHW tensors."""
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, (b, h, w, m), jnp.float32, 1e-5, 1.0 - 1e-5)
    u2 = jax.random.uniform(k2, (b, h, w, 3), jnp.float32, 1e-5, 1.0 - 1e-5)
    return [_nchw(u1), _nchw(u2)]


def test_normal_log_p_and_kl_match_jax():
    rng = np.random.RandomState(0)
    mu, ls, mu2, ls2, s = (rng.randn(2, 4, 3, 3).astype(np.float32) * 3 for _ in range(5))
    jn, jp = jdist.Normal(mu, ls), jdist.Normal(mu2, ls2)
    tn = tdist.Normal(torch.tensor(mu), torch.tensor(ls))
    tp = tdist.Normal(torch.tensor(mu2), torch.tensor(ls2))
    np.testing.assert_allclose(tn.log_p(torch.tensor(s)).numpy(), jn.log_p(s), **DIST_TOL)
    np.testing.assert_allclose(tn.kl(tp).numpy(), jn.kl(jp), **DIST_TOL)


def _mixture_case(m=3, h=4, w=5):
    """Mixture parameters (NHWC, M + 9M channels) and samples in [-1, 1] that
    hit both edges exactly, the thresholds' neighbourhoods and the inside."""
    rng = np.random.RandomState(1)
    params = rng.randn(B, h, w, 10 * m).astype(np.float32)
    params[..., m:] *= 0.5
    values = np.array([-1.0, 1.0, -0.9995, 0.995, -0.998, 0.989, 0.0, 0.3, -0.6, 0.5],
                      np.float32)
    samples = values[rng.randint(0, len(values), (B, h, w, 3))]
    samples[0, 0, 0] = -1.0
    samples[0, 0, 1] = 1.0
    samples[0, 0, 2] = [-0.9995, 0.995, 0.2]
    return params, samples


def test_log_prob_at_the_edges_matches_jax():
    """log_prob and its gradient in the mixture's parameters, at pixels on
    -1, 1, -0.9995 (left tail), 0.995 (right tail), just inside the
    thresholds and inside; the gradient finite everywhere."""
    params, samples = _mixture_case()
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(jdist.DiscMixLogistic(p).log_prob(jnp.asarray(samples)) ** 2)))(
        jnp.asarray(params))
    jlp = jdist.DiscMixLogistic(jnp.asarray(params)).log_prob(jnp.asarray(samples))
    tp = _nchw(params).requires_grad_(True)
    tlp = tdist.DiscMixLogistic(tp).log_prob(_nchw(samples))
    (tlp ** 2).sum().backward()
    np.testing.assert_allclose(tlp.detach().numpy(), np.asarray(jlp), **DIST_TOL)
    g = _nhwc(tp.grad)
    assert np.all(np.isfinite(g))
    # the bin's mass cdf_plus - cdf_min cancels in float32: its log's
    # gradient carries that cancellation in either op order
    assert rel_err(g, jgrad) <= 1e-4


def test_mixture_sample_matches_jax():
    params, _ = _mixture_case()
    key = jax.random.PRNGKey(3)
    want = jdist.DiscMixLogistic(jnp.asarray(params)).sample(key)
    draws = tdist.Draws(_mixture_uniforms(key, B, 4, 5, 3))
    got = tdist.DiscMixLogistic(_nchw(params)).sample(draws)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **DIST_TOL)
    u = jax.random.uniform(key, (B, 4, 5, 3), jnp.float32, 1e-5, 1.0 - 1e-5)
    np.testing.assert_allclose(_nhwc(tdist.gumbel_argmax_one_hot(
        tdist.Draws([_nchw(u)]), _nchw(params[..., :3]))),
        np.asarray(jdist.gumbel_argmax_one_hot(key, jnp.asarray(params[..., :3]))))


def _models(flows: bool):
    cfg = dict(CFG, num_nf_cells=1 if flows else None)
    jcfg, tcfg = JaxNVAEConfig(**cfg), NVAEConfig(**cfg)
    jnvae = JaxNVAE(jcfg)
    x0 = jnp.zeros((1, 16, 16, 3))
    k = jax.random.PRNGKey(0)
    variables = jax.tree.map(np.asarray, random_variables(jax.eval_shape(
        lambda: jnvae.init({"params": k}, x0, k)), 3 + flows))
    return jcfg, tcfg, jnvae, variables, load_port(NVAE(tcfg, device="cpu"), variables)


@pytest.fixture(scope="module")
def plain():
    return _models(False)


def _images(seed=0):
    return np.random.RandomState(seed).rand(B, 16, 16, 3).astype(np.float32)


def _count_segment_calls(monkeypatch):
    calls = []
    real = tcells.depthwise_silu_segment

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(tcells, "depthwise_silu_segment", counting)
    return calls


@pytest.mark.parametrize("flows", [False, True])
def test_training_forward_and_batch_statistics_match_jax(flows, plain, monkeypatch):
    """The training forward's logits and per-group KL (B, n_latents), and
    the running statistics every BatchNorm holds after it: flax's momentum
    and biased variance (torch's own BatchNorm would store the unbiased
    one, off by n / (n - 1) in every var). The decoder cells do not go
    through the segment kernel's wrapper in training."""
    jcfg, tcfg, jnvae, variables, _ = plain if not flows else _models(True)
    tnvae = load_port(NVAE(tcfg, device="cpu"), variables)  # its statistics move
    x = _images()
    key = jax.random.PRNGKey(7)
    (logits, kl), upd = jax.jit(lambda v, x, k: jnvae.apply(
        v, x, k, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x), key)
    calls = _count_segment_calls(monkeypatch)
    tnvae.train()
    with torch.no_grad():
        tlogits, tkl = tnvae(torch.tensor(x), _latent_normals(key, tcfg, B, tcfg.n_latents + 1))
    assert not calls
    assert tkl.shape == (B, tcfg.n_latents)
    np.testing.assert_allclose(_nhwc(tlogits), np.asarray(logits), **FORWARD_TOL)
    np.testing.assert_allclose(tkl.numpy(), np.asarray(kl), **FORWARD_TOL)
    _assert_trees_close(to_jax_variables(tnvae)["batch_stats"], upd["batch_stats"],
                        "batch_stats", **FORWARD_TOL)
    tnvae.eval()
    torch.testing.assert_close(to_jax_variables(tnvae)["params"]["const_prior"],
                               variables["params"]["const_prior"], rtol=0, atol=0,
                               check_dtype=False)


def test_reconstruction_loss_matches_jax(plain):
    jcfg, tcfg, jnvae, variables, tnvae = plain
    x = _images(1)
    logits = np.random.RandomState(2).randn(B, 16, 16, 30).astype(np.float32)
    want = jnvae.reconstruction_loss(jnp.asarray(x), jnp.asarray(logits))
    got = tnvae.reconstruction_loss(torch.tensor(x), _nchw(logits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DIST_TOL)


def test_sample_matches_jax(plain, monkeypatch):
    jcfg, tcfg, jnvae, variables, tnvae = plain
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda v, k: jnvae.apply(v, k, 3, 0.8, method=JaxNVAE.sample))(
        variables, key)
    keys = jax.random.split(key, tcfg.n_latents + 2)
    draws = [_nchw(jax.random.normal(k, (3, s[2], s[3], s[1])))
             for k, s in zip(keys, eps_shapes(tcfg, 3))]
    draws += _mixture_uniforms(keys[tcfg.n_latents], 3, 16, 16, 3)
    calls = _count_segment_calls(monkeypatch)
    with torch.no_grad():
        got = tnvae.sample(3, draws, temperature=0.8)
    assert len(calls) == len(tcfg.decoder_segment_shapes())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FORWARD_TOL)


@pytest.mark.parametrize("deterministic", [True, False])
def test_reconstruct_matches_jax(deterministic, plain, monkeypatch):
    jcfg, tcfg, jnvae, variables, tnvae = plain
    x = _images(3)
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda v, x, k: jnvae.apply(v, x, k, deterministic,
                                               method=JaxNVAE.reconstruct))(
        variables, jnp.asarray(x), key)
    draws = None
    if not deterministic:
        keys = jax.random.split(key, tcfg.n_latents + 2)
        draws = [_nchw(jax.random.normal(k, (B, s[2], s[3], s[1])))
                 for k, s in zip(keys, eps_shapes(tcfg, B))]
        draws += _mixture_uniforms(keys[tcfg.n_latents], B, 16, 16, 3)
    calls = _count_segment_calls(monkeypatch)
    with torch.no_grad():
        got = tnvae.reconstruct(torch.tensor(x), draws, deterministic=deterministic)
    assert len(calls) == len(tcfg.decoder_segment_shapes())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FORWARD_TOL)


@pytest.fixture(scope="module")
def jax_step(plain):
    """JAX's jitted train step of the small NVAE (one compile for both
    cases: the global step is an argument)."""
    jcfg, tcfg, jnvae, variables, _ = plain
    return jtrain.make_nvae_train_step(jnvae, LR, num_total_iter=100, input_noise=0.05)


@pytest.mark.parametrize("global_step", [5, 60])  # beta 0.17, beta 1
def test_train_step_matches_jax(global_step, plain, jax_step):
    """One make_nvae_train_step step with input noise 0.05 from the same
    weights and draws: the loss, recon and KL, the parameters after Adamax
    (weight decay 1e-4 added to the gradient) and the BatchNorm statistics.
    Then the trained model's eval decode renews K1's cached weights."""
    jcfg, tcfg, jnvae, variables, _ = plain
    tnvae = load_port(NVAE(tcfg, device="cpu"), variables)
    tx, step = jax_step
    x = _images(4)
    key = jax.random.PRNGKey(global_step)
    jvars, _, jloss, jrecon, jkl = step(variables, tx.init(variables["params"]),
                                        {"image": jnp.asarray(x)}, key,
                                        jnp.float32(global_step))
    key, kn = jax.random.split(key)
    draws = [torch.tensor(np.asarray(jax.random.normal(kn, x.shape)))]
    draws += _latent_normals(key, tcfg, B, tcfg.n_latents + 1)
    _, tstep = ttrain.make_nvae_train_step(tnvae, LR, num_total_iter=100, input_noise=0.05)
    before = tnvae.reconstruct(torch.tensor(x), deterministic=True).detach()
    loss, recon, kl = tstep({"image": x}, draws, global_step)
    for g, w in ((loss, jloss), (recon, jrecon), (kl, jkl)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=STEP_TOL["rtol"])
    got = to_jax_variables(tnvae)
    grad_scale = max(float(p.grad.abs().max()) for p in tnvae.parameters())
    _assert_first_adamax_step_close(variables["params"], got["params"], jvars["params"],
                                    grad_scale)
    _assert_trees_close(got["batch_stats"], jvars["batch_stats"], "batch_stats",
                        **FORWARD_TOL)
    # the eval decode after the step reads the new weights and statistics
    tnvae.eval()
    with torch.no_grad():
        after = tnvae.reconstruct(torch.tensor(x), deterministic=True)
    want = jax.jit(lambda v, x: jnvae.apply(v, x, key, True, method=JaxNVAE.reconstruct))(
        jvars, jnp.asarray(x))
    assert not torch.equal(after, before)
    np.testing.assert_allclose(after.numpy(), np.asarray(want), **FORWARD_TOL)


def test_segment_cache_renews_after_an_optimizer_step(plain):
    """A decoder cell's cached K1 weights (segment_args, made once while no
    weight requires grad) follow an optimizer's in-place update and a
    training forward's running statistics: the eval decode after a step
    equals a fresh model's with the stepped weights."""
    jcfg, tcfg, jnvae, variables, _ = plain
    tnvae = load_port(NVAE(tcfg, device="cpu"), variables)
    x = torch.tensor(_images(5))
    tnvae.requires_grad_(False)
    with torch.no_grad():
        tnvae.reconstruct(x, deterministic=True)
    cell = tnvae.dec_cells["1_1_0"]
    cached = cell._segment_cache
    assert cached is not None
    tnvae.requires_grad_(True)
    _, tstep = ttrain.make_nvae_train_step(tnvae, 6e-3, num_total_iter=100)
    tstep({"image": x.numpy()}, torch.Generator().manual_seed(0), 5)
    tnvae.eval().requires_grad_(False)
    with torch.no_grad():
        got = tnvae.reconstruct(x, deterministic=True)
    assert cell._segment_cache is not cached
    fresh = load_port(NVAE(tcfg, device="cpu"), to_jax_variables(tnvae)).requires_grad_(False)
    with torch.no_grad():
        torch.testing.assert_close(got, fresh.reconstruct(x, deterministic=True),
                                   rtol=0, atol=0)


def test_config_helpers_and_run_log_match_jax(plain, tmp_path):
    """kl_alpha and from_reference_dict on the flagship's and a reference
    dict's configurations; param_summary of the port's NVAE and of the JAX
    variables; RunLog's file."""
    from gen_adversarial_tpu.core.runlog import RunLog as JaxRunLog
    from gen_adversarial_tpu.core.runlog import param_summary as jax_summary
    from gen_adversarial_tpu_torch.core.runlog import RunLog, param_summary
    from gen_adversarial_tpu_torch.flagship import FLAGSHIP_NVAE

    jcfg, tcfg, _, variables, tnvae = plain
    for cfg in (tcfg, FLAGSHIP_NVAE, NVAEConfig()):
        want = JaxNVAEConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
        np.testing.assert_array_equal(cfg.kl_alpha(), want.kl_alpha())
    ae_args = {"initial_channels": 16, "num_pre-post_process_blocks": 1,
               "num_pre-post_process_cells": 2, "num_logistic_mixtures": 5, "num_scales": 2,
               "min_groups_per_scale": 1, "num_groups_per_scale": 4, "is_adaptive": True,
               "num_cells_per_group": 2, "num_latent_per_group": 8, "num_nf_cells": 2}
    got = NVAEConfig.from_reference_dict(ae_args, (3, 64))
    want = JaxNVAEConfig.from_reference_dict(ae_args, (3, 64))
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == \
        {f: getattr(want, f) for f in want.__dataclass_fields__}
    assert param_summary(tnvae, "nvae") == jax_summary(variables["params"], "nvae") == \
        param_summary(variables["params"], "nvae")
    lines = []
    log = RunLog(tmp_path / "log.txt", lines.append)
    log("a")
    log(3)
    want_log = JaxRunLog(tmp_path / "jax_log.txt", lambda s: None)
    want_log("a")
    want_log(3)
    assert lines == ["a", "3"] == log.lines == want_log.lines
    assert (tmp_path / "log.txt").read_text() == (tmp_path / "jax_log.txt").read_text()


@pytest.mark.parametrize("step", [0, 10, 29, 50])
def test_kl_coeff_and_balanced_kl_match_jax(step):
    """beta from the global step in float32 (annealed over 30 of 100
    steps), and the balanced KL with its gradient (no gradient through the
    balancing weights) at that beta."""
    want_beta = jtrain.kl_coeff(jnp.float32(step), jtrain.KL_ANNEAL_PORTION * 100,
                                jtrain.KL_CONST_PORTION * 100, jtrain.KL_CONST_COEFF)
    beta = ttrain.kl_coeff(torch.tensor(step, dtype=torch.float32),
                           ttrain.KL_ANNEAL_PORTION * 100, ttrain.KL_CONST_PORTION * 100,
                           ttrain.KL_CONST_COEFF)
    assert beta.dtype == torch.float32 and beta.item() == float(want_beta)
    rng = np.random.RandomState(step)
    kl_all = (rng.rand(3, 6) * 5 - 1).astype(np.float32)
    alpha = JaxNVAEConfig(**CFG).kl_alpha().astype(np.float32)[:1].repeat(6) * \
        np.arange(1, 7, dtype=np.float32)
    want, want_g = jax.value_and_grad(lambda k: jnp.sum(jtrain.balanced_kl(
        k, want_beta, jnp.asarray(alpha)) ** 2))(jnp.asarray(kl_all))
    t = torch.tensor(kl_all, requires_grad=True)
    got = (ttrain.balanced_kl(t, beta, torch.tensor(alpha)) ** 2).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def small_step():
    """The CPU side of tests/test_torch_gpu.py's small NVAE step: the model
    before its step, the images, the draws and the buffers after it."""
    _, model, x, draws = small_nvae_train_case(torch.Generator().manual_seed(3))
    before = copy.deepcopy(model)
    return before, x, draws, nvae_train_step(model, x, draws)[2]


def _torch_bn_forward(self, x):
    """torch's own BatchNorm forward: in training it stores the unbiased
    variance var * n / (n - 1) (models/batchnorm.py's docstring)."""
    return super(batchnorm._FlaxTraining, self).forward(x)


@pytest.mark.parametrize("case", ["draws_1e-6", "unbiased_var", "mean_shift_1e-3_std"])
def test_bn_buffer_measure(case, small_step, monkeypatch):
    """The measure that the GPU train-step test holds the running statistics
    to (torch_port_helpers.bn_buffer_errors at 1e-4): two CPU steps whose
    draws differ by 1e-6 relative pass it (their running means differ by
    about their own size where a BN normalises an input already
    batch-normalised, so a measure relative to each buffer's maximum reads
    rounding noise there); torch's unbiased running variance fails it on a
    running_var; a running mean moved by 1e-3 of its BN's std fails it."""
    before, x, draws, want = small_step
    if case == "draws_1e-6":
        got = nvae_train_step(copy.deepcopy(before), x, [d * (1 + 1e-6) for d in draws])[2]
        assert_bn_buffers_close(got, want, 1e-4)
        return
    if case == "unbiased_var":
        monkeypatch.setattr(batchnorm._FlaxTraining, "forward", _torch_bn_forward)
        got = nvae_train_step(copy.deepcopy(before), x, draws)[2]
        errors = bn_buffer_errors(got, want)
        assert max(e for n, e in errors.items() if n.endswith("running_mean")) <= 1e-4
        with pytest.raises(AssertionError, match="running_var"):
            assert_bn_buffers_close(got, want, 1e-4)
        return
    name = next(n for n in want if n.endswith("running_mean"))
    got = dict(want)
    got[name] = want[name] + 1e-3 * want[name[:-len("mean")] + "var"].sqrt()
    with pytest.raises(AssertionError, match=name):
        assert_bn_buffers_close(got, want, 1e-4)
