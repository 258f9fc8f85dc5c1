"""The port's alpha search (gen_adversarial_tpu_torch/search) against the JAX
package's (gen_adversarial_tpu/search) and the float64 oracle of
tests/gp_oracle.py, on the CPU: the schedules, the grid search's rows, the
resume of both searches after a crash, each package reading the other's
progress files, the GP (marginal likelihood, posterior, EI, fit,
acquisition), `AlphaEvaluator` and `create_adversarial_dataset` on the
small ids NVAE of tests/test_alpha_evaluator.py (16 px, 2 latent groups)
with a linear classifier, every draw made by numpy and replayed on both
sides (tests/torch_port_helpers.keyed_normal_calls)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import gen_adversarial_tpu.search.alphas as jax_alphas
import gen_adversarial_tpu.search.gp as jax_gp
import gen_adversarial_tpu.search.grid as jax_grid
import gen_adversarial_tpu_torch.search.alphas as alphas
import gen_adversarial_tpu_torch.search.gp as gp
import gen_adversarial_tpu_torch.search.grid as grid
from gen_adversarial_tpu.defenses.base import MLVGMDefense as JaxDefense
from gen_adversarial_tpu.defenses.eot import eot_wrap as jax_eot_wrap
from gen_adversarial_tpu.defenses.purify import _compose, make_nvae_purify_split as jax_split
from gen_adversarial_tpu.eval.factory import LoadedDefense as JaxLoaded
from gen_adversarial_tpu.models.nvae.model import NVAE as JaxNVAE
from gen_adversarial_tpu.models.nvae.model import NVAEConfig as JaxNVAEConfig
from gen_adversarial_tpu_torch.data import png
from gen_adversarial_tpu_torch.defenses.base import MLVGMDefense
from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.defenses.purify import make_nvae_purify_split
from gen_adversarial_tpu_torch.eval.factory import LoadedDefense
from gen_adversarial_tpu_torch.models.nvae.model import NVAE, NVAEConfig, eps_shapes
from tests import gp_oracle
from tests.torch_port_helpers import keyed_normal_calls, load_port, one_torch_thread  # noqa: F401
from tests.torch_port_helpers import random_variables

pytestmark = pytest.mark.usefixtures("one_torch_thread")

QUIET = dict(log_fn=lambda s: None)
# the GP in float32 against JAX's float32 (other summation orders) and
# against the float64 oracle, on a 12-point problem: measured at most 1.5e-6
# and 6.4e-7 relative (EI), JAX's own distance from the oracle 1.4e-6
GP_RTOL = 1e-5
ORACLE_RTOL = 1e-5
# 200 (fit) or 60 (acquisition) Adam steps in float32, torch's against
# optax's: the same update, rounded at other places; measured 5.0e-6
# relative (fit) and 1.2e-6 absolute (candidate), 7.7e-6 relative (EI)
FIT_RTOL = 1e-4
ACQF_ATOL = 1e-5
# the kept adversaries' pixels, port against JAX: (adv * 255) truncated, so a
# value within float32 rounding of a level boundary may land one level off
MAX_OFF_PIXELS = 16


# --- schedules, grid, resume --------------------------------------------------

@pytest.mark.parametrize("n", [1, 4, 24])
def test_schedules_match_jax(n):
    assert alphas.get_linear_alphas(n) == jax_alphas.get_linear_alphas(n)
    assert alphas.get_cosine_alphas(n) == jax_alphas.get_cosine_alphas(n)
    assert alphas.ALPHA_ATTENUATION == jax_alphas.ALPHA_ATTENUATION


def _objective(a):
    return float(1.0 - np.mean((np.asarray(a) - 0.3) ** 2))


def test_grid_search_rows_and_best_combination_match_jax(tmp_path):
    """The same seed gives JAX's rows bit for bit; get_best_combination
    reads either package's folder alike."""
    want = jax_grid.grid_search(_objective, 3, 8, seed=5, results_folder=str(tmp_path / "j"),
                                **QUIET)
    got = grid.grid_search(_objective, 3, 8, seed=5, results_folder=str(tmp_path / "t"),
                           **QUIET)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for folder in ("j", "t"):
        np.testing.assert_array_equal(alphas.get_best_combination(str(tmp_path / folder)),
                                      jax_alphas.get_best_combination(str(tmp_path / "j")))


def _crash_after(n_ok, objective):
    calls = {"n": 0}

    def crashing(a):
        calls["n"] += 1
        if calls["n"] > n_ok:
            raise RuntimeError("boom")
        return objective(a)

    return crashing


def _counting(objective):
    evals = {"n": 0}

    def counted(a):
        evals["n"] += 1
        return objective(a)

    return counted, evals


@pytest.mark.parametrize("first,second", [(grid, grid), (jax_grid, grid), (grid, jax_grid)])
def test_grid_search_resumes_after_a_crash(tmp_path, first, second):
    """A search that dies after 4 of 8 evaluations resumes at the fifth, in
    either package from either package's files, and ends with every row of
    an uninterrupted run."""
    want = grid.grid_search(_objective, 3, 8, seed=5, **QUIET)
    out = tmp_path / "res"
    with pytest.raises(RuntimeError):
        first.grid_search(_crash_after(4, _objective), 3, 8, seed=5,
                          results_folder=str(out), **QUIET)
    assert np.load(out / "alphas.npy").shape == (4, 3)
    counted, evals = _counting(_objective)
    logs = []
    got = second.grid_search(counted, 3, 8, seed=5, results_folder=str(out), log_fn=logs.append)
    assert any(line.startswith("[resume] continuing at evaluation 4") for line in logs)
    assert evals["n"] == 4 and not (out / "grid_progress.json").exists()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _bowl(a):
    return float(1.0 - np.mean((np.asarray(a) - 0.6) ** 2))


def test_bayesian_optimize_resumes_after_a_crash(tmp_path):
    """Crash inside the second BO step (5 seeds + 1 step kept), rerun: only
    the 2 unfinished steps run, and the trajectory equals the uninterrupted
    one exactly (the GP inputs from the marker's ys, step s's samples from
    (seed, s))."""
    want = gp.bayesian_optimize(_bowl, n_alphas=4, n_steps=3, seed=2, device="cpu",
                                results_folder=str(tmp_path / "full"), **QUIET)
    assert not (tmp_path / "full" / "bo_progress.json").exists()
    assert want[0].shape == (8, 4) and want[1].shape == (8, 1)
    out = tmp_path / "res"
    with pytest.raises(RuntimeError):
        gp.bayesian_optimize(_crash_after(6, _bowl), n_alphas=4, n_steps=3, seed=2,
                             device="cpu", results_folder=str(out), **QUIET)
    assert (out / "bo_progress.json").exists()
    counted, evals = _counting(_bowl)
    logs = []
    got = gp.bayesian_optimize(counted, n_alphas=4, n_steps=3, seed=2, device="cpu",
                               results_folder=str(out), log_fn=logs.append)
    assert any(line.startswith("[resume] continuing at evaluation 6") for line in logs)
    assert evals["n"] == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("writer,reader", [(jax_grid, grid), (grid, jax_grid)])
def test_each_package_reads_the_others_progress(tmp_path, writer, reader):
    """A BO marker (rows, accuracies, the exact ys) written by one package's
    save_search_step is read back equal by the other's load_search_progress;
    another fingerprint restarts."""
    rng = np.random.RandomState(0)
    rows = [rng.rand(5) for _ in range(3)]
    ys = [0.25, 0.5, 1.0 / 3.0]
    accs = (1.0 - np.asarray(ys))[:, None].tolist()
    fingerprint = {"mode": "bo", "n_alphas": 5, "seed": 1, "config": "c.yaml"}
    writer.save_search_step(tmp_path, rows, accs, fingerprint, "bo_progress.json",
                            extra={"ys": ys})
    got_rows, got_accs, done, marker = reader.load_search_progress(
        tmp_path, fingerprint, "bo_progress.json", lambda s: None)
    assert done == 3 and marker["ys"] == ys
    np.testing.assert_array_equal(np.stack(got_rows), np.stack(rows))
    np.testing.assert_array_equal(np.asarray(got_accs), np.asarray(accs))
    assert reader.load_search_progress(tmp_path, {**fingerprint, "seed": 2}, "bo_progress.json",
                                       lambda s: None)[2] == 0


# --- the GP -------------------------------------------------------------------

def _gp_problem(n=12, d=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, d).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) + 0.5 * x[:, 1] - x[:, 2] * x[:, -1]).astype(np.float32)
    params = {"raw_ls": rng.randn(d).astype(np.float32) * 0.3,
              "raw_os": np.float32(0.4), "raw_noise": np.float32(-3.0),
              "mean": np.float32(y.mean())}
    return x, y, params


def _torch_params(params):
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in params.items()}


def _jax_params(params):
    return {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in params.items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_gp_matches_jax_and_the_float64_oracle():
    x, y, params = _gp_problem()
    x_test = np.random.RandomState(1).rand(6, 4).astype(np.float32)
    tp, jp = _torch_params(params), _jax_params(params)
    tx, ty, tt = torch.tensor(x), torch.tensor(y), torch.tensor(x_test)
    jx, jy, jt = jnp.asarray(x), jnp.asarray(y), jnp.asarray(x_test)
    best_f = float(y.min())
    got = [gp.neg_mll(tp, tx, ty), *gp.gp_posterior(tp, tx, ty, tt),
           gp.expected_improvement(tp, tx, ty, tt, best_f)]
    want = [jax_gp.neg_mll(jp, jx, jy), *jax_gp.gp_posterior(jp, jx, jy, jt),
            jax_gp.expected_improvement(jp, jx, jy, jt, best_f)]
    oracle = [gp_oracle.neg_mll(params, x, y), *gp_oracle.posterior(params, x, y, x_test),
              gp_oracle.expected_improvement(params, x, y, x_test, best_f)]
    for name, g, w, o in zip(["neg_mll", "mu", "var", "ei"], got, want, oracle):
        g = g.numpy()
        assert g.dtype == np.float32 and np.all(np.isfinite(g)), name
        assert _rel(g, w) <= GP_RTOL, (name, _rel(g, w))
        assert _rel(g, o) <= ORACLE_RTOL, (name, _rel(g, o))


def test_a_failed_cholesky_gives_nan_and_the_fit_keeps_the_last_finite_step(monkeypatch):
    """cholesky_ex's failure is NaN, as JAX's float32 Cholesky; a fit whose
    loss turns non-finite at its k-th evaluation (that of the iterate after
    k - 1 steps) returns that iterate, the hyperparameters of a fit of
    k - 1 steps, as the JAX fit_gp does."""
    chol = gp._cholesky(torch.tensor([[1.0, 2.0], [2.0, 1.0]]))
    assert torch.isnan(chol).all()
    x, y, _ = _gp_problem()
    tx, ty = torch.tensor(x), torch.tensor(y)
    want = gp.fit_gp(tx, ty, steps=3)
    real, calls = gp.neg_mll, {"n": 0}

    def failing(params, x, y):
        calls["n"] += 1
        loss = real(params, x, y)
        return loss * torch.nan if calls["n"] == 4 else loss

    monkeypatch.setattr(gp, "neg_mll", failing)
    got = gp.fit_gp(tx, ty, steps=10)
    assert calls["n"] == 4
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("nan_at", [1, 7])
def test_fit_gp_after_a_non_finite_loss_matches_jax(nan_at, monkeypatch):
    """Each package's neg_mll made NaN at its nan_at-th evaluation (JAX's
    step run eagerly, so that its neg_mll is called once a step): both fits
    stop there and return the same iterate, within 1e-5 relative."""
    x, y, _ = _gp_problem()

    def failing(real):
        calls = {"n": 0}

        def neg_mll(params, x, y):
            calls["n"] += 1
            loss = real(params, x, y)
            return loss * float("nan") if calls["n"] == nan_at else loss
        return neg_mll, calls

    jax_neg_mll, jax_calls = failing(jax_gp.neg_mll)
    port_neg_mll, port_calls = failing(gp.neg_mll)
    monkeypatch.setattr(jax_gp, "neg_mll", jax_neg_mll)
    monkeypatch.setattr(gp, "neg_mll", port_neg_mll)
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    want = jax_gp.fit_gp(jnp.asarray(x), jnp.asarray(y), steps=20)
    got = gp.fit_gp(torch.tensor(x), torch.tensor(y), steps=20)
    assert jax_calls["n"] == port_calls["n"] == nan_at
    for k in ("raw_ls", "raw_os", "raw_noise", "mean"):
        w = np.asarray(want[k], np.float64)
        assert np.all(np.isfinite(w)), k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5, atol=0, err_msg=k)


@pytest.fixture(scope="module")
def fitted():
    """(x, y, JAX's fit, the port's fit) on a bowl around 0.45 seen at 16
    points, whose EI peaks inside the box."""
    x = np.random.RandomState(0).rand(16, 3).astype(np.float32)
    y = np.sum((x - 0.45) ** 2, 1).astype(np.float32)
    want = jax_gp.fit_gp(jnp.asarray(x), jnp.asarray(y))
    got = gp.fit_gp(torch.tensor(x), torch.tensor(y))
    return x, y, want, got


def test_fit_gp_matches_jax(fitted):
    """200 Adam steps from JAX's starting point: the hyperparameters, and the
    posterior they give, within FIT_RTOL of JAX's."""
    x, y, want, got = fitted
    for k in ("raw_ls", "raw_os", "raw_noise", "mean"):
        assert _rel(got[k].numpy(), want[k]) <= FIT_RTOL, k
    start = _torch_params({"raw_ls": np.zeros(3), "raw_os": 0.54, "raw_noise": -4.0,
                           "mean": y.mean()})
    assert gp.neg_mll(got, torch.tensor(x), torch.tensor(y)) < \
        gp.neg_mll(start, torch.tensor(x), torch.tensor(y))
    x_test = np.random.RandomState(4).rand(5, 3).astype(np.float32)
    mu, var = gp.gp_posterior(got, torch.tensor(x), torch.tensor(y), torch.tensor(x_test))
    jmu, jvar = jax_gp.gp_posterior(want, jnp.asarray(x), jnp.asarray(y), jnp.asarray(x_test))
    assert _rel(mu.numpy(), jmu) <= FIT_RTOL and _rel(var.numpy(), jvar) <= FIT_RTOL


def test_optimize_acqf_matches_jax(fitted, monkeypatch):
    """The same 32 raw samples on both sides (numpy, swapped for
    jax.random.uniform and for the port's draw), JAX's fitted
    hyperparameters: the same 8 restarts refined 60 Adam steps each give
    JAX's candidate and EI."""
    x, y, want_params, _ = fitted
    raw = np.random.RandomState(5).rand(32, 3).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(raw))
    monkeypatch.setattr(gp, "_raw_samples", lambda generator, n, d: torch.tensor(raw))
    best_f = float(y.min())
    want = jax_gp.optimize_acqf(jax.random.PRNGKey(0), want_params, jnp.asarray(x),
                                jnp.asarray(y), best_f, (jnp.zeros(3), jnp.ones(3)))
    params = {k: torch.tensor(np.asarray(v)) for k, v in want_params.items()}
    got = gp.optimize_acqf(torch.Generator(), params, torch.tensor(x), torch.tensor(y),
                           best_f, (torch.zeros(3), torch.ones(3)))
    assert float(want[1]) > 0
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=ACQF_ATOL)
    np.testing.assert_allclose(got[1].item(), float(want[1]), rtol=FIT_RTOL)
    assert torch.all((got[0] > 0.05) & (got[0] < 0.95))  # inside: no bound decides it


def test_gp_fit_survives_near_duplicate_rows():
    """Two rows 1e-7 apart: the noise floor and the jitter keep the float32
    Cholesky finite, in the fit and the posterior."""
    rng = np.random.RandomState(0)
    xs = np.vstack([rng.rand(7, 5), rng.rand(1, 5)]).astype(np.float32)
    xs[-1] = xs[-2] + 1e-7
    ys = rng.rand(8).astype(np.float32)
    tx, ty = torch.tensor(xs), torch.tensor(ys)
    params = gp.fit_gp(tx, ty)
    mu, var = gp.gp_posterior(params, tx, ty, tx[:3])
    assert torch.isfinite(mu).all() and torch.isfinite(var).all()
    assert all(torch.isfinite(v).all() for v in params.values())


# --- AlphaEvaluator and the adversarial set on the small ids NVAE --------------

CFG = dict(resolution=16, initial_channels=4, n_pre_post_blocks=1, n_pre_post_cells=1,
           num_scales=2, num_groups_per_scale=1, min_groups_per_scale=1,
           num_cells_per_group=1, num_latent_per_group=2, num_nf_cells=None, num_mixtures=3)
N_IMAGES, BATCH, EOT, N_CLASSES = 6, 3, 2, 4


@pytest.fixture(scope="module")
def small():
    """The JAX and port small ids defenses (eps 0, the shared encode) with
    the same random NVAE weights and a linear classifier."""
    jcfg, tcfg = JaxNVAEConfig(**CFG), NVAEConfig(**CFG)
    jnvae = JaxNVAE(jcfg)
    k = jax.random.PRNGKey(0)
    variables = random_variables(jax.eval_shape(
        lambda: jnvae.init({"params": k}, jnp.zeros((1, 16, 16, 3)), k)), 1)
    w = np.random.RandomState(2).randn(16 * 16 * 3, N_CLASSES).astype(np.float32) * 0.05
    enc, dec = jax_split(jnvae, 0.6)
    jdef = JaxDefense(purify_variables=variables, classifier_variables=jnp.asarray(w),
                      alphas=jnp.zeros((tcfg.n_latents,)), purify_apply=_compose(enc, dec),
                      purify_encode_apply=enc, purify_decode_apply=dec,
                      classifier_apply=lambda v, x: x.reshape(x.shape[0], -1) @ v,
                      image_size=16, normalize_before_purify=False)
    tnvae = load_port(NVAE(tcfg, device="cpu"), variables)
    tenc, tdec = make_nvae_purify_split(tnvae, 0.6)
    tw = torch.tensor(w)
    tdef = MLVGMDefense(tnvae, nn.Identity(), torch.zeros(tcfg.n_latents), tenc, tdec,
                        lambda x: x.reshape(x.shape[0], -1) @ tw, image_size=16)
    return jdef, tdef, tcfg


def _position_draws(tcfg, positions, batch, seed):
    """Per position (a tuple), numpy draws of one EoT-2 call over `batch`
    images: the JAX per_draw list and the port's draws (each latent's eps,
    draw-major)."""
    rng = np.random.RandomState(seed)
    out = {}
    for pos in positions:
        eps = [[rng.standard_normal(s).astype(np.float32) for s in eps_shapes(tcfg, batch)]
               for _ in range(EOT)]
        per_draw = [(None, [e.transpose(0, 2, 3, 1) for e in eps[d]] + [None])
                    for d in range(EOT)]
        port = [torch.tensor(np.concatenate([eps[d][j] for d in range(EOT)]))
                for j in range(tcfg.n_latents)]
        out[pos] = (per_draw, port)
    return out


def test_alpha_evaluator_matches_jax(small, monkeypatch):
    """Two evaluations of 6 images in batches of 3 at EoT-2, JAX's keys
    (fold_in(fold_in(key, e), b)) and the port's positions (seed, e, b) fed
    the same numpy draws: the same accuracy, which is neither 0 nor 1, and
    the same per-image correctness; the alphas buffer holds alphas x 0.7."""
    jdef, tdef, tcfg = small
    images = np.random.RandomState(3).rand(N_IMAGES, 16, 16, 3).astype(np.float32)
    n_batches = N_IMAGES // BATCH
    positions = [(e, b) for e in range(2) for b in range(n_batches)]
    draws = _position_draws(tcfg, positions, BATCH, 8)
    base = jax.random.PRNGKey(0)
    keys = {(e, b): jax.random.fold_in(jax.random.fold_in(base, e), b) for e, b in positions}
    jax_call = keyed_normal_calls([(keys[p], draws[p][0]) for p in positions])
    monkeypatch.setattr(alphas, "position_generator",
                        lambda device, seed, e, b: list(draws[(e, b)][1]))
    schedules = [np.asarray(alphas.get_cosine_alphas(tcfg.n_latents)), np.array([0.2, 0.9])]

    jpreds = jax.jit(lambda d, k, x: jnp.argmax(jax_eot_wrap(d, EOT)(k, x), 1))
    want_preds = [np.concatenate([np.asarray(jax_call(lambda: jpreds(
        jdef.replace(alphas=jnp.asarray(a) * 0.7), keys[e, b],
        jnp.asarray(images[b * BATCH:(b + 1) * BATCH]))))
        for b in range(n_batches)]) for e, a in enumerate(schedules)]
    # half the images labelled as the first evaluation predicts them
    labels = want_preds[0].copy()
    labels[::2] = (labels[::2] + 1) % N_CLASSES

    ev = alphas.AlphaEvaluator(tdef, images, labels, attenuation=0.7, eot_steps=EOT,
                               batch_size=BATCH, device="cpu")
    jev = jax_alphas.AlphaEvaluator(jdef, images, labels, attenuation=0.7, eot_steps=EOT,
                                    batch_size=BATCH)
    for e, a in enumerate(schedules):
        got_preds = ev.predictions(a)
        np.testing.assert_array_equal(tdef.alphas.numpy(),
                                      a.astype(np.float32) * np.float32(0.7))
        np.testing.assert_array_equal(got_preds == labels, want_preds[e] == labels)
        want_acc = jax_call(lambda: jev.objective_function(a))
        assert want_acc == np.mean(want_preds[e] == labels)
        if e == 0:
            assert 0.0 < want_acc < 1.0
    ev.fast_forward(0)
    assert ev.objective_function(schedules[0]) == np.mean(want_preds[0] == labels)


def test_fast_forward_draws_what_an_uninterrupted_run_draws(small):
    """Three evaluations in one evaluator; a second evaluator fast-forwarded
    by 2 gives the third's predictions (its own generators, no replay)."""
    _, tdef, tcfg = small
    images = np.random.RandomState(4).rand(4, 16, 16, 3).astype(np.float32)
    labels = np.zeros(4, np.int64)
    schedule = np.asarray(alphas.get_linear_alphas(tcfg.n_latents))
    kw = dict(attenuation=0.7, eot_steps=EOT, batch_size=BATCH, seed=3, device="cpu")
    ev = alphas.AlphaEvaluator(tdef, images, labels, **kw)
    preds = [ev.predictions(schedule) for _ in range(3)]
    resumed = alphas.AlphaEvaluator(tdef, images, labels, **kw)
    resumed.fast_forward(2)
    np.testing.assert_array_equal(resumed.predictions(schedule), preds[2])
    with torch.no_grad():  # the draws are those of position (3, 2, 0)
        logits = eot_wrap(tdef, EOT)(torch.tensor(images[:BATCH]),
                                            alphas.position_generator("cpu", 3, 2, 0))
    np.testing.assert_array_equal(logits.argmax(1).numpy(), preds[2][:BATCH])


def test_create_adversarial_dataset_matches_jax(small, tmp_path, monkeypatch):
    """FGSM at L2 2.0 through EoT-2 over 8 images in 4 class folders (the
    random defense puts them all on class 2, so the 'c' images are the ones
    classified right and the others are skipped as already wrong), walked
    in the shuffled order of seed 0, batches of 3 (a ragged last one), the
    same numpy draws for each batch's two forwards on both sides: the same
    kept files, and their pixels equal but for at most MAX_OFF_PIXELS values
    one level apart (a float32 value at a multiple of 1/255 truncates to
    either side)."""
    jdef, tdef, tcfg = small
    rng = np.random.RandomState(6)
    for i in range(8):
        png.write(tmp_path / "images" / "abcd"[i % 4] / f"{i}.png",
                  (rng.rand(16, 16, 3) * 255).astype(np.uint8))
    # JAX's keys: split(key) a batch, then FGSM's k0 (the gradient's
    # forward) and k2 (the test of the adversary)
    key, jax_keys = jax.random.PRNGKey(0), []
    for b in range(3):
        key, sub = jax.random.split(key)
        jax_keys.append(jax.random.split(sub))
    draws = {}
    for b, size in enumerate([3, 3, 2]):
        draws.update(_position_draws(tcfg, [(b, 0), (b, 1)], size, 9 + b))
    jax_call = keyed_normal_calls([(jax_keys[b][f], draws[b, f][0])
                                   for b in range(3) for f in range(2)])
    monkeypatch.setattr(grid, "position_generator", lambda device, seed, b: list(
        draws[b, 0][1]) + list(draws[b, 1][1]))
    kw = dict(image_size=16, n_classes=N_CLASSES, eot_steps=EOT, eot_chunk=None, attacks={})
    jloaded = JaxLoaded("ids", "ours", defense=jdef, **kw)
    loaded = LoadedDefense("ids", "ours", defense=tdef, device=torch.device("cpu"), **kw)
    tdef.alphas.zero_()
    args = (str(tmp_path / "images"), 2.0, 8)
    want = jax_call(lambda: jax_grid.create_adversarial_dataset(
        jloaded, args[0], str(tmp_path / "jax"), *args[1:], eot_steps=EOT, batch_size=3,
        **QUIET))
    got = grid.create_adversarial_dataset(loaded, args[0], str(tmp_path / "port"), *args[1:],
                                          eot_steps=EOT, batch_size=3, **QUIET)
    names = sorted(p.relative_to(tmp_path / "port").as_posix()
                   for p in (tmp_path / "port").rglob("*.png"))
    want_names = sorted(p.relative_to(tmp_path / "jax").as_posix()
                        for p in (tmp_path / "jax").rglob("*.png"))
    assert got == want == len(names) and names == want_names
    assert 0 < got < 8, "the FGSM should keep some images and skip others"
    off = 0
    for name in names:
        a = png.read_rgb(tmp_path / "port" / name).astype(int)
        b = png.read_rgb(tmp_path / "jax" / name).astype(int)
        assert np.abs(a - b).max() <= 1, name
        off += int(np.count_nonzero(a != b))
    print(f"kept {names}; {off} pixel values one level off JAX's")
    assert off <= MAX_OFF_PIXELS, off

