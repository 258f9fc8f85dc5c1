"""Exact Gaussian process and Expected Improvement in torch (counterpart of
gen_adversarial_tpu/search/gp.py, which replaced the reference's botorch
SingleTaskGP/EI stack, alpha_learning/bayesian_optimization.py:79-116):
Matern-5/2 ARD kernel, Gaussian likelihood, marginal-likelihood fit with
Adam, multi-restart EI maximization under box bounds, and the Bayesian
search loop. float32, like the JAX package, on the device of the inputs.

The GP is tiny (tens of points); the expensive part is the objective, an
EoT epoch over the adversarial set (search/alphas.AlphaEvaluator).

A float32 Cholesky that fails gives NaN here as in JAX (`_cholesky`:
`torch.linalg.cholesky_ex`, whose `info` is checked, in place of the
raising `torch.linalg.cholesky`), and `fit_gp` stops at the first
hyperparameters whose loss is not finite, as the JAX `fit_gp` does.

The search's own randomness is addressed by position: Bayesian step `s`
draws its raw acquisition samples from a CPU generator seeded from
`np.random.SeedSequence((seed, s))` (the JAX package splits one key stream
and replays it on resume), so a resumed search needs no replay and the same
samples reach the GP on any device.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from gen_adversarial_tpu_torch.eval.factory import resolve_device
from gen_adversarial_tpu_torch.models.nvae.distributions import position_generator
from gen_adversarial_tpu_torch.search.alphas import get_cosine_alphas, get_linear_alphas
from gen_adversarial_tpu_torch.search.grid import (
    _fast_forward, load_search_progress, save_search_step)


def matern52(x1, x2, lengthscales, outputscale):
    """Matern 5/2 ARD kernel. x1 (N,D), x2 (M,D) -> (N,M)."""
    d = (x1[:, None, :] - x2[None, :, :]) / lengthscales
    r = torch.sqrt(torch.sum(d ** 2, dim=-1) + 1e-12)
    sqrt5r = math.sqrt(5.0) * r
    return outputscale * (1 + sqrt5r + 5.0 / 3.0 * r ** 2) * torch.exp(-sqrt5r)


def _unpack(params):
    # noise floor 1e-4 like gpytorch's GaussianLikelihood constraint
    # (GreaterThan(1e-4)) the reference's botorch SingleTaskGP relies on:
    # float32 Cholesky of a near-duplicate-row kernel fails below that
    # (botorch additionally runs in float64)
    return (F.softplus(params["raw_ls"]) + 1e-4,
            F.softplus(params["raw_os"]) + 1e-4,
            F.softplus(params["raw_noise"]) + 1e-4,
            params["mean"])


def _kernel_with_jitter(x, ls, os_, noise):
    n = x.shape[0]
    # jitter scales with the signal variance (kernel diag = outputscale)
    return matern52(x, x, ls, os_) + (noise + 1e-6 * os_) * torch.eye(
        n, dtype=x.dtype, device=x.device)


def _cholesky(k):
    """Lower Cholesky factor, NaN where the factorization failed (as a
    float32 Cholesky in JAX), without a sync to the host."""
    chol, info = torch.linalg.cholesky_ex(k)
    return torch.where(info == 0, chol, torch.nan)


def neg_mll(params, x, y):
    ls, os_, noise, mean = _unpack(params)
    n = x.shape[0]
    chol = _cholesky(_kernel_with_jitter(x, ls, os_, noise))
    resid = y - mean
    alpha = torch.cholesky_solve(resid[:, None], chol)[:, 0]
    return (0.5 * resid @ alpha + torch.sum(torch.log(torch.diagonal(chol)))
            + 0.5 * n * math.log(2 * math.pi))


def _initial_params(x, y) -> dict:
    """JAX's starting point (gp.py:49-50)."""
    return {"raw_ls": torch.zeros(x.shape[1], dtype=x.dtype, device=x.device),
            "raw_os": torch.tensor(0.54, dtype=x.dtype, device=x.device),
            "raw_noise": torch.tensor(-4.0, dtype=x.dtype, device=x.device),
            "mean": torch.mean(y)}


def fit_gp(x: torch.Tensor, y: torch.Tensor, steps: int = 200, lr: float = 0.05) -> dict:
    """Fit hyperparameters by maximizing the exact marginal likelihood with
    Adam (torch's update is optax's: eps outside the square root). The fit
    stops at the first iterate whose loss is not finite and returns that
    iterate, as the JAX `fit_gp` does (its jitted step returns the old
    iterate's loss beside the new iterate, and on a non-finite loss it
    returns the iterate that loss was found at): the fit goes no further
    into NaN, and both packages then propose the same alphas. Returns
    detached tensors."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in _initial_params(x, y).items()}
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    for _ in range(steps):
        loss = neg_mll(params, x, y)
        if not torch.isfinite(loss):
            break
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return {k: v.detach() for k, v in params.items()}


def gp_posterior(params, x_train, y_train, x_test):
    ls, os_, noise, mean = _unpack(params)
    chol = _cholesky(_kernel_with_jitter(x_train, ls, os_, noise))
    k_star = matern52(x_test, x_train, ls, os_)
    alpha = torch.cholesky_solve((y_train - mean)[:, None], chol)[:, 0]
    mu = mean + k_star @ alpha
    v = torch.linalg.solve_triangular(chol, k_star.T, upper=False)
    var = torch.clamp(os_ - torch.sum(v ** 2, dim=0), min=1e-10)
    return mu, var


def expected_improvement(params, x_train, y_train, x_test, best_f,
                         minimize: bool = True):
    """EI for minimization (the reference minimizes 1-accuracy)."""
    mu, var = gp_posterior(params, x_train, y_train, x_test)
    sigma = torch.sqrt(var)
    imp = (best_f - mu) if minimize else (mu - best_f)
    z = imp / sigma
    cdf = 0.5 * (1 + torch.special.erf(z / math.sqrt(2.0)))
    pdf = torch.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
    return imp * cdf + sigma * pdf


def _raw_samples(generator: torch.Generator, n: int, d: int) -> torch.Tensor:
    """n uniform points of [0, 1)^d from `generator`, in float32."""
    return torch.rand((n, d), generator=generator, device=generator.device)


def optimize_acqf(generator, params, x_train, y_train, best_f, bounds,
                  num_restarts: int = 8, raw_samples: int = 32,
                  steps: int = 60, lr: float = 0.05):
    """Multi-restart EI maximization under box bounds (the reference's
    botorch optimize_acqf(q=1, num_restarts=8, raw_samples=32)): raw_samples
    uniform draws from `generator`, the num_restarts best by EI refined by
    Adam with clipping to the bounds. The restarts are refined as one
    (num_restarts, d) tensor: Adam is elementwise and the summed negative EI
    separates by row, so each row takes the steps JAX's vmap of one restart
    takes. Returns (candidate (d,), its EI)."""
    d = x_train.shape[1]
    lo, hi = bounds
    raw = _raw_samples(generator, raw_samples, d).to(x_train.device) * (hi - lo) + lo
    with torch.no_grad():
        ei_raw = expected_improvement(params, x_train, y_train, raw, best_f)
    top = torch.argsort(-ei_raw, stable=True)[:num_restarts]
    z = raw[top].clone().requires_grad_(True)
    opt = torch.optim.Adam([z], lr=lr)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        (-expected_improvement(params, x_train, y_train, z, best_f).sum()).backward()
        opt.step()
        with torch.no_grad():
            z.copy_(torch.clamp(z, lo, hi))
    with torch.no_grad():
        eis = expected_improvement(params, x_train, y_train, z, best_f)
    best = torch.argmax(eis)
    return z.detach()[best], eis[best]


def bayesian_optimize(objective, n_alphas: int, n_steps: int,
                      seed_points: list | None = None, seed: int = 0,
                      log_fn=print, results_folder: str | None = None,
                      resume: bool = True,
                      fingerprint_extra: dict | None = None, device="cuda"):
    """The full BO loop (bayesian_optimization.py:50-124): 5 seed schedules,
    then a GP refit and an EI candidate each step; minimizes 1 - accuracy.
    Returns (all_alphas (N,D), all_accuracies (N,1)). The GP runs on
    `device` ('cuda' unless the caller asks for the CPU; without CUDA,
    'cuda' raises).

    With results_folder set, every evaluated point is saved (in the final
    alphas.npy/accuracies.npy format, plus bo_progress.json with the exact
    ys) and a rerun resumes after the last evaluated point: the objective's
    fast_forward hook (grid._fast_forward) moves its draws, and step s's
    samples depend on (seed, s) only, so the resumed run is seed-reproducible
    end to end. `fingerprint_extra`: objective-identifying fields folded into
    the resume fingerprint (see grid_search)."""
    device = resolve_device(device, "bayesian_optimize")
    if seed_points is None:
        seed_points = [
            get_cosine_alphas(n_alphas),
            get_linear_alphas(n_alphas),
            [0.5] * n_alphas,
            [1 - a for a in get_linear_alphas(n_alphas)],
            [1 - a for a in get_cosine_alphas(n_alphas)],
        ]
    n_seed = len(seed_points)
    folder = Path(results_folder) if results_folder is not None else None
    fingerprint = {"mode": "bo", "n_alphas": n_alphas, "n_steps": n_steps,
                   "seed": seed, "n_seed": n_seed,
                   **(fingerprint_extra or {})}
    rows, acc_rows, done, marker = ([], [], 0, {}) if not resume else \
        load_search_progress(folder, fingerprint, "bo_progress.json", log_fn)
    if done and (len(marker.get("ys", [])) != done or not np.allclose(
            np.stack(rows[:min(done, n_seed)]),
            np.stack([np.asarray(p, np.float64)
                      for p in seed_points[:min(done, n_seed)]]))):
        log_fn("[resume] saved rows do not match this run's seed schedules; "
               "restarting from scratch")
        rows, acc_rows, done, marker = [], [], 0, {}
    xs = [np.asarray(r, np.float64) for r in rows]
    # ys come from the marker, not 1-accuracies: the json float round-trip
    # is exact, so a resumed run's GP inputs are bit-identical
    ys = [float(v) for v in marker.get("ys", [])]
    _fast_forward(objective, done)

    def checkpoint():
        if folder is not None:
            save_search_step(folder, xs,
                             (1.0 - np.asarray(ys))[:, None].tolist(),
                             fingerprint, "bo_progress.json",
                             extra={"ys": ys})

    for p in [np.asarray(p, np.float64) for p in seed_points][done:n_seed]:
        acc = objective(p)
        xs.append(p)
        ys.append(1.0 - acc)
        log_fn(f"[bo seed] acc {acc:.4f}")
        checkpoint()

    bounds = (torch.zeros(n_alphas, device=device), torch.ones(n_alphas, device=device))
    for s in range(max(0, done - n_seed), n_steps):
        x_train = torch.tensor(np.stack(xs), dtype=torch.float32, device=device)
        y_train = torch.tensor(np.asarray(ys), dtype=torch.float32, device=device)
        params = fit_gp(x_train, y_train)
        cand, ei = optimize_acqf(position_generator("cpu", seed, s), params, x_train,
                                 y_train, float(np.min(ys)), bounds)
        cand = cand.cpu().numpy()
        acc = objective(cand)
        xs.append(np.asarray(cand, np.float64))
        ys.append(1.0 - acc)
        log_fn(f"[bo step {s}] EI {float(ei):.4f} acc {acc:.4f} "
               f"(best {1 - min(ys):.4f})")
        checkpoint()

    if folder is not None:
        (folder / "bo_progress.json").unlink(missing_ok=True)
    return np.stack(xs), 1.0 - np.asarray(ys)[:, None]
