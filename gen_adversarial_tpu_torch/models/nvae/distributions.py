"""NVAE distributions on NCHW tensors (counterpart of
gen_adversarial_tpu/models/nvae/distributions.py): the soft-clamped Normal
(sampling, log density, closed-form KL) and the discretized logistic
mixture (log_prob with the reference's asymmetric -0.999 / 0.99 edges, the
gumbel `sample`, the deterministic mean).

Random draws come from a `Draws` source: a `torch.Generator`, or recorded
tensors replayed in order (the tests feed the JAX package's normals and
uniforms this way).
"""

from __future__ import annotations

import math
from collections.abc import Iterable

import numpy as np
import torch
import torch.nn.functional as F


def soft_clamp(x: torch.Tensor, n: float = 5.0) -> torch.Tensor:
    return torch.tanh(x / n) * n


class Draws:
    """Standard-normal and uniform draws, from a generator or replayed in
    order.

    `source` is a `torch.Generator` (draws are made on the tensor's device,
    which must be the generator's) or an iterable of tensors, each of which
    must have exactly the shape that is asked for next (a replayed uniform
    is the value itself, already in [low, high))."""

    def __init__(self, source: torch.Generator | Iterable[torch.Tensor]):
        self.generator = source if isinstance(source, torch.Generator) else None
        self._replay = None if self.generator is not None else iter(source)

    def normal(self, shape, like: torch.Tensor) -> torch.Tensor:
        shape = tuple(shape)
        if self.generator is not None:
            return torch.randn(shape, generator=self.generator,
                               device=like.device, dtype=like.dtype)
        return self._next(shape, like)

    def uniform(self, shape, like: torch.Tensor, low: float = 0.0,
                high: float = 1.0) -> torch.Tensor:
        """Uniform in [low, high), as jax.random.uniform(minval, maxval)."""
        shape = tuple(shape)
        if self.generator is not None:
            u = torch.rand(shape, generator=self.generator, device=like.device,
                           dtype=like.dtype)
            return torch.clamp(u * (high - low) + low, min=low)
        return self._next(shape, like)

    def _next(self, shape: tuple, like: torch.Tensor) -> torch.Tensor:
        try:
            eps = next(self._replay)
        except StopIteration:
            raise ValueError(f"no recorded draw left for shape {shape}") from None
        if tuple(eps.shape) != shape:
            raise ValueError(f"recorded draw has shape {tuple(eps.shape)}, "
                             f"expected {shape}")
        return eps.to(device=like.device, dtype=like.dtype)


def as_draws(source) -> Draws:
    return source if isinstance(source, Draws) else Draws(source)


class RecordingDraws(Draws):
    """Draws from `source` (a generator, a `Draws` or recorded tensors), each
    appended to `record` (a new list unless one is given) as it is made; a
    `Draws` of the record replays them in order, on any device."""

    def __init__(self, source, record: list | None = None):
        self.inner = as_draws(source)
        self.record = [] if record is None else record

    def normal(self, shape, like: torch.Tensor) -> torch.Tensor:
        eps = self.inner.normal(shape, like)
        self.record.append(eps)
        return eps

    def uniform(self, shape, like: torch.Tensor, low: float = 0.0,
                high: float = 1.0) -> torch.Tensor:
        u = self.inner.uniform(shape, like, low, high)
        self.record.append(u)
        return u


class SlicedDraws(Draws):
    """The draws of a global batch, of which this is the i-th of n equal
    parts (a data-parallel rank's): each draw is made at n times the first
    dimension asked for, and the part's rows are kept, so that every rank
    draws what one process would."""

    def __init__(self, source, batch_slice: tuple[int, int]):
        super().__init__(source)
        self.part, self.parts = batch_slice

    def _rows(self, draw, shape):
        b = shape[0]
        return draw((b * self.parts,) + tuple(shape[1:]))[self.part * b:(self.part + 1) * b]

    def normal(self, shape, like: torch.Tensor) -> torch.Tensor:
        return self._rows(lambda s: super(SlicedDraws, self).normal(s, like), shape)

    def uniform(self, shape, like: torch.Tensor, low: float = 0.0,
                high: float = 1.0) -> torch.Tensor:
        return self._rows(lambda s: super(SlicedDraws, self).uniform(s, like, low, high),
                          shape)


def position_generator(device, *position: int) -> torch.Generator:
    """A generator on `device` seeded from np.random.SeedSequence(position):
    the draws of a run's step depend on where it stands, not on what ran
    before it (eval/harness.py's batches, search/alphas.py's evaluations)."""
    state = np.random.SeedSequence(position).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


class Normal:
    """N(soft_clamp(mu), temp * exp(soft_clamp(log_sigma)))."""

    def __init__(self, mu, log_sigma, temp: float = 1.0):
        self.mu = soft_clamp(mu)
        self.sigma = temp * torch.exp(soft_clamp(log_sigma))

    def sample(self, draws: Draws):
        eps = draws.normal(self.mu.shape, self.mu)
        return self.mu + eps * self.sigma, eps

    def sample_given_eps(self, eps):
        return self.mu + eps * self.sigma

    def log_p(self, samples):
        z = (samples - self.mu) / self.sigma
        return -0.5 * z ** 2 - 0.5 * math.log(2 * math.pi) - torch.log(self.sigma)

    def kl(self, prior: "Normal"):
        delta_mu = self.mu - prior.mu
        delta_sigma = self.sigma / prior.sigma
        term1 = delta_mu ** 2 / prior.sigma ** 2
        return 0.5 * (term1 + delta_sigma ** 2) - 0.5 - torch.log(delta_sigma)


def gumbel_argmax_one_hot(draws: Draws, logits: torch.Tensor, dim: int = 1,
                          temperature: float = 1.0) -> torch.Tensor:
    """One-hot of argmax(logits / T + Gumbel noise) over `dim`, the noise
    from uniforms in [1e-5, 1 - 1e-5] of the logits' shape."""
    u = draws.uniform(logits.shape, logits, 1e-5, 1.0 - 1e-5)
    g = -torch.log(-torch.log(u))
    idx = torch.argmax(logits / temperature + g, dim=dim)
    return F.one_hot(idx, logits.shape[dim]).movedim(-1, dim).to(logits.dtype)


class DiscMixLogistic:
    """Mixture of discretized logistics over 3-channel images in [-1, 1].

    params: (B, M + 9M, H, W) with the reference's '(n c)' channel packing:
    first the M mixture logits, then for each mixture n the 9 values
    [mean_r, mean_g, mean_b, s_r, s_g, s_b, k_rg, k_rb, k_gb]."""

    max_val = 2.0 ** 8 - 1

    def __init__(self, params: torch.Tensor):
        b, ch, h, w = params.shape
        m = ch // 10
        self.logits = params[:, :m]                            # (B,M,H,W)
        rest = params[:, m:].reshape(b, m, 9, h, w)
        self.means = rest[:, :, 0:3]                           # (B,M,3,H,W)
        self.log_scales = torch.clamp(rest[:, :, 3:6], min=-7.0)
        self.coeffs = torch.tanh(rest[:, :, 6:9])

    def _adjusted_means(self, samples):
        """PixelCNN++ channel-autoregressive means; samples (B,3,H,W) ->
        (B,M,3,H,W)."""
        s = samples[:, None]
        r = self.means[:, :, 0]
        g = self.means[:, :, 1] + self.coeffs[:, :, 0] * s[:, :, 0]
        bl = self.means[:, :, 2] + self.coeffs[:, :, 1] * s[:, :, 0] + \
            self.coeffs[:, :, 2] * s[:, :, 1]
        return torch.stack([r, g, bl], dim=2)

    def log_prob(self, samples: torch.Tensor) -> torch.Tensor:
        """samples in [-1, 1], (B,3,H,W) -> per-pixel log prob (B,H,W). A
        channel value below -0.999 takes the left tail, one above 0.99 the
        right tail (the reference's asymmetric edges); the bin's log mass is
        taken of max(cdf_delta, 1e-10), so the branch that `where` drops
        keeps a finite gradient."""
        s = samples[:, None]
        centered = s - self._adjusted_means(samples)
        neg_scale = torch.exp(-self.log_scales)
        plus_in = neg_scale * (centered + 1.0 / self.max_val)
        min_in = neg_scale * (centered - 1.0 / self.max_val)
        cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
        log_cdf_plus = plus_in - F.softplus(plus_in)
        log_one_minus_cdf_min = -F.softplus(min_in)
        safe = neg_scale * centered
        safe = safe - self.log_scales - 2.0 * F.softplus(safe)
        safe = safe - math.log(self.max_val / 2)
        mid = torch.where(cdf_delta > 1e-5, torch.log(torch.clamp(cdf_delta, min=1e-10)),
                          safe)
        log_probs = torch.where(s < -0.999, log_cdf_plus,
                                torch.where(s > 0.99, log_one_minus_cdf_min, mid))
        log_probs = log_probs.sum(2) + torch.log_softmax(self.logits, dim=1)
        return torch.logsumexp(log_probs, dim=1)

    def sample(self, draws: Draws) -> torch.Tensor:
        """A draw of the mixture, (B,3,H,W) in [-1, 1]: the component by
        gumbel argmax (uniforms of the logits' shape), then a logistic draw
        (uniforms of the image's shape, in [1e-5, 1 - 1e-5])."""
        sel = gumbel_argmax_one_hot(draws, self.logits)[:, :, None]  # (B,M,1,H,W)
        mu = torch.sum(self.means * sel, dim=1)
        scale = torch.sum(self.log_scales * sel, dim=1)
        k = torch.sum(self.coeffs * sel, dim=1)
        u = draws.uniform(mu.shape, mu, 1e-5, 1.0 - 1e-5)
        x = mu + torch.exp(scale) * (torch.log(u) - torch.log(1.0 - u))
        return self._autoregress(x, k)

    @staticmethod
    def _autoregress(x, k):
        """x, k: (B, 3, H, W)."""
        r = torch.clamp(x[:, 0], -1.0, 1.0)
        g = torch.clamp(x[:, 1] + k[:, 0] * r, -1.0, 1.0)
        bl = torch.clamp(x[:, 2] + k[:, 1] * r + k[:, 2] * g, -1.0, 1.0)
        return torch.stack([r, g, bl], dim=1)

    def mean(self) -> torch.Tensor:
        """(B, 3, H, W) in [-1, 1]."""
        probs = torch.softmax(self.logits, dim=1).unsqueeze(2)  # (B,M,1,H,W)
        mu = torch.sum(self.means * probs, dim=1)
        k = torch.sum(self.coeffs * probs, dim=1)
        return self._autoregress(mu, k)
