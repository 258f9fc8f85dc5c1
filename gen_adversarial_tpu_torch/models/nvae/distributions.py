"""NVAE distributions on NCHW tensors (counterpart of
gen_adversarial_tpu/models/nvae/distributions.py): the soft-clamped Normal
and the deterministic mean of the 10-mixture discretized logistic, which is
all the purify path needs. `log_prob` and the gumbel `sample` of the mixture
come with the training slice.

Random draws come from a `Draws` source: a `torch.Generator`, or recorded
tensors replayed in order (the tests feed the JAX package's noise this way).
"""

from __future__ import annotations

from collections.abc import Iterable

import numpy as np
import torch


def soft_clamp(x: torch.Tensor, n: float = 5.0) -> torch.Tensor:
    return torch.tanh(x / n) * n


class Draws:
    """Standard-normal draws, from a generator or replayed in order.

    `source` is a `torch.Generator` (draws are made on the tensor's device,
    which must be the generator's) or an iterable of tensors, each of which
    must have exactly the shape that is asked for next."""

    def __init__(self, source: torch.Generator | Iterable[torch.Tensor]):
        self.generator = source if isinstance(source, torch.Generator) else None
        self._replay = None if self.generator is not None else iter(source)

    def normal(self, shape, like: torch.Tensor) -> torch.Tensor:
        shape = tuple(shape)
        if self.generator is not None:
            return torch.randn(shape, generator=self.generator,
                               device=like.device, dtype=like.dtype)
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


class DiscMixLogistic:
    """Mixture of discretized logistics over 3-channel images in [-1, 1].

    params: (B, M + 9M, H, W) with the reference's '(n c)' channel packing:
    first the M mixture logits, then for each mixture n the 9 values
    [mean_r, mean_g, mean_b, s_r, s_g, s_b, k_rg, k_rb, k_gb]."""

    def __init__(self, params: torch.Tensor):
        b, ch, h, w = params.shape
        m = ch // 10
        self.logits = params[:, :m]                            # (B,M,H,W)
        rest = params[:, m:].reshape(b, m, 9, h, w)
        self.means = rest[:, :, 0:3]                           # (B,M,3,H,W)
        # rest[:, :, 3:6] are the log scales, which only log_prob and sample
        # read (not ported yet)
        self.coeffs = torch.tanh(rest[:, :, 6:9])

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
