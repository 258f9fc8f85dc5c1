"""Expectation over Transformation (counterpart of
gen_adversarial_tpu/defenses/eot.py): the mean of the logits over eot_steps
stochastic forward passes.

Where the JAX package vmaps over PRNG keys, the draws here are folded into
the batch dimension: draw d of image b is row d * B + b of one batch of
eot_steps * B (or of `chunk` draws at a time). The shared-encode path runs
the deterministic encode once per image when the defense allows it
(initial_noise_eps == 0) and repeats its state across the draws.
"""

from __future__ import annotations

import torch

from gen_adversarial_tpu_torch.models.nvae.distributions import as_draws


def _repeat(tree, times: int):
    """Repeat every tensor of a (dict / tuple of) tensors `times` along dim 0."""
    if isinstance(tree, torch.Tensor):
        return tree.repeat(times, *([1] * (tree.dim() - 1)))
    if isinstance(tree, dict):
        return {k: _repeat(v, times) for k, v in tree.items()}
    return type(tree)(_repeat(v, times) for v in tree)


def eot_wrap(defense, eot_steps: int = 32, chunk: int | None = None):
    """Returns net(x, draws) -> mean logits over eot_steps draws.

    `draws` is a `torch.Generator` or the recorded draws of the folded
    batches in order (per chunk: the input noise, then the purify eps; see
    defenses/base.py). `chunk` runs that many draws per batch to bound
    activation memory."""
    if chunk is not None:
        if chunk >= eot_steps:
            chunk = None
        elif eot_steps % chunk:
            raise ValueError(f"eot_steps={eot_steps} is not divisible by chunk={chunk}")
    per_batch = chunk or eot_steps

    def net(x, draws):
        draws = as_draws(draws)
        b = x.shape[0]
        shared = defense.supports_shared_encode
        if shared:
            state = _repeat(defense.purify_state(x), per_batch)
        else:
            xs = _repeat(x, per_batch)
        logits = []
        for _ in range(eot_steps // per_batch):
            if shared:
                out = defense.state_call(state, draws)
            else:
                out = defense(xs, draws)
            logits.append(out.view(per_batch, b, -1))
        return torch.cat(logits).mean(dim=0)

    return net
