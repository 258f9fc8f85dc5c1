"""Alpha schedules and the search objective (counterpart of
gen_adversarial_tpu/search/alphas.py; the reference's
alpha_learning/common_utils.py).

`AlphaEvaluator` is the EoT accuracy of a purification defense on a
precomputed adversarial set as a function of its alpha vector. Where the JAX
package swaps the alpha leaf of a pytree, the port writes the defense's
`alphas` buffer in place (in the buffer's dtype, bfloat16 after
`core/precision.defense_astype`): the defense is never rebuilt or copied.

Its draws are addressed by position, as the JAX package's keys are:
evaluation `e`, batch `b` draws from a generator seeded from
`np.random.SeedSequence((seed, e, b))` (`position_generator`), made on the
defense's device, as `eval/harness.batch_generator` makes its own. A search
that resumes after `n` evaluations calls `fast_forward(n)` and draws
exactly what an uninterrupted one would.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.eval.factory import resolve_device
from gen_adversarial_tpu_torch.models.nvae.distributions import position_generator

# hardcoded attenuations (common_utils.py:42,53,64)
ALPHA_ATTENUATION = {"gender": 1.0, "ids": 0.7, "cars": 0.7}


def get_linear_alphas(n: int) -> list:
    return [i / n for i in range(1, n + 1)]


def get_cosine_alphas(n: int) -> list:
    return [0.5 * (1 - math.cos(math.pi * (i / n))) for i in range(1, n + 1)]


def get_best_combination(folder: str) -> np.ndarray:
    alphas = np.load(f"{folder}/alphas.npy")
    accuracies = np.load(f"{folder}/accuracies.npy")[:, 0]
    return alphas[accuracies.argmax()]


class AlphaEvaluator:
    """EoT accuracy of `defense` (an MLVGMDefense; its `alphas` buffer is
    written by every evaluation) on images (N, H, W, C) in [0, 1] with
    integer labels, in batches of batch_size (the last one ragged), the
    EoT-wrapped logits under torch.no_grad(). `device` is where the images
    go, the defense's device ('cuda' unless the caller asks for the CPU;
    without CUDA, 'cuda' raises)."""

    def __init__(self, defense, images, labels, attenuation: float,
                 eot_steps: int = 32, batch_size: int = 16, seed: int = 0,
                 eot_chunk: int | None = None, device="cuda"):
        self.device = resolve_device(device, "AlphaEvaluator")
        self.defense = defense
        self.images = np.asarray(images, np.float32)
        self.labels = np.asarray(labels)
        self.attenuation = attenuation
        self.batch_size = batch_size
        self.seed = seed
        self.net = eot_wrap(defense, eot_steps, chunk=eot_chunk)
        self._eval_index = 0

    def fast_forward(self, n_evaluations: int):
        """Skip the draws of the first n completed evaluations (the searches'
        resume path; see grid._fast_forward)."""
        self._eval_index = int(n_evaluations)

    def predictions(self, alphas) -> np.ndarray:
        """The per-image predictions of the next evaluation, with the
        defense's alphas set to alphas x attenuation (in float32, as the JAX
        package multiplies them)."""
        scaled = np.asarray(alphas, np.float32) * np.float32(self.attenuation)
        self.defense.alphas.copy_(torch.from_numpy(scaled))
        e = self._eval_index
        self._eval_index += 1
        preds = []
        bs = self.batch_size
        with torch.no_grad():
            for b, i in enumerate(range(0, len(self.images), bs)):
                x = torch.from_numpy(self.images[i:i + bs]).to(self.device)
                logits = self.net(x, position_generator(self.device, self.seed, e, b))
                preds.append(logits.argmax(1).cpu().numpy())
        return np.concatenate(preds) if preds else np.zeros(0, np.int64)

    def objective_function(self, alphas) -> float:
        correct = int(np.sum(self.predictions(alphas) == self.labels))
        return correct / max(len(self.images), 1)
