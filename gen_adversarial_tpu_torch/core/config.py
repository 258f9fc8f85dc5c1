"""The attack hyperparameters of each experiment (the port's copy of
`AttackSuiteConfig` and `ATTACK_SUITES` in gen_adversarial_tpu/core/config.py,
which imports yaml; the port imports nothing of the JAX package)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AttackSuiteConfig:
    """DeepFool's and C&W's hyperparameters for one experiment."""
    deepfool_num_classes: int
    deepfool_overshoot: float
    deepfool_max_iter: int
    cw_c: float
    cw_kappa: float
    cw_steps: int
    cw_lr: float
    cw_n_restarts: int
    cw_early_stopping_steps: int


ATTACK_SUITES = {
    "gender": AttackSuiteConfig(2, 0.01, 1024, 64.0, 0.01, 1024, 1e-3, 8, 32),
    "ids": AttackSuiteConfig(8, 0.02, 128, 16.0, 0.05, 1024, 5e-3, 8, 16),
    "cars": AttackSuiteConfig(4, 0.02, 256, 24.0, 0.02, 1024, 2e-3, 8, 16),
}
