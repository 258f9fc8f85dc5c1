"""The attack suite of an experiment (counterpart of `build_attacks` in
gen_adversarial_tpu/eval/factory.py). The defense factories are one per
family: flagship.py (ids), gender.py, cars.py."""

from __future__ import annotations

from functools import partial

from gen_adversarial_tpu_torch.attacks import autoattack, cw_attack, deepfool_attack
from gen_adversarial_tpu_torch.core.config import ATTACK_SUITES


def build_attacks(experiment: str, n_classes: int, cotangent_chunk: int | None = None) -> dict:
    """name -> attack(net, images, labels, generator). cotangent_chunk is the
    class-jacobian block of DeepFool and of AutoAttack's FAB
    (attacks/utils.class_grads): the same results, less live memory."""
    s = ATTACK_SUITES[experiment]
    return {
        "deepfool": partial(deepfool_attack, num_classes=s.deepfool_num_classes,
                            overshoot=s.deepfool_overshoot, max_iter=s.deepfool_max_iter,
                            cotangent_chunk=cotangent_chunk),
        "c&w": partial(cw_attack, c=s.cw_c, kappa=s.cw_kappa, steps=s.cw_steps, lr=s.cw_lr,
                       n_restarts=s.cw_n_restarts,
                       early_stopping_steps=s.cw_early_stopping_steps),
        "autoattack": partial(autoattack, n_classes=n_classes, cotangent_chunk=cotangent_chunk),
    }
