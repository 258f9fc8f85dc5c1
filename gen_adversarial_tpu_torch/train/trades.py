"""TRADES fine-tuning of a trained classifier (counterpart of
gen_adversarial_tpu/train/trades.py; the reference's
trades/fine_tune_classifier.py): the classifier trainer's SGD with
momentum 0.9 (`train/classifier.create_train_state`) with the loss swapped
for TRADES', its inner maximization the L2 variant
(`defenses/competitors.trades_inner_l2`, 16 steps) at the experiment's eps
and beta.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gen_adversarial_tpu_torch.defenses.competitors import kl_div_sum, trades_inner_l2
from gen_adversarial_tpu_torch.train.classifier import TrainState, _nchw, _on

# the reference's README and fine_tune_classifier.py
TRADES_RECIPES = {
    "gender": dict(beta=1.5, epsilon=4.0),
    "ids": dict(beta=1.0, epsilon=2.0),
    "cars": dict(beta=8.0, epsilon=4.0),
}
TRADES_PERTURB_STEPS = 16


def _norm(z):
    return (z - 0.5) / 0.5


def make_trades_train_step(beta: float, epsilon: float,
                           perturb_steps: int = TRADES_PERTURB_STEPS):
    """train_step(state, batch, draws) -> loss (a device tensor): the inner
    PGD against the model in eval mode (its draws from `draws`), then CE +
    beta x KL(adv || natural) / B from two training-mode forwards (natural,
    then adversarial: the second starts from the running statistics the
    first left), one SGD step on the model in `state`. In a data-parallel
    run (`state.ddp`) the inner PGD runs on the plain module and the
    training forwards through the wrapper; `draws` are then a rank's part
    of the global batch's (models/nvae/distributions.SlicedDraws)."""

    def train_step(state: TrainState, batch: dict, draws) -> torch.Tensor:
        model = state.model
        x, y = _on(model, batch)
        model.eval()
        x_adv = trades_inner_l2(lambda inp: model(_nchw(inp)), draws, x, epsilon,
                                perturb_steps, normalization_function=_norm)
        x_adv = torch.clamp(x_adv, 0.0, 1.0).detach()
        net = state.net.train()
        logits_nat = net(_nchw(_norm(x)))
        logits_adv = net(_nchw(_norm(x_adv)))
        loss_robust = kl_div_sum(F.log_softmax(logits_adv, dim=1),
                                 F.softmax(logits_nat, dim=1)) / x.shape[0]
        loss = F.cross_entropy(logits_nat, y) + beta * loss_robust
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    return train_step
