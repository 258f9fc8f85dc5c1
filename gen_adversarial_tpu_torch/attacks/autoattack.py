"""The custom AutoAttack ensemble (counterpart of
gen_adversarial_tpu/attacks/autoattack.py): APGD-CE at the bounds 0.5, 1, 4,
then APGD-DLR at 0.5, 2, 4 (skipped for 3 classes or fewer), then FAB(128);
the Square attack is left out, as in the reference. A higher bound only
counts for samples the lower ones did not solve.

Where the JAX ensemble splits one key into a key per stage, every stage here
draws from a source of its own (`split_draws`), so a stage's result does not
depend on which stages ran before it. `autoattack` runs every stage and
gates the merge per sample; `make_staged_autoattack` skips a stage whose
gate is all False (one boolean read from the device per stage) and gives
the same result.

FAB's class Jacobian differentiates one forward against every class's
one-hot cotangent (attacks/utils.class_grads). The JAX package does that in
one block unless GAT_COT_CHUNK sets one; the port, where no block is given,
takes blocks of `utils.class_block(n_classes, batch)` cotangents, which give
the same result: all 100 ids classes in one block at the CLI's batch of 8 and
EoT-32 would hold 100 x the backward of 256 purified images and do not fit
one 80 GB card."""

from __future__ import annotations

import hashlib

import torch

from gen_adversarial_tpu_torch.attacks.apgd import apgd_attack
from gen_adversarial_tpu_torch.attacks.fab import fab_attack
from gen_adversarial_tpu_torch.attacks.utils import class_block
from gen_adversarial_tpu_torch.models.nvae.distributions import Draws, as_draws

N_STAGES = 7  # 3 APGD-CE, 3 APGD-DLR, FAB
APGD_ITERS, APGD_RHO = 64, 0.75
FAB_ITERS = 128
CE_BOUNDS, DLR_BOUNDS = (0.5, 1.0, 4.0), (0.5, 2.0, 4.0)


def split_draws(draws: Draws, n: int) -> list[Draws]:
    """n draw sources, one per stage (the JAX `jax.random.split`). From a
    generator: n new generators on its device, seeded from a hash of its
    state (host memory for CPU and CUDA generators alike, so no device
    sync), after which the parent moves on by n draws. A replayed source
    is shared: the stages take its draws in stage order."""
    gen = draws.generator
    if gen is None:
        return [draws] * n
    state = gen.get_state().numpy().tobytes()
    seeds = [int.from_bytes(hashlib.blake2b(state + bytes([i]), digest_size=8).digest(),
                            "little") >> 1 for i in range(n)]
    torch.empty(n, device=gen.device).normal_(generator=gen)
    return [Draws(torch.Generator(device=gen.device).manual_seed(s)) for s in seeds]


def update_result(res0, res1, gate=None):
    """Adopt result 1 where it succeeds and result 0 failed or has a larger
    bound; `gate` limits the samples that may change (the escalation to a
    higher bound only for samples not yet solved)."""
    s0, b0, a0 = res0
    s1, b1, a1 = res1
    take = s1 & (~s0 | (b1 < b0))
    if gate is not None:
        take = take & gate
    bdims = (-1,) + (1,) * (a0.dim() - 1)
    return s0 | take, torch.where(take, b1, b0), torch.where(take.reshape(bdims), a1, a0)


def _run(net, images, labels, generator, n_classes, cotangent_chunk, skip_solved):
    stages = split_draws(as_draws(generator), N_STAGES)

    def chain(ce: bool, first: int, bounds):
        res = apgd_attack(net, images, labels, stages[first], APGD_ITERS, APGD_RHO,
                          bounds[0], ce)
        for i, bound in enumerate(bounds[1:], start=first + 1):
            gate = ~res[0]
            if skip_solved and not bool(gate.any()):
                continue  # every sample solved: the stage would change nothing
            res = update_result(res, apgd_attack(net, images, labels, stages[i], APGD_ITERS,
                                                 APGD_RHO, bound, ce), gate)
        return res

    res = chain(True, 0, CE_BOUNDS)
    if n_classes > 3:
        res = update_result(res, chain(False, 3, DLR_BOUNDS))
    if cotangent_chunk is None:
        cotangent_chunk = class_block(n_classes, images.shape[0])
    return update_result(res, fab_attack(net, images, labels, stages[6], n_iter=FAB_ITERS,
                                         alpha_max=0.1, eta=1.05, beta=0.9,
                                         cotangent_chunk=cotangent_chunk))


def autoattack(net, images: torch.Tensor, labels: torch.Tensor, generator, n_classes: int,
               cotangent_chunk: int | None = None):
    """Every stage runs; the escalation is a per-sample gate at the merge.
    cotangent_chunk is FAB's (utils.class_grads; None: `utils.class_block`).
    Returns (success, bound, adv)."""
    return _run(net, images, labels, generator, n_classes, cotangent_chunk, False)


def make_staged_autoattack(n_classes: int, cotangent_chunk: int | None = None):
    """The ensemble with the host-gated skip of solved stages. Returns
    run(net, images, labels, generator) -> (success, bound, adv), equal to
    `autoattack`'s."""

    def run(net, images, labels, generator):
        return _run(net, images, labels, generator, n_classes, cotangent_chunk, True)

    return run
