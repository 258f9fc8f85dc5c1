"""TRADES fine-tuning CLI (counterpart of
gen_adversarial_tpu/cli/trades_finetune.py; the reference's
trades/fine_tune_classifier.py entry point).

  python -m gen_adversarial_tpu_torch.cli.trades_finetune \\
      --data-path /data/cars --experiment cars \\
      --classifier-path ckpts/cars/classifier.msgpack \\
      --epochs 50 --lr 0.01 --cumulative-bs 128 --out ckpts/cars_trades [--device cuda]

--data-path holds train/ of class folders; the classifier is the
experiment's (VGG11-BN for ids, ResNet50 for gender, ResNeXt50 for cars),
read from a flax msgpack file. Each epoch shuffles with seed + epoch; step
s's inner-loop draws come from a generator seeded (seed, s). It runs on one
CUDA device unless --device cpu is given. <out>/last.msgpack is the
fine-tuned classifier's flax tree (meta experiment and recipe), which the
JAX package's `load_variables` and the port's `load_defense` (a trades_*
config) read.

Data parallel, one process per GPU (the reference's torchrun DDP
fine-tuner, trades/fine_tune_classifier.py:82,239):

  torchrun --nproc-per-node 4 -m gen_adversarial_tpu_torch.cli.trades_finetune \
      ... --distributed

--cumulative-bs is the global batch; each rank decodes its part of it,
draws the inner PGD's start for the whole batch and keeps its rows, and
DistributedDataParallel averages the gradients (train/classifier.py's
skeleton). Rank 0 alone logs and writes last.msgpack. --n-devices > 1 in one
process raises, naming that command.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv: list[str] | None = None):
    """Returns the fine-tuned classifier's TrainState."""
    p = argparse.ArgumentParser("TRADES fine-tune")
    p.add_argument("--data-path", required=True)
    p.add_argument("--experiment", choices=["gender", "ids", "cars"], required=True)
    p.add_argument("--classifier-path", required=True)
    p.add_argument("--epochs", type=int, required=True)
    p.add_argument("--lr", type=float, required=True)
    p.add_argument("--cumulative-bs", type=int, required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument("--distributed", action="store_true",
                   help="data parallel over torchrun's processes, one GPU each")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK under torchrun) or cpu")
    args = p.parse_args(argv)

    from gen_adversarial_tpu_torch.core import distributed as dist_util

    dist_util.check_n_devices(args.n_devices, "gen_adversarial_tpu_torch.cli.trades_finetune")
    if args.distributed:
        dist_util.maybe_initialize()
    pid, n_proc = dist_util.data_parallel_shard(args.distributed, "cli.trades_finetune")
    if args.cumulative_bs % n_proc:
        raise SystemExit(f"--cumulative-bs {args.cumulative_bs} is not divisible by "
                         f"{n_proc} processes")

    import torch

    from gen_adversarial_tpu_torch.core.checkpoint import save_variables
    from gen_adversarial_tpu_torch.core.config import IMAGE_SIZE
    from gen_adversarial_tpu_torch.core.convert import to_jax_variables
    from gen_adversarial_tpu_torch.core.runlog import RunLog, param_summary
    from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset, iterate_batches
    from gen_adversarial_tpu_torch.eval import factory
    from gen_adversarial_tpu_torch.models.nvae.distributions import (
        SlicedDraws, position_generator)
    from gen_adversarial_tpu_torch.train.classifier import create_train_state
    from gen_adversarial_tpu_torch.train.trades import TRADES_RECIPES, make_trades_train_step

    device = factory.resolve_device(args.device, "cli.trades_finetune")
    model, _ = factory.load_classifier_parts(args.experiment, args.classifier_path, device)
    model.requires_grad_(True)
    state = create_train_state(model, args.lr)
    if args.distributed:
        state.ddp = dist_util.wrap_ddp(model)
    recipe = TRADES_RECIPES[args.experiment]
    step = make_trades_train_step(beta=recipe["beta"], epsilon=recipe["epsilon"])

    tds = ImageLabelDataset(f"{args.data_path}/train", IMAGE_SIZE[args.experiment])
    log = RunLog(Path(args.out) / "log.txt") if pid == 0 else (lambda s: None)
    log(param_summary(model, factory.CLASSIFIER_TYPE[args.experiment]))
    gstep = 0
    for epoch in range(args.epochs):
        losses = []
        for batch in iterate_batches(tds, args.cumulative_bs, shuffle=True,
                                     seed=args.seed + epoch, batch_slice=(pid, n_proc)):
            draws = SlicedDraws(position_generator(device, args.seed, gstep), (pid, n_proc))
            losses.append(step(state, batch, draws))
            gstep += 1
        loss = torch.stack(losses).mean() if losses else torch.full((), float("nan"), device=device)
        if n_proc > 1:
            torch.distributed.all_reduce(loss)
        log(f"[epoch {epoch + 1}/{args.epochs}] trades loss {float(loss) / n_proc:.4f}")

    if pid == 0:
        save_variables(Path(args.out) / "last.msgpack", to_jax_variables(state.model.eval()),
                       {"experiment": args.experiment, "trades": recipe})
    return state


if __name__ == "__main__":
    main()
