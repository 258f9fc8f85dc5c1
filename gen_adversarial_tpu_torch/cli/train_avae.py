"""A-VAE WGAN-GP training CLI (counterpart of
gen_adversarial_tpu/cli/train_avae.py; the reference's a_vae/train.py entry
point: batch 32, the experiment's pooling kernel, the EMA generator saved
for the defense).

  python -m gen_adversarial_tpu_torch.cli.train_avae --path data/train \\
      --img-size 64 --out runs/avae_ids [--iters N] [--resume] [--device cuda]

It runs on one CUDA device unless --device cpu is given. Every --save-every
iterations it writes the EMA generator as <out>/iter_NNNNNNN.msgpack and the
whole train state (generator, critic, EMA, both Adam states, the position in
the data) under <out>/state/step_NNNNNNNN/; at the end <out>/last.msgpack.
The .msgpack files are `core/checkpoint.save_variables` flax trees
({'params': ...} of `StyledGenerator`, meta img_size and iter), which the
JAX package's `load_variables` and the port's `load_defense` read.
Iteration i's draws come from generators seeded (seed, i, 0) for the critic
step and (seed, i, 1) for the generator step, and each epoch's shuffle from
seed + the iteration it starts at, so --resume continues bit for bit.
"""

from __future__ import annotations

import argparse
import copy
from pathlib import Path

# the experiment's pooling kernel, by image size (the reference's train.py)
KERNEL_SIZE = {64: 2, 128: 4, 256: 8}


def main(argv: list[str] | None = None):
    """Returns the EMA generator."""
    p = argparse.ArgumentParser("A-VAE WGAN-GP training")
    p.add_argument("--path", required=True, help="training image folder")
    p.add_argument("--img-size", type=int, choices=[64, 128, 256], required=True)
    p.add_argument("--iters", type=int, default=3_000_000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--n-critic", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--save-every", type=int, default=8000)
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest train state in --out/state")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from gen_adversarial_tpu_torch.core.checkpoint import (
        latest_step, load_optimizer_tree, load_state, optimizer_tree, save_state,
        save_variables)
    from gen_adversarial_tpu_torch.core.convert import from_jax_variables, to_jax_variables
    from gen_adversarial_tpu_torch.core.runlog import RunLog, param_summary
    from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset, iterate_batches
    from gen_adversarial_tpu_torch.eval.factory import resolve_device
    from gen_adversarial_tpu_torch.models.nvae.distributions import position_generator
    from gen_adversarial_tpu_torch.train.avae import make_avae_trainers

    device = resolve_device(args.device, "cli.train_avae")
    t = make_avae_trainers(args.img_size, KERNEL_SIZE[args.img_size], args.lr, device=device)
    t.init(torch.Generator(device=device).manual_seed(args.seed))
    ema = copy.deepcopy(t.gen).requires_grad_(False)

    out = Path(args.out)
    state_dir = out / "state"
    it = epoch_it = skip = 0
    step = latest_step(state_dir) if args.resume else None
    if step is not None:
        state = load_state(state_dir, step, "avae")
        for name, module in (("gen", t.gen), ("disc", t.disc), ("ema", ema)):
            from_jax_variables(state[name], module)
        load_optimizer_tree(t.g_opt, t.gen, state["g_opt"])
        load_optimizer_tree(t.d_opt, t.disc, state["d_opt"])
        it, epoch_it, skip = int(state["it"]), int(state["epoch_it"]), int(state["batch_idx"])

    log = RunLog(out / "log.txt", append=args.resume)
    log(param_summary(t.gen, "a_vae/generator"))
    log(param_summary(t.disc, "a_vae/discriminator"))
    if args.resume:
        log(f"[resume] at iteration {it}" if step is not None
            else "[resume] no state checkpoint found; starting fresh")

    def save_train_state(batch_idx: int):
        save_state(state_dir, it, "avae", {
            "gen": to_jax_variables(t.gen), "disc": to_jax_variables(t.disc),
            "ema": to_jax_variables(ema), "g_opt": optimizer_tree(t.g_opt, t.gen),
            "d_opt": optimizer_tree(t.d_opt, t.disc), "it": it, "epoch_it": epoch_it,
            "batch_idx": batch_idx})

    def save_ema(path: Path):
        save_variables(path, {"params": to_jax_variables(ema)["params"]},
                       {"img_size": args.img_size, "iter": it})

    ds = ImageLabelDataset(args.path, args.img_size)
    rec = kl = float("nan")  # until the first generator step
    while it < args.iters:
        # the epoch's shuffle is seeded by the iteration it starts at, so a
        # resumed run walks the same batches
        for bi, batch in enumerate(iterate_batches(ds, args.batch_size, shuffle=True,
                                                   seed=args.seed + epoch_it)):
            if bi < skip:
                continue
            x = torch.as_tensor(batch["image"], device=device).permute(0, 3, 1, 2) * 2.0 - 1.0
            wgan, gp = t.d_step(x, position_generator(device, args.seed, it, 0))
            if (it + 1) % args.n_critic == 0:
                rec, kl = t.g_step(x, position_generator(device, args.seed, it, 1))
                t.accumulate(ema)
            if it % 200 == 0:
                log(f"[{it}] D {float(wgan):.3f} gp {float(gp):.3f} "
                    f"G {float(rec):.3f} KL {float(kl):.5f}")
            if it % args.save_every == 0:
                save_ema(out / f"iter_{it:07d}.msgpack")
            it += 1
            if it % args.save_every == 0:
                save_train_state(bi + 1)
            if it >= args.iters:
                break
        skip = 0
        epoch_it = it
    save_ema(out / "last.msgpack")
    return ema


if __name__ == "__main__":
    main()
