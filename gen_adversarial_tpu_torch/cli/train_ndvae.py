"""ND-VAE training CLI (counterpart of gen_adversarial_tpu/cli/train_ndvae.py;
the reference's train_ndvae.py entry point): the Adamax denoiser of
train/ndvae.py over paired (adversarial -> clean) folders, with the
recipes of `--type`.

  python -m gen_adversarial_tpu_torch.cli.train_ndvae --images-path data \\
      --type cars128 --out runs/ndvae_cars [--seed 0] [--device cuda]

--images-path holds train/ (clean) and ndvae_adversaries/ (their
adversaries, paired by sorted file order; `train/ndvae.generate_fgsm_dataset`
or `cli/alpha_search --mode make-adv` writes them). One numpy RandomState
seeded --seed shuffles each epoch and draws the extra noise (one N(0, 1) a
pixel times one U(0, noise_max) a batch), in the JAX package's order; step
s's model draws come from a generator seeded (seed, s). It runs on one CUDA
device unless --device cpu is given. <out>/nd_vae.msgpack is the flax tree
(`core/checkpoint.save_variables`, meta the recipe), which the JAX
package's `load_variables` and the port's `load_defense` read. The celeba64
recipe has one scale and cannot train (train/ndvae.py).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv: list[str] | None = None):
    """Returns the trained DefenceNVAE (eval mode)."""
    p = argparse.ArgumentParser("ND-VAE training")
    p.add_argument("--images-path", required=True,
                   help="base path containing train/ and ndvae_adversaries/")
    p.add_argument("--type", dest="task", choices=["celeba256", "celeba64", "cars128"],
                   required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from gen_adversarial_tpu_torch.core.checkpoint import save_variables
    from gen_adversarial_tpu_torch.core.convert import to_jax_variables
    from gen_adversarial_tpu_torch.core.init import flax_init_
    from gen_adversarial_tpu_torch.core.runlog import RunLog, param_summary
    from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset
    from gen_adversarial_tpu_torch.eval.factory import resolve_device
    from gen_adversarial_tpu_torch.models.ndvae.model import DefenceNVAE
    from gen_adversarial_tpu_torch.models.nvae.distributions import position_generator
    from gen_adversarial_tpu_torch.train.ndvae import NDVAE_RECIPES, make_ndvae_train_step

    device = resolve_device(args.device, "cli.train_ndvae")
    r = NDVAE_RECIPES[args.task]
    model = DefenceNVAE(input_dim=r["image_size"], **r["params"], device=device)
    flax_init_(model, torch.Generator(device=device).manual_seed(args.seed))

    clean_ds = ImageLabelDataset(f"{args.images_path}/train", r["image_size"])
    adv_ds = ImageLabelDataset(f"{args.images_path}/ndvae_adversaries", r["image_size"])
    if len(clean_ds) != len(adv_ds):
        raise ValueError(f"paired folders must align: {len(clean_ds)} clean images, "
                         f"{len(adv_ds)} adversaries")

    n_iter_per_epoch = len(clean_ds) // r["batch_size"]
    _, step = make_ndvae_train_step(model, r["lr"], r["epochs"] * n_iter_per_epoch)

    log = RunLog(Path(args.out) / "log.txt")
    log(param_summary(model, f"nd_vae/{args.task}"))

    rng = np.random.RandomState(args.seed)
    gstep = 0
    for epoch in range(r["epochs"]):
        order = rng.permutation(len(clean_ds))
        losses = []
        for b in range(n_iter_per_epoch):
            idx = order[b * r["batch_size"]:(b + 1) * r["batch_size"]]
            x_orig = np.stack([clean_ds.load_image(i) for i in idx])
            x_adv = np.stack([adv_ds.load_image(i) for i in idx])
            if r["use_noise"]:
                x_adv = np.clip(x_adv + rng.randn(*x_adv.shape).astype(np.float32)
                                * rng.uniform(0, r["noise_max"]), 0, 1)
            loss, _, _ = step({"x_adv": x_adv, "x_orig": x_orig},
                              position_generator(device, args.seed, gstep), gstep)
            losses.append(loss)
            gstep += 1
        log(f"[epoch {epoch + 1}/{r['epochs']}] loss "
            f"{float(torch.stack(losses).mean()) if losses else float('nan'):.2f}")

    save_variables(Path(args.out) / "nd_vae.msgpack", to_jax_variables(model),
                   {"task": args.task, **{k: v for k, v in r.items() if k != "params"},
                    "params": r["params"]})
    return model.eval()


if __name__ == "__main__":
    main()
