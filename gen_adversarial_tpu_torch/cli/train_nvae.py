"""NVAE training CLI (counterpart of gen_adversarial_tpu/cli/train_nvae.py):
the small-scale trainer of train/nvae.py (Adamax, annealed balanced-KL
ELBO) on a folder dataset, for users without the paper's checkpoints.

  python -m gen_adversarial_tpu_torch.cli.train_nvae \\
      --images-path data/train --resolution 64 --channels 16 \\
      --scales 2 --groups 2 --epochs 40 --out runs/nvae_small [--device cuda]

It runs on one CUDA device unless --device cpu is given. <out>/nvae.msgpack
is the flax variable tree (`core/checkpoint.save_variables`; meta epoch and
config), which the JAX package's `load_variables` and the port's
`load_defense` read; a rerun resumes from it. <out>/log.txt holds the log.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv: list[str] | None = None):
    """Returns the trained NVAE (eval mode)."""
    p = argparse.ArgumentParser("NVAE training")
    p.add_argument("--images-path", required=True)
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--channels", type=int, default=16, help="initial_channels")
    p.add_argument("--scales", type=int, default=2)
    p.add_argument("--groups", type=int, default=2,
                   help="num_groups_per_scale (non-adaptive)")
    p.add_argument("--cells", type=int, default=1, help="cells per group")
    p.add_argument("--latent", type=int, default=8, help="num_latent_per_group")
    p.add_argument("--mixtures", type=int, default=5)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--lr", type=float, default=6e-3)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--input-noise", type=float, default=0.0,
                   help="denoising pixel-noise augmentation std")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from gen_adversarial_tpu_torch.core.runlog import RunLog
    from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset
    from gen_adversarial_tpu_torch.eval.factory import resolve_device
    from gen_adversarial_tpu_torch.models.nvae.model import NVAE, NVAEConfig
    from gen_adversarial_tpu_torch.train.nvae import fit_nvae

    device = resolve_device(args.device, "cli.train_nvae")
    cfg = NVAEConfig(resolution=args.resolution, initial_channels=args.channels,
                     n_pre_post_blocks=1, n_pre_post_cells=2, num_scales=args.scales,
                     num_groups_per_scale=args.groups, is_adaptive=False,
                     num_cells_per_group=args.cells, num_latent_per_group=args.latent,
                     num_nf_cells=None, num_mixtures=args.mixtures)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    log = RunLog(out / "log.txt")
    log(f"[config] {cfg}")
    ds = ImageLabelDataset(args.images_path, args.resolution)
    model = fit_nvae(NVAE(cfg, device=device), ds, epochs=args.epochs, lr=args.lr,
                     batch_size=args.batch_size, seed=args.seed, log_fn=log,
                     checkpoint_path=str(out / "nvae.msgpack"), input_noise=args.input_noise)
    log(f"[done] checkpoint at {out / 'nvae.msgpack'}")
    return model


if __name__ == "__main__":
    main()
