"""Alpha-schedule search CLI (counterpart of
gen_adversarial_tpu/cli/alpha_search.py; the reference's alpha_learning
scripts create_adversarial_dataset.py, grid_search.py and
bayesian_optimization.py).

Usage:
  python -m gen_adversarial_tpu_torch.cli.alpha_search \\
      --mode make-adv --config configs/ours_linear_noise_ids.yaml \\
      --images-path /data/ids/train --out-dir /data/ids_adv --n-samples 500
  python -m gen_adversarial_tpu_torch.cli.alpha_search \\
      --mode bo|grid --config configs/ours_linear_noise_ids.yaml \\
      --adv-images-path /data/ids_adv --n-steps 50 --results-folder results/bo_ids \\
      [--device cuda]

The config's checkpoint paths point at flax msgpack files (written by either
package's `save_variables`); the image sets are folders of class folders.
It runs on one CUDA device unless --device cpu is given. Every mode wraps
EoT with --eot-chunk, or without it with the config's family default at
--batch-size (eval/factory.default_eot_chunk); the JAX CLI's make-adv drops
the flag and runs unchunked, which gives the same adversaries on the same
draws but does not fit one 80 GB card for gender. The results folder
holds alphas.npy, accuracies.npy and, while a search runs, its progress
marker, in the JAX package's format: either package resumes the other's.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from gen_adversarial_tpu_torch.core.config import N_LATENTS, defense_type_of, experiment_of

# FGSM bounds per experiment (create_adversarial_dataset.py; 4/2/4)
FGSM_BOUND = {"gender": 4.0, "ids": 2.0, "cars": 4.0}


def main(argv: list[str] | None = None):
    """make-adv returns the number of adversaries kept; grid and bo return
    (alphas (N, D), accuracies (N, 1))."""
    p = argparse.ArgumentParser("alpha search")
    p.add_argument("--mode", choices=["grid", "bo", "make-adv"], required=True)
    p.add_argument("--config", required=True,
                   help="an ours_* config naming classifier/autoencoder paths")
    p.add_argument("--adv-images-path", help="precomputed adversarial set")
    p.add_argument("--images-path", help="clean set (for --mode make-adv)")
    p.add_argument("--out-dir", help="destination (for --mode make-adv)")
    p.add_argument("--n-steps", type=int, default=50)
    p.add_argument("--n-samples", type=int, default=500)
    p.add_argument("--results-folder", default="alpha_search_results")
    p.add_argument("--eot-steps", type=int, default=32)
    p.add_argument("--eot-chunk", type=int, default=None,
                   help="chunk the EoT draws to bound peak activation memory "
                        "(default: the family's, eval/factory.default_eot_chunk)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--no-resume", action="store_true",
                   help="ignore any per-evaluation search checkpoint "
                        "(grid/bo_progress.json) and restart from scratch")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset
    from gen_adversarial_tpu_torch.eval.factory import (
        default_eot_chunk, load_defense, load_ours_for_search)
    from gen_adversarial_tpu_torch.search.alphas import ALPHA_ATTENUATION, AlphaEvaluator
    from gen_adversarial_tpu_torch.search.gp import bayesian_optimize
    from gen_adversarial_tpu_torch.search.grid import create_adversarial_dataset, grid_search

    eot_chunk = args.eot_chunk if args.eot_chunk is not None else default_eot_chunk(
        experiment_of(args.config), defense_type_of(args.config), args.batch_size,
        args.eot_steps)
    if args.mode == "make-adv":
        loaded = load_defense(args.config, eot_steps=args.eot_steps, eot_chunk=eot_chunk,
                              device=args.device)
        return create_adversarial_dataset(loaded, args.images_path, args.out_dir,
                                          FGSM_BOUND[loaded.experiment], args.n_samples,
                                          eot_steps=args.eot_steps,
                                          batch_size=args.batch_size)

    exp, image_size, make_defense = load_ours_for_search(args.config, device=args.device)
    n_alphas = N_LATENTS[exp]

    # the adversarial set, in memory
    ds = ImageLabelDataset(args.adv_images_path, image_size)
    images = np.stack([ds.load_image(i) for i in range(len(ds))])
    evaluator = AlphaEvaluator(make_defense(np.zeros(n_alphas)), images, ds.labels,
                               attenuation=ALPHA_ATTENUATION[exp],
                               eot_steps=args.eot_steps, batch_size=args.batch_size,
                               eot_chunk=eot_chunk, device=args.device)

    folder = Path(args.results_folder)
    folder.mkdir(parents=True, exist_ok=True)
    # the objective's identity in the resume fingerprint: the default shared
    # --results-folder must never let a crashed search on one (config,
    # adversarial set, EoT) resume into another
    fp_extra = {"config": args.config, "adv_images_path": args.adv_images_path,
                "eot_steps": args.eot_steps, "batch_size": args.batch_size}
    if args.mode == "grid":
        return grid_search(evaluator.objective_function, n_alphas, args.n_steps,
                           results_folder=str(folder), resume=not args.no_resume,
                           fingerprint_extra=fp_extra)
    xs, accs = bayesian_optimize(evaluator.objective_function, n_alphas, args.n_steps,
                                 results_folder=str(folder), resume=not args.no_resume,
                                 fingerprint_extra=fp_extra, device=args.device)
    np.save(folder / "alphas.npy", xs)
    np.save(folder / "accuracies.npy", accs)
    best = xs[accs[:, 0].argmax()]
    print(f"best alphas: {best.tolist()} acc {accs.max():.4f}")
    return xs, accs


if __name__ == "__main__":
    main()
