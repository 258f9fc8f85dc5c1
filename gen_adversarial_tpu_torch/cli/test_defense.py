"""Attack-benchmark CLI (counterpart of gen_adversarial_tpu/cli/test_defense.py).

Usage:
  python -m gen_adversarial_tpu_torch.cli.test_defense \\
      --config configs/ours_cosine_noise_cars.yaml \\
      --images-path /data/cars/test \\
      --results-folder results/ours_cosine_noise_cars \\
      [--attack deepfool|c&w|autoattack] [--batch-size 8] [--eot-steps 32] \\
      [--eot-chunk N] [--device cuda]

The config's checkpoint paths point at flax msgpack files (written by either
package's `save_variables`); the images are a folder of class folders.
It runs on one CUDA device unless --device cpu is given. Without
--eot-chunk the EoT chunk is eval/factory.default_eot_chunk's for the
config's family at --batch-size (the JAX CLI runs unchunked): gender and
cars attack gradients at batch 8 and EoT-32 do not fit one 80 GB card
unchunked.

Data parallel, one process per GPU (the reference's DistributedSampler
shards):

  torchrun --nproc-per-node 4 -m gen_adversarial_tpu_torch.cli.test_defense \
      ... --distributed

Each rank evaluates its round-robin shard of the images; the per-image
results are gathered in rank order and rank 0 writes results.json and the
plots (eval/harness.run_benchmark). --n-devices > 1 in one process raises,
naming that command.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser("GPU attack benchmark")
    p.add_argument("--config", required=True)
    p.add_argument("--images-path", required=True)
    p.add_argument("--results-folder", required=True)
    p.add_argument("--attack", default=None, choices=[None, "deepfool", "c&w", "autoattack"])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--eot-steps", type=int, default=32)
    p.add_argument("--eot-chunk", type=int, default=None,
                   help="EoT draws a forward (default: the family's, "
                        "eval/factory.default_eot_chunk)")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="bfloat16 runs purifier+classifier in bfloat16 (weights cast once, "
                        "float32 logits)")
    p.add_argument("--remat-policy", default=None,
                   choices=[None, "dots_saveable", "dots_with_no_batch_dims_saveable"],
                   help="what the purifier's remat saves (the JAX jax.checkpoint_policies "
                        "names; default saves nothing)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--no-resume", action="store_true",
                   help="ignore any per-batch progress file (progress_p*.json) and restart "
                        "the eval from image 0")
    p.add_argument("--n-devices", type=int, default=None,
                   help="more than one raises: run one process per GPU under torchrun")
    p.add_argument("--distributed", action="store_true",
                   help="data parallel over torchrun's processes, one GPU each")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK under torchrun) or cpu")
    args = p.parse_args(argv)

    from gen_adversarial_tpu_torch.core import distributed as dist_util

    dist_util.check_n_devices(args.n_devices, "gen_adversarial_tpu_torch.cli.test_defense")
    if args.distributed:
        dist_util.maybe_initialize()

    from gen_adversarial_tpu_torch.core.config import defense_type_of, experiment_of
    from gen_adversarial_tpu_torch.eval.factory import default_eot_chunk, load_defense
    from gen_adversarial_tpu_torch.eval.harness import run_benchmark

    eot_chunk = args.eot_chunk if args.eot_chunk is not None else default_eot_chunk(
        experiment_of(args.config), defense_type_of(args.config), args.batch_size,
        args.eot_steps)
    loaded = load_defense(args.config, eot_steps=args.eot_steps, eot_chunk=eot_chunk,
                          dtype=args.dtype, remat_policy=args.remat_policy,
                          device=args.device)
    return run_benchmark(loaded, args.images_path, args.results_folder,
                         batch_size=args.batch_size, seed=args.seed,
                         attack_filter=args.attack, max_images=args.max_images,
                         plots=not args.no_plots, n_devices=args.n_devices,
                         distributed=args.distributed, resume=not args.no_resume)


if __name__ == "__main__":
    main()
