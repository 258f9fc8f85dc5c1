"""Classifier training CLI (counterpart of
gen_adversarial_tpu/cli/train_classifier.py; the reference's
classifier/train.py entry point).

Usage:
  python -m gen_adversarial_tpu_torch.cli.train_classifier \\
      --data-path /data/celeba_gender --model-type resnet --n-classes 2 \\
      --image-size 256 --cumulative-bs 128 --epochs 50 --lr 0.1 \\
      --checkpoint-path ckpts/gender [--device cuda]

`--data-path` holds train/ and validation/ folders of class folders. It runs
on one CUDA device unless --device cpu is given. The trained model is
written to <checkpoint-path>/last.msgpack as the flax variable tree
(`core/checkpoint.save_variables`; meta model_type, n_classes, history),
which the JAX package's `load_variables` and the port's `load_defense`
read; periodic train states go to <checkpoint-path>/step_NNNNNNNN/.

Data parallel, one process per GPU (the reference's torchrun DDP trainer):

  torchrun --nproc-per-node 4 -m gen_adversarial_tpu_torch.cli.train_classifier \
      ... --distributed

--cumulative-bs is the global batch (train/classifier.fit); rank 0 alone
logs and writes the files. --n-devices > 1 in one process raises, naming
that command.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def load_pretrained_backbone(path: str, model_type: str, n_classes: int,
                             image_size: int, seed: int = 0) -> dict:
    """A torchvision .pt state dict -> the classifier's flax variable tree,
    its projector head fresh (from a generator seeded `seed`);
    `image_size` is unused and kept for the JAX signature."""
    import torch

    from gen_adversarial_tpu_torch.core.convert import to_jax_variables
    from gen_adversarial_tpu_torch.core.init import flax_init_
    from gen_adversarial_tpu_torch.core.torch_convert import convert_torchvision_backbone
    from gen_adversarial_tpu_torch.models.classifiers import make_classifier

    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
    model = flax_init_(make_classifier(model_type, n_classes, device="cpu"),
                       torch.Generator().manual_seed(seed))
    return convert_torchvision_backbone(sd, model_type, to_jax_variables(model))


def main(argv: list[str] | None = None):
    """Returns (state, history) of `train/classifier.fit`."""
    p = argparse.ArgumentParser("classifier training")
    p.add_argument("--data-path", required=True,
                   help="directory with train/ and validation/ subfolders")
    p.add_argument("--model-type", choices=["resnext", "resnet", "vgg"], required=True)
    p.add_argument("--n-classes", type=int, required=True)
    p.add_argument("--cumulative-bs", type=int, required=True)
    p.add_argument("--image-size", type=int, required=True)
    p.add_argument("--epochs", type=int, required=True)
    p.add_argument("--lr", type=float, required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument("--checkpoint-path", default=None)
    p.add_argument("--pretrained", default=None, metavar="TORCHVISION_PT",
                   help="path to a torchvision ImageNet state dict (.pt); "
                        "initializes the backbone from it with a fresh projector head")
    p.add_argument("--distributed", action="store_true",
                   help="data parallel over torchrun's processes, one GPU each")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK under torchrun) or cpu")
    args = p.parse_args(argv)

    from gen_adversarial_tpu_torch.core import distributed as dist_util

    dist_util.check_n_devices(args.n_devices, "gen_adversarial_tpu_torch.cli.train_classifier")
    if args.distributed:
        dist_util.maybe_initialize()

    from gen_adversarial_tpu_torch.core.checkpoint import save_variables
    from gen_adversarial_tpu_torch.core.convert import to_jax_variables
    from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset
    from gen_adversarial_tpu_torch.train.classifier import fit

    init_variables = None
    if args.pretrained:
        init_variables = load_pretrained_backbone(
            args.pretrained, args.model_type, args.n_classes, args.image_size, args.seed)
    tds = ImageLabelDataset(f"{args.data_path}/train", args.image_size)
    vds = ImageLabelDataset(f"{args.data_path}/validation", args.image_size)
    state, history = fit(args.model_type, args.n_classes, args.image_size, tds, vds,
                         epochs=args.epochs, lr=args.lr, batch_size=args.cumulative_bs,
                         seed=args.seed, n_devices=args.n_devices,
                         checkpoint_dir=args.checkpoint_path,
                         init_variables=init_variables, distributed=args.distributed,
                         device=args.device)
    if args.checkpoint_path and (not args.distributed or dist_util.is_rank0()):
        save_variables(Path(args.checkpoint_path) / "last.msgpack",
                       to_jax_variables(state.model),
                       {"model_type": args.model_type, "n_classes": args.n_classes,
                        "history": history})
    return state, history


if __name__ == "__main__":
    main()
