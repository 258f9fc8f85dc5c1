"""One rank of tests/test_torch_distributed.py's two-rank runs of the port,
started by torchrun on the CPU (gloo). It imports no JAX, so that a rank
starts in a few seconds.

  python -m torch.distributed.run --nproc-per-node 2 --master-addr 127.0.0.1 \\
      --master-port <port> tests/_torch_distributed_worker.py <mode> <args>

modes:
  harness <images> <config> <results>   run_benchmark, DeepFool, tiny VGG
  train <data> <out.npz>                fit on the tiny VGG; rank 0 writes the params
  trades <data> <classifier> <out>      the TRADES CLI, tiny VGG, 2 inner steps
  bn <out_dir>                          a training BatchNorm2d forward and backward
Every rank writes what it returns to rank<r>.json beside its output (the
ranks share one stdout, where their lines can interleave).
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from gen_adversarial_tpu_torch.core import distributed

TINY_PLAN = (4, "M", 8, "M", 8, 8, "M", 8, 8, "M", 8, 8, "M")  # torch_port_helpers'
TIMEOUT_S = 30.0  # a dead rank fails the others' collectives within this
TRAIN = dict(epochs=1, lr=1e-3, batch_size=4, seed=7)
TRADES_STEPS = 2
# the BatchNorm case: a global batch of BN_SHAPE, split over the ranks
BN_SHAPE = (6, 3, 4, 4)


def tiny_vgg(model_type, n_classes, device="cpu"):
    from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
    return VGG11BN(n_classes, plan=TINY_PLAN, device=device)


def harness(images, config, results):
    from gen_adversarial_tpu_torch.eval import factory
    from gen_adversarial_tpu_torch.eval.harness import run_benchmark

    factory.make_classifier = tiny_vgg
    loaded = factory.load_defense(config, device="cpu")
    out = run_benchmark(loaded, images, results, batch_size=2, attack_filter="deepfool",
                        plots=False, log_fn=lambda s: None, distributed=True)
    report(results, out)


def report(out_path, value) -> None:
    """`value` as JSON in rank<r>.json beside `out_path`."""
    rank = distributed.process_shard()[0]
    (Path(out_path).parent / f"rank{rank}.json").write_text(json.dumps(value))


def train(data, out_npz):
    from gen_adversarial_tpu_torch.core.convert import to_jax_variables
    from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset
    from gen_adversarial_tpu_torch.train import classifier

    classifier.make_classifier = tiny_vgg
    tds = ImageLabelDataset(f"{data}/train", 32)
    vds = ImageLabelDataset(f"{data}/validation", 32)
    state, history = classifier.fit("vgg", 2, 32, tds, vds, log_fn=lambda s: None,
                                    distributed=True, device="cpu", **TRAIN)
    report(out_npz, history)
    if distributed.is_rank0():
        np.savez(out_npz, **flat(to_jax_variables(state.model)))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def patch_trades(image_size=32, n_classes=2):
    """The ids experiment at the tiny VGG's size and TRADES_STEPS inner
    steps (what tests/test_torch_distributed.py's one-rank run patches)."""
    from gen_adversarial_tpu_torch.core import config
    from gen_adversarial_tpu_torch.eval import factory
    from gen_adversarial_tpu_torch.train import trades

    factory.make_classifier = tiny_vgg
    config.IMAGE_SIZE["ids"] = image_size
    config.N_CLASSES["ids"] = n_classes
    make = trades.make_trades_train_step
    trades.make_trades_train_step = (
        lambda beta, epsilon: make(beta, epsilon, perturb_steps=TRADES_STEPS))


def trades_argv(data, ckpt, out):
    return ["--data-path", data, "--experiment", "ids", "--classifier-path", ckpt,
            "--epochs", "1", "--lr", "1e-3", "--cumulative-bs", "4", "--seed", "3",
            "--out", out, "--device", "cpu"]


def trades(data, ckpt, out):
    from gen_adversarial_tpu_torch.cli import trades_finetune

    patch_trades()
    trades_finetune.main(trades_argv(data, ckpt, out) + ["--distributed"])


def bn_case(seed=0):
    """(module, global input, cotangent) of the BatchNorm case."""
    from gen_adversarial_tpu_torch.models.batchnorm import BatchNorm2d

    rng = np.random.RandomState(seed)
    bn = BatchNorm2d(BN_SHAPE[1], eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(1 + 0.1 * rng.randn(BN_SHAPE[1]).astype(np.float32)))
        bn.bias.copy_(torch.tensor(0.1 * rng.randn(BN_SHAPE[1]).astype(np.float32)))
    x = torch.tensor((rng.randn(*BN_SHAPE) * 2 + 0.5).astype(np.float32))
    g = torch.tensor(rng.randn(*BN_SHAPE).astype(np.float32))
    return bn.train(), x, g


def bn_run(bn, x, g) -> dict:
    """Forward, backward of sum(y * g); what the test compares."""
    x = x.clone().requires_grad_(True)
    y = bn(x)
    (y * g).sum().backward()
    return {"y": y.detach().numpy(), "x_grad": x.grad.numpy(),
            "weight_grad": bn.weight.grad.numpy(), "bias_grad": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(), "running_var": bn.running_var.numpy()}


def bn(out_dir):
    rank, world = distributed.process_shard()
    module, x, g = bn_case()
    b = x.shape[0] // world
    part = slice(rank * b, (rank + 1) * b)
    np.savez(Path(out_dir) / f"bn_rank{rank}.npz", **bn_run(module, x[part], g[part]))


def main():
    distributed.maybe_initialize(timeout_s=TIMEOUT_S)
    mode, args = sys.argv[1], sys.argv[2:]
    {"harness": harness, "train": train, "trades": trades, "bn": bn}[mode](*args)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
