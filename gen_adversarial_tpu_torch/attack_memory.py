"""What of the harness's attacks fits one card: the peak memory and seconds
of the attacks' differentiated calls on the three full-width defenses
(random weights from seed 0) at the CLI's batch of 8 and EoT-32, float32.

Per family:
- `grad`: one input gradient of the summed cross-entropy (an APGD step's
  and a C&W step's backward);
- `deepfool`: DeepFool's class Jacobian (attacks/utils.class_grads over the
  suite's deepfool_num_classes, core/config.ATTACK_SUITES) in one block and
  in blocks of each DF_BLOCKS entry below it;
- `fab`: FAB's over all the family's classes, likewise with FAB_BLOCKS.
A blocked Jacobian is measured over two blocks of cotangents (its peak is a
block's; its seconds are the forward's and two blocks'). ids runs without
an EoT chunk; gender and cars (remat on) at each EOT_CHUNKS entry (a chunk
whose gradient does not fit measures nothing more). A call that runs out
of the card's memory is recorded with `oom` and the peak reached.

Usage: python3 -m gen_adversarial_tpu_torch.attack_memory
    [--out ATTACK_MEMORY.json] [--only ids|gender|cars]
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch
import torch.nn.functional as F

from gen_adversarial_tpu_torch.attacks.utils import class_grads
from gen_adversarial_tpu_torch.cars import cars_defense
from gen_adversarial_tpu_torch.core.config import ATTACK_SUITES, IMAGE_SIZE, N_CLASSES
from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.eval.factory import resolve_device
from gen_adversarial_tpu_torch.flagship import flagship
from gen_adversarial_tpu_torch.gender import gender_defense
from gen_adversarial_tpu_torch.smoke_all_configs import device_line

BATCH, EOT_STEPS = 8, 32
EOT_CHUNKS = {"ids": (None,), "gender": (4, 2, 1), "cars": (4, 2)}
DF_BLOCKS = (4, 2)
FAB_BLOCKS = (4, 2, 1)
BUILD = {"ids": lambda d: flagship(initial_noise_eps=2.0, device=d, seed=0),
         "gender": lambda d: gender_defense(device=d, seed=0),
         "cars": lambda d: cars_defense(device=d, seed=0)}


def measure(fn, device) -> dict:
    """fn's seconds (synchronized) and peak GiB, or its out-of-memory."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t = time.monotonic()
    try:
        fn()
        torch.cuda.synchronize(device)
        row = {"s": time.monotonic() - t}
    except torch.OutOfMemoryError:
        row = {"oom": True, "s": time.monotonic() - t}
    row["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    return row


def family_rows(experiment: str, device) -> dict:
    defense = BUILD[experiment](device)
    size, n_classes = IMAGE_SIZE[experiment], N_CLASSES[experiment]
    x = torch.rand(BATCH, size, size, 3, device=device,
                   generator=torch.Generator(device=device).manual_seed(1))
    y = torch.zeros(BATCH, dtype=torch.long, device=device)

    def draws():
        return torch.Generator(device=device).manual_seed(2)

    def grad(net):
        def run():
            xx = x.detach().requires_grad_(True)
            loss = F.cross_entropy(net(xx, draws()), y, reduction="sum")
            torch.autograd.grad(loss, xx)
        return run

    def jacobian(net, k, block):
        # k classes (the first k of each image's), in blocks of `block`:
        # two blocks, or one block of all k
        n = k if block is None else min(k, 2 * block)
        idx = torch.arange(n, device=device).expand(BATCH, n)
        return lambda: class_grads(net, x, draws(), idx, cotangent_chunk=block)

    rows = {}
    df_classes = ATTACK_SUITES[experiment].deepfool_num_classes
    for chunk in EOT_CHUNKS[experiment]:
        net = eot_wrap(defense, EOT_STEPS, chunk=chunk)
        row = {"grad": measure(grad(net), device)}
        rows[f"eot_chunk_{chunk}"] = row
        if row["grad"].get("oom"):
            continue
        for name, k, blocks in (("deepfool", df_classes, DF_BLOCKS),
                                ("fab", n_classes, FAB_BLOCKS)):
            row[name] = {"classes": k}
            for block in (None,) + tuple(b for b in blocks if b < k):
                row[name][f"block_{block or k}"] = measure(jacobian(net, k, block), device)
        print(experiment, chunk, json.dumps(row), flush=True)
    return rows


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser("peaks of the attacks' differentiated calls at batch 8")
    p.add_argument("--out", default="ATTACK_MEMORY.json")
    p.add_argument("--only", choices=tuple(BUILD), default=None)
    args = p.parse_args(argv)
    device = resolve_device("cuda", "attack_memory")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"nvidia_smi": device_line(device), "batch": BATCH, "eot_steps": EOT_STEPS,
              "capacity_gib": torch.cuda.get_device_properties(device).total_memory / 2**30,
              "families": {}}
    for experiment in BUILD:
        if args.only in (None, experiment):
            report["families"][experiment] = family_rows(experiment, device)
            with open(args.out, "w") as f:
                json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
