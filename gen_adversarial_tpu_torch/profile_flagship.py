"""Where a defense call's time goes on the GPU: one torch.profiler trace of
the EoT-32 call of the ids flagship (batch 4, initial noise eps 2.0), of
the gender defense (batch 2 at 256 px, initial noise eps 4.0) or of the cars
defense (batch 4 at 128 px, initial noise eps 4.0), random weights from
seed 0, in float32 (TF32 off) or in bfloat16 (core/precision.defense_astype
after the build): one warm-up call, 2 calls untraced, then 2 calls traced.
`--family nvae_train` traces the flagship NVAE's training step instead
(train/nvae.make_nvae_train_step at batch 16, 64 px, input noise 0.03,
float32: the forward with batch statistics, the backward and Adamax).

    python3 -m gen_adversarial_tpu_torch.profile_flagship
        [--family ids|gender|cars|nvae_train] [--dtype float32|bfloat16]

Prints one JSON line: the card (name and power limit as nvidia-smi gives
them), the host wall time of the same number of calls untraced and traced
(their difference is the tracing cost), the summed device time of the
traced kernels and its share of the untraced wall time (the busy share;
1 minus it is the idle share), the device time by kind of kernel (the K1
segment kernel, the K2 blur kernel, convolutions, matrix products,
elementwise and reductions, other), the part of the convolutions' time
that cuDNN spends in its NCHW <-> NHWC layout transposes, and the ten
kernels that took the most time. Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time


def kind_of(name: str) -> str:
    n = name.lower()
    # K1's and K2's kernels in both builds: segment_{f32,bf16}_kernel and
    # blur_{f32,bf16}_kernel
    if "segment_f32_kernel" in n or "segment_bf16_kernel" in n:
        return "k1_depthwise_segment"
    if "blur_f32_kernel" in n or "blur_bf16_kernel" in n:
        return "k2_upfirdn_blur"
    if any(s in n for s in ("conv", "fprop", "implicit", "winograd", "cudnn", "xmma")):
        return "convolution"
    if "gemm" in n or "gemv" in n:
        return "matmul"
    if any(s in n for s in ("elementwise", "reduce", "vectorized", "unrolled", "cat",
                            "upsample", "pool", "softmax", "batch_norm")):
        return "elementwise_and_reduction"
    return "other"


def is_layout_transpose(name: str) -> bool:
    """cuDNN's NCHW <-> NHWC transposes (counted among the convolutions)."""
    n = name.lower()
    return "nchwtonhwc" in n or "nhwctonchw" in n


def kernel_times(prof, torch) -> dict:
    """The device kernels of a torch.profiler trace: name -> (summed us, count)."""
    kernels = {}
    for evt in prof.events():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        total, count = kernels.get(evt.name, (0.0, 0))
        kernels[evt.name] = (total + evt.time_range.elapsed_us(), count + 1)
    return kernels


CALLS = 2
SEED = 0
# family -> (batch, image size, initial noise eps)
FAMILIES = {"ids": (4, 64, 2.0), "gender": (2, 256, 4.0), "cars": (4, 128, 4.0),
            "nvae_train": (16, 64, 0.0)}
# the NVAE training step's input noise std
TRAIN_INPUT_NOISE = 0.03


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--family", choices=sorted(FAMILIES), default="ids")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    args = parser.parse_args(argv)
    family = args.family
    batch, size, eps = FAMILIES[family]
    import torch
    if not torch.cuda.is_available():
        print("profile_flagship: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from gen_adversarial_tpu_torch.cars import cars_defense
    from gen_adversarial_tpu_torch.core.precision import defense_astype
    from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
    from gen_adversarial_tpu_torch.flagship import flagship
    from gen_adversarial_tpu_torch.gender import gender_defense

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30)
    dev = torch.device("cuda")
    images = torch.rand(batch, size, size, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED))
    draws = torch.Generator(device=dev).manual_seed(SEED + 1)
    if family == "nvae_train":
        if args.dtype != "float32":
            parser.error("--family nvae_train runs in float32")
        from gen_adversarial_tpu_torch.core.init import flax_init_
        from gen_adversarial_tpu_torch.flagship import FLAGSHIP_NVAE
        from gen_adversarial_tpu_torch.models.nvae.model import NVAE
        from gen_adversarial_tpu_torch.train.nvae import make_nvae_train_step
        nvae = flax_init_(NVAE(FLAGSHIP_NVAE, device=dev),
                          torch.Generator(device=dev).manual_seed(SEED))
        _, step = make_nvae_train_step(nvae, 6e-3, num_total_iter=100,
                                       input_noise=TRAIN_INPUT_NOISE)

        def call():
            step({"image": images}, draws, 5)
        grad_mode = contextlib.nullcontext()
    else:
        make = {"ids": flagship, "gender": gender_defense, "cars": cars_defense}[family]
        defense = make(initial_noise_eps=eps, device=dev, seed=SEED)
        if args.dtype == "bfloat16":
            defense_astype(defense, torch.bfloat16)
        net = eot_wrap(defense, eot_steps=32)

        def call():
            net(images, draws)
        grad_mode = torch.no_grad()
    with grad_mode:
        call()
        torch.cuda.synchronize()
        t = time.monotonic()
        for _ in range(CALLS):
            call()
        torch.cuda.synchronize()
        untraced_s = time.monotonic() - t
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.monotonic()
            for _ in range(CALLS):
                call()
            torch.cuda.synchronize()
            wall_s = time.monotonic() - t

    kernels = kernel_times(prof, torch)
    device_s = sum(us for us, _ in kernels.values()) / 1e6
    by_kind = {}
    for name, (us, _) in kernels.items():
        by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + us / 1e6
    transpose_s = sum(us for name, (us, _) in kernels.items() if is_layout_transpose(name)) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi.stdout.strip() or "not available",
        "family": family, "calls": CALLS, "batch": batch, "image_size": size,
        "initial_noise_eps": eps, "eot_steps": 32 if family != "nvae_train" else None,
        "dtype": args.dtype,
        "wall_s": wall_s, "untraced_wall_s": untraced_s,
        "device_kernel_s": device_s if kernels else "not measured",
        "busy_share": device_s / untraced_s if kernels else "not measured",
        "by_kind_s": by_kind, "layout_transpose_s": transpose_s,
        "top_kernels": [{"name": n[:120], "s": us / 1e6, "count": c}
                        for n, (us, c) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
