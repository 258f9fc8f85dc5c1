#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gen_adversarial_tpu_torch) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ with nvcc (one process per
source, all at once), then for each of the port's two paths checks its
kernel against the kernel's plain PyTorch version at the shapes the path
gives it and drives the path, float32, random weights from a seed:

- the ids flagship defense (NVAE purify -> VGG11-BN, EoT-32, initial noise
  eps 2.0) on a batch of 4 images, through K1 (csrc/depthwise_segment.cu);
- the gender defense (E4E -> StyleGAN2-1024 -> ResNet50, EoT-32, initial
  noise eps 4.0) on a batch of 2 images at 256 px, through K2
  (csrc/upfirdn_blur.cu);
- the cars defense (Style-Transformer -> StyleGAN2-512 -> ResNeXt50,
  EoT-32, initial noise eps 4.0) on a batch of 4 images at 128 px, through
  K2 at the 512-px generator's shapes.

Each path is then rehearsed small on the GPU and on the CPU with the same
weights and draws (the GPU defense a deep copy of the CPU one; for ids also
with the NVAE's normalizing-flow cells). Phase `grad` takes input gradients the way the attacks
will (torch.func.vjp, then vmap over the one-hot class cotangents) through
the three small defenses on the GPU and the CPU, and one input gradient of
the full ids flagship, timed, with its peak memory. Then the attacks
(gen_adversarial_tpu_torch/attacks): `attacks_parity` runs each of them a
few steps through a small ids defense with frozen draws on the GPU and the
CPU (FAB over 100 classes), and the staged AutoAttack against the
monolithic one on the GPU; `attack_flagship` runs DeepFool and APGD-CE a
few steps on the full ids flagship (EoT-32), through K1; `attack_remat`
runs APGD-CE's start (one CE gradient) on the full gender defense and
one input gradient of the full cars defense, both with remat, through K2.
The CPU's references of `grad`, `attacks_parity` and `bf16_parity` run on
a worker thread while the card runs the phases after them; `cpu_refs`, after `attack_remat`, waits
for them and makes the grad and attack checks. Then bfloat16
(core/precision.defense_astype): `kernels_bf16` checks the kernels'
bfloat16 builds against their bfloat16 plain versions
at the flagship's, the gender path's and the cars path's shapes (K2
bit-identical, K1 within one bfloat16 ulp) and at ragged ones, and times
them; `bf16` runs the three full-width forwards in
bfloat16 after a float32 call on the same weights, with the host's cost of
a launch and, from one torch.profiler trace in each dtype, the device's
busy share and the kernels' device time; `bf16_parity` holds cast
copies of the three small defenses and the small ids class gradients in
bfloat16 on the GPU against the CPU's float32, within twice the CPU's own
bfloat16 distance;
`attack_bf16` runs APGD-CE on the bfloat16 flagship and, with remat, on the
bfloat16 gender defense. Phase `attack_remat` also takes one CE input
gradient of the full gender defense under each `remat_policy`. Last,
`harness` runs the evaluation entry points on the float32 flagship from
files: its NVAE and VGG written as the paper's released checkpoints hold
them (reference-format .pt files fabricated from the modules by
tests/torch_reference_layout.py, the NVAE's convolutions weight-normed),
converted to flax msgpack by cli/convert_checkpoints.py (each file's tree
held against core/convert.to_jax_variables of its module), a copy of
configs/ours_linear_noise_ids.yaml pointing at them, 6 PNG images in two
class folders (made by phase `harness_files`, right after `parity`: the
converter's two processes run on the host while the card runs the kernel,
gender, cars, gradient, attack and bfloat16 phases);
`eval/factory.load_defense` (its logits held against the built defense's
on the same draws) and `eval/harness.run_benchmark` under DeepFool and C&W
at short budgets, with plots, checked as results.json (each
attack moves an image classified right to a finite minimal L2) and PNG
files, then under the staged AutoAttack (APGD-CE and APGD-DLR at their
three bounds, FAB over all 100 classes in attacks/utils.class_block's
blocks) at 1 iteration a stage on the first batch, its list joining the
others in results.json, with K1's launches and the peak (the full-length
run at the CLI's batch on each family is
gen_adversarial_tpu_torch/smoke_autoattack.py; the CLIs at their defaults,
gen_adversarial_tpu_torch/smoke_cli_defaults.py). The phase line gives the
EoT chunk the CLIs would take at the harness's batch and the class blocks
DeepFool and FAB took where none was given (4 of DeepFool's 8 classes and
of FAB's 100 at batch 4). Phase `configs` (after
`distributed`) copies six more configs onto the harness's files
(ours_cosine_blur_ids, ours_learned_no_preprocessing_ids, both ablations,
no_defense_ids, competitor_trades_ids), loads each through load_defense
and holds its EoT-2 forward at batch 2 to the harness's built
modules under the config's settings on the same draws, with K1's 50
launches on the two ours_* and none elsewhere, and times one DeepFool step
on ours_cosine_blur_ids (the input blur and the shared-encode EoT); the
other configs run in gen_adversarial_tpu_torch/smoke_all_configs.py. Then
`alpha_search` runs cli/alpha_search.py's main() on the same
files: make-adv (FGSM at L2 2.0 through EoT-32 over the 6 PNGs; at least
one adversary kept, each a 64 x 64 PNG under its source's name within the
bound of it) and bo (the 5 seed schedules and 1 GP step on the kept set;
alphas.npy and accuracies.npy checked), then an AlphaEvaluator on the
harness's loaded flagship draws the same at one position twice and after
fast_forward, and the GP's fit and acquisition on the card agree with the
CPU's. Last, `train` runs the trainers at full width: 1 + 3 steps of the
flagship NVAE's make_nvae_train_step (batch 16, input noise 0.03; no K1
launch) and of the flagship VGG11-BN's train_step (batch 64, train_augment),
with seconds a step and peak memory; the trained NVAE's eval
reconstruct(deterministic=True) launches K1 50 times and sample runs; the
NVAE written by save_variables and read back by load_variables reconstructs
the same; and one step of a small NVAE and of a small VGG on the card
agrees with the CPU's. Then the competitors, which launch neither kernel:
`competitors` writes random A-VAE and ND-VAE purifiers (flax's
initializers, from a seed) and a ResNet50 and a ResNeXt50 as checkpoints,
loads the six configs/competitor_{avae,ndvae}_{ids,gender,cars}.yaml copies
(the ids ones with the harness's flagship VGG) through load_defense and
times their EoT-32 forwards at each family's batch, a DeepFool step and a
CE input gradient on the ids pair, the A-VAE refusing bfloat16 and the
bfloat16 ND-VAE's agreement with float32, and a small A-VAE and ND-VAE on
the card against the CPU; `train_competitors` times the A-VAE's WGAN-GP
steps (batch 32, 64 px), the ND-VAE's cars128 recipe (batch 32) and
TRADES on the flagship VGG11-BN (batch 64), and holds one step of each, at
small sizes, on the card against the CPU: those steps' card half of the
A-VAE runs in phase `competitor_steps`, right before `harness`, and their
CPU halves on the worker thread while the card runs `harness` and the
phases after it. Then `distributed`
(core/distributed.py, one process per GPU): two ranks started by
`torch.distributed.run` share the card through gloo (NCCL refuses two ranks
on one GPU) and run the classifier CLI with --distributed on a small VGG,
held to one rank's run of the CLI, while this process joins an NCCL group
of one, reruns the harness's DeepFool with distributed=True (the harness
phase's results) and times the flagship VGG11-BN's train step in
DistributedDataParallel; and `discriminator`: K2 against its plain version
at the 1024-px StyleGAN2 discriminator's 16 blur sites (pads (2, 2) and
(1, 1), before its stride-2 convolutions), its forward and input gradient
at batch 4 with K2's 16 and 32 launches, one converted from a
reference-layout state dict giving the same logits, and a small one on the
card against the CPU. Every phase prints one JSON line with its seconds
and the run's seconds so far;
the second-to-last line summarises the kernels (K1 and K2, each in float32
and in bfloat16), and the last line is
{"ok": true, "device": {...}}. Any failure, or passing the 5-minute budget
(the build included), ends the run with a non-zero exit code and no last
line. Without a CUDA device it exits non-zero at once. It imports nothing of
JAX and nothing of the JAX package. `python3 chip_smoke.py ddp-worker ...`
is one rank of phase `distributed`.
"""

from __future__ import annotations

import copy
import faulthandler
import json
import math
import subprocess
import sys
import time

BUDGET_S = 300.0
BATCH = 4
EOT_STEPS = 32
TIMED_CALLS = 1
GRAD_CALLS = 1  # timed input-gradient calls of the full flagship, after a warm-up
KERNEL_REPS = 10
# float32 kernel vs plain: both sum 25 products in float32 in another order
K1_TOL = 1e-5
# whole defense on the GPU vs on the CPU: ~50 layers of float32 convolutions
# in other summation orders
PARITY_RTOL = 1e-4
# the small gender and cars defenses' input gradients, GPU float32 vs CPU
# float64: at most this many times as far as the CPU's float32 gradient
# (phase `grad`)
GRAD_GAP_FACTOR = 1.2
# H100 SXM published peaks (NVIDIA data sheet), at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
K1_FLOP_PER_ELEMENT = 62  # 25 FMAs, two affines, two SiLUs
# the gender defense: batch 2 images x EoT-32, all 32 draws in one batch
GENDER_BATCH = 2
GENDER_EOT_CHUNK = None
# float32 kernel vs plain: 16 products summed in the same order, FMAs or not
K2_TOL = 1e-5
K2_FLOP_PER_OUTPUT = 16  # 4 FMAs vertical (per staged column), 4 horizontal
BLUR_PAD = (1, 1)  # the blur after a 3x3 up-convolution
# the cars defense: batch 4 images x EoT-32, all 32 draws in one batch
CARS_BATCH = 4
CARS_EOT_CHUNK = None
# K2's plain version is timed at fewer launches, warmed by the call that
# the check made (each is ~0.5 s at a 512- or 1024-px shape); the library
# calls that the kernels line reports at LIBRARY_REPS launches after
# LIBRARY_WARMUP (each is ~0.25 s at the 1025-px site)
K2_SLOW_REPS = 1
LIBRARY_REPS = 2
LIBRARY_WARMUP = 1
# the attacks, GPU vs CPU on a small defense (phase `attacks_parity`): a few
# steps of each; bounds (relative) and adversarial images (absolute, in
# [0, 1]) after steps that each take a float32 input gradient
ATTACK_TOL = 1e-3
# the attacks on the full flagship (phase `attack_flagship`): batch 4,
# DeepFool's 8 class cotangents in blocks of 4 (the backward's live memory),
# FLAGSHIP_DF_ITERS steps of it and ATTACK_APGD_ITERS of APGD-CE (also in
# bfloat16, phase `attack_bf16`)
ATTACK_BATCH = 4
ATTACK_DF_ITERS = 2  # also the harness's and phase distributed's DeepFool
FLAGSHIP_DF_ITERS = 1
ATTACK_APGD_ITERS = 1
ATTACK_COT_CHUNK = 4
# APGD-CE on the full gender defense and one input gradient of the full
# cars defense, remat on (phase `attack_remat`); the EoT draws in chunks of
# 4, so that a backward recomputes one chunk's purify at a time. APGD-CE at
# 0 iterations: its start, one CE gradient and the final forward (the
# harness's AutoAttack and smoke_autoattack.py step it)
REMAT_APGD_ITERS = 0
REMAT_EOT_CHUNK = 4
# their batches: the gender attack and CE gradients (also in bfloat16, phase
# `attack_bf16`) and the cars gradient on one image; the gender CE gradient
# under each remat_policy at EoT-REMAT_POLICY_EOT (two chunks)
REMAT_GENDER_BATCH = 1
REMAT_CARS_BATCH = 1
REMAT_POLICY_EOT = 8
# the small gender defense's class gradients with remat on against off, on
# cuDNN's deterministic algorithms: the recompute replays the same draws
REMAT_RTOL = 1e-5
# bfloat16 kernel vs its bfloat16 plain version: both sum in float32 and
# round y once, so they differ by one bfloat16 spacing at most (2**-7 of the
# value), beside the float32 kernels' absolute tolerance (phase
# `kernels_bf16`); the plain version timed at fewer launches, the library
# call at LIBRARY_REPS
BF16_KERNEL_RTOL = 2.0 ** -7
BF16_SLOW_REPS = 1
# phase `harness`: the flagship's results.json over 6 images at batch 4 (one
# full batch, one ragged batch of 2), DeepFool at ATTACK_DF_ITERS steps with
# its cotangents in its default blocks (attacks/utils.class_block: 4 at
# batch 4, ATTACK_COT_CHUNK), C&W at HARNESS_CW_STEPS steps
# and one restart. The random head's class-0 bias puts image 0 on class 0 by
# HARNESS_MARGIN_SIGMAS x the draw-to-draw std of its margin, so the attacks
# have a correctly classified image they can move at these budgets
HARNESS_BATCH = 4
HARNESS_IMAGES = 6
HARNESS_CW_STEPS = 4
HARNESS_MARGIN_SIGMAS = 2.0
HARNESS_SEED = 42  # run_benchmark's seed: its draws are computed here too
# then the staged AutoAttack through run_benchmark on the first batch of
# HARNESS_BATCH images: every stage (APGD-CE and APGD-DLR at three bounds
# each, FAB over all 100 classes in attacks/utils.class_block's blocks) at
# HARNESS_AA_ITERS iterations (the paper's 64 and 128; the full depth's
# peak, which does not grow with the steps, is smoke_autoattack.py's)
HARNESS_AA_ITERS = 1
# phase `configs`: copies of these configs on the harness's files, each
# loaded by load_defense and held to the same modules built directly at
# batch CONFIGS_BATCH x EoT-CONFIGS_EOT (ours_cosine_blur_ids: the input
# blur, then the shared-encode EoT at eps 0); one DeepFool step on the first
PHASE_CONFIGS = ("ours_cosine_blur_ids", "ours_learned_no_preprocessing_ids",
                 "ablation_blur_ids", "ablation_noise_ids", "no_defense_ids",
                 "competitor_trades_ids")
CONFIGS_BATCH = 2
CONFIGS_EOT = 2
# phase `alpha_search`: make-adv over the harness's 6 PNGs and the evaluator
# at batch 4, bo with 1 GP step after its 5 seed schedules; the GP on the
# card against the CPU at 12 points of the search's 24 alphas, each call on
# the same inputs: 200 (fit) or 60 (acquisition) float32 Adam steps,
# cuSOLVER's Cholesky against LAPACK's (on an H100 the fit's hyperparameters
# came 3.7e-4 apart, and acquisitions on two fits that far apart gave
# candidates 5.9e-3 apart, so the acquisition takes one fit's on both)
ALPHA_ADV_BATCH = 4
ALPHA_BO_STEPS = 1
ALPHA_GP_POINTS = 12
ALPHA_GP_TOL = 1e-3
# phase `train`: the flagship NVAE's make_nvae_train_step at batch 16 with
# input noise 0.03 and the flagship VGG11-BN's train_step at batch 64, each
# 1 warm-up and TRAIN_STEPS timed steps; then one step of a small NVAE and
# of a small VGG on the card against the CPU, from the same weights and
# draws (loss, gradients, parameters, running statistics; relative)
TRAIN_SEED = 7
TRAIN_STEPS = 1
TRAIN_NVAE_BATCH = 16
TRAIN_CLF_BATCH = 64
TRAIN_INPUT_NOISE = 0.03
TRAIN_PARITY_RTOL = 1e-4
# phase `competitors`: the six competitor configs from files at EoT-32, each
# family at its batch, purifiers random from this seed; phase
# `train_competitors`: the A-VAE's steps at the CLI's batch 32 (64 px), the
# ND-VAE's cars128 recipe (batch 32) and TRADES on the flagship VGG11-BN at
# TRAIN_CLF_BATCH with the ids recipe
COMPETITOR_SEED = 21
COMPETITOR_BATCH = {"ids": 4, "gender": 2, "cars": 4}
# the ids ND-VAE's DeepFool step takes its class cotangents one at a time:
# the forward keeps ~35 GB of activations (its 4096-wide post cell at 32 px
# and 1024-wide one at 64 px, 2.1 GB a tensor over 128 images), and blocks
# of 4 cotangents ran out of the card's 80 GB (no remat: eot_chunk would not
# bound a backward's memory)
COMPETITOR_DF_COT_CHUNK = {"avae": ATTACK_COT_CHUNK, "ndvae": 1}
# the DeepFool step and the CE gradient take the first image of the ids batch
COMPETITOR_ATTACK_BATCH = 1
TRAIN_AVAE_BATCH = 32
# the gender CE gradient under a remat_policy against policy None (phase
# attack_remat): the same function, but cuDNN may run other algorithms,
# and with random weights this gradient agrees only to ~1e-3 between them in
# float32 (phase grad); a recompute that drew afresh would differ by O(1)
POLICY_RTOL = 1e-2
# phase `distributed` (data parallel, core/distributed.py): the harness's
# DeepFool under an NCCL group of one; the flagship VGG11-BN's train step in
# DistributedDataParallel at TRAIN_CLF_BATCH; two ranks sharing the card
# (gloo: NCCL refuses two ranks on one GPU) run the classifier CLI on the
# train phase's small VGG over DDP_TRAIN images at global batch DDP_BATCH
# (2 steps), held to one rank's run of the same CLI at the CPU tests'
# tolerance. A rank's collectives wait at most DDP_TIMEOUT_S for the other.
DDP_PLAN = (8, "M", 16, "M", 16, "M")
DDP_IMAGE = 16
DDP_TRAIN = {"c0": 4, "c1": 4}
DDP_VALIDATION = {"c0": 3, "c1": 2}  # a ragged last batch of 1 image
DDP_BATCH = 4
DDP_TIMEOUT_S = 120
DDP_RTOL, DDP_ATOL = 2e-3, 1e-4
# phase `discriminator`: the 1024-px StyleGAN2 discriminator (channel
# multiplier 2) at batch 4, float32; its K2 blurs before the stride-2
# convolutions, 2 per ResBlock; a small one on the card against the CPU
DISC_SIZE = 1024
DISC_BATCH = 4
DISC_SMALL = 32

T0 = time.monotonic()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def run_phase(name, fn):
    t = time.monotonic()
    out = fn()
    elapsed = time.monotonic() - T0
    out = {"phase": name, "seconds": round(time.monotonic() - t, 3),
           "elapsed_s": round(elapsed, 3), **out}
    emit(out)
    if elapsed > BUDGET_S:
        raise RuntimeError(f"budget of {BUDGET_S:.0f} s passed after phase {name} "
                           f"({elapsed:.1f} s)")
    return out


def cuda_ms(torch, fn, reps=KERNEL_REPS, warmup=3) -> float:
    """Mean device ms of fn over `reps` launches, after `warmup`."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _leaves(tree, path=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def run_convert_cli(argv) -> None:
    """cli/convert_checkpoints.main(argv), then one JSON line: its seconds
    and its peak resident memory in GiB: VmHWM, the high-water mark of this
    process's own address space, where /proc reports it (getrusage's
    ru_maxrss keeps the forking parent's resident size across exec), and
    the largest resident size a thread sampled every 10 ms from
    /proc/self/statm; null where /proc has neither."""
    import os
    import re
    import threading

    from gen_adversarial_tpu_torch.cli.convert_checkpoints import main as convert

    page = os.sysconf("SC_PAGE_SIZE")
    sampled, done = [0], threading.Event()

    def sample():
        while not done.wait(0.01):
            try:
                with open("/proc/self/statm") as f:
                    sampled[0] = max(sampled[0], int(f.read().split()[1]) * page)
            except (OSError, ValueError, IndexError):
                return

    sampler = threading.Thread(target=sample, daemon=True)
    t = time.monotonic()
    sampler.start()
    convert(argv)
    seconds = time.monotonic() - t
    done.set()
    sampler.join()
    try:
        with open("/proc/self/status") as f:
            hwm = re.search(r"VmHWM:\s+(\d+)\s*kB", f.read())
    except OSError:
        hwm = None
    print(json.dumps({"seconds": seconds,
                      "vm_hwm_gib": int(hwm.group(1)) / 2**20 if hwm else None,
                      "sampled_rss_gib": sampled[0] / 2**30 if sampled[0] else None}))


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ddp_worker(data: str, out: str, distributed: str = "1") -> None:
    """The classifier CLI (cli/train_classifier.main) on DDP_PLAN's small
    VGG on cuda:0, with --distributed under torchrun's gloo group when
    `distributed` is "1" (two ranks share the card), each rank then writing
    its history and the time it ended to <out>/rank<r>.json (the ranks share
    one stdout, where their lines can interleave)."""
    from pathlib import Path

    import torch

    from gen_adversarial_tpu_torch.cli import train_classifier
    from gen_adversarial_tpu_torch.core import distributed as dist_util
    from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
    from gen_adversarial_tpu_torch.train import classifier

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if distributed == "1":
        dist_util.maybe_initialize(backend="gloo", timeout_s=DDP_TIMEOUT_S)
    make = classifier.make_classifier
    classifier.make_classifier = lambda t, n, device: VGG11BN(n, plan=DDP_PLAN, device=device)
    try:
        _, history = train_classifier.main(
            ["--data-path", data, "--model-type", "vgg", "--n-classes", "2",
             "--cumulative-bs", str(DDP_BATCH), "--image-size", str(DDP_IMAGE), "--epochs", "1",
             "--lr", "0.01", "--seed", "3", "--checkpoint-path", out, "--device", "cuda:0"]
            + (["--distributed"] if distributed == "1" else []))
    finally:
        classifier.make_classifier = make
    if distributed == "1":
        rank = dist_util.process_shard()[0]
        torch.distributed.destroy_process_group()
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / f"rank{rank}.json").write_text(
            json.dumps({"history": history, "ended": time.time()}))


# the converter CLI in a process of its own, as a user runs it
CONVERT_CLI = "import sys, chip_smoke; chip_smoke.run_convert_cli(sys.argv[1:])"
# a weight-norm fold (a norm, a quotient, a product in float32) against the
# weight it was made from
FOLD_RTOL, FOLD_ATOL = 1e-5, 1e-7


def _stop(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _stop_group(proc) -> None:
    """Kill proc's process group (started with start_new_session) if proc
    still runs."""
    import os
    import signal
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def reference_files_round_trip(torch, nvae, vgg, nvae_cfg, tmp, root):
    """The flagship's NVAE and VGG as the paper's released files hold them,
    fabricated from the modules (tests/torch_reference_layout.py): the NVAE's
    reference checkpoint, {'configuration', 'state_dict_temp=0.6'}, its
    convolutions weight-normed as torch's parametrizations store them, and
    the VGG's trainer checkpoint, {'state_dict'}. The converter CLI turns
    them into tmp/nvae.msgpack and tmp/vgg.msgpack, both files at once, in
    processes of their own, which this starts. Returns check(): it waits for
    them and holds each file's tree to the module's to_jax_variables leaf
    for leaf, equal but for the folded kernels (within FOLD_RTOL), and the
    NVAE's meta config to nvae_cfg; it returns the numbers and raises on a
    difference. Processes still running at exit are killed."""
    import atexit

    import numpy as np
    from gen_adversarial_tpu_torch.core.checkpoint import load_variables
    from gen_adversarial_tpu_torch.core.convert import to_jax_variables
    from gen_adversarial_tpu_torch.models.nvae.model import NVAEConfig
    from tests import torch_reference_layout as layout

    out = {}
    t = time.monotonic()
    trees = {"nvae": to_jax_variables(nvae), "vgg": to_jax_variables(vgg)}
    ckpt = layout.nvae_checkpoint(trees["nvae"], nvae_cfg, form="parametrizations")
    key = "state_dict_temp=0.6"
    ckpt[key] = {k: torch.from_numpy(v) for k, v in ckpt[key].items()}
    torch.save(ckpt, tmp / "nvae.pt")
    sd = layout.classifier_state_dict(trees["vgg"], "vgg")
    torch.save({"epoch": 0, "state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp / "vgg.pt")
    del ckpt, sd
    out["reference_pt_write_s"] = time.monotonic() - t
    out["reference_pt_gb"] = sum((tmp / f).stat().st_size for f in ("nvae.pt", "vgg.pt")) / 1e9

    args = {"nvae": ["--kind", "nvae", "--temperature", "0.6"],
            "vgg": ["--kind", "classifier", "--model-type", "vgg"]}
    t = time.monotonic()
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", CONVERT_CLI, *a, "--src", str(tmp / f"{name}.pt"),
         "--dst", str(tmp / f"{name}.msgpack")], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, a in args.items()}
    atexit.register(_stop, list(procs.values()))

    def check() -> dict:
        cli = {}
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=BUDGET_S)
            if proc.returncode != 0:
                raise RuntimeError(f"convert_checkpoints {name}: exit {proc.returncode}: "
                                   f"{stderr[-2000:]}")
            cli[name] = json.loads(stdout.strip().splitlines()[-1])
        out["convert_wall_s"] = time.monotonic() - t  # from the start, not from check()
        out["convert_cli"] = cli

        t_read = time.monotonic()
        files = {name: load_variables(tmp / f"{name}.msgpack") for name in trees}
        out["compare_read_s"] = time.monotonic() - t_read
        fold_err = 0.0
        for name, (got, meta) in files.items():
            want = dict(_leaves(trees[name]))
            got = dict(_leaves(got))
            if sorted(got) != sorted(want):
                raise RuntimeError(f"{name}: the converted tree's leaves differ: "
                                   f"{sorted(set(got) ^ set(want))[:5]}")
            for path, w in want.items():
                g = got[path]
                if g.dtype != w.dtype or g.shape != w.shape:
                    raise RuntimeError(f"{name} {path}: {g.dtype}{g.shape} for "
                                       f"{w.dtype}{w.shape}")
                if name == "nvae" and path[-1] == "kernel":
                    fold_err = max(fold_err, float(np.abs(g - w).max() / np.abs(w).max()))
                    if not np.allclose(g, w, rtol=FOLD_RTOL, atol=FOLD_ATOL):
                        raise RuntimeError(f"nvae {path}: the folded kernel is "
                                           f"{np.abs(g - w).max()} off")
                elif not np.array_equal(g, w):
                    raise RuntimeError(f"{name} {path}: the converted leaf differs")
        if NVAEConfig(**files["nvae"][1]["config"]) != nvae_cfg:
            raise RuntimeError(f"the NVAE's meta config {files['nvae'][1]['config']}")
        out["nvae_fold_max_rel_err"] = fold_err
        out["leaves"] = {name: len(list(_leaves(tree))) for name, tree in trees.items()}
        return out

    return check


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: this smoke runs only on the GPU")
    # a hang (a kernel that never returns) still ends the process
    faulthandler.dump_traceback_later(BUDGET_S + 60, exit=True)

    from concurrent.futures import ThreadPoolExecutor, wait

    from gen_adversarial_tpu_torch.core import cuda_build
    from gen_adversarial_tpu_torch.ops import depthwise as k1
    from gen_adversarial_tpu_torch.ops import upfirdn as k2

    # one nvcc per source, all started together, while the rest imports;
    # phase `build` collects them
    builder = ThreadPoolExecutor(1)
    building = builder.submit(cuda_build.load, k1.SOURCE, k2.SOURCE)
    builder.shutdown(wait=False)

    import torch.nn.functional as F
    from torch.func import vjp, vmap
    from gen_adversarial_tpu_torch import cars
    from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
    from gen_adversarial_tpu_torch.flagship import FLAGSHIP_NVAE, flagship
    from gen_adversarial_tpu_torch.gender import IMAGE_SIZE, gender_defense
    from gen_adversarial_tpu_torch.models.nvae.model import NVAEConfig, eps_shapes
    from gen_adversarial_tpu_torch.models.stylegan2.generator import GENERATOR_CHANNELS
    from gen_adversarial_tpu_torch.models.stylegan2.layers import BLUR_KERNEL

    # float32 means float32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    def device_phase():
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not available"
        print(line, flush=True)
        import os
        return {"kind": kind, "count": torch.cuda.device_count(), "nvidia_smi": line,
                "torch": torch.__version__, "cuda": torch.version.cuda,
                "host": {"cpus": os.cpu_count(), "usable_cpus": len(os.sched_getaffinity(0))}}

    device_info = run_phase("device", device_phase)

    def build_phase():
        t = time.monotonic()
        built = building.result()
        return {"wait_s": round(time.monotonic() - t, 3),
                "sources": [{"source": f"gen_adversarial_tpu_torch/csrc/{name}.cu",
                             "nvcc_s": round(b.seconds, 3), **cuda_build.ptxas_summary(b.log)}
                            for name, b in built.items()]}

    run_phase("build", build_phase)

    # every (hidden width, size) of the decoder segment in one decode, with
    # its launches per decode; the folded EoT batch is 32 * B
    shape_counts = {}
    for shape in FLAGSHIP_NVAE.decoder_segment_shapes():
        shape_counts[shape] = shape_counts.get(shape, 0) + 1
    n = EOT_STEPS * BATCH
    gen = torch.Generator(device=dev).manual_seed(0)

    def reset_counts():
        k1.reset_launches()
        k2.reset_launches()

    def kernels_phase():
        rows = []
        for (c, h), per_decode in shape_counts.items():
            x = torch.randn(n, c, h, h, device=dev, generator=gen).contiguous(
                memory_format=torch.channels_last)
            taps = torch.randn(5, 5, c, device=dev, generator=gen) * 0.2
            aff = [torch.randn(c, device=dev, generator=gen) * 0.5 + 1 for _ in range(4)]
            y = k1.depthwise_silu_segment(x, taps, *aff)
            torch.cuda.synchronize()
            plain = k1.depthwise_silu_segment_plain(x, taps, *aff)
            err = (y - plain).abs().max().item()
            scale = max(1.0, plain.abs().max().item())
            if not math.isfinite(err) or err > K1_TOL * scale:
                raise RuntimeError(f"K1 disagrees with its plain version at C={c} H={h}: "
                                   f"max abs err {err} > {K1_TOL * scale}")
            w = k1.taps_oihw(taps).contiguous()
            ms = cuda_ms(torch, lambda: k1.depthwise_silu_segment(x, taps, *aff))
            plain_ms = cuda_ms(torch, lambda: k1.depthwise_silu_segment_plain(x, taps, *aff))
            library_ms = cuda_ms(torch, lambda: F.conv2d(x, w, padding=2, groups=c))
            # what this card reaches for the same bytes: one read of x, one write
            copy = torch.empty_like(x)
            copy_ms = cuda_ms(torch, lambda: copy.copy_(x))
            elements = x.numel()
            bytes_moved = 2 * elements * 4 + (25 + 4) * c * 4
            bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S,
                                 elements * K1_FLOP_PER_ELEMENT / F32_FLOP_PER_S)
            rows.append({"C": c, "H": h, "N": n, "per_decode": per_decode,
                         "max_abs_err": err, "tol": K1_TOL * scale, "kernel_ms": ms,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "bound_ms": bound_ms, "roofline_share": bound_ms / ms,
                         "copy_ms": copy_ms})
            del x, y, plain, copy
        return {"kernel": "depthwise_silu_segment", "shapes": rows}

    kernels = run_phase("kernels", kernels_phase)

    def flagship_phase():
        t = time.monotonic()
        defense = flagship(initial_noise_eps=2.0, device=dev, seed=0)
        torch.cuda.synchronize()
        build_s = time.monotonic() - t
        net = eot_wrap(defense, eot_steps=EOT_STEPS)
        images = torch.rand(BATCH, 64, 64, 3, device=dev, generator=gen)
        draws = torch.Generator(device=dev).manual_seed(1)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()  # counts from here on are this path's
        times = []
        with torch.no_grad():
            for _ in range(1 + TIMED_CALLS):  # one warm-up, then the timed calls
                t = time.monotonic()
                logits = net(images, draws)
                torch.cuda.synchronize()
                times.append(time.monotonic() - t)
        launches = k1.launches
        passes = 1 + TIMED_CALLS
        per_decode = sum(shape_counts.values())
        if tuple(logits.shape) != (BATCH, 100):
            raise RuntimeError(f"logits have shape {tuple(logits.shape)}")
        if not torch.isfinite(logits).all():
            raise RuntimeError("logits are not all finite")
        if launches != per_decode * passes:
            raise RuntimeError(f"K1 launched {launches} times, expected "
                               f"{per_decode} x {passes} decode passes")
        timed = sum(times[1:])
        return {"batch": BATCH, "eot_steps": EOT_STEPS, "initial_noise_eps": 2.0,
                "dtype": "float32", "weights_build_s": build_s,
                "logits_shape": list(logits.shape), "finite": True,
                "k1_launches": launches, "k2_launches": k2.launches,
                "decode_passes": passes, "k1_launches_per_decode": per_decode,
                "call_s": times, "images_per_s": BATCH * TIMED_CALLS / timed,
                "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30}

    flag = run_phase("flagship", flagship_phase)
    torch.cuda.empty_cache()  # the flagship's weights went with its phase

    # the small defenses' CPU modules, each made once from its seed; every
    # use takes a deep copy (the same weights, for a fraction of a build)
    small_built = {}

    def small_cpu(make, *key):
        if key not in small_built:
            small_built[key] = make()
        return copy.deepcopy(small_built[key])

    def small_ids(n_classes=10, num_nf_cells=None, eot=4, on_card=True):
        """A small ids defense on the CPU and a deep copy of it on the GPU
        (None unless on_card), with EoT draws and images from a numpy seed;
        `num_nf_cells` 1 puts a normalizing-flow block after each latent's
        mix."""
        import numpy as np
        cfg = NVAEConfig(resolution=32, initial_channels=8, num_scales=2,
                         num_groups_per_scale=2, is_adaptive=False,
                         num_cells_per_group=1, num_latent_per_group=4, num_mixtures=3,
                         num_nf_cells=num_nf_cells)
        plan = (16, "M", 32, "M")
        b = 2
        kw = dict(initial_noise_eps=2.0, seed=3, cfg=cfg, vgg_plan=plan, n_classes=n_classes)
        cpu = small_cpu(lambda: flagship(device="cpu", **kw), "ids", n_classes, num_nf_cells)
        gpu = copy.deepcopy(cpu).to(dev) if on_card else None
        rng = np.random.RandomState(4)
        x = torch.tensor(rng.rand(b, 32, 32, 3).astype(np.float32))
        shapes = [(eot * b, 32, 32, 3)] + eps_shapes(cfg, eot * b)
        draws = [torch.tensor(rng.standard_normal(s).astype(np.float32)) for s in shapes]
        return cpu, gpu, x, draws, eot, len(cfg.decoder_segment_shapes())

    def parity_phase():
        # a small defense on the GPU (kernel path) against the same weights
        # and draws on the CPU (plain path), without and with the NVAE's
        # normalizing-flow cells
        out = {}
        for name, nf in (("ids", None), ("ids_flow_cells", 1)):
            cpu, gpu, x, draws, eot, segments = small_ids(num_nf_cells=nf)
            before = k1.launches
            with torch.no_grad():
                want = eot_wrap(cpu, eot)(x, draws)
                got = eot_wrap(gpu, eot)(x.to(dev), draws).cpu()
            if k1.launches - before != segments:
                raise RuntimeError(f"the GPU {name} defense did not go through K1")
            err = (got - want).abs().max().item()
            tol = PARITY_RTOL * max(1.0, want.abs().max().item())
            if not math.isfinite(err) or err > tol:
                raise RuntimeError(f"GPU {name} defense disagrees with the CPU one: {err} > {tol}")
            out[name] = {"num_nf_cells": nf, "flow_blocks": len(gpu.purifier.nf_cells),
                         "eot_steps": eot, "batch": x.shape[0], "max_abs_err": err, "tol": tol}
        return out

    run_phase("parity", parity_phase)
    torch.cuda.empty_cache()

    import tempfile
    from pathlib import Path

    # phases harness_files, harness and alpha_search share one directory: the
    # flagship's checkpoints (2.75 GB, written once), the config copy and the
    # 6 PNGs
    root = Path(__file__).resolve().parent
    (root / ".scratch").mkdir(exist_ok=True)  # gitignored
    scratch = tempfile.TemporaryDirectory(prefix="harness_", dir=root / ".scratch")
    shared = {}  # what a phase leaves to a later one

    def harness_files_phase():
        # the harness's float32 flagship, its 6 PNGs and its files: the
        # converter CLI's two processes (host numpy, about 15-18 s) run
        # while the next phases use the card; the harness phase collects them
        import numpy as np
        from gen_adversarial_tpu_torch.core.config import DefenseConfig
        from gen_adversarial_tpu_torch.data import png
        from gen_adversarial_tpu_torch.eval.harness import batch_generator

        out = {"nvidia_smi": device_info["nvidia_smi"]}
        tmp = Path(scratch.name)
        built = flagship(initial_noise_eps=2.0, device=dev, seed=0)
        # the config's alphas are rounded to two decimals: the built
        # defense takes them, so the loaded one computes the same logits
        cfg = DefenseConfig.from_yaml(root / "configs" / "ours_linear_noise_ids.yaml")
        built.alphas.copy_(torch.as_tensor(np.asarray(cfg.interpolation_alphas, np.float32)
                                           * np.float32(cfg.alpha_attenuation)))
        # 6 images in two class folders, 'a' (label 0: images 0-2, all in
        # the first batch) and 'b' (label 1). Random weights put every
        # image on one class by ~0.29 and move a logit by ~1e-3 from draw
        # to draw, so no image would be classified right: the head's
        # class-0 bias is raised until image 0 wins class 0 under the
        # harness's clean draw by HARNESS_MARGIN_SIGMAS x the std of its
        # margin over 8 draws (the harness's 4 stages of batch 0 and 4
        # more). Images 1-2 then fall either side of the boundary.
        rng = np.random.RandomState(0)
        pixels = (rng.rand(HARNESS_IMAGES, 64, 64, 3) * 255).astype(np.uint8)
        for i, image in enumerate(pixels):
            png.write(tmp / "images" / ("a" if i < HARNESS_IMAGES // 2 else "b")
                      / f"{i}.png", image)
        first = torch.tensor(pixels[:HARNESS_BATCH] / np.float32(255.0), device=dev)
        net = eot_wrap(built, EOT_STEPS)

        def margin_lost(logits):  # best other class minus class 0
            return logits[:, 1:].max(1).values - logits[:, 0]

        with torch.no_grad():
            draws = [batch_generator(HARNESS_SEED, 0, 0, stage, dev) for stage in range(4)]
            draws += [torch.Generator(device=dev).manual_seed(100 + i) for i in range(4)]
            lost = torch.stack([margin_lost(net(first, d))[0] for d in draws])
            sigma = lost.std().item()
            built.classifier.classifier.fc1.bias[0] += \
                lost[0].item() + HARNESS_MARGIN_SIGMAS * sigma
            clean = net(first, batch_generator(HARNESS_SEED, 0, 0, 0, dev)).argmax(1)
        out["image0_margin"] = {"sigma": sigma, "margin": HARNESS_MARGIN_SIGMAS * sigma}
        # the 'a' images the harness's clean predictions get right
        right = [i for i in range(HARNESS_IMAGES // 2) if clean[i].item() == 0]
        if 0 not in right:
            raise RuntimeError(f"image 0 is not on class 0 after the bias: {clean.tolist()}")
        del net, first
        torch.cuda.synchronize()
        # the checkpoints: reference-format .pt files of the built modules,
        # converted by the converter CLI in processes of their own, which run
        # through the next phases (see reference_files_round_trip)
        shared.update(built=built, right=right, conversion=reference_files_round_trip(
            torch, built.purifier, built.classifier, FLAGSHIP_NVAE, tmp, root))
        return out

    run_phase("harness_files", harness_files_phase)

    # phase `distributed`'s two ranks (each about 8 s to reach the card, then
    # import, rendezvous and two small steps; 34-43 s of wall on a slow host)
    # run while the card works through the phases up to `distributed`, which
    # collects them: started right after harness_files, they use the card only
    # in their last seconds, during the gradient and attack phases, after the
    # float32 kernel timings
    ddp_ranks = {}

    def start_ddp_ranks():
        import atexit
        import os

        import numpy as np
        from gen_adversarial_tpu_torch.core.distributed import TORCHRUN_ENV
        from gen_adversarial_tpu_torch.data import png

        tmp = Path(scratch.name) / "ddp"
        rng = np.random.RandomState(TRAIN_SEED)
        for split, counts in (("train", DDP_TRAIN), ("validation", DDP_VALIDATION)):
            for cls, count in counts.items():
                for i in range(count):
                    png.write(tmp / "data" / split / cls / f"{i}.png",
                              (rng.rand(DDP_IMAGE, DDP_IMAGE, 3) * 255).astype(np.uint8))
        env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
        ddp_ranks.update(dir=tmp, t0=time.time(), process=subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
             "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
             "--master-port", str(_free_port()), str(root / "chip_smoke.py"), "ddp-worker",
             str(tmp / "data"), str(tmp / "two")],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True))
        # a phase that fails before `distributed` collects them leaves none running
        atexit.register(_stop_group, ddp_ranks["process"])

    def stop_ddp_ranks() -> str:
        """The ranks' output once they have ended (their process group
        killed if they outlast DDP_TIMEOUT_S); '' if none was started."""
        import os
        import signal

        ranks = ddp_ranks.pop("process", None)
        if ranks is None:
            return ""
        try:
            stdout, _ = ranks.communicate(timeout=DDP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(ranks.pid, signal.SIGKILL)
            stdout, _ = ranks.communicate()
        ddp_ranks["returncode"] = ranks.returncode
        return stdout

    start_ddp_ranks()

    # the blur after every up-convolution of the 1024-px generator: output
    # r x r at r = 8 .. 1024, input (r + 1) x (r + 1), one launch per decode
    # each, on the folded EoT batch of the gender call
    n_gender = EOT_STEPS * GENDER_BATCH
    k2_sites = [(GENERATOR_CHANNELS[r], r + 1) for r in (2 ** i for i in range(3, 11))]

    # normalized, times the factor 2 of an up-convolution
    taps = tuple(2.0 * t / sum(BLUR_KERNEL) for t in BLUR_KERNEL)

    def k2_rows(sites, n, pad=BLUR_PAD, taps=taps, library_reps=(LIBRARY_REPS, LIBRARY_WARMUP)):
        """K2 against its plain version at each (C, H_in) of `sites` on a
        batch of n at `pad` (symmetric), timed with the plain version, the
        library call, a copy of the same bytes and the bound; the plain
        version at K2_SLOW_REPS launches, the library call at `library_reps`
        (launches, warm-ups)."""
        kf = torch.tensor(taps[::-1], device=dev)
        rows = []
        for c, h in sites:
            x = torch.randn(n, c, h, h, device=dev, generator=gen).contiguous(
                memory_format=torch.channels_last)
            y = k2.upfirdn_blur(x, taps, pad)
            torch.cuda.synchronize()
            plain = k2.blur_plain(x, taps, pad)
            err = (y - plain).abs().max().item()
            scale = max(1.0, plain.abs().max().item())
            del plain
            if not math.isfinite(err) or err > K2_TOL * scale:
                raise RuntimeError(f"K2 disagrees with its plain version at C={c} H={h}: "
                                   f"max abs err {err} > {K2_TOL * scale}")
            w2d = torch.outer(kf, kf).expand(c, 1, len(taps), len(taps)).contiguous()
            ms = cuda_ms(torch, lambda: k2.upfirdn_blur(x, taps, pad))
            plain_ms = cuda_ms(torch, lambda: k2.blur_plain(x, taps, pad), K2_SLOW_REPS,
                               warmup=0)
            # at a symmetric pad one depthwise convolution with the 2-D taps
            # is the same function
            library_ms = cuda_ms(torch, lambda: F.conv2d(x, w2d, padding=pad[0], groups=c),
                                 *library_reps)
            copy = torch.empty_like(x)
            copy_ms = cuda_ms(torch, lambda: copy.copy_(x))
            del copy
            bytes_moved = (x.numel() + y.numel()) * 4
            bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S,
                                 y.numel() * K2_FLOP_PER_OUTPUT / F32_FLOP_PER_S)
            rows.append({"C": c, "H_in": h, "H_out": y.shape[2], "N": n, "pad": list(pad),
                         "per_decode": 1, "elements_in": x.numel(),
                         "max_abs_err": err, "tol": K2_TOL * scale, "kernel_ms": ms,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "bound_ms": bound_ms, "roofline_share": bound_ms / ms,
                         "copy_ms": copy_ms})
            del x, y
            torch.cuda.empty_cache()
        return rows

    def ragged_f32():
        """K2's float32 build off the main paths' shapes, where it takes its
        masked path: widths that are not multiples of 4, and an x whose
        storage starts 4 bytes past 16-byte alignment; negative pads and 3
        taps. Each call one launch, within K2_TOL of the plain version."""
        asym, three = (0.1, 0.2, 0.3, 0.4), (1 / 7, 2 / 7, 4 / 7)
        cases = []
        for shape, kt, pad, offset in [((2, 3, 9, 9), asym, (1, 1), 0),
                                       ((1, 35, 20, 37), three, (-1, 2), 0),
                                       ((2, 45, 33, 31), asym, (2, 2), 0),
                                       ((3, 45, 17, 17), three, (0, -1), 0),
                                       ((2, 32, 33, 33), taps, BLUR_PAD, 1),
                                       ((1, 512, 16, 16), asym, (2, 2), 1)]:
            n_, c, h, w = shape
            flat = torch.randn(offset + n_ * h * w * c, device=dev, generator=gen)
            x = flat[offset:].view(n_, h, w, c).permute(0, 3, 1, 2)
            before = k2.launches
            got = k2.upfirdn_blur(x, kt, pad)
            launched = k2.launches - before
            plain = k2.blur_plain(x, kt, pad)
            err = (got - plain).abs().max().item()
            tol = K2_TOL * max(1.0, plain.abs().max().item())
            if launched != 1 or not math.isfinite(err) or err > tol:
                raise RuntimeError(f"K2 (float32) at {shape}, pad {pad}, storage offset "
                                   f"{offset}: {launched} launches, max abs err {err} > {tol}")
            cases.append({"shape": list(shape), "taps": len(kt), "pad": list(pad),
                          "offset_bytes": 4 * offset, "max_abs_err": err, "tol": tol})
        return cases

    def kernels_k2_phase():
        rows = k2_rows(k2_sites, n_gender)
        # the backward (the same kernel, flipped taps, transposed pads) once,
        # at a mid shape, against autograd through the plain version
        c, h = k2_sites[3]
        x = torch.randn(n_gender, c, h, h, device=dev, generator=gen).contiguous(
            memory_format=torch.channels_last)
        g = torch.randn(n_gender, c, h - 1, h - 1, device=dev, generator=gen).contiguous(
            memory_format=torch.channels_last)
        xk = x.clone().requires_grad_()
        before = k2.launches
        k2.upfirdn_blur(xk, taps, BLUR_PAD).backward(g)
        backward_launches = k2.launches - before
        xp = x.clone().requires_grad_()
        k2.blur_plain(xp, taps, BLUR_PAD).backward(g)
        bwd_err = (xk.grad - xp.grad).abs().max().item()
        bwd_tol = K2_TOL * max(1.0, xp.grad.abs().max().item())
        if backward_launches != 2 or not math.isfinite(bwd_err) or bwd_err > bwd_tol:
            raise RuntimeError(f"K2 backward: {backward_launches} launches, max abs err "
                               f"{bwd_err} (tol {bwd_tol})")
        del x, g, xk, xp
        torch.cuda.empty_cache()
        return {"kernel": "upfirdn_blur", "taps": list(taps), "pad": list(BLUR_PAD),
                "slow_reps": K2_SLOW_REPS, "library_reps": LIBRARY_REPS, "shapes": rows,
                "backward": {"C": c, "H_in": h, "max_abs_err": bwd_err, "tol": bwd_tol,
                             "launches": backward_launches},
                "ragged": ragged_f32()}

    kernels2 = run_phase("kernels_k2", kernels_k2_phase)

    def gender_phase():
        t = time.monotonic()
        defense = gender_defense(device=dev, seed=0)
        torch.cuda.synchronize()
        build_s = time.monotonic() - t
        net = eot_wrap(defense, eot_steps=EOT_STEPS, chunk=GENDER_EOT_CHUNK)
        images = torch.rand(GENDER_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3, device=dev,
                            generator=gen)
        draws = torch.Generator(device=dev).manual_seed(2)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()  # counts from here on are this path's
        times = []
        with torch.no_grad():
            for _ in range(1 + TIMED_CALLS):  # one warm-up, then the timed calls
                t = time.monotonic()
                logits = net(images, draws)
                torch.cuda.synchronize()
                times.append(time.monotonic() - t)
        launches = k2.launches
        passes = 1 + TIMED_CALLS
        per_decode = len(k2_sites)
        if tuple(logits.shape) != (GENDER_BATCH, 2):
            raise RuntimeError(f"logits have shape {tuple(logits.shape)}")
        if not torch.isfinite(logits).all():
            raise RuntimeError("logits are not all finite")
        if launches != per_decode * passes:
            raise RuntimeError(f"K2 launched {launches} times, expected "
                               f"{per_decode} x {passes} decode passes")
        timed = sum(times[1:])
        return {"batch": GENDER_BATCH, "eot_steps": EOT_STEPS, "eot_chunk": GENDER_EOT_CHUNK,
                "initial_noise_eps": defense.initial_noise_eps, "stylegan_size": 1024,
                "image_size": IMAGE_SIZE, "dtype": "float32", "weights_build_s": build_s,
                "logits_shape": list(logits.shape), "finite": True,
                "k2_launches": launches, "k1_launches": k1.launches,
                "decode_passes": passes, "k2_launches_per_decode": per_decode,
                "call_s": times, "images_per_s": GENDER_BATCH * TIMED_CALLS / timed,
                "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30}

    gender = run_phase("gender", gender_phase)
    torch.cuda.empty_cache()  # the gender weights went with its phase

    def small_gender(b=2, eot=2, on_card=True):
        """A small gender defense (32-px generator, full-width encoder, one
        ResNet block per stage) on the CPU and a deep copy of it on the GPU,
        with EoT draws and b 64-px images from a numpy seed."""
        import numpy as np
        size, image, n_codes = 32, 64, 8
        # remat off: phase `grad` differentiates it with torch.func, which
        # refuses torch.utils.checkpoint
        kw = dict(seed=3, stylegan_size=size, classifier_layers=(1, 1, 1, 1), remat=False)
        cpu = small_cpu(lambda: gender_defense(device="cpu", **kw), "gender")
        gpu = copy.deepcopy(cpu).to(dev) if on_card else None
        rng = np.random.RandomState(4)
        x = torch.tensor(rng.rand(b, image, image, 3).astype(np.float32))
        draws = [torch.tensor(rng.standard_normal(s).astype(np.float32))
                 for s in [(eot * b, image, image, 3), (n_codes, eot * b, 512)]]
        return cpu, gpu, x, draws, eot, size

    def gender_parity_phase():
        # the small gender defense on the GPU (kernel path) against the same
        # weights and draws on the CPU (plain path)
        cpu, gpu, x, draws, eot, size = small_gender()
        before = k2.launches
        with torch.no_grad():
            want = eot_wrap(cpu, eot)(x, draws)
            got = eot_wrap(gpu, eot)(x.to(dev), draws).cpu()
        launched = k2.launches - before
        if launched != 3:  # the up-convolutions at 8, 16 and 32 px
            raise RuntimeError(f"the GPU defense launched K2 {launched} times, expected 3")
        err = (got - want).abs().max().item()
        tol = PARITY_RTOL * max(1.0, want.abs().max().item())
        if not math.isfinite(err) or err > tol:
            raise RuntimeError(f"GPU gender defense disagrees with the CPU one: {err} > {tol}")
        return {"stylegan_size": size, "eot_steps": eot, "batch": x.shape[0],
                "k2_launches": launched, "max_abs_err": err, "tol": tol}

    run_phase("gender_parity", gender_parity_phase)
    torch.cuda.empty_cache()

    # the blur after every up-convolution of the 512-px generator: output
    # r x r at r = 8 .. 512, one launch per decode each, on the folded EoT
    # batch of the cars call
    n_cars = EOT_STEPS * CARS_BATCH
    k2_cars_sites = [(GENERATOR_CHANNELS[r], r + 1)
                     for r in (2 ** i for i in range(3, 1 + int(math.log2(cars.OUTPUT_SIZE))))]

    def kernels_k2_cars_phase():
        return {"kernel": "upfirdn_blur", "taps": list(taps), "pad": list(BLUR_PAD),
                "slow_reps": K2_SLOW_REPS, "library_reps": LIBRARY_REPS,
                "shapes": k2_rows(k2_cars_sites, n_cars)}

    kernels2_cars = run_phase("kernels_k2_cars", kernels_k2_cars_phase)

    def cars_phase():
        t = time.monotonic()
        defense = cars.cars_defense(device=dev, seed=0)
        torch.cuda.synchronize()
        build_s = time.monotonic() - t
        net = eot_wrap(defense, eot_steps=EOT_STEPS, chunk=CARS_EOT_CHUNK)
        images = torch.rand(CARS_BATCH, cars.IMAGE_SIZE, cars.IMAGE_SIZE, 3, device=dev,
                            generator=gen)
        draws = torch.Generator(device=dev).manual_seed(5)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()  # counts from here on are this path's
        times = []
        with torch.no_grad():
            for _ in range(1 + TIMED_CALLS):  # one warm-up, then the timed calls
                t = time.monotonic()
                logits = net(images, draws)
                torch.cuda.synchronize()
                times.append(time.monotonic() - t)
        launches = k2.launches
        passes = 1 + TIMED_CALLS
        per_decode = len(k2_cars_sites)
        if tuple(logits.shape) != (CARS_BATCH, cars.N_CLASSES):
            raise RuntimeError(f"logits have shape {tuple(logits.shape)}")
        if not torch.isfinite(logits).all():
            raise RuntimeError("logits are not all finite")
        if launches != per_decode * passes or k1.launches != 0:
            raise RuntimeError(f"K2 launched {launches} times, expected {per_decode} x "
                               f"{passes} decode passes; K1 {k1.launches} times, expected 0")
        timed = sum(times[1:])
        return {"batch": CARS_BATCH, "eot_steps": EOT_STEPS, "eot_chunk": CARS_EOT_CHUNK,
                "initial_noise_eps": defense.initial_noise_eps,
                "stylegan_size": cars.OUTPUT_SIZE, "image_size": cars.IMAGE_SIZE,
                "dtype": "float32", "weights_build_s": build_s,
                "logits_shape": list(logits.shape), "finite": True,
                "k2_launches": launches, "k1_launches": k1.launches,
                "decode_passes": passes, "k2_launches_per_decode": per_decode,
                "call_s": times, "images_per_s": CARS_BATCH * TIMED_CALLS / timed,
                "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30}

    cars_run = run_phase("cars", cars_phase)
    torch.cuda.empty_cache()  # the cars weights went with its phase

    def small_cars(eps, b, eot, on_card=True):
        """A small cars defense (32-px generator, full-width encoder, which
        always sees the 192 x 256 crop, one ResNeXt block per stage) on the
        CPU and a deep copy of it on the GPU, with EoT draws and 128-px images
        from a numpy seed."""
        import numpy as np
        size, n_codes, image = 32, 8, cars.IMAGE_SIZE
        kw = dict(initial_noise_eps=eps, seed=3, output_size=size,
                  classifier_layers=(1, 1, 1, 1), remat=False)  # as small_gender's
        cpu = small_cpu(lambda: cars.cars_defense(device="cpu", **kw), "cars", eps)
        gpu = copy.deepcopy(cpu).to(dev) if on_card else None
        rng = np.random.RandomState(4)
        x = torch.tensor(rng.rand(b, image, image, 3).astype(np.float32))
        shapes = ([(eot * b, image, image, 3)] if eps > 0 else []) + [(n_codes, eot * b, 512)]
        draws = [torch.tensor(rng.standard_normal(s).astype(np.float32)) for s in shapes]
        return cpu, gpu, x, draws, eot, size

    def cars_parity_phase():
        # the small cars defense on the GPU (kernel path) against the same
        # weights and draws on the CPU (plain path)
        cpu, gpu, x, draws, eot, size = small_cars(cars.INITIAL_NOISE_EPS, 2, 2)
        before = k2.launches
        with torch.no_grad():
            want = eot_wrap(cpu, eot)(x, draws)
            got = eot_wrap(gpu, eot)(x.to(dev), draws).cpu()
        launched = k2.launches - before
        if launched != 3:  # the up-convolutions at 8, 16 and 32 px
            raise RuntimeError(f"the GPU defense launched K2 {launched} times, expected 3")
        err = (got - want).abs().max().item()
        tol = PARITY_RTOL * max(1.0, want.abs().max().item())
        if not math.isfinite(err) or err > tol:
            raise RuntimeError(f"GPU cars defense disagrees with the CPU one: {err} > {tol}")
        return {"stylegan_size": size, "eot_steps": eot, "batch": x.shape[0],
                "initial_noise_eps": cars.INITIAL_NOISE_EPS, "k2_launches": launched,
                "max_abs_err": err, "tol": tol}

    run_phase("cars_parity", cars_parity_phase)
    torch.cuda.empty_cache()

    def class_grads(net, x, draws):
        """The input gradient of every class logit (summed over the batch):
        torch.func.vjp, then vmap of its vjp_fn over the one-hot class
        cotangents, as the JAX attacks' class_grads does
        (gen_adversarial_tpu/attacks/utils.py). (K, B, H, W, 3)."""
        logits, vjp_fn = vjp(lambda v: net(v, draws), x)
        k = logits.shape[-1]
        onehots = torch.eye(k, device=x.device)[:, None, :].expand(k, x.shape[0], k)
        (grads,) = vmap(vjp_fn)(onehots)
        return grads.detach()

    def rel_err(got, want):
        return ((got.double() - want.double()).abs().max()
                / want.double().abs().max()).item()

    # The CPU's references of phases grad, attacks_parity and bf16_parity
    # need nothing from the card: they run on one worker thread, in the
    # order submitted, while the card works through the phases after the one
    # that submits them (the attacks on the full defenses). Phase `cpu_refs`
    # (after attack_remat) waits for all of them, so that the bfloat16
    # timings run on an idle host, and makes the grad and attack checks;
    # bf16_parity makes its own.
    cpu_worker = ThreadPoolExecutor(1, thread_name_prefix="cpu_refs")
    submitted, deferred = [], {}

    def on_cpu(fn, *args):
        future = cpu_worker.submit(fn, *args)
        submitted.append(future)
        return future

    def grad_phase():
        out = {}
        reset_counts()  # counts from here on are this path's
        # the small ids defense: GPU (K1 forward, plain backward) vs CPU
        cpu, gpu, x, draws, eot, _ = small_ids()
        want = class_grads(eot_wrap(cpu, eot), x, draws)
        got = class_grads(eot_wrap(gpu, eot), x.to(dev), draws).cpu()
        err = rel_err(got, want)
        if not math.isfinite(err) or err > PARITY_RTOL:
            raise RuntimeError(f"ids input gradients, GPU vs CPU: {err} > {PARITY_RTOL}")
        out["ids"] = {"classes": want.shape[0], "eot_steps": eot, "rel_err": err,
                      "tol": PARITY_RTOL, "k1_launches": k1.launches}
        # a small StyleGAN defense: GPU (K2 forward and backward) vs CPU. With
        # random weights its input gradient is ill-conditioned in float32 (the
        # logits agree to 1e-7, the gradient to ~1e-3), so it is held against
        # the CPU's float64 result: the GPU's float32 gradient may be no
        # farther from it than GRAD_GAP_FACTOR x the CPU's float32 one is.
        # cuDNN's default algorithm choice varies from run to run, and with
        # it that distance (the cars gradient's read 0.16 and 1.0 x the CPU's
        # in two runs of one tree), so the GPU runs cuDNN's deterministic
        # algorithms here and the check reads the same number every run
        def cpu_grads(cpu, x, draws, eot):  # on the worker, which owns cpu
            t = time.monotonic()
            want = class_grads(eot_wrap(cpu, eot), x, draws)
            cpu_s = {"float32": time.monotonic() - t}
            t = time.monotonic()
            want64 = class_grads(eot_wrap(cpu.double(), eot), x.double(),
                                 [d.double() for d in draws])
            cpu_s["float64"] = time.monotonic() - t
            return want, want64, cpu_s

        def against_float64(name, cpu, gpu, x, draws, eot):
            pending = on_cpu(cpu_grads, cpu, x, draws, eot)
            before = k2.launches
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=True, allow_tf32=False):
                got = class_grads(eot_wrap(gpu, eot), x.to(dev), draws).cpu()
            launched = k2.launches - before

            def check():
                want, want64, cpu_s = pending.result()
                gap = rel_err(want, want64)
                tol = max(PARITY_RTOL, GRAD_GAP_FACTOR * gap)
                err = rel_err(got, want64)
                if not math.isfinite(err) or err > tol:
                    raise RuntimeError(f"{name} input gradients, GPU float32 vs CPU float64: "
                                       f"{err} > {GRAD_GAP_FACTOR} x the CPU float32 one's {gap}")
                return {"classes": want.shape[0], "eot_steps": eot, "batch": x.shape[0],
                        "gpu_f32_vs_cpu_f64": err, "cpu_f32_vs_cpu_f64": gap, "tol": tol,
                        "gpu_vs_cpu_f32": rel_err(got, want), "k2_launches": launched,
                        "cpu_s": cpu_s}

            deferred[f"grad_{name}"] = check
            out[name] = {"k2_launches": launched, "checked_in": "cpu_refs"}

        # one image at EoT-2: the CPU's float32 and float64 references are
        # most of the phase, and the host's share of it varies most
        cpu, gpu, x, draws, eot, _ = small_gender(1, 2)
        against_float64("gender", cpu, gpu, x, draws, eot)
        # the small cars defense, the same way, at eps 0 (the shared encode:
        # the CPU's float64 encoder runs once per image at 192 x 256)
        cpu, gpu, x, draws, eot, _ = small_cars(0.0, 1, 2)
        against_float64("cars", cpu, gpu, x, draws, eot)
        del cpu, gpu
        torch.cuda.empty_cache()
        # one input gradient of the full flagship (batch 4, EoT-32): what the
        # attack slice will size itself by; only finiteness gates it
        defense = flagship(initial_noise_eps=2.0, device=dev, seed=0)
        net = eot_wrap(defense, eot_steps=EOT_STEPS)
        images = torch.rand(BATCH, 64, 64, 3, device=dev, generator=gen)
        cotangent = torch.randn(BATCH, 100, device=dev, generator=gen)

        def input_grad():
            draws = torch.Generator(device=dev).manual_seed(1)
            _, vjp_fn = vjp(lambda v: net(v, draws), images)
            return vjp_fn(cotangent)[0]

        input_grad()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = k1.launches
        times = []
        for _ in range(GRAD_CALLS):
            t = time.monotonic()
            grad = input_grad()
            torch.cuda.synchronize()
            times.append(time.monotonic() - t)
        if tuple(grad.shape) != (BATCH, 64, 64, 3) or not torch.isfinite(grad).all():
            raise RuntimeError(f"flagship input gradient: shape {tuple(grad.shape)}, "
                               f"finite {bool(torch.isfinite(grad).all())}")
        out["flagship"] = {"batch": BATCH, "eot_steps": EOT_STEPS, "initial_noise_eps": 2.0,
                           "call_s": times, "finite": True,
                           "k1_launches": k1.launches - before,
                           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30}
        if k1.launches == 0 or k2.launches == 0:
            raise RuntimeError(f"the gradient path launched K1 {k1.launches} and K2 "
                               f"{k2.launches} times")
        out["k1_launches"], out["k2_launches"] = k1.launches, k2.launches
        return out

    run_phase("grad", grad_phase)
    torch.cuda.empty_cache()

    from gen_adversarial_tpu_torch import attacks
    from gen_adversarial_tpu_torch.core.config import ATTACK_SUITES

    def attack_errors(got, want):
        """GPU result against the CPU's: the bounds' largest relative
        difference (inf where both failed), the adversarial images' largest
        absolute one."""
        gs, gb, ga = (t.cpu() for t in got[:3])
        ws, wb, wa = want[:3]
        if not torch.equal(gs, ws) or not torch.equal(torch.isinf(gb), torch.isinf(wb)):
            raise RuntimeError(f"GPU and CPU attacks disagree on success {gs.tolist()} vs "
                               f"{ws.tolist()} or bounds {gb.tolist()} vs {wb.tolist()}")
        fin = torch.isfinite(wb)
        bound_err = ((gb[fin] - wb[fin]).abs() / wb[fin].abs().clamp(min=1.0)).max().item() \
            if fin.any() else 0.0
        return bound_err, (ga - wa).abs().max().item()

    def attacks_parity_phase():
        # every attack through the small ids defense over 100 classes (FAB's
        # class jacobian at the flagship's class count), its draws frozen:
        # every call replays the same recorded draws, so the GPU and the CPU
        # attack the same deterministic function; a few steps each. The
        # AutoAttack ensemble is these APGD and FAB runs at fixed lengths
        # (64 and 128 steps), merged: the CPU tests hold the merge, and the
        # end of this phase runs both ensembles on the card
        cpu, gpu, x, draws, eot, _ = small_ids(n_classes=100)
        nets = {d: (lambda v, _, net=eot_wrap(m, eot): net(v, draws))
                for d, m in (("cpu", cpu), ("gpu", gpu))}
        with torch.no_grad():
            labels = nets["cpu"](x, None).argmax(1)
        start = torch.randn(x.shape, generator=torch.Generator().manual_seed(8))
        s = ATTACK_SUITES["ids"]
        runs = {
            "fgsm": lambda net, v, y, g: attacks.fgsm_attack(net, v, y, g, 1.0),
            "deepfool": lambda net, v, y, g: attacks.deepfool_attack(
                net, v, y, g, num_classes=s.deepfool_num_classes,
                overshoot=s.deepfool_overshoot, max_iter=3),
            "cw": lambda net, v, y, g: attacks.cw_attack(
                net, v, y, [start], c=s.cw_c, kappa=s.cw_kappa, steps=4, lr=s.cw_lr,
                early_stopping_steps=s.cw_early_stopping_steps),
            "apgd_ce": lambda net, v, y, g: attacks.apgd_attack(net, v, y, [start], 4, 0.75,
                                                                4.0, True),
            "apgd_dlr": lambda net, v, y, g: attacks.apgd_attack(net, v, y, [start], 4, 0.75,
                                                                 4.0, False),
            "fab": lambda net, v, y, g: attacks.fab_attack(net, v, y, g, n_iter=1),
        }
        def cpu_runs():  # on the worker
            done = {}
            for name, run in runs.items():
                t = time.monotonic()
                done[name] = (run(nets["cpu"], x, labels, torch.Generator()),
                              time.monotonic() - t)
            return done

        pending = on_cpu(cpu_runs)
        reset_counts()  # counts from here on are this phase's
        out = {"classes": 100, "eot_steps": eot, "batch": x.shape[0], "checked_in": "cpu_refs"}
        got = {}
        for name, run in runs.items():
            before = k1.launches
            t = time.monotonic()
            got[name] = run(nets["gpu"], x.to(dev), labels.to(dev), torch.Generator(device=dev))
            torch.cuda.synchronize()
            out[name] = {"k1_launches": k1.launches - before, "gpu_s": time.monotonic() - t}

        def check():
            res = {"tol": ATTACK_TOL}
            for name, (want, cpu_s) in pending.result().items():
                bound_err, adv_err = attack_errors(got[name], want)
                if bound_err > ATTACK_TOL or adv_err > ATTACK_TOL:
                    raise RuntimeError(f"{name}, GPU vs CPU: bounds {bound_err}, adversarial "
                                       f"images {adv_err} > {ATTACK_TOL}")
                res[name] = {"success": want[0].tolist(), "bound_rel_err": bound_err,
                             "adv_abs_err": adv_err, "cpu_s": cpu_s}
            return res

        deferred["attacks_parity"] = check
        if k1.launches == 0:
            raise RuntimeError("the GPU attacks did not go through K1")
        out["k1_launches"] = k1.launches
        # AutoAttack on the card: the staged ensemble, which skips stages
        # whose samples are all solved, against the monolithic one on a
        # linear net of a noisy input with a CUDA generator (every stage
        # draws from a generator of its own, split from the attack's)
        w = torch.randn(4 * 4 * 3, 5, device=dev, generator=gen)
        noisy = lambda v, d: (v + 0.01 * d.normal(v.shape, v)).reshape(v.shape[0], -1) @ w
        v = torch.rand(4, 4, 4, 3, device=dev, generator=gen)
        y = (v.reshape(4, -1) @ w).argmax(1)
        t = time.monotonic()
        mono = attacks.autoattack(noisy, v, y, torch.Generator(device=dev).manual_seed(12),
                                  n_classes=5)
        staged = attacks.make_staged_autoattack(5)(noisy, v, y,
                                                   torch.Generator(device=dev).manual_seed(12))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(mono, staged)):
            raise RuntimeError("the staged AutoAttack differs from the monolithic one on the card")
        out["autoattack_staged_vs_monolithic"] = {"equal": True, "success": mono[0].tolist(),
                                                  "seconds": time.monotonic() - t}
        return out

    attack_parity = run_phase("attacks_parity", attacks_parity_phase)

    def bf16_refs():
        """Phase bf16_parity's CPU side, on the worker: each small defense in
        float32 and a bfloat16 cast copy of it, their outputs, and the small
        ids defense's class gradients in both."""
        from gen_adversarial_tpu_torch.core.precision import defense_astype
        made = {}
        for name, make in (
                ("ids", lambda: small_ids(eot=2, on_card=False)),
                ("gender", lambda: small_gender(on_card=False)),
                ("cars", lambda: small_cars(cars.INITIAL_NOISE_EPS, 2, 2, on_card=False))):
            cpu, _, x, draws, eot, _ = make()
            cpu16 = defense_astype(copy.deepcopy(cpu))
            with torch.no_grad():
                made[name] = (cpu, cpu16, x, draws, eot, eot_wrap(cpu, eot)(x, draws),
                              eot_wrap(cpu16, eot)(x, draws))
        cpu, cpu16, x, draws, eot = made["ids"][:5]
        made["ids_class_grads"] = (class_grads(eot_wrap(cpu, eot), x, draws),
                                   class_grads(eot_wrap(cpu16, eot), x, draws))
        return made

    bf16_cpu = on_cpu(bf16_refs)
    torch.cuda.empty_cache()

    def timed(fn):
        """fn() with its seconds and peak memory, from a synchronized start."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.monotonic()
        result = fn()
        torch.cuda.synchronize()
        return result, time.monotonic() - t, torch.cuda.max_memory_allocated() / 2**30

    def check_attack(name, res, batch):
        success, bound, adv = res[:3]
        # DeepFool's bound is inf for a sample it did not move across (the
        # reference's marker); every other bound is finite
        bad = torch.isnan(bound) | (torch.isinf(bound) & success)
        if tuple(adv.shape[:1]) != (batch,) or bad.any() or not torch.isfinite(adv).all():
            raise RuntimeError(f"{name}: success {success.tolist()}, bounds {bound.tolist()}, "
                               f"adversarial images finite {bool(torch.isfinite(adv).all())}")
        # JSON has no inf: null stands for it
        return {"success": success.tolist(),
                "bounds": [b if math.isfinite(b) else None for b in bound.tolist()]}

    def attack_flagship_phase():
        # the full ids flagship (EoT-32, batch 4) under the ids suite's
        # DeepFool (8 classes, max_iter cut to FLAGSHIP_DF_ITERS) and APGD-CE at
        # AutoAttack's first bound for ATTACK_APGD_ITERS steps
        defense = flagship(initial_noise_eps=2.0, device=dev, seed=0)
        net = eot_wrap(defense, eot_steps=EOT_STEPS)
        images = torch.rand(ATTACK_BATCH, 64, 64, 3, device=dev, generator=gen)
        with torch.no_grad():
            labels = net(images, torch.Generator(device=dev).manual_seed(6)).argmax(1)
        s = ATTACK_SUITES["ids"]
        out = {"batch": ATTACK_BATCH, "eot_steps": EOT_STEPS, "initial_noise_eps": 2.0}
        reset_counts()  # counts from here on are this path's
        res, sec, peak = timed(lambda: attacks.deepfool_attack(
            net, images, labels, torch.Generator(device=dev).manual_seed(7),
            num_classes=s.deepfool_num_classes, overshoot=s.deepfool_overshoot,
            max_iter=FLAGSHIP_DF_ITERS, return_iters=True, cotangent_chunk=ATTACK_COT_CHUNK))
        out["deepfool"] = {**check_attack("deepfool", res, ATTACK_BATCH),
                           "classes": s.deepfool_num_classes, "iters": res[3],
                           "cotangent_chunk": ATTACK_COT_CHUNK, "seconds": sec,
                           "s_per_iter": sec / max(res[3], 1), "max_memory_allocated_gb": peak,
                           "k1_launches": k1.launches}
        before = k1.launches
        res, sec, peak = timed(lambda: attacks.apgd_attack(
            net, images, labels, torch.Generator(device=dev).manual_seed(8),
            ATTACK_APGD_ITERS, 0.75, 0.5, True))
        out["apgd_ce"] = {**check_attack("apgd_ce", res, ATTACK_BATCH), "iters": ATTACK_APGD_ITERS,
                          "max_bound": 0.5, "seconds": sec,
                          "s_per_iter": sec / (ATTACK_APGD_ITERS + 1),
                          "max_memory_allocated_gb": peak, "k1_launches": k1.launches - before}
        if k1.launches == 0 or out["apgd_ce"]["k1_launches"] == 0:
            raise RuntimeError(f"the flagship attacks launched K1 {k1.launches} times")
        out["k1_launches"], out["k2_launches"] = k1.launches, k2.launches
        return out

    attack_flag = run_phase("attack_flagship", attack_flagship_phase)
    torch.cuda.empty_cache()

    def attack_remat_phase():
        # remat on, as the gender and cars factories set it: APGD-CE on the
        # full gender defense (batch REMAT_GENDER_BATCH, EoT-32 in chunks of
        # REMAT_EOT_CHUNK), then one input gradient of the full cars defense
        # (batch REMAT_CARS_BATCH, EoT-32)
        out = {"eot_steps": EOT_STEPS, "eot_chunk": REMAT_EOT_CHUNK}
        # first, remat on the card: the small gender defense's class
        # gradients with remat on and off, from a CUDA generator seeded alike
        _, small, x, _, eot, _ = small_gender()
        grads = {}
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            for remat in (False, True):
                small.remat = remat
                grads[remat] = attacks.class_grads(
                    eot_wrap(small, eot), x.to(dev), torch.Generator(device=dev).manual_seed(11))[1]
        err = rel_err(grads[True], grads[False])
        if not math.isfinite(err) or err > REMAT_RTOL:
            raise RuntimeError(f"small gender class gradients, remat on vs off: {err} > {REMAT_RTOL}")
        out["small_gender_remat_vs_plain"] = {"rel_err": err, "tol": REMAT_RTOL}
        del small, grads

        defense = gender_defense(device=dev, seed=0)
        if not defense.remat:
            raise RuntimeError("the gender factory left remat off")
        net = eot_wrap(defense, eot_steps=EOT_STEPS, chunk=REMAT_EOT_CHUNK)
        images = torch.rand(REMAT_GENDER_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3, device=dev,
                            generator=gen)
        labels = torch.arange(REMAT_GENDER_BATCH, device=dev) % 2
        reset_counts()  # counts from here on are this path's
        res, sec, peak = timed(lambda: attacks.apgd_attack(
            net, images, labels, torch.Generator(device=dev).manual_seed(9),
            REMAT_APGD_ITERS, 0.75, 0.5, True))
        out["gender_apgd_ce"] = {
            **check_attack("gender apgd_ce", res, REMAT_GENDER_BATCH),
            "batch": REMAT_GENDER_BATCH,
            "iters": REMAT_APGD_ITERS, "max_bound": 0.5, "seconds": sec,
            "s_per_gradient": sec / (REMAT_APGD_ITERS + 1), "max_memory_allocated_gb": peak,
            "k2_launches": k2.launches, "k1_launches": k1.launches}
        if k2.launches == 0:
            raise RuntimeError("the gender attack did not go through K2")
        del res
        # one CE input gradient (what an APGD-CE step takes) under each
        # remat_policy, its seconds and peak beside policy None's
        by_policy, grads = {}, {}
        net = eot_wrap(defense, eot_steps=REMAT_POLICY_EOT, chunk=REMAT_EOT_CHUNK)
        for policy in (None, *REMAT_POLICIES):
            defense.remat_policy = policy

            def ce_grad():
                x = images.clone().requires_grad_(True)
                logits = net(x, torch.Generator(device=dev).manual_seed(9))
                return torch.autograd.grad(F.cross_entropy(logits, labels), x)[0]

            before = k2.launches
            grads[policy], sec, peak = timed(ce_grad)
            by_policy[str(policy)] = {"seconds": sec, "max_memory_allocated_gb": peak,
                                      "k2_launches": k2.launches - before}
            if policy is not None:
                err = rel_err(grads[policy], grads[None])
                by_policy[str(policy)]["rel_err_vs_none"] = err
                if not math.isfinite(err) or err > POLICY_RTOL:
                    raise RuntimeError(f"gender CE gradient under {policy}: {err} from policy "
                                       f"None's > {POLICY_RTOL}")
        defense.remat_policy = None
        out["gender_ce_grad_by_policy"] = {"batch": REMAT_GENDER_BATCH,
                                           "eot_steps": REMAT_POLICY_EOT, **by_policy}
        del defense, net, grads
        torch.cuda.empty_cache()

        defense = cars.cars_defense(device=dev, seed=0)
        net = eot_wrap(defense, eot_steps=EOT_STEPS, chunk=REMAT_EOT_CHUNK)
        images = torch.rand(REMAT_CARS_BATCH, cars.IMAGE_SIZE, cars.IMAGE_SIZE, 3, device=dev,
                            generator=gen)
        cotangent = torch.randn(REMAT_CARS_BATCH, cars.N_CLASSES, device=dev, generator=gen)

        def input_grad():
            x = images.clone().requires_grad_(True)
            logits = net(x, torch.Generator(device=dev).manual_seed(10))
            return torch.autograd.grad(logits, x, cotangent)[0]

        reset_counts()  # counts from here on are this path's
        grad, sec, peak = timed(input_grad)
        if tuple(grad.shape) != tuple(images.shape) or not torch.isfinite(grad).all() \
                or k2.launches == 0:
            raise RuntimeError(f"cars input gradient: shape {tuple(grad.shape)}, finite "
                               f"{bool(torch.isfinite(grad).all())}, K2 {k2.launches} launches")
        out["cars_input_grad"] = {"batch": REMAT_CARS_BATCH, "remat": defense.remat,
                                  "seconds": sec,
                                  "max_memory_allocated_gb": peak, "finite": True,
                                  "k2_launches": k2.launches, "k1_launches": k1.launches}
        return out

    from gen_adversarial_tpu_torch.defenses.base import REMAT_POLICIES

    attack_rm = run_phase("attack_remat", attack_remat_phase)
    torch.cuda.empty_cache()

    def cpu_refs_phase():
        # the worker's references (see on_cpu): wait for all, then the checks
        # of phases grad and attacks_parity against them
        t = time.monotonic()
        wait(submitted)
        out = {"waited_s": time.monotonic() - t, "jobs": len(submitted)}
        for name, check in deferred.items():
            out[name] = check()
        return out

    run_phase("cpu_refs", cpu_refs_phase)

    # ---- bfloat16 (core/precision.defense_astype): the kernels' bfloat16
    # builds, the three full-width forwards, small defenses against the CPU's
    # float32, and the attacks' gradients
    bf16 = torch.bfloat16
    from torch.profiler import ProfilerActivity, profile
    from gen_adversarial_tpu_torch.core.precision import BF16_GAP_FACTOR, defense_astype
    from gen_adversarial_tpu_torch.profile_flagship import kernel_times, kind_of

    def check_bf16(name, got, want, tol):
        """A bfloat16 kernel against its bfloat16 plain version: both sum in
        float32 and round once, so within one bfloat16 spacing of the plain
        value (rtol 2**-7) beside the float32 kernel's absolute tolerance.
        Returns (max abs err, max ulps: |got - want| in units of want's
        bfloat16 spacing, 2**-7 of its binade, where |want| is at least the
        absolute part of the bound; that absolute part). Eight images at a
        time: the 1024-px site is 4.3 GB in bfloat16."""
        scale = max(1.0, want.abs().max().float().item())
        bad, err, ulps = 0, 0.0, 0.0
        for g, w in zip(got.split(8), want.split(8)):
            w = w.float()
            d = (g.float() - w).abs()
            w = w.abs()
            bad += (d > BF16_KERNEL_RTOL * w + tol * scale).sum().item()
            err = max(err, d.max().item())
            spacing = torch.exp2(torch.floor(torch.log2(w.clamp(min=tol * scale))) - 7)
            ulps = max(ulps, (d / spacing).max().item())
        if bad or not math.isfinite(err):
            raise RuntimeError(f"{name} (bfloat16) disagrees with its plain version at {bad} "
                               f"elements: max abs err {err}, {ulps} ulps")
        return err, ulps, tol * scale

    def k1_bf16_rows():
        """K1's bfloat16 build at the flagship's shapes, with the float32
        taps and affines the decoder cells hand it (bfloat16 weights widened
        once: ResidualCellDecoder.segment_args), against its plain version;
        also timed with the bfloat16 weights themselves, which the wrapper
        widens at every launch."""
        rows = []
        for (c, h), per_decode in shape_counts.items():
            x = torch.randn(n, c, h, h, device=dev, generator=gen).to(bf16).contiguous(
                memory_format=torch.channels_last)
            wk16 = (torch.randn(5, 5, c, device=dev, generator=gen) * 0.2).to(bf16)
            aff16 = [(torch.randn(c, device=dev, generator=gen) * 0.5 + 1).to(bf16)
                     for _ in range(4)]
            wk, aff = wk16.float(), [a.float() for a in aff16]
            y = k1.depthwise_silu_segment(x, wk, *aff)
            torch.cuda.synchronize()
            err, ulps, tol = check_bf16(f"K1 at C={c} H={h}", y,
                                        k1.depthwise_silu_segment_plain(x, wk, *aff), K1_TOL)
            w = k1.taps_oihw(wk16).contiguous()
            ms = cuda_ms(torch, lambda: k1.depthwise_silu_segment(x, wk, *aff))
            ms_bf16_weights = cuda_ms(torch, lambda: k1.depthwise_silu_segment(x, wk16, *aff16))
            plain_ms = cuda_ms(torch, lambda: k1.depthwise_silu_segment_plain(x, wk, *aff),
                               BF16_SLOW_REPS, warmup=0)
            library_ms = cuda_ms(torch, lambda: F.conv2d(x, w, padding=2, groups=c),
                                 LIBRARY_REPS, LIBRARY_WARMUP)
            elements = x.numel()
            # bfloat16 x and y, float32 taps and affines; float32 arithmetic
            bytes_moved = 2 * elements * 2 + (25 + 4) * c * 4
            byte_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
            op_ms = 1e3 * elements * K1_FLOP_PER_ELEMENT / F32_FLOP_PER_S
            rows.append({"C": c, "H": h, "N": n, "per_decode": per_decode,
                         "max_abs_err": err, "max_ulps": ulps, "tol": tol,
                         "kernel_ms": ms, "kernel_ms_bf16_weights": ms_bf16_weights,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "bound_ms": max(byte_ms, op_ms),
                         "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                         "roofline_share": max(byte_ms, op_ms) / ms})
            del x, y
        return rows

    def k2_bf16_rows(sites, n_images):
        """K2's bfloat16 build at each (C, H_in) of `sites` on a batch of
        n_images: bit-identical to its plain version (both sum in float32 in
        the same order and round once), timed with the plain version at
        BF16_SLOW_REPS launches and the library call at LIBRARY_REPS."""
        kf = torch.tensor(taps[::-1], device=dev)
        rows = []
        for c, h in sites:
            x = torch.randn(n_images, c, h, h, device=dev, generator=gen).to(bf16).contiguous(
                memory_format=torch.channels_last)
            y = k2.upfirdn_blur(x, taps, BLUR_PAD)
            torch.cuda.synchronize()
            plain = k2.blur_plain(x, taps, BLUR_PAD)
            mismatched = (y != plain).sum().item()
            err = (y.float() - plain.float()).abs().max().item()
            del plain
            if mismatched:
                raise RuntimeError(f"K2 (bfloat16) at C={c} H={h} is not bit-identical to its "
                                   f"plain version at {mismatched} elements (max abs err {err})")
            w2d = torch.outer(kf, kf).to(bf16).expand(c, 1, len(taps), len(taps)).contiguous()
            ms = cuda_ms(torch, lambda: k2.upfirdn_blur(x, taps, BLUR_PAD))
            plain_ms = cuda_ms(torch, lambda: k2.blur_plain(x, taps, BLUR_PAD), BF16_SLOW_REPS,
                               warmup=0)
            library_ms = cuda_ms(torch, lambda: F.conv2d(x, w2d, padding=1, groups=c),
                                 LIBRARY_REPS, LIBRARY_WARMUP)
            byte_ms = 1e3 * (x.numel() + y.numel()) * 2 / HBM_BYTES_PER_S
            op_ms = 1e3 * y.numel() * K2_FLOP_PER_OUTPUT / F32_FLOP_PER_S
            rows.append({"C": c, "H_in": h, "H_out": y.shape[2], "N": n_images,
                         "per_decode": 1, "max_abs_err": err, "mismatched": mismatched,
                         "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                         "bound_ms": max(byte_ms, op_ms),
                         "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                         "roofline_share": max(byte_ms, op_ms) / ms})
            del x, y
            torch.cuda.empty_cache()
        return rows

    def ragged_bf16():
        """The bfloat16 builds off the main paths' shapes: K2 at widths that
        are not multiples of 8 (its masked scalar path) or of 32, pads (2, 2)
        and negative pads, 3 taps and 8-px maps, bit-identical; K1 at widths
        that are multiples of 8 but not of 32 and partial tiles, within one
        ulp; each also under torch.func.vmap, whose rule folds the vmapped
        dim into N (one launch)."""
        asym, three = (0.1, 0.2, 0.3, 0.4), (1 / 7, 2 / 7, 4 / 7)
        cases = []
        for shape, kt, pad in [((2, 3, 9, 9), asym, (1, 1)), ((1, 13, 20, 37), asym, (2, 2)),
                               ((2, 45, 33, 31), three, (1, 1)), ((2, 40, 8, 8), asym, (2, 2)),
                               ((1, 72, 31, 70), asym, (-1, 2)), ((3, 24, 17, 17), three, (0, -1))]:
            x = torch.randn(*shape, device=dev, generator=gen).to(bf16).contiguous(
                memory_format=torch.channels_last)
            if not torch.equal(k2.upfirdn_blur(x, kt, pad), k2.blur_plain(x, kt, pad)):
                raise RuntimeError(f"K2 (bfloat16) at {shape}, pad {pad}: not bit-identical")
            cases.append({"kernel": "K2", "shape": list(shape), "taps": len(kt), "pad": list(pad)})
        for shape in [(1, 40, 13, 5), (3, 48, 17, 33), (2, 72, 8, 8), (1, 200, 37, 21)]:
            c = shape[1]
            x = torch.randn(*shape, device=dev, generator=gen).to(bf16).contiguous(
                memory_format=torch.channels_last)
            wk = torch.randn(5, 5, c, device=dev, generator=gen) * 0.2
            aff = [torch.randn(c, device=dev, generator=gen) * 0.5 + 1 for _ in range(4)]
            check_bf16(f"K1 at {shape}", k1.depthwise_silu_segment(x, wk, *aff),
                       k1.depthwise_silu_segment_plain(x, wk, *aff), K1_TOL)
            cases.append({"kernel": "K1", "shape": list(shape)})
        xs = torch.randn(3, 2, 40, 17, 17, device=dev, generator=gen).to(bf16)
        before = k2.launches
        got = vmap(lambda v: k2.upfirdn_blur(v, asym, (1, 1)))(xs)
        if k2.launches != before + 1 or not torch.equal(
                got, torch.stack([k2.blur_plain(v, asym, (1, 1)) for v in xs])):
            raise RuntimeError("K2 (bfloat16) under vmap: not one launch, or not bit-identical")
        wk = torch.randn(5, 5, 40, device=dev, generator=gen) * 0.2
        aff = [torch.randn(40, device=dev, generator=gen) * 0.5 + 1 for _ in range(4)]
        before = k1.launches
        got = vmap(lambda v: k1.depthwise_silu_segment(v, wk, *aff))(xs)
        if k1.launches != before + 1:
            raise RuntimeError("K1 (bfloat16) under vmap: not one launch")
        check_bf16("K1 under vmap", got, torch.stack(
            [k1.depthwise_silu_segment_plain(v, wk, *aff) for v in xs]), K1_TOL)
        cases.append({"kernel": "K1 and K2 under vmap", "shape": list(xs.shape)})
        return cases

    def kernels_bf16_phase():
        return {"dtype": "bfloat16", "slow_reps": BF16_SLOW_REPS, "library_reps": LIBRARY_REPS,
                "k1": {"kernel": "depthwise_silu_segment", "shapes": k1_bf16_rows()},
                "k2": {"kernel": "upfirdn_blur", "taps": list(taps), "pad": list(BLUR_PAD),
                       "shapes": k2_bf16_rows(k2_sites, n_gender),
                       "cars_shapes": k2_bf16_rows(k2_cars_sites, n_cars)},
                "ragged": ragged_bf16()}

    kernels16 = run_phase("kernels_bf16", kernels_bf16_phase)

    def host_launch_us(reps=2000):
        """The host's cost of one launch: µs a launch of a one-element add,
        `reps` of them, then a synchronize. The device does almost nothing,
        so this is the host's speed at dispatching, in this run."""
        t = torch.zeros(1, device=dev)
        torch.cuda.synchronize()
        start = time.monotonic()
        for _ in range(reps):
            t.add_(1)
        torch.cuda.synchronize()
        return 1e6 * (time.monotonic() - start) / reps

    def timed_and_traced(call, wall_s):
        """One traced call, ending in a synchronize, beside wall_s, the host
        seconds of an untraced call of the same work: its summed device
        kernel seconds, their ratio (the busy share; kernels that overlap can
        take it above 1) and the kernel seconds by kind. The trace records the
        device's activity only: recording every host op as well cost the
        phase several seconds of host time."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels_ = kernel_times(prof, torch)
        by_kind = {}
        for kname, (us, _) in kernels_.items():
            by_kind[kind_of(kname)] = by_kind.get(kind_of(kname), 0.0) + us / 1e6
        device_s = sum(by_kind.values())
        if not kernels_:
            return {"wall_s": wall_s, "device_kernel_s": "not measured",
                    "busy_share": "not measured"}
        return {"wall_s": wall_s, "device_kernel_s": device_s,
                "busy_share": device_s / wall_s, "by_kind_s": by_kind}

    def bf16_forward(name, make, batch, size, classes, seed, wall32):
        """One full-width defense: a float32 call, then the same weights cast
        by defense_astype and the same draws' seed in bfloat16: one warm-up
        call (compared with the float32 one), then the timed calls. In each
        dtype one traced call gives the device's busy share in this run,
        against the last timed call (in float32 wall32, the path's float32
        phase's), and the host's launch cost is taken before the
        timed calls: the bfloat16 flagship's device idles most of its call,
        and its rate varies from run to run."""
        t = time.monotonic()
        defense = make()
        torch.cuda.synchronize()
        build_s = time.monotonic() - t
        net = eot_wrap(defense, eot_steps=EOT_STEPS)
        images = torch.rand(batch, size, size, 3, device=dev, generator=gen)
        with torch.no_grad():
            ref = net(images, torch.Generator(device=dev).manual_seed(seed))
            draws32 = torch.Generator(device=dev).manual_seed(seed)
            busy32 = timed_and_traced(lambda: net(images, draws32), wall32)
            defense_astype(defense)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()  # counts from here on are this path's, in bfloat16
            draws = torch.Generator(device=dev).manual_seed(seed)
            times, calls = [], []
            launch_us = host_launch_us()
            for _ in range(1 + TIMED_CALLS):  # one warm-up, then the timed calls
                t = time.monotonic()
                calls.append(net(images, draws))
                torch.cuda.synchronize()
                times.append(time.monotonic() - t)
            launched = {dtype: (k1.launches_by_dtype[dtype], k2.launches_by_dtype[dtype])
                        for dtype in (bf16, torch.float32)}
            busy16 = timed_and_traced(lambda: net(images, draws), times[-1])
        first, logits = calls[0], calls[-1]
        if logits.dtype != torch.float32 or tuple(logits.shape) != (batch, classes) \
                or not torch.isfinite(logits).all():
            raise RuntimeError(f"{name} bfloat16 logits: {logits.dtype} "
                               f"{tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
        spread = ref.std().item()
        delta = (first - ref).abs().mean().item()
        if not math.isfinite(delta):
            raise RuntimeError(f"{name}: the bfloat16 logits' distance from float32 is {delta}")
        return {"batch": batch, "eot_steps": EOT_STEPS, "dtype": "bfloat16",
                "initial_noise_eps": defense.initial_noise_eps, "weights_build_s": build_s,
                "compute_dtype": str(defense.compute_dtype), "finite": True,
                "argmax_agreement_vs_f32":
                    (first.argmax(1) == ref.argmax(1)).float().mean().item(),
                "mean_abs_dlogit_over_std_vs_f32": delta / spread,
                "k1_launches": launched[bf16][0], "k2_launches": launched[bf16][1],
                "f32_launches": sum(launched[torch.float32]),
                "call_s": times, "images_per_s": batch * TIMED_CALLS / sum(times[1:]),
                "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
                "host_launch_us": launch_us, "busy_bf16": busy16, "busy_f32": busy32}

    def bf16_phase():
        out = {}
        # each path's float32 phase timed an untraced call of the same work
        for name, make, batch, size, classes, seed, kernel, wall32 in (
                ("flagship", lambda: flagship(initial_noise_eps=2.0, device=dev, seed=0),
                 BATCH, 64, 100, 1, "k1", flag["call_s"][-1]),
                ("gender", lambda: gender_defense(device=dev, seed=0), GENDER_BATCH,
                 IMAGE_SIZE, 2, 2, "k2", gender["call_s"][-1]),
                ("cars", lambda: cars.cars_defense(device=dev, seed=0), CARS_BATCH,
                 cars.IMAGE_SIZE, cars.N_CLASSES, 5, "k2", cars_run["call_s"][-1])):
            out[name] = bf16_forward(name, make, batch, size, classes, seed, wall32)
            if out[name][f"{kernel}_launches"] == 0 or out[name]["f32_launches"]:
                raise RuntimeError(f"{name} in bfloat16: {out[name]}: its kernel's bfloat16 "
                                   "build was not launched, or a float32 one was")
            torch.cuda.empty_cache()
        return out

    run16 = run_phase("bf16", bf16_phase)
    # the conversion's check (it reads both files and compares their 2.75 GB
    # of leaves) on the worker, while the card runs the next phases; phase
    # harness takes its result
    shared["conversion"] = cpu_worker.submit(shared["conversion"])

    def rel_l2(got, want):
        return ((got.double() - want.double()).norm() / want.double().norm()).item()

    def bf16_parity_phase():
        # each small defense in float32 on the CPU, and cast copies of it:
        # bfloat16 on the CPU (the gap bfloat16 itself opens) and on the GPU,
        # which may be at most BF16_GAP_FACTOR x as far from the CPU's float32
        out, ids = {}, None

        def gate(name, want, cpu16, gpu16, **extra):
            gap, err = rel_l2(cpu16, want), rel_l2(gpu16, want)
            if not math.isfinite(err) or err > BF16_GAP_FACTOR * gap:
                raise RuntimeError(f"{name}, GPU bfloat16 vs CPU float32: {err} > "
                                   f"{BF16_GAP_FACTOR} x the CPU bfloat16's {gap}")
            out[name] = {"gpu_bf16_vs_cpu_f32": err, "cpu_bf16_vs_cpu_f32": gap,
                         "gpu_vs_cpu_bf16": rel_l2(gpu16, cpu16), "factor": BF16_GAP_FACTOR,
                         **extra}

        # the CPU's side came from the worker (bf16_refs)
        made = bf16_cpu.result()
        for name, launched in (("ids", lambda: k1.launches_by_dtype[bf16]),
                               ("gender", lambda: k2.launches_by_dtype[bf16]),
                               ("cars", lambda: k2.launches_by_dtype[bf16])):
            cpu, cpu16, x, draws, eot, want, got_cpu16 = made[name]
            gpu16 = defense_astype(copy.deepcopy(cpu).to(dev))
            with torch.no_grad():
                before = launched()
                got_gpu16 = eot_wrap(gpu16, eot)(x.to(dev), draws).cpu()
            if launched() == before:
                raise RuntimeError(f"the small {name} defense in bfloat16 launched no kernel")
            gate(name, want, got_cpu16, got_gpu16, eot_steps=eot, batch=x.shape[0],
                 launches=launched() - before)
            if name == "ids":
                ids = (cpu, cpu16, gpu16, x, draws, eot)
        # the small ids defense's class gradients (torch.func.vjp, vmap over
        # the one-hot cotangents), the same way
        cpu, cpu16, gpu16, x, draws, eot = ids
        want, got_cpu16 = made["ids_class_grads"]
        got_gpu16 = class_grads(eot_wrap(gpu16, eot), x.to(dev), draws).cpu()
        if got_gpu16.dtype != torch.float32:
            raise RuntimeError(f"bfloat16 class gradients came back as {got_gpu16.dtype}")
        gate("ids_class_grads", want, got_cpu16, got_gpu16, classes=want.shape[0])
        return out

    run_phase("bf16_parity", bf16_parity_phase)
    torch.cuda.empty_cache()

    def attack_bf16_phase():
        # APGD-CE through the bfloat16 flagship (as attack_flagship, in
        # bfloat16), then through the bfloat16 gender defense with remat and
        # EoT chunks of REMAT_EOT_CHUNK (as attack_remat)
        out = {"eot_steps": EOT_STEPS, "dtype": "bfloat16"}
        defense = defense_astype(flagship(initial_noise_eps=2.0, device=dev, seed=0))
        net = eot_wrap(defense, eot_steps=EOT_STEPS)
        images = torch.rand(ATTACK_BATCH, 64, 64, 3, device=dev, generator=gen)
        with torch.no_grad():
            labels = net(images, torch.Generator(device=dev).manual_seed(6)).argmax(1)
        reset_counts()  # counts from here on are this path's
        launch_us = host_launch_us()
        res, sec, peak = timed(lambda: attacks.apgd_attack(
            net, images, labels, torch.Generator(device=dev).manual_seed(8),
            ATTACK_APGD_ITERS, 0.75, 0.5, True))
        out["flagship_apgd_ce"] = {
            **check_attack("flagship bf16 apgd_ce", res, ATTACK_BATCH), "batch": ATTACK_BATCH,
            "iters": ATTACK_APGD_ITERS, "max_bound": 0.5, "seconds": sec,
            "s_per_gradient": sec / (ATTACK_APGD_ITERS + 1), "max_memory_allocated_gb": peak,
            "adv_dtype": str(res[2].dtype), "k1_launches": k1.launches_by_dtype[bf16],
            "host_launch_us": launch_us}
        if k1.launches_by_dtype[bf16] == 0 or res[2].dtype != torch.float32:
            raise RuntimeError(f"the bfloat16 flagship attack: {out['flagship_apgd_ce']}")
        del defense, net, res
        torch.cuda.empty_cache()

        defense = defense_astype(gender_defense(device=dev, seed=0))
        net = eot_wrap(defense, eot_steps=EOT_STEPS, chunk=REMAT_EOT_CHUNK)
        images = torch.rand(REMAT_GENDER_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3, device=dev,
                            generator=gen)
        labels = torch.arange(REMAT_GENDER_BATCH, device=dev) % 2
        reset_counts()  # counts from here on are this path's
        res, sec, peak = timed(lambda: attacks.apgd_attack(
            net, images, labels, torch.Generator(device=dev).manual_seed(9),
            REMAT_APGD_ITERS, 0.75, 0.5, True))
        out["gender_apgd_ce"] = {
            **check_attack("gender bf16 apgd_ce", res, REMAT_GENDER_BATCH),
            "batch": REMAT_GENDER_BATCH,
            "remat": defense.remat, "eot_chunk": REMAT_EOT_CHUNK, "iters": REMAT_APGD_ITERS,
            "max_bound": 0.5, "seconds": sec, "s_per_gradient": sec / (REMAT_APGD_ITERS + 1),
            "max_memory_allocated_gb": peak, "adv_dtype": str(res[2].dtype),
            "k2_launches": k2.launches_by_dtype[bf16]}
        if k2.launches_by_dtype[bf16] == 0 or res[2].dtype != torch.float32:
            raise RuntimeError(f"the bfloat16 gender attack: {out['gender_apgd_ce']}")
        return out

    attack16 = run_phase("attack_bf16", attack_bf16_phase)
    torch.cuda.empty_cache()

    def harness_phase():
        # the evaluation entry points on the float32 flagship, from files
        import importlib
        import importlib.util
        import re
        from functools import partial

        from gen_adversarial_tpu_torch.attacks.utils import class_block
        from gen_adversarial_tpu_torch.core.checkpoint import load_variables
        from gen_adversarial_tpu_torch.data import png
        from gen_adversarial_tpu_torch.eval.factory import default_eot_chunk, load_defense
        from gen_adversarial_tpu_torch.eval.harness import (
            ATTACK_JSON_NAMES, TITLE_STRIP, run_benchmark)

        out = {"nvidia_smi": device_info["nvidia_smi"], "batch": HARNESS_BATCH,
               "images": HARNESS_IMAGES, "eot_steps": EOT_STEPS}
        tmp = Path(scratch.name)
        built, right = shared["built"], shared["right"]
        # the converter processes started by harness_files have run meanwhile,
        # and the worker has checked their files
        t = time.monotonic()
        out["conversion"] = shared.pop("conversion").result()
        out["conversion_wait_s"] = time.monotonic() - t
        out["checkpoint_gb"] = sum((tmp / f).stat().st_size
                                   for f in ("nvae.msgpack", "vgg.msgpack")) / 1e9
        # read: every array of both files to the device
        t = time.monotonic()
        n_bytes = 0
        for f in ("nvae.msgpack", "vgg.msgpack"):
            leaves = [load_variables(tmp / f)[0]]
            while leaves:
                leaf = leaves.pop()
                if isinstance(leaf, dict):
                    leaves.extend(leaf.values())
                else:
                    n_bytes += torch.from_numpy(leaf).to(dev).numel() * leaf.itemsize
        torch.cuda.synchronize()
        out["checkpoint_read_s"] = time.monotonic() - t
        out["checkpoint_read_gb"] = n_bytes / 1e9

        text = (root / "configs" / "ours_linear_noise_ids.yaml").read_text()
        text = re.sub(r"^classifier_path: .*$", f"classifier_path: {tmp / 'vgg.msgpack'}",
                      text, flags=re.M)
        text = re.sub(r"^autoencoder_path: .*$", f"autoencoder_path: {tmp / 'nvae.msgpack'}",
                      text, flags=re.M)
        config = tmp / "ours_linear_noise_ids.yaml"
        config.write_text(text)

        t = time.monotonic()
        loaded = load_defense(str(config))
        torch.cuda.synchronize()
        out["load_defense_s"] = time.monotonic() - t
        images = torch.rand(BATCH, 64, 64, 3, device=dev, generator=gen)
        with torch.no_grad():
            want = eot_wrap(built, EOT_STEPS)(images, torch.Generator(device=dev).manual_seed(13))
            got = loaded.net(images, torch.Generator(device=dev).manual_seed(13))
        err = (got - want).abs().max().item()
        tol = PARITY_RTOL * max(1.0, want.abs().max().item())
        if not math.isfinite(err) or err > tol:
            raise RuntimeError(f"the loaded flagship's logits differ from the built one's: "
                               f"{err} > {tol}")
        out["loaded_vs_built"] = {"max_abs_err": err, "tol": tol}
        del want, got
        torch.cuda.empty_cache()

        seconds = {"deepfool": [], "c&w": []}

        def timed_attack(name, attack):
            def run_attack(*args):
                torch.cuda.synchronize()
                t = time.monotonic()
                res = attack(*args)
                torch.cuda.synchronize()
                seconds[name].append(time.monotonic() - t)
                return res
            return run_attack

        s = ATTACK_SUITES["ids"]
        loaded.attacks["deepfool"] = timed_attack("deepfool", partial(
            attacks.deepfool_attack, num_classes=s.deepfool_num_classes,
            overshoot=s.deepfool_overshoot, max_iter=ATTACK_DF_ITERS))
        # the blocks DeepFool's and FAB's class Jacobians take where none is
        # given (GAT_DF_COT_CHUNK and GAT_COT_CHUNK unset), read at their
        # class_grads calls
        blocks = {"deepfool": [], "fab": []}
        block_modules = {name: importlib.import_module(f"gen_adversarial_tpu_torch.attacks.{name}")
                         for name in blocks}
        real_class_grads = {name: m.class_grads for name, m in block_modules.items()}

        def block_recorder(name):
            def recorded(*args, **kw):
                blocks[name].append(kw.get("cotangent_chunk"))
                return real_class_grads[name](*args, **kw)
            return recorded

        for name, m in block_modules.items():
            m.class_grads = block_recorder(name)
        loaded.attacks["c&w"] = timed_attack("c&w", partial(
            attacks.cw_attack, c=s.cw_c, kappa=s.cw_kappa, steps=HARNESS_CW_STEPS,
            lr=s.cw_lr, n_restarts=1, early_stopping_steps=s.cw_early_stopping_steps))
        results_dir, logs = tmp / "results", []
        torch.cuda.reset_peak_memory_stats()
        reset_counts()  # counts from here on are this path's
        t = time.monotonic()
        for name in ("deepfool", "c&w"):
            results = run_benchmark(loaded, str(tmp / "images"), str(results_dir),
                                    batch_size=HARNESS_BATCH, seed=HARNESS_SEED,
                                    attack_filter=name, log_fn=logs.append)
        out["run_benchmark_s"] = time.monotonic() - t
        out["k1_launches"], out["k2_launches"] = k1.launches, k2.launches
        out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 2**30
        if k1.launches == 0:
            raise RuntimeError("the harness did not go through K1")
        written = json.loads((results_dir / "results.json").read_text())
        keys = [ATTACK_JSON_NAMES["deepfool"], ATTACK_JSON_NAMES["c&w"]]
        if written != results or sorted(written) != sorted(["Clean", *keys]):
            raise RuntimeError(f"results.json has keys {sorted(written)}")
        # the clean accuracy is the clean draw's; no class-1 logit comes
        # near the top, so DeepFool finds the 'b' images misclassified
        # already and reports 0; each attack moves an 'a' image that the
        # clean predictions got right to a finite minimal L2 (100.0 marks
        # no adversary; an 'a' image can also start misclassified under
        # the attack's own draws)
        if written["Clean"] != len(right) / HARNESS_IMAGES:
            raise RuntimeError(f"clean accuracy {written['Clean']}, but images {right} of "
                               f"{HARNESS_IMAGES} are classified right")
        beaten = {}
        for key in keys:
            values = written[key]
            beaten[key] = [i for i in right if 0.0 < values[i] < 100.0]
            if len(values) != HARNESS_IMAGES or not all(
                    math.isfinite(v) and 0.0 <= v <= 100.0 for v in values) \
                    or not beaten[key] or (key == ATTACK_JSON_NAMES["deepfool"] and any(
                        values[HARNESS_IMAGES // 2:])):
                raise RuntimeError(f"results.json {key}: {values} (images {right} "
                                   "classified right)")
        plots = {}
        for name in ("deepfool", "c&w"):
            for i in (0, 5):
                pixels = png.read_rgb(results_dir / "plots" / f"{name}_example={i}.png")
                title = pixels[:TITLE_STRIP]
                if pixels.shape != (TITLE_STRIP + 64 + 12, 3 * (64 + 12), 3) \
                        or title.max() == 0:
                    raise RuntimeError(f"plot {name} {i}: shape {pixels.shape}, title "
                                       f"drawn {bool(title.max())}")
                plots[f"{name}_example={i}"] = list(pixels.shape)
        out.update(results=written, classified_right=right, beaten=beaten, plots=plots,
                   attack_s_per_batch=seconds,
                   title_font="PIL ImageDraw" if importlib.util.find_spec("PIL")
                   else "bitmap",
                   progress_left=(results_dir / "progress_p0.json").exists(), log=logs)
        if out["progress_left"]:
            raise RuntimeError("the harness left its progress file")

        # the staged AutoAttack on the first batch, every stage at
        # HARNESS_AA_ITERS iterations (the ensemble's depths, lowered here
        # and restored), FAB over all 100 classes; its list joins the others
        # in results.json
        aa_module = importlib.import_module("gen_adversarial_tpu_torch.attacks.autoattack")
        depths = aa_module.APGD_ITERS, aa_module.FAB_ITERS
        aa_module.APGD_ITERS = aa_module.FAB_ITERS = HARNESS_AA_ITERS
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        try:
            t = time.monotonic()
            aa_results = run_benchmark(loaded, str(tmp / "images"), str(results_dir),
                                       batch_size=HARNESS_BATCH, seed=HARNESS_SEED,
                                       attack_filter="autoattack", max_images=HARNESS_BATCH,
                                       plots=False, log_fn=logs.append)
            torch.cuda.synchronize()
            aa_s = time.monotonic() - t
        finally:
            aa_module.APGD_ITERS, aa_module.FAB_ITERS = depths
            for name, m in block_modules.items():
                m.class_grads = real_class_grads[name]
        aa_json = ATTACK_JSON_NAMES["autoattack"]
        both = json.loads((results_dir / "results.json").read_text())
        values = both.get(aa_json, [])
        out["autoattack"] = {
            "s": aa_s, "iterations": HARNESS_AA_ITERS, "images": HARNESS_BATCH,
            "n_classes": loaded.n_classes,
            "fab_block": class_block(loaded.n_classes, HARNESS_BATCH),
            "values": values, "clean": aa_results["Clean"],
            "k1_launches": k1.launches, "k2_launches": k2.launches,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30}
        if sorted(both) != sorted(["Clean", *keys, aa_json]) or any(
                both[key] != written[key] for key in keys):
            raise RuntimeError(f"results.json after AutoAttack has keys {sorted(both)}")
        if len(values) != HARNESS_BATCH or not all(
                math.isfinite(v) and 0.0 <= v <= 100.0 for v in values):
            raise RuntimeError(f"results.json {aa_json}: {values}")
        if k1.launches == 0:
            raise RuntimeError("the harness's AutoAttack did not go through K1")
        # what the defaults gave at the harness's batch: the CLIs' EoT chunk
        # (none for ids) and the class blocks the attacks took
        out["defaults"] = {
            "cli_eot_chunk": default_eot_chunk("ids", "ours", HARNESS_BATCH, EOT_STEPS),
            "eot_chunk": loaded.eot_chunk,
            "deepfool_blocks": sorted(set(blocks["deepfool"]), key=str),
            "fab_blocks": sorted(set(blocks["fab"]), key=str)}
        want = {"deepfool": [class_block(s.deepfool_num_classes, HARNESS_BATCH)],
                "fab": [class_block(loaded.n_classes, HARNESS_BATCH)]}
        if any(out["defaults"][f"{name}_blocks"] != want[name] for name in want) \
                or loaded.eot_chunk != out["defaults"]["cli_eot_chunk"]:
            raise RuntimeError(f"the defaults gave {out['defaults']}, expected blocks {want}")
        if (results_dir / "progress_p0.json").exists():
            raise RuntimeError("the harness's AutoAttack left its progress file")
        shared.update(config=config, loaded=loaded, images=tmp / "images", built=built)
        return out

    def configs_phase():
        # six more configs from the harness's files: each copy loaded by
        # load_defense, its EoT forward held to the harness's built modules
        # under the config's settings on the same draws, with K1's launches;
        # each file is read once (the harness phase times a read)
        import re
        from functools import lru_cache

        import numpy as np
        from gen_adversarial_tpu_torch.core.config import DefenseConfig
        from gen_adversarial_tpu_torch.defenses.ablations import (
            GaussianBlurDefense, GaussianNoiseDefense)
        from gen_adversarial_tpu_torch.defenses.base import (
            ClassifierDefense, MLVGMDefense, make_classifier_apply)
        from gen_adversarial_tpu_torch.defenses.purify import make_nvae_purify_split
        from gen_adversarial_tpu_torch.eval import factory

        tmp = Path(scratch.name)
        built = shared.pop("built")
        nvae, vgg = built.purifier, built.classifier
        apply = make_classifier_apply(vgg)
        out = {"nvidia_smi": device_info["nvidia_smi"], "batch": CONFIGS_BATCH,
               "eot_steps": CONFIGS_EOT}
        images = torch.rand(CONFIGS_BATCH, 64, 64, 3, device=dev, generator=gen)
        read = factory.load_variables
        factory.load_variables = lru_cache(maxsize=None)(read)
        try:
            for name in PHASE_CONFIGS:
                text = (root / "configs" / f"{name}.yaml").read_text()
                text = re.sub(r"^classifier_path: .*$",
                              f"classifier_path: {tmp / 'vgg.msgpack'}", text, flags=re.M)
                text = re.sub(r"^autoencoder_path: .*$",
                              f"autoencoder_path: {tmp / 'nvae.msgpack'}", text, flags=re.M)
                config = tmp / "configs" / f"{name}.yaml"
                config.parent.mkdir(exist_ok=True)
                config.write_text(text)
                cfg = DefenseConfig.from_yaml(config)
                t = time.monotonic()
                loaded = factory.load_defense(str(config), eot_steps=CONFIGS_EOT)
                torch.cuda.synchronize()
                load_s = time.monotonic() - t
                if name.startswith("ours"):
                    alphas = torch.as_tensor(np.asarray(cfg.interpolation_alphas, np.float32)
                                             * np.float32(cfg.alpha_attenuation), device=dev)
                    encode, decode = make_nvae_purify_split(nvae, 0.6)
                    direct = MLVGMDefense(
                        purifier=nvae, classifier=vgg, alphas=alphas, purify_encode=encode,
                        purify_decode=decode, classifier_apply=apply,
                        initial_noise_eps=cfg.initial_noise_eps,
                        apply_blur=cfg.gaussian_blur_input, image_size=64)
                elif name.startswith("ablation_blur"):
                    direct = GaussianBlurDefense(vgg, apply, 64)
                elif name.startswith("ablation_noise"):
                    direct = GaussianNoiseDefense(vgg, apply, eps=2.0)
                else:  # no_defense, TRADES: the bare classifier, deterministic
                    direct = ClassifierDefense(vgg, apply)
                with torch.no_grad():
                    want = eot_wrap(direct, CONFIGS_EOT)(
                        images, torch.Generator(device=dev).manual_seed(17))
                    reset_counts()  # counts from here on are this config's path
                    got = loaded.net(images, torch.Generator(device=dev).manual_seed(17))
                    torch.cuda.synchronize()
                launches = k1.launches
                err = (got - want).abs().max().item()
                tol = PARITY_RTOL * max(1.0, want.abs().max().item())
                expected = 50 if name.startswith("ours") else 0  # one decode of the batch
                out[name] = {"load_defense_s": load_s, "defense_type": loaded.defense_type,
                             "eot_steps": loaded.eot_steps, "k1_launches": launches,
                             "k2_launches": k2.launches, "max_abs_err": err, "tol": tol}
                if not math.isfinite(err) or err > tol:
                    raise RuntimeError(f"{name}: the loaded defense's logits differ from the "
                                       f"directly built one's: {err} > {tol}")
                if launches != expected or k2.launches:
                    raise RuntimeError(f"{name}: K1 {launches} and K2 {k2.launches} launches "
                                       f"in one forward, expected {expected} and 0")
                if name == PHASE_CONFIGS[0]:
                    # one DeepFool step (the suite's 8 classes at once) on
                    # labels the attack's first draws predict, so it steps
                    with torch.no_grad():
                        labels = loaded.net(
                            images, torch.Generator(device=dev).manual_seed(5)).argmax(1)
                    torch.cuda.reset_peak_memory_stats()
                    reset_counts()
                    t = time.monotonic()
                    succ, bound, adv, steps = loaded.attacks["deepfool"](
                        loaded.net, images, labels, torch.Generator(device=dev).manual_seed(5),
                        max_iter=1, return_iters=True)
                    torch.cuda.synchronize()
                    out["deepfool_step"] = {
                        "config": name, "s": time.monotonic() - t, "steps": steps,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                        "k1_launches": k1.launches, "success": succ.tolist(),
                        "bound": [b if math.isfinite(b) else None for b in bound.tolist()]}
                    if steps != 1 or not torch.isfinite(adv).all() or not k1.launches:
                        raise RuntimeError(f"DeepFool step: {out['deepfool_step']}")
                del loaded, direct, want, got
        finally:
            factory.load_variables = read
        del built, nvae, vgg
        torch.cuda.empty_cache()
        return out

    def alpha_search_phase():
        # the alpha search (cli/alpha_search.py) on the harness's flagship
        # files: make-adv over its 6 PNGs, bo on the kept adversaries, and
        # in process the evaluator's positions and the GP on the card vs the
        # CPU
        import numpy as np
        from gen_adversarial_tpu_torch.cli import alpha_search
        from gen_adversarial_tpu_torch.data import png
        from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset
        from gen_adversarial_tpu_torch.eval import factory
        from gen_adversarial_tpu_torch.models.nvae.distributions import position_generator
        from gen_adversarial_tpu_torch.search import alphas, gp, grid

        tmp = Path(scratch.name)
        config, images_path = str(shared["config"]), shared["images"]
        out = {"nvidia_smi": device_info["nvidia_smi"], "eot_steps": EOT_STEPS}
        # host seconds of the calls the CLI makes, each ended by a synchronize
        seconds = {"load": [], "fgsm_batch": [], "evaluation": [], "fit_gp": [],
                   "optimize_acqf": []}
        patched = [(factory, "load_defense", "load"), (factory, "load_ours_for_search", "load"),
                   (grid, "fgsm_attack", "fgsm_batch"),
                   (alphas.AlphaEvaluator, "predictions", "evaluation"),
                   (gp, "fit_gp", "fit_gp"), (gp, "optimize_acqf", "optimize_acqf")]
        real = {}

        def timed(fn, bucket):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t = time.monotonic()
                result = fn(*args, **kwargs)
                torch.cuda.synchronize()
                seconds[bucket].append(time.monotonic() - t)
                return result
            return call

        for owner, name, bucket in patched:
            real[owner, name] = getattr(owner, name)
            setattr(owner, name, timed(real[owner, name], bucket))
        reset_counts()  # counts from here on are this path's
        try:
            adv_dir = tmp / "adv"
            t = time.monotonic()
            kept = alpha_search.main([
                "--mode", "make-adv", "--config", config, "--images-path", str(images_path),
                "--out-dir", str(adv_dir), "--n-samples", str(HARNESS_IMAGES),
                "--eot-steps", str(EOT_STEPS), "--batch-size", str(ALPHA_ADV_BATCH)])
            out["make_adv_s"] = time.monotonic() - t
            out["make_adv_k1_launches"] = k1.launches
            files = sorted(adv_dir.rglob("*.png"))
            kept_names = [f.relative_to(adv_dir).as_posix() for f in files]
            out["kept"] = kept_names
            if kept < 1 or kept != len(files):
                raise RuntimeError(f"make-adv kept {kept} adversaries ({kept_names}): FGSM at "
                                   f"L2 {alpha_search.FGSM_BOUND['ids']} moved no image "
                                   "classified right")
            limit = alpha_search.FGSM_BOUND["ids"] + math.sqrt(64 * 64 * 3) / 255
            distances = {}
            for f, name in zip(files, kept_names):
                source = images_path / name
                adv = png.read_rgb(f)
                if adv.shape != (64, 64, 3) or not source.exists():
                    raise RuntimeError(f"kept {name}: shape {adv.shape}, source there "
                                       f"{source.exists()}")
                distances[name] = float(np.sqrt(np.sum(
                    (adv / 255.0 - png.read_rgb(source) / 255.0) ** 2)))
                if not distances[name] <= limit:
                    raise RuntimeError(f"kept {name} lies at L2 {distances[name]} > {limit} "
                                       "from its source")
            out["l2_from_source"] = distances

            bo_dir = tmp / "bo"
            t = time.monotonic()
            before = k1.launches
            xs, accs = alpha_search.main([
                "--mode", "bo", "--config", config, "--adv-images-path", str(adv_dir),
                "--n-steps", str(ALPHA_BO_STEPS), "--eot-steps", str(EOT_STEPS),
                "--batch-size", str(ALPHA_ADV_BATCH), "--results-folder", str(bo_dir)])
            out["bo_s"] = time.monotonic() - t
            out["bo_k1_launches"] = k1.launches - before
            saved_x, saved_acc = np.load(bo_dir / "alphas.npy"), np.load(bo_dir / "accuracies.npy")
            rows = 5 + ALPHA_BO_STEPS
            if saved_x.shape != (rows, 24) or not np.all((saved_x >= 0) & (saved_x <= 1)) \
                    or saved_acc.shape != (rows, 1) \
                    or not np.allclose(saved_acc * kept, np.round(saved_acc * kept)) \
                    or (bo_dir / "bo_progress.json").exists():
                raise RuntimeError(f"bo: alphas {saved_x.shape}, accuracies "
                                   f"{saved_acc[:, 0].tolist()} of {kept} images, progress "
                                   f"left {(bo_dir / 'bo_progress.json').exists()}")
            out["bo_accuracies"] = saved_acc[:, 0].tolist()
        finally:
            for owner, name, _ in patched:
                setattr(owner, name, real[owner, name])
        out["call_seconds"] = seconds

        # the evaluator on the harness's loaded flagship over its 6 PNGs:
        # one position twice, and a resumed evaluator after fast_forward
        before = k1.launches
        ds = ImageLabelDataset(str(images_path), 64)
        images = np.stack([ds.load_image(i) for i in range(len(ds))])
        schedule = alphas.get_cosine_alphas(24)
        kw = dict(attenuation=alphas.ALPHA_ATTENUATION["ids"], eot_steps=EOT_STEPS,
                  batch_size=ALPHA_ADV_BATCH)
        t = time.monotonic()
        evaluator = alphas.AlphaEvaluator(shared["loaded"].defense, images, ds.labels, **kw)
        first = evaluator.predictions(schedule)
        evaluator.fast_forward(0)
        again = evaluator.predictions(schedule)
        second = evaluator.predictions(schedule)
        resumed = alphas.AlphaEvaluator(shared["loaded"].defense, images, ds.labels, **kw)
        resumed.fast_forward(1)
        second_resumed = resumed.predictions(schedule)
        evaluations_s = time.monotonic() - t  # 4 evaluations, predictions on the host
        if not (np.array_equal(first, again) and np.array_equal(second, second_resumed)):
            raise RuntimeError(f"evaluator predictions at one position differ: "
                               f"{first.tolist()} vs {again.tolist()}, {second.tolist()} vs "
                               f"{second_resumed.tolist()}")
        out["evaluator"] = {"position_0": first.tolist(), "position_1": second.tolist(),
                            "labels": ds.labels.tolist(), "seconds": evaluations_s,
                            "k1_launches": k1.launches - before}

        # the GP at the search's width on the card and on the CPU, each call
        # on the same inputs: the fit on the same points, the acquisition on
        # the CPU fit's hyperparameters and the same raw samples (a CPU
        # generator either way)
        rng = np.random.RandomState(0)
        x = rng.rand(ALPHA_GP_POINTS, 24).astype(np.float32)
        y = np.sum((x - 0.45) ** 2, 1).astype(np.float32)
        params, proposals = {}, {}
        for where in ("cpu", "cuda"):
            tx, ty = torch.tensor(x, device=where), torch.tensor(y, device=where)
            t = time.monotonic()
            params[where] = {k: v.cpu() for k, v in gp.fit_gp(tx, ty).items()}
            torch.cuda.synchronize()
            fit_s = time.monotonic() - t
            t = time.monotonic()
            cand, ei = gp.optimize_acqf(
                position_generator("cpu", 0, 0),
                {k: v.to(where) for k, v in params["cpu"].items()}, tx, ty, float(y.min()),
                (torch.zeros(24, device=where), torch.ones(24, device=where)))
            proposals[where] = (cand.cpu(), ei.item())
            out[f"gp_{where}_s"] = {"fit_gp": fit_s, "optimize_acqf": time.monotonic() - t}
        param_err = max(((params["cuda"][k] - params["cpu"][k]).abs().max()
                         / params["cpu"][k].abs().max().clamp(min=1e-6)).item()
                        for k in params["cpu"])
        (want_c, want_ei), (got_c, got_ei) = proposals["cpu"], proposals["cuda"]
        cand_err = (got_c - want_c).abs().max().item()
        ei_err = abs(got_ei - want_ei) / max(abs(want_ei), 1e-12)
        out["gp"] = {"points": ALPHA_GP_POINTS, "param_rel_err": param_err,
                     "candidate_abs_err": cand_err, "ei_rel_err": ei_err, "ei": want_ei,
                     "tol": ALPHA_GP_TOL}
        if not all(math.isfinite(e) and e <= ALPHA_GP_TOL
                   for e in (param_err, cand_err, ei_err)):
            raise RuntimeError(f"the GP on the card differs from the CPU's: {out['gp']}")
        out["k1_launches"], out["k2_launches"] = k1.launches, k2.launches
        if k1.launches == 0:
            raise RuntimeError("the alpha search did not go through K1")
        return out

    # one step of a small model on the card and on the CPU, from the same
    # weights and draws (phases train and train_competitors). Errors are relative to a
    # scale that the noise of float32 sums cannot cross: gradients to the
    # largest gradient; a parameter to its tensor's largest value, or,
    # where that is not met, the gradient its step implies to the
    # largest gradient (a bias before a training BatchNorm has a true
    # gradient of 0, and Adamax's first step lr * G / (|G| + eps) turns
    # the noise into a step of either sign); running statistics to the
    # layer's running variance (a mean after a bias-free 1x1 of
    # normalized inputs is 0 up to noise)
    def step_errors(results, start, implied_grad):
        (want_loss, want, want_g), (got_loss, got, got_g) = results["cpu"], results["cuda"]
        scale = max(g.abs().max().item() for g in want_g.values())
        params = 0.0
        for k, g0 in want_g.items():
            w, g, p0 = want[k].double(), got[k].double().cpu(), start[k].double()
            rel_p = (g - w).abs() / w.abs().max().clamp(min=1e-12)
            rel_g = (implied_grad(p0, g, k) - implied_grad(p0, w, k)).abs() / scale
            params = max(params, torch.minimum(rel_p, rel_g).max().item())
        stats = 0.0
        for k in want:
            if k.endswith("running_var"):
                layer = k[:-len("running_var")]
                var = want[k].double().abs().max().clamp(min=1e-12)
                for name in ("running_mean", "running_var"):
                    diff = got[layer + name].double().cpu() - want[layer + name].double()
                    stats = max(stats, (diff.abs().max() / var).item())
        return {"loss": abs(got_loss - want_loss) / abs(want_loss),
                "grads": max(((got_g[n] - want_g[n]).abs().max() / scale).item()
                             for n in want_g),
                "params": params, "running_stats": stats}

    def adamax_grad(p0, p, name=None, lr=6e-3, eps=1e-3):
        # the gradient a first Adamax step implies: p = p0 - lr G / (|G| + eps)
        a = torch.clamp((p0 - p) / lr, -0.999999, 0.999999)
        return eps * a / (1 - a.abs())

    def sgd_grad(p0, p, name=None, lr=0.01):
        return (p0 - p) / lr  # a first SGD step: the momentum buffer is G

    def one_step(models, step):
        results = {}
        for where, model in models.items():
            # oneDNN's convolution backward corrupted the heap in NVAE
            # training steps on torch 2.13's CPU build: the CPU steps go
            # around it
            with torch.backends.mkldnn.flags(enabled=False):
                loss = step(where, model)
            results[where] = (loss, {k: v.detach().cpu().clone()
                                     for k, v in model.state_dict().items()},
                              {n: p.grad.detach().cpu().clone()
                               for n, p in model.named_parameters()})
        return results

    def train_phase():
        # the trainers at full width: the flagship NVAE's make_nvae_train_step
        # and the flagship VGG11-BN's train_step, then the trained NVAE's
        # eval decodes through K1, a checkpoint round trip, and one step of
        # a small NVAE and a small VGG on the card against the CPU
        import dataclasses

        from gen_adversarial_tpu_torch.core.checkpoint import load_variables, save_variables
        from gen_adversarial_tpu_torch.core.convert import from_jax_variables, to_jax_variables
        from gen_adversarial_tpu_torch.core.init import flax_init_
        from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
        from gen_adversarial_tpu_torch.models.nvae.distributions import position_generator
        from gen_adversarial_tpu_torch.models.nvae.model import NVAE
        from gen_adversarial_tpu_torch.train import augment
        from gen_adversarial_tpu_torch.train import classifier as train_clf
        from gen_adversarial_tpu_torch.train import nvae as train_nvae

        out = {"nvidia_smi": device_info["nvidia_smi"]}
        gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)

        def timed_steps(step, n):
            """(losses, seconds of each call) of 1 + n calls of step(i)."""
            losses, seconds = [], []
            for i in range(1 + n):
                torch.cuda.synchronize()
                t = time.monotonic()
                loss = step(i)
                torch.cuda.synchronize()
                seconds.append(time.monotonic() - t)
                losses.append(float(loss))
            return losses, seconds

        def peak_gib():
            return torch.cuda.max_memory_allocated() / 2 ** 30

        # the flagship NVAE: 1 warm-up and TRAIN_STEPS timed steps
        nvae = flax_init_(NVAE(FLAGSHIP_NVAE, device=dev), gen)
        before = {k: v.clone() for k, v in nvae.state_dict().items()}
        images = torch.rand((TRAIN_NVAE_BATCH, 64, 64, 3), generator=gen, device=dev)
        _, nvae_step = train_nvae.make_nvae_train_step(
            nvae, 6e-3, num_total_iter=100, input_noise=TRAIN_INPUT_NOISE)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, seconds = timed_steps(lambda i: nvae_step(
            {"image": images}, position_generator(dev, TRAIN_SEED, i), i)[0], TRAIN_STEPS)
        out["nvae"] = {"batch": TRAIN_NVAE_BATCH, "losses": losses, "step_s": seconds,
                       "s_per_step": sum(seconds[1:]) / TRAIN_STEPS,
                       "peak_gib": peak_gib(), "k1_launches": k1.launches}
        if k1.launches:
            raise RuntimeError(f"the NVAE's training steps launched K1 {k1.launches} times")
        after = nvae.state_dict()
        moved = {kind: sum(not torch.equal(after[k], before[k]) for k in after
                           if k.endswith(suffix))
                 for kind, suffix in (("weights", "weight"), ("running_means", "running_mean"),
                                      ("running_vars", "running_var"))}
        out["nvae"]["changed"] = moved
        if not all(math.isfinite(v) for v in losses) or not all(moved.values()):
            raise RuntimeError(f"NVAE training: losses {losses}, changed {moved}")

        # the trained NVAE's eval decodes go through K1: 50 launches a decode
        nvae.eval().requires_grad_(False)
        reset_counts()
        with torch.no_grad():
            rec = nvae.reconstruct(images, deterministic=True)
            torch.cuda.synchronize()
            recon_launches = k1.launches
            sample = nvae.sample(4, gen)
        per_decode = len(FLAGSHIP_NVAE.decoder_segment_shapes())
        out["eval"] = {"reconstruct_k1_launches": recon_launches,
                       "sample_k1_launches": k1.launches - recon_launches,
                       "per_decode": per_decode}
        if recon_launches != per_decode or k1.launches != 2 * per_decode:
            raise RuntimeError(f"eval decodes: {out['eval']}")
        if rec.shape != images.shape or sample.shape != (4, 64, 64, 3) or \
                not (torch.isfinite(rec).all() and torch.isfinite(sample).all()):
            raise RuntimeError(f"reconstruct {tuple(rec.shape)}, sample {tuple(sample.shape)}")

        # the trained NVAE through save_variables / load_variables
        path = Path(scratch.name) / "trained_nvae.msgpack"
        save_variables(path, to_jax_variables(nvae),
                       {"epoch": 0, "config": dataclasses.asdict(FLAGSHIP_NVAE)})
        variables, meta = load_variables(path)
        fresh = NVAE(NVAEConfig(**meta["config"]), device=dev)
        fresh = from_jax_variables(variables, fresh).eval().requires_grad_(False)
        with torch.no_grad():
            again = fresh.reconstruct(images, deterministic=True)
        out["roundtrip_max_abs_err"] = (again - rec).abs().max().item()
        if out["roundtrip_max_abs_err"] > 1e-6:
            raise RuntimeError(f"the reloaded NVAE reconstructs {out['roundtrip_max_abs_err']} "
                               "away from the trained one")
        del nvae, fresh, before, after, variables

        # the flagship VGG11-BN: 1 warm-up and TRAIN_STEPS timed train_steps
        clf = flax_init_(VGG11BN(100, device=dev), gen).to(memory_format=torch.channels_last)
        state = train_clf.create_train_state(clf, 0.01)
        batch = {"image": torch.rand((TRAIN_CLF_BATCH, 64, 64, 3), generator=gen, device=dev),
                 "label": torch.randint(0, 100, (TRAIN_CLF_BATCH,), generator=gen, device=dev)}
        torch.cuda.reset_peak_memory_stats()
        losses, seconds = timed_steps(lambda i: train_clf.train_step(
            state, batch, position_generator(dev, TRAIN_SEED, i)), TRAIN_STEPS)
        out["vgg"] = {"batch": TRAIN_CLF_BATCH, "losses": losses, "step_s": seconds,
                      "s_per_step": sum(seconds[1:]) / TRAIN_STEPS, "peak_gib": peak_gib()}
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"VGG training: losses {losses}")
        del clf, state, batch

        cpu_gen = torch.Generator().manual_seed(TRAIN_SEED)
        small_cfg = NVAEConfig(resolution=16, initial_channels=8, n_pre_post_blocks=1,
                               n_pre_post_cells=2, num_scales=2, num_groups_per_scale=2,
                               is_adaptive=False, num_cells_per_group=1,
                               num_latent_per_group=4, num_mixtures=3)
        cpu_nvae = flax_init_(NVAE(small_cfg, device="cpu"), cpu_gen)
        start = {k: v.clone() for k, v in cpu_nvae.state_dict().items()}
        models = {"cpu": cpu_nvae, "cuda": copy.deepcopy(cpu_nvae).to(dev)}
        x = torch.rand((2, 16, 16, 3), generator=cpu_gen)
        draws = [torch.randn((2, 16, 16, 3), generator=cpu_gen)]
        draws += [torch.randn(s, generator=cpu_gen) for s in eps_shapes(small_cfg, 2)]

        def nvae_one(where, model):
            _, step = train_nvae.make_nvae_train_step(model, 6e-3, num_total_iter=100,
                                                      input_noise=TRAIN_INPUT_NOISE)
            return step({"image": x}, list(draws), 5)[0].item()

        nvae_err = step_errors(one_step(models, nvae_one), start, adamax_grad)

        cpu_vgg = flax_init_(VGG11BN(10, plan=(8, "M", 16, "M", 16, "M"), device="cpu"), cpu_gen)
        start = {k: v.clone() for k, v in cpu_vgg.state_dict().items()}
        vggs = {"cpu": cpu_vgg, "cuda": copy.deepcopy(cpu_vgg).to(dev)}
        batch = {"image": torch.rand((4, 16, 16, 3), generator=cpu_gen),
                 "label": torch.randint(0, 10, (4,), generator=cpu_gen)}
        params = augment.draw_augment(cpu_gen, 4)

        def fixed_augment(images, generator):
            out = augment.apply_augment(images, {k: v.to(images.device)
                                                 for k, v in params.items()})
            return (out - 0.5) / 0.5

        def vgg_one(where, model):
            st = train_clf.create_train_state(model, 0.01)
            return train_clf.train_step(st, batch, None, augment=fixed_augment).item()

        vgg_err = step_errors(one_step(vggs, vgg_one), start, sgd_grad)
        out["gpu_vs_cpu"] = {"nvae": nvae_err, "vgg": vgg_err, "tol": TRAIN_PARITY_RTOL}
        errors = list(nvae_err.values()) + list(vgg_err.values())
        if not all(math.isfinite(e) and e <= TRAIN_PARITY_RTOL for e in errors):
            raise RuntimeError(f"a train step on the card differs from the CPU's: "
                               f"{out['gpu_vs_cpu']}")
        out["k1_launches"] = recon_launches + out["eval"]["sample_k1_launches"]
        return out

    from gen_adversarial_tpu_torch.models.nvae.distributions import RecordingDraws

    def competitors_phase():
        # the six competitor configs at full width from files: the purifiers
        # random from a seed (flax's initializers), the classifiers the
        # harness's flagship VGG (ids) and a ResNet50 / ResNeXt50 (gender,
        # cars), each config loaded by load_defense and run at EoT-32
        import re

        from gen_adversarial_tpu_torch.core.checkpoint import save_variables
        from gen_adversarial_tpu_torch.core.config import (
            IMAGE_SIZE as SIZES, N_CLASSES, DefenseConfig)
        from gen_adversarial_tpu_torch.core.convert import to_jax_variables
        from gen_adversarial_tpu_torch.core.init import flax_init_
        from gen_adversarial_tpu_torch.core.precision import defense_astype
        from gen_adversarial_tpu_torch.defenses.base import make_classifier_apply
        from gen_adversarial_tpu_torch.defenses.competitors import AVaeDefense, NDVaeDefense
        from gen_adversarial_tpu_torch.eval.factory import CLASSIFIER_TYPE, load_defense
        from gen_adversarial_tpu_torch.models.avae.model import StyledGenerator
        from gen_adversarial_tpu_torch.models.classifiers import VGG11BN, make_classifier
        from gen_adversarial_tpu_torch.models.ndvae.model import DefenceNVAE

        out = {"nvidia_smi": device_info["nvidia_smi"], "eot_steps": EOT_STEPS}
        tmp = Path(scratch.name) / "competitors"
        tmp.mkdir()
        cgen = torch.Generator(device=dev).manual_seed(COMPETITOR_SEED)
        clf_paths = {"ids": Path(scratch.name) / "vgg.msgpack"}  # phase harness's
        for exp in ("gender", "cars"):
            clf = flax_init_(make_classifier(CLASSIFIER_TYPE[exp], N_CLASSES[exp], device=dev),
                             cgen)
            clf_paths[exp] = tmp / f"{exp}_classifier.msgpack"
            save_variables(clf_paths[exp], to_jax_variables(clf),
                           {"model_type": CLASSIFIER_TYPE[exp]})
            del clf

        def purifier(kind, cfg, size):
            if kind == "avae":
                return StyledGenerator(size, device=dev)
            return DefenceNVAE(x_channels=cfg.x_channels, encoding_channels=cfg.encoding_channels,
                               pre_proc_groups=cfg.pre_proc_groups, scales=cfg.scales,
                               groups=cfg.groups, cells=cfg.cells, input_dim=size, device=dev)

        configs = {}
        reset_counts()  # counts from here on are this path's
        for kind in ("avae", "ndvae"):
            for exp in ("ids", "gender", "cars"):
                name = f"competitor_{kind}_{exp}"
                size, batch = SIZES[exp], COMPETITOR_BATCH[exp]
                text = (root / "configs" / f"{name}.yaml").read_text()
                text = re.sub(r"^classifier_path: .*$", f"classifier_path: {clf_paths[exp]}",
                              text, flags=re.M)
                text = re.sub(r"^autoencoder_path: .*$",
                              f"autoencoder_path: {tmp / (name + '.msgpack')}", text, flags=re.M)
                config = tmp / f"{name}.yaml"
                config.write_text(text)
                cfg = DefenseConfig.from_yaml(config)
                t = time.monotonic()
                model = flax_init_(purifier(kind, cfg, size), cgen)
                save_variables(tmp / f"{name}.msgpack", to_jax_variables(model))
                write_s = time.monotonic() - t
                n_params = sum(p.numel() for p in model.parameters())
                del model
                t = time.monotonic()
                loaded = load_defense(str(config))
                torch.cuda.synchronize()
                load_s = time.monotonic() - t
                images = torch.rand(batch, size, size, 3, device=dev, generator=cgen)
                torch.cuda.reset_peak_memory_stats()
                call_s = []
                with torch.no_grad():
                    for i in range(1 + TIMED_CALLS):
                        torch.cuda.synchronize()
                        t = time.monotonic()
                        logits = loaded.net(images, torch.Generator(device=dev).manual_seed(i))
                        torch.cuda.synchronize()
                        call_s.append(time.monotonic() - t)
                if tuple(logits.shape) != (batch, N_CLASSES[exp]) or \
                        not torch.isfinite(logits).all():
                    raise RuntimeError(f"{name}: logits {tuple(logits.shape)}, finite "
                                       f"{bool(torch.isfinite(logits).all())}")
                mean_s = sum(call_s[1:]) / TIMED_CALLS
                out[name] = {"batch": batch, "image_size": size, "purifier_params": n_params,
                             "init_and_write_s": write_s, "load_defense_s": load_s,
                             "call_s": call_s,
                             "images_per_s": batch / mean_s,
                             "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30}
                configs[name] = (config, loaded, images)

        # the ids pair under the attacks: a DeepFool step (the suite's 8
        # class cotangents in blocks of COMPETITOR_DF_COT_CHUNK) and an
        # APGD-CE input gradient, through EoT-32, on COMPETITOR_ATTACK_BATCH
        # images
        s = ATTACK_SUITES["ids"]
        for kind in ("avae", "ndvae"):
            name = f"competitor_{kind}_ids"
            _, loaded, images = configs[name]
            images = images[:COMPETITOR_ATTACK_BATCH]
            chunk = COMPETITOR_DF_COT_CHUNK[kind]
            with torch.no_grad():
                labels = loaded.net(images, torch.Generator(device=dev).manual_seed(5)).argmax(1)
            res, sec, peak = timed(lambda: attacks.deepfool_attack(
                loaded.net, images, labels, torch.Generator(device=dev).manual_seed(7),
                num_classes=s.deepfool_num_classes, overshoot=s.deepfool_overshoot, max_iter=1,
                return_iters=True, cotangent_chunk=chunk))
            out[name]["deepfool_step"] = {**check_attack(name + " deepfool", res, len(images)),
                                          "batch": len(images), "seconds": sec,
                                          "max_memory_allocated_gb": peak,
                                          "cotangent_chunk": chunk, "eot_chunk": None}

            def ce_grad():  # what an APGD-CE step takes
                x = images.clone().requires_grad_(True)
                logits = loaded.net(x, torch.Generator(device=dev).manual_seed(8))
                return torch.autograd.grad(F.cross_entropy(logits, labels), x)[0]

            grad, sec, peak = timed(ce_grad)
            if not torch.isfinite(grad).all() or grad.abs().max() == 0:
                raise RuntimeError(f"{name}: the CE input gradient is not finite or is 0")
            out[name]["apgd_ce_gradient"] = {"seconds": sec, "max_memory_allocated_gb": peak,
                                             "eot_chunk": None}
        out["k1_launches"], out["k2_launches"] = k1.launches, k2.launches
        if k1.launches or k2.launches:
            raise RuntimeError(f"the competitors launched K1 {k1.launches}, K2 {k2.launches} "
                               "times: neither has a Pallas kernel")

        # bfloat16: the A-VAE raises (as the JAX package's does once its
        # weights are traced); the ND-VAE computes in float32 on weights
        # rounded to bfloat16 (defenses/competitors.py), so its logits move
        # from the float32 ones
        try:
            load_defense(str(configs["competitor_avae_ids"][0]), dtype="bfloat16")
        except TypeError as e:
            out["avae_bfloat16"] = f"raises TypeError: {e}"
        else:
            raise RuntimeError("the A-VAE loaded in bfloat16")
        _, loaded, images = configs["competitor_ndvae_ids"]
        cast = defense_astype(copy.deepcopy(loaded.defense), torch.bfloat16)
        with torch.no_grad():
            want = loaded.net(images, torch.Generator(device=dev).manual_seed(9))
            got = eot_wrap(cast, EOT_STEPS)(images, torch.Generator(device=dev).manual_seed(9))
        out["ndvae_bfloat16"] = {
            "argmax_agreement": (got.argmax(1) == want.argmax(1)).float().mean().item(),
            "max_abs_dlogit": (got - want).abs().max().item(), "logits_dtype": str(got.dtype),
            "finite": bool(torch.isfinite(got).all())}
        if (not out["ndvae_bfloat16"]["finite"] or got.dtype != torch.float32
                or out["ndvae_bfloat16"]["max_abs_dlogit"] == 0):
            raise RuntimeError(f"the bfloat16 ND-VAE (its logits must move from float32's): "
                               f"{out['ndvae_bfloat16']}")
        del configs, loaded, cast
        torch.cuda.empty_cache()

        # a small A-VAE (64 px, its smallest; batch 1, EoT 2) and a small
        # ND-VAE, on the card and on the CPU from the same weights and draws
        cpu_gen = torch.Generator().manual_seed(COMPETITOR_SEED)
        clf = flax_init_(VGG11BN(10, plan=(8, "M", 16, "M", 16, "M"), device="cpu"), cpu_gen)
        small = {
            "avae": AVaeDefense(flax_init_(StyledGenerator(64, device="cpu"), cpu_gen), clf,
                                make_classifier_apply(clf), 2),
            "ndvae": NDVaeDefense(flax_init_(DefenceNVAE(encoding_channels=8, scales=2,
                                                         groups=1, cells=2, input_dim=64,
                                                         device="cpu"), cpu_gen),
                                  clf, make_classifier_apply(clf), 0.1)}
        errors = {}
        for kind, defense in small.items():
            x = torch.rand(1, 64, 64, 3, generator=cpu_gen)
            rec = RecordingDraws(cpu_gen)
            with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
                want = eot_wrap(defense, 2)(x, rec)
                got = eot_wrap(copy.deepcopy(defense).to(dev), 2)(x.to(dev), list(rec.record))
            errors[kind] = rel_err(got.cpu(), want)
        out["small_gpu_vs_cpu"] = {**errors, "tol": PARITY_RTOL}
        if not all(math.isfinite(e) and e <= PARITY_RTOL for e in errors.values()):
            raise RuntimeError(f"small competitors on the card differ from the CPU: {errors}")
        return out

    def train_competitors_phase():
        # the three competitor trainers at full width, 1 warm-up and
        # TRAIN_STEPS timed steps each, then one step of small models on the
        # card against the CPU
        from gen_adversarial_tpu_torch.core.init import flax_init_
        from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
        from gen_adversarial_tpu_torch.models.ndvae.model import DefenceNVAE
        from gen_adversarial_tpu_torch.models.nvae.distributions import position_generator
        from gen_adversarial_tpu_torch.train import avae as train_avae
        from gen_adversarial_tpu_torch.train import classifier as train_clf
        from gen_adversarial_tpu_torch.train import ndvae as train_ndvae
        from gen_adversarial_tpu_torch.train import trades as train_trades

        out = {"nvidia_smi": device_info["nvidia_smi"]}
        tgen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
        reset_counts()

        def timed_steps(step, n=TRAIN_STEPS):
            """(losses, seconds of each call, peak GiB) of 1 + n calls of step(i)."""
            losses, seconds = [], []
            torch.cuda.reset_peak_memory_stats()
            for i in range(1 + n):
                torch.cuda.synchronize()
                t = time.monotonic()
                loss = step(i)
                torch.cuda.synchronize()
                seconds.append(time.monotonic() - t)
                losses.append(float(loss))
            return losses, seconds, torch.cuda.max_memory_allocated() / 2 ** 30

        def moved(model, before):
            after = model.state_dict()
            return sum(not torch.equal(after[k], before[k]) for k in after
                       if after[k].is_floating_point())

        def record(name, model, before, losses, seconds, peak, batch, **extra):
            out[name] = {"batch": batch, "losses": losses, "step_s": seconds,
                         "s_per_step": sum(seconds[1:]) / TRAIN_STEPS, "peak_gib": peak,
                         "tensors_changed": moved(model, before), **extra}
            if not all(math.isfinite(v) for v in losses) or not out[name]["tensors_changed"]:
                raise RuntimeError(f"{name} training: {out[name]}")

        # the A-VAE at 64 px, batch 32 (the CLI's defaults): d_step, g_step
        # and accumulate a step
        t = train_avae.make_avae_trainers(64, 2, 1e-3, device=dev)
        t.init(tgen)
        ema = copy.deepcopy(t.gen).requires_grad_(False)
        both = torch.nn.ModuleDict({"gen": t.gen, "disc": t.disc})
        before = {k: v.clone() for k, v in both.state_dict().items()}
        real = torch.rand(TRAIN_AVAE_BATCH, 3, 64, 64, device=dev, generator=tgen) * 2 - 1

        def avae_step(i):
            wgan, gp = t.d_step(real, position_generator(dev, TRAIN_SEED, i, 0))
            rec, kl = t.g_step(real, position_generator(dev, TRAIN_SEED, i, 1))
            t.accumulate(ema)
            return wgan + gp + rec + kl

        record("avae", both, before, *timed_steps(avae_step), TRAIN_AVAE_BATCH)
        del t, ema, both, before, real

        # the ND-VAE on the cars128 recipe (128 px, batch 32)
        r = train_ndvae.NDVAE_RECIPES["cars128"]
        model = flax_init_(DefenceNVAE(input_dim=r["image_size"], **r["params"], device=dev), tgen)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        size = r["image_size"]
        clean = torch.rand(r["batch_size"], size, size, 3, device=dev, generator=tgen)
        adv = torch.clamp(clean + 0.05 * torch.randn(clean.shape, device=dev, generator=tgen),
                          0, 1)
        _, nd_step = train_ndvae.make_ndvae_train_step(model, r["lr"], num_total_iter=100)
        record("ndvae_cars128", model, before, *timed_steps(lambda i: nd_step(
            {"x_adv": adv, "x_orig": clean}, position_generator(dev, TRAIN_SEED, i), i)[0]),
            r["batch_size"])
        del model, before, clean, adv

        # TRADES on the flagship VGG11-BN at batch 64, the ids recipe
        recipe = train_trades.TRADES_RECIPES["ids"]
        clf = flax_init_(VGG11BN(100, device=dev), tgen).to(memory_format=torch.channels_last)
        before = {k: v.clone() for k, v in clf.state_dict().items()}
        state = train_clf.create_train_state(clf, 0.01)
        batch = {"image": torch.rand(TRAIN_CLF_BATCH, 64, 64, 3, device=dev, generator=tgen),
                 "label": torch.randint(0, 100, (TRAIN_CLF_BATCH,), device=dev, generator=tgen)}
        trades_step = train_trades.make_trades_train_step(recipe["beta"], recipe["epsilon"])
        record("trades_ids", clf, before, *timed_steps(lambda i: trades_step(
            state, batch, position_generator(dev, TRAIN_SEED, i))), TRAIN_CLF_BATCH,
            perturb_steps=train_trades.TRADES_PERTURB_STEPS, **recipe)
        del clf, state, batch, before
        torch.cuda.empty_cache()
        out["k1_launches"], out["k2_launches"] = k1.launches, k2.launches

        # the small steps against the CPU (phase competitor_steps): the
        # worker's CPU steps, then the ND-VAE's and TRADES' card steps on the
        # draws the CPU recorded
        cpu = shared.pop("competitor_cpu").result()
        nd_card = {"cuda": cpu["ndvae"]["init"].to(dev)}
        _, nd_step = train_ndvae.make_ndvae_train_step(nd_card["cuda"], 1e-2, num_total_iter=100)
        nd_err = step_errors({**one_step(nd_card, lambda where, model: nd_step(
            cpu["ndvae"]["pair"], list(cpu["ndvae"]["record"]), 5)[0].item()),
            "cpu": cpu["ndvae"]["result"]}, cpu["ndvae"]["start"],
            lambda p0, p, name: adamax_grad(p0, p, lr=1e-2))
        vgg_card = {"cuda": cpu["trades"]["init"].to(dev)}
        trades_step = train_trades.make_trades_train_step(1.0, 2.0, perturb_steps=4)
        trades_err = step_errors({**one_step(vgg_card, lambda where, model: trades_step(
            train_clf.create_train_state(model, 0.01), cpu["trades"]["batch"],
            list(cpu["trades"]["record"])).item()), "cpu": cpu["trades"]["result"]},
            cpu["trades"]["start"], sgd_grad)
        avae_err = cpu["avae_err"]
        out["gpu_vs_cpu"] = {"avae_f32_vs_f64": avae_err, "ndvae": nd_err,
                             "trades_float64": trades_err, "tol": TRAIN_PARITY_RTOL}
        errors = ([e for k, e in avae_err.items() if k != "branches_changed"]
                  + list(nd_err.values()) + list(trades_err.values()))
        if not all(math.isfinite(e) and e <= TRAIN_PARITY_RTOL for e in errors):
            raise RuntimeError(f"a competitor train step on the card differs from the CPU's: "
                               f"{out['gpu_vs_cpu']}")
        return out

    def competitor_steps_phase():
        # one step of the A-VAE (64 px, batch 1), a small ND-VAE and a small
        # VGG on the card against the CPU (step_errors' scales), checked in
        # phase train_competitors. The CPU's steps run on the worker while
        # the card runs the phases from harness on (the worker's oneDNN
        # switch and the A-VAE's branch replay are process-wide: the main
        # sequence waits for it before phase train, whose CPU steps switch
        # oneDNN too, and competitors runs the A-VAE). The A-VAE's
        # Adam (eps 1e-8) and the ND-VAE's Adamax are held by the gradient
        # their first step implies. The A-VAE steps in float32 on the card
        # (here, first) and in float64 on the CPU, whose leaky ReLUs take the
        # card's branches (leaky_relu_branches): where a leaky ReLU's input lies
        # within rounding of 0 the two precisions take different slopes,
        # which put a float32 step's gradients up to 3.1e-2 (relative) from
        # the float64 step's on the CPU, and on the float32 run's branches
        # 2.4e-5 (tests/torch_avae_branch_sweep.py, 12 seeds).
        # TRADES runs in float64 on both: its inner loop starts from a
        # 0.001 x N(0, 1) perturbation, where the KL is ~1e-8, below
        # float32's resolution of its O(1) terms, so its first direction is
        # rounding noise in float32. The ND-VAE and TRADES steps run on the
        # CPU first, which records their draws for the card's
        from gen_adversarial_tpu_torch.core.init import flax_init_
        from gen_adversarial_tpu_torch.models.avae.model import leaky_relu_branches
        from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
        from gen_adversarial_tpu_torch.models.ndvae.model import DefenceNVAE
        from gen_adversarial_tpu_torch.train import avae as train_avae
        from gen_adversarial_tpu_torch.train import classifier as train_clf
        from gen_adversarial_tpu_torch.train import ndvae as train_ndvae
        from gen_adversarial_tpu_torch.train import trades as train_trades

        card_gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
        card = train_avae.make_avae_trainers(64, 2, 1e-3, device=dev)
        card.init(card_gen)
        both = torch.nn.ModuleDict({"gen": card.gen, "disc": card.disc})
        start = {k: v.detach().cpu().clone() for k, v in both.state_dict().items()}
        x = torch.rand(1, 3, 64, 64, device=dev, generator=card_gen) * 2 - 1
        d_rec, g_rec = RecordingDraws(card_gen), RecordingDraws(card_gen)
        masks = []

        def avae_card(where, model):
            with leaky_relu_branches() as taken:
                wgan, gp = card.d_step(x, d_rec)
                rec, kl = card.g_step(x, g_rec)
            masks.extend(t.cpu() for t in taken)
            return (wgan + gp + rec + kl).item()

        avae_card_result = one_step({"cuda": both}, avae_card)["cuda"]
        d_record = [t.cpu() for t in d_rec.record]
        g_record = [t.cpu() for t in g_rec.record]
        real = x.cpu()
        del card, both, d_rec, g_rec, x
        torch.cuda.empty_cache()

        def adam_grad(p0, p, name, lr=1e-3):
            return adamax_grad(p0, p, lr=lr * (train_avae.STYLE_LR_MUL if
                                               name.startswith("gen.style_layers") else 1.0),
                               eps=1e-8)

        def cpu_steps():  # on the worker
            cpu_gen = torch.Generator().manual_seed(TRAIN_SEED)
            tr = train_avae.make_avae_trainers(64, 2, 1e-3, device="cpu")
            both = torch.nn.ModuleDict({"gen": tr.gen, "disc": tr.disc})
            both.load_state_dict(start)
            both.double()
            changed = []

            def avae_cpu(where, model):
                with leaky_relu_branches(masks) as taken:
                    wgan, gp = tr.d_step(real.double(), list(d_record))
                    rec, kl = tr.g_step(real.double(), list(g_record))
                changed.extend(taken)
                return (wgan + gp + rec + kl).item()

            avae_err = step_errors({"cuda": avae_card_result,
                                    **one_step({"cpu": both}, avae_cpu)}, start, adam_grad)
            avae_err["branches_changed"] = int(sum(n.item() for n in changed))
            del tr, both

            nd = flax_init_(DefenceNVAE(encoding_channels=8, scales=2, groups=1, cells=2,
                                        input_dim=32, device="cpu"), cpu_gen)
            ndvae = {"init": copy.deepcopy(nd),
                     "start": {k: v.clone() for k, v in nd.state_dict().items()},
                     "pair": {"x_adv": torch.rand(2, 32, 32, 3, generator=cpu_gen),
                              "x_orig": torch.rand(2, 32, 32, 3, generator=cpu_gen)}}
            nd_rec = RecordingDraws(cpu_gen)
            _, nd_step = train_ndvae.make_ndvae_train_step(nd, 1e-2, num_total_iter=100)
            ndvae["result"] = one_step({"cpu": nd}, lambda where, model: nd_step(
                ndvae["pair"], nd_rec, 5)[0].item())["cpu"]
            ndvae["record"] = nd_rec.record

            vgg = flax_init_(VGG11BN(10, plan=(8, "M", 16, "M", 16, "M"), device="cpu"),
                             cpu_gen).double()
            trades = {"init": copy.deepcopy(vgg),
                      "start": {k: v.clone() for k, v in vgg.state_dict().items()},
                      "batch": {"image": torch.rand(4, 16, 16, 3, generator=cpu_gen,
                                                    dtype=torch.float64),
                                "label": torch.randint(0, 10, (4,), generator=cpu_gen)}}
            t_rec = RecordingDraws(cpu_gen)
            step = train_trades.make_trades_train_step(1.0, 2.0, perturb_steps=4)
            trades["result"] = one_step({"cpu": vgg}, lambda where, model: step(
                train_clf.create_train_state(model, 0.01), trades["batch"], t_rec).item())["cpu"]
            trades["record"] = t_rec.record
            return {"avae_err": avae_err, "ndvae": ndvae, "trades": trades}

        shared["competitor_cpu"] = cpu_worker.submit(cpu_steps)
        return {"avae_card_loss": avae_card_result[0]}

    def distributed_phase():
        # data parallel (core/distributed.py): the two gloo ranks sharing the
        # card, started after phase harness_files, have run the classifier CLI;
        # this process, in an NCCL group of one, reruns the harness's
        # DeepFool with distributed=True (before alpha_search writes the
        # loaded defense's alphas), times the flagship VGG11-BN's step in
        # DDP, and runs the CLI as one rank, which the two ranks' result is
        # held to
        import os

        import numpy as np
        from gen_adversarial_tpu_torch.core import distributed as dist_util
        from gen_adversarial_tpu_torch.core.checkpoint import load_variables
        from gen_adversarial_tpu_torch.core.init import flax_init_
        from gen_adversarial_tpu_torch.eval.harness import run_benchmark
        from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
        from gen_adversarial_tpu_torch.models.nvae.distributions import position_generator
        from gen_adversarial_tpu_torch.train import classifier as train_clf

        out = {"nvidia_smi": device_info["nvidia_smi"]}
        tmp = ddp_ranks["dir"]
        try:
            os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), RANK="0",
                              WORLD_SIZE="1", LOCAL_RANK="0")
            t = time.monotonic()
            several = dist_util.maybe_initialize(timeout_s=DDP_TIMEOUT_S)
            out["nccl_init_s"] = time.monotonic() - t
            out["backend"] = torch.distributed.get_backend()
            if several or out["backend"] != "nccl":
                raise RuntimeError(f"expected an NCCL group of one: {out['backend']}, "
                                   f"{torch.distributed.get_world_size()} processes")

            # the harness phase's DeepFool, as the rank of a group of one
            reset_counts()
            t = time.monotonic()
            results = run_benchmark(shared["loaded"], str(shared["images"]),
                                    str(tmp / "results"), batch_size=HARNESS_BATCH,
                                    seed=HARNESS_SEED, attack_filter="deepfool",
                                    plots=False, log_fn=lambda s: None, distributed=True)
            out["run_benchmark_s"] = time.monotonic() - t
            out["k1_launches"] = k1.launches
            want, got = harness["results"]["DeepFool"], results["DeepFool"]
            out["deepfool"] = {"got": got, "want": want, "identical": got == want,
                               "max_abs_diff": max(abs(a - b) for a, b in zip(got, want))}
            # the same draws; the attack's gradients may run other cuDNN
            # algorithms than in the harness phase
            if len(got) != len(want) or any(abs(a - b) > ATTACK_TOL * abs(b)
                                            for a, b in zip(got, want)) \
                    or results["Clean"] != harness["results"]["Clean"] or not k1.launches:
                raise RuntimeError(f"distributed DeepFool {got}, clean {results['Clean']}; "
                                   f"the harness phase's {want}, {harness['results']['Clean']}")

            # the flagship VGG11-BN's train step in DDP
            gen_v = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
            clf = flax_init_(VGG11BN(100, device=dev), gen_v).to(
                memory_format=torch.channels_last)
            state = train_clf.create_train_state(clf, 0.01)
            state.ddp = dist_util.wrap_ddp(clf)
            batch = {"image": torch.rand((TRAIN_CLF_BATCH, 64, 64, 3), generator=gen_v,
                                         device=dev),
                     "label": torch.randint(0, 100, (TRAIN_CLF_BATCH,), generator=gen_v,
                                            device=dev)}
            torch.cuda.reset_peak_memory_stats()
            seconds, losses = [], []
            for i in range(1 + TRAIN_STEPS):
                torch.cuda.synchronize()
                t = time.monotonic()
                losses.append(float(train_clf.train_step(
                    state, batch, position_generator(dev, TRAIN_SEED, i))))
                torch.cuda.synchronize()
                seconds.append(time.monotonic() - t)
            out["vgg_ddp"] = {"batch": TRAIN_CLF_BATCH, "losses": losses, "step_s": seconds,
                              "s_per_step": sum(seconds[1:]) / TRAIN_STEPS,
                              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            if not all(math.isfinite(v) for v in losses):
                raise RuntimeError(f"VGG training in DDP: losses {losses}")
            del clf, state, batch

            # one rank's run of the same CLI, in this process
            t = time.monotonic()
            ddp_worker(str(tmp / "data"), str(tmp / "one"), "0")
            out["one_rank_s"] = time.monotonic() - t
        finally:
            stdout = stop_ddp_ranks()
            if dist_util.initialized():
                torch.distributed.destroy_process_group()
            for key in dist_util.TORCHRUN_ENV:
                os.environ.pop(key, None)
        reports = [tmp / "two" / f"rank{r}.json" for r in range(2)]
        if ddp_ranks["returncode"] != 0 or not all(p.exists() for p in reports):
            raise RuntimeError(f"the two ranks: exit {ddp_ranks['returncode']}:\n"
                               + "\n".join(stdout.splitlines()[-30:]))
        reports = [json.loads(p.read_text()) for p in reports]
        # from the launch to the last rank's end, while the harness phase ran
        out["two_ranks"] = {"started_in": "harness_files",
                            "wall_s": max(r["ended"] for r in reports) - ddp_ranks["t0"]}
        if not reports[0]["history"] or reports[0]["history"] != reports[1]["history"]:
            raise RuntimeError(f"the two ranks' histories differ: {reports}")
        one, _ = load_variables(tmp / "one" / "last.msgpack")
        two, _ = load_variables(tmp / "two" / "last.msgpack")
        one, two = dict(_leaves(one)), dict(_leaves(two))
        errors = {"/".join(k): float(np.max(np.abs(two[k] - v) - DDP_RTOL * np.abs(v)))
                  for k, v in one.items()}
        out["two_ranks"].update(history=reports[0]["history"], leaves=len(one),
                                worst_excess=max(errors.values()), atol=DDP_ATOL,
                                rtol=DDP_RTOL,
                                max_abs_diff=max(float(np.max(np.abs(two[k] - v)))
                                                 for k, v in one.items()))
        if sorted(one) != sorted(two) or max(errors.values()) > DDP_ATOL:
            raise RuntimeError(f"two ranks' parameters differ from one rank's: "
                               f"{out['two_ranks']}")
        return out

    def discriminator_phase():
        # the 1024-px StyleGAN2 discriminator: K2 at its 16 blur sites against
        # the plain version, forward and input gradient at full width with
        # K2's launches counted, a small one on the card against the CPU,
        # and one converted from a reference-layout state dict
        from gen_adversarial_tpu_torch.core.convert import from_jax_variables, to_jax_variables
        from gen_adversarial_tpu_torch.core.stylegan_convert import convert_discriminator
        from gen_adversarial_tpu_torch.flagship import random_init_
        from gen_adversarial_tpu_torch.gender import init_stylegan_tensor_
        from gen_adversarial_tpu_torch.models.stylegan2.discriminator import Discriminator
        from gen_adversarial_tpu_torch.models.stylegan2.generator import generator_channels
        from tests.torch_reference_layout import discriminator_state_dict

        out = {"nvidia_smi": device_info["nvidia_smi"], "size": DISC_SIZE,
               "batch": DISC_BATCH, "dtype": "float32"}
        ch = generator_channels(2)
        # each ResBlock at resolution r blurs its conv1 output (pad (2, 2))
        # and its input (pad (1, 1)), both ch[r] channels at r x r
        sites = [(ch[2 ** i], 2 ** i) for i in range(int(math.log2(DISC_SIZE)), 2, -1)]
        disc_taps = tuple(t / sum(BLUR_KERNEL) for t in BLUR_KERNEL)
        # the library call as many times as the kernel: at the small sites
        # both are host-bound, and the two are compared there
        reps = (KERNEL_REPS, 3)
        out["k2"] = {"taps": list(disc_taps), "library_reps": KERNEL_REPS,
                     "pad_2": k2_rows(sites, DISC_BATCH, (2, 2), disc_taps, reps),
                     "pad_1": k2_rows(sites, DISC_BATCH, (1, 1), disc_taps, reps)}

        gen_d = torch.Generator(device=dev).manual_seed(COMPETITOR_SEED)
        disc = random_init_(Discriminator(DISC_SIZE, device=dev), gen_d, init_stylegan_tensor_)
        disc.requires_grad_(False)
        out["parameters_m"] = sum(p.numel() for p in disc.parameters()) / 1e6
        x = torch.rand((DISC_BATCH, 3, DISC_SIZE, DISC_SIZE), generator=gen_d,
                       device=dev) * 2 - 1
        torch.cuda.reset_peak_memory_stats()
        reset_counts()  # counts from here on are this path's
        times = []
        with torch.no_grad():
            for _ in range(1 + TIMED_CALLS):
                t = time.monotonic()
                logits = disc(x)
                torch.cuda.synchronize()
                times.append(time.monotonic() - t)
        forward_launches = k2.launches
        out["forward"] = {"call_s": times, "k2_launches": forward_launches,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        grad_times = []
        for _ in range(1 + GRAD_CALLS):
            xg = x.clone().requires_grad_(True)
            t = time.monotonic()
            grad, = torch.autograd.grad(disc(xg).sum(), xg)
            torch.cuda.synchronize()
            grad_times.append(time.monotonic() - t)
        grad_launches = k2.launches
        out["input_grad"] = {"call_s": grad_times, "k2_launches": grad_launches,
                             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        per = 2 * len(sites)
        if tuple(logits.shape) != (DISC_BATCH, 1) or not torch.isfinite(logits).all() \
                or not torch.isfinite(grad).all() or grad.shape != x.shape:
            raise RuntimeError(f"logits {tuple(logits.shape)}, gradient {tuple(grad.shape)}")
        if forward_launches != per * (1 + TIMED_CALLS) \
                or grad_launches != 2 * per * (1 + GRAD_CALLS):
            raise RuntimeError(f"K2 launched {forward_launches} times in {1 + TIMED_CALLS} "
                               f"forwards and {grad_launches} in {1 + GRAD_CALLS} input "
                               f"gradients, expected {per} and {2 * per} each")

        # converted from the reference's layout: the same logits
        t = time.monotonic()
        sd = discriminator_state_dict(to_jax_variables(disc)["params"], DISC_SIZE)
        loaded = Discriminator(DISC_SIZE, device=dev)
        from_jax_variables(convert_discriminator(sd, DISC_SIZE), loaded)
        out["conversion_s"] = time.monotonic() - t
        with torch.no_grad():
            err = (loaded(x) - logits).abs().max().item()
        # the same weights through the same kernels: equal up to cuDNN's
        # choice of algorithm
        tol = 1e-6 * max(1.0, logits.abs().max().item())
        out["converted"] = {"max_abs_err": err, "tol": tol, "keys": len(sd)}
        if not err <= tol:
            raise RuntimeError(f"the converted discriminator's logits differ by {err}")
        del disc, loaded, x, xg, grad, sd

        # a small one on the card against the CPU: logits and input gradient
        cpu_gen = torch.Generator().manual_seed(COMPETITOR_SEED)
        small = random_init_(Discriminator(DISC_SMALL, device="cpu"), cpu_gen,
                             init_stylegan_tensor_).requires_grad_(False)
        xs = torch.rand((DISC_BATCH, 3, DISC_SMALL, DISC_SMALL), generator=cpu_gen) * 2 - 1
        results = {}
        for where, model in (("cpu", small), ("cuda", copy.deepcopy(small).to(dev))):
            xw = xs.to(where).requires_grad_(True)
            y = model(xw)
            g, = torch.autograd.grad(y.sum(), xw)
            results[where] = (y.detach().cpu(), g.cpu())
        (want_y, want_g), (got_y, got_g) = results["cpu"], results["cuda"]
        errs = {"logits": ((got_y - want_y).abs().max() / want_y.abs().max()).item(),
                "input_grad": ((got_g - want_g).abs().max() / want_g.abs().max()).item()}
        out["small_gpu_vs_cpu"] = {"size": DISC_SMALL, **errs, "tol": PARITY_RTOL}
        if not all(math.isfinite(e) and e <= PARITY_RTOL for e in errs.values()):
            raise RuntimeError(f"the small discriminator on the card differs: {errs}")
        return out

    try:
        run_phase("competitor_steps", competitor_steps_phase)
        harness = run_phase("harness", harness_phase)
        run_phase("distributed", distributed_phase)
        torch.cuda.empty_cache()
        configs = run_phase("configs", configs_phase)
        alpha = run_phase("alpha_search", alpha_search_phase)
        # the competitors' CPU steps (phase competitor_steps) switch oneDNN
        # off and replay the A-VAE's branches process-wide: done before
        # train's CPU steps and the competitors' A-VAE
        wait([shared["competitor_cpu"]])
        train = run_phase("train", train_phase)
        torch.cuda.empty_cache()
        competitors = run_phase("competitors", competitors_phase)
        torch.cuda.empty_cache()
        train_competitors = run_phase("train_competitors", train_competitors_phase)
        torch.cuda.empty_cache()
        disc = run_phase("discriminator", discriminator_phase)
    finally:
        stop_ddp_ranks()
        shared.clear()
        scratch.cleanup()

    def mean_call_s(phase):
        return sum(phase["call_s"][1:]) / TIMED_CALLS

    def path_numbers(rows, launches, per, path, call_s):
        """A kernel's numbers on one path: per decode of its EoT batch, the
        sums over the launches at the path's shapes."""
        def weighted(key):
            return sum(r[key] * r["per_decode"] for r in rows)
        ms = weighted("kernel_ms")
        out = {"launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
               "ms": ms, "plain_ms": weighted("plain_ms"), "bound_ms": weighted("bound_ms"),
               "roofline_share": weighted("bound_ms") / ms,
               "bound_by": "bytes" if all(r.get("bound_by", "bytes") == "bytes" for r in rows)
               else "operations",
               "library_ms": weighted("library_ms"), "per": per,
               f"share_of_{path}_call": ms / 1e3 / call_s}
        if "copy_ms" in rows[0]:
            out["copy_ms"] = weighted("copy_ms")
        if "max_ulps" in rows[0]:
            out["max_ulps"] = max(r["max_ulps"] for r in rows)
        if "kernel_ms_bf16_weights" in rows[0]:
            out["ms_bf16_weights"] = weighted("kernel_ms_bf16_weights")
        if "mismatched" in rows[0]:
            out["mismatched"] = sum(r["mismatched"] for r in rows)
        return out

    def entry(name, dtype, source, replaces, library, **numbers):
        return {"name": name, "dtype": dtype, "route": "cuda",
                "source": f"gen_adversarial_tpu_torch/csrc/{source}.cu",
                "replaces": replaces, **numbers, "library": library}

    def per_decode(path, n):
        return (f"one decode of the {path} EoT-{EOT_STEPS} batch (N={n}): "
                "the sum over its launches")

    k2_gender = path_numbers(kernels2["shapes"], gender["k2_launches"],
                             per_decode("gender", n_gender), "gender", mean_call_s(gender))
    k2_cars = path_numbers(kernels2_cars["shapes"], cars_run["k2_launches"],
                           per_decode("cars", n_cars), "cars", mean_call_s(cars_run))
    k2_disc = path_numbers(disc["k2"]["pad_2"] + disc["k2"]["pad_1"],
                           disc["forward"]["k2_launches"],
                           f"one forward of the {DISC_SIZE}-px discriminator at batch "
                           f"{DISC_BATCH}: the sum over its launches", "discriminator",
                           mean_call_s(disc["forward"]))
    k1_16 = path_numbers(kernels16["k1"]["shapes"], run16["flagship"]["k1_launches"],
                         per_decode("ids", n), "flagship", mean_call_s(run16["flagship"]))
    k2_16_gender = path_numbers(kernels16["k2"]["shapes"], run16["gender"]["k2_launches"],
                                per_decode("gender", n_gender), "gender",
                                mean_call_s(run16["gender"]))
    k2_16_cars = path_numbers(kernels16["k2"]["cars_shapes"], run16["cars"]["k2_launches"],
                              per_decode("cars", n_cars), "cars", mean_call_s(run16["cars"]))

    def device_ms(path, busy, kernel_kind):
        """The kernel's device ms in one traced call of phase bf16 (one
        decode of the path's EoT batch)."""
        by_kind = run16[path][busy].get("by_kind_s")
        return 1e3 * by_kind.get(kernel_kind, 0.0) if by_kind else "not measured"
    emit({"kernels": [
        entry("depthwise_silu_segment", "float32", k1.SOURCE,
              "gen_adversarial_tpu/ops/pallas_depthwise.py:87",
              "torch.nn.functional.conv2d(groups=C), the depthwise only",
              **path_numbers(kernels["shapes"], flag["k1_launches"], per_decode("ids", n),
                             "flagship", mean_call_s(flag)),
              device_ms=device_ms("flagship", "busy_f32", "k1_depthwise_segment"),
              # launches in the attack phases (forwards, and recomputes under remat)
              attack_launches={"attacks_parity": attack_parity["k1_launches"],
                               "attack_flagship": attack_flag["k1_launches"],
                               "harness": harness["k1_launches"],
                               "harness_autoattack": harness["autoattack"]["k1_launches"],
                               "configs": sum(configs[c]["k1_launches"] for c in PHASE_CONFIGS)
                               + configs["deepfool_step"]["k1_launches"],
                               "alpha_search": alpha["k1_launches"],
                               "train": train["k1_launches"]}),
        # the top-level numbers are the gender path's; `launches` and
        # `max_abs_err` cover the three paths, `cars` and `discriminator`
        # hold the other two's (the discriminator's blurs at pads (2, 2)
        # and (1, 1), the library call at the same padding)
        entry("upfirdn_blur", "float32", k2.SOURCE,
              "gen_adversarial_tpu/ops/pallas_upfirdn.py:115",
              "torch.nn.functional.conv2d(outer(kf, kf), padding=pad, groups=C)",
              **{**k2_gender, "launches": k2_gender["launches"] + k2_cars["launches"]
                 + k2_disc["launches"],
                 "max_abs_err": max(k2_gender["max_abs_err"], k2_cars["max_abs_err"],
                                    k2_disc["max_abs_err"])},
              launches_by_path={"gender": k2_gender["launches"],
                                "cars": k2_cars["launches"],
                                "discriminator": k2_disc["launches"]},
              device_ms=device_ms("gender", "busy_f32", "k2_upfirdn_blur"),
              cars=k2_cars, discriminator=k2_disc,
              # launches in phase attack_remat (forward, recompute and
              # backward) and in the discriminator's input gradients
              attack_launches={
                  "gender_apgd_ce": attack_rm["gender_apgd_ce"]["k2_launches"],
                  "cars_input_grad": attack_rm["cars_input_grad"]["k2_launches"],
                  "discriminator_input_grad": disc["input_grad"]["k2_launches"]}),
        # the bfloat16 builds: launches in phase bf16
        # (the three forwards) and attack_bf16; times at the flagship's,
        # gender's and cars' shapes; K1's `ms` with the float32 weights the
        # decoder cells hand it, `ms_bf16_weights` with the wrapper's casts
        entry("depthwise_silu_segment", "bfloat16", k1.SOURCE,
              "gen_adversarial_tpu/ops/pallas_depthwise.py:87",
              "torch.nn.functional.conv2d(groups=C) in bfloat16, the depthwise only",
              **k1_16, device_ms=device_ms("flagship", "busy_bf16", "k1_depthwise_segment"),
              attack_launches={
                  "flagship_apgd_ce": attack16["flagship_apgd_ce"]["k1_launches"]}),
        # the top-level numbers are the gender path's; `launches` and
        # `max_abs_err` cover both paths, and `cars` holds the cars path's
        entry("upfirdn_blur", "bfloat16", k2.SOURCE,
              "gen_adversarial_tpu/ops/pallas_upfirdn.py:115",
              "torch.nn.functional.conv2d(outer(kf, kf), padding=1, groups=C) in bfloat16",
              **{**k2_16_gender, "launches": k2_16_gender["launches"] + k2_16_cars["launches"],
                 "max_abs_err": max(k2_16_gender["max_abs_err"], k2_16_cars["max_abs_err"])},
              launches_by_path={"gender": k2_16_gender["launches"],
                                "cars": k2_16_cars["launches"]},
              device_ms=device_ms("gender", "busy_bf16", "k2_upfirdn_blur"),
              device_ms_cars=device_ms("cars", "busy_bf16", "k2_upfirdn_blur"),
              cars=k2_16_cars,
              attack_launches={"gender_apgd_ce": attack16["gender_apgd_ce"]["k2_launches"]}),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["ddp-worker"]:  # one rank of phase `distributed`
        sys.exit(ddp_worker(*sys.argv[2:]))
    sys.exit(main())
