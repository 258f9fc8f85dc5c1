"""A/B of versions of the StyleGAN2 blur kernel (K2) on one CUDA card.

    python3 -m gen_adversarial_tpu_torch.ab_k2 [--dtype bfloat16] NAME=SOURCE ...

Each variant is a CUDA source with K2's C interface: `csrc/upfirdn_blur.cu`,
an earlier commit's version of it from `git show`, or an edited copy, built
by nvcc with the port's flags (one nvcc each, all at once) into `_build/ab/`.
Every variant is first held against the plain version (`ops/upfirdn.blur_plain`)
at each blur site of the gender (1024-px generator) and cars (512-px) paths
at N = 2 and at ragged shapes: bit-identical in bfloat16, within
chip_smoke.py's K2 tolerance in float32. Then each site is timed at its
path's folded EoT-32 batch (gender N = 64, cars N = 128) with CUDA events,
the variants in turns (A B .. B A, twice), the best of the four kept. One
JSON line a variant (its build), one a site, and per path the sums over a
decode's sites. The card's name and power limit come first.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from gen_adversarial_tpu_torch.ab_k1 import build, cuda_ms
from gen_adversarial_tpu_torch.models.stylegan2.generator import GENERATOR_CHANNELS
from gen_adversarial_tpu_torch.models.stylegan2.layers import BLUR_KERNEL
from gen_adversarial_tpu_torch.ops import upfirdn as k2

TAPS = tuple(2.0 * t / sum(BLUR_KERNEL) for t in BLUR_KERNEL)  # the up-conv blur
PAD = (1, 1)
# (path, N, generator output size): the folded EoT-32 batches
PATHS = [("gender", 64, 1024), ("cars", 128, 512)]
RAGGED = [((2, 3, 9, 9), (1, 1)), ((1, 45, 20, 37), (2, 2)), ((1, 72, 31, 70), (-1, 2))]
TOL = 1e-5  # x max(1, max |plain|): chip_smoke.py's K2_TOL


def sites(size: int) -> list[tuple[int, int]]:
    """(C, H_in) of the blur after each up-convolution up to `size` px."""
    return [(GENERATOR_CHANNELS[r], r + 1) for r in (2 ** i for i in range(3, 11)) if r <= size]


def main(argv) -> int:
    dtype = torch.float32
    if argv[:1] == ["--dtype"]:
        dtype, argv = getattr(torch, argv[1]), argv[2:]
    variants = {name: Path(src) for name, _, src in (a.partition("=") for a in argv)}
    if not variants:
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        print("ab_k2: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    print(smi, flush=True)
    libs = build(variants, k2.declare)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(n, c, h, w):
        return torch.randn(n, c, h, w, device="cuda", generator=gen).to(dtype).contiguous(
            memory_format=torch.channels_last)

    checks = [((2, c, h, h), PAD) for c, h in sites(1024)] + RAGGED
    for shape, pad in checks:
        x = inputs(*shape)
        plain = k2.blur_plain(x, TAPS, pad)
        for name, lib in libs.items():
            got = k2._launch(x, TAPS, pad, lib=lib)
            err = (got.float() - plain.float()).abs().max().item()
            ok = (torch.equal(got, plain) if dtype == torch.bfloat16
                  else err <= TOL * max(1.0, plain.abs().max().item()))
            if not ok:
                raise RuntimeError(f"{name} disagrees with the plain version at {shape}, pad "
                                   f"{pad}, in {dtype}: max abs err {err}")

    summary = {"card": smi, "dtype": str(dtype)}
    for path, n, size in PATHS:
        rows = []
        for c, h in sites(size):
            x = inputs(n, c, h, h)
            launch = {name: (lambda lib=lib: k2._launch(x, TAPS, PAD, lib=lib))
                      for name, lib in libs.items()}
            times = {name: [] for name in libs}
            for name in (list(libs) + list(libs)[::-1]) * 2:  # A B .. B A, twice
                times[name].append(cuda_ms(launch[name]))
            out = k2.out_size(h, len(TAPS), PAD)
            bound_ms = 1e3 * (x.numel() + n * c * out * out) * x.element_size() / 3.35e12
            row = {"path": path, "C": c, "H_in": h, "N": n, "dtype": str(dtype),
                   "bound_ms": bound_ms, "ms": {name: min(t) for name, t in times.items()}}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del x, launch
            torch.cuda.empty_cache()
        summary[path] = {"bound_ms": sum(r["bound_ms"] for r in rows),
                         "ms": {name: sum(r["ms"][name] for r in rows) for name in libs}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
