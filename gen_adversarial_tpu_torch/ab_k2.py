"""A/B of versions of the StyleGAN2 blur kernel (K2) on one CUDA card.

    python3 -m gen_adversarial_tpu_torch.ab_k2 [--dtype bfloat16] NAME=SOURCE ...

Each variant is a CUDA source with K2's C interface: `csrc/upfirdn_blur.cu`,
an earlier commit's version of it from `git show`, or an edited copy, built
by nvcc with the port's flags (one nvcc each, all at once) into `_build/ab/`.
Every variant is first checked at each blur site of the gender (1024-px
generator), cars (512-px) and discriminator (1024-px, pads (2, 2) and (1, 1))
paths at N = 2 and at ragged shapes (widths and an x 4 bytes past 16-byte
alignment that take the masked path, partial channel tiles, negative pads,
3 taps): against the plain version
(`ops/upfirdn.blur_plain`), bit-identical in bfloat16 and within
chip_smoke.py's K2 tolerance in float32, and bit for bit against the first
variant named (give it the source a change must not alter). Then each site
is timed at its path's batch (gender N = 64 and cars N = 128, the folded
EoT-32 batches; the discriminator N = 4), where the outputs are held bit
for bit against the first variant's once more:

- `ms`: CUDA events over launches from Python, the variants in turns
  (A B .. B A, twice), the best of the four;
- `graph_ms`: the same launches replayed from one CUDA graph, the device's
  time with no host in the way;
- `wrapper_ms`: the public `ops/upfirdn.upfirdn_blur` (the package's own
  build, no autograd recording) timed as `ms`. At the discriminator's sites,
  where the host sets the time, it is taken in PAIR_ROUNDS rounds of A B B A
  against the library call `F.conv2d(outer(kf, kf), padding=pad, groups=C)`
  (`library_ms`; at the generators' sites it costs seconds): each the median
  over the rounds of its ms a call, and `wrapper_wins` the share of rounds in
  which the wrapper took no longer than the library call.

One JSON line a variant (its build), one a site, one of the wrapper's host
costs a call and its parts at each of the discriminator's 8-px sites
(`host_us`), and per path the sums over a decode's or a forward's sites.
The card's name and power limit come first.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from gen_adversarial_tpu_torch.ab_k1 import build, cuda_ms, graph_ms, host_us
from gen_adversarial_tpu_torch.models.stylegan2.generator import (
    GENERATOR_CHANNELS,
    generator_channels,
)
from gen_adversarial_tpu_torch.models.stylegan2.layers import BLUR_KERNEL
from gen_adversarial_tpu_torch.ops import upfirdn as k2

TAPS = tuple(2.0 * t / sum(BLUR_KERNEL) for t in BLUR_KERNEL)  # the up-conv blur
DISC_TAPS = tuple(t / sum(BLUR_KERNEL) for t in BLUR_KERNEL)  # the discriminator's
PAD = (1, 1)
ASYM3 = (1 / 7, 2 / 7, 4 / 7)
# (shape, pad, taps, storage offset in elements) off the paths: C % 4 != 0
# and x off 16-byte alignment (the masked path), partial channel tiles,
# negative pads, 3 taps
RAGGED = [((2, 3, 9, 9), (1, 1), TAPS, 0), ((1, 45, 20, 37), (2, 2), TAPS, 0),
          ((1, 72, 31, 70), (-1, 2), TAPS, 0), ((2, 36, 17, 40), (2, 2), ASYM3, 0),
          ((1, 96, 33, 9), (0, -1), ASYM3, 0), ((2, 32, 33, 33), (1, 1), TAPS, 1),
          ((1, 35, 19, 21), (-1, 2), ASYM3, 1)]
TOL = 1e-5  # x max(1, max |plain|): chip_smoke.py's K2_TOL
DISC_SIZE, DISC_N = 1024, 4
PAIR_ROUNDS = 50
HOST_REPS = 500


def sites(size: int) -> list[tuple[int, int]]:
    """(C, H_in) of the blur after each up-convolution up to `size` px."""
    return [(GENERATOR_CHANNELS[r], r + 1) for r in (2 ** i for i in range(3, 11)) if r <= size]


def disc_sites() -> list[tuple[int, int, tuple, tuple]]:
    """(C, H_in, pad, taps) of the 1024-px discriminator's 16 blurs: each
    ResBlock at resolution r blurs its conv1 output (pad (2, 2)) and its
    input (pad (1, 1)), both at r x r with the channels of r."""
    ch = generator_channels(2)
    res = [2 ** i for i in range(10, 2, -1)]
    return [(ch[r], r, pad, DISC_TAPS) for pad in ((2, 2), (1, 1)) for r in res]


# (path, N, sites as (C, H_in, pad, taps))
PATHS = [("gender", 64, [(c, h, PAD, TAPS) for c, h in sites(1024)]),
         ("cars", 128, [(c, h, PAD, TAPS) for c, h in sites(512)]),
         ("discriminator", DISC_N, disc_sites())]


def host_costs(x, taps, pad, reps=HOST_REPS) -> dict:
    """The wrapper's host time a call and its parts, in microseconds, each
    over `reps` calls."""
    lib = k2._lib()
    y = k2._launch(x, taps, pad)
    fn = getattr(lib, k2.ENTRY[x.dtype])
    host_taps = k2._host_taps[taps]
    device = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    n, c, h, w = x.shape
    xg = x.detach().clone().requires_grad_()
    weight = library_weight(x, taps)
    return {
        "upfirdn_blur": host_us(lambda: k2.upfirdn_blur(x, taps, pad), reps),
        "upfirdn_blur_recorded": host_us(lambda: k2.upfirdn_blur(xg, taps, pad), reps),
        "launch": host_us(lambda: k2._launch(x, taps, pad), reps),
        "check": host_us(lambda: k2._check(x, taps, pad), reps),
        "c_call": host_us(lambda: fn(x.data_ptr(), y.data_ptr(), n, h, w, c, pad[0], pad[1],
                                     host_taps, len(taps), device, stream), reps),
        "library": host_us(lambda: F.conv2d(x, weight, padding=pad[0], groups=c), reps)}


def paired_ms(fa, fb, rounds=PAIR_ROUNDS) -> tuple[float, float, float]:
    """fa against fb in `rounds` rounds of A B B A: the median over the
    rounds of each one's ms a call, and the share of rounds in which fa took
    no longer than fb."""
    a, b = [], []
    for _ in range(rounds):
        ta, tb = cuda_ms(fa, warmup=1), cuda_ms(fb, warmup=1)
        tb, ta = (tb + cuda_ms(fb, warmup=1)) / 2, (ta + cuda_ms(fa, warmup=1)) / 2
        a.append(ta)
        b.append(tb)
    return statistics.median(a), statistics.median(b), sum(p <= q for p, q in zip(a, b)) / rounds


def library_weight(x, taps):
    kf = torch.tensor(taps[::-1], device=x.device, dtype=x.dtype)
    return torch.outer(kf, kf).expand(x.shape[1], 1, len(taps), len(taps)).contiguous()


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
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    print(smi, flush=True)
    libs = build(variants, k2.declare)
    first = next(iter(libs))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(n, c, h, w, offset=0):
        """Random channels_last x whose storage starts `offset` elements in."""
        flat = torch.randn(offset + n * h * w * c, device="cuda", generator=gen).to(dtype)
        return flat[offset:].view(n, h, w, c).permute(0, 3, 1, 2)

    failed = {}  # variant -> why it was dropped from the timings

    def outputs(x, taps, pad) -> dict:
        """Each variant's output; a variant that is not bit-identical to the
        first's is dropped."""
        got = {}
        for name, lib in list(libs.items()):
            try:
                got[name] = k2._launch(x, taps, pad, lib=lib)
                torch.cuda.synchronize()
            except RuntimeError as e:
                if name == first:
                    raise
                failed[name] = f"at {tuple(x.shape)}, pad {pad}: {e}"
                del libs[name]
        for name, y in got.items():
            if not torch.equal(y, got[first]):
                err = (y.float() - got[first].float()).abs().max().item()
                failed[name] = (f"not bit-identical to {first} at {tuple(x.shape)}, pad {pad}, "
                                f"taps {len(taps)}: max abs difference {err}")
                del libs[name]
        return {name: got[name] for name in libs}

    checks = ([((2, c, h, h), pad, taps, 0) for _, _, path in PATHS for c, h, pad, taps in path]
              + RAGGED)
    for shape, pad, taps, offset in checks:
        x = inputs(*shape, offset=offset)
        plain = k2.blur_plain(x, taps, pad)
        for name, got in outputs(x, taps, pad).items():
            err = (got.float() - plain.float()).abs().max().item()
            ok = (torch.equal(got, plain) if dtype == torch.bfloat16
                  else err <= TOL * max(1.0, plain.abs().max().item()))
            if not ok:
                if name == first:
                    raise RuntimeError(f"{first} disagrees with the plain version at {shape}, "
                                       f"pad {pad}: max abs err {err}")
                failed[name] = f"disagrees with the plain version at {shape}, pad {pad}: {err}"
                libs.pop(name, None)
    print(json.dumps({"checked": len(checks), "bit_identical_to": first, "kept": list(libs),
                      "failed": failed}), flush=True)

    summary = {"card": smi, "dtype": str(dtype)}
    for path, n, path_sites in PATHS:
        rows = []
        for c, h, pad, taps in path_sites:
            x = inputs(n, c, h, h)
            outputs(x, taps, pad)
            torch.cuda.empty_cache()
            launch = {name: (lambda lib=lib: k2._launch(x, taps, pad, lib=lib))
                      for name, lib in libs.items()}
            times = {name: [] for name in libs}
            for name in (list(libs) + list(libs)[::-1]) * 2:  # A B .. B A, twice
                times[name].append(cuda_ms(launch[name]))
            out = k2.out_size(h, len(taps), pad)
            bound_ms = 1e3 * (x.numel() + n * c * out * out) * x.element_size() / 3.35e12
            row = {"path": path, "C": c, "H_in": h, "N": n, "pad": list(pad), "dtype": str(dtype),
                   "bound_ms": bound_ms, "ms": {name: min(t) for name, t in times.items()},
                   "graph_ms": {name: graph_ms(fn) for name, fn in launch.items()}}
            if path == "discriminator":
                weight = library_weight(x, taps)
                row["wrapper_ms"], row["library_ms"], row["wrapper_wins"] = paired_ms(
                    lambda: k2.upfirdn_blur(x, taps, pad),
                    lambda: F.conv2d(x, weight, padding=pad[0], groups=c))
            else:
                row["wrapper_ms"] = cuda_ms(lambda: k2.upfirdn_blur(x, taps, pad))
            rows.append(row)
            print(json.dumps(row), flush=True)
            del x, launch
            torch.cuda.empty_cache()
        summary[path] = {"bound_ms": sum(r["bound_ms"] for r in rows),
                         "wrapper_ms": sum(r["wrapper_ms"] for r in rows),
                         **{key: {name: sum(r[key][name] for r in rows) for name in libs}
                            for key in ("ms", "graph_ms")}}
    for c, h, pad, taps in PATHS[2][2][7::8]:  # the discriminator's two 8-px sites
        print(json.dumps({"host_us": host_costs(inputs(DISC_N, c, h, h), taps, pad),
                          "C": c, "H_in": h, "N": DISC_N, "pad": list(pad)}), flush=True)
    summary["failed"] = failed
    print(json.dumps(summary), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
