"""A/B of versions of the decoder segment kernel (K1) on one CUDA card.

    python3 -m gen_adversarial_tpu_torch.ab_k1 [--dtype bfloat16] NAME=SOURCE ...

Each variant is a CUDA source with K1's C interface: `csrc/depthwise_segment.cu`,
an earlier commit's version of it from `git show`, or an edited copy of it
(another tile, stage count or store path), all built by nvcc with the port's
flags (one nvcc each, all at once) into `_build/ab/`. Every variant is first
held against the plain version (`ops/depthwise.depthwise_silu_segment_plain`)
at the flagship's decoder shapes at N = 4 and at ragged shapes, with
chip_smoke.py's tolerance (in bfloat16: within one bfloat16 spacing or that
absolute tolerance); then each shape of a flagship decode (N = 128) is
timed with CUDA events, the variants in turns (A B .. B A, twice), and the
best of the four is kept (`ms`: launches from Python, as a caller makes
them); beside it `graph_ms`, the same launches replayed from a CUDA graph
(device time with no host in the way), `host_us`, the host time to issue one
launch, and `wrapper_host_us`, the same through the public
`ops/depthwise.depthwise_silu_segment` (the package's own build). Per-decode
sums of `ms` and `graph_ms` close it. Prints the card's name and power limit
first, then one JSON line a variant (its build), one a shape and the summary.
`--dtype` is x's and y's (float32 by default); the taps and affines are
float32 in both, as the decoder cells hand them to the kernel.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import torch

from gen_adversarial_tpu_torch.core import cuda_build
from gen_adversarial_tpu_torch.flagship import FLAGSHIP_NVAE
from gen_adversarial_tpu_torch.ops import depthwise as k1

RAGGED = [(1, 40, 13, 5), (3, 40, 13, 29), (5, 48, 17, 33), (1, 96, 64, 64)]
N = 128  # the folded EoT-32 x batch 4
TOL = 1e-5  # x max(1, max |plain|): chip_smoke.py's K1_TOL
REPS = 20


def build(variants: dict[str, Path], declare=k1.declare):
    """Each variant built by nvcc (all at once), loaded and `declare`d."""
    out_dir = cuda_build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.find_nvcc()
    jobs = {name: (subprocess.Popen([nvcc, *cuda_build.NVCC_FLAGS, "-o",
                                     str(out_dir / f"lib{name}.so"), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                   out_dir / f"lib{name}.so")
            for name, src in variants.items()}
    libs = {}
    for name, (proc, so) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}{err}")
        print(json.dumps({"variant": name, "source": str(variants[name]),
                          **cuda_build.ptxas_summary(out + err)}), flush=True)
        libs[name] = declare(ctypes.CDLL(str(so)))
    return libs


def cuda_ms(fn, reps=REPS, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=REPS) -> float:
    """Device time a call of `fn` with no host in the way: `reps` calls
    captured in one CUDA graph, replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps=REPS) -> float:
    """Host time to issue one call of `fn` (the device may lag behind)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t
    torch.cuda.synchronize()
    return elapsed / reps * 1e6


def agrees(got, want, dtype) -> tuple[bool, float]:
    """(within chip_smoke.py's tolerance, max abs err)."""
    d = (got.float() - want.float()).abs()
    tol = TOL * max(1.0, want.abs().max().item())
    if dtype == torch.float32:
        return d.max().item() <= tol, d.max().item()  # NaN fails too
    spacing = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp(min=1e-30))) - 7)
    return not ((d > spacing) & (d > tol)).any().item(), d.max().item()


def main(argv) -> int:
    dtype = torch.float32
    if argv[:1] == ["--dtype"]:
        dtype, argv = getattr(torch, argv[1]), argv[2:]
    variants = {name: Path(src) for name, _, src in (a.partition("=") for a in argv)}
    if not variants:
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        print("ab_k1: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    print(smi, flush=True)
    libs = build(variants)
    shapes = Counter(FLAGSHIP_NVAE.decoder_segment_shapes())  # (C, H) -> launches a decode
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(n, c, h, w):
        x = torch.randn(n, c, h, w, device="cuda", generator=gen).to(dtype).contiguous(
            memory_format=torch.channels_last)
        taps = torch.randn(5, 5, c, device="cuda", generator=gen) * 0.2
        aff = [torch.randn(c, device="cuda", generator=gen) * 0.5 + 1 for _ in range(4)]
        return x, taps, aff

    for shape in [(4, c, h, h) for c, h in shapes] + RAGGED:
        x, taps, aff = inputs(*shape)
        plain = k1.depthwise_silu_segment_plain(x, taps, *aff)
        for name, lib in libs.items():
            ok, err = agrees(k1._launch(x, taps, *aff, lib=lib), plain, dtype)
            if not ok:
                raise RuntimeError(f"{name} disagrees with the plain version at {shape} in "
                                   f"{dtype}: max abs err {err}")

    rows = []
    for (c, h), per_decode in shapes.items():
        x, taps, aff = inputs(N, c, h, h)
        launch = {name: (lambda lib=lib: k1._launch(x, taps, *aff, lib=lib))
                  for name, lib in libs.items()}
        times = {name: [] for name in libs}
        for name in (list(libs) + list(libs)[::-1]) * 2:  # A B .. B A, twice
            times[name].append(cuda_ms(launch[name]))
        row = {"C": c, "H": h, "N": N, "dtype": str(dtype), "per_decode": per_decode,
               "ms": {name: min(t) for name, t in times.items()},
               "graph_ms": {name: graph_ms(fn) for name, fn in launch.items()},
               "host_us": {name: host_us(fn) for name, fn in launch.items()},
               "wrapper_host_us": host_us(lambda: k1.depthwise_silu_segment(x, taps, *aff))}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, launch
    print(json.dumps({"card": smi, "dtype": str(dtype), **{key: {
        name: sum(r[key][name] * r["per_decode"] for r in rows) for name in libs}
        for key in ("ms", "graph_ms")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
