"""The attack benchmark over a folder dataset (counterpart of
gen_adversarial_tpu/eval/harness.py):

- results land in <results_folder>/results.json in the JAX package's schema:
  'Clean' accuracy and one per-image minimal-L2 list per attack
  (ATTACK_JSON_NAMES), 100.0 where the attack found no adversary; a rerun
  of one attack merges into the file (`_merge_results`);
- the images run in batches of batch_size on the defense's device; a ragged
  last batch is padded by repeating rows and the padding is trimmed from
  the results;
- every fifth image gets a PNG of original / adversarial / purified with
  red / green success borders and the L2 bound in a title strip;
- per-batch resume: progress_p<pid>.json holds the results of the finished
  batches under a fingerprint of the run's setup, and a rerun of the same
  setup continues after them;
- data parallel (distributed=True in a torchrun process group,
  core/distributed.py): each rank runs its round-robin shard of the images
  (`iterate_batches(shard=...)`, the reference's DistributedSampler) and
  keeps its own progress file; the per-image lists are gathered in rank
  order (the reference's all_gather + cat), and rank 0 alone writes the
  plots and results.json, before a barrier that all ranks pass.

Random draws: each batch's clean predictions and each attack on it draw
from a generator on the device seeded from
`np.random.SeedSequence((seed, pid, batch index, stage))`, stage 0 for the
clean predictions and 1 + the attack's index in KNOWN_ATTACKS for an attack
(its plots' purify continues that attack's generator). A batch's results
depend on nothing that ran before it, so a resumed run equals an
uninterrupted one by construction. AutoAttack always runs as the staged
ensemble (attacks/autoattack.make_staged_autoattack), which equals the
monolithic one.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from gen_adversarial_tpu_torch.attacks import make_staged_autoattack
from gen_adversarial_tpu_torch.core.distributed import (
    allgather_lists, check_n_devices, data_parallel_shard)
from gen_adversarial_tpu_torch.data import png
from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset, iterate_batches
from gen_adversarial_tpu_torch.eval.factory import LoadedDefense
from gen_adversarial_tpu_torch.models.nvae.distributions import position_generator

KNOWN_ATTACKS = ("deepfool", "c&w", "autoattack")
ATTACK_JSON_NAMES = {"deepfool": "DeepFool", "c&w": "C&W", "autoattack": "AutoAttack"}
TITLE_STRIP = 14  # pixels above the tiles

# a 5 x 7 bitmap font for the plot's title where PIL is not installed: every
# character of "original, adversarial [L2=<bound>], cleaned" (bound 'inf'
# or 'nan' included), each row 5 bits, left to right
_GLYPHS = {
    "0": "01110 10001 10011 10101 11001 10001 01110",
    "1": "00100 01100 00100 00100 00100 00100 01110",
    "2": "01110 10001 00001 00010 00100 01000 11111",
    "3": "11111 00010 00100 00010 00001 10001 01110",
    "4": "00010 00110 01010 10010 11111 00010 00010",
    "5": "11111 10000 11110 00001 00001 10001 01110",
    "6": "00110 01000 10000 11110 10001 10001 01110",
    "7": "11111 00001 00010 00100 01000 01000 01000",
    "8": "01110 10001 10001 01110 10001 10001 01110",
    "9": "01110 10001 10001 01111 00001 00010 01100",
    "L": "10000 10000 10000 10000 10000 10000 11111",
    "a": "00000 00000 01110 00001 01111 10001 01111",
    "c": "00000 00000 01110 10000 10000 10001 01110",
    "d": "00001 00001 01101 10011 10001 10001 01111",
    "e": "00000 00000 01110 10001 11111 10000 01110",
    "f": "00110 01001 01000 11100 01000 01000 01000",
    "g": "00000 01111 10001 10001 01111 00001 01110",
    "i": "00100 00000 01100 00100 00100 00100 01110",
    "l": "01100 00100 00100 00100 00100 00100 01110",
    "n": "00000 00000 10110 11001 10001 10001 10001",
    "o": "00000 00000 01110 10001 10001 10001 01110",
    "r": "00000 00000 10110 11001 10000 10000 10000",
    "s": "00000 00000 01110 10000 01110 00001 11110",
    "v": "00000 00000 10001 10001 10001 01010 00100",
    ",": "00000 00000 00000 00000 01100 00100 01000",
    ".": "00000 00000 00000 00000 00000 01100 01100",
    "[": "01110 01000 01000 01000 01000 01000 01110",
    "]": "01110 00010 00010 00010 00010 00010 01110",
    "=": "00000 00000 11111 00000 11111 00000 00000",
    "-": "00000 00000 00000 11111 00000 00000 00000",
    " ": "00000 00000 00000 00000 00000 00000 00000",
}


def _draw_bitmap_text(canvas: np.ndarray, text: str, x: int, y: int) -> None:
    """White 5 x 7 glyphs into an (H, W, 3) uint8 canvas, 6 px apart,
    clipped at its right edge."""
    for ch in text:
        rows = _GLYPHS.get(ch)
        if rows is None:
            raise ValueError(f"the plot's bitmap font has no glyph for {ch!r}")
        glyph = np.array([[bit == "1" for bit in row] for row in rows.split()])
        region = canvas[y:y + 7, x:x + 5]
        region[glyph[:region.shape[0], :region.shape[1]]] = 255
        x += 6


def _pad_border(img: np.ndarray, success: bool | None, pad: int) -> np.ndarray:
    """The tile with a white (None), red (attack succeeded) or green border."""
    h, w, c = img.shape
    if success is None:
        color = np.array([1.0, 1.0, 1.0])
    elif success:
        color = np.array([1.0, 0.0, 0.0])
    else:
        color = np.array([0.0, 1.0, 0.0])
    out = np.tile(color, (h + 2 * pad, w + 2 * pad, 1)).astype(np.float32)
    out[pad:-pad, pad:-pad] = img
    return out


def save_example_plot(path: Path, original: np.ndarray, adversarial: np.ndarray,
                      purified: np.ndarray, success: bool, bound: float) -> None:
    """One row [original | adversarial | purified] of bordered tiles under a
    black title strip with the attack's L2 bound, as a PNG. The title is
    drawn by PIL's ImageDraw where PIL is installed, else in a bitmap font."""
    pad = int(np.log2(original.shape[0]))
    row = np.concatenate([
        _pad_border(original, None, pad),
        _pad_border(np.clip(adversarial, 0, 1), True, pad),
        _pad_border(np.clip(purified, 0, 1), bool(success), pad)], axis=1)
    tiles = (row * 255).astype(np.uint8)
    canvas = np.zeros((tiles.shape[0] + TITLE_STRIP,) + tiles.shape[1:], np.uint8)
    canvas[TITLE_STRIP:] = tiles
    title = f"original, adversarial [L2={bound:.2f}], cleaned"
    try:
        from PIL import Image, ImageDraw
    except ImportError:
        _draw_bitmap_text(canvas, title, 2, 2)
    else:
        img = Image.fromarray(canvas)
        ImageDraw.Draw(img).text((2, 2), title, fill="white")
        canvas = np.asarray(img)
    png.write(path, canvas)


def batch_generator(seed: int, pid: int, batch_index: int, stage: int,
                    device: torch.device) -> torch.Generator:
    """The generator of one stage of one batch (see the module docstring)."""
    return position_generator(device, seed, pid, batch_index, stage)


def run_benchmark(loaded: LoadedDefense, images_path: str, results_folder: str,
                  batch_size: int = 8, seed: int = 42,
                  attack_filter: str | None = None, max_images: int | None = None,
                  plots: bool = True, log_fn=print,
                  n_devices: int | None = None,
                  distributed: bool = False,
                  resume: bool = True) -> dict:
    """The benchmark over a folder dataset; returns and writes results.json.

    With resume=True (default), the results of every finished batch are
    written to results_folder/progress_p<pid>.json, and a rerun with the same
    setup (the fingerprint) continues from the first unfinished batch; the
    finished run removes the file and merges into results.json.

    distributed=True runs this rank's shard of the process group (see the
    module); every rank returns the gathered results. n_devices > 1 raises:
    the port's data parallelism is one process per GPU."""
    check_n_devices(n_devices, "gen_adversarial_tpu_torch.cli.test_defense")
    pid, pcount = data_parallel_shard(distributed, "eval.harness.run_benchmark")
    dataset = ImageLabelDataset(images_path, loaded.image_size)
    results_folder = Path(results_folder)
    plots_folder = results_folder / "plots"
    device = loaded.device

    if attack_filter is not None and attack_filter not in KNOWN_ATTACKS:
        raise ValueError(f"unknown attack_filter {attack_filter!r}; "
                         f"expected one of {KNOWN_ATTACKS}")
    attack_names = [a for a in KNOWN_ATTACKS if attack_filter is None or a == attack_filter]
    attacks = {name: loaded.attacks[name] for name in attack_names}
    if "autoattack" in attacks:
        attacks["autoattack"] = make_staged_autoattack(**attacks["autoattack"].keywords)
    net = loaded.net

    clean_correct: list = []
    distortions = {name: [] for name in attack_names}
    n_seen = 0
    # the cap is global: this rank sees its round-robin share of the first
    # max_images images
    if max_images is not None:
        max_images = len(range(pid, max_images, pcount))
    plots = plots and pid == 0

    # anything that changes the batches or their draws invalidates the file
    progress_path = results_folder / f"progress_p{pid}.json"
    fingerprint = {"seed": seed, "batch_size": batch_size,
                   "attacks": list(attack_names), "max_images": max_images,
                   "pid": pid, "pcount": pcount, "n_images": len(dataset),
                   "eot_steps": loaded.eot_steps,
                   "defense_type": loaded.defense_type,
                   "experiment": loaded.experiment,
                   "eot_chunk": loaded.eot_chunk, "dtype": loaded.dtype,
                   "n_devices": n_devices, "backend": "torch"}
    resume_n_seen = 0
    if resume and progress_path.exists():
        try:
            prog = json.loads(progress_path.read_text())
        except (json.JSONDecodeError, OSError):
            prog = None
        if prog and prog.get("fingerprint") == fingerprint:
            resume_n_seen = int(prog["n_seen"])
            clean_correct = list(prog["clean_correct"])
            distortions = {n: list(prog["distortions"][n]) for n in attack_names}
            log_fn(f"[resume] continuing from image {resume_n_seen} "
                   f"({progress_path.name})")
        elif prog is not None:
            log_fn("[resume] progress file does not match this run's setup; "
                   "restarting from scratch")

    for batch_index, batch in enumerate(iterate_batches(dataset, batch_size, drop_last=False,
                                                        shard=(pid, pcount))):
        if max_images is not None and n_seen >= max_images:
            break
        x = np.clip(np.asarray(batch["image"]), 0.0, 1.0)
        y = np.asarray(batch["label"])
        if max_images is not None and n_seen + x.shape[0] > max_images:
            x = x[: max_images - n_seen]
            y = y[: max_images - n_seen]
        b = x.shape[0]
        if n_seen + b <= resume_n_seen:  # this batch's results are in the file
            n_seen += b
            continue
        # the ragged last batch padded to batch_size (the padding is trimmed)
        if b < batch_size:
            reps = np.concatenate([np.arange(b), np.zeros(batch_size - b, int)])
            x, y = x[reps], y[reps]
        x = torch.from_numpy(x).to(device)
        y = torch.from_numpy(y.astype(np.int64)).to(device)

        with torch.no_grad():
            preds = net(x, batch_generator(seed, pid, batch_index, 0, device)).argmax(1)
        clean_correct.extend((preds == y).cpu().numpy()[:b].tolist())

        for name in attack_names:
            generator = batch_generator(seed, pid, batch_index,
                                        1 + KNOWN_ATTACKS.index(name), device)
            t0 = time.time()
            succ, bound, adv = attacks[name](net, x, y, generator)[:3]
            succ, bound = succ.cpu().numpy()[:b], bound.float().cpu().numpy()[:b]
            med = (float(np.nanmedian(np.where(succ, bound, np.nan)))
                   if succ.any() else float("nan"))
            log_fn(f"[{name}] batch of {b}: {succ.sum()}/{b} succeeded, "
                   f"median L2 {med:.3f} ({time.time() - t0:.1f}s)")
            distortions[name].extend(np.where(succ, bound, 100.0).astype(float).tolist())

            # every fifth image: its plot, per attack
            dump_idx = [i for i in range(b) if (n_seen + i) % 5 == 0]
            if plots and dump_idx:
                with torch.no_grad():
                    purified = loaded.get_purified(adv, generator)
                purified = np.clip(purified.float().cpu().numpy(), 0, 1)
                adv_np, x_np = adv.float().cpu().numpy(), x.cpu().numpy()
                for i in dump_idx:
                    save_example_plot(plots_folder / f"{name}_example={n_seen + i}.png",
                                      x_np[i], adv_np[i], purified[i],
                                      bool(succ[i]), float(bound[i]))
        n_seen += b
        if resume:
            tmp = progress_path.with_suffix(".tmp")
            tmp.parent.mkdir(parents=True, exist_ok=True)
            tmp.write_text(json.dumps(
                {"fingerprint": fingerprint, "n_seen": n_seen,
                 "clean_correct": clean_correct, "distortions": distortions}))
            os.replace(tmp, progress_path)  # atomic: never a torn checkpoint

    if pcount > 1:
        clean_correct = allgather_lists(clean_correct)
        distortions = {name: allgather_lists(vals) for name, vals in distortions.items()}
    # removed only after the gather: a rank that dies in it leaves every
    # rank's finished batches for the rerun
    progress_path.unlink(missing_ok=True)  # run completed (or stale file)
    results = {"Clean": float(np.mean(clean_correct)),
               **{ATTACK_JSON_NAMES[n]: v for n, v in distortions.items()}}
    if pid == 0:
        results = _merge_results(results_folder / "results.json", results["Clean"],
                                 distortions)
        log_fn(f"[results] clean accuracy {results['Clean']:.4f}")
    if pcount > 1:
        torch.distributed.barrier()  # every rank returns after results.json exists
    return results


def _merge_results(json_path: Path, clean_acc: float, distortions: dict) -> dict:
    """results.json with Clean and the given attacks' lists replaced and any
    other attack's list kept (a rerun of one attack updates the file)."""
    res = json.loads(json_path.read_text()) if json_path.exists() else {}
    res["Clean"] = clean_acc
    for name, values in distortions.items():
        res[ATTACK_JSON_NAMES[name]] = values
    json_path.parent.mkdir(parents=True, exist_ok=True)
    json_path.write_text(json.dumps(res, indent=2))
    return res
