"""Random grid search over alpha vectors and the adversarial set the search
scores them on (counterpart of gen_adversarial_tpu/search/grid.py; the
reference's alpha_learning/grid_search.py and
create_adversarial_dataset.py).

The search state is the JAX package's, file for file: `alphas.npy`,
`accuracies.npy` and `grid_progress.json` (`bo_progress.json` for the
Bayesian search, search/gp.py), so either package resumes the other's.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from gen_adversarial_tpu_torch.attacks import fgsm_attack
from gen_adversarial_tpu_torch.data import png
from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset, iterate_batches
from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
from gen_adversarial_tpu_torch.models.nvae.distributions import position_generator


def _atomic_npy(path: Path, arr: np.ndarray):
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)


def save_search_step(folder: Path, alphas, accuracies, fingerprint: dict,
                     progress_name: str, extra: dict | None = None):
    """Persist the search state after one objective evaluation: the final
    alphas.npy/accuracies.npy format (partial), plus a progress marker.
    Every objective call is a full EoT epoch over the adversarial set, so
    losing evaluated rows to a crash costs hours; the final filenames mean
    even a crashed search's partial results are directly usable."""
    folder.mkdir(parents=True, exist_ok=True)
    _atomic_npy(folder / "alphas.npy", np.stack(alphas))
    _atomic_npy(folder / "accuracies.npy", np.asarray(accuracies))
    tmp = folder / (progress_name + ".tmp")
    tmp.write_text(json.dumps(dict(extra or {}, fingerprint=fingerprint,
                                   done=len(alphas))))
    os.replace(tmp, folder / progress_name)


def load_search_progress(folder: Path | None, fingerprint: dict,
                         progress_name: str, log_fn):
    """-> (alphas rows, accuracies rows, done, marker dict) or ([], [], 0, {})."""
    if folder is None or not (folder / progress_name).exists():
        return [], [], 0, {}
    try:
        meta = json.loads((folder / progress_name).read_text())
        a = np.load(folder / "alphas.npy")
        acc = np.load(folder / "accuracies.npy")
    except (json.JSONDecodeError, OSError, ValueError):
        return [], [], 0, {}
    done = int(meta.get("done", 0))
    if (meta.get("fingerprint") != fingerprint or a.shape[0] != done
            or acc.shape[0] != done):
        log_fn(f"[resume] {progress_name} does not match this run's setup; "
               "restarting from scratch")
        return [], [], 0, {}
    log_fn(f"[resume] continuing at evaluation {done} ({progress_name})")
    return list(a), [list(r) for r in np.atleast_2d(acc)], done, meta


def _fast_forward(objective, done: int):
    """Tell a resuming objective how many evaluations are already paid for,
    so its own draws land where an uninterrupted run's would (see
    AlphaEvaluator.fast_forward). Plain callables without the hook (tests,
    synthetic objectives) are left alone."""
    ff = getattr(objective, "fast_forward", None) \
        or getattr(getattr(objective, "__self__", None), "fast_forward", None)
    if ff is not None:
        ff(done)


def grid_search(objective, n_alphas: int, n_steps: int, seed: int = 0,
                results_folder: str | None = None, log_fn=print,
                resume: bool = True, fingerprint_extra: dict | None = None):
    """n_steps uniform-random alpha vectors from np.random.RandomState(seed),
    each scored by objective(alphas) -> accuracy; returns (alphas (N, D),
    accuracies (N, 1)). With results_folder set, every evaluation is saved
    and a rerun resumes after the last one. `fingerprint_extra`:
    objective-identifying fields (config path, adversarial set, eot_steps,
    ...) folded into the resume fingerprint, so a crashed search on defense
    A never resumes into a search on defense B sharing the same folder."""
    rng = np.random.RandomState(seed)
    folder = Path(results_folder) if results_folder is not None else None
    fingerprint = {"mode": "grid", "n_alphas": n_alphas, "n_steps": n_steps,
                   "seed": seed, **(fingerprint_extra or {})}
    alphas, accuracies, done, _ = ([], [], 0, {}) if not resume else \
        load_search_progress(folder, fingerprint, "grid_progress.json", log_fn)
    if done:
        # replay the RNG stream for the finished steps; if the saved rows
        # disagree the checkpoint is from a different stream - restart
        replay = [rng.uniform(0.0, 1.0, size=n_alphas) for _ in range(done)]
        if not np.allclose(np.stack(replay), np.stack(alphas)):
            log_fn("[resume] saved rows do not match the seed's RNG stream; "
                   "restarting from scratch")
            alphas, accuracies, done = [], [], 0
            rng = np.random.RandomState(seed)
    _fast_forward(objective, done)
    for s in range(done, n_steps):
        a = rng.uniform(0.0, 1.0, size=n_alphas)
        acc = objective(a)
        alphas.append(a)
        accuracies.append([acc])
        log_fn(f"[grid {s}] acc {acc:.4f}")
        if folder is not None:
            save_search_step(folder, alphas, accuracies, fingerprint,
                             "grid_progress.json")
    alphas = np.stack(alphas)
    accuracies = np.asarray(accuracies)
    if folder is not None:
        folder.mkdir(parents=True, exist_ok=True)
        _atomic_npy(folder / "alphas.npy", alphas)
        _atomic_npy(folder / "accuracies.npy", accuracies)
        (folder / "grid_progress.json").unlink(missing_ok=True)
    return alphas, accuracies


def _write_image(path: Path, pixels: np.ndarray):
    """A .png with data/png.py; any other extension with PIL, which picks the
    format from it (JPEG under a .jpg name), or an error naming the file."""
    if path.suffix == ".png":
        png.write(path, pixels)
        return
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: writing a {path.suffix} file needs PIL, which is not "
                           "installed (PNG files are written without it)") from None
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(pixels).save(path)


def create_adversarial_dataset(loaded, images_path: str, out_dir: str,
                               l2_bound: float, n_samples: int,
                               eot_steps: int = 32, batch_size: int = 8,
                               seed: int = 0, log_fn=print):
    """FGSM at l2_bound against `loaded.defense` (eval/factory.LoadedDefense)
    through EoT; the successful adversaries of images classified right are
    written to out_dir/<class>/<source name>, at most n_samples, as
    (adv * 255).astype(uint8) (truncated, as the JAX package writes them).
    Returns the number kept.

    The images are walked in the shuffled order of iterate_batches(shuffle=
    True, seed=seed), like the reference's shuffle=True DataLoader ("to allow
    samples from all classes"); batch b draws from a generator seeded from
    np.random.SeedSequence((seed, b))."""
    dataset = ImageLabelDataset(images_path, loaded.image_size)
    net = eot_wrap(loaded.defense, eot_steps, chunk=loaded.eot_chunk)
    device = loaded.device
    kept = 0
    out = Path(out_dir)
    idx = 0
    # `order` replays iterate_batches' shuffle so that files can be named
    order = np.arange(len(dataset))
    np.random.RandomState(seed).shuffle(order)
    for b, batch in enumerate(iterate_batches(dataset, batch_size, drop_last=False,
                                              shuffle=True, seed=seed)):
        if kept >= n_samples:
            break
        x = torch.from_numpy(np.clip(batch["image"], 0, 1)).to(device)
        y = torch.from_numpy(batch["label"].astype(np.int64)).to(device)
        succ, bound, adv = fgsm_attack(net, x, y, position_generator(device, seed, b), l2_bound)
        succ, bound = succ.cpu().numpy(), bound.float().cpu().numpy()
        adv = adv.float().cpu().numpy()
        for i in range(x.shape[0]):
            f = dataset.files[order[idx]]
            idx += 1
            # bound > 0 excludes already-misclassified clean images, which
            # FGSM reports as zero-perturbation successes (the reference's
            # `if success and bound > 0.`, create_adversarial_dataset.py:103)
            if not succ[i] or bound[i] <= 0.0 or kept >= n_samples:
                continue
            _write_image(out / f.parent.name / f.name, (adv[i] * 255).astype(np.uint8))
            kept += 1
    log_fn(f"[adv dataset] kept {kept} adversaries in {out}")
    return kept
