"""The defense-efficacy experiment on the port (counterpart of
tools/efficacy_run.py): train a small classifier and a small NVAE purifier
on a synthetic dataset, search the purifier's alphas against adversaries,
and run the ids attack suite on the bare and the defended classifier.

Stages (each kept under .efficacy_torch/; a rerun resumes):

  0. synth dataset    4-class oriented gratings at 64 px (384 + 32 images a
                      class), PNG files in class folders.
  1. classifier       small-plan VGG11-BN, normalize-only SGD steps (a
                      horizontal flip would alias the 45- and 135-degree
                      classes); clean test accuracy.
  2. NVAE             2 scales x 2 groups, 16 channels, trained by
                      train/nvae.fit_nvae (Adamax, annealed balanced KL,
                      input noise 0.03); the purifier's check: the
                      classifier's accuracy on the eval-mode deterministic
                      reconstructions of the test set (through K1 on the
                      card) and their mean L2 distance.
  3. alpha search     DeepFool adversaries of the recon-only defense (all
                      alphas 0) on the training set, then grid search and
                      Bayesian optimization of the alphas against them.
  4. harness          eval/harness.run_benchmark under DeepFool, C&W and
                      AutoAttack at the ids suite's budgets on the first 128
                      test images: 'base' (the bare classifier), 'ours' and
                      'ours_noise' (initial noise eps 2.0), EoT-8.
  5. report           EFFICACY_torch.json at the repository's root.

Run:  python -m gen_adversarial_tpu_torch.efficacy_run [--device cuda] [--seed 7]
      GAT_EFFICACY_STAGE=3 python -m ...   (stop after stage 3)

Every stage appends its wall seconds and numbers to
.efficacy_torch/stages.json and prints them as one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
WORK = REPO / ".efficacy_torch"
REPORT = REPO / "EFFICACY_torch.json"

IMAGE_SIZE = 64
N_CLASSES = 4
N_TRAIN_PER_CLASS = 384
N_TEST_PER_CLASS = 32
SEED = 7

# small-plan VGG11-BN: the ids classifier family at 1/8 width
VGG_PLAN = (16, "M", 32, "M", 64, 64, "M", 64, 64, "M", 64, 64, "M")

CLF_EPOCHS = 12
CLF_LR = 0.02
CLF_BATCH = 64

NVAE_EPOCHS = 40
NVAE_LR = 6e-3
NVAE_BATCH = 64
NVAE_INPUT_NOISE = 0.03
NVAE_CONFIG = dict(resolution=IMAGE_SIZE, initial_channels=16, n_pre_post_blocks=1,
                   n_pre_post_cells=2, num_scales=2, num_groups_per_scale=2,
                   is_adaptive=False, num_cells_per_group=1, num_latent_per_group=8,
                   num_nf_cells=None, num_mixtures=5)

EOT_STEPS = 8           # EoT width for defense eval + search
EVAL_BATCH = 16
N_EVAL_IMAGES = 128     # every harness run sees the same first 128 test images
N_ADV = 128             # DeepFool adversaries kept for the alpha search
ADV_MAX_ITER = 128
GRID_STEPS = 24
BO_STEPS = 24
VARIANTS = ("base", "ours", "ours_noise")
ATTACKS = ("deepfool", "c&w", "autoattack")


def nvae_config():
    from gen_adversarial_tpu_torch.models.nvae.model import NVAEConfig
    return NVAEConfig(**NVAE_CONFIG)


def _record(stage: str, seconds: float, **numbers) -> dict:
    """Append a stage's seconds and numbers to WORK/stages.json and print
    them."""
    path = WORK / "stages.json"
    stages = json.loads(path.read_text()) if path.exists() else {}
    stages[stage] = {"seconds": seconds, **numbers}
    path.write_text(json.dumps(stages, indent=2))
    print(json.dumps({"efficacy_stage": stage, **stages[stage]}), flush=True)
    return stages[stage]


# --------------------------------------------------------------- stage 0
def synth_image(rng: np.random.RandomState, cls: int, size: int) -> np.ndarray:
    """One grating: orientation = class identity (0/45/90/135 deg +-8),
    random frequency/phase/tint/brightness: an ~6-dim smooth manifold."""
    th = np.deg2rad(45.0 * cls) + rng.uniform(-np.pi / 22, np.pi / 22)
    freq = rng.uniform(1.5, 3.0)
    phase = rng.uniform(0, 2 * np.pi)
    g = (np.arange(size) + 0.5) / size
    xx, yy = np.meshgrid(g, g, indexing="xy")
    wave = np.sin(2 * np.pi * freq * (xx * np.cos(th) + yy * np.sin(th)) + phase)
    tint = rng.uniform(0.55, 1.0, size=3)
    base = rng.uniform(0.35, 0.55)
    img = base + 0.35 * wave[..., None] * tint[None, None, :]
    return np.clip(img, 0.0, 1.0)


def stage0_dataset(log, seed):
    from gen_adversarial_tpu_torch.data import png
    marker = WORK / "data" / ".done"
    if marker.exists():
        return
    rng = np.random.RandomState(seed)
    for split, n_per in (("train", N_TRAIN_PER_CLASS), ("test", N_TEST_PER_CLASS)):
        for cls in range(N_CLASSES):
            d = WORK / "data" / split / f"class_{cls}"
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n_per):
                img = synth_image(rng, cls, IMAGE_SIZE)
                png.write(d / f"{i:04d}.png", (img * 255).round().astype(np.uint8))
    marker.write_text("ok")
    log(f"[stage0] dataset written: {N_CLASSES}x{N_TRAIN_PER_CLASS} train, "
        f"{N_CLASSES}x{N_TEST_PER_CLASS} test at {IMAGE_SIZE}px")


# --------------------------------------------------------------- stage 1
def _clf_model(device):
    from gen_adversarial_tpu_torch.models.classifiers import VGG11BN
    return VGG11BN(N_CLASSES, plan=VGG_PLAN, device=device)


def _normalize_only(images, generator):
    from gen_adversarial_tpu_torch.train.augment import eval_normalize
    return eval_normalize(torch.clamp(images, 0.0, 1.0))


def _accuracy(model, dataset) -> float:
    from gen_adversarial_tpu_torch.data.datasets import iterate_batches
    from gen_adversarial_tpu_torch.train.classifier import TrainState, eval_step
    state = TrainState(model, None)
    correct = sum(eval_step(state, b)[0]
                  for b in iterate_batches(dataset, EVAL_BATCH, drop_last=False))
    return correct / len(dataset)


def stage1_classifier(log, device, seed):
    from gen_adversarial_tpu_torch.core.checkpoint import load_variables, save_variables
    from gen_adversarial_tpu_torch.core.convert import from_jax_variables, to_jax_variables
    from gen_adversarial_tpu_torch.core.init import flax_init_
    from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset, iterate_batches
    from gen_adversarial_tpu_torch.train.classifier import create_train_state, train_step

    path = WORK / "classifier.msgpack"
    model = _clf_model(device)
    if path.exists():
        variables, meta = load_variables(path)
        from_jax_variables(variables, model)
        log(f"[stage1] classifier loaded (test acc {meta['test_acc']:.4f})")
        return model.eval(), float(meta["test_acc"])

    train_ds = ImageLabelDataset(str(WORK / "data" / "train"), IMAGE_SIZE)
    test_ds = ImageLabelDataset(str(WORK / "data" / "test"), IMAGE_SIZE)
    flax_init_(model, torch.Generator(device=device).manual_seed(seed))
    state = create_train_state(model.to(memory_format=torch.channels_last), CLF_LR)
    for epoch in range(CLF_EPOCHS):
        losses = [train_step(state, batch, None, augment=_normalize_only)
                  for batch in iterate_batches(train_ds, CLF_BATCH, shuffle=True,
                                               seed=seed + epoch)]
        log(f"[stage1 epoch {epoch + 1}/{CLF_EPOCHS}] "
            f"loss {float(torch.stack(losses).mean()):.4f}")
    test_acc = _accuracy(model, test_ds)
    log(f"[stage1] clean test accuracy {test_acc:.4f}")
    save_variables(path, to_jax_variables(model), {"test_acc": test_acc, "plan": list(VGG_PLAN)})
    return model.eval(), test_acc


# --------------------------------------------------------------- stage 2
def stage2_nvae(log, clf, device, seed):
    from gen_adversarial_tpu_torch.core.checkpoint import load_variables, save_variables
    from gen_adversarial_tpu_torch.core.convert import from_jax_variables, to_jax_variables
    from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset, iterate_batches
    from gen_adversarial_tpu_torch.models.nvae.model import NVAE
    from gen_adversarial_tpu_torch.ops import depthwise
    from gen_adversarial_tpu_torch.train.augment import eval_normalize
    from gen_adversarial_tpu_torch.train.nvae import fit_nvae

    cfg = nvae_config()
    model = NVAE(cfg, device=device)
    final = WORK / "nvae_final.msgpack"
    if final.exists():
        variables, meta = load_variables(final)
        from_jax_variables(variables, model)
        log(f"[stage2] NVAE loaded (recon acc {meta['recon_acc']:.4f}, "
            f"recon L2 {meta['recon_l2']:.3f})")
        return model.eval(), meta

    train_ds = ImageLabelDataset(str(WORK / "data" / "train"), IMAGE_SIZE)
    t = time.monotonic()
    fit_nvae(model, train_ds, epochs=NVAE_EPOCHS, lr=NVAE_LR, batch_size=NVAE_BATCH,
             seed=seed, log_fn=log, checkpoint_path=str(WORK / "nvae.msgpack"),
             input_noise=NVAE_INPUT_NOISE)
    if device.type == "cuda":
        torch.cuda.synchronize()
    fit_s = time.monotonic() - t

    # the purifier's check: classifier accuracy on the eval-mode
    # deterministic reconstructions of the test set, and their mean L2
    model.eval().requires_grad_(False)
    test_ds = ImageLabelDataset(str(WORK / "data" / "test"), IMAGE_SIZE)
    correct, l2, n = 0, 0.0, 0
    launches = depthwise.launches
    with torch.no_grad():
        for batch in iterate_batches(test_ds, EVAL_BATCH, drop_last=False):
            x = torch.clamp(torch.from_numpy(batch["image"]).to(device), 0, 1)
            r = torch.clamp(model.reconstruct(x, deterministic=True), 0, 1)
            logits = clf(eval_normalize(r).permute(0, 3, 1, 2))
            y = torch.from_numpy(batch["label"].astype(np.int64)).to(device)
            correct += int((logits.argmax(-1) == y).sum())
            l2 += float(torch.sqrt(((r - x) ** 2).sum((1, 2, 3))).sum())
            n += len(y)
    meta = {"recon_acc": correct / n, "recon_l2": l2 / n, "fit_s": fit_s,
            "k1_launches": depthwise.launches - launches,
            "config": dataclasses.asdict(cfg)}
    log(f"[stage2] recon classifier acc {meta['recon_acc']:.4f}, "
        f"mean recon L2 {meta['recon_l2']:.3f}")
    save_variables(final, to_jax_variables(model), meta)
    return model, meta


# --------------------------------------------------------------- stage 3
def _make_defense(nvae, clf, alphas, device, remat=False, noise_eps=0.0):
    from gen_adversarial_tpu_torch.defenses.base import MLVGMDefense, make_classifier_apply
    from gen_adversarial_tpu_torch.defenses.purify import make_nvae_purify_split
    nvae.eval().requires_grad_(False)
    clf.eval().requires_grad_(False)
    encode, decode = make_nvae_purify_split(nvae, 0.6)
    return MLVGMDefense(
        purifier=nvae, classifier=clf,
        alphas=torch.as_tensor(np.asarray(alphas, np.float32), device=device),
        purify_encode=encode, purify_decode=decode,
        classifier_apply=make_classifier_apply(clf), initial_noise_eps=noise_eps,
        image_size=IMAGE_SIZE, remat=remat)


def _make_deepfool_adv_set(log, defense, images_path, out_dir, n_samples, device, seed):
    """DeepFool adversaries of `defense` through EoT, kept as PNG files in
    class folders under their source's name (the format of
    search/grid.create_adversarial_dataset)."""
    from gen_adversarial_tpu_torch.attacks.deepfool import deepfool_attack
    from gen_adversarial_tpu_torch.data import png
    from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset, iterate_batches
    from gen_adversarial_tpu_torch.defenses.eot import eot_wrap
    from gen_adversarial_tpu_torch.models.nvae.distributions import position_generator

    dataset = ImageLabelDataset(images_path, IMAGE_SIZE)
    net = eot_wrap(defense, EOT_STEPS)
    kept = idx = 0
    order = np.arange(len(dataset))
    np.random.RandomState(seed).shuffle(order)
    for b, batch in enumerate(iterate_batches(dataset, EVAL_BATCH, drop_last=False,
                                              shuffle=True, seed=seed)):
        if kept >= n_samples:
            break
        x = torch.clamp(torch.from_numpy(batch["image"]).to(device), 0, 1)
        y = torch.from_numpy(batch["label"].astype(np.int64)).to(device)
        succ, bound, adv = deepfool_attack(net, x, y, position_generator(device, seed, b),
                                           num_classes=N_CLASSES, max_iter=ADV_MAX_ITER)
        succ, bound, adv = succ.cpu().numpy(), bound.cpu().numpy(), adv.cpu().numpy()
        for i in range(x.shape[0]):
            if kept < n_samples and succ[i]:
                f = dataset.files[order[idx]]
                png.write(out_dir / f.parent.name / f.with_suffix(".png").name,
                          (np.clip(adv[i], 0, 1) * 255).round().astype(np.uint8))
                kept += 1
            idx += 1
        median = float(np.median(bound[succ])) if succ.any() else float("nan")
        log(f"[adv set] {kept}/{n_samples} kept (batch median L2 {median:.2f})")
    log(f"[adv set] done: {kept} DeepFool adversaries in {out_dir}")
    return kept


def stage3_search(log, nvae, clf, device, seed):
    from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset
    from gen_adversarial_tpu_torch.search.alphas import AlphaEvaluator, get_best_combination
    from gen_adversarial_tpu_torch.search.gp import bayesian_optimize
    from gen_adversarial_tpu_torch.search.grid import grid_search

    n_latents = nvae.cfg.n_latents
    best_path = WORK / "best_alphas.npy"
    if best_path.exists():
        best = np.load(best_path)
        log(f"[stage3] alphas loaded: {np.round(best, 3).tolist()}")
        return best, {}

    # the adversarial set against the recon-only defense (all alphas 0: the
    # posterior mean), built with DeepFool as the JAX tool builds it: on
    # this task single-step FGSM finds almost no adversaries
    adv_dir = WORK / "adv_set"
    defense = _make_defense(nvae, clf, np.zeros(n_latents), device)
    t = time.monotonic()
    if not (adv_dir / ".done").exists():
        _make_deepfool_adv_set(log, defense, str(WORK / "data" / "train"), adv_dir, N_ADV,
                               device, seed)
        (adv_dir / ".done").write_text("ok")
    adv_s = time.monotonic() - t

    adv_ds = ImageLabelDataset(str(adv_dir), IMAGE_SIZE)
    images = np.stack([adv_ds.load_image(i) for i in range(len(adv_ds))])
    labels = adv_ds.labels
    log(f"[stage3] adversarial set: {len(adv_ds)} images")

    fp = {"experiment": "efficacy_ids_small", "eot": EOT_STEPS, "n_adv": len(adv_ds)}
    t = time.monotonic()
    evaluator = AlphaEvaluator(defense, images, labels, attenuation=1.0, eot_steps=EOT_STEPS,
                               batch_size=EVAL_BATCH, seed=seed, device=device)
    grid_search(evaluator.objective_function, n_latents, n_steps=GRID_STEPS, seed=seed,
                results_folder=str(WORK / "search_grid"), log_fn=log, fingerprint_extra=fp)
    grid_s = time.monotonic() - t
    # a fresh evaluator with its own draws for the BO phase (each search
    # fast-forwards its own objective on resume)
    t = time.monotonic()
    bo_eval = AlphaEvaluator(defense, images, labels, attenuation=1.0, eot_steps=EOT_STEPS,
                             batch_size=EVAL_BATCH, seed=seed + 1, device=device)
    bayesian_optimize(bo_eval.objective_function, n_latents, n_steps=BO_STEPS, seed=seed,
                      results_folder=str(WORK / "search_bo"), log_fn=log,
                      fingerprint_extra=fp, device=device)
    bo_s = time.monotonic() - t

    accs = {}
    numbers = {"n_adv": len(adv_ds), "adv_set_s": adv_s, "grid_s": grid_s, "bo_s": bo_s}
    for mode in ("search_grid", "search_bo"):
        best = get_best_combination(str(WORK / mode))
        acc = float(np.load(WORK / mode / "accuracies.npy").max())
        accs[mode] = (best, acc)
        numbers[mode] = {"best_acc": acc, "alphas": np.asarray(best).round(4).tolist()}
        log(f"[stage3] {mode}: best acc {acc:.4f} at {np.round(best, 3).tolist()}")
    best = max(accs.values(), key=lambda t: t[1])[0]
    np.save(best_path, best)
    return best, numbers


# --------------------------------------------------------------- stage 4
def stage4_harness(log, nvae, clf, alphas, device, seed):
    from gen_adversarial_tpu_torch.defenses.base import ClassifierDefense, make_classifier_apply
    from gen_adversarial_tpu_torch.eval.factory import LoadedDefense, build_attacks
    from gen_adversarial_tpu_torch.eval.harness import ATTACK_JSON_NAMES, run_benchmark

    attacks = build_attacks("ids", N_CLASSES)
    # the ids DeepFool searches the top-8 classes; this task has 4
    attacks["deepfool"].keywords["num_classes"] = N_CLASSES
    attacks["autoattack"].keywords["n_classes"] = N_CLASSES

    def build(name):
        if name == "base":
            return ClassifierDefense(clf.eval().requires_grad_(False),
                                     make_classifier_apply(clf)), 1
        # the ours_*_noise_ids family's initial noise eps 2.0: per-EoT-draw
        # input randomization against the adaptive EoT attacker. No remat
        # and no EoT chunks: a batch's attack graph fits the card's memory
        # (both are memory levers that leave the results as they are)
        return _make_defense(nvae, clf, alphas, device,
                             noise_eps=2.0 if name == "ours_noise" else 0.0), EOT_STEPS

    runs, attack_seconds = {}, {}
    for name in VARIANTS:
        defense, eot = build(name)
        out = WORK / f"results_{name}"
        res_file = out / "results.json"
        existing = json.loads(res_file.read_text()) if res_file.exists() else {}
        # one harness run per attack: results.json merges them, and a rerun
        # skips the attacks it holds
        for att in ATTACKS:
            if ATTACK_JSON_NAMES[att] in existing:
                log(f"[stage4] {name}/{att}: already in results.json")
                continue
            loaded = LoadedDefense(
                experiment="ids", defense_type="ours" if name != "base" else "base",
                image_size=IMAGE_SIZE, n_classes=N_CLASSES, defense=defense,
                eot_steps=eot, eot_chunk=None, attacks=attacks, device=device)
            log(f"[stage4] running harness: {name}/{att} (eot={eot}, batch={EVAL_BATCH})")
            t = time.monotonic()
            run_benchmark(loaded, str(WORK / "data" / "test"), str(out),
                          batch_size=EVAL_BATCH, seed=seed, max_images=N_EVAL_IMAGES,
                          attack_filter=att, plots=True, log_fn=log)
            attack_seconds[f"{name}/{att}"] = time.monotonic() - t
            existing = json.loads(res_file.read_text())
        runs[name] = existing
    return runs, {"attack_seconds": attack_seconds}


# --------------------------------------------------------------- stage 5
def _attack_stats(values):
    v = np.asarray(values, float)
    succ = v < 100.0
    return {"n": int(v.size), "success_rate": float(succ.mean()),
            "median_l2_successful": float(np.median(v[succ])) if succ.any() else None,
            "n_failed_marker_100": int((~succ).sum())}


def _device_line(device) -> str | None:
    if device.type != "cuda":
        return None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None


def stage5_report(log, clf_acc, nvae_meta, alphas, runs, device, seed):
    report = {
        "what": "defense-efficacy experiment on the PyTorch port: trained small models, "
                "the port's harness, ids attack suite budgets",
        "dataset": {"image_size": IMAGE_SIZE, "n_classes": N_CLASSES,
                    "train_per_class": N_TRAIN_PER_CLASS, "test_per_class": N_TEST_PER_CLASS,
                    "family": "oriented gratings (smooth low-dim manifold)"},
        "models": {"classifier": f"VGG11BN plan {list(VGG_PLAN)}",
                   "clean_test_acc": clf_acc,
                   "nvae": "2 scales x 2 groups, c16 (ids structure scaled down)",
                   "nvae_recon_clf_acc": nvae_meta["recon_acc"],
                   "nvae_recon_l2": nvae_meta["recon_l2"]},
        "defense": {"type": "ours (NVAE purification); ours_noise adds the "
                            "ours_*_noise_ids family's initial_noise_eps 2.0",
                    "eot_steps": EOT_STEPS,
                    "alphas": np.asarray(alphas).round(4).tolist(),
                    "alpha_source": "grid+BO search on DeepFool adversarial set"},
        "eval": {"n_images": N_EVAL_IMAGES, "batch": EVAL_BATCH,
                 "attack_suite": "ids (DeepFool-128, C&W 1024x8 restarts, AutoAttack)",
                 "harness": "gen_adversarial_tpu_torch/eval/harness.run_benchmark"},
        "seed": seed,
        "results": {},
        "notes": ["median_l2 is over SUCCESSFUL attacks only (the harness's 100.0 marker = "
                  "no adversary found within the attack budget)."],
        "device": torch.cuda.get_device_name(0) if device.type == "cuda" else str(device),
        "nvidia_smi": _device_line(device),
    }
    for name, res in runs.items():
        entry = {"clean_acc": res["Clean"]}
        for attack in ("DeepFool", "C&W", "AutoAttack"):
            if attack in res:
                entry[attack] = _attack_stats(res[attack])
        report["results"][name] = entry
    comp = {}
    for defended in ("ours", "ours_noise"):
        if defended not in report["results"]:
            continue
        comp[defended] = {}
        for attack in ("DeepFool", "C&W", "AutoAttack"):
            b = report["results"].get("base", {}).get(attack)
            o = report["results"][defended].get(attack)
            if b and o:
                comp[defended][attack] = {
                    "success_rate_base": b["success_rate"],
                    "success_rate_defended": o["success_rate"],
                    "median_l2_base": b["median_l2_successful"],
                    "median_l2_defended": o["median_l2_successful"]}
    report["comparison"] = comp
    stages = WORK / "stages.json"
    report["stages"] = json.loads(stages.read_text()) if stages.exists() else {}
    REPORT.write_text(json.dumps(report, indent=2))
    log(f"[stage5] wrote {REPORT}")
    log(json.dumps(comp, indent=2))
    return report


def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser("defense-efficacy experiment on the port")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=SEED,
                   help="the dataset's, the initial weights', the data order's and the "
                        "draws' seed (default %(default)s, the JAX tool's)")
    args = p.parse_args(argv)
    from gen_adversarial_tpu_torch.eval.factory import resolve_device
    device = resolve_device(args.device, "efficacy_run")
    if device.type == "cuda":
        # float32 means float32: no TF32 in cuDNN convolutions or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    WORK.mkdir(parents=True, exist_ok=True)
    seed_file = WORK / "seed"
    if seed_file.exists() and int(seed_file.read_text()) != args.seed:
        raise SystemExit(f"{WORK} holds the run of seed {seed_file.read_text()}, not "
                         f"{args.seed}: move it away to start another seed")
    seed_file.write_text(str(args.seed))

    def log(msg):
        print(msg, flush=True)
        with open(WORK / "log.txt", "a") as f:
            f.write(str(msg) + "\n")

    def timed(fn, *a):
        t = time.monotonic()
        out = fn(*a)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out, time.monotonic() - t

    stop_after = int(os.environ.get("GAT_EFFICACY_STAGE", "5"))
    _, s = timed(stage0_dataset, log, args.seed)
    _record("0", s)
    if stop_after < 1:
        return
    (clf, clf_acc), s = timed(stage1_classifier, log, device, args.seed)
    _record("1", s, clean_test_acc=clf_acc)
    if stop_after < 2:
        return
    (nvae, nvae_meta), s = timed(stage2_nvae, log, clf, device, args.seed)
    _record("2", s, **{k: v for k, v in nvae_meta.items() if k != "config"})
    if stop_after < 3:
        return
    (alphas, numbers), s = timed(stage3_search, log, nvae, clf, device, args.seed)
    _record("3", s, **numbers, best_alphas=np.asarray(alphas).round(4).tolist())
    if stop_after < 4:
        return
    (runs, numbers), s = timed(stage4_harness, log, nvae, clf, alphas, device, args.seed)
    _record("4", s, **numbers)
    if stop_after < 5:
        return
    stage5_report(log, clf_acc, nvae_meta, alphas, runs, device, args.seed)


if __name__ == "__main__":
    main()
