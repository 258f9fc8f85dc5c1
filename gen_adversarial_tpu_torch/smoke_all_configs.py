"""The config matrix (twin of tools/smoke_all_configs.py): for every file in
configs/, fabricate the checkpoints it names (random weights from a seed,
written as flax msgpack files), point a copy of the config at them, load it
through eval/factory.load_defense and run a one-batch DeepFool
eval/harness.run_benchmark (EoT-2) to results.json, and record per config
whether it ran, with its seconds.

Every model is at its real width: the classifiers (VGG11-BN with the
projector over 100 classes, ResNet50, ResNeXt50-32x4d), the gender purifier
PSP(1024) (E4E and the 1024-px StyleGAN2), the cars Style-Transformer(512),
the A-VAE at the experiment's size and the ND-VAE from its config's fields.
The ids NVAE is the flagship's (flagship.FLAGSHIP_NVAE: 32 channels, 3
scales x 8 groups of 2 cells, 20 latents a group: the configs' 24 alphas),
where the JAX tool used an 8-channel model of one cell a group. One row
more, outside the 45 and under "extra" in the report:
ours_cosine_noise_ids on the same NVAE with one normalizing-flow cell.

Each file is made once and reused by every config that names it. Per config
the report holds the JAX tool's keys (ok, secs, attack_secs, clean, or
error) and load_secs, peak_gib (the device's peak allocation), the launches
of K1 (ops/depthwise.py) and K2 (ops/upfirdn.py), and DeepFool's steps per
batch. On the card a row is ok only if its path launched its kernels and no
other: K1 on the ids ours_* rows, K2 on the gender and cars ours_* rows,
neither on the rest (on the CPU neither launches). The report is written
after every config, and a rerun keeps the ok rows and runs the others again.
The exit code is 1 unless every row is ok.

With --cli-defaults each config runs as cli/test_defense.py runs it when no
flag is given: one batch of the CLI's 8 images at EoT-32, the EoT chunk the
CLI takes (eval/factory.default_eot_chunk) and DeepFool's own class block
(attacks/utils.class_block), DeepFool cut to one step. The 8 images lie in
one class folder and the classifier's class-0 bias is raised until every
image is classified 0 under the harness's clean draw (label_all_as_zero),
so that DeepFool's step runs: its class Jacobian sets the attacks' peak.
Each row also records the chunk, the blocks DeepFool took, the bias raised
and the card's capacity; a row that runs out of memory is not ok (nothing
retries at a smaller chunk). No extra row in this mode. --batch-size N runs
it as the CLI runs with that flag (one batch of N images), to find the
batch with which a config that does not fit at 8 does.

Usage: python3 -m gen_adversarial_tpu_torch.smoke_all_configs
    [--out SMOKE_torch.json] [--only SUBSTR] [--work DIR] [--device cuda]
    [--cli-defaults [--batch-size N]]  (default --out
    SMOKE_DEFAULTS_torch.json, --work .scratch/smoke_matrix_defaults)
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from gen_adversarial_tpu_torch.attacks import deepfool as deepfool_module
from gen_adversarial_tpu_torch.core.checkpoint import save_variables
from gen_adversarial_tpu_torch.core.config import (
    IMAGE_SIZE, N_CLASSES, DefenseConfig, defense_type_of, experiment_of)
from gen_adversarial_tpu_torch.core.convert import to_jax_variables
from gen_adversarial_tpu_torch.core.init import init_flax_tensor_
from gen_adversarial_tpu_torch.data import png
from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset
from gen_adversarial_tpu_torch.eval import factory
from gen_adversarial_tpu_torch.eval.harness import batch_generator, run_benchmark
from gen_adversarial_tpu_torch.flagship import FLAGSHIP_NVAE, init_tensor_, random_init_
from gen_adversarial_tpu_torch.gender import init_stylegan_tensor_
from gen_adversarial_tpu_torch.models.classifiers import Projector
from gen_adversarial_tpu_torch.ops import depthwise as k1
from gen_adversarial_tpu_torch.ops import upfirdn as k2

REPO = Path(__file__).resolve().parents[1]
CONFIGS = REPO / "configs"
SEED = 0  # every fabricated file's generator, as the JAX tool's PRNGKey(0)
# the ids purifier, and the extra row's: the same with a flow cell
NVAE_CONFIG = FLAGSHIP_NVAE
FLOW_NVAE_CONFIG = dataclasses.replace(FLAGSHIP_NVAE, num_nf_cells=1)
EXTRA_ROW, EXTRA_CONFIG = "ours_cosine_noise_ids_flow", "ours_cosine_noise_ids"
# gender runs the 1024-px generator at batch 1 with the EoT draws one at a
# time, as the JAX tool does
BATCH = {"gender": 1, "ids": 2, "cars": 2}
EOT_CHUNK = {"gender": 1, "ids": None, "cars": None}
EOT_STEPS = 2
MAX_IMAGES = 2
# the harness's per-attack log line ends in its seconds
ATTACK_SECS = re.compile(r"\((\d+\.\d)s\)$")
# --cli-defaults: cli/test_defense.py's batch, EoT and seed, and DeepFool's
# steps (its peak is a step's, whatever the number of steps)
CLI_BATCH, CLI_EOT_STEPS, CLI_SEED = 8, 32, 42
CLI_DEEPFOOL_ITERS = 1


def fabricate_dataset(root: Path, size: int, n_classes: int, n_per_class: int = 2) -> None:
    """Two class folders of random PNGs at the experiment's size."""
    rng = np.random.RandomState(0)
    for c in range(min(n_classes, 2)):
        for i in range(n_per_class):
            png.write(root / f"class_{c:03d}" / f"{i}.png",
                      (rng.rand(size, size, 3) * 255).astype(np.uint8))


def label_all_as_zero(loaded, images: torch.Tensor, device: torch.device, seed: int,
                      margin_draws: int) -> dict:
    """Raise the classifier head's class-0 bias until every image is
    classified 0 under the harness's clean draw of batch 0 (run_benchmark
    at `seed`) and `margin_draws` more, by the median margin of the random
    head's top class over its second, so that the attacks have work;
    returns the raise and the margin."""
    head = next(m for m in loaded.defense.classifier.modules() if isinstance(m, Projector))
    net = loaded.net

    def draws():  # new generators: a forward moves its generator on
        return [batch_generator(seed, 0, 0, 0, device)] + [
            torch.Generator(device=device).manual_seed(1000 + i) for i in range(margin_draws)]

    with torch.no_grad():
        logits = torch.stack([net(images, d) for d in draws()])  # (D, B, C)
        top2 = logits[0].topk(2, dim=1).values
        margin = (top2[:, 0] - top2[:, 1]).median().item()
        lost = (logits[..., 1:].max(-1).values - logits[..., 0]).max().item()
        head.fc1.bias[0] += lost + margin
        preds = [net(images, d).argmax(1) for d in draws()]
    if any(bool((p != 0).any()) for p in preds):
        raise RuntimeError(f"after raising the class-0 bias by {lost + margin}, the "
                           f"predictions are {[p.tolist() for p in preds]}")
    return {"bias_raise": lost + margin, "top2_margin": margin}


def _random(build, device: torch.device, init) -> torch.nn.Module:
    """build(device) made on the meta device, then every tensor filled on
    `device` by `init` from a generator seeded SEED (flagship.random_init_)."""
    with torch.device("meta"):
        module = build("meta")
    generator = torch.Generator(device=device).manual_seed(SEED)
    return random_init_(module.to_empty(device=device), generator, init)


def _save(path: Path, module: torch.nn.Module, meta: dict) -> dict:
    """The module as a checkpoint (meta beside it); its seconds, size and
    parameter count."""
    t = time.monotonic()
    save_variables(path, to_jax_variables(module), meta)
    return {"secs": time.monotonic() - t, "gb": path.stat().st_size / 1e9,
            "params": sum(p.numel() for p in module.parameters())}


def fabricate_classifier(path: Path, experiment: str, device: torch.device) -> dict:
    kind = factory.CLASSIFIER_TYPE[experiment]
    model = _random(lambda d: factory.make_classifier(kind, N_CLASSES[experiment], device=d),
                    device, init_tensor_)
    return _save(path, model, {"model_type": kind})


def fabricate_ours(path: Path, experiment: str, device: torch.device,
                   nvae_config=None) -> dict:
    """The experiment's purifier with the meta keys the factory reads; the
    ids NVAE's config is `nvae_config` (NVAE_CONFIG when None)."""
    if experiment == "ids":
        cfg = nvae_config or NVAE_CONFIG
        model = _random(lambda d: factory.NVAE(cfg, device=d), device, init_tensor_)
        return _save(path, model, {"config": dataclasses.asdict(cfg)})
    if experiment == "gender":
        model = _random(lambda d: factory.PSP(1024, device=d), device, init_stylegan_tensor_)
        return _save(path, model, {"stylegan_size": 1024})
    model = _random(lambda d: factory.StyleTransformer(512, device=d), device,
                    init_stylegan_tensor_)
    return _save(path, model, {"output_size": 512})


def fabricate_avae(path: Path, experiment: str, device: torch.device) -> dict:
    model = _random(lambda d: factory.StyledGenerator(IMAGE_SIZE[experiment], device=d),
                    device, init_flax_tensor_)
    return _save(path, model, {})


def fabricate_ndvae(path: Path, experiment: str, cfg: DefenseConfig,
                    device: torch.device) -> dict:
    model = _random(lambda d: factory.DefenceNVAE(
        x_channels=cfg.x_channels, encoding_channels=cfg.encoding_channels,
        pre_proc_groups=cfg.pre_proc_groups, scales=cfg.scales, groups=cfg.groups,
        cells=cfg.cells, input_dim=IMAGE_SIZE[experiment], device=d), device,
        init_flax_tensor_)
    return _save(path, model, {})


def copy_config(src: Path, dst: Path, classifier: Path, autoencoder: Path | None) -> None:
    """The config's text with its checkpoint path lines pointed at the files."""
    text = src.read_text()
    for key, path in (("classifier_path", classifier), ("autoencoder_path", autoencoder)):
        if path is None:
            continue
        text, n = re.subn(rf"^{key}: .*$", lambda m: f"{key}: {path}", text, flags=re.M)
        if n != 1:
            raise ValueError(f"{src}: {n} lines of {key}")
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(text)


def path_kernels(name: str, experiment: str, device: torch.device) -> set:
    """The kernels a row's path launches: K1 in the ids NVAE's decoder
    cells, K2 in the StyleGAN2 generators' blurs; none on the CPU."""
    if device.type != "cuda" or defense_type_of(name) != "ours":
        return set()
    return {"K1"} if experiment == "ids" else {"K2"}


def check_launches(launches: dict, expected: set) -> None:
    wrong = [k for k, n in launches.items() if (n > 0) != (k in expected)]
    if wrong:
        raise RuntimeError(f"kernel launches {launches}: expected launches of "
                           f"{sorted(expected) or 'no kernel'}")


def run_config(name: str, config: Path, data: Path, results: Path, experiment: str,
               device: torch.device, cli_batch: int | None = None) -> dict:
    """load_defense and a one-batch DeepFool run_benchmark of one config
    copy (with cli_batch: as the CLI runs it at that --batch-size and its
    other defaults, the images labelled 0); the row, with the kernels'
    launches since the caller reset them (raises where the run fails)."""
    cuda = device.type == "cuda"
    shutil.rmtree(results, ignore_errors=True)  # no earlier run's progress file
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    kind = defense_type_of(name)
    cli_defaults = cli_batch is not None
    if cli_defaults:
        batch, eot_steps, max_images = cli_batch, CLI_EOT_STEPS, cli_batch
        eot_chunk = factory.default_eot_chunk(experiment, kind, batch, eot_steps)
    else:
        batch, eot_steps, max_images = BATCH[experiment], EOT_STEPS, MAX_IMAGES
        eot_chunk = EOT_CHUNK[experiment]
    t0 = time.monotonic()
    loaded = factory.load_defense(str(config), eot_steps=eot_steps, eot_chunk=eot_chunk,
                                  device=device)
    if cuda:
        torch.cuda.synchronize(device)
    load_secs = time.monotonic() - t0
    labels = None
    if cli_defaults:
        dataset = ImageLabelDataset(str(data), loaded.image_size)
        images = torch.tensor(np.stack([dataset.load_image(i) for i in range(batch)]),
                              device=device)
        labels = label_all_as_zero(loaded, images, device, CLI_SEED, 0)
        del images
    deepfool, steps, blocks = loaded.attacks["deepfool"], [], []
    depth = {"max_iter": CLI_DEEPFOOL_ITERS} if cli_defaults else {}

    def counted_deepfool(*args):
        *out, n = deepfool(*args, return_iters=True, **depth)
        steps.append(n)
        return out

    def recorded_class_grads(*args, **kw):
        blocks.append(kw["cotangent_chunk"])
        return class_grads(*args, **kw)

    loaded.attacks["deepfool"] = counted_deepfool
    class_grads = deepfool_module.class_grads
    deepfool_module.class_grads = recorded_class_grads
    msgs = []
    try:
        res = run_benchmark(loaded, str(data), str(results), batch_size=batch,
                            max_images=max_images, attack_filter="deepfool", plots=False,
                            log_fn=msgs.append)
    finally:
        deepfool_module.class_grads = class_grads
    written = results / "results.json"
    if not written.exists() or "DeepFool" not in json.loads(written.read_text()):
        raise RuntimeError(f"{written} holds no DeepFool results")
    attack_secs = sum(float(m.group(1)) for m in map(ATTACK_SECS.search, map(str, msgs)) if m)
    row = {"ok": True, "secs": time.monotonic() - t0, "attack_secs": attack_secs,
           "clean": res["Clean"], "load_secs": load_secs,
           "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
           "k1_launches": k1.launches, "k2_launches": k2.launches, "deepfool_steps": steps}
    if cli_defaults:
        row.update(batch=batch, eot_steps=loaded.eot_steps, eot_chunk=loaded.eot_chunk,
                   deepfool_blocks=sorted(set(blocks), key=str), labels=labels)
        if not any(steps):
            raise RuntimeError(f"DeepFool took no step ({steps}): its class Jacobian's peak "
                               "was not reached")
        if cuda and row["peak_gib"] >= capacity_gib(device):
            raise RuntimeError(f"peak {row['peak_gib']:.2f} GiB reached the card's "
                               f"{capacity_gib(device):.2f}")
    check_launches({"K1": k1.launches, "K2": k2.launches},
                   path_kernels(name, experiment, device))
    return row


def capacity_gib(device: torch.device) -> float:
    return torch.cuda.get_device_properties(device).total_memory / 2**30


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "not available"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else "not available"


def source_identity() -> dict:
    """The checkout's commit where it is a git repository (a copy without
    .git gives None), and a digest of the files the run executes."""
    digest = hashlib.sha256()
    package = REPO / "gen_adversarial_tpu_torch"
    files = [(p.relative_to(package).as_posix(), p) for p in sorted(package.rglob("*"))
             if p.suffix in (".py", ".cu") and "_build" not in p.parts]
    files += [(f"configs/{p.name}", p) for p in sorted(CONFIGS.glob("*.yaml"))]
    for name, p in files:
        digest.update(name.encode() + b"\0" + p.read_bytes())
    try:
        git = subprocess.run(["git", "-C", str(REPO), "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=30)
        commit = git.stdout.strip() if git.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired):
        commit = None
    return {"commit": commit, "sources_sha256": digest.hexdigest()}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser("the config matrix on the card")
    p.add_argument("--out", default=None,
                   help="SMOKE_torch.json (SMOKE_DEFAULTS_torch.json with --cli-defaults)")
    p.add_argument("--only", default=None, help="substring filter on config names")
    p.add_argument("--work", default=None,
                   help=".scratch/smoke_matrix (_defaults with --cli-defaults)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--cli-defaults", action="store_true",
                   help="each config at the test_defense CLI's defaults (module docstring)")
    p.add_argument("--batch-size", type=int, default=CLI_BATCH,
                   help="with --cli-defaults: the CLI's --batch-size")
    args = p.parse_args(argv)
    defaults = args.cli_defaults
    cli_batch = args.batch_size if defaults else None
    args.out = args.out or str(REPO / ("SMOKE_DEFAULTS_torch.json" if defaults
                                       else "SMOKE_torch.json"))
    args.work = args.work or str(REPO / ".scratch" / ("smoke_matrix_defaults" if defaults
                                                      else "smoke_matrix"))
    device = factory.resolve_device(args.device, "smoke_all_configs")
    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    out_path = Path(args.out)

    # resume: keep the ok rows of an earlier report; run the others again
    results, extra, files = {}, {}, {}
    if out_path.exists():
        try:
            prior = json.loads(out_path.read_text())
        except (json.JSONDecodeError, OSError):
            prior = {}
        results = {k: v for k, v in prior.get("configs", {}).items() if v.get("ok")}
        extra = {k: v for k, v in prior.get("extra", {}).items() if v.get("ok")}
        files = prior.get("files", {})
    header = {"backend": device.type,
              "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
              "nvidia_smi": device_line(device), "torch": torch.__version__,
              "cuda": torch.version.cuda, **source_identity(),
              "nvae_config": dataclasses.asdict(NVAE_CONFIG)}
    if defaults:
        header.update(cli_defaults=True, eot_steps=CLI_EOT_STEPS, max_images=cli_batch,
                      batch=cli_batch, deepfool_max_iter=CLI_DEEPFOOL_ITERS,
                      capacity_gib=capacity_gib(device) if device.type == "cuda" else None)
    else:
        header.update(eot_steps=EOT_STEPS, max_images=MAX_IMAGES, batch=BATCH,
                      extra_nvae_config=dataclasses.asdict(FLOW_NVAE_CONFIG))

    def write_report(partial: bool) -> None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(
            {**header, "partial": partial,
             "ok": sum(1 for r in results.values() if r["ok"]), "total": len(results),
             "configs": results,
             "extra_ok": sum(1 for r in extra.values() if r["ok"]), "extra": extra,
             "files": files}, indent=2))

    def fabricated(path: Path, make) -> Path:
        """path, made by make(path) unless an earlier run left it whole (its
        meta file is written last)."""
        if not (path.exists() and path.with_suffix(".json").exists()):
            files[path.relative_to(work).as_posix()] = make(path)
        return path

    # the ours_* configs first: the paper's defense across the three families
    configs = sorted(CONFIGS.glob("*.yaml"),
                     key=lambda p: (not p.stem.startswith("ours"), p.stem))
    rows = [(p.stem, p, results) for p in configs]
    if not defaults:
        rows.append((EXTRA_ROW, CONFIGS / f"{EXTRA_CONFIG}.yaml", extra))
    for name, cfg_path, table in rows:
        if (args.only and args.only not in name) or name in table:
            continue
        exp = experiment_of(str(cfg_path))
        d = work / exp
        is_extra = table is extra
        k1.reset_launches()
        k2.reset_launches()
        try:
            if defaults:  # the CLI's batch, in one class folder (label 0)
                fabricate_dataset(d / "data_defaults", IMAGE_SIZE[exp], 1,
                                  n_per_class=cli_batch)
            else:
                fabricate_dataset(d / "data", IMAGE_SIZE[exp], N_CLASSES[exp])
            clf = fabricated(d / "classifier.msgpack",
                             lambda f: fabricate_classifier(f, exp, device))
            kind, ae = defense_type_of(str(cfg_path)), None
            if is_extra:
                ae = fabricated(d / "ours_ae_flow.msgpack", lambda f: fabricate_ours(
                    f, exp, device, nvae_config=FLOW_NVAE_CONFIG))
            elif kind == "ours":
                ae = fabricated(d / "ours_ae.msgpack", lambda f: fabricate_ours(f, exp, device))
            elif kind == "A-VAE":
                ae = fabricated(d / "avae.msgpack", lambda f: fabricate_avae(f, exp, device))
            elif kind == "ND-VAE":
                cfg = DefenseConfig.from_yaml(cfg_path)
                ae = fabricated(d / "ndvae.msgpack",
                                lambda f: fabricate_ndvae(f, exp, cfg, device))
            config = work / ("extra" if is_extra else "") / cfg_path.name
            copy_config(cfg_path, config, clf, ae)
            results_dir = work / "results" / name
            data = d / ("data_defaults" if defaults else "data")
            table[name] = run_config(name, config, data, results_dir, exp, device, cli_batch)
            print(f"[ok] {name} ({table[name]['secs']:.1f}s)", flush=True)
        except Exception as e:  # a failed config is a row; the matrix goes on
            traceback.print_exc()
            table[name] = {"ok": False, "error": f"{type(e).__name__}: {e}",
                           "k1_launches": k1.launches, "k2_launches": k2.launches}
            print(f"[FAIL] {name}: {table[name]['error']}", flush=True)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        write_report(partial=True)

    write_report(partial=False)
    n_ok = sum(1 for r in results.values() if r["ok"])
    n_extra = sum(1 for r in extra.values() if r["ok"])
    print(f"[done] {n_ok}/{len(results)} configs and {n_extra}/{len(extra)} extra rows ok "
          f"-> {out_path}", flush=True)
    return 0 if n_ok == len(results) and n_extra == len(extra) else 1


if __name__ == "__main__":
    sys.exit(main())
