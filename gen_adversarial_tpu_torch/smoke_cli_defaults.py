"""The paper's commands on one card as the README gives them: for each of
configs/ours_cosine_noise_{ids,gender,cars}.yaml, cli/test_defense.py with
no flag but the paths and --max-images 8 (DeepFool, C&W and the staged
AutoAttack on one batch of the CLI's 8 images at EoT-32), then
cli/alpha_search.py's make-adv (--n-samples 8) and its grid and bo searches
(--n-steps 2) on the made set, each at the CLI's defaults: the EoT chunk is
the one the CLIs choose (eval/factory.default_eot_chunk) and the attacks'
class blocks their own (attacks/utils.class_block). No GAT_* variable may be
set: the run refuses to start under one.

Set-up, per family: the purifier and the classifier at full width from
smoke_all_configs' functions (random weights from its seed), the 8 images
in one class folder (label 0), and two copies of the config. The evaluation's
classifier has its class-0 bias raised until every image is classified 0
under the CLI's clean draw (smoke_all_configs.label_all_as_zero), so that
the attacks have work; the search's has it raised by the median over the
images of the runner-up's lead under that draw, so that some images sit
near the boundary FGSM has to cross. Both classifiers are written as
checkpoint files for the CLIs to load. grid and bo take the made set, or
the clean images where make-adv kept none (the row says which).

Depth is the only cut, as in smoke_autoattack: DeepFool runs DEEPFOOL_ITERS
steps, C&W CW_STEPS steps of CW_RESTARTS restart, each AutoAttack stage
APGD_ITERS iterations and FAB FAB_ITERS; the constants are set for the run
and restored after it. A step's peak does not grow with the number of steps,
so the cut keeps the full run's peak.

The report holds per family and command: ok (or the error), seconds, the
peak of torch.cuda.max_memory_allocated, the EoT chunks the CLI loaded with,
the class blocks DeepFool's and FAB's class Jacobians took, the launches of
K1 (ops/depthwise.py) and K2 (ops/upfirdn.py) held to
smoke_all_configs.path_kernels; and the card's nvidia-smi line and capacity.
The exit code is 1 unless every row is ok with its peak under the card's
capacity. A command that runs out of memory is a failed row: nothing retries
at a smaller chunk.

Usage: python3 -m gen_adversarial_tpu_torch.smoke_cli_defaults
    [--out CLI_DEFAULTS_torch.json] [--only ids|gender|cars] [--work DIR]
    [--device cpu]  (cpu passes --device cpu to the CLIs: a rehearsal)
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import os
import shutil
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from gen_adversarial_tpu_torch.cli import alpha_search, test_defense
from gen_adversarial_tpu_torch.core.checkpoint import save_variables
from gen_adversarial_tpu_torch.core.config import ATTACK_SUITES, IMAGE_SIZE
from gen_adversarial_tpu_torch.core.convert import to_jax_variables
from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset
from gen_adversarial_tpu_torch.eval import factory
from gen_adversarial_tpu_torch.eval.harness import ATTACK_JSON_NAMES, batch_generator
from gen_adversarial_tpu_torch.flagship import FLAGSHIP_NVAE
from gen_adversarial_tpu_torch.models.classifiers import Projector
from gen_adversarial_tpu_torch.ops import depthwise as k1
from gen_adversarial_tpu_torch.ops import upfirdn as k2
from gen_adversarial_tpu_torch.search import alphas as search_alphas
from gen_adversarial_tpu_torch.smoke_all_configs import (
    capacity_gib, check_launches, copy_config, device_line, fabricate_classifier,
    fabricate_dataset, fabricate_ours, label_all_as_zero, path_kernels, source_identity)

# the modules, which the package's functions of the same names shadow
aa = importlib.import_module("gen_adversarial_tpu_torch.attacks.autoattack")
deepfool_module = importlib.import_module("gen_adversarial_tpu_torch.attacks.deepfool")
fab_module = importlib.import_module("gen_adversarial_tpu_torch.attacks.fab")

REPO = Path(__file__).resolve().parents[1]
CONFIGS = REPO / "configs"
FAMILIES = ("ids", "gender", "cars")
COMMANDS = ("test_defense", "make_adv", "grid", "bo")
NVAE_CONFIG = FLAGSHIP_NVAE
# the CLIs' defaults: --batch-size 8, --eot-steps 32, test_defense's --seed
BATCH, EOT_STEPS, SEED = 8, 32, 42
MAX_IMAGES = SEARCH_SAMPLES = 8
SEARCH_STEPS = 2
DEEPFOOL_ITERS, CW_STEPS, CW_RESTARTS = 2, 2, 1
APGD_ITERS, FAB_ITERS = 1, 1
# flags added to every CLI call: none on the card, where the commands run as
# written; a rehearsal on the CPU shrinks the batch and the EoT with them
# (and sets BATCH, EOT_STEPS and MAX_IMAGES to match)
CLI_FLAGS: list = []


class Recorder:
    """For the run: the attacks' depths cut (ATTACK_SUITES' DeepFool and C&W
    entries, autoattack's APGD_ITERS and FAB_ITERS), and recorders around
    factory.load_defense (the EoT chunk loaded), the AlphaEvaluator (the
    chunk it is given) and DeepFool's and FAB's class_grads (the block each
    call takes); restore() puts every name back as it was."""

    def __init__(self):
        self.saved = None
        self.reset()

    def reset(self) -> None:
        self.eot_chunks, self.blocks = [], {"deepfool": [], "fab": []}

    def install(self) -> None:
        self.saved = (dict(ATTACK_SUITES), aa.APGD_ITERS, aa.FAB_ITERS, factory.load_defense,
                      search_alphas.AlphaEvaluator, deepfool_module.class_grads,
                      fab_module.class_grads)
        suites, _, _, load_defense, evaluator, df_grads, fab_grads = self.saved
        for name, suite in suites.items():
            ATTACK_SUITES[name] = dataclasses.replace(
                suite, deepfool_max_iter=DEEPFOOL_ITERS, cw_steps=CW_STEPS,
                cw_n_restarts=CW_RESTARTS)
        aa.APGD_ITERS, aa.FAB_ITERS = APGD_ITERS, FAB_ITERS

        def recorded_load(*args, **kw):
            loaded = load_defense(*args, **kw)
            self.eot_chunks.append(loaded.eot_chunk)
            return loaded

        def recorded_evaluator(*args, **kw):
            self.eot_chunks.append(kw.get("eot_chunk"))
            return evaluator(*args, **kw)

        def blocks_of(attack, class_grads):
            def recorded(*args, **kw):
                self.blocks[attack].append(kw.get("cotangent_chunk"))
                return class_grads(*args, **kw)
            return recorded

        factory.load_defense = recorded_load
        search_alphas.AlphaEvaluator = recorded_evaluator
        deepfool_module.class_grads = blocks_of("deepfool", df_grads)
        fab_module.class_grads = blocks_of("fab", fab_grads)

    def restore(self) -> None:
        suites, aa.APGD_ITERS, aa.FAB_ITERS, factory.load_defense, \
            search_alphas.AlphaEvaluator, deepfool_module.class_grads, \
            fab_module.class_grads = self.saved
        ATTACK_SUITES.clear()
        ATTACK_SUITES.update(suites)


def _save_classifier(path: Path, classifier: torch.nn.Module, experiment: str) -> None:
    save_variables(path, to_jax_variables(classifier),
                   {"model_type": factory.CLASSIFIER_TYPE[experiment]})


def prepare(experiment: str, work: Path, device: torch.device) -> dict:
    """The family's files: images, purifier, the evaluation's and the
    search's classifiers and config copies (module docstring)."""
    name = f"ours_cosine_noise_{experiment}"
    d = work / experiment
    t0 = time.monotonic()
    data = d / "data"
    shutil.rmtree(data, ignore_errors=True)
    fabricate_dataset(data, IMAGE_SIZE[experiment], 1, n_per_class=MAX_IMAGES)
    clf, ae = d / "classifier.msgpack", d / "ours_ae.msgpack"
    if not (clf.exists() and clf.with_suffix(".json").exists()):
        fabricate_classifier(clf, experiment, device)
    if not (ae.exists() and ae.with_suffix(".json").exists()):
        fabricate_ours(ae, experiment, device, nvae_config=NVAE_CONFIG)
    configs = {"eval": d / "eval" / f"{name}.yaml", "search": d / "search" / f"{name}.yaml"}
    copy_config(CONFIGS / f"{name}.yaml", configs["eval"], clf, ae)

    # the labels: the CLI's clean draw of its one batch, at the chunk it takes
    chunk = factory.default_eot_chunk(experiment, "ours", BATCH, EOT_STEPS)
    loaded = factory.load_defense(str(configs["eval"]), eot_steps=EOT_STEPS, eot_chunk=chunk,
                                  device=device)
    dataset = ImageLabelDataset(str(data), loaded.image_size)
    images = torch.tensor(np.stack([dataset.load_image(i) for i in range(MAX_IMAGES)]),
                          device=device)
    with torch.no_grad():
        logits = loaded.net(images, batch_generator(SEED, 0, 0, 0, device))
    lead = (logits[:, 1:].max(1).values - logits[:, 0]).median().item()
    head = next(m for m in loaded.defense.classifier.modules() if isinstance(m, Projector))
    bias = head.fc1.bias[0].item()
    labels = label_all_as_zero(loaded, images, device, SEED, 0)
    files = {"eval": d / "classifier_eval.msgpack", "search": d / "classifier_search.msgpack"}
    _save_classifier(files["eval"], loaded.defense.classifier, experiment)
    with torch.no_grad():
        head.fc1.bias[0] = bias + lead
    _save_classifier(files["search"], loaded.defense.classifier, experiment)
    for role in configs:
        copy_config(CONFIGS / f"{name}.yaml", configs[role], files[role], ae)
    del loaded, images, logits
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"config": name, "data": data, "configs": configs, "eval_labels": labels,
            "search_bias_raise": lead, "setup_s": time.monotonic() - t0}


def run_command(recorder: Recorder, command: str, fn, config_name: str, experiment: str,
                device: torch.device) -> tuple:
    """fn() (one CLI call) with the recorders reset; its row and its result
    (raises where the call fails, its launches are not its path's, or its
    peak reached the card's capacity)."""
    cuda = device.type == "cuda"
    recorder.reset()
    k1.reset_launches()
    k2.reset_launches()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t = time.monotonic()
    result = fn()
    if cuda:
        torch.cuda.synchronize(device)
    row = {"ok": True, "s": time.monotonic() - t,
           "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
           "eot_chunks": sorted(set(recorder.eot_chunks), key=str),
           "deepfool_blocks": sorted(set(recorder.blocks["deepfool"]), key=str),
           "fab_blocks": sorted(set(recorder.blocks["fab"]), key=str),
           "k1_launches": k1.launches, "k2_launches": k2.launches}
    check_launches({"K1": k1.launches, "K2": k2.launches},
                   path_kernels(config_name, experiment, device))
    if cuda and row["peak_gib"] >= capacity_gib(device):
        raise RuntimeError(f"{command}: peak {row['peak_gib']:.2f} GiB reached the card's "
                           f"{capacity_gib(device):.2f}")
    return row, result


def run_family(recorder: Recorder, experiment: str, work: Path, device: torch.device,
               device_flags: list) -> dict:
    """The family's set-up and its four commands; a failed command is a row
    and the next one runs."""
    setup = prepare(experiment, work, device)
    d = work / experiment
    name, data, configs = setup["config"], setup["data"], setup["configs"]
    rows, out = {}, {k: v for k, v in setup.items() if k not in ("data", "configs")}
    adv = d / "adv"
    for path in (d / "results", adv, d / "grid", d / "bo"):
        shutil.rmtree(path, ignore_errors=True)  # no earlier run's files or progress

    def evaluation():
        argv = ["--config", str(configs["eval"]), "--images-path", str(data),
                "--results-folder", str(d / "results"), "--max-images", str(MAX_IMAGES)]
        res = test_defense.main(argv + device_flags)
        written = json.loads((d / "results" / "results.json").read_text())
        lists = {k: written.get(v) for k, v in ATTACK_JSON_NAMES.items()}
        if written != res or any(v is None or len(v) != MAX_IMAGES for v in lists.values()):
            raise RuntimeError(f"results.json holds {sorted(written)}: {lists}")
        return written

    def make_adv():
        return alpha_search.main(["--mode", "make-adv", "--config", str(configs["search"]),
                                  "--images-path", str(data), "--out-dir", str(adv),
                                  "--n-samples", str(SEARCH_SAMPLES)] + device_flags)

    def search(mode):
        def run():
            made = adv.exists() and any(adv.rglob("*.png"))
            out[f"{mode}_set"] = "made" if made else "clean (make-adv kept none)"
            xs, accs = alpha_search.main(
                ["--mode", mode, "--config", str(configs["search"]), "--adv-images-path",
                 str(adv if made else data), "--n-steps", str(SEARCH_STEPS),
                 "--results-folder", str(d / mode)] + device_flags)
            return {"rows": int(xs.shape[0]), "best_accuracy": float(accs.max())}
        return run

    calls = {"test_defense": evaluation, "make_adv": make_adv, "grid": search("grid"),
             "bo": search("bo")}
    for command in COMMANDS:
        try:
            rows[command], result = run_command(recorder, command, calls[command], name,
                                                experiment, device)
            if command == "test_defense":
                rows[command]["results"] = result
            elif command == "make_adv":
                rows[command]["kept"] = result
            else:
                rows[command].update(result)
            print(f"[ok] {experiment} {command}: {rows[command]['s']:.1f} s, peak "
                  f"{rows[command]['peak_gib']} GiB, EoT chunks {rows[command]['eot_chunks']}, "
                  f"DeepFool blocks {rows[command]['deepfool_blocks']}, FAB blocks "
                  f"{rows[command]['fab_blocks']}", flush=True)
        except Exception as e:  # a failed command is a row; the next one runs
            traceback.print_exc()
            rows[command] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            print(f"[FAIL] {experiment} {command}: {rows[command]['error']}", flush=True)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out["ok"] = all(rows[c]["ok"] for c in COMMANDS)
    out["commands"] = rows
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser("the paper's commands at the CLIs' defaults")
    p.add_argument("--out", default=str(REPO / "CLI_DEFAULTS_torch.json"))
    p.add_argument("--only", choices=FAMILIES, default=None)
    p.add_argument("--work", default=str(REPO / ".scratch" / "smoke_cli_defaults"))
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the CLIs' own) or cpu (--device cpu to the CLIs)")
    args = p.parse_args(argv)
    set_vars = sorted(k for k in os.environ if k.startswith("GAT_"))
    if set_vars:
        raise RuntimeError(f"the commands must run at their defaults: unset {set_vars}")
    device = factory.resolve_device(args.device, "smoke_cli_defaults")
    device_flags = CLI_FLAGS + ([] if device.type == "cuda" else ["--device", "cpu"])
    work, out_path = Path(args.work), Path(args.out)
    families = {}
    if out_path.exists():  # a run of one family keeps the others' rows
        try:
            families = json.loads(out_path.read_text()).get("families", {})
        except (json.JSONDecodeError, OSError):
            families = {}
    cuda = device.type == "cuda"
    header = {"backend": device.type,
              "device": torch.cuda.get_device_name(device) if cuda else "cpu",
              "nvidia_smi": device_line(device), "torch": torch.__version__,
              "cuda": torch.version.cuda, **source_identity(),
              "capacity_gib": capacity_gib(device) if cuda else None,
              "batch": BATCH, "eot_steps": EOT_STEPS, "max_images": MAX_IMAGES,
              "eot_chunk": {f: factory.default_eot_chunk(f, "ours", BATCH, EOT_STEPS)
                            for f in FAMILIES},
              "depth": {"deepfool_max_iter": DEEPFOOL_ITERS, "cw_steps": CW_STEPS,
                        "cw_n_restarts": CW_RESTARTS, "apgd_iters": APGD_ITERS,
                        "fab_iters": FAB_ITERS},
              "search": {"n_samples": SEARCH_SAMPLES, "n_steps": SEARCH_STEPS},
              "cli_flags": device_flags}
    recorder = Recorder()
    run = [f for f in FAMILIES if args.only in (None, f)]
    recorder.install()
    try:
        for experiment in run:
            try:
                families[experiment] = run_family(recorder, experiment, work, device,
                                                  device_flags)
            except Exception as e:  # a failed set-up is a row; the others go on
                traceback.print_exc()
                families[experiment] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                print(f"[FAIL] {experiment}: {families[experiment]['error']}", flush=True)
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            out_path.parent.mkdir(parents=True, exist_ok=True)
            out_path.write_text(json.dumps({**header, "families": families}, indent=2))
    finally:
        recorder.restore()
    ok = all(families[f]["ok"] for f in run)
    print(f"[done] {sum(families[f]['ok'] for f in run)}/{len(run)} families ok -> {out_path}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
