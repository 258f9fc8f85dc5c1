"""The paper's third attack on the card: the staged L2 AutoAttack (APGD-CE at
the bounds 0.5, 1 and 4, APGD-DLR at 0.5, 2 and 4 where there are more than 3
classes, then FAB; attacks/autoattack.py) through eval/harness.run_benchmark,
one batch on each family's ours_cosine_noise defense at full width and
EoT-32, from fabricated files.

For each of configs/ours_cosine_noise_{ids,gender,cars}.yaml the purifier
and the classifier are fabricated at full width by smoke_all_configs'
functions (ids: the flagship NVAE and VGG11-BN over 100 classes; gender:
PSP(1024) and ResNet50; cars: StyleTransformer(512) and ResNeXt50), a copy
of the config points at them, and `load_defense` loads it at EoT-32 with the
EoT chunk the CLIs take at the family's batch (eval/factory.default_eot_chunk);
`GAT_COT_CHUNK` is read by the factory as always (unset: FAB's own block,
attacks/utils.class_block).

Labels: the BATCH images lie in one class folder (label 0), and the
classifier's head bias of class 0 is raised until every image is classified
as 0 under the harness's clean draw and MARGIN_DRAWS more draws, by the
margin a random head gives its own top class over its second (the median
over the images); otherwise the ensemble would find every image solved and
skip its stages.

Depth is the only cut: each APGD stage runs APGD_DEPTH iterations and FAB
FAB_DEPTH, where the paper's run takes attacks/autoattack.APGD_ITERS (64)
and FAB_ITERS (128); both constants are lowered for the run and restored.
A step's peak memory does not grow with the number of steps, so the cut
keeps the full run's peak.

The report holds per family: that results.json holds AutoAttack, the calls,
iterations, seconds and peak of each of the 7 stages and which were skipped
as solved (the DLR stages are absent below 4 classes), FAB's cotangent
block, the launches of K1 (ops/depthwise.py) and K2 (ops/upfirdn.py) held to
smoke_all_configs.path_kernels, the seconds of an APGD step (a call of n
iterations takes n + 1 gradients and one forward: its seconds / (n + 1)) and
of a FAB iteration (a call's seconds / n, its one starting forward
included), the projected seconds of one full-length batch (every stage at
its full depth), the peak of `torch.cuda.max_memory_allocated` around the
APGD calls and around FAB, and the card's line from nvidia-smi. The exit
code is 1 unless every family run is ok.

Usage: python3 -m gen_adversarial_tpu_torch.smoke_autoattack
    [--out AUTOATTACK_torch.json] [--only ids|gender|cars] [--device cuda]
    [--work DIR]
"""

from __future__ import annotations

import argparse
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

from gen_adversarial_tpu_torch.core.config import IMAGE_SIZE, N_CLASSES
from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset
from gen_adversarial_tpu_torch.eval import factory
from gen_adversarial_tpu_torch.eval.harness import run_benchmark
from gen_adversarial_tpu_torch.flagship import FLAGSHIP_NVAE
from gen_adversarial_tpu_torch.ops import depthwise as k1
from gen_adversarial_tpu_torch.ops import upfirdn as k2
from gen_adversarial_tpu_torch.smoke_all_configs import (
    check_launches, copy_config, device_line, fabricate_classifier, fabricate_dataset,
    fabricate_ours, label_all_as_zero, path_kernels, source_identity)

# the module, which the package's `autoattack` function shadows
aa = importlib.import_module("gen_adversarial_tpu_torch.attacks.autoattack")

REPO = Path(__file__).resolve().parents[1]
CONFIGS = REPO / "configs"
FAMILIES = ("ids", "gender", "cars")
NVAE_CONFIG = FLAGSHIP_NVAE
EOT_STEPS = 32
# the CLI's default batch (cli/test_defense.py)
BATCH = {"ids": 8, "gender": 8, "cars": 8}
APGD_DEPTH, FAB_DEPTH = 2, 2
SEED = 42  # run_benchmark's default seed: its clean draw is the labels' draw
MARGIN_DRAWS = 2  # draws besides the harness's clean one that must agree
STAGES = ("apgd_ce_0.5", "apgd_ce_1", "apgd_ce_4", "apgd_dlr_0.5", "apgd_dlr_2",
          "apgd_dlr_4", "fab")
# the stages the staged ensemble runs even when every image is solved
ALWAYS_RUN = ("apgd_ce_0.5", "apgd_dlr_0.5", "fab")


def eot_chunk(experiment: str) -> int | None:
    """The EoT chunk the CLIs take for the family's ours_* config at its
    batch (eval/factory.default_eot_chunk)."""
    return factory.default_eot_chunk(experiment, "ours", BATCH[experiment], EOT_STEPS)


def expected_stages(n_classes: int) -> tuple:
    """The stages of the ensemble at n_classes (no DLR at 3 or fewer)."""
    return tuple(s for s in STAGES if n_classes > 3 or "dlr" not in s)


class StageRecorder:
    """attacks/autoattack's apgd_attack and fab_attack, wrapped to record per
    stage the calls, iterations, seconds (synchronized) and peak memory;
    install() swaps them in for the run, with the lowered depths, and
    restore() puts the module back as it was."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stages = {s: {"calls": 0, "iterations": 0, "seconds": 0.0, "peak_gib": None}
                       for s in STAGES}
        self.fab_blocks = []
        self.saved = None

    def _timed(self, stage, n_iter, fn):
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t = time.monotonic()
        out = fn()
        if cuda:
            torch.cuda.synchronize(self.device)
        row = self.stages[stage]
        row["calls"] += 1
        row["iterations"] += n_iter
        row["seconds"] += time.monotonic() - t
        if cuda:
            peak = torch.cuda.max_memory_allocated(self.device) / 2**30
            row["peak_gib"] = max(row["peak_gib"] or 0.0, peak)
        return out

    def install(self) -> None:
        self.saved = (aa.apgd_attack, aa.fab_attack, aa.APGD_ITERS, aa.FAB_ITERS)
        apgd, fab = aa.apgd_attack, aa.fab_attack

        def apgd_attack(net, images, labels, generator, n_iter, rho, max_bound, ce_loss):
            stage = f"apgd_{'ce' if ce_loss else 'dlr'}_{max_bound:g}"
            return self._timed(stage, n_iter, lambda: apgd(
                net, images, labels, generator, n_iter, rho, max_bound, ce_loss))

        def fab_attack(net, images, labels, generator, n_iter, **kw):
            self.fab_blocks.append(kw.get("cotangent_chunk"))
            return self._timed("fab", n_iter, lambda: fab(net, images, labels, generator,
                                                          n_iter, **kw))

        aa.apgd_attack, aa.fab_attack = apgd_attack, fab_attack
        aa.APGD_ITERS, aa.FAB_ITERS = APGD_DEPTH, FAB_DEPTH

    def restore(self) -> None:
        aa.apgd_attack, aa.fab_attack, aa.APGD_ITERS, aa.FAB_ITERS = self.saved


def run_family(experiment: str, work: Path, device: torch.device) -> dict:
    """Fabricate, load, label and attack one family's batch; the row
    (raises where a step fails)."""
    cuda = device.type == "cuda"
    name = f"ours_cosine_noise_{experiment}"
    d = work / experiment
    n_classes, batch = N_CLASSES[experiment], BATCH[experiment]
    t0 = time.monotonic()
    data = d / "data"
    shutil.rmtree(data, ignore_errors=True)
    fabricate_dataset(data, IMAGE_SIZE[experiment], 1, n_per_class=batch)
    clf, ae = d / "classifier.msgpack", d / "ours_ae.msgpack"
    if not (clf.exists() and clf.with_suffix(".json").exists()):
        fabricate_classifier(clf, experiment, device)
    if not (ae.exists() and ae.with_suffix(".json").exists()):
        fabricate_ours(ae, experiment, device, nvae_config=NVAE_CONFIG)
    config = d / f"{name}.yaml"
    copy_config(CONFIGS / f"{name}.yaml", config, clf, ae)
    fabricate_s = time.monotonic() - t0

    t = time.monotonic()
    loaded = factory.load_defense(str(config), eot_steps=EOT_STEPS,
                                  eot_chunk=eot_chunk(experiment), device=device)
    if cuda:
        torch.cuda.synchronize(device)
    load_s = time.monotonic() - t
    dataset = ImageLabelDataset(str(data), loaded.image_size)
    images = torch.tensor(np.stack([dataset.load_image(i) for i in range(batch)]),
                          device=device)
    labels = label_all_as_zero(loaded, images, device, SEED, MARGIN_DRAWS)

    results = d / "results"
    shutil.rmtree(results, ignore_errors=True)
    recorder = StageRecorder(device)
    k1.reset_launches()
    k2.reset_launches()
    recorder.install()
    msgs = []
    try:
        t = time.monotonic()
        res = run_benchmark(loaded, str(data), str(results), batch_size=batch, seed=SEED,
                            attack_filter="autoattack", max_images=batch, plots=False,
                            log_fn=msgs.append)
        attack_s = time.monotonic() - t
    finally:
        recorder.restore()
    launches = {"K1": k1.launches, "K2": k2.launches}

    written = json.loads((results / "results.json").read_text())
    if len(written.get("AutoAttack", [])) != batch:
        raise RuntimeError(f"results.json holds {sorted(written)}, AutoAttack "
                           f"{written.get('AutoAttack')}")
    stages = recorder.stages
    expected = expected_stages(n_classes)
    absent = [s for s in STAGES if s not in expected]
    wrong = [s for s in STAGES
             if stages[s]["calls"] > 1 or stages[s]["iterations"] != stages[s]["calls"] * (
                 FAB_DEPTH if s == "fab" else APGD_DEPTH)
             or (s in absent and stages[s]["calls"])
             or (s in ALWAYS_RUN and s in expected and not stages[s]["calls"])]
    if wrong:
        raise RuntimeError(f"stages {wrong} ran otherwise than the ensemble runs them: "
                           f"{stages}")
    check_launches(launches, path_kernels(name, experiment, device))

    ran = [s for s in expected if stages[s]["calls"]]
    apgd = [s for s in ran if s != "fab"]
    apgd_s = sum(stages[s]["seconds"] for s in apgd)
    apgd_step_s = apgd_s / sum(stages[s]["iterations"] + stages[s]["calls"] for s in apgd)
    fab_iter_s = stages["fab"]["seconds"] / stages["fab"]["iterations"]
    n_apgd = len(expected) - 1
    full_apgd_steps = n_apgd * (recorder.saved[2] + 1)
    full_fab_iters = recorder.saved[3]

    def peak(names):
        values = [stages[s]["peak_gib"] for s in names if stages[s]["peak_gib"] is not None]
        return max(values) if values else None

    return {"ok": True, "config": name, "batch": batch, "eot_steps": EOT_STEPS,
            "eot_chunk": loaded.eot_chunk, "n_classes": n_classes,
            "gat_cot_chunk": os.environ.get("GAT_COT_CHUNK"),
            "fab_block": recorder.fab_blocks[0], "clean": res["Clean"],
            "autoattack": written["AutoAttack"], "labels": labels,
            "stages": stages, "stages_run": ran,
            "skipped_as_solved": [s for s in expected if not stages[s]["calls"]],
            "absent": absent, "apgd_depth": APGD_DEPTH, "fab_depth": FAB_DEPTH,
            "apgd_step_s": apgd_step_s, "fab_iteration_s": fab_iter_s,
            "full_apgd_steps": full_apgd_steps, "full_fab_iterations": full_fab_iters,
            "projected_full_batch_s": apgd_step_s * full_apgd_steps
            + fab_iter_s * full_fab_iters,
            "apgd_peak_gib": peak(apgd), "fab_peak_gib": peak(["fab"]),
            "k1_launches": launches["K1"], "k2_launches": launches["K2"],
            "fabricate_s": fabricate_s, "load_s": load_s, "attack_s": attack_s,
            "secs": time.monotonic() - t0, "log": [str(m) for m in msgs]}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser("the staged AutoAttack on the card, one batch a family")
    p.add_argument("--out", default=str(REPO / "AUTOATTACK_torch.json"))
    p.add_argument("--only", choices=FAMILIES, default=None)
    p.add_argument("--work", default=str(REPO / ".scratch" / "smoke_autoattack"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = factory.resolve_device(args.device, "smoke_autoattack")
    work = Path(args.work)
    out_path = Path(args.out)
    families = {}
    if out_path.exists():  # a run of one family keeps the others' rows
        try:
            families = json.loads(out_path.read_text()).get("families", {})
        except (json.JSONDecodeError, OSError):
            families = {}
    header = {"backend": device.type,
              "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
              "nvidia_smi": device_line(device), "torch": torch.__version__,
              "cuda": torch.version.cuda, **source_identity(), "eot_steps": EOT_STEPS,
              "batch": BATCH, "eot_chunk": {f: eot_chunk(f) for f in FAMILIES},
              "apgd_depth": APGD_DEPTH,
              "fab_depth": FAB_DEPTH, "full_apgd_iters": aa.APGD_ITERS,
              "full_fab_iters": aa.FAB_ITERS}
    run = [f for f in FAMILIES if args.only in (None, f)]
    for experiment in run:
        try:
            families[experiment] = run_family(experiment, work, device)
            row = families[experiment]
            print(f"[ok] {experiment}: stages {row['stages_run']}, APGD "
                  f"{row['apgd_step_s']:.2f} s a step at {row['apgd_peak_gib']} GiB, FAB "
                  f"{row['fab_iteration_s']:.2f} s an iteration at {row['fab_peak_gib']} GiB, "
                  f"projected {row['projected_full_batch_s']:.0f} s a batch", flush=True)
        except Exception as e:  # a failed family is a row; the others go on
            traceback.print_exc()
            families[experiment] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            print(f"[FAIL] {experiment}: {families[experiment]['error']}", flush=True)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps({**header, "families": families}, indent=2))
    ok = all(families[f]["ok"] for f in run)
    print(f"[done] {sum(families[f]['ok'] for f in run)}/{len(run)} families ok -> {out_path}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
