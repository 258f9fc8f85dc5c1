"""The staged-AutoAttack smoke (gen_adversarial_tpu_torch/smoke_autoattack.py)
on the CPU, small: the small ids, gender and cars defenses of
tests/test_torch_smoke_matrix.py (its patched constructors, the small NVAE
of tests/test_torch_factory.py, the configs' alphas resampled to the small
purifiers), with a shallow IR-SE trunk in the gender and cars encoders
(ShallowTrunk) and gender's images at 64 px, one image a family at EoT-1,
each stage at 1 iteration: about 50 s of one CPU thread. One run
of `main` over the three families: each reaches the stages the ensemble
runs at its class count (7 with ids' 100 classes and cars' 4, no APGD-DLR
with gender's 2), results.json holds AutoAttack, and the attacks' depths
and functions are restored after the run. Then the paper's commands at the
CLIs' defaults (gen_adversarial_tpu_torch/smoke_cli_defaults.py) rehearsed
on the small ids family: test_defense, make-adv, grid and bo."""

import importlib
import json
from pathlib import Path

import pytest
import torch

import gen_adversarial_tpu_torch.attack_memory as attack_memory
import gen_adversarial_tpu_torch.eval.factory as factory
import gen_adversarial_tpu_torch.smoke_autoattack as smoke
import gen_adversarial_tpu_torch.smoke_cli_defaults as cli_smoke
from gen_adversarial_tpu_torch.attacks import utils as attack_utils
from gen_adversarial_tpu_torch.core.config import ATTACK_SUITES, IMAGE_SIZE, read_flat_yaml
from gen_adversarial_tpu_torch.core.config import N_LATENTS as CONFIG_N_LATENTS
from gen_adversarial_tpu_torch.gender import resampled_alphas
from gen_adversarial_tpu_torch.models.e4e import encoder as e4e_encoder
from gen_adversarial_tpu_torch.models.e4e.psp import PSP
from gen_adversarial_tpu_torch.models.nvae.model import NVAEConfig
from gen_adversarial_tpu_torch.models.style_transformer import encoder as st_encoder
from gen_adversarial_tpu_torch.models.style_transformer.model import StyleTransformer
from tests.test_torch_factory import NVAE_CFG
from tests.test_torch_smoke_matrix import N_LATENTS, _small_classifier
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parents[1]
aa = importlib.import_module("gen_adversarial_tpu_torch.attacks.autoattack")
# the gender images here (the family's are 256 px): the E4E encoder sees
# them at this size; the decode is pooled to 256 px for the ResNet either way
GENDER_SIZE = 64


class ShallowTrunk(e4e_encoder.IRSE50Trunk):
    """IR-SE-50's input layer and the first bottleneck of each of its four
    stages (their widths and strides), tapped after stages 2, 3 and 4 as
    IR-SE-50 is: the gender and cars encoders' trunk here. With the full
    trunk of 24 bottlenecks a cars APGD step took 3.25 s of one CPU thread
    (this one 1.82 s)."""

    def __init__(self, device=None):
        torch.nn.Module.__init__(self)
        full = e4e_encoder.irse50_blocks()
        self.input_conv = torch.nn.Conv2d(3, 64, 3, padding=1, bias=False, device=device)
        self.input_bn = e4e_encoder._bn(64, device)
        self.input_prelu = e4e_encoder.PReLU(64, device=device)
        self.body = torch.nn.ModuleList(e4e_encoder.BottleneckIRSE(*full[i], device=device)
                                        for i in (0, 3, 7, 21))

    def forward(self, x):
        x = self.input_prelu(self.input_bn(self.input_conv(x)))
        taps = []
        for block in self.body:
            x = block(x)
            taps.append(x)
        return tuple(taps[1:])


def _small_configs(root: Path) -> Path:
    """Copies of the three ours_cosine_noise configs, alphas resampled."""
    for family in smoke.FAMILIES:
        name = f"ours_cosine_noise_{family}"
        text = (REPO / "configs" / f"{name}.yaml").read_text()
        alphas = read_flat_yaml(REPO / "configs" / f"{name}.yaml")["interpolation_alphas"]
        small = resampled_alphas(alphas, 1.0, N_LATENTS[family])
        lines = [ln for ln in text.splitlines() if not ln.startswith("- ")]
        at = lines.index("interpolation_alphas:") + 1
        lines[at:at] = [f"- {a:.4f}" for a in small]
        (root / f"{name}.yaml").write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One run of main over the three families; (exit code, report, work
    dir, the autoattack module's depths and functions before and after)."""
    tmp = tmp_path_factory.mktemp("autoattack")
    out, work = tmp / "AUTOATTACK.json", tmp / "work"
    configs = tmp / "configs"
    configs.mkdir()
    state = lambda: (aa.APGD_ITERS, aa.FAB_ITERS, aa.apgd_attack, aa.fab_attack)  # noqa: E731
    before = state()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(factory, "make_classifier", _small_classifier)
        mp.setattr(factory, "PSP", lambda size, device: PSP(32, device=device))
        mp.setattr(factory, "StyleTransformer",
                   lambda size, device: StyleTransformer(32, device=device))
        mp.setattr(smoke, "NVAE_CONFIG", NVAEConfig(**NVAE_CFG))
        mp.setattr(smoke, "CONFIGS", _small_configs(configs))
        mp.setattr(smoke, "BATCH", {f: 1 for f in smoke.FAMILIES})
        mp.setattr(smoke, "EOT_STEPS", 1)
        mp.setattr(smoke, "MARGIN_DRAWS", 0)
        mp.setattr(e4e_encoder, "IRSE50Trunk", ShallowTrunk)
        mp.setattr(st_encoder, "IRSE50Trunk", ShallowTrunk)
        mp.setitem(IMAGE_SIZE, "gender", GENDER_SIZE)
        mp.setattr(smoke, "APGD_DEPTH", 1)
        mp.setattr(smoke, "FAB_DEPTH", 1)
        code = smoke.main(["--out", str(out), "--work", str(work), "--device", "cpu"])
    return code, json.loads(out.read_text()), work, before, state()


@pytest.mark.parametrize("family", ["ids", "gender", "cars"])
def test_each_family_reaches_its_stages(run, family):
    """The family's row is ok: every stage of its class count ran once at
    the cut depth, or was skipped because every image was already solved
    (only the higher bounds of a chain can be); no APGD-DLR below 4
    classes; results.json holds AutoAttack's distance of the image; the
    projection counts every stage at full depth; no kernel launched (CPU)."""
    code, report, work, _, _ = run
    row = report["families"][family]
    assert row["ok"], row
    expected = smoke.expected_stages(row["n_classes"])
    assert len(expected) == (4 if family == "gender" else 7)
    assert row["absent"] == ([s for s in smoke.STAGES if "dlr" in s] if family == "gender"
                             else [])
    assert sorted(row["stages_run"] + row["skipped_as_solved"]) == sorted(expected)
    for stage in smoke.ALWAYS_RUN:
        if stage in expected:
            assert stage in row["stages_run"]
    for stage, rec in row["stages"].items():
        ran = stage in row["stages_run"]
        assert rec["calls"] == int(ran) and rec["iterations"] == int(ran)
        assert (rec["seconds"] > 0) == ran and rec["peak_gib"] is None
    assert row["clean"] == 1.0 and row["batch"] == 1 and row["eot_steps"] == 1
    results = json.loads((work / family / "results" / "results.json").read_text())
    assert results["AutoAttack"] == row["autoattack"] and len(results["AutoAttack"]) == 1
    assert row["full_apgd_steps"] == (len(expected) - 1) * (aa.APGD_ITERS + 1)
    assert row["full_fab_iterations"] == aa.FAB_ITERS
    assert row["projected_full_batch_s"] == pytest.approx(
        row["apgd_step_s"] * row["full_apgd_steps"]
        + row["fab_iteration_s"] * row["full_fab_iterations"])
    assert row["k1_launches"] == row["k2_launches"] == 0 and row["apgd_peak_gib"] is None
    assert row["fab_block"] == attack_utils.class_block(row["n_classes"], 1)


def test_the_run_restores_the_attacks_depths(run):
    """The exit code is 0; the report's header names the full depths; the
    autoattack module's APGD_ITERS, FAB_ITERS and attack functions are the
    same objects after the run as before it."""
    code, report, _, before, after = run
    assert code == 0
    assert (report["full_apgd_iters"], report["full_fab_iters"]) == (64, 128)
    assert (report["apgd_depth"], report["fab_depth"]) == (1, 1)
    assert report["backend"] == "cpu" and report["nvidia_smi"] == "not available"
    assert after == before
    assert before[:2] == (64, 128)


def test_cuda_without_a_device_raises(tmp_path):
    """Both scripts that measure on the card raise without one, writing
    nothing (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        smoke.main(["--out", str(tmp_path / "A.json"), "--work", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        attack_memory.main(["--out", str(tmp_path / "M.json")])
    assert not list(tmp_path.iterdir())


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """One run of smoke_cli_defaults.main on the small ids family (the
    matrix test's small VGG, test_torch_factory's NVAE with 4 latent groups),
    rehearsed at batch 2 and EoT-2 over 2 images (CLI_FLAGS), the draw budget
    and the class blocks' cotangent samples lowered so that both defaults
    act there: an EoT chunk of 1 and blocks of 2 classes. Returns (exit
    code, report, work dir, the names the run swaps before and after)."""
    tmp = tmp_path_factory.mktemp("cli_defaults")
    out, work = tmp / "CLI_DEFAULTS.json", tmp / "work"
    configs = tmp / "configs"
    configs.mkdir()
    state = lambda: (dict(ATTACK_SUITES), aa.APGD_ITERS, aa.FAB_ITERS,  # noqa: E731
                     factory.load_defense, cli_smoke.search_alphas.AlphaEvaluator,
                     cli_smoke.deepfool_module.class_grads, cli_smoke.fab_module.class_grads)
    before = state()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(factory, "make_classifier", _small_classifier)
        mp.setattr(cli_smoke, "NVAE_CONFIG", NVAEConfig(**NVAE_CFG))
        mp.setattr(cli_smoke, "CONFIGS", _small_configs(configs))
        mp.setitem(CONFIG_N_LATENTS, "ids", N_LATENTS["ids"])
        mp.setattr(cli_smoke, "CLI_FLAGS", ["--batch-size", "2", "--eot-steps", "2"])
        mp.setattr(cli_smoke, "BATCH", 2)
        mp.setattr(cli_smoke, "EOT_STEPS", 2)
        mp.setattr(cli_smoke, "MAX_IMAGES", 2)
        mp.setattr(cli_smoke, "SEARCH_SAMPLES", 2)
        mp.setattr(cli_smoke, "SEARCH_STEPS", 1)
        mp.setitem(factory.EOT_DRAW_BUDGET, ("ids", "ours"), 2)
        mp.setattr(attack_utils, "COT_SAMPLES", 4)
        code = cli_smoke.main(["--out", str(out), "--work", str(work), "--device", "cpu",
                               "--only", "ids"])
    return code, json.loads(out.read_text()), work, before, state()


def test_cli_defaults_runs_every_command(cli_run):
    """Exit 0 and the report's ids row: test_defense wrote DeepFool, C&W and
    AutoAttack for the 2 images, every command loaded at the default chunk
    (1), DeepFool's and FAB's Jacobians took the default block (2 classes),
    make-adv kept what it wrote, grid and bo wrote their rows (1 and 5 + 1)
    on the set they name; no kernel launched (CPU); the swapped names are
    back after the run."""
    code, report, work, before, after = cli_run
    assert code == 0, report
    row = report["families"]["ids"]
    assert row["ok"] and sorted(row["commands"]) == sorted(cli_smoke.COMMANDS)
    rows = row["commands"]
    for command, r in rows.items():
        assert r["ok"] and r["eot_chunks"] == [1], (command, r)
        assert r["k1_launches"] == r["k2_launches"] == 0 and r["peak_gib"] is None
        assert r["s"] > 0
    results = rows["test_defense"]["results"]
    assert sorted(results) == ["AutoAttack", "C&W", "Clean", "DeepFool"]
    assert all(len(results[k]) == 2 for k in ("AutoAttack", "C&W", "DeepFool"))
    assert results["Clean"] == 1.0  # the raised class-0 bias
    assert rows["test_defense"]["deepfool_blocks"] == [2]
    assert rows["test_defense"]["fab_blocks"] == [2]
    adv = sorted((work / "ids" / "adv").rglob("*.png"))
    assert rows["make_adv"]["kept"] == len(adv)
    assert rows["grid"]["rows"] == 1 and rows["bo"]["rows"] == 6
    assert row["grid_set"] == row["bo_set"] == ("made" if adv else "clean (make-adv kept none)")
    assert report["cli_flags"] == ["--batch-size", "2", "--eot-steps", "2", "--device", "cpu"]
    assert report["backend"] == "cpu" and report["nvidia_smi"] == "not available"
    assert after == before


def test_cli_defaults_refuses_a_gat_variable(monkeypatch, tmp_path):
    """The commands run at their defaults: a GAT_* variable in the
    environment stops the run before anything is made."""
    monkeypatch.setenv("GAT_DF_COT_CHUNK", "2")
    with pytest.raises(RuntimeError, match="GAT_DF_COT_CHUNK"):
        cli_smoke.main(["--out", str(tmp_path / "C.json"), "--work", str(tmp_path / "w"),
                        "--device", "cpu"])
    assert not list(tmp_path.iterdir())
