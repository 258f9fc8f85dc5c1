"""The port's CLI (gen_adversarial_tpu_torch/cli/test_defense.py) on the
tiny world of tests/test_harness.py: `main()` with --device cpu writes
results.json in the JAX schema; the multi-device flags and a CUDA device
that is not there raise; the EoT chunk it passes to load_defense is the
family's default unless --eot-chunk is given."""

import json

import pytest
import torch

import gen_adversarial_tpu_torch.eval.factory as factory
from gen_adversarial_tpu_torch.cli.test_defense import main
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)
from tests.torch_port_helpers import patch_tiny_classifier, tiny_world

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture()
def args(tmp_path, monkeypatch):
    patch_tiny_classifier(monkeypatch)
    data_dir, ckpt = tiny_world(tmp_path, n_per_class=2)
    config = tmp_path / "no_defense_ids.yaml"
    config.write_text(f"classifier_path: {ckpt}\n")
    return ["--config", str(config), "--images-path", str(data_dir),
            "--results-folder", str(tmp_path / "results")]


def test_main_writes_results_json(args, tmp_path):
    got = main(args + ["--device", "cpu", "--attack", "deepfool", "--no-plots",
                       "--batch-size", "3"])
    written = json.loads((tmp_path / "results" / "results.json").read_text())
    assert written == got and sorted(written) == ["Clean", "DeepFool"]
    assert len(written["DeepFool"]) == 4 and 0.0 <= written["Clean"] <= 1.0
    assert all(v == 100.0 or 0.0 <= v < 100.0 for v in written["DeepFool"])
    assert not (tmp_path / "results" / "plots").exists()
    assert not (tmp_path / "results" / "progress_p0.json").exists()


@pytest.mark.parametrize("flags", [["--n-devices", "2"], ["--distributed"]])
def test_multi_device_flags_raise(args, flags):
    """Several devices in one process, or --distributed outside torchrun,
    refuse and name the torchrun command (the port's data parallelism is
    one process per GPU)."""
    error = ValueError if "--n-devices" in flags else SystemExit
    with pytest.raises(error, match="torchrun --nproc-per-node"):
        main(args + ["--device", "cpu"] + flags)


def test_the_default_device_is_cuda(args):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("name,flags,want", [
    ("ours_cosine_noise_gender", [], 1),
    ("ours_cosine_noise_gender", ["--batch-size", "4"], 2),
    ("ours_linear_blur_cars", [], 2),
    ("ours_cosine_noise_ids", [], None),
    ("no_defense_gender", [], None),
    ("ours_cosine_noise_gender", ["--eot-chunk", "4"], 4),
    ("ours_cosine_noise_ids", ["--eot-chunk", "8"], 8)])
def test_the_eot_chunk_is_the_familys_default_unless_given(tmp_path, monkeypatch, name, flags,
                                                          want):
    """Without --eot-chunk the CLI passes factory.default_eot_chunk's at
    --batch-size (8 by default) to load_defense: gender 1 (2 at batch 4),
    cars 2, ids and the classifier alone none; a given --eot-chunk wins.
    load_defense is replaced by a recorder (no model is built)."""
    seen = {}

    def load_defense(config, **kw):
        seen.update(kw)
        raise _Stop

    monkeypatch.setattr(factory, "load_defense", load_defense)
    with pytest.raises(_Stop):
        main(["--config", str(tmp_path / f"{name}.yaml"), "--images-path", str(tmp_path),
              "--results-folder", str(tmp_path / "results")] + flags)
    assert seen["eot_chunk"] == want and seen["eot_steps"] == 32
