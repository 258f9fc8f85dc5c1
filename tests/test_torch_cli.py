"""The port's CLI (gen_adversarial_tpu_torch/cli/test_defense.py) on the
tiny world of tests/test_harness.py: `main()` with --device cpu writes
results.json in the JAX schema; the multi-device flags and a CUDA device
that is not there raise."""

import json

import pytest
import torch

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
