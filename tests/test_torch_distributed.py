"""The port's data parallelism on the CPU: two gloo ranks started by
`torch.distributed.run` against the port's own one-rank run (the twins of
tests/test_distributed.py, whose JAX mesh becomes one process per device):
the harness's results as multisets on an odd image count, the classifier
trainer's parameters and logged history (with and without a ragged
validation tail), the TRADES CLI's last.msgpack, and the global BatchNorm
moments with their input gradient. In process: the pieces those runs are
made of (the gather at world size 1, the batch slices of the data, the
augmentation and the draws) and the refusals (several devices in one
process, --distributed outside torchrun, distributed=True without a group).

The ranks (tests/_torch_distributed_worker.py) import no JAX. Each run is
bounded well under a minute; a rank that dies fails the others' collectives
within the worker's group timeout.
"""

import json
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gen_adversarial_tpu_torch.core import distributed
from gen_adversarial_tpu_torch.core.checkpoint import load_variables, save_variables
from gen_adversarial_tpu_torch.core.convert import to_jax_variables
from gen_adversarial_tpu_torch.core.init import flax_init_
from gen_adversarial_tpu_torch.data import png
from gen_adversarial_tpu_torch.data.datasets import ImageLabelDataset, iterate_batches
from gen_adversarial_tpu_torch.models.nvae.distributions import Draws, SlicedDraws
from gen_adversarial_tpu_torch.train import augment
from tests import _torch_distributed_worker as worker
from tests.torch_port_helpers import one_torch_thread, tiny_world  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
RUN_TIMEOUT_S = 45
# the JAX twins' tolerance on trained parameters: the ranks' gradient sums
# and the global moments add in another order than one process
TRAIN_TOL = dict(rtol=2e-3, atol=1e-4)
BN_TOL = dict(rtol=1e-6, atol=1e-6)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(mode: str, *args) -> None:
    """Two ranks of the worker in `mode`. The run's process group is killed
    whole if it outlasts RUN_TIMEOUT_S."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
           "--master-port", str(_free_port()), str(REPO / "tests" / "_torch_distributed_worker.py"),
           mode, *map(str, args)]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        out, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"two ranks of {mode} ran past {RUN_TIMEOUT_S} s:\n{out[-3000:]}")
    assert proc.returncode == 0, out[-3000:]


def _reports(folder: Path) -> list:
    """What each rank returned (its rank<r>.json)."""
    return [json.loads((folder / f"rank{r}.json").read_text()) for r in range(2)]


def _png_folders(root: Path, counts: dict, size: int, seed: int) -> None:
    """{split/class: n} folders of random PNGs."""
    rng = np.random.RandomState(seed)
    for folder, n in counts.items():
        for i in range(n):
            png.write(root / folder / f"{i}.png",
                      (rng.rand(size, size, 3) * 255).astype(np.uint8))


# ---------------------------------------------------------------- in process
def test_allgather_lists_single_process_identity():
    vals = [1.0, 2.5, 100.0]
    assert distributed.allgather_lists(vals) == vals
    assert distributed.process_shard() == (0, 1) and distributed.is_rank0()
    assert not distributed.multi_process()


def test_batch_slices_partition_each_batch(tmp_path):
    """Each rank's part of each shuffled batch, concatenated, is the batch;
    a ragged tail's part may be empty."""
    _png_folders(tmp_path, {"a": 4, "b": 5}, 8, 0)
    ds = ImageLabelDataset(str(tmp_path), 8)
    whole = list(iterate_batches(ds, 4, shuffle=True, seed=3, drop_last=False))
    parts = [list(iterate_batches(ds, 4, shuffle=True, seed=3, drop_last=False,
                                  batch_slice=(r, 2))) for r in range(2)]
    assert [len(b["label"]) for b in whole] == [4, 4, 1]
    assert [len(b["label"]) for b in parts[0]] == [2, 2, 0]
    for b, p0, p1 in zip(whole, *parts):
        np.testing.assert_array_equal(np.concatenate([p0["image"], p1["image"]]), b["image"])
        np.testing.assert_array_equal(np.concatenate([p0["label"], p1["label"]]), b["label"])


def test_rank_parts_of_the_draws_are_the_global_draws():
    """SlicedDraws and train_augment's batch_slice: the ranks' parts of a
    global batch's draws (normal, uniform, augmentation) are the rows one
    process draws for the whole batch."""
    like = torch.zeros(())

    def draws(source, b):
        return [source.normal((b, 2), like), source.uniform((b, 5), like, -1.0, 2.0)]

    whole = draws(Draws(torch.Generator().manual_seed(4)), 6)
    parts = [draws(SlicedDraws(torch.Generator().manual_seed(4), (r, 2)), 3) for r in range(2)]
    for w, p0, p1 in zip(whole, *parts):
        torch.testing.assert_close(torch.cat([p0, p1]), w, rtol=0, atol=0)
    images = torch.rand((6, 8, 8, 3), generator=torch.Generator().manual_seed(5))
    want = augment.train_augment(images, torch.Generator().manual_seed(6))
    got = torch.cat([augment.train_augment(images[3 * r:3 * r + 3],
                                           torch.Generator().manual_seed(6), (r, 2))
                     for r in range(2)])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _raises_several_devices(tmp_path):
    from gen_adversarial_tpu_torch.cli import test_defense, train_classifier, trades_finetune
    from gen_adversarial_tpu_torch.eval.harness import run_benchmark
    from gen_adversarial_tpu_torch.train.classifier import fit

    folder = str(tmp_path)
    return {
        "run_benchmark": lambda: run_benchmark(None, folder, folder, n_devices=2),
        "fit": lambda: fit("vgg", 2, 32, None, None, 1, 0.1, 4, n_devices=2, device="cpu"),
        "test_defense": lambda: test_defense.main(
            ["--config", "x.yaml", "--images-path", folder, "--results-folder", folder,
             "--n-devices", "2", "--device", "cpu"]),
        "train_classifier": lambda: train_classifier.main(
            ["--data-path", folder, "--model-type", "vgg", "--n-classes", "2",
             "--cumulative-bs", "4", "--image-size", "32", "--epochs", "1", "--lr", "0.1",
             "--n-devices", "2", "--device", "cpu"]),
        "trades_finetune": lambda: trades_finetune.main(
            ["--data-path", folder, "--experiment", "ids", "--classifier-path", "x",
             "--epochs", "1", "--lr", "0.1", "--cumulative-bs", "4", "--out", folder,
             "--n-devices", "2", "--device", "cpu"]),
    }


@pytest.mark.parametrize("entry", ["run_benchmark", "fit", "test_defense", "train_classifier",
                                   "trades_finetune"])
def test_several_devices_in_one_process_raise_naming_torchrun(tmp_path, entry):
    """The JAX --n-devices k (a mesh inside one process, the local mesh of
    its two-process eval) is k processes here: asking for more than one
    device in one process raises, naming the torchrun command."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2 -m gen_adversarial"):
        _raises_several_devices(tmp_path)[entry]()


def test_distributed_without_torchrun_exits(monkeypatch):
    """--distributed outside torchrun's environment exits with a message;
    distributed=True without a process group refuses to run alone."""
    from gen_adversarial_tpu_torch.eval.harness import run_benchmark

    for key in distributed.TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit, match="not started by torchrun"):
        distributed.maybe_initialize()
    assert not distributed.initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        run_benchmark(None, ".", ".", distributed=True)


# ---------------------------------------------------------------- two ranks
def test_two_rank_harness_matches_one_rank(tmp_path, monkeypatch):
    """The no-defense config over 5 images at batch 2 (rank 0: 3 images in a
    full and a ragged batch, rank 1: 2 in one): results.json holds the
    one-rank run's results as multisets, written once by rank 0; every rank
    returns them; no progress file is left."""
    from gen_adversarial_tpu_torch.eval import factory
    from gen_adversarial_tpu_torch.eval.harness import run_benchmark

    data_dir, ckpt = tiny_world(tmp_path, n_per_class=3)
    (data_dir / "b" / "2.png").unlink()
    config = tmp_path / "no_defense_ids.yaml"
    config.write_text(f"classifier_path: {ckpt}\n")
    monkeypatch.setattr(factory, "make_classifier", worker.tiny_vgg)
    single = run_benchmark(factory.load_defense(str(config), device="cpu"), str(data_dir),
                           str(tmp_path / "res_1"), batch_size=2, attack_filter="deepfool",
                           plots=False, log_fn=lambda s: None)

    _torchrun("harness", data_dir, config, tmp_path / "res_2")
    two = json.loads((tmp_path / "res_2" / "results.json").read_text())
    assert two["Clean"] == pytest.approx(single["Clean"])
    assert len(two["DeepFool"]) == len(single["DeepFool"]) == 5
    assert sorted(two["DeepFool"]) == pytest.approx(sorted(single["DeepFool"]), rel=1e-5)
    assert _reports(tmp_path) == [two, two]
    assert not list((tmp_path / "res_2").glob("progress_p*.json"))


@pytest.mark.parametrize("val_counts", [(4, 4), (5, 4)], ids=["even_tail", "ragged_tail"])
def test_two_rank_training_matches_one_rank(tmp_path, monkeypatch, val_counts):
    """fit over 16 training images at global batch 4 (4 steps): the two
    ranks return identical histories, near the one-rank run's, and rank 0's
    parameters and running statistics follow the one-rank trajectory. The
    ragged case's last validation batch holds 1 image, so rank 0's part of
    it is empty."""
    from gen_adversarial_tpu_torch.train import classifier

    _png_folders(tmp_path / "data", {"train/c0": 8, "train/c1": 8,
                                     "validation/c0": val_counts[0],
                                     "validation/c1": val_counts[1]}, 32, 5)
    monkeypatch.setattr(classifier, "make_classifier", worker.tiny_vgg)
    data = tmp_path / "data"
    state, history = classifier.fit(
        "vgg", 2, 32, ImageLabelDataset(f"{data}/train", 32),
        ImageLabelDataset(f"{data}/validation", 32), log_fn=lambda s: None, device="cpu",
        **worker.TRAIN)
    want = worker.flat(to_jax_variables(state.model))

    _torchrun("train", data, tmp_path / "params.npz")
    logged = _reports(tmp_path)
    assert len(logged[0]) == len(history) == 1 and logged[0] == logged[1], logged
    assert logged[0][0]["loss"] == pytest.approx(history[0]["loss"], rel=1e-5)
    assert logged[0][0]["acc"] == history[0]["acc"]
    got = np.load(tmp_path / "params.npz")
    assert sorted(got.files) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **TRAIN_TOL)


def test_two_rank_trades_cli_matches_one_rank(tmp_path, monkeypatch):
    """The TRADES CLI with --distributed over 8 images at global batch 4 (2
    steps, 2 inner PGD steps): rank 0's last.msgpack holds the one-rank
    run's parameters; one log.txt, rank 0's."""
    from gen_adversarial_tpu_torch.cli import trades_finetune
    from gen_adversarial_tpu_torch.core import config
    from gen_adversarial_tpu_torch.eval import factory
    from gen_adversarial_tpu_torch.train import trades

    _png_folders(tmp_path / "data", {"train/c0": 4, "train/c1": 4}, 32, 9)
    model = flax_init_(worker.tiny_vgg("vgg", 2), torch.Generator().manual_seed(0))
    ckpt = tmp_path / "clf.msgpack"
    save_variables(ckpt, to_jax_variables(model), {"model_type": "vgg"})
    for module, name in ((factory, "make_classifier"), (trades, "make_trades_train_step")):
        monkeypatch.setattr(module, name, getattr(module, name))  # restored after
    monkeypatch.setitem(config.IMAGE_SIZE, "ids", config.IMAGE_SIZE["ids"])
    monkeypatch.setitem(config.N_CLASSES, "ids", config.N_CLASSES["ids"])
    worker.patch_trades()
    trades_finetune.main(worker.trades_argv(str(tmp_path / "data"), str(ckpt),
                                            str(tmp_path / "out_1")))
    want, _ = load_variables(tmp_path / "out_1" / "last.msgpack")

    _torchrun("trades", tmp_path / "data", ckpt, tmp_path / "out_2")
    got, meta = load_variables(tmp_path / "out_2" / "last.msgpack")
    assert meta["experiment"] == "ids"
    want, got = worker.flat(want), worker.flat(got)
    assert sorted(got) == sorted(want)
    moved = max(float(np.abs(want[k] - v).max()) for k, v in worker.flat(
        to_jax_variables(model)).items())
    assert moved > 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **TRAIN_TOL)
    assert len((tmp_path / "out_2" / "log.txt").read_text().splitlines()) == 2


def test_two_rank_batchnorm_moments_match_one_rank(tmp_path):
    """A training BatchNorm2d on two ranks' halves of a batch of 6: the
    outputs, input gradients and running statistics are one rank's on the
    whole batch, and the ranks' weight and bias gradients sum to its."""
    _torchrun("bn", tmp_path)
    ranks = [np.load(tmp_path / f"bn_rank{r}.npz") for r in range(2)]
    want = worker.bn_run(*worker.bn_case())
    for key in ("y", "x_grad"):
        np.testing.assert_allclose(np.concatenate([r[key] for r in ranks]), want[key],
                                   err_msg=key, **BN_TOL)
    for key in ("weight_grad", "bias_grad"):
        np.testing.assert_allclose(ranks[0][key] + ranks[1][key], want[key], err_msg=key,
                                   **BN_TOL)
    for key in ("running_mean", "running_var"):
        for r in ranks:
            np.testing.assert_allclose(r[key], want[key], err_msg=key, **BN_TOL)
