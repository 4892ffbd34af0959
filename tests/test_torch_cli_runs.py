"""The port's command line (``train/__main__.py``, ``evaluate/__main__.py``)
against the JAX package's ``train.py`` and ``evaluate.py``, on the CPU
(``--device cpu``): a run that checkpoints and evaluates, and the port's
``evaluate`` on a snapshot that the JAX ``train.py`` writes, scored on the
same JPEG files as JAX's ``evaluate.py``; the 12 stats agree within
``STAT_ATOL`` (measured: gap 0 on each, with AP50 0.0476 and AR100 0.0667
on this CPU).  Runs are ``resnet_test`` at 64 x 64 (the CLI's heads are
full width: FPN 256, heads 256 x 4).
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu_torch.evaluate import __main__ as t_evaluate
from batchai_retinanet_horovod_coco_tpu_torch.models import convert
from batchai_retinanet_horovod_coco_tpu_torch.models.retinanet import RetinaNetConfig, build_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.train import __main__ as t_train
from batchai_retinanet_horovod_coco_tpu_torch.train.optim import OptimizerConfig
from batchai_retinanet_horovod_coco_tpu_torch.train.state import create_train_state
from batchai_retinanet_horovod_coco_tpu_torch.utils import checkpoint as t_ckpt
from test_torch_cli_flags import synthetic_flags, two_torch_threads  # noqa: F401
from test_torch_train import drop_tmp_path  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # train.py, evaluate.py
import evaluate as j_evaluate  # noqa: E402
import train as j_train  # noqa: E402

STAT_ATOL = 1e-3
STATS = ("AP", "AP50", "AP75", "APsmall", "APmedium", "APlarge", "AR1", "AR10", "AR100",
         "ARsmall", "ARmedium", "ARlarge")


def test_synthetic_run_checkpoints_and_evaluates(tmp_path):
    """3 steps from PNG files with a checkpoint and an eval; ``evaluate`` on
    the snapshot reproduces the run's final COCO stats exactly."""
    flags = synthetic_flags(tmp_path)
    out = t_train.main(flags + ["--steps", "3", "--checkpoint-every", "3", "--eval-every", "3",
                                "--score-threshold", "0.001", "--log-dir", str(tmp_path / "logs")])
    assert out["final_step"] == 3.0
    assert t_ckpt.latest_step(str(tmp_path / "ckpt")) == 3
    assert (tmp_path / "ckpt" / "anchor_config.json").exists()
    assert sorted(p.suffix for p in (tmp_path / "data" / "train").iterdir()) == [".png"] * 8
    records = [json.loads(line) for line in (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert records[0]["event"] == "run_header"
    assert [r["step"] for r in records if "train/loss" in r] == [3]
    assert all(np.isfinite(r["train/loss"]) for r in records if "train/loss" in r)
    final = {k.removeprefix("eval/"): v for k, v in out.items() if k.startswith("eval/")}
    assert set(final) == set(STATS) and final["AR100"] > 0
    metrics = t_evaluate.main(flags + ["--score-threshold", "0.001"])
    assert {k: metrics[k] for k in STATS} == final


@pytest.fixture(scope="module")
def jax_snapshot(tmp_path_factory):
    """2 steps of the JAX train.py on its synthetic set (JPEG files), on the
    CPU; returns the dataset root, the snapshot and the flags."""
    root = tmp_path_factory.mktemp("jax_run")
    model = ["--image-min-side", "64", "--image-max-side", "64", "--backbone", "resnet_test", "--f32",
             "--batch-size", "4", "--workers", "2", "--snapshot-path", str(root / "ckpt")]
    out = j_train.main(["synthetic", "--synthetic-root", str(root / "data"), "--synthetic-images", "8",
                        "--synthetic-size", "64", *model, "--steps", "2", "--checkpoint-every", "2",
                        "--warmup-steps", "0", "--lr", "0.32"])
    assert out["final_step"] == 2.0
    coco = ["coco", str(root / "data"), "--train-annotations", "instances_train.json",
            "--train-images", "train", "--val-annotations", "instances_val.json", "--val-images", "val",
            *model, "--warmup-steps", "0", "--lr", "0.32", "--score-threshold", "0.001"]
    yield root, coco
    shutil.rmtree(root, ignore_errors=True)


def test_jax_snapshot_evaluates_in_port(jax_snapshot):
    """The port's evaluate scores the JAX package's snapshot on the same
    JPEG files as JAX's evaluate.py, within STAT_ATOL on each of the 12
    stats; the restore it makes writes every saved parameter bit for bit."""
    root, coco = jax_snapshot
    want = j_evaluate.main(list(coco))
    got = t_evaluate.main(coco + ["--device", "cpu"])
    gaps = {k: abs(got[k] - want[k]) for k in STATS}
    assert max(gaps.values()) <= STAT_ATOL, gaps
    assert want["AR100"] > 0  # the comparison is not of zeros alone

    args = t_train.parse_args(coco + ["--device", "cpu"])
    model = build_retinanet(RetinaNetConfig(num_classes=3, backbone="resnet_test", dtype=torch.float32),
                            device="cpu", seed=5)
    state = create_train_state(model, OptimizerConfig(base_lr=args.lr, global_batch_size=4,
                                                      warmup_steps=0, total_steps=args.steps), device="cpu")
    manager = t_ckpt.CheckpointManager(args.snapshot_path)
    manager.restore(state)
    params, _ = convert.flax_from_state_dict(state.model.state_dict())
    saved = dict(flatten(manager.restore_arrays()["params"]))
    restored = dict(flatten(params))
    assert restored.keys() == saved.keys()
    for path, value in restored.items():
        np.testing.assert_array_equal(np.asarray(value), saved[path], err_msg=str(path))


def flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.slow
def test_real_recipe_converges(tmp_path):
    """The JAX package's convergence gate (tests/integration/
    test_convergence_gate.py) through the port's command line on the CPU:
    300 steps on 64 synthetic images, then an eval; AP50 > 0.15."""
    common = [
        "synthetic", "--synthetic-root", str(tmp_path / "data"), "--synthetic-images", "64",
        "--synthetic-size", "64", "--image-min-side", "64", "--image-max-side", "64",
        "--backbone", "resnet_test", "--f32", "--batch-size", "8", "--workers", "8",
        "--snapshot-path", str(tmp_path / "ckpt"), "--schedule", "multistep",
        "--warmup-steps", "30", "--lr", "0.32", "--weight-decay", "1e-4", "--device", "cpu",
    ]
    out = t_train.main(common + ["--steps", "300", "--log-every", "50", "--checkpoint-every", "100"])
    assert out["final_step"] == 300
    metrics = t_train.main(common + ["--preset", "eval"])
    assert metrics["AP50"] > 0.15, metrics
