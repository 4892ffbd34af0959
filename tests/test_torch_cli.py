"""The port's command line (``train/__main__.py``, ``evaluate/__main__.py``,
``utils/cli.py``) against the JAX package's ``train.py`` and
``evaluate.py``, on the CPU (``--device cpu``).

The parser keeps ``train.py``'s flag names and defaults; flags that need
what is not ported are refused naming ``ROADMAP.md``.  Runs are
``resnet_test`` at 64 x 64 (the CLI's heads are full width: FPN 256, heads
256 x 4).  A snapshot that the JAX ``train.py`` writes is evaluated by the
port's ``evaluate`` on the same JPEG files as JAX's ``evaluate.py``; the
12 stats agree within ``STAT_ATOL`` (measured: gap 0 on each, with AP50
0.0476 and AR100 0.0667 on this CPU).
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.ops import anchors as j_anchors
from batchai_retinanet_horovod_coco_tpu.utils import cli as j_cli
from batchai_retinanet_horovod_coco_tpu_torch.data import shm_pipeline as t_shm
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import __main__ as t_evaluate
from batchai_retinanet_horovod_coco_tpu_torch.models import convert
from batchai_retinanet_horovod_coco_tpu_torch.models.retinanet import RetinaNetConfig, build_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.ops import anchors as t_anchors
from batchai_retinanet_horovod_coco_tpu_torch.train import __main__ as t_train
from batchai_retinanet_horovod_coco_tpu_torch.train.optim import OptimizerConfig
from batchai_retinanet_horovod_coco_tpu_torch.train.state import create_train_state
from batchai_retinanet_horovod_coco_tpu_torch.utils import checkpoint as t_ckpt
from batchai_retinanet_horovod_coco_tpu_torch.utils import cli as t_cli

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # train.py, evaluate.py
import evaluate as j_evaluate  # noqa: E402
import train as j_train  # noqa: E402

SUBCOMMANDS = {
    "coco": ["coco", "/data/coco"],
    "csv": ["csv", "a.csv", "c.csv"],
    "pascal": ["pascal", "/data/voc"],
    "synthetic": ["synthetic"],
}
PORT_ONLY = {"device"}
# The synthetic root defaults under the temp directory (TMPDIR), which is
# train.py's /tmp where TMPDIR is unset.
TEMP_DEFAULT = {"synthetic_root"}
SMALL = ["--image-min-side", "64", "--image-max-side", "64", "--backbone", "resnet_test", "--f32",
         "--batch-size", "4", "--workers", "2", "--device", "cpu"]
STAT_ATOL = 1e-3
STATS = ("AP", "AP50", "AP75", "APsmall", "APmedium", "APlarge", "AR1", "AR10", "AR100",
         "ARsmall", "ARmedium", "ARlarge")


@pytest.mark.parametrize("sub", sorted(SUBCOMMANDS))
def test_parser_defaults_are_train_py_s(sub):
    """Every flag the port keeps has train.py's name and default."""
    got = vars(t_train.parse_args(SUBCOMMANDS[sub]))
    want = vars(j_train.parse_args(SUBCOMMANDS[sub]))
    assert set(got) - PORT_ONLY <= set(want)
    assert {k: v for k, v in got.items() if k not in PORT_ONLY | TEMP_DEFAULT} == {
        k: want[k] for k in got if k not in PORT_ONLY | TEMP_DEFAULT
    }
    assert got["device"] == "cuda"
    if sub == "synthetic":
        assert os.path.basename(got["synthetic_root"]) == os.path.basename(want["synthetic_root"])


def test_presets():
    assert set(t_train.PRESETS) == {"cpu-inference", "coco-mini", "eval"}
    for name, values in t_train.PRESETS.items():
        assert values == j_train.PRESETS[name]
        args = t_train.parse_args(["--preset", name, "synthetic", "--batch-size", "3"])
        assert args.batch_size == 3  # an explicit flag wins
        assert all(getattr(args, k) == v for k, v in values.items() if k != "batch_size")
    with pytest.raises(SystemExit):
        t_train.parse_args(["--preset", "dp8", "synthetic"])


@pytest.mark.parametrize("flags", [
    ["--num-devices", "8"], ["--spatial-shards", "2"], ["--quantized-allreduce"],
    ["--shard-weight-update"], ["--distributed-auto"], ["--coordinator-address", "h:1"],
    ["--num-processes", "2"], ["--process-id", "0"], ["--data-worker-procs", "1"],
    ["--data-worker-timeout", "30"], ["--tensorboard"], ["--debug-nans"],
    ["--pretrained-backbone", "r50.pth"], ["--stem", "conv"], ["--pack-width"],
    ["--backbone", "mobilenet"],
], ids=lambda f: f[0])
def test_unported_flags_are_refused(flags, tmp_path, monkeypatch):
    """Each flag whose setting needs what is not ported is refused, naming
    it.  The decode-worker flags, refused before, now run a 2-step
    synthetic run on the CPU: ``--data-worker-procs`` through the
    shared-memory worker processes, ``--data-worker-timeout`` with them
    off."""
    if flags[0] in ("--data-worker-procs", "--data-worker-timeout"):
        built, real = [], t_shm.build_shm_pipeline

        def spy(*args, **kwargs):
            built.append(real(*args, **kwargs))
            return built[-1]

        monkeypatch.setattr(t_shm, "build_shm_pipeline", spy)
        out = t_train.main(synthetic_flags(tmp_path) + flags + ["--steps", "2"])
        assert out["final_step"] == 2.0
        assert t_cli.make_pipeline_worker_kwargs(t_train.parse_args(["synthetic", *flags]))[
            "num_worker_procs" if flags[0] == "--data-worker-procs" else "worker_timeout"] == float(flags[1])
        assert len(built) == (flags[0] == "--data-worker-procs")
        assert all(p.exitcode is not None for pipe in built for p in pipe.processes)
        return
    with pytest.raises(SystemExit, match="ROADMAP.md") as info:
        t_train.main(["synthetic", "--device", "cpu", *flags])
    assert flags[0] in str(info.value)


def test_cuda_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(["synthetic", "--synthetic-root", str(tmp_path), "--synthetic-images", "4"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_anchor_config_file_moves_between_packages(tmp_path, writer):
    """The snapshot's anchor_config.json: one package writes it, the other
    reads the same config."""
    flags = ["--anchor-sizes", "24,48,96,192,384", "--anchor-ratios", "0.5,1,2,3"]
    j_args = j_train.parse_args(["synthetic", *flags])
    t_args = t_train.parse_args(["synthetic", *flags])
    if writer == "jax":
        j_cli.save_anchor_config(str(tmp_path), j_cli.make_anchor_config(j_args))
        got = t_cli.load_anchor_config(str(tmp_path))
        assert got == t_cli.make_anchor_config(t_args)
    else:
        t_cli.save_anchor_config(str(tmp_path), t_cli.make_anchor_config(t_args))
        got = j_cli.load_anchor_config(str(tmp_path))
        assert got == j_cli.make_anchor_config(j_args)
    assert [f.name for f in tmp_path.iterdir()] == ["anchor_config.json"]
    assert t_anchors.AnchorConfig().__dict__ == j_anchors.AnchorConfig().__dict__
    with pytest.raises(SystemExit, match="conflict"):
        t_cli.resolve_anchor_config(t_train.parse_args(["synthetic", "--anchor-sizes", "1,2,3,4,5"]),
                                    str(tmp_path))


def synthetic_flags(root: Path) -> list[str]:
    return ["synthetic", "--synthetic-root", str(root / "data"), "--synthetic-images", "8",
            "--synthetic-size", "64", *SMALL, "--snapshot-path", str(root / "ckpt")]


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


def test_nan_abort_and_auto_resume(tmp_path):
    """A NaN batch at step 3 aborts the run after ckpt-2; with
    --auto-resume the run restores ckpt-2, reseeds the data and finishes."""
    common = ["--steps", "4", "--checkpoint-every", "1", "--inject-nan-step", "3", "--log-every", "1"]
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        t_train.main(synthetic_flags(tmp_path / "a") + common)
    assert t_ckpt.latest_step(str(tmp_path / "a" / "ckpt")) == 2
    out = t_train.main(synthetic_flags(tmp_path / "b") + common + ["--auto-resume"])
    assert out["final_step"] == 4.0
    manifest = t_ckpt.read_manifest(str(tmp_path / "b" / "ckpt"))
    assert manifest["step"] == 4
    assert manifest["metadata"]["stream_base_step"] == 2
    assert manifest["metadata"]["data_seed"] == 7919


def test_resume_elastic_continues_the_stream(tmp_path, capsys):
    """A run stopped at step 2 and resumed to 4 with --resume-elastic sees
    the batches of an uninterrupted 4-step run: the same losses."""
    def losses() -> dict[int, float]:
        out = {}
        for line in capsys.readouterr().out.splitlines():
            if line.startswith("{") and '"loss"' in line:
                rec = json.loads(line)
                out[rec["step"]] = rec["loss"]
        return out

    # constant: a multistep schedule depends on --steps.
    common = ["--checkpoint-every", "2", "--log-every", "1", "--warmup-steps", "0", "--schedule", "constant"]
    t_train.main(synthetic_flags(tmp_path / "a") + common + ["--steps", "4"])
    want = losses()
    t_train.main(synthetic_flags(tmp_path / "b") + common + ["--steps", "2"])
    capsys.readouterr()
    t_train.main(synthetic_flags(tmp_path / "b") + common + ["--steps", "4", "--resume-elastic"])
    out = capsys.readouterr().out
    assert '"event": "elastic_resume"' in out and '"skip_batches": 2' in out
    got = {json.loads(line)["step"]: json.loads(line)["loss"] for line in out.splitlines()
           if line.startswith("{") and '"loss"' in line}
    assert sorted(got) == [3, 4]
    assert [got[3], got[4]] == [want[3], want[4]]  # bit for bit


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
    return root, coco


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
