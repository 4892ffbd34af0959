"""``--spatial-shards`` on the port's command line (``train/__main__.py``),
on the CPU: a (1 data x 2 space) world of ``synthetic --num-devices 2
--spatial-shards 2 --f32`` trains two steps, checkpoints and evaluates;
every refusal of the JAX command line's guards (``train.py``) comes with
the JAX message, in the JAX order, for the same flags."""

import json
import sys
import time
from pathlib import Path

import pytest

from batchai_retinanet_horovod_coco_tpu_torch.train import __main__ as t_train
from batchai_retinanet_horovod_coco_tpu_torch.utils import checkpoint as t_ckpt
from test_torch_cli_flags import two_torch_threads  # noqa: F401
from test_torch_data_parallel import cli_flags
from test_torch_train import drop_tmp_path  # noqa: F401
from torch_comm_harness import start, wait_all

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # train.py
import train as j_train  # noqa: E402

DEADLINE_S = 150


def test_spatial_world_trains_checkpoints_and_evaluates(tmp_path):
    """Two ranks hold the rows of the same 4 images: two steps, rank 0's
    log and checkpoint (one data shard in the manifest), the COCO eval
    over the whole world."""
    log = tmp_path / "run.log"
    proc = start([sys.executable, "-m", "batchai_retinanet_horovod_coco_tpu_torch.train",
                  *cli_flags(tmp_path), "--num-devices", "2", "--spatial-shards", "2",
                  "--steps", "2", "--checkpoint-every", "2", "--eval-every", "2"], log)
    wait_all([proc], [log], time.monotonic() + DEADLINE_S)
    lines = [json.loads(line) for line in log.read_text().splitlines() if line.startswith('{"step"')]
    train = [line for line in lines if "loss" in line]
    assert [line["step"] for line in train] == [2]
    assert train[0]["num_pos"] > 0 and train[0]["grad_norm"] > 0
    assert any("eval/AP" in line for line in lines)
    manifest = t_ckpt.read_manifest(str(tmp_path / "ckpt"))
    assert manifest["step"] == 2 and manifest["metadata"]["shard_count"] == 1


SYNTHETIC = ["synthetic", "--synthetic-images", "4", "--synthetic-size", "64"]


@pytest.mark.parametrize("flags", [
    ["--spatial-shards", "2"],
    ["--spatial-shards", "3", "--num-devices", "4", "--f32"],
    ["--spatial-shards", "2", "--num-devices", "2"],
    ["--spatial-shards", "8", "--num-devices", "8", "--f32", "--image-min-side", "64",
     "--image-max-side", "64"],
    ["--spatial-shards", "2", "--num-devices", "4", "--f32", "--backbone", "resnet50",
     "--image-min-side", "64", "--image-max-side", "64"],
], ids=["divide-one", "divide", "f32", "strided-envelope", "data-axis"])
def test_refusals_carry_the_jax_messages(flags, tmp_path):
    """The port's message is the JAX command line's, word for word."""
    with pytest.raises(SystemExit) as want:
        j_train._run(j_train.parse_args(SYNTHETIC + ["--synthetic-root", str(tmp_path), *flags]))
    with pytest.raises(SystemExit) as got:
        t_train.main(SYNTHETIC + ["--device", "cpu", "--synthetic-root", str(tmp_path), *flags])
    assert str(got.value) == str(want.value)


def test_space_axis_cannot_span_hosts():
    """Under torchrun (``LOCAL_WORLD_SIZE`` ranks a host) a space group
    must fit in a host: the JAX message with the per-host count; the data
    axis override lets a deep backbone through the data-axis envelope."""
    args = t_train.parse_args(["synthetic", "--spatial-shards", "4", "--f32"])
    with pytest.raises(SystemExit) as info:
        t_train.refuse_spatial(args, 8, environ={"LOCAL_WORLD_SIZE": "2"})
    assert str(info.value) == ("--spatial-shards 4 must divide the per-host device count 2 on "
                               "multi-host runs (the space axis cannot span hosts)")
    source = (Path(__file__).resolve().parents[1] / "train.py").read_text()
    assert "multi-host runs (the space axis cannot span hosts)" in source
    t_train.refuse_spatial(args, 8, environ={"LOCAL_WORLD_SIZE": "4"})
    deep = t_train.parse_args(["synthetic", "--spatial-shards", "2", "--f32", "--backbone",
                               "resnet50", "--image-min-side", "64", "--image-max-side", "64",
                               "--allow-data-axis-divergence"])
    t_train.refuse_spatial(deep, 4, environ={})
