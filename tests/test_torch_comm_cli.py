"""The gradient-communication flags of the port's command line against the
JAX ``train.py``'s: every ``--comm-*`` flag, ``--shard-weight-update`` and
the deprecated ``--quantized-allreduce`` map to the same ``CommConfig``,
the refusals carry the JAX messages, and a ``--num-devices 2`` run of ZeRO
with int8 checkpoints and resumes (a world of 2 over gloo, each rank a
child process, under one deadline).
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

import pytest

from batchai_retinanet_horovod_coco_tpu.utils import cli as j_cli
from batchai_retinanet_horovod_coco_tpu_torch.train import __main__ as t_train
from batchai_retinanet_horovod_coco_tpu_torch.utils import checkpoint as t_ckpt
from batchai_retinanet_horovod_coco_tpu_torch.utils import cli as t_cli
from test_torch_cli_flags import two_torch_threads  # noqa: F401
from test_torch_data_parallel import cli_flags
from test_torch_train import drop_tmp_path  # noqa: F401
from torch_comm_harness import start, wait_all

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # train.py
import train as j_train  # noqa: E402

DEADLINE_S = 300  # one deadline a world; generous under the tier's six workers
FLAG_SETS = [
    [],
    ["--comm-compress", "int8"],
    ["--comm-compress", "bf16", "--comm-no-error-feedback", "--comm-bucket-mb", "8"],
    ["--comm-overlap"],
    ["--comm-compress", "int8", "--comm-overlap", "--comm-bucket-mb", "0.5"],
    ["--comm-compress", "int8", "--comm-slices", "2"],
    ["--comm-dcn-mode", "int8"],
    ["--comm-compress", "int8", "--comm-dcn-mode", "bf16", "--comm-dcn-bucket-mb", "16"],
    ["--comm-compress", "bf16", "--comm-ici-mode", "bf16"],
    ["--comm-ici-mode", "none", "--comm-dcn-mode", "none"],
    ["--quantized-allreduce"],
    ["--quantized-allreduce", "--comm-compress", "bf16"],
    ["--shard-weight-update", "--comm-compress", "int8"],
]


def configs(flags: list[str]):
    t_args = t_train.parse_args(["synthetic", *flags])
    j_args = j_train.parse_args(["synthetic", *flags])
    return t_cli.make_comm_config(t_args), j_cli.make_comm_config(j_args), t_args


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: " ".join(f) or "none")
def test_comm_flags_map_to_the_jax_config(flags, capsys):
    """The same parsed values and the same ``CommConfig`` (or None); the
    deprecated alias prints one ``deprecated_flag`` line, as the JAX one."""
    got, want, args = configs(flags)
    assert (got is None) == (want is None)
    if got is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert args.shard_weight_update == ("--shard-weight-update" in flags)
    t_train.refuse_unported(args)
    lines = [json.loads(line) for line in capsys.readouterr().err.splitlines()
             if '"deprecated_flag"' in line]
    if "--quantized-allreduce" in flags:
        assert len(lines) == 2  # the port's, then the JAX package's
        assert {k: lines[0][k] for k in ("flag", "mapped_to")} == {
            k: lines[1][k] for k in ("flag", "mapped_to")}
        assert lines[0]["mapped_to"].startswith("--comm-compress ")
    else:
        assert lines == []
    assert t_cli.make_comm_config(args, announce=False) == got
    assert capsys.readouterr().err == ""


def test_a_policy_the_config_refuses_is_refused_as_jax():
    flags = ["--comm-compress", "int8", "--comm-ici-mode", "bf16"]
    with pytest.raises(ValueError) as want:
        j_cli.make_comm_config(j_train.parse_args(["synthetic", *flags]))
    with pytest.raises(ValueError) as got:
        t_cli.make_comm_config(t_train.parse_args(["synthetic", *flags]))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flags,message", [
    (["--spatial-shards", "2", "--comm-compress", "int8"],
     "--spatial-shards is exclusive with --shard-weight-update and "
     "--comm-compress/--comm-overlap/--quantized-allreduce"),
    (["--spatial-shards", "2", "--shard-weight-update"],
     "--spatial-shards is exclusive with --shard-weight-update and "
     "--comm-compress/--comm-overlap/--quantized-allreduce"),
    (["--shard-weight-update"], "--shard-weight-update needs --num-devices > 1"),
    (["--comm-compress", "int8"],
     "--comm-compress/--comm-overlap need --num-devices > 1 (compression rides the mesh "
     "collectives)"),
    (["--comm-overlap"],
     "--comm-compress/--comm-overlap need --num-devices > 1 (compression rides the mesh "
     "collectives)"),
    (["--spatial-shards", "2"], "--spatial-shards 2 must divide --num-devices 1"),
], ids=["spatial-comm", "spatial-zero", "zero-alone", "compress-alone", "overlap-alone",
        "spatial"])
def test_refusals_carry_the_jax_messages(flags, message, tmp_path):
    """Each message is the JAX command line's (``train.py``).  Spatial
    sharding is ported: alone on one device it meets the JAX guards' first
    refusal, ``--spatial-shards`` must divide ``--num-devices`` (before
    "requires --f32"), word for word; only TensorBoard and
    ``--debug-nans`` remain unported."""
    with pytest.raises(SystemExit) as info:
        t_train.main(["synthetic", "--device", "cpu", "--synthetic-root", str(tmp_path), *flags])
    assert message in str(info.value)
    source = (Path(__file__).resolve().parents[1] / "train.py").read_text()
    if flags == ["--spatial-shards", "2"]:
        with pytest.raises(SystemExit) as want:
            j_train._run(j_train.parse_args(["synthetic", "--synthetic-root", str(tmp_path),
                                             *flags]))
        assert str(info.value) == str(want.value)
    else:
        assert message.split(" (")[0].split(" and ")[0] in source


def test_zero_int8_world_checkpoints_and_resumes(tmp_path):
    """``--num-devices 2 --shard-weight-update --comm-compress int8``: two
    steps and a checkpoint in the JAX ZeRO layout (``zero_world_size`` 2,
    the residuals under ``['comm_state']``); then the same world resumes it
    to step 3 with the deprecated alias and ``--comm-overlap`` (dropped
    under ZeRO), each announced once, and no residual reset."""
    log = tmp_path / "first.log"
    world = ["--num-devices", "2", "--shard-weight-update", "--checkpoint-every", "2",
             "--comm-bucket-mb", "0.5"]
    proc = start([sys.executable, "-m", "batchai_retinanet_horovod_coco_tpu_torch.train",
                  *cli_flags(tmp_path), *world, "--comm-compress", "int8", "--steps", "2"], log)
    wait_all([proc], [log], time.monotonic() + DEADLINE_S)
    directory = str(tmp_path / "ckpt")
    manifest = t_ckpt.read_manifest(directory)
    assert manifest["step"] == 2 and manifest["zero_world_size"] == 2
    assert manifest["metadata"]["shard_count"] == 2
    residuals = [e for e in manifest["leaves"] if e["path"].startswith("['comm_state']")]
    assert residuals and all(len(e["shape"]) == 1 and e["shape"][0] % 2 == 0 for e in residuals)
    first = [json.loads(line) for line in log.read_text().splitlines() if line.startswith('{"step"')]
    assert [line["step"] for line in first] == [2]
    assert first[0]["comm_compressed_bytes"] > 0 and first[0]["ef_residual_norm"] > 0
    log = tmp_path / "resume.log"
    proc = start([sys.executable, "-m", "batchai_retinanet_horovod_coco_tpu_torch.train",
                  *cli_flags(tmp_path), *world, "--quantized-allreduce", "--comm-overlap",
                  "--steps", "3"], log)
    wait_all([proc], [log], time.monotonic() + DEADLINE_S)
    text = log.read_text()
    assert text.count('"event": "deprecated_flag"') == 1
    assert text.count('"event": "comm_overlap_ignored"') == 1
    assert '"event": "ef_reset"' not in text
    assert text.count("resumed from step 2") == 1
    assert t_ckpt.read_manifest(directory)["step"] == 3
