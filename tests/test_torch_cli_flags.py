"""The port's command line (``train/__main__.py``, ``utils/cli.py``) against
the JAX package's ``train.py``, on the CPU (``--device cpu``): the parser,
the presets, the refused flags and the flags that run.

The parser keeps ``train.py``'s flag names and defaults; flags that need
what is not ported are refused naming ``ROADMAP.md``; the launch flags map
to a ``DistributedConfig`` (a world's runs are in
``tests/test_torch_data_parallel.py``); every backbone, stem and
``--pretrained-backbone`` runs.  Runs are ``resnet_test`` at 64 x 64 (the
CLI's heads are full width: FPN 256, heads 256 x 4).  The runs and the
resumes are in ``tests/test_torch_cli_runs.py`` and
``tests/test_torch_cli_resume.py``.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.ops import anchors as j_anchors
from batchai_retinanet_horovod_coco_tpu.utils import cli as j_cli
from batchai_retinanet_horovod_coco_tpu_torch.data import shm_pipeline as t_shm
from batchai_retinanet_horovod_coco_tpu_torch.ops import anchors as t_anchors
from batchai_retinanet_horovod_coco_tpu_torch.parallel.mesh import world_devices
from batchai_retinanet_horovod_coco_tpu_torch.train import __main__ as t_train
from batchai_retinanet_horovod_coco_tpu_torch.utils import checkpoint as t_ckpt
from batchai_retinanet_horovod_coco_tpu_torch.utils import cli as t_cli
from chip_smoke import torchvision_resnet_layout
from test_torch_train import drop_tmp_path  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # train.py
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


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """The tier's six test workers share the host's cores, and torch's
    default of one intra-op thread a core only makes them contend: a CLI
    run of these files took 7.2 s on 2 threads and 10.4 s on 8 even alone
    (8 cores).  The command-line files import this fixture."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


SMALL = ["--image-min-side", "64", "--image-max-side", "64", "--backbone", "resnet_test", "--f32",
         "--batch-size", "4", "--workers", "2", "--device", "cpu"]


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
    """Every preset of train.py, the data-parallel dp8 and pod included."""
    assert set(t_train.PRESETS) == set(j_train.PRESETS) >= {"dp8", "pod"}
    for name, values in t_train.PRESETS.items():
        assert values == j_train.PRESETS[name]
        args = t_train.parse_args(["--preset", name, "synthetic", "--batch-size", "3"])
        assert args.batch_size == 3  # an explicit flag wins
        assert all(getattr(args, k) == v for k, v in values.items() if k != "batch_size")
    with pytest.raises(SystemExit):
        t_train.parse_args(["--preset", "dp16", "synthetic"])


# The launch flags of test_unported_flags_are_refused, each completed into
# the world it is part of.
LAUNCH_FLAGS = {
    "--num-devices": [],
    "--distributed-auto": [],
    "--coordinator-address": ["--num-processes", "2", "--process-id", "0"],
    "--num-processes": ["--coordinator-address", "h:1", "--process-id", "0"],
    "--process-id": ["--coordinator-address", "h:1", "--num-processes", "2"],
}


@pytest.mark.parametrize("flags", [
    ["--num-devices", "8"], ["--spatial-shards", "2"], ["--quantized-allreduce"],
    ["--shard-weight-update"], ["--distributed-auto"], ["--coordinator-address", "h:1"],
    ["--num-processes", "2"], ["--process-id", "0"], ["--data-worker-procs", "1"],
    ["--data-worker-timeout", "30"], ["--tensorboard"], ["--debug-nans"],
    ["--pretrained-backbone", "r50.pth"], ["--stem", "conv"], ["--pack-width"],
    ["--backbone", "mobilenet"],
], ids=lambda f: f[0])
def test_unported_flags_are_refused(flags, tmp_path, monkeypatch, capsys):
    """Each flag whose setting needs what is not ported is refused, naming
    it.  The decode-worker flags, refused before, now run a 2-step
    synthetic run on the CPU: ``--data-worker-procs`` through the
    shared-memory worker processes, ``--data-worker-timeout`` with them
    off.  So do the model flags: ``--stem conv``, ``--pack-width``,
    ``--backbone mobilenet``, and ``--pretrained-backbone`` with a random
    torchvision-layout file (one block a stage, as ``resnet_test``) under
    ``--norm frozen_bn``, whose statistics the snapshot then holds.  The
    launch flags, refused before, are accepted: each maps to the world it
    asks for (``DistributedConfig``), checked here without a run (a world
    of 2 runs in tests/test_torch_data_parallel.py)."""
    if flags[0] in LAUNCH_FLAGS:
        args = t_train.parse_args(["synthetic", "--device", "cpu", *flags, *LAUNCH_FLAGS[flags[0]]])
        t_train.refuse_unported(args)
        config = t_train.distributed_config(args)
        if flags[0] == "--num-devices":
            assert not config.joins and world_devices(args.num_devices, "cpu") == 8
        elif flags[0] == "--distributed-auto":
            assert config.auto and config.joins
        else:
            resolved = config.resolved()
            assert (resolved.coordinator_address, resolved.num_processes, resolved.process_id,
                    resolved.local_rank) == ("h:1", 2, 0, 0)
            assert resolved.init_method == "tcp://h:1" and resolved.backend_name() == "gloo"
        return
    if flags[0] in ("--pretrained-backbone", "--stem", "--pack-width", "--backbone"):
        if flags[0] == "--pretrained-backbone":
            rng = np.random.default_rng(0)
            layout = torchvision_resnet_layout((1, 1, 1, 1))
            weights = {k: torch.from_numpy(rng.uniform(0.5, 1.5, s).astype(np.float32)) for k, s in layout.items()}
            torch.save(weights, tmp_path / flags[1])
            flags = [flags[0], str(tmp_path / flags[1]), "--norm", "frozen_bn"]
        out = t_train.main(synthetic_flags(tmp_path) + flags + ["--steps", "2"])
        assert out["final_step"] == 2.0
        assert t_ckpt.latest_step(str(tmp_path / "ckpt")) == 2
        stats = t_ckpt.CheckpointManager(str(tmp_path / "ckpt")).restore_arrays()["batch_stats"]
        if flags[0] == "--pretrained-backbone":
            assert f"imported backbone weights from {flags[1]}" in capsys.readouterr().out
            np.testing.assert_array_equal(stats["backbone"]["stage5_block0"]["proj_norm"]["var"],
                                          weights["layer4.0.downsample.1.running_var"].numpy())
        return
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
