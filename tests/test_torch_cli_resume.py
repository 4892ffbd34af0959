"""The port's command line (``train/__main__.py``) on the CPU
(``--device cpu``): a NaN batch aborts a run, ``--auto-resume`` heals it,
and ``--resume-elastic`` continues the stream of a stopped run.  Runs are
``resnet_test`` at 64 x 64 (the CLI's heads are full width: FPN 256,
heads 256 x 4) with a checkpoint every step or two.
"""

import json

import pytest

from batchai_retinanet_horovod_coco_tpu_torch.train import __main__ as t_train
from batchai_retinanet_horovod_coco_tpu_torch.utils import checkpoint as t_ckpt
from test_torch_cli_flags import synthetic_flags, two_torch_threads  # noqa: F401
from test_torch_train import drop_tmp_path  # noqa: F401


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
