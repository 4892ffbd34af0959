"""The port's boundary: what it imports, and where it runs by default.

The port imports torch and numpy, never JAX, flax, cv2, PIL or the JAX
package (not even that package's jax-free modules), so it runs on a machine
that has only PyTorch.  Its entry points default to ``device="cuda"`` and
raise without a card; they never fall back to the CPU.
"""

import ast
import inspect
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import batchai_retinanet_horovod_coco_tpu_torch as port
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as t_detect
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import export as t_export
from batchai_retinanet_horovod_coco_tpu_torch.models import retinanet as t_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.serve.engine import DetectEngine
from batchai_retinanet_horovod_coco_tpu_torch.train import state as t_state
from batchai_retinanet_horovod_coco_tpu_torch.train import step as t_step

PACKAGE_DIR = Path(port.__file__).resolve().parent
REPO_ROOT = PACKAGE_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cv2", "PIL", "batchai_retinanet_horovod_coco_tpu")
SOURCES = sorted(PACKAGE_DIR.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]
SMALL = dict(num_classes=3, backbone="resnet_test", fpn_channels=32, head_width=32, head_depth=2)


def imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_sources_import_nothing_forbidden():
    assert len(SOURCES) > 20
    bad = [
        (str(path.relative_to(REPO_ROOT)), name)
        for path in SOURCES
        for name in imported_modules(path)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad
    # The scan sees the port's own imports, so it is not vacuous.
    assert "batchai_retinanet_horovod_coco_tpu_torch.ops" in imported_modules(
        PACKAGE_DIR / "ops" / "cuda" / "nms.py"
    )
    scanned = {str(path.relative_to(PACKAGE_DIR)) for path in SOURCES[:-1]}
    assert {"losses.py", "ops/matching.py", "ops/cuda/matching.py", "ops/cuda/focal.py",
            "train/optim.py", "train/state.py", "train/step.py", "train/loop.py",
            "utils/checkpoint.py", "utils/atomicio.py", "data/coco.py", "data/prefetch.py",
            "evaluate/coco_eval.py", "evaluate/voc_eval.py", "data/image_io.py",
            "data/transforms.py", "data/pipeline.py", "data/synthetic.py", "data/csv.py",
            "data/pascal_voc.py", "native/build.py", "utils/cli.py", "train/__main__.py",
            "evaluate/__main__.py", "evaluate/export.py", "convert_model.py",
            "serve/__main__.py", "obs/__init__.py", "obs/trace.py", "obs/watchdog.py",
            "obs/events.py", "obs/telemetry.py", "obs/slo.py", "obs/numerics.py",
            "obs/vocabulary.py", "utils/locks.py", "data/shm_pipeline.py",
            "evaluate/_native.py", "launch/__init__.py", "launch/pod.py",
            "parallel/__init__.py", "parallel/mesh.py"} <= scanned


def test_serving_and_training_modules_load_without_jax():
    code = (
        "import sys\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.serve.frontend\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.evaluate.detect\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.models.convert\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.train.loop\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.utils.checkpoint\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.ops.cuda.matching\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.ops.cuda.focal\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.data\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.data.shm_pipeline\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.evaluate._native\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.train.__main__\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.evaluate.__main__\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.evaluate.export\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.obs.telemetry\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.obs.slo\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.obs.numerics\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.obs.vocabulary\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.convert_model\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.serve.__main__\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.launch\n"
        "import batchai_retinanet_horovod_coco_tpu_torch.parallel\n"
        f"roots = {FORBIDDEN!r}\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & set(roots)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_every_device_default_is_cuda():
    """No function or constructor of the port defaults to the CPU."""
    defaults = []
    for path in sorted(PACKAGE_DIR.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            args = node.args.args + node.args.kwonlyargs
            values = [None] * (len(node.args.args) - len(node.args.defaults))
            values += node.args.defaults + node.args.kw_defaults
            for arg, value in zip(args, values):
                if arg.arg == "device" and value is not None:
                    defaults.append((path.name, node.name, ast.literal_eval(value)))
    assert {d[2] for d in defaults} == {"cuda"}, defaults
    assert {d[1] for d in defaults} >= {
        "make_detect_fn", "from_state", "build_retinanet", "make_train_step",
        "create_train_state", "from_export", "export_detector", "export_model", "load_model",
    }


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    model = t_retinanet.RetinaNet(t_retinanet.RetinaNetConfig(**SMALL))
    assert inspect.signature(DetectEngine.from_state).parameters["device"].default == "cuda"
    calls = [
        lambda: DetectEngine.from_state(model, ((64, 64),), (1,), min_side=64, max_side=64),
        lambda: t_detect.make_detect_fn(model, (64, 64)),
        lambda: t_retinanet.build_retinanet(t_retinanet.RetinaNetConfig(**SMALL)),
        lambda: t_step.make_train_step(model, (64, 64), 3),
        lambda: t_state.create_train_state(model),
        lambda: DetectEngine.from_export("no-export-dir"),
        lambda: t_export.load_model("no-export-dir"),
        lambda: t_export.export_detector(model, (64, 64), 1),
    ]
    if torch.cuda.is_available():
        engine = calls[0]()
        assert engine.device.type == "cuda"
        assert next(model.parameters()).device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    cpu = DetectEngine.from_state(
        model.cpu(), ((64, 64),), (1,), device="cpu", min_side=64, max_side=64
    )
    assert cpu.device.type == "cpu"
