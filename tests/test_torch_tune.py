"""The port's schedule search (``tune/candidates.py``, ``tune/search.py``)
and the consumers of the kernels' launch shapes, on the CPU.

The candidates are registry entries and each menu holds its default; the
``--from-report`` reader gives the JAX package's ``(ops, batch_axis)`` and
its ``SystemExit`` cases on the same report documents; a trial that fails
is recorded, a sticky CUDA error stops the search, an approximate trial
never wins, all with injected trial programs, and a card's trial is timed
as one replay of a captured graph between CUDA events (faked here).  The
consumers: the train step and the detect path resolve the launch shapes
from the registry (an explicit value wins), the wrappers refuse a shape off
the menu, a program exported before the NMS op took launch shapes still
loads and runs, and the plain culling test lists every gt that has an IoU
above 0 in a tile, at every tile of the menu and at larger ones.
"""

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.tune import __main__ as j_tune_cli
from batchai_retinanet_horovod_coco_tpu.tune import candidates as j_candidates
from batchai_retinanet_horovod_coco_tpu_torch import losses as t_losses
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as t_detect
from batchai_retinanet_horovod_coco_tpu_torch.ops import anchors as t_anchors
from batchai_retinanet_horovod_coco_tpu_torch.ops import matching as t_matching
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import focal as t_focal_cuda
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import matching as t_matching_cuda
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import nms as t_nms_cuda
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import shapes as t_shapes
from batchai_retinanet_horovod_coco_tpu_torch.ops.iou import pairwise_iou
from batchai_retinanet_horovod_coco_tpu_torch.train import step as t_step
from batchai_retinanet_horovod_coco_tpu_torch.tune import __main__ as t_tune_cli
from batchai_retinanet_horovod_coco_tpu_torch.tune import candidates as t_candidates
from batchai_retinanet_horovod_coco_tpu_torch.tune import schedule as schedule_lib
from batchai_retinanet_horovod_coco_tpu_torch.tune import search as t_search

REPO = Path(__file__).resolve().parents[1]
GOLDEN_REPORT = REPO / "tests" / "fixtures" / "perf_doctor" / "PERF_REPORT.golden.json"


@pytest.fixture(autouse=True)
def clean_registry(monkeypatch):
    """The lookup cache and the once-a-reason lines are process-global."""
    monkeypatch.delenv(schedule_lib.ENV_DIR, raising=False)
    schedule_lib._cache.clear()
    schedule_lib._warned.clear()
    yield
    schedule_lib._cache.clear()
    schedule_lib._warned.clear()


def doc(kind="cpu", **entries):
    return {"format": schedule_lib.FORMAT, "device_kind": kind, "entries": entries}


# ---- candidates ------------------------------------------------------------


@pytest.mark.parametrize("op,kwargs,count", [("nms", {}, 6), ("nms", {"include_semantic": True}, 18),
                                             ("focal", {}, 4), ("matching", {}, 2)],
                         ids=["nms", "nms-semantic", "focal", "matching"])
def test_every_candidate_is_a_registry_entry_and_the_menu_holds_the_default(op, kwargs, count):
    cands = t_candidates.candidates_for(op, **kwargs)
    for params in cands:
        schedule_lib.validate_schedule(doc(**{op: params}))
    assert sum(t_candidates.is_default(op, p) for p in cands) == 1
    assert len(cands) == count == len({json.dumps(p, sort_keys=True) for p in cands})
    for (menu_op, key), menu in t_shapes.MENUS.items():
        if menu_op == op:
            assert schedule_lib.DEFAULT_SCHEDULE[op][key] == t_shapes.DEFAULTS[(op, key)] in menu
            assert sorted({p[key] for p in cands}) == sorted(menu)
    assert t_candidates.PRE_NMS_SIZES == j_candidates.PRE_NMS_SIZES
    assert schedule_lib.MENUS is t_shapes.MENUS


def test_unknown_op_is_named_as_the_jax_package_names_it():
    """The JAX package's message, less its batch axis, which the port has
    not."""
    with pytest.raises(ValueError) as want:
        j_candidates.candidates_for("conv")
    with pytest.raises(ValueError) as got:
        t_candidates.candidates_for("conv")
    assert str(got.value) == str(want.value).replace("batch, ", "")
    with pytest.raises(ValueError, match="unknown op 'batch'"):
        t_candidates.candidates_for("batch")


# ---- --from-report against the JAX reader ----------------------------------


REPORTS = {
    "golden": None,
    "ranked": {"bottlenecks": [{"name": "device_step", "tune_ops": ["focal", "matching", "nms"]},
                               {"name": "eval_pipeline", "tune_ops": ["nms", "batch"]},
                               {"name": "compilation", "tune_ops": []}]},
    "batch-only": {"bottlenecks": [{"name": "host_input_pipeline", "tune_ops": ["batch"]}]},
    "no-tune-ops-key": {"bottlenecks": [{"name": "x"}, {"name": "y", "tune_ops": ["nms"]}]},
    "nothing-tunable": {"bottlenecks": [{"name": "compilation", "tune_ops": []}]},
    "no-bottlenecks": {"top": []},
    "array": [1, 2, 3],
    "strings": {"bottlenecks": ["not-a-dict"]},
    "not-json": "{not json",
    "missing": "",
}


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_ops_from_report_equals_the_jax_reader(name, tmp_path):
    if name == "golden":
        path = str(GOLDEN_REPORT)
    else:
        path = str(tmp_path / "PERF_REPORT.json")
        body = REPORTS[name]
        if name != "missing":
            Path(path).write_text(body if isinstance(body, str) else json.dumps(body))

    def run(reader):
        try:
            return ("ok", reader(path))
        except SystemExit as e:
            return ("exit", str(e))

    want, got = run(j_tune_cli._ops_from_report), run(t_tune_cli._ops_from_report)
    assert got == want
    assert want[0] == ("exit" if name in ("nothing-tunable", "no-bottlenecks", "array", "strings",
                                          "not-json", "missing") else "ok")


# ---- trials with injected programs -----------------------------------------


def test_a_failed_candidate_is_recorded_not_fatal():
    def build(params):
        if params["tile_a"] == 128:
            raise RuntimeError("matching kernel launch failed: too many resources requested for launch")
        return lambda: None

    ok = t_search.run_trial("matching", {"tile_a": 256}, build, steps=2)
    bad = t_search.run_trial("matching", {"tile_a": 128}, build, steps=2)
    assert ok.status == "ok" and ok.ms_per_call is not None and len(ok.window_ms) == 2
    assert bad.status == "failed" and "too many resources" in bad.error
    assert bad.record()["ms_per_call"] is None


@pytest.mark.parametrize("text", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "CUDA error: misaligned address",
    "CUDA error: device-side assert triggered",
])
@pytest.mark.parametrize("chained", [False, True], ids=["direct", "cause"])
def test_a_sticky_cuda_error_stops_the_search(text, chained):
    def build(params):
        if not chained:
            raise RuntimeError(text)
        try:
            raise RuntimeError(text)
        except RuntimeError as inner:
            raise ValueError("NMS mask kernel launch failed") from inner

    with pytest.raises(t_search.DeviceUnavailable) as info:
        t_search.run_trial("nms", {"mask_lanes": 4, "scan_threads": 256}, build, steps=2)
    assert isinstance(info.value.__cause__, RuntimeError if not chained else ValueError)
    assert not t_search.is_sticky(RuntimeError("too many resources requested for launch"))


def test_an_approximate_trial_never_wins(monkeypatch):
    def fake_builder(batch, hw, device):
        def build(params):
            # The approximate candidate is made the fastest.
            delay = 0.0 if params["pre_nms_size"] != 1000 else 0.003
            return lambda: time.sleep(delay)
        return build

    monkeypatch.setitem(t_search._BUILDERS, "nms", fake_builder)
    monkeypatch.setattr(t_search, "windows_for", lambda device: t_search.host_windows)
    shape = {"mask_lanes": 4, "scan_threads": 256}
    # device "cuda" so that every candidate runs: the injected programs
    # touch no card, and are timed on the host's clock.
    winner, trials = t_search.search_op(
        "nms", steps=2, device="cuda",
        candidates=[{**shape, "pre_nms_size": 1000}, {**shape, "pre_nms_size": 512}])
    assert winner["pre_nms_size"] == 1000
    approx = [t for t in trials if t.semantics == "approx"]
    assert len(approx) == 1 and approx[0].status == "ok"
    assert approx[0].ms_per_call < trials[0].ms_per_call


def test_on_the_cpu_only_the_default_is_measured(monkeypatch):
    def fake_builder(batch, hw, device):
        return lambda params: (lambda: None)

    monkeypatch.setitem(t_search._BUILDERS, "focal", fake_builder)
    winner, trials = t_search.search_op("focal", steps=2, device="cpu")
    assert winner == schedule_lib.DEFAULT_SCHEDULE["focal"]
    assert [t.status for t in trials].count("ok") == 1
    assert all("no CUDA device" in t.error for t in trials if t.status == "skipped")


def test_a_card_trial_is_timed_in_device_time(monkeypatch):
    """On a card the window is device time: the calls are captured once in
    a graph and replayed once untimed, and each window is one replay
    between two CUDA events."""
    calls, replays = [], []

    class Graph:
        def replay(self):
            replays.append(len(calls))

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            self.at = len(replays)

        def elapsed_time(self, other):
            # 2 ms a replay: the ms of the replays between the two events.
            return 2.0 * (other.at - self.at)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    assert t_search.windows_for(torch.device("cuda")) is t_search.device_windows
    assert t_search.windows_for(torch.device("cpu")) is t_search.host_windows
    trial = t_search.run_trial("matching", {"tile_a": 128}, lambda params: lambda: calls.append(1),
                               steps=10, windows=t_search.device_windows)
    # Two warm-up calls, then five captured; one untimed replay, then the
    # windows replay them.
    assert len(calls) == 7 and replays == [7, 7, 7]
    assert trial.status == "ok" and trial.window_ms == [0.4, 0.4] and trial.ms_per_call == 0.4
    assert trial.noise_pct == 0.0


def test_compose_schedule_validates_what_it_writes():
    trial = t_search.Trial("matching", {"tile_a": 300}, 1.0, [1.0, 1.0], 0.0)
    with pytest.raises(schedule_lib.ScheduleError, match="matching.tile_a"):
        t_search.compose_schedule("cpu", {"matching": {"tile_a": 300}}, [trial])
    good = t_search.compose_schedule("cpu", {"matching": {"tile_a": 128}}, [trial])
    assert good["trials"] == [trial.record()]


# ---- consumers --------------------------------------------------------------


def test_the_train_step_resolves_the_kernels_launch_shapes(tmp_path, monkeypatch):
    loss, match = t_losses.LossConfig(), t_matching.MatchingConfig()
    got = t_step.resolve_kernel_schedule(loss, match, "cpu")
    assert (got[0].focal_fwd_tile_a, got[0].focal_bwd_tile_a, got[1].tile_a) == (2048, 256, 256)
    monkeypatch.setenv(schedule_lib.ENV_DIR, str(tmp_path))
    schedule_lib.save_schedule(doc(focal={"fwd_tile_a": 1024, "bwd_tile_a": 128},
                                   matching={"tile_a": 128}), str(tmp_path))
    got = t_step.resolve_kernel_schedule(loss, match, torch.device("cpu"))
    assert (got[0].focal_fwd_tile_a, got[0].focal_bwd_tile_a, got[1].tile_a) == (1024, 128, 128)
    pinned = t_step.resolve_kernel_schedule(
        t_losses.LossConfig(focal_fwd_tile_a=2048), t_matching.MatchingConfig(tile_a=256), "cpu")
    assert (pinned[0].focal_fwd_tile_a, pinned[0].focal_bwd_tile_a, pinned[1].tile_a) == (2048, 128, 256)


def test_the_wrappers_refuse_a_shape_off_the_menu():
    anchors = torch.tensor([[0.0, 0.0, 10.0, 10.0]])
    gts = (torch.tensor([[[1.0, 1.0, 9.0, 9.0]]]), torch.zeros((1, 1), dtype=torch.int32),
           torch.ones((1, 1), dtype=torch.bool))
    assert len(t_matching_cuda.assign_fused(anchors, *gts, 128)) == 5
    with pytest.raises(ValueError, match="tile_a 300 is not on the kernel's menu"):
        t_matching_cuda.assign_fused(anchors, *gts, 300)
    with pytest.raises(ValueError, match="tile_a 300"):
        t_matching.anchor_targets_compact_batched(anchors, *gts, t_matching.MatchingConfig(tile_a=300))
    logits, labels, state = torch.zeros((1, 2, 4)), torch.zeros((1, 2), dtype=torch.int32), \
        torch.ones((1, 2), dtype=torch.int32)
    t_focal_cuda.focal_loss_per_image_sums(logits, labels, state, fwd_tile_a=1024, bwd_tile_a=128)
    with pytest.raises(ValueError, match="bwd_tile_a 64"):
        t_focal_cuda.focal_loss_per_image_sums(logits, labels, state, bwd_tile_a=64)
    with pytest.raises(ValueError, match="fwd_tile_a 8192"):
        t_losses.focal_loss_compact(logits, labels, state, t_losses.LossConfig(focal_fwd_tile_a=8192))
    boxes, scores = torch.tensor([[[0.0, 0.0, 1.0, 1.0]]]), torch.tensor([[0.9]])
    classes = torch.zeros((1, 1), dtype=torch.int32)
    assert t_nms_cuda.nms_keep_mask(boxes, scores, classes, 0.5, 8, 512).tolist() == [[True]]
    with pytest.raises(ValueError, match="scan_threads 64"):
        t_nms_cuda.nms_keep_mask(boxes, scores, classes, 0.5, 4, 64)
    with pytest.raises(ValueError, match="mask_lanes 1 is not on the kernel's menu \\[2, 4, 8\\]"):
        t_nms_cuda.nms_keep_mask(boxes, scores, classes, 0.5, 1, 256)


OLD_EXPORT = """
import sys, torch
@torch.library.custom_op("retinanet_torch::nms_keep_mask", mutates_args=(), device_types="cpu")
def op(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
       iou_threshold: float) -> torch.Tensor:
    raise AssertionError("never run")
@op.register_fake
def _(boxes, scores, classes, iou_threshold):
    return scores.new_empty(scores.shape, dtype=torch.bool)
class Keep(torch.nn.Module):
    def forward(self, b, s, c):
        return torch.ops.retinanet_torch.nms_keep_mask.default(b, s, c, 0.5)
args = (torch.rand(2, 6, 4), torch.rand(2, 6), torch.zeros((2, 6), dtype=torch.int32))
torch.export.save(torch.export.export(Keep(), args), sys.argv[1])
"""


def test_a_program_exported_before_the_launch_shapes_still_loads_and_runs(tmp_path):
    """An export whose NMS call has the op's first schema (no launch shapes)
    loads with today's op and runs at the default shape."""
    path = str(tmp_path / "old.pt2")
    out = subprocess.run([sys.executable, "-c", OLD_EXPORT, path], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    program = torch.export.load(path)
    call = [n for n in program.graph.nodes if n.op == "call_function"][0]
    assert len(call.args) == 4
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 50, (2, 6, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + 20], -1))
    scores = torch.sort(torch.from_numpy(rng.uniform(0, 1, (2, 6)).astype(np.float32)),
                        descending=True).values
    classes = torch.zeros((2, 6), dtype=torch.int32)
    before = t_nms_cuda.plain_calls
    got = program.module()(boxes, scores, classes)
    assert t_nms_cuda.plain_calls == before + 1
    assert torch.equal(got, t_nms_cuda.nms_keep_mask_plain(boxes, scores, classes, 0.5))


@pytest.mark.parametrize("tile", sorted({*t_shapes.MENUS[("matching", "tile_a")], 512, 1024}))
def test_the_culling_lists_every_gt_with_an_iou_in_the_tile(tile):
    """``tile_gt_lists``, the matching kernel's culling test in plain
    PyTorch: at every tile of the menu (and at larger ones: the argument
    holds for any tile), every real gt with an IoU above 0 against an
    anchor of a tile is on that tile's list."""
    anchors = torch.from_numpy(np.array(t_anchors.anchors_for_image_shape((256, 384)), np.float32))
    rng = np.random.default_rng(tile)
    b, g = 3, 40
    xy = rng.uniform(-40, 400, (b, g, 2))
    wh = rng.uniform(1, 200, (b, g, 2))
    gt_boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))
    gt_mask = torch.from_numpy(rng.uniform(size=(b, g)) < 0.8)
    lists = t_matching_cuda.tile_gt_lists(anchors, gt_boxes, gt_mask, tile)  # (B, T, G)
    a = anchors.shape[0]
    t = -(-a // tile)
    iou = pairwise_iou(anchors, gt_boxes) * gt_mask[:, None, :]  # (B, A, G)
    hit = torch.zeros((b, t * tile, g), dtype=torch.bool)
    hit[:, :a] = iou > 0
    hit = hit.view(b, t, tile, g).any(2)
    assert lists.shape == (b, t, g)
    assert not (hit & ~lists).any()
    assert hit.any() and not lists.all()
