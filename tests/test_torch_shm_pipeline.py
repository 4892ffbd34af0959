"""The port's multiprocess shared-memory producer (``data/shm_pipeline.py``)
against its thread path and the JAX package's ``shm_pipeline``.

- For a fixed seed, with the full random transform, the batches equal the
  port's thread path bit for bit, and the JAX ``shm_pipeline``'s in every
  field but the images, which agree within the warp's tolerance
  (``tests/test_torch_data.py::test_build_pipeline_equals_jax``).
- Eval mode covers each record once and pads the short last batch.
- A killed worker, a wedged worker (a 2 s ``worker_timeout``) and a
  worker's exception each raise in the consumer; afterwards, and after
  ``close()``, no child is alive and no segment of this process is left in
  ``/dev/shm``.
- A worker never initializes CUDA.
- The resize that both paths run gives the same pixels on any number of
  torch threads (``F.interpolate`` does not: its last bit moves with them).

Segments are named with the producer's prefix and the creating pid, and
each check here reads only this process's: other test files (the JAX
package's among them) may run producers beside this one.  The JAX
producer's segments get a prefix of this file's own, so the JAX package's
leak checks never see them.
"""

import dataclasses
import os
import signal
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from batchai_retinanet_horovod_coco_tpu.data import coco as j_coco
from batchai_retinanet_horovod_coco_tpu.data import pipeline as j_pipeline
from batchai_retinanet_horovod_coco_tpu.data import shm_pipeline as j_shm
from batchai_retinanet_horovod_coco_tpu.data import synthetic as j_synthetic
from batchai_retinanet_horovod_coco_tpu.data import transforms as j_transforms
from batchai_retinanet_horovod_coco_tpu_torch.data import coco as t_coco
from batchai_retinanet_horovod_coco_tpu_torch.data import image_io
from batchai_retinanet_horovod_coco_tpu_torch.data import pipeline as t_pipeline
from batchai_retinanet_horovod_coco_tpu_torch.data import shm_pipeline as t_shm
from batchai_retinanet_horovod_coco_tpu_torch.data import transforms as t_transforms

BATCH_FIELDS = ("gt_boxes", "gt_labels", "gt_mask", "image_ids", "scales", "valid")
COMMON = dict(batch_size=4, min_side=64, max_side=96, max_gt=8, seed=3, num_workers=2,
              buckets=((64, 96), (96, 64)))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """11 JPEGs of 48 x 80 by the JAX package's writer, read by both
    packages' COCO readers."""
    root = str(tmp_path_factory.mktemp("shm_synthetic"))
    ann = j_synthetic.make_synthetic_coco(root, num_images=11, num_classes=3, image_size=(48, 80), seed=0)
    image_dir = os.path.join(root, "train")
    return t_coco.CocoDataset(ann, image_dir), j_coco.CocoDataset(ann, image_dir)


def config(**kw) -> t_pipeline.PipelineConfig:
    return t_pipeline.PipelineConfig(**{**COMMON, "num_worker_procs": 2, **kw})


def own_segments() -> list[str]:
    return [f for f in os.listdir("/dev/shm") if f.startswith(f"{t_shm.SHM_PREFIX}{os.getpid()}_")]


def assert_reaped(pipe) -> None:
    assert all(p.exitcode is not None for p in pipe.processes), "a worker outlived the pipeline"
    assert not own_segments(), own_segments()


def take(pipe, n: int) -> list:
    try:
        return [next(pipe) for _ in range(n)]
    finally:
        pipe.close()


def assert_warp_close(got: np.ndarray, want: np.ndarray) -> None:
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (d <= 1).mean() >= 0.99 and d.mean() <= 0.5, (d.max(), (d > 1).mean(), d.mean())


def torch_bilinear(image: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """The resize's arithmetic as separate f32 torch ops: taps as
    ``F.interpolate`` places them, across then down, rounded half to even."""
    def taps(n_in, n_out):
        scale = float(np.float32(n_in) / np.float32(n_out))
        src = ((torch.arange(n_out, dtype=torch.float32) + 0.5) * scale - 0.5).clamp(min=0.0)
        i0 = src.to(torch.int64)
        w1 = src - i0.to(torch.float32)
        return i0, torch.where(i0 < n_in - 1, i0 + 1, i0), 1.0 - w1, w1

    x = torch.from_numpy(image).to(torch.float32)
    y0, y1, wy0, wy1 = taps(x.shape[0], nh)
    x0, x1, wx0, wx1 = taps(x.shape[1], nw)
    across = x[:, x0] * wx0[:, None] + x[:, x1] * wx1[:, None]
    out = across[y0] * wy0[:, None, None] + across[y1] * wy1[:, None, None]
    return out.round().clamp(0, 255).to(torch.uint8).numpy()


def test_resize_is_its_f32_formulation_on_any_thread_count():
    """The pipeline's resize (the codec's) equals its arithmetic written as
    f32 torch ops, and within a grey level ``F.interpolate``, whose last bit
    moves with torch's thread count: so a worker on one torch thread and a
    decode thread beside the step give the same pixels."""
    rng = np.random.default_rng(0)
    threads = torch.get_num_threads()
    try:
        for h, w, nh, nw in ((48, 80, 58, 96), (480, 640, 800, 1067), (7, 3, 64, 96), (333, 500, 64, 96)):
            image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            got = image_io.resize_bilinear(image, nh, nw)
            for n in (1, threads):
                torch.set_num_threads(n)
                assert np.array_equal(got, torch_bilinear(image, nh, nw))
                plain = F.interpolate(torch.from_numpy(image).permute(2, 0, 1)[None].float(), size=(nh, nw),
                                      mode="bilinear", align_corners=False)
                plain = plain[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()
                assert np.abs(plain.astype(np.int16) - got).max() <= 1
    finally:
        torch.set_num_threads(threads)


def test_prefix_is_not_the_jax_package_s():
    assert t_shm.SHM_PREFIX == "rtorchshm" and not t_shm.SHM_PREFIX.startswith(j_shm._SHM_PREFIX)


def test_batches_equal_the_thread_path_and_jax_shm_pipeline(datasets, monkeypatch):
    t_ds, j_ds = datasets
    t_cfg = config(transform=t_transforms.TransformConfig())
    threads = take(t_pipeline.build_pipeline(t_ds, dataclasses.replace(t_cfg, num_worker_procs=0)), 4)
    pipe = t_pipeline.build_pipeline(t_ds, t_cfg)
    assert isinstance(pipe, t_shm._ShmPipeline) and len(pipe.processes) == 2
    procs = take(pipe, 4)
    assert_reaped(pipe)
    assert not pipe.workers_touched_cuda
    # The JAX producer under a prefix of this file's own (see the docstring).
    monkeypatch.setattr(j_shm, "_SHM_PREFIX", "rtorchjaxshm")
    j_cfg = j_pipeline.PipelineConfig(**{**COMMON, "num_worker_procs": 2},
                                      transform=j_transforms.TransformConfig())
    j_pipe = j_pipeline.build_pipeline(j_ds, j_cfg)
    assert isinstance(j_pipe, j_shm._ShmPipeline)
    jax = take(j_pipe, 4)
    for got, want, ref in zip(procs, threads, jax):
        for field in ("images", *BATCH_FIELDS):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
        for field in BATCH_FIELDS:
            np.testing.assert_array_equal(getattr(got, field), getattr(ref, field), err_msg=field)
        assert_warp_close(got.images, ref.images)


def test_eval_covers_each_record_once_with_padding(datasets):
    t_ds, _ = datasets
    cfg = config(shuffle=False, hflip_prob=0.0)
    want = list(t_pipeline.build_pipeline(t_ds, dataclasses.replace(cfg, num_worker_procs=0), train=False))
    pipe = t_pipeline.build_pipeline(t_ds, cfg, train=False)
    got = list(pipe)
    assert_reaped(pipe)
    assert [b.images.shape[0] for b in got] == [4, 4, 4]
    seen = np.concatenate([b.image_ids[b.valid] for b in got]).tolist()
    assert sorted(seen) == sorted(r.image_id for r in t_ds.records)
    assert not got[-1].valid.all()
    for a, b in zip(got, want, strict=True):
        for field in ("images", *BATCH_FIELDS):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    with pytest.raises(StopIteration):
        next(pipe)


def test_close_reaps_every_child_and_segment(datasets):
    t_ds, _ = datasets
    pipe = t_pipeline.build_pipeline(t_ds, config())
    next(pipe)
    assert sorted(own_segments()) == sorted(n.lstrip("/") for n in pipe.shm_names)
    assert all(p.is_alive() for p in pipe.processes)
    pipe.close()
    assert_reaped(pipe)
    assert not pipe._thread.is_alive()
    pipe.close()  # idempotent


def test_a_killed_worker_raises(datasets):
    t_ds, _ = datasets
    pipe = t_pipeline.build_pipeline(t_ds, config())
    next(pipe)
    os.kill(pipe.processes[0].pid, signal.SIGKILL)
    deadline = time.monotonic() + 30
    with pytest.raises(RuntimeError, match="died unexpectedly"):
        while time.monotonic() < deadline:
            next(pipe)
    assert time.monotonic() < deadline
    assert_reaped(pipe)


def test_a_wedged_worker_trips_the_timeout(datasets):
    """One worker, stopped with SIGSTOP: alive but silent."""
    t_ds, _ = datasets
    pipe = t_pipeline.build_pipeline(t_ds, config(num_worker_procs=1, worker_timeout=2.0))
    next(pipe)
    os.kill(pipe.processes[0].pid, signal.SIGSTOP)
    start = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match=r"stalled.*worker_timeout=2.0s"):
            while time.monotonic() - start < 30:
                next(pipe)
        assert time.monotonic() - start >= 2.0
    finally:
        pipe.close()  # SIGKILL reaches a stopped process
    assert_reaped(pipe)


def test_a_worker_exception_arrives_with_its_traceback(datasets, tmp_path):
    t_ds, _ = datasets
    broken = t_coco.CocoDataset.__new__(t_coco.CocoDataset)
    broken.__dict__.update(t_ds.__dict__, image_dir=str(tmp_path))  # no image there
    pipe = t_pipeline.build_pipeline(broken, config(shuffle=False), train=False)
    with pytest.raises(RuntimeError, match=r"(?s)worker \d failed:.*Traceback.*FileNotFoundError"):
        next(pipe)
    assert_reaped(pipe)
