"""The port's serve stack on the CPU: ``DetectionServer`` over
``DetectEngine.from_state(..., device="cpu")``.

The JAX serve contract (its ``serve/frontend.py`` docstring) held inside the
port: a served image's detections are exactly what ``make_detect_fn`` +
``detections_to_coco`` give for the same resized image in the same bucket,
bit for bit, in both batching modes.  Plus the drain on ``close()``, the
per-request rejection of a bad payload, encoded payloads decoded by the
port's codec, the port's torch resize against the JAX package's
``resize_for_bucket`` (cv2 ``INTER_LINEAR``), the HTTP frontend's status
codes and JSON keys against the JAX package's ``serve_http``, and the serve
command line's refusals.
"""

import json
import threading
from pathlib import Path
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.data import pipeline as j_pipeline
from batchai_retinanet_horovod_coco_tpu.serve import frontend as j_frontend
from batchai_retinanet_horovod_coco_tpu.serve.common import ServeConfig as JaxServeConfig
from batchai_retinanet_horovod_coco_tpu.serve.stub import StubDetectEngine
from batchai_retinanet_horovod_coco_tpu_torch.data import image_io
from batchai_retinanet_horovod_coco_tpu_torch.data import pipeline as t_pipeline
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as t_detect
from batchai_retinanet_horovod_coco_tpu_torch.models import retinanet as t_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import nms as nms_cuda
from batchai_retinanet_horovod_coco_tpu_torch.ops.nms import Detections
from batchai_retinanet_horovod_coco_tpu_torch.serve.batcher import assemble_requests
from batchai_retinanet_horovod_coco_tpu_torch.serve.common import (
    RequestRejected,
    ServeConfig,
    ServeRequest,
    ServerClosed,
)
from batchai_retinanet_horovod_coco_tpu_torch.serve.engine import DetectEngine
from batchai_retinanet_horovod_coco_tpu_torch.serve import frontend as t_frontend
from batchai_retinanet_horovod_coco_tpu_torch.serve.frontend import DetectionServer

REPO_ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(
    num_classes=3, backbone="resnet_test", fpn_channels=32, head_width=32,
    head_depth=2, dtype=torch.float32,
)
MIN_SIDE, MAX_SIDE = 64, 96
BUCKETS = t_pipeline.default_buckets(MIN_SIDE, MAX_SIDE)  # (64, 96), (96, 64)
BATCH = 4
CONFIG = t_detect.DetectConfig(score_threshold=0.001, pre_nms_size=200, max_detections=100)
# (h, w): upscaled, downscaled, as-is, extreme aspect ratios, square; both
# orientations of each.
SIZES = [
    (48, 64), (64, 48), (120, 180), (180, 120), (64, 96), (96, 64),
    (30, 200), (200, 30), (100, 100),
]


def make_images(seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in SIZES]


@pytest.fixture(scope="module")
def model():
    return t_retinanet.build_retinanet(
        t_retinanet.RetinaNetConfig(**SMALL), device="cpu", seed=0
    )


def make_engine(model) -> DetectEngine:
    return DetectEngine.from_state(
        model, BUCKETS, (BATCH,), CONFIG, device="cpu",
        min_side=MIN_SIDE, max_side=MAX_SIDE,
    )


def expected(model, engine: DetectEngine, image: np.ndarray) -> list[dict]:
    """The port's own ``make_detect_fn`` + ``detections_to_coco`` on the
    resized image, alone in a padded batch of the served batch size."""
    h, w = image.shape[:2]
    hw = t_pipeline.bucket_for_source(h, w, MIN_SIDE, MAX_SIDE, BUCKETS)
    req = ServeRequest(0, None, None)
    req.image, scale = t_pipeline.resize_for_bucket(image, hw, MIN_SIDE, MAX_SIDE)
    req.scale = np.float32(scale)
    batch = assemble_requests([req], hw, BATCH)
    det = t_detect.make_detect_fn(model, hw, CONFIG, device="cpu")(batch.images)
    det = Detections(*(field.numpy() for field in det))
    dets = t_detect.detections_to_coco(
        det, np.zeros(BATCH, np.int64), batch.scales, batch.valid,
        engine.label_to_cat_id, image_sizes={0: (w, h)},
    )
    for d in dets:
        d.pop("image_id")
    return dets


@pytest.mark.parametrize("continuous", [True, False], ids=["continuous", "deadline"])
def test_served_results_equal_detect_fn(model, continuous):
    """Mixed sizes and orientations through the server: each result equals
    the port's own detect path on the same resized image, bit for bit,
    whichever rows it shared a batch with."""
    engine = make_engine(model)
    images = make_images(seed=1)
    before = nms_cuda.plain_calls
    with DetectionServer(
        engine, ServeConfig(max_delay_ms=20, preprocess_workers=2, continuous=continuous)
    ) as server:
        futures = [server.submit(img) for img in images]
        served = [f.result(timeout=120) for f in futures]
        snap = server.snapshot()
    assert snap["completed"] == len(images) and snap["failed"] == 0
    assert nms_cuda.plain_calls - before >= snap["batches"] > 0
    for image, got in zip(images, served):
        assert got, f"no detections for a {image.shape} image (vacuous check)"
        assert got == expected(model, engine, image), image.shape
    buckets = {
        t_pipeline.bucket_for_source(h, w, MIN_SIDE, MAX_SIDE, BUCKETS) for h, w in SIZES
    }
    assert buckets == set(BUCKETS)


def test_close_drains_in_flight_requests(model):
    engine = make_engine(model)
    server = DetectionServer(engine, ServeConfig(max_delay_ms=50, preprocess_workers=1))
    futures = [server.submit(img) for img in make_images(seed=2)[:5]]
    server.close()  # drains: every request admitted before close completes
    assert all(f.done() for f in futures)
    assert all(isinstance(f.result(), list) for f in futures)
    assert server.snapshot()["outstanding"] == 0
    with pytest.raises(ServerClosed):
        server.submit(make_images(seed=3)[0])
    server.close()  # idempotent


@pytest.mark.parametrize(
    "payload",
    [
        np.zeros((32, 32, 3), np.float32),  # not uint8
        np.zeros((32, 32), np.uint8),  # not HWC RGB
        b"\x89PNG encoded bytes",  # a PNG signature, then no PNG
    ],
    ids=["float", "gray", "bytes"],
)
def test_bad_payload_rejects_that_request_only(model, payload):
    engine = make_engine(model)
    with DetectionServer(engine, ServeConfig(max_delay_ms=10, preprocess_workers=1)) as server:
        with pytest.raises(RequestRejected) as info:
            server.detect(payload, timeout_s=60)
        assert info.value.reason == "decode_error"
        assert isinstance(server.detect(make_images(seed=4)[0], timeout_s=60), list)


@pytest.mark.parametrize("h,w", SIZES + [(333, 500), (17, 23)])
def test_resize_matches_jax_pipeline(h, w):
    """torch bilinear (half-pixel, no antialias) against cv2 INTER_LINEAR:
    the same bucket, scale and shape exactly; pixels within one grey level
    (cv2 interpolates uint8 in fixed point)."""
    image = np.random.default_rng(h * 1000 + w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    hw = t_pipeline.bucket_for_source(h, w, MIN_SIDE, MAX_SIDE, BUCKETS)
    assert hw == j_pipeline.bucket_for_source(h, w, MIN_SIDE, MAX_SIDE, BUCKETS)
    got, got_scale = t_pipeline.resize_for_bucket(image, hw, MIN_SIDE, MAX_SIDE)
    want, want_scale = j_pipeline.resize_for_bucket(image, hw, MIN_SIDE, MAX_SIDE)
    assert got_scale == want_scale
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    if got.shape == image.shape:
        assert got is image  # no resize: the input array itself


def test_pad_template_matches_jax_pipeline():
    np.testing.assert_array_equal(t_pipeline._PAD_PIXEL, j_pipeline._PAD_PIXEL)
    req = ServeRequest(0, None, None)
    req.image = np.full((40, 50, 3), 7, np.uint8)
    batch = assemble_requests([req], (64, 96), 2)
    assert batch.images.shape == (2, 64, 96, 3)
    assert (batch.images[0, :40, :50] == 7).all()
    assert (batch.images[0, 40:] == t_pipeline._PAD_PIXEL).all()
    assert (batch.images[0, :40, 50:] == t_pipeline._PAD_PIXEL).all()
    assert (batch.images[1] == t_pipeline._PAD_PIXEL).all()
    assert batch.valid.tolist() == [True, False]


def test_encoded_payloads_are_decoded_by_the_codec(model):
    """PNG bytes serve as their decoded pixels; a progressive JPEG, which
    the codec refuses, is that request's ``decode_error``."""
    engine = make_engine(model)
    image = make_images(seed=5)[0]
    progressive = (REPO_ROOT / "tests" / "fixtures" / "jpeg" / "progressive.jpg").read_bytes()
    with DetectionServer(engine, ServeConfig(max_delay_ms=10, preprocess_workers=1)) as server:
        assert server.detect(image_io.encode_png(image), timeout_s=60) == expected(model, engine, image)
        with pytest.raises(RequestRejected) as info:
            server.detect(progressive, timeout_s=60)
        assert info.value.reason == "decode_error" and "progressive" in str(info.value)


class BlockingPortEngine(DetectEngine):
    """The port's engine whose dispatch waits for ``release``."""

    release: threading.Event

    def dispatch(self, hw, images):
        self.release.wait(60)
        return super().dispatch(hw, images)


class BlockingJaxEngine(StubDetectEngine):
    release: threading.Event

    def dispatch(self, hw, images):
        self.release.wait(60)
        return super().dispatch(hw, images)


def http_call(base: str, path: str, body: bytes | None = None, trace: str | None = None):
    """(status, JSON body, trace header) of one request."""
    headers = {t_frontend.TRACE_HEADER: trace} if trace else {}
    request = urllib.request.Request(base + path, data=body, headers=headers,
                                     method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(request, timeout=60) as r:
            return r.status, json.load(r), r.headers.get(t_frontend.TRACE_HEADER)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e), e.headers.get(t_frontend.TRACE_HEADER)


def http_answers(server, serve_http, release: threading.Event) -> dict:
    """Status codes, JSON keys and trace echoes of the HTTP frontend over
    ``server`` for a good image, garbage bytes, an unknown path, a shed
    and a timeout (``release`` blocks the engine for the last two)."""
    good = image_io.encode_png(np.zeros((64, 64, 3), np.uint8))
    httpd = serve_http(server)
    blocked = serve_http(server, request_timeout_s=0.5)
    for h in (httpd, blocked):
        threading.Thread(target=h.serve_forever, daemon=True).start()
    base = "http://%s:%d" % httpd.server_address[:2]
    slow = "http://%s:%d" % blocked.server_address[:2]
    out = {}
    try:
        release.set()
        code, body, trace = http_call(base, "/detect", good, trace="client-trace-1")
        out["good"] = (code, sorted(body), trace, body["trace_id"])
        code, body, trace = http_call(base, "/detect", b"garbage")
        out["garbage"] = (code, sorted(body), body["reason"], len(trace), trace == body["trace_id"])
        code, body, _ = http_call(base, "/nowhere", good)
        out["unknown"] = (code, sorted(body))
        code, body, _ = http_call(base, "/stats")
        out["stats"] = (code, body["completed"])
        release.clear()
        answers: list = []
        threads = [threading.Thread(target=lambda: answers.append(http_call(slow, "/detect", good)))
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        out["shed"] = sorted({(c, tuple(sorted(b))) for c, b, _ in answers if c == 503})
        out["timeout"] = sorted({(c, tuple(sorted(b))) for c, b, _ in answers if c == 504})
        out["codes"] = sorted({c for c, _, _ in answers})
    finally:
        release.set()
        for h in (httpd, blocked):
            h.shutdown()
            h.server_close()
    return out


def test_http_answers_as_jax_serve_http(model):
    """The port's ``serve_http`` against the JAX package's (over its stub
    engine): the same status codes and JSON keys for a good image (200),
    garbage bytes (400), an unknown path (404), a shed (503: admission
    queue 1 behind a blocked engine) and a timeout (504), every /detect
    answer echoing its trace id (the client's, or a minted one)."""
    config = dict(admission_queue=1, bucket_queue=1, dispatch_depth=1, preprocess_workers=1,
                  max_delay_ms=1)
    port_engine = BlockingPortEngine.from_state(
        model, BUCKETS, (BATCH,), CONFIG, device="cpu", min_side=MIN_SIDE, max_side=MAX_SIDE,
    )
    jax_engine = BlockingJaxEngine(batch_sizes=(1,))
    for engine in (port_engine, jax_engine):
        engine.release = threading.Event()
        engine.release.set()  # the warm-up runs
    with j_frontend.DetectionServer(jax_engine, JaxServeConfig(**config)) as jax_server:
        want = http_answers(jax_server, j_frontend.serve_http, jax_engine.release)
    with DetectionServer(port_engine, ServeConfig(**config)) as port_server:
        got = http_answers(port_server, t_frontend.serve_http, port_engine.release)
    assert got == want
    assert want["good"] == (200, ["detections", "trace_id"], "client-trace-1", "client-trace-1")
    assert want["garbage"] == (400, ["error", "reason", "trace_id"], "decode_error", 16, True)
    assert want["unknown"] == (404, ["error"])
    assert want["shed"] == [(503, ("error", "reason", "trace_id"))]
    assert want["timeout"] == [(504, ("error", "trace_id"))]


@pytest.mark.parametrize("flags", [
    ["--stub-engine"], ["--stub-delay-ms", "5"], ["--platform", "cpu"], ["--obs-trace"],
    ["--obs-port", "9000"], ["--slo-rule", "p99<100"], ["--replica-id", "r1"], ["--numerics"],
], ids=lambda f: f[0].lstrip("-"))
def test_serve_refusals_name_the_roadmap(flags):
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        t_frontend.main(["--export-dir", "nowhere", "--http", "0", "--device", "cpu", *flags])


def test_serve_flags_are_the_jax_command_line_s():
    want = {a.dest: a.default for a in j_frontend.build_parser()._actions}
    got = {a.dest: a.default for a in t_frontend.build_parser()._actions}
    refused = {f.lstrip("-").replace("-", "_") for f in t_frontend.REFUSED_FLAGS}
    assert set(got) == set(want) - refused | {"device"}
    assert all(got[k] == want[k] for k in got if k not in ("device", "export_dir"))
    assert got["device"] == "cuda"
