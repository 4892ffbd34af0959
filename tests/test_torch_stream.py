"""The port's streaming sessions (``serve/stream.py``, the ``/stream*``
routes of ``serve/frontend.py::serve_http``, the fleet's stream pins and
``obs/telemetry.py::record_stream_frame``) against the JAX package's.

Every comparison is exact:

- ``TrackStitcher``: the same track ids on seeded detection sequences
  whose boxes lie on a ¼-pixel grid (every product of the IoU is exact in
  f32 there, so a tie at the threshold is a tie on both sides, whether or
  not XLA:CPU contracts the JAX side's products into FMAs), ties at the
  threshold included;
- the frame-delta cache hits the same frames, and the stream answers
  (track ids included) are equal, over each package's ``--stub-video``
  stub engine;
- with the cache off, a stream answer without ``track_id`` equals the
  single-image answer for the same image, on a port model on the CPU
  (``resnet_test``);
- ``/stream/open``, ``/stream/frame``, ``/stream/close`` and ``GET
  /stream`` over the port's ``serve_http`` give the JAX ``serve_http``'s
  status codes and JSON bodies (session ids and latencies, which are
  random and clocks, left out);
- a stream through the fleet is pinned, re-pinned once when its replica
  dies, and loses no frame, as in the JAX router;
- the ``serve_stream_*`` series are byte-equal to the JAX registry's for
  the same record calls.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from batchai_retinanet_horovod_coco_tpu.obs import telemetry as j_telemetry
from batchai_retinanet_horovod_coco_tpu.obs import trace as j_trace
from batchai_retinanet_horovod_coco_tpu.obs import watchdog as j_watchdog
from batchai_retinanet_horovod_coco_tpu.serve import common as j_common
from batchai_retinanet_horovod_coco_tpu.serve import fleet as j_fleet
from batchai_retinanet_horovod_coco_tpu.serve import frontend as j_frontend
from batchai_retinanet_horovod_coco_tpu.serve import replica as j_replica
from batchai_retinanet_horovod_coco_tpu.serve import stream as j_stream
from batchai_retinanet_horovod_coco_tpu.serve import stub as j_stub
from batchai_retinanet_horovod_coco_tpu.utils import backoff as j_backoff
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as t_detect
from batchai_retinanet_horovod_coco_tpu_torch.models import retinanet as t_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.obs import telemetry as t_telemetry
from batchai_retinanet_horovod_coco_tpu_torch.obs import trace as t_trace
from batchai_retinanet_horovod_coco_tpu_torch.obs import watchdog as t_watchdog
from batchai_retinanet_horovod_coco_tpu_torch.serve import common as t_common
from batchai_retinanet_horovod_coco_tpu_torch.serve import fleet as t_fleet
from batchai_retinanet_horovod_coco_tpu_torch.serve import frontend as t_frontend
from batchai_retinanet_horovod_coco_tpu_torch.serve import replica as t_replica
from batchai_retinanet_horovod_coco_tpu_torch.serve import stream as t_stream
from batchai_retinanet_horovod_coco_tpu_torch.serve import stub as t_stub
from batchai_retinanet_horovod_coco_tpu_torch.serve.engine import DetectEngine
from batchai_retinanet_horovod_coco_tpu_torch.utils import backoff as t_backoff

JAX = SimpleNamespace(common=j_common, fleet=j_fleet, frontend=j_frontend, replica=j_replica,
                      stream=j_stream, stub=j_stub, backoff=j_backoff, telemetry=j_telemetry)
PORT = SimpleNamespace(common=t_common, fleet=t_fleet, frontend=t_frontend, replica=t_replica,
                       stream=t_stream, stub=t_stub, backoff=t_backoff, telemetry=t_telemetry)


def live_threads() -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(("serve", "fleet"))]


@pytest.fixture(autouse=True)
def clean_obs():
    """Each test starts and ends with both packages' obs layers off, and
    leaves no serve or fleet thread behind."""
    for mod in (t_trace, j_trace, t_telemetry, j_telemetry):
        mod.reset()
    j_telemetry._stream_metrics = None  # the JAX reset() keeps its stream handles
    yield
    for mod in (t_trace, j_trace, t_telemetry, j_telemetry):
        mod.reset()
    j_telemetry._stream_metrics = None
    for wd in (t_watchdog, j_watchdog):
        wd.stop()
        wd.default().sink = None
    deadline = time.time() + 10
    while live_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not live_threads()


# ---- track stitching -------------------------------------------------------


def quarter(rng, lo, hi, size=None) -> np.ndarray:
    return rng.integers(int(lo * 4), int(hi * 4), size) / 4.0


def detection_sequence(seed: int, frames: int = 12) -> list[list[dict]]:
    """Three or four objects that drift, are missed, come back and change
    class, with boxes on a ¼-pixel grid; some frames hold exact duplicates
    (greedy ties).  Few distinct (tracks, detections) shapes: the JAX
    stitcher's eager IoU compiles once a shape."""
    rng = np.random.default_rng(seed)
    objects = [[*quarter(rng, 0, 100, 2), *quarter(rng, 4, 40, 2), int(rng.integers(0, 2))]
               for _ in range(int(rng.integers(3, 5)))]
    out = []
    for _ in range(frames):
        dets = []
        for obj in objects:
            obj[0] += quarter(rng, -4, 4)
            obj[1] += quarter(rng, -4, 4)
            if rng.random() < 0.1:
                obj[4] = 1 - obj[4]
            if rng.random() < 0.15:
                continue  # missed this frame
            dets.append({"category_id": obj[4], "bbox": [float(v) for v in obj[:4]],
                         "score": 0.5})
        if dets and rng.random() < 0.15:
            dets[-1] = dict(dets[0], bbox=list(dets[0]["bbox"]))
        out.append(dets)
    return out


def at_threshold_sequence() -> list[list[dict]]:
    """An IoU of exactly 0.3 (60 / 200: a 10 x 10 box against a 10 x 16 box
    over a 10 x 6 strip of it), then duplicates (a greedy tie) and two
    tracks on one box."""
    a = {"category_id": 0, "bbox": [0.0, 0.0, 10.0, 10.0], "score": 0.9}
    b = dict(a, bbox=[0.0, 4.0, 10.0, 16.0])
    return [[a], [b], [b, dict(b)], [dict(a, bbox=[0.0, 8.25, 10.0, 16.0])], [],
            [dict(a, bbox=[0.0, 4.25, 10.0, 16.0])]]


def stitched(stitcher_cls, frames, **kwargs) -> list[list[int]]:
    st = stitcher_cls(**kwargs)
    ids = []
    for dets in frames:
        dets = [dict(d, bbox=list(d["bbox"])) for d in dets]
        st.update(dets)
        ids.append([d["track_id"] for d in dets])
    return ids


@pytest.mark.parametrize("seed", range(4))
def test_track_ids_equal_jax(seed):
    frames = detection_sequence(seed)
    for kwargs in (dict(max_misses=1), dict(iou_threshold=0.1, max_misses=1)):
        got = stitched(t_stream.TrackStitcher, frames, **kwargs)
        assert got == stitched(j_stream.TrackStitcher, frames, **kwargs)
        assert got[0] == list(range(len(frames[0])))


def test_track_ids_at_the_threshold_equal_jax():
    frames = at_threshold_sequence()
    got = stitched(t_stream.TrackStitcher, frames, iou_threshold=0.3)
    assert got == stitched(j_stream.TrackStitcher, frames, iou_threshold=0.3)
    assert got[1] == [0]  # IoU exactly 0.3 continues the track
    assert got[2] == [0, 1]  # the first of two equal boxes takes it


# ---- sessions over the stub video engine -----------------------------------


def stub_server(pkg, video=True, rid="r0", batch_sizes=(4,)):
    engine = pkg.stub.StubDetectEngine(batch_sizes=batch_sizes, video=video)
    return pkg.frontend.DetectionServer(
        engine, pkg.common.ServeConfig(max_delay_ms=2, preprocess_workers=1), replica_id=rid,
    )


def stream_run(pkg, frames) -> list:
    """Every frame submitted to one session at once (the hit or miss is
    decided at admission, against the last dispatched frame); returns
    (cache_hit, detections) a frame in delivery order, and the manager's
    and the session's counters."""
    server = stub_server(pkg)
    manager = pkg.stream.StreamManager(server, pkg.common.StreamConfig(max_inflight=64))
    out = []
    try:
        sid = manager.open_stream(width=64, height=64)["session"]
        futures = [manager.submit_frame(sid, seq, frame, timeout_s=30)
                   for seq, frame in enumerate(frames)]
        out += [(fut.cache_hit, fut.result(timeout=30)) for fut in futures]
        status = manager.status()
        out.append({k: status[k] for k in ("sessions_open", "frames", "cache_hits",
                                           "cache_misses", "cache_bytes_saved", "reaped")})
        stats = manager.close_stream(sid)
        out.append({k: v for k, v in stats.items() if not k.endswith("_ms")})
    finally:
        manager.close()
        server.close()
    return out


@pytest.mark.parametrize("drift", [
    dict(seed=0, n=30, step=0.5), dict(seed=1, n=30, step=1.5, cut_every=9),
    dict(seed=2, n=20, step=1.0),
], ids=["slow drift", "cuts", "steady drift"])
def test_delta_cache_hits_the_jax_frames(drift):
    frames = t_stub.drift_frames(**drift)
    assert all((f == g).all() for f, g in zip(frames, j_stub.drift_frames(**drift)))
    got, want = stream_run(PORT, frames), stream_run(JAX, frames)
    assert got == want
    hits = [hit for hit, _ in want[:-2]]
    assert any(hits) and not all(hits)


def test_cache_off_stream_is_the_single_image_path_on_a_port_model():
    """``delta_threshold=0``: every frame rides the device, and its answer
    without ``track_id`` is the single-image answer for the same image on
    a ``resnet_test`` port model on the CPU (each request alone in its
    batch on both paths)."""
    model = t_retinanet.build_retinanet(t_retinanet.RetinaNetConfig(
        num_classes=3, backbone="resnet_test", fpn_channels=16, head_width=16, head_depth=1,
        dtype=torch.float32), device="cpu", seed=0)
    engine = DetectEngine.from_state(
        model, ((64, 96), (96, 64)), (2,),
        t_detect.DetectConfig(score_threshold=0.001, pre_nms_size=100, max_detections=50),
        device="cpu", min_side=64, max_side=96,
    )
    server = t_frontend.DetectionServer(engine, t_common.ServeConfig(max_delay_ms=1))
    manager = t_stream.StreamManager(server, t_common.StreamConfig(delta_threshold=0.0))
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (120, 180, 3), dtype=np.uint8)
    frames = [np.clip(base.astype(np.int16) + 3 * k, 0, 255).astype(np.uint8) for k in range(5)]
    try:
        sid = manager.open_stream(width=180, height=120)["session"]
        streamed = []
        for seq, frame in enumerate(frames):
            fut = manager.submit_frame(sid, seq, frame, timeout_s=60)
            streamed.append((fut.cache_hit, fut.result(timeout=60)))
        single = [server.detect(frame, timeout_s=60) for frame in frames]
        manager.close_stream(sid)
    finally:
        manager.close()
        server.close()
    assert all(not hit for hit, _ in streamed)
    assert all(single) and all("track_id" in d for _, dets in streamed for d in dets)
    stripped = [[{k: v for k, v in d.items() if k != "track_id"} for d in dets]
                for _, dets in streamed]
    assert stripped == single


def test_session_contract_as_jax():
    """Out of order, backlogged, unknown and closed sessions, and the
    session cap, reject with the JAX reasons; an idle session is reaped
    on the injectable clock."""
    def run(pkg):
        clock = [100.0]
        server = stub_server(pkg, batch_sizes=(1,))
        manager = pkg.stream.StreamManager(
            server, pkg.common.StreamConfig(max_streams=2, idle_timeout_s=5.0),
            now_fn=lambda: clock[0],
        )
        out = []

        def attempt(fn, *args):
            try:
                res = fn(*args)
                out.append(("ok", res.result(timeout=30) if hasattr(res, "result") else sorted(res)))
            except pkg.common.RequestRejected as exc:
                out.append(("rejected", exc.reason))

        frame = np.full((64, 64, 3), 40, np.uint8)
        try:
            sid = manager.open_stream()["session"]
            attempt(manager.submit_frame, sid, 1, frame)  # out of order
            attempt(manager.submit_frame, sid, 0, frame)
            attempt(manager.submit_frame, sid, 1, b"not an image")  # decode error
            attempt(manager.submit_frame, "nope", 0, frame)
            other = manager.open_stream()["session"]
            attempt(manager.open_stream)  # over the cap
            attempt(manager.close_stream, other)
            attempt(manager.submit_frame, other, 0, frame)  # closed
            clock[0] += 6.0
            manager.reap_idle()  # or the delivery thread's own sweep first
            attempt(manager.submit_frame, sid, 2, frame)  # reaped
            out.append(manager.status()["reaped"])
        finally:
            manager.close()
            server.close()
        return out

    got, want = run(PORT), run(JAX)
    assert got == want
    assert [o[1] for o in want if isinstance(o, tuple) and o[0] == "rejected"] == [
        "stream_out_of_order", "decode_error", "unknown_stream", "stream_limit",
        "unknown_stream", "unknown_stream"]


# ---- /stream* over HTTP ----------------------------------------------------


def png(frame: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "PNG")
    return buf.getvalue()


def http_stream(pkg) -> dict:
    """The /stream* routes of ``serve_http`` over the package's stub video
    server: status codes and bodies, session ids and latencies left out."""
    server = stub_server(pkg)
    httpd = pkg.frontend.serve_http(server, "127.0.0.1", 0)
    # watchdog: serve_forever returns at httpd.shutdown() in the finally below.
    threading.Thread(target=httpd.serve_forever, daemon=True, name="test-stream-http").start()
    url = "http://%s:%d" % httpd.server_address[:2]
    sessions: dict[str, str] = {}

    def call(path, body=None, headers=None):
        req = urllib.request.Request(url + path, data=body, headers=headers or {},
                                     method="POST" if body is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                code, data = r.status, json.load(r)
        except urllib.error.HTTPError as e:
            code, data = e.code, json.load(e)
        return code, json.loads(json.dumps(data, sort_keys=True).replace(
            *next(iter(sessions.items()), ("\0", "\0"))))

    def drop_clocks(data):
        if isinstance(data, (tuple, list)):
            return type(data)(drop_clocks(v) for v in data)
        if isinstance(data, dict):
            return {k: drop_clocks(v) for k, v in data.items() if not k.endswith("_ms")}
        return data

    frames = t_stub.drift_frames(seed=3, n=8, step=1.5, cut_every=5)
    out = {}
    try:
        code, opened = call("/stream/open", json.dumps({"width": 64, "height": 64}).encode(),
                            {"X-Retinanet-Trace": "open-1"})
        sessions[opened["session"]] = "SESSION"
        out["open"] = code, {k: v for k, v in opened.items() if k != "session"}
        for seq, frame in enumerate(frames):
            out[f"frame {seq}"] = call("/stream/frame", png(frame), {
                "X-Retinanet-Stream": opened["session"], "X-Retinanet-Frame": str(seq),
                "X-Retinanet-Trace": f"f-{seq}"})
        head = {"X-Retinanet-Stream": opened["session"], "X-Retinanet-Trace": "e"}
        out["out of order"] = call("/stream/frame", png(frames[0]),
                                   {**head, "X-Retinanet-Frame": "3"})
        out["malformed"] = call("/stream/frame", png(frames[0]),
                                {**head, "X-Retinanet-Frame": "x"})
        out["bad image"] = call("/stream/frame", b"garbage", {**head, "X-Retinanet-Frame": "8"})
        out["deadline"] = call("/stream/frame", png(frames[0]),
                               {**head, "X-Retinanet-Frame": "9", "X-Retinanet-Deadline-Ms": "60000"})
        out["unknown"] = call("/stream/frame", png(frames[0]), {
            "X-Retinanet-Stream": "nope", "X-Retinanet-Frame": "0", "X-Retinanet-Trace": "u"})
        out["status"] = drop_clocks(call("/stream"))
        out["close"] = drop_clocks(call("/stream/close", b"", head))
        out["closed"] = call("/stream/frame", png(frames[0]), {**head, "X-Retinanet-Frame": "10"})
        out["nowhere"] = call("/stream/nowhere", b"", head)
    finally:
        httpd.shutdown()
        httpd.server_close()  # closes the stream manager too
        server.close()
    return out


def test_stream_routes_answer_as_jax_serve_http():
    got, want = http_stream(PORT), http_stream(JAX)
    assert got == want
    assert want["open"] == (200, {"bucket": [64, 64], "trace_id": "open-1"})
    assert [want[k][0] for k in ("out of order", "malformed", "bad image", "unknown", "closed",
                                 "nowhere")] == [400, 400, 400, 404, 404, 404]
    hits = [want[f"frame {seq}"][1]["cache_hit"] for seq in range(8)]
    assert any(hits) and not all(hits)


# ---- streams through the fleet ---------------------------------------------


class SinkSpy:
    def __init__(self):
        self.events: list[tuple[str, dict]] = []

    def event(self, kind: str, **fields):
        self.events.append((kind, fields))


def fleet_stream(pkg) -> dict:
    """A stream pinned by the fleet over two stub video replicas; its
    replica dies after frame 5 and the stream re-pins."""
    sink = SinkSpy()
    servers = [stub_server(pkg, rid=f"r{k}") for k in range(2)]
    router = pkg.fleet.FleetRouter(
        [pkg.replica.LocalReplica(s) for s in servers],
        pkg.fleet.FleetConfig(probe_backoff=pkg.backoff.BackoffPolicy(
            max_tries=1_000_000, base_s=1.0, multiplier=2.0, ceiling_s=8.0), seed=5),
        sink=sink, auto_poll=False,
    )
    frames = t_stub.drift_frames(seed=4, n=12, step=2.5)
    out: dict = {"frames": []}
    try:
        opened = router.stream_open(width=64, height=64)
        sid = opened["session"]
        out["pinned"] = opened["replica_id"]
        for seq, frame in enumerate(frames):
            if seq == 6:
                next(s for s in servers if s.replica_id == opened["replica_id"]).close()
                router.poll_once(now=100.0)
            out["frames"].append(router.stream_frame(sid, seq, frame))
        try:
            router.stream_frame(sid, 3, frames[0])
        except pkg.common.RequestRejected as exc:
            out["out of order"] = exc.reason
        out["close"] = {k: v for k, v in router.stream_close(sid).items() if not k.endswith("_ms")}
        status = router.status()
        out["status"] = {k: status[k] for k in ("streams_open", "stream_repins", "breaker_opens")}
        out["events"] = [(kind, {k: v for k, v in f.items() if k != "stream"})
                         for kind, f in sink.events]
    finally:
        router.close(close_replicas=True)
        for s in servers:
            s.close()
    return out


def test_fleet_stream_repins_as_jax():
    got, want = fleet_stream(PORT), fleet_stream(JAX)
    assert got == want
    assert len(want["frames"]) == 12 and all(dets for dets, _ in want["frames"])
    assert [k for k, _ in want["events"]].count("stream_repinned") == 1
    assert want["out of order"] == "stream_out_of_order"


def test_stream_series_are_byte_equal_to_jax():
    """The same ``record_stream_frame`` calls give the same exposition
    (the default registries' ``serve_stream_*`` families)."""
    texts = []
    for telemetry in (t_telemetry, j_telemetry):
        telemetry.enable()
        for hit, ms in ((False, 12.5), (True, 0.25), (True, 0.5), (False, float("nan"))):
            telemetry.record_stream_frame(cache_hit=hit, latency_ms=ms)
        texts.append("\n".join(line for line in telemetry.default().prometheus_text().splitlines()
                               if "serve_stream_" in line))
    assert texts[0] == texts[1]
    assert "serve_stream_cache_hits_total 2" in texts[0]
