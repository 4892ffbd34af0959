"""The port's file data path against the JAX package and PIL: the image
codec (``data/image_io.py`` over ``native/imagecodec.cpp``), the
transforms, ``load_example`` and ``build_pipeline``, the synthetic writer,
and the CSV and VOC readers.

Tolerances, each with what this file measured (on the CPU, PIL 12.1 with
libjpeg-turbo, cv2 5.0):
- JPEG decode against PIL: the bar is 1 grey level; measured 0 (bit-exact)
  on every JPEG here (the fixtures, the JAX package's synthetic files, and
  the encoder settings of ``JPEG_CASES``);
- PNG decode against PIL: bit-exact;
- the resize against cv2's: within 1 level (as ``tests/test_torch_serve.py``);
- ``warp_image`` against ``cv2.warpAffine``: at least 99% of the pixels
  within 1 level and mean |Δ| <= 0.5; measured: largest gap 1, on 0.014% of
  the pixels;
- ``apply_visual_effects`` against the cv2 path: within 1 level; measured 0;
- boxes, labels, masks, scales, ids, matrices: exact.
"""

import hashlib
import io
import json
import os
import struct
import sys
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from batchai_retinanet_horovod_coco_tpu.data import coco as j_coco
from batchai_retinanet_horovod_coco_tpu.data import csv as j_csv
from batchai_retinanet_horovod_coco_tpu.data import pascal_voc as j_voc
from batchai_retinanet_horovod_coco_tpu.data import pipeline as j_pipeline
from batchai_retinanet_horovod_coco_tpu.data import synthetic as j_synthetic
from batchai_retinanet_horovod_coco_tpu.data import transforms as j_transforms
from batchai_retinanet_horovod_coco_tpu_torch.data import coco as t_coco
from batchai_retinanet_horovod_coco_tpu_torch.data import csv as t_csv
from batchai_retinanet_horovod_coco_tpu_torch.data import image_io
from batchai_retinanet_horovod_coco_tpu_torch.data import pascal_voc as t_voc
from batchai_retinanet_horovod_coco_tpu_torch.data import pipeline as t_pipeline
from batchai_retinanet_horovod_coco_tpu_torch.data import synthetic as t_synthetic
from batchai_retinanet_horovod_coco_tpu_torch.data import transforms as t_transforms

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
BATCH_FIELDS = ("gt_boxes", "gt_labels", "gt_mask", "image_ids", "scales", "valid")


def pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return np.abs(a.astype(np.int16) - b.astype(np.int16))


def assert_warp_close(got: np.ndarray, want: np.ndarray) -> None:
    """The warp's tolerance: >= 99% of the pixels within 1, mean <= 0.5."""
    d = gap(got, want)
    assert (d <= 1).mean() >= 0.99 and d.mean() <= 0.5, (d.max(), (d > 1).mean(), d.mean())


# ---------------------------------------------------------------- codec


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_decodes_to_its_digest(name):
    """Each committed fixture, the progressive one included, decodes to the
    pixels PIL gave when it was written (its sha256 in digests.json) and to
    PIL's decode now, bit for bit."""
    path = FIXTURES / name
    got = image_io.read_rgb(path)
    assert list(got.shape) == DIGESTS[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS[name]["sha256"]
    assert int(gap(got, pil_rgb(path.read_bytes())).max()) == 0
    assert image_io.read_size(path) == Image.open(path).size


def test_fixtures_cover_the_cases():
    data = {n: (FIXTURES / n).read_bytes() for n in DIGESTS}
    assert b"\xff\xdd" in data["restart.jpg"]  # DRI: a restart interval
    assert b"\xff\xc2" in data["progressive.jpg"]
    sizes = {n: tuple(d["shape"]) for n, d in DIGESTS.items()}
    assert sum(s == (480, 640, 3) for s in sizes.values()) == 4
    assert sizes["odd_33x47.jpg"] == (33, 47, 3)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 300_000


def scene(seed: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    (xx + yy) * 255 // max(h + w - 2, 1)], -1).astype(np.float64)
    img += rng.normal(0, 12, img.shape)
    img[h // 4 : h // 2, w // 4 : w // 2] = [250, 10, 30]
    return np.clip(img, 0, 255).astype(np.uint8)


# (h, w, PIL options, grey): the samplings, qualities down to 16-bit
# quantization tables, restart intervals, optimized Huffman tables, and
# components one or two samples wide.
JPEG_CASES = [
    (480, 640, dict(quality=92, subsampling=2), False),
    (47, 33, dict(quality=75, subsampling=2), False),
    (31, 33, dict(quality=92, subsampling=1), False),
    (64, 64, dict(quality=92, subsampling=0), False),
    (17, 1, dict(quality=92, subsampling=2), False),
    (2, 3, dict(quality=92, subsampling=1), False),
    (100, 3, dict(quality=30, subsampling=2), False),
    (40, 56, dict(quality=100, subsampling=2, optimize=True), False),
    (40, 56, dict(quality=92, subsampling=2, restart_marker_blocks=1), False),
    (40, 56, dict(qtables=[[300] * 64, [400] * 64], subsampling=2), False),
    (40, 56, dict(quality=92), True),
    (1, 9, dict(quality=50), True),
]


@pytest.mark.parametrize("h,w,options,grey", JPEG_CASES)
def test_jpeg_equals_pil(h, w, options, grey):
    img = scene(h * 1000 + w, h, w)
    pil = Image.fromarray(img).convert("L") if grey else Image.fromarray(img)
    buf = io.BytesIO()
    pil.save(buf, "JPEG", **options)
    assert int(gap(image_io.decode(buf.getvalue()), pil_rgb(buf.getvalue())).max()) == 0


def test_jax_synthetic_jpegs_equal_pil(jax_dataset):
    root, ds = jax_dataset
    for record in ds.records:
        data = Path(ds.image_path(record)).read_bytes()
        assert int(gap(image_io.decode(data), pil_rgb(data)).max()) == 0


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "P4", "P1", "1"])
def test_png_equals_pil(mode, tmp_path):
    rng = np.random.default_rng(len(mode) * 7 + ord(mode[0]))
    im = Image.fromarray(rng.integers(0, 256, (29, 53, 4), dtype=np.uint8), "RGBA")
    if mode.startswith("P"):
        colors = {"P": 200, "P4": 16, "P1": 2}[mode]
        im = im.convert("RGB").quantize(colors=colors)
    else:
        im = im.convert(mode)
    for optimize in (False, True):  # PIL picks other filter types
        path = tmp_path / f"{mode}-{optimize}.png"
        im.save(path, "PNG", optimize=optimize)
        assert np.array_equal(image_io.read_rgb(path), pil_rgb(path.read_bytes()))
        assert image_io.read_size(path) == Image.open(path).size


def test_encode_png_round_trips():
    img = np.random.default_rng(3).integers(0, 256, (21, 34, 3), dtype=np.uint8)
    data = image_io.encode_png(img)
    assert np.array_equal(pil_rgb(data), img)
    assert np.array_equal(image_io.decode(data), img)


def png_bytes(depth: int, interlace: int) -> bytes:
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    raw = b"\x00" + b"\x00" * (3 * 4 * depth // 8)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 1, depth, 2, 0, 0, interlace))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


# The case the codec once refused and now decodes, to PIL's pixels.
NOW_DECODED = ("16-bit PNG",)
# The interlaced case's image data is one row of 4 pixels as a sequential
# file lays it out, too short for Adam7's passes: PIL refuses it as
# truncated, and so does the codec, which reads interlacing now.  The GIF
# case, refused as a format before the codec read GIF, ends after its
# screen descriptor: PIL finds no image in it, and neither does the codec.
NOW_TRUNCATED = {"interlaced": "truncated PNG image data", "not a JPEG or PNG": "GIF has no image"}


@pytest.mark.parametrize("data,message", [
    (png_bytes(16, 0), "16-bit PNG"),
    (png_bytes(8, 1), "interlaced"),
    (b"GIF89a" + b"\x00" * 32, "not a JPEG or PNG"),
    (image_io.encode_png(np.zeros((4, 4, 3), np.uint8))[:40], "truncated PNG"),
    (b"\xff\xd8\xff\xc9\x00\x0b\x08\x00\x10\x00\x10\x01\x01\x11\x00", r"SOF9"),
])
def test_unsupported_files_raise(data, message, tmp_path):
    """A GIF without an image, truncated PNGs and an arithmetic-coded JPEG
    raise, naming the file; the 16-bit PNG, refused before the codec read
    it, now decodes to PIL's pixels.  Interlaced PNGs that PIL decodes are
    in ``tests/test_torch_formats.py``, GIFs in ``test_torch_formats_more.py``."""
    path = tmp_path / "bad.img"
    path.write_bytes(data)
    if message in NOW_DECODED:
        assert np.array_equal(image_io.read_rgb(path), pil_rgb(data))
        assert image_io.read_size(path) == Image.open(path).size
        return
    if message in NOW_TRUNCATED:
        with pytest.raises((OSError, SyntaxError), match="truncated|cannot identify"):
            pil_rgb(data)
        message = NOW_TRUNCATED[message]
    with pytest.raises(ValueError, match=message) as info:
        image_io.read_rgb(path)
    assert str(path) in str(info.value)


def test_cmyk_jpeg_raises(tmp_path):
    """A CMYK JPEG, refused before, decodes as PIL does: inverted (Adobe)
    CMYK through PIL's cmyk2rgb."""
    path = tmp_path / "cmyk.jpg"
    Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(path, "JPEG")
    got = image_io.read_rgb(path)
    assert np.array_equal(got, pil_rgb(path.read_bytes()))
    assert got[0, 0].tolist() == [207, 198, 190]


# ----------------------------------------------------------- transforms


@pytest.mark.parametrize("seed", range(6))
def test_random_transform_equals_jax(seed):
    """Same draws: the matrix, the boxes and the labels equal JAX's; the
    warp and the jitter within their tolerances of its cv2 path."""
    rng = np.random.default_rng(100 + seed)
    h, w = int(rng.integers(20, 160)), int(rng.integers(20, 160))
    image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    xy = rng.uniform(0, min(h, w) / 2, (5, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, min(h, w) / 2, (5, 2))], 1).astype(np.float32)
    labels = np.arange(5, dtype=np.int32)
    j_cfg, t_cfg = j_transforms.TransformConfig(), t_transforms.TransformConfig()
    assert np.array_equal(
        j_transforms.random_transform_matrix(j_cfg, np.random.default_rng(seed), h, w),
        t_transforms.random_transform_matrix(t_cfg, np.random.default_rng(seed), h, w),
    )
    want = j_transforms.apply_random_transform(image, boxes, labels, j_cfg, np.random.default_rng(seed))
    got = t_transforms.apply_random_transform(image, boxes, labels, t_cfg, np.random.default_rng(seed))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert_warp_close(got[0], want[0])
    matrix = j_transforms.random_transform_matrix(j_cfg, np.random.default_rng(seed), h, w)
    warped = t_transforms.warp_image(image, matrix)
    assert_warp_close(warped, j_transforms.warp_image(image, matrix))
    assert int(gap(warped, j_transforms.warp_image(image, matrix)).max()) <= 1
    jitter = t_transforms.apply_visual_effects(image, t_cfg, np.random.default_rng(seed))
    assert int(gap(jitter, j_transforms.apply_visual_effects(image, j_cfg, np.random.default_rng(seed))).max()) <= 1


def test_warp_outside_the_image_is_zero():
    image = np.full((10, 12, 3), 200, np.uint8)
    shift = np.array([[1.0, 0.0, 30.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    assert not t_transforms.warp_image(image, shift).any()
    assert np.array_equal(t_transforms.warp_image(image, np.eye(3)), image)


# ------------------------------------------------------ pipeline, datasets


@pytest.fixture(scope="module")
def jax_dataset(tmp_path_factory):
    """A directory written by the JAX package's synthetic writer (JPEG q92):
    11 images of 48 x 80, read through the JAX package's CocoDataset."""
    root = str(tmp_path_factory.mktemp("jax_synthetic"))
    ann = j_synthetic.make_synthetic_coco(root, num_images=11, num_classes=3, image_size=(48, 80), seed=0)
    return root, j_coco.CocoDataset(ann, os.path.join(root, "train"))


def port_dataset(root: str) -> t_coco.CocoDataset:
    return t_coco.CocoDataset(os.path.join(root, "instances_train.json"), os.path.join(root, "train"))


COMMON = dict(batch_size=4, min_side=64, max_side=96, max_gt=8, seed=3, num_workers=3,
              buckets=((64, 96), (96, 64)))
MODES = {
    "train-flips": dict(train=True, kw=dict(hflip_prob=0.5)),
    "train-random-transform": dict(train=True, kw=dict(transform="yes")),
    "eval-padding-rows": dict(train=False, kw=dict(shuffle=False, hflip_prob=0.0)),
}


def configs(mode: str):
    kw = dict(MODES[mode]["kw"])
    j_kw, t_kw = dict(kw), dict(kw)
    if kw.get("transform"):
        j_kw["transform"], t_kw["transform"] = j_transforms.TransformConfig(), t_transforms.TransformConfig()
    return j_pipeline.PipelineConfig(**COMMON, **j_kw), t_pipeline.PipelineConfig(**COMMON, **t_kw)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_load_example_equals_jax(jax_dataset, mode):
    root, j_ds = jax_dataset
    t_ds = port_dataset(root)
    j_cfg, t_cfg = configs(mode)
    train = MODES[mode]["train"]
    for i, (jr, tr) in enumerate(zip(j_ds.records, t_ds.records)):
        bucket = j_pipeline.bucket_for_source(jr.height, jr.width, 64, 96, COMMON["buckets"])
        want = j_pipeline.load_example(j_ds, jr, j_cfg, j_pipeline.example_rng(j_cfg, train, 0, i), bucket)
        got = t_pipeline.load_example(t_ds, tr, t_cfg, t_pipeline.example_rng(t_cfg, train, 0, i), bucket)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)
        if t_cfg.transform is None:
            assert int(gap(got[0], want[0]).max()) <= 1
        else:
            assert_warp_close(got[0], want[0])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_build_pipeline_equals_jax(jax_dataset, mode):
    """The port's batches equal JAX's in order and in every field but the
    images, which agree within the resize's (and the warp's) tolerance."""
    root, j_ds = jax_dataset
    t_ds = port_dataset(root)
    j_cfg, t_cfg = configs(mode)
    train = MODES[mode]["train"]
    j_it = j_pipeline.build_pipeline(j_ds, j_cfg, train=train)
    t_it = t_pipeline.build_pipeline(t_ds, t_cfg, train=train)
    count = 0
    try:
        for want, got in zip(j_it, t_it):
            for field in BATCH_FIELDS:
                np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
            if t_cfg.transform is None:
                assert int(gap(got.images, want.images).max()) <= 1
            else:
                assert_warp_close(got.images, want.images)
            count += 1
            if count == 6:  # more than an epoch of training
                break
    finally:
        j_it.close()
        t_it.close()
    if train:
        assert count == 6
    else:
        assert count == 3 and not want.valid.all()  # 11 images: a short last batch
        assert t_it.stats.truncated_boxes == j_it.stats.truncated_boxes


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=False), dict(exclude_ids=(2, 5, 7)),
                                dict(batch_size=5), dict(batch_size=3, seed=9)])
def test_batch_plans_equal_jax(jax_dataset, kw):
    root, j_ds = jax_dataset
    t_ds = port_dataset(root)
    j_cfg = j_pipeline.PipelineConfig(**{**COMMON, **kw})
    t_cfg = t_pipeline.PipelineConfig(**{**COMMON, **kw})
    for train in (True, False):
        for epoch in (0, 1):
            assert list(t_pipeline.batch_plans(t_ds, t_cfg, train, epoch)) == list(
                j_pipeline.batch_plans(j_ds, j_cfg, train, epoch))
    assert t_pipeline.resolve_max_gt(None, t_ds) == j_pipeline.resolve_max_gt(None, j_ds)


def test_skip_batches_resumes_the_stream(jax_dataset):
    root, _ = jax_dataset
    t_ds = port_dataset(root)
    cfg = t_pipeline.PipelineConfig(**COMMON)
    full = t_pipeline.build_pipeline(t_ds, cfg)
    resumed = t_pipeline.build_pipeline(t_ds, t_pipeline.PipelineConfig(**COMMON, skip_batches=3))
    try:
        batches = [next(full) for _ in range(5)]
        for want in batches[3:]:
            got = next(resumed)
            np.testing.assert_array_equal(got.image_ids, want.image_ids)
            np.testing.assert_array_equal(got.images, want.images)
    finally:
        full.close()
        resumed.close()


def test_pipeline_threads_stress(jax_dataset):
    """More decode threads than cores and a short switch interval give the
    same batches as one thread; the producer is gone after close()."""
    root, _ = jax_dataset
    t_ds = port_dataset(root)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        runs = []
        for workers in (1, 2 * (os.cpu_count() or 4)):
            it = t_pipeline.build_pipeline(
                t_ds, t_pipeline.PipelineConfig(**{**COMMON, "num_workers": workers}))
            runs.append([next(it) for _ in range(8)])
            it.close()
            assert not it._thread.is_alive()
    finally:
        sys.setswitchinterval(interval)
    for a, b in zip(*runs):
        for field in ("images", *BATCH_FIELDS):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_pipeline_raises_a_decode_error(tmp_path, jax_dataset):
    root, _ = jax_dataset
    t_ds = port_dataset(root)
    t_ds.image_dir = str(tmp_path)  # no image there
    it = t_pipeline.build_pipeline(t_ds, t_pipeline.PipelineConfig(**COMMON), train=False)
    with pytest.raises(FileNotFoundError):
        next(it)
    it.close()
    assert not it._thread.is_alive()


def test_worker_processes_are_not_ported(jax_dataset):
    """The multiprocess producer, refused before, builds and gives the
    thread path's batches (``tests/test_torch_shm_pipeline.py`` holds it to
    its contract)."""
    root, _ = jax_dataset
    t_ds = port_dataset(root)
    cfg = t_pipeline.PipelineConfig(**COMMON)
    want = t_pipeline.build_pipeline(t_ds, cfg)
    got = t_pipeline.build_pipeline(t_ds, t_pipeline.PipelineConfig(**{**COMMON, "num_worker_procs": 1}))
    try:
        for _ in range(3):
            a, b = next(got), next(want)
            for field in ("images", *BATCH_FIELDS):
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    finally:
        got.close()
        want.close()
    assert all(p.exitcode is not None for p in got.processes)


def test_synthetic_writer_equals_jax(tmp_path, monkeypatch):
    """The same annotations as the JAX writer (file names .png for .jpg),
    and PNG files holding exactly the pixels it drew."""
    drawn = {}

    def capture(self, fp, *args, **kwargs):
        drawn[os.path.basename(str(fp))] = np.asarray(self).copy()

    monkeypatch.setattr(Image.Image, "save", capture)
    kw = dict(num_images=5, num_classes=4, image_size=(40, 72), max_objects=5, seed=4, split="val")
    want = json.loads(Path(j_synthetic.make_synthetic_coco(str(tmp_path / "jax"), **kw)).read_text())
    monkeypatch.undo()
    got_path = t_synthetic.make_synthetic_coco(str(tmp_path / "port"), **kw)
    got = json.loads(Path(got_path).read_text())
    for image in want["images"]:
        image["file_name"] = image["file_name"].replace(".jpg", ".png")
    assert got == want
    for image in got["images"]:
        pixels = image_io.read_rgb(tmp_path / "port" / "val" / image["file_name"])
        assert np.array_equal(pixels, drawn[image["file_name"].replace(".png", ".jpg")])


def records_equal(got, want) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.image_id, a.file_name, a.width, a.height) == (b.image_id, b.file_name, b.width, b.height)
        for field in ("boxes", "labels", "areas", "crowd_boxes", "crowd_labels", "crowd_areas"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
            assert getattr(a, field).dtype == getattr(b, field).dtype


def test_csv_reader_equals_jax(tmp_path):
    rng = np.random.default_rng(5)
    rows = []
    for i, (h, w, ext) in enumerate([(30, 41, "jpg"), (25, 19, "png"), (12, 60, "jpg")]):
        name = f"img{i}.{ext}"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(tmp_path / name)
        rows += [f"{name},1,2,{5 + i},{9 + i},{'cat' if i else 'dog'}", f"{name},0.5,1,3,4,dog"]
    rows.append("img1.png,,,,,")
    (tmp_path / "ann.csv").write_text("\n".join(rows) + "\n")
    (tmp_path / "classes.csv").write_text("dog,0\ncat,1\n")
    for keep_empty in (False, True):
        got = t_csv.CsvDataset(str(tmp_path / "ann.csv"), str(tmp_path / "classes.csv"), keep_empty=keep_empty)
        want = j_csv.CsvDataset(str(tmp_path / "ann.csv"), str(tmp_path / "classes.csv"), keep_empty=keep_empty)
        records_equal(got.records, want.records)
        assert got.class_names == want.class_names and got.label_to_cat_id == want.label_to_cat_id
    (tmp_path / "bad.csv").write_text("img0.jpg,1,2,0,9,dog\n")
    with pytest.raises(ValueError, match="line 1"):
        t_csv.CsvDataset(str(tmp_path / "bad.csv"), str(tmp_path / "classes.csv"))


def test_voc_reader_equals_jax(tmp_path):
    rng = np.random.default_rng(6)
    for d in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (tmp_path / d).mkdir(parents=True)
    ids = ["000001", "000002", "000003"]
    for i, vid in enumerate(ids):
        Image.fromarray(rng.integers(0, 256, (30 + i, 40 + 3 * i, 3), dtype=np.uint8)).save(
            tmp_path / "JPEGImages" / f"{vid}.jpg")
        size = "" if i == 1 else f"<size><width>{40 + 3 * i}</width><height>{30 + i}</height></size>"
        objects = "".join(
            f"<object><name>{name}</name><difficult>{diff}</difficult><bndbox><xmin>{2 + k}</xmin>"
            f"<ymin>3</ymin><xmax>{20 + k}</xmax><ymax>25</ymax></bndbox></object>"
            for k, (name, diff) in enumerate([("dog", 0), ("cat", 1), ("person", 0)][: 3 - i])
        )
        (tmp_path / "Annotations" / f"{vid}.xml").write_text(
            f"<annotation><filename>{vid}.jpg</filename>{size}{objects}</annotation>")
    (tmp_path / "ImageSets/Main/trainval.txt").write_text("\n".join(ids) + "\n")
    for kw in (dict(), dict(skip_difficult=True), dict(keep_empty=True, skip_difficult=True)):
        got = t_voc.PascalVocDataset(str(tmp_path), split="trainval", **kw)
        want = j_voc.PascalVocDataset(str(tmp_path), split="trainval", **kw)
        records_equal(got.records, want.records)


def test_read_size_reads_only_the_header(tmp_path):
    """A JPEG cut right after its frame header still has its size."""
    path = tmp_path / "a.jpg"
    Image.fromarray(np.zeros((37, 91, 3), np.uint8)).save(path)
    data = path.read_bytes()
    sof = data.index(b"\xff\xc0")
    (tmp_path / "cut.jpg").write_bytes(data[: sof + 9])
    assert image_io.read_size(tmp_path / "cut.jpg") == (91, 37)


def test_decode_runs_without_the_interpreter_lock():
    """Two threads decode side by side: the codec is a ctypes call, which
    releases the lock (a smoke test of the binding, not a timing)."""
    data = (FIXTURES / "coco_0.jpg").read_bytes()
    want = image_io.decode(data)
    out = []
    threads = [threading.Thread(target=lambda: out.append(image_io.decode(data))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(out) == 4 and all(np.array_equal(o, want) for o in out)


def test_corrupt_jpegs_raise_or_decode():
    """Flipped bytes and truncations of a JPEG (headers and entropy data)
    give a ValueError or an image of the header's size, never a crash."""
    data = bytearray((FIXTURES / "restart.jpg").read_bytes())
    rng = np.random.default_rng(11)
    cases = [bytes(data[:n]) for n in range(0, len(data), 97)]
    for _ in range(300):
        bad = bytearray(data)
        for pos in rng.integers(2, len(bad), int(rng.integers(1, 4))):
            bad[pos] = int(rng.integers(0, 256))
        cases.append(bytes(bad))
    decoded = 0
    for case in cases:
        try:
            image = image_io.decode(case, "corrupt.jpg")
        except ValueError as e:
            assert "corrupt.jpg" in str(e)
            continue
        assert image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3
        decoded += 1
    assert 0 < decoded < len(cases)


def test_huffman_table_with_too_many_codes_raises():
    """A DHT whose counts overflow the code space (three 1-bit codes)."""
    data = bytearray((FIXTURES / "odd_33x47.jpg").read_bytes())
    counts = data.index(b"\xff\xc4") + 5  # after the marker, length and class/id byte
    longest = max(range(1, 16), key=lambda i: data[counts + i])
    data[counts] += 3  # the symbol total stays, so the segment still parses
    data[counts + longest] -= 3
    with pytest.raises(ValueError, match="too many codes"):
        image_io.decode(bytes(data), "bad.jpg")
