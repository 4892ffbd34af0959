"""GIF, TIFF and WebP through the codec, against PIL
(``native/imagecodec.cpp`` and ``data/image_io.py``).

Tolerance: none.  Every image here decodes to PIL's pixels
(``np.asarray(Image.open(f).convert("RGB"))``, PIL 12.1 over libtiff 4.7
and libwebp 1.6) bit for bit, and ``read_size`` gives PIL's ``.size``.
The fixtures of ``tests/fixtures/formats_more/`` carry PIL's digests for
machines without PIL; ``make_fixtures.py`` there writes them and holds the
GIF, TIFF and WebP builders the seeded cases below use.  Served bytes
answer as the live engine answers their decoded pixels, and the codec's
pixels are the JAX server's ``decode_payload``'s.  What stays refused
(CCITT and old-style JPEG TIFF, a truncated GIF) raises ``ValueError``
naming the file.
"""

import hashlib
import importlib.util
import io
import json
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from batchai_retinanet_horovod_coco_tpu.serve.router import decode_payload
from batchai_retinanet_horovod_coco_tpu_torch.data import image_io
from batchai_retinanet_horovod_coco_tpu_torch.serve.common import ServeConfig
from batchai_retinanet_horovod_coco_tpu_torch.serve.frontend import DetectionServer

from test_torch_serve import expected, make_engine, model  # noqa: F401  (model is a fixture)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "formats_more"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
_spec = importlib.util.spec_from_file_location("format_more_fixtures", FIXTURES / "make_fixtures.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)


def pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def assert_equals_pil(data: bytes, tmp_path: Path, label: str = "") -> None:
    path = tmp_path / "image"
    path.write_bytes(data)
    got = image_io.read_rgb(path)
    want = pil_rgb(data)
    assert got.dtype == np.uint8 and got.shape == want.shape, label
    assert np.array_equal(got, want), label
    with Image.open(path) as im:
        assert image_io.read_size(path) == im.size, label


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_equals_its_digest_and_pil(name):
    path = FIXTURES / name
    got = image_io.read_rgb(path)
    assert list(got.shape) == DIGESTS[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS[name]["sha256"]
    assert np.array_equal(got, pil_rgb(path.read_bytes()))
    assert list(image_io.read_size(path)) == DIGESTS[name]["size"]


def tiff_tags(data: bytes) -> dict:
    order = "<" if data[:2] == b"II" else ">"
    (offset,) = struct.unpack_from(order + "I", data, 4)
    (count,) = struct.unpack_from(order + "H", data, offset)
    tags = {}
    for i in range(count):
        tag, kind, n, value = struct.unpack_from(order + "HHII", data, offset + 2 + 12 * i)
        if kind == 3 and n == 1:
            value = struct.unpack_from(order + "H", data, offset + 10 + 12 * i)[0]
        tags[tag] = value
    return tags


def test_fixtures_cover_the_variants():
    data = {n: (FIXTURES / n).read_bytes() for n in DIGESTS}
    gifs = {n: d for n, d in data.items() if n.endswith(".gif")}
    assert {d[:6] for d in gifs.values()} == {b"GIF87a", b"GIF89a"}
    assert DIGESTS["gif_small_frame.gif"]["size"] == [31, 23]
    assert DIGESTS["gif_frame_past_screen.gif"]["size"] == [35, 29]  # grown to hold the frame
    tiffs = {n: tiff_tags(d) for n, d in data.items() if n.endswith(".tif")}
    assert {d[:2] for n, d in data.items() if n in tiffs} == {b"II", b"MM"}
    assert {t.get(259, 1) for t in tiffs.values()} == {1, 5, 7, 8, 32773, 32946}
    assert {t[262] for t in tiffs.values()} == {0, 1, 2, 3, 5, 6}
    assert any(322 in t for t in tiffs.values()) and any(t.get(284) == 2 for t in tiffs.values())
    assert any(t.get(317) == 2 for t in tiffs.values()) and any(t.get(266) == 2 for t in tiffs.values())
    webps = {n: [k for k, _ in make.webp_chunks(d)] for n, d in data.items() if n.endswith(".webp")}
    kinds = {k for chunks in webps.values() for k in chunks}
    assert {b"VP8 ", b"VP8L", b"VP8X", b"ALPH", b"ANIM", b"ANMF", b"EXIF"} <= kinds
    for name in ("gif_640x480.gif", "tiff_640x480_lzw.tif", "webp_640x480.webp"):
        assert DIGESTS[name]["shape"] == [480, 640, 3]
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 250_000


@pytest.mark.parametrize("seed", range(8))
def test_random_gif_equals_pil(seed, tmp_path):
    """Sizes, palettes (global, local, both, grey ramp, none), interlacing,
    a frame inside or past a larger screen, transparency, clear codes."""
    rng = np.random.default_rng(seed)
    for case in range(8):
        h, w = (int(v) for v in rng.integers(1, 48, 2))
        colours = int(rng.integers(1, 257))
        index = rng.integers(0, colours, (h, w))
        if rng.random() < 0.5:
            index = (np.arange(h)[:, None] // 3 + np.arange(w)[None] // 5) % colours
        palette = rng.integers(0, 256, (int(rng.integers(1, 257)), 3))
        options = dict(interlace=bool(rng.random() < 0.4), clear_every=int(rng.choice([0, 0, 40, 300])))
        kind = rng.random()
        if kind < 0.3:
            options["palette"] = palette
        elif kind < 0.5:
            options["local_palette"] = palette
        elif kind < 0.6:
            options.update(palette=palette, local_palette=palette[::-1])
        elif kind < 0.7:
            options["palette"] = np.repeat(np.arange(256)[:, None], 3, 1)[: 2 ** int(rng.integers(1, 9))]
        if rng.random() < 0.4:
            options["screen"] = (w + int(rng.integers(0, 20)), h + int(rng.integers(0, 20)))
            options["at"] = (int(rng.integers(0, 10)), int(rng.integers(0, 10)))
        if rng.random() < 0.3:
            options["transparency"] = int(rng.integers(0, 256))
        if rng.random() < 0.2:
            options["version"] = b"GIF87a"
        assert_equals_pil(make.gif(index.astype(np.uint8), **options), tmp_path, f"{case} {options}")


# (photometric, bits, samples, extra samples): every PIL mode the codec reads.
TIFF_KINDS = [
    (0, 1, 1, ()), (1, 1, 1, ()), (0, 2, 1, ()), (1, 2, 1, ()), (0, 4, 1, ()), (1, 4, 1, ()),
    (0, 8, 1, ()), (1, 8, 1, ()), (1, 16, 1, ()), (1, 8, 2, (2,)),
    (2, 8, 3, ()), (2, 8, 4, ()), (2, 8, 4, (0,)), (2, 8, 4, (1,)), (2, 8, 4, (2,)), (2, 8, 5, (2, 0)),
    (2, 16, 3, ()), (2, 16, 4, ()), (2, 16, 4, (0,)), (2, 16, 4, (1,)), (2, 16, 4, (2,)),
    (3, 1, 1, ()), (3, 2, 1, ()), (3, 4, 1, ()), (3, 8, 1, ()), (3, 8, 2, (2,)),
    (5, 8, 4, ()), (5, 8, 5, (0,)), (5, 16, 4, ()),
]


@pytest.mark.parametrize("photometric,bits,spp,extra", TIFF_KINDS)
def test_random_tiff_equals_pil(photometric, bits, spp, extra, tmp_path):
    """Each mode through random layouts: byte order, compression (none,
    LZW, Deflate 8 and 32946, PackBits), predictor 2, strips (ragged) or
    tiles (edge tiles padded), planar configuration 2, fill order 2.  A
    layout PIL itself fails to read is skipped over."""
    rng = np.random.default_rng(TIFF_KINDS.index((photometric, bits, spp, extra)))
    compared = 0
    for case in range(12):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        top = (1 << bits) - 1
        samples = rng.integers(0, top + 1, (h, w, spp))
        if rng.random() < 0.5:
            samples = (np.arange(h)[:, None, None] * 7 + np.arange(w)[None, :, None] * 3
                       + np.arange(spp)) % (top + 1)
        if extra[:1] == (1,) and bits == 8:  # associated alpha: colour <= alpha
            samples[..., :3] = np.minimum(samples[..., :3], samples[..., 3:4])
        options = dict(order=str(rng.choice(["<", ">"])), extra=extra,
                       compression=int(rng.choice([1, 5, 8, 32946, 32773])))
        if bits >= 8 and rng.random() < 0.4:
            options["predictor"] = 2
        if spp > 1 and rng.random() < 0.3:
            options["planar"] = 2
        layout = rng.random()
        if layout < 0.3:
            options["tile"] = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
        elif layout < 0.7:
            options["rows_per_strip"] = int(rng.integers(1, h + 1))
        if rng.random() < 0.1:
            options["fill_order"] = 2
        if photometric == 3:
            options["colormap"] = rng.integers(0, 65536, 3 * (1 << bits)).tolist()
        data = make.tiff(samples.astype(np.uint16 if bits == 16 else np.uint8), photometric, bits, **options)
        try:
            pil_rgb(data)
        except (OSError, ValueError, SyntaxError):
            continue
        assert_equals_pil(data, tmp_path, f"{case} {h}x{w} {options}")
        compared += 1
    assert compared >= 4


@pytest.mark.parametrize("seed", range(4))
def test_random_jpeg_tiff_equals_pil(seed, tmp_path):
    """JPEG-compressed strips over a JPEGTables tag: grey, RGB (no colour
    conversion, as libtiff tells libjpeg) and YCbCr at 4:4:4, 4:2:2 and
    4:2:0 (libjpeg's conversion), strips of 8 rows up to the whole image."""
    rng = np.random.default_rng(100 + seed)
    for case in range(6):
        h, w = (int(v) for v in rng.integers(8, 60, 2))
        grey = rng.random() < 0.25
        img = make.scene(seed * 10 + case, h, w, 1 if grey else 3).astype(np.uint8)
        photometric = 1 if grey else int(rng.choice([2, 6]))
        sub = "4:4:4" if photometric == 2 else str(rng.choice(["4:4:4", "4:2:2", "4:2:0"]))
        rows = int(rng.choice([8, 16, 32, h]))
        tables, strips = None, []
        quality = int(rng.integers(30, 95))
        for y in range(0, h, rows):
            buf = io.BytesIO()
            options = {} if grey else dict(subsampling=sub, keep_rgb=photometric == 2)
            strip = img[y:y + rows, :, 0] if grey else img[y:y + rows]
            Image.fromarray(strip).save(buf, "JPEG", quality=quality, **options)
            t, s = make.jpeg_in_tiff(buf.getvalue())
            tables = tables or t
            strips.append(s)
        extra = {530: (3, [2 if sub != "4:4:4" else 1, 2 if sub == "4:2:0" else 1])} if photometric == 6 else {}
        data = make.tiff(img, photometric, compression=7, rows_per_strip=rows, jpeg=(tables, strips),
                         more_tags=extra)
        assert_equals_pil(data, tmp_path, f"{case} {photometric} {sub} {rows}")


def webp_scene(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * rng.uniform(0.5, 3)) % 256, (yy * rng.uniform(0.5, 3)) % 256,
                    ((xx + yy) * rng.uniform(0.5, 2)) % 256], -1)
    img += rng.normal(0, rng.uniform(0, 30), img.shape)
    for _ in range(3):
        x0, y0 = rng.integers(0, w), rng.integers(0, h)
        img[y0:y0 + h // 3, x0:x0 + w // 3] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("lossless", [False, True], ids=["vp8", "vp8l"])
@pytest.mark.parametrize("seed", range(4))
def test_random_webp_equals_pil(seed, lossless, tmp_path):
    """Sizes from 1 to 200, every quality and method PIL passes on; alpha
    (VP8X with ALPH for lossy files)."""
    rng = np.random.default_rng(200 + seed + 10 * lossless)
    for case in range(6):
        h, w = (int(v) for v in rng.integers(1, 200, 2))
        img = webp_scene(rng, h, w)
        mode = "RGB"
        if rng.random() < 0.3:
            img = np.concatenate([img, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], -1)
            mode = "RGBA"
        buf = io.BytesIO()
        Image.fromarray(img, mode).save(buf, "WEBP", lossless=lossless, quality=int(rng.integers(0, 101)),
                                        method=int(rng.integers(0, 7)))
        assert_equals_pil(buf.getvalue(), tmp_path, f"{case} {h}x{w} {mode}")


@pytest.mark.parametrize("seed", range(4))
def test_random_libwebp_settings_equal_pil(seed, tmp_path):
    """What PIL does not pass on to libwebp: the simple loop filter, its
    strength, sharpness, token partitions, segments."""
    rng = np.random.default_rng(300 + seed)
    for case in range(5):
        h, w = (int(v) for v in rng.integers(1, 160, 2))
        config = dict(filter_type=int(rng.integers(0, 2)), filter_sharpness=int(rng.integers(0, 8)),
                      filter_strength=int(rng.integers(0, 101)), partitions=int(rng.integers(0, 4)),
                      segments=int(rng.integers(1, 5)), sns_strength=int(rng.integers(0, 101)),
                      method=int(rng.integers(0, 7)))
        data = make.libwebp_encode(webp_scene(rng, h, w), float(rng.uniform(0, 100)), **config)
        assert_equals_pil(data, tmp_path, f"{case} {h}x{w} {config}")


@pytest.mark.parametrize("seed", range(3))
def test_random_animated_webp_equals_pil(seed, tmp_path):
    """An animation's first frame at an even offset inside a larger canvas,
    lossy or lossless: the rest of the canvas is black, as
    ``WebPAnimDecoder`` leaves it."""
    rng = np.random.default_rng(400 + seed)
    for case in range(4):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        buf = io.BytesIO()
        Image.fromarray(webp_scene(rng, h, w)).save(buf, "WEBP", lossless=bool(rng.random() < 0.5))
        x, y = 2 * int(rng.integers(0, 8)), 2 * int(rng.integers(0, 8))
        canvas = (x + w + int(rng.integers(0, 9)), y + h + int(rng.integers(0, 9)))
        assert_equals_pil(make.webp_animation(canvas, [(x, y, buf.getvalue())]), tmp_path, f"{case}")


PARITY = ["gif87a_global.gif", "gif_small_frame_transparent.gif", "tiff_rgb_lzw.tif",
          "tiff_ycbcr_jpeg_420.tif", "tiff_palette4_lzw.tif", "webp_lossy.webp",
          "webp_lossless_alpha.webp", "webp_animated_offset_frame.webp"]


@pytest.mark.parametrize("name", PARITY)
def test_decode_equals_jax_decode_payload(name):
    """The port's ``decode`` against the JAX server's ``decode_payload``
    (PIL) on the same bytes."""
    data = (FIXTURES / name).read_bytes()
    want = decode_payload(data)
    got = image_io.decode(data)
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)


def test_gif_tiff_and_webp_payloads_are_served(model):  # noqa: F811
    """A GIF, an LZW TIFF and a lossy WebP sent as bytes answer as the
    engine answers their decoded pixels."""
    engine = make_engine(model)
    with DetectionServer(engine, ServeConfig(max_delay_ms=10, preprocess_workers=1)) as server:
        for name in ("gif_local_interlaced.gif", "tiff_rgb_lzw.tif", "webp_lossy_odd_33x47.webp"):
            data = (FIXTURES / name).read_bytes()
            assert server.detect(data, timeout_s=60) == expected(model, engine, image_io.decode(data)), name


def tiff_with_compression(compression: int) -> bytes:
    """A bilevel TIFF whose compression tag names ``compression``."""
    return make.tiff(np.zeros((4, 8), np.uint8), 0, 1, more_tags={259: (3, [compression])})


STILL_REFUSED = {
    "ccitt-rle-tiff": (lambda: tiff_with_compression(2), r"CCITT RLE \(compression 2\)"),
    "ccitt-g3-tiff": (lambda: tiff_with_compression(3), r"CCITT Group 3 fax \(compression 3\)"),
    "ccitt-g4-tiff": (lambda: tiff_with_compression(4), r"CCITT Group 4 fax \(compression 4\)"),
    "old-jpeg-tiff": (lambda: tiff_with_compression(6), r"old-style JPEG \(compression 6\)"),
    "truncated-gif": (lambda: b"GIF89a" + bytes(32), r"GIF has no image"),
}


@pytest.mark.parametrize("kind", sorted(STILL_REFUSED))
def test_what_stays_refused_raises_naming_the_file(kind, tmp_path):
    """CCITT fax and old-style JPEG TIFFs stay refused (bilevel fax pages and
    a JPEG layout libtiff itself reads only with guesswork); the GIF that
    ends after its screen descriptor is refused by PIL too."""
    make_bytes, message = STILL_REFUSED[kind]
    path = tmp_path / f"{kind}.img"
    path.write_bytes(make_bytes())
    with pytest.raises(ValueError, match=message) as info:
        image_io.read_rgb(path)
    assert str(path) in str(info.value)
    if kind == "truncated-gif":
        with pytest.raises((OSError, SyntaxError, ValueError)):
            pil_rgb(path.read_bytes())


def test_pil_written_group4_tiff_is_refused(tmp_path):
    """Refused to decode, but sized as PIL sizes it."""
    buf = io.BytesIO()
    Image.fromarray(np.eye(16, 24, dtype=bool)).save(buf, "TIFF", compression="group4")
    path = tmp_path / "fax.tif"
    path.write_bytes(buf.getvalue())
    with pytest.raises(ValueError, match=r"CCITT Group 4 fax \(compression 4\) TIFF is not supported"):
        image_io.read_rgb(path)
    assert pil_rgb(buf.getvalue()).shape == (16, 24, 3)  # PIL decodes it
    with Image.open(path) as im:
        assert image_io.read_size(path) == im.size == (24, 16)
