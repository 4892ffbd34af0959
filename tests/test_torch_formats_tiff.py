"""The TIFFs the codec reads since CCITT, LZMA and Zstandard
(``native/imagecodec.cpp``, ``data/image_io.py``): CCITT RLE, Group 3 (1D,
2D, fill bits) and Group 4; LZMA (libtiff's xz stream, read by the standard
library's liblzma) and Zstandard (a frame decoder in the library); float
and signed grey samples; the eight orientations; YCbCr that is not
JPEG-compressed.

Tolerance: none.  Every image decodes to PIL's pixels
(``np.asarray(Image.open(f).convert("RGB"))``, PIL 12.1 over libtiff 4.7)
bit for bit, and ``read_size`` gives PIL's ``.size``.  The fixtures of
``tests/fixtures/formats_tiff/`` carry PIL's digests for machines without
PIL; seeded cases come from ``formats_more/make_fixtures.py``'s ``tiff``,
whose LZMA, Zstandard and fax data is libtiff's own.  What stays refused
(old-style JPEG, WebP-in-TIFF, which this PIL refuses too, a Zstandard
frame that needs a dictionary, an xz filter chain libtiff does not write,
an xz stream whose check fails, a Zstandard checksum that fails) raises
``ValueError`` naming the file.
"""

import hashlib
import importlib.util
import io
import json
import lzma
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from batchai_retinanet_horovod_coco_tpu_torch.data import image_io

from test_torch_formats_more import assert_equals_pil, pil_rgb, tiff_tags

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "formats_tiff"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
_spec = importlib.util.spec_from_file_location("formats_tiff_fixtures", FIXTURES / "make_fixtures.py")
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)
make = fixtures.more


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_equals_its_digest_and_pil(name):
    path = FIXTURES / name
    got = image_io.read_rgb(path)
    assert list(got.shape) == DIGESTS[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS[name]["sha256"]
    assert np.array_equal(got, pil_rgb(path.read_bytes()))
    assert list(image_io.read_size(path)) == DIGESTS[name]["size"]


def test_fixtures_cover_the_variants():
    tags = {n: tiff_tags((FIXTURES / n).read_bytes()) for n in DIGESTS}
    data = {n: (FIXTURES / n).read_bytes()[:2] for n in DIGESTS}
    for compression in (2, 3, 4, 34925, 50000):
        mine = [n for n, t in tags.items() if t.get(259) == compression]
        assert any(322 not in tags[n] for n in mine), compression  # strips
        assert any(322 in tags[n] or 274 in tags[n] for n in mine) or compression in (2, 3)
        assert {data[n] for n in mine} == {b"II", b"MM"} or compression == 3, compression
    assert any(322 in t for t in tags.values() if t.get(259) in (4, 34925, 50000))
    assert {t.get(274, 1) for t in tags.values()} == set(range(1, 9))
    assert {t.get(339, 1) for t in tags.values()} == {1, 2, 3}
    assert {t.get(317, 1) for t in tags.values()} == {1, 2, 3}
    assert {t.get(259, 1) for t in tags.values() if t.get(262) == 6} == {1, 5, 8, 32773, 34925, 50000}
    assert DIGESTS["tiff_640x480_ccitt_g4.tif"]["shape"] == DIGESTS["tiff_640x480_zstd.tif"]["shape"] == [480, 640, 3]
    assert DIGESTS["tiff_orientation6.tif"]["size"] == [11, 17]  # PIL swaps a 17 x 11 file's size
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 150_000


@pytest.mark.parametrize("seed", range(3))
def test_random_fax_equals_pil(seed, tmp_path):
    """Each CCITT coding over random pages, some with the width tag off by a
    few pixels (rows libtiff finishes in white or cuts)."""
    rng = np.random.default_rng(seed)
    for compression, t4options in ((2, 0), (3, 0), (3, 1), (3, 5), (4, 0)):
        h, w = int(rng.integers(1, 30)), int(rng.integers(1, 150))
        page = (rng.random((h, w)) < rng.choice([0.05, 0.5])).astype(np.uint8)
        for width in (w, w + int(rng.integers(-3, 4))):
            if width < 1:
                continue
            data = make.tiff(page, int(rng.integers(0, 2)), 1, order="<>"[seed % 2],
                             compression=compression, t4options=t4options,
                             fill_order=int(rng.integers(1, 3)), rows_per_strip=int(rng.integers(1, 12)),
                             more_tags={256: (4, [width])})
            assert_equals_pil(data, tmp_path, f"c{compression} t4 {t4options} {h}x{w} as {width}")


@pytest.mark.parametrize("compression", [34925, 50000])
@pytest.mark.parametrize("seed", range(2))
def test_random_lzma_and_zstd_equal_pil(compression, seed, tmp_path):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 60))
    smooth = make.scene(seed, h, w).astype(np.uint8)
    noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    name = {34925: "lzma", 50000: "zstd"}[compression]
    for img in (smooth, noise):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "TIFF", compression=name, tiffinfo={317: 2})
        assert_equals_pil(buf.getvalue(), tmp_path, f"{name} PIL")
        layout = {"tile": (16, 16)} if seed else {"rows_per_strip": 5}
        data = make.tiff(img, 2, order=">", compression=compression, predictor=2, **layout)
        assert_equals_pil(data, tmp_path, f"{name} built {layout}")


@pytest.mark.parametrize("kind", ["float32", "int16", "int32"])
@pytest.mark.parametrize("order", ["<", ">"])
def test_random_float_and_signed_grey_equal_pil(kind, order, tmp_path):
    """PIL's F -> L truncates within 0..255 (NaN and below 0 to 0); I clips.
    A big-endian file through libtiff reaches PIL's big-endian raw mode
    with libtiff's native (little-endian) samples: PIL reads them swapped."""
    rng = np.random.default_rng(len(kind) + ord(order))
    values = rng.normal(100, 120, (9, 13))
    values.flat[:4] = (0.5, 254.99, -0.0, 255.0)
    samples = values.astype(kind)
    bits, fmt = int(kind[-2:]), {"f": 3, "i": 2}[kind[0]]
    for compression in (1, 5, 8, 34925, 50000):
        for predictor in ((1, 2, 3) if kind == "float32" else (1, 2)):
            if compression == 1 and predictor != 1:
                continue
            data = make.tiff(samples, 1, bits, order=order, compression=compression, predictor=predictor,
                             sample_format=fmt, rows_per_strip=4)
            assert_equals_pil(data, tmp_path, f"{kind} {order} c{compression} p{predictor}")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_each_orientation_equals_pil(orientation, tmp_path):
    rgb = make.scene(orientation, 7, 12).astype(np.uint8)
    for compression in (1, 5, 50000):
        data = make.tiff(rgb, 2, compression=compression, rows_per_strip=3,
                         more_tags={274: (3, [orientation])})
        assert_equals_pil(data, tmp_path, f"orientation {orientation} c{compression}")
    ycc = make.tiff(rgb, 6, compression=8, subsampling=(2, 2), more_tags={274: (3, [orientation])})
    assert_equals_pil(ycc, tmp_path, f"YCbCr orientation {orientation}")


@pytest.mark.parametrize("subsampling", [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)])
def test_random_ycbcr_equals_pil(subsampling, tmp_path):
    """libtiff's RGBA interface: its conversion tables, a strip read to its
    rows times TIFFScanlineSize, the 4 x 4 tile skew."""
    rng = np.random.default_rng(sum(subsampling))
    for layout in ({"rows_per_strip": 5}, {"tile": (16, 16)}, {}):
        h, w = int(rng.integers(1, 30)), int(rng.integers(1, 40))
        ycc = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        more = {529: (5, [2990, 10000, 5870, 10000, 1140, 10000])} if layout else {}
        data = make.tiff(ycc, 6, compression=int(rng.choice([5, 8, 32773, 50000])),
                         subsampling=subsampling, more_tags=more, **layout)
        assert_equals_pil(data, tmp_path, f"{subsampling} {layout} {h}x{w}")
    raw = make.tiff(rng.integers(0, 256, (6, 9, 3), dtype=np.uint8), 6, rows_per_strip=2,
                    more_tags={530: (3, list(subsampling))})
    assert_equals_pil(raw, tmp_path, "uncompressed YCbCr")  # PIL's raw decoder, mode RGBX


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64, for a Zstandard frame's content checksum."""
    p1, p2, p3, p4, p5 = (11400714785074694791, 14029467366897019727, 1609587929392839161,
                          9650029242287828579, 2870177450012600261)
    mask = (1 << 64) - 1
    rotl = lambda x, r: ((x << r) | (x >> (64 - r))) & mask
    rnd = lambda acc, v: (rotl((acc + v * p2) & mask, 31) * p1) & mask
    n, pos = len(data), 0
    if n >= 32:
        v = [(seed + p1 + p2) & mask, (seed + p2) & mask, seed, (seed - p1) & mask]
        while pos + 32 <= n:
            v = [rnd(v[i], struct.unpack_from("<Q", data, pos + 8 * i)[0]) for i in range(4)]
            pos += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & mask
        for x in v:
            h = ((h ^ rnd(0, x)) * p1 + p4) & mask
    else:
        h = (seed + p5) & mask
    h = (h + n) & mask
    while pos + 8 <= n:
        h = (rotl(h ^ rnd(0, struct.unpack_from("<Q", data, pos)[0]), 27) * p1 + p4) & mask
        pos += 8
    if pos + 4 <= n:
        h = (rotl(h ^ (struct.unpack_from("<I", data, pos)[0] * p1 & mask), 23) * p2 + p3) & mask
        pos += 4
    for b in data[pos:]:
        h = (rotl(h ^ (b * p5 & mask), 11) * p1) & mask
    for shift, prime in ((33, p2), (29, p3)):
        h = ((h ^ (h >> shift)) * prime) & mask
    return h ^ (h >> 32)


def zstd_raw_frame(content: bytes, checksum: int | None = None, dictionary: int = 0) -> bytes:
    """A single-segment frame of one raw block: 1-byte content size, a
    4-byte dictionary id when given, the low 32 bits of XXH64 when asked."""
    desc = 0x20 | (0x04 if checksum is not None else 0) | (3 if dictionary else 0)
    head = struct.pack("<IB", 0xFD2FB528, desc) + (struct.pack("<I", dictionary) if dictionary else b"")
    block = struct.pack("<I", 1 | (len(content) << 3))[:3] + content
    tail = struct.pack("<I", checksum & 0xFFFFFFFF) if checksum is not None else b""
    return head + bytes([len(content)]) + block + tail


def strip_tiff(strip: bytes, compression: int, h: int, w: int) -> bytes:
    """An 8-bit grey TIFF of one strip that holds ``strip`` as stored."""
    return make.tiff(np.frombuffer(strip, np.uint8)[None], 1, more_tags={
        259: (3, [compression]), 256: (4, [w]), 257: (4, [h]), 278: (4, [h])})


def test_zstd_checksum_is_checked(tmp_path):
    assert xxh64(b"") == 0xEF46DB3751D8E999  # the reference's empty-input vector
    pixels = bytes(range(7, 7 + 48))
    good = strip_tiff(zstd_raw_frame(pixels, xxh64(pixels)), 50000, 6, 8)
    assert_equals_pil(good, tmp_path, "raw block with checksum")
    assert image_io.decode(good)[..., 0].tobytes() == pixels
    path = tmp_path / "bad_checksum.tif"
    path.write_bytes(strip_tiff(zstd_raw_frame(pixels, xxh64(pixels) ^ 1), 50000, 6, 8))
    with pytest.raises(ValueError, match="checksum mismatch") as info:
        image_io.read_rgb(path)
    assert str(path) in str(info.value)


def refused(kind: str) -> bytes:
    pixels = bytes(range(48))
    if kind == "old-jpeg":
        return make.tiff(np.zeros((4, 8, 3), np.uint8), 6, more_tags={259: (3, [6])})
    if kind == "webp":
        return make.tiff(np.zeros((4, 8, 3), np.uint8), 2, more_tags={259: (3, [50001])})
    if kind == "zstd-dictionary":
        return strip_tiff(zstd_raw_frame(pixels, dictionary=7), 50000, 6, 8)
    if kind == "xz-bcj-filter":
        xz = lzma.compress(pixels, lzma.FORMAT_XZ, filters=[{"id": lzma.FILTER_X86},
                                                            {"id": lzma.FILTER_LZMA2}])
        return strip_tiff(xz, 34925, 6, 8)
    if kind == "xz-bad-check":
        xz = bytearray(lzma.compress(pixels, lzma.FORMAT_XZ, check=lzma.CHECK_CRC64))
        xz[-40] ^= 0xFF  # inside the block's CRC64, before the index
        return strip_tiff(bytes(xz), 34925, 6, 8)
    raise KeyError(kind)


STILL_REFUSED = {
    "old-jpeg": r"old-style JPEG \(compression 6\)",
    "webp": r"WebP .*\(compression 50001\)",
    "zstd-dictionary": r"needs dictionary 7",
    "xz-bcj-filter": r"xz filter chain \['0x4', '0x21'\]",
    "xz-bad-check": r"corrupt LZMA data",
}


@pytest.mark.parametrize("kind", sorted(STILL_REFUSED))
def test_what_stays_refused_raises_naming_the_file(kind, tmp_path):
    path = tmp_path / f"{kind}.tif"
    path.write_bytes(refused(kind))
    with pytest.raises(ValueError, match=STILL_REFUSED[kind]) as info:
        image_io.read_rgb(path)
    assert str(path) in str(info.value)
    if kind == "webp":  # libtiff here has no WebP codec: PIL refuses it too
        with pytest.raises(OSError):
            pil_rgb(path.read_bytes())
