"""The codec's formats beyond sequential JPEG and plain PNG, against PIL:
progressive JPEG (block-smoothed where its scans leave coefficients
incomplete), CMYK, YCCK and RGB-coded JPEG, interlaced and 16-bit PNG, and
BMP, RLE8 and RLE4 among them (``native/imagecodec.cpp`` and
``data/image_io.py``).

Tolerance: none.  Every image here decodes to PIL's pixels
(``np.asarray(Image.open(f).convert("RGB"))``, PIL 12.1 over libjpeg-turbo)
bit for bit, and ``read_size`` gives PIL's ``.size``.  The fixtures of
``tests/fixtures/formats/`` carry PIL's digests for machines without PIL;
``make_fixtures.py`` there writes them and holds the PNG, BMP, RLE and
cut-progressive builders used here.  What stays refused raises
``ValueError`` naming the file.
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

from batchai_retinanet_horovod_coco_tpu_torch.data import image_io

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "formats"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
_spec = importlib.util.spec_from_file_location("format_fixtures", FIXTURES / "make_fixtures.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)


def pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def assert_equals_pil(data: bytes, tmp_path: Path) -> None:
    path = tmp_path / "image"
    path.write_bytes(data)
    got = image_io.read_rgb(path)
    assert got.dtype == np.uint8 and np.array_equal(got, pil_rgb(data))
    with Image.open(path) as im:
        assert image_io.read_size(path) == im.size


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_equals_its_digest_and_pil(name):
    path = FIXTURES / name
    got = image_io.read_rgb(path)
    assert list(got.shape) == DIGESTS[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS[name]["sha256"]
    assert np.array_equal(got, pil_rgb(path.read_bytes()))
    assert list(image_io.read_size(path)) == DIGESTS[name]["size"]
    with Image.open(path) as im:
        assert image_io.read_size(path) == im.size


def test_fixtures_cover_the_cases():
    data = {n: (FIXTURES / n).read_bytes() for n in DIGESTS}
    progressive = [n for n, d in data.items() if b"\xff\xc2" in d]
    assert len(progressive) == 8 and DIGESTS["progressive_640x480.jpg"]["shape"] == [480, 640, 3]
    # Cut after scans 1, 3 and 6 of PIL's 10, so libjpeg block-smooths them.
    assert {n: data[n].count(b"\xff\xda") for n in progressive if "cut" in n} == {
        "progressive_cut1.jpg": 1, "progressive_cut3.jpg": 3, "progressive_cut6.jpg": 6}
    assert b"\xff\xdd" in data["progressive_restart.jpg"]  # DRI: a restart interval
    for name, transform in (("adobe_rgb.jpg", 0), ("cmyk.jpg", 0), ("ycck.jpg", 2)):
        adobe = data[name].index(b"Adobe")
        assert data[name][adobe + 11] == transform, name
    pngs = {n: struct.unpack(">IIBBBBB", d[16:29]) for n, d in data.items() if n.endswith(".png")}
    interlaced = {(ct, depth) for _, _, depth, ct, _, _, il in pngs.values() if il}
    assert interlaced == {(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2),
                          (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)}
    assert {ct for _, _, depth, ct, _, _, il in pngs.values() if depth == 16 and not il} == {0, 2, 4, 6}
    bmps = [n for n in data if n.endswith(".bmp")]
    assert {struct.unpack_from("<H", data[n], 28 if struct.unpack_from("<I", data[n], 14)[0] > 12
                               else 24)[0] for n in bmps} == {1, 4, 8, 16, 24, 32}
    rle = {n: struct.unpack_from("<I", data[n], 30)[0] for n in bmps if "rle" in n}
    assert sorted(rle.values()) == [1, 1, 2, 2] and all(DIGESTS[n]["shape"][1] % 2 for n in rle)
    assert all(b"\x00\x02" in data[n] for n in rle if "deltas" in n)  # delta escapes
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 150_000


def scene(seed: int, h: int, w: int) -> np.ndarray:
    return make.scene(seed, h, w).astype(np.uint8)


# (h, w, PIL options, mode): samplings, qualities, restart intervals,
# optimized tables, odd and tiny sizes, through PIL's progressive script.
PROGRESSIVE_CASES = [
    (480, 640, dict(quality=92, subsampling=2), "RGB"),
    (47, 33, dict(quality=75, subsampling=2), "RGB"),
    (31, 33, dict(quality=92, subsampling=1), "RGB"),
    (64, 64, dict(quality=92, subsampling=0), "RGB"),
    (17, 1, dict(quality=92, subsampling=2), "RGB"),
    (2, 3, dict(quality=92, subsampling=1), "RGB"),
    (40, 56, dict(quality=100, subsampling=2, optimize=True), "RGB"),
    (40, 56, dict(quality=92, subsampling=2, restart_marker_blocks=1), "RGB"),
    (40, 56, dict(quality=92, subsampling=2, restart_marker_rows=1), "RGB"),
    (40, 56, dict(quality=20, subsampling=2), "RGB"),
    (40, 56, dict(quality=92), "L"),
    (1, 9, dict(quality=50), "L"),
    (33, 47, dict(quality=90), "CMYK"),
    (16, 16, dict(quality=90, keep_rgb=True), "RGB"),
]


@pytest.mark.parametrize("h,w,options,mode", PROGRESSIVE_CASES)
def test_progressive_jpeg_equals_pil(h, w, options, mode, tmp_path):
    img = Image.fromarray(scene(h * 1000 + w, h, w)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, "JPEG", progressive=True, **options)
    assert b"\xff\xc2" in buf.getvalue()
    assert_equals_pil(buf.getvalue(), tmp_path)


@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
@pytest.mark.parametrize("transform", [0, 2], ids=["cmyk", "ycck"])
def test_four_component_jpeg_equals_pil(transform, progressive, tmp_path):
    """Random CMYK pixels; transform 2 is the same file read as YCCK."""
    rng = np.random.default_rng(transform * 10 + progressive)
    img = Image.fromarray(rng.integers(0, 256, (24, 40, 4), dtype=np.uint8), "CMYK")
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=95, progressive=progressive)
    data = bytearray(buf.getvalue())
    data[data.index(b"Adobe") + 11] = transform
    assert_equals_pil(bytes(data), tmp_path)
    if transform == 0 and not progressive:
        solid = io.BytesIO()
        Image.new("CMYK", (4, 4), (10, 20, 30, 40)).save(solid, "JPEG")
        assert image_io.decode(solid.getvalue())[0, 0].tolist() == [207, 198, 190]


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("color_type,depth", PNG_KINDS, ids=[f"type{c}-{d}bit" for c, d in PNG_KINDS])
def test_hand_built_interlaced_png_equals_pil(color_type, depth, tmp_path):
    """Adam7 over sizes whose passes are empty, one pixel wide or full."""
    top = (1 << depth) - 1
    rng = np.random.default_rng(color_type * 100 + depth)
    for h, w in ((1, 1), (1, 9), (9, 1), (5, 3), (8, 8), (17, 23)):
        samples = rng.integers(0, top + 1, (h, w, make.PNG_CHANNELS[color_type]))
        palette = rng.integers(0, 256, (top + 1, 3)) if color_type == 3 else None
        data = make.png(samples, depth, color_type, True, palette, seed=h * w)
        assert_equals_pil(data, tmp_path)


@pytest.mark.parametrize("color_type", [0, 2, 4, 6], ids=["grey", "rgb", "grey-alpha", "rgba"])
def test_hand_built_16bit_png_equals_pil(color_type, tmp_path):
    """PIL's semantics: 16-bit grey clips at 255 (I;16), the other types
    keep each sample's high byte."""
    values = np.array([0x0000, 0x00FF, 0x0100, 0x1234, 0xFF00, 0xFFFF])
    ch = make.PNG_CHANNELS[color_type]
    data = make.png(np.repeat(values[None, :, None], ch, 2), 16, color_type)
    want = [0, 255, 255, 255, 255, 255] if color_type == 0 else [0, 0, 1, 18, 255, 255]
    assert image_io.decode(data)[0, :, 0].tolist() == want
    assert_equals_pil(data, tmp_path)
    samples = np.random.default_rng(color_type).integers(0, 65536, (13, 29, ch))
    assert_equals_pil(make.png(samples, 16, color_type, seed=color_type), tmp_path)


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_bmp_palette_short_and_full_equals_pil(bits, tmp_path):
    """Palette files, bottom-up and top-down, with a palette shorter than
    the indices reach (those pixels are black, as PIL has them)."""
    rng = np.random.default_rng(bits)
    index = rng.integers(0, 1 << bits, (7, 13))
    rows = [bytes(np.packbits(np.unpackbits(r.astype(np.uint8)[:, None], axis=1)[:, 8 - bits:]))
            for r in index]
    palette = rng.integers(0, 256, (1 << bits, 3)).tolist()
    for pal in (palette, palette[: max(1, len(palette) // 2 - 1)]):
        for top_down in (False, True):
            assert_equals_pil(make.bmp(rows, 13, bits, pal, top_down=top_down), tmp_path)


# (h, w, PIL options, mode) of progressive files cut after each of their
# scans: 4:2:0 with an odd count of luma block rows (the smoothing reads a
# padding block row near the bottom), 4:2:2, 4:4:4, grey, CMYK, tiny and
# restart intervals.
CUT_CASES = [
    (120, 160, dict(quality=95, subsampling=2), "RGB"),
    (40, 56, dict(quality=92, subsampling=2), "RGB"),
    (24, 24, dict(quality=75, subsampling=2), "RGB"),
    (33, 47, dict(quality=90, subsampling=2), "RGB"),
    (17, 9, dict(quality=50, subsampling=1), "RGB"),
    (64, 64, dict(quality=92, subsampling=0), "RGB"),
    (8, 8, dict(quality=80, subsampling=2), "RGB"),
    (48, 40, dict(quality=30, subsampling=2, restart_marker_blocks=2), "RGB"),
    (40, 56, dict(quality=92), "L"),
    (41, 23, dict(quality=85), "L"),
    (33, 47, dict(quality=90), "CMYK"),
]


@pytest.mark.parametrize("h,w,options,mode", CUT_CASES)
def test_cut_progressive_jpeg_equals_pil(h, w, options, mode, tmp_path):
    """Every prefix of a progressive file's scans, with an EOI: libjpeg
    block-smooths what they leave incomplete, from the DC values of the 5x5
    blocks around each block, the DC too while no AC scan has come."""
    img = Image.fromarray(scene(h * 7 + w, h, w)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, "JPEG", progressive=True, **options)
    full = buf.getvalue()
    for scans in range(1, full.count(b"\xff\xda")):
        assert_equals_pil(make.cut_after_scan(full, scans), tmp_path)


def random_rle_stream(rng: np.random.Generator, width: int, rle4: bool) -> bytes:
    """Encoded and absolute runs (some past the row's end, some of an odd
    count), ends of line, deltas and perhaps an end of bitmap, at random."""
    out = bytearray()
    for _ in range(int(rng.integers(1, 30))):
        op = rng.integers(0, 10)
        if op < 5:
            out += bytes([int(rng.integers(1, 2 * width + 2)), int(rng.integers(0, 256))])
        elif op < 6:
            out += b"\x00\x00"
        elif op < 7:
            out += bytes([0, 2, int(rng.integers(0, 4)), int(rng.integers(0, 2))])
        elif op < 9:
            n = int(rng.integers(3, 2 * width + 3))
            body = rng.integers(0, 256, (n + 1) // 2 if rle4 else n).astype(np.uint8).tobytes()
            out += bytes([0, n]) + body + bytes(len(body) % 2)
        else:
            out += b"\x00\x01"
    if rng.integers(4):
        out += b"\x00\x01"
    return bytes(out)


@pytest.mark.parametrize("seed", range(6))
def test_random_rle_bmp_equals_pil(seed, tmp_path):
    """RLE streams at random: each decodes to PIL's pixels, or both PIL and
    the codec raise (a stream that ends before the image is full), the
    codec's ValueError naming the file."""
    rng = np.random.default_rng(seed)
    decoded = 0
    for _ in range(60):
        rle4 = bool(rng.integers(2))
        width, height = int(rng.integers(1, 12)), int(rng.integers(1, 8))
        palette = rng.integers(0, 256, (16 if rle4 else int(rng.integers(2, 257)), 3)).tolist()
        data = bytearray(make.bmp([b""] * height, width, 4 if rle4 else 8, palette,
                                  top_down=bool(rng.integers(5) == 0)))
        data += random_rle_stream(rng, width, rle4)
        struct.pack_into("<I", data, 30, 2 if rle4 else 1)
        data = bytes(data)
        try:
            want = pil_rgb(data)
        except (OSError, ValueError):
            want = None
        path = tmp_path / "random.bmp"
        path.write_bytes(data)
        if want is None:
            with pytest.raises(ValueError, match="RLE-compressed BMP") as info:
                image_io.read_rgb(path)
            assert str(path) in str(info.value)
            continue
        assert np.array_equal(image_io.read_rgb(path), want)
        decoded += 1
    assert decoded >= 20


def test_rle_bmp_skips_and_short_rows_are_index_0(tmp_path):
    """What a delta or an early end of line passes over is palette index 0,
    as PIL has it; a delta's offsets are the two bytes after the four the
    format defines; an encoded run is cut at the row's end."""
    palette = [(200, 10, 10), (10, 200, 10), (10, 10, 200), (90, 90, 90)]
    stream = bytes([3, 1, 0, 0, 2, 2, 0, 2, 9, 9, 1, 0, 1, 3, 0, 0, 7, 3, 0, 1])
    data = bytearray(make.bmp([b""] * 3, 5, 8, palette))
    data += stream
    struct.pack_into("<I", data, 30, 1)
    want = [[3, 3, 3, 3, 3], [2, 2, 0, 3, 0], [1, 1, 1, 0, 0]]  # top row first
    got = image_io.decode(bytes(data))
    assert np.array_equal(got, np.array(palette, np.uint8)[want])
    assert np.array_equal(got, pil_rgb(bytes(data)))


def jpeg_with_sof(marker: int, precision: int = 8) -> bytes:
    return b"\xff\xd8\xff" + bytes([marker]) + b"\x00\x0b" + bytes([precision]) + b"\x00\x10\x00\x10\x01\x01\x11\x00"


def pil_bytes(fmt: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(scene(3, 8, 8)).save(buf, fmt)
    return buf.getvalue()


REFUSED = {
    "arithmetic-jpeg": (lambda: jpeg_with_sof(0xC9), r"SOF9"),
    "lossless-jpeg": (lambda: jpeg_with_sof(0xC3), r"lossless JPEG \(SOF3\)"),
    "hierarchical-jpeg": (lambda: jpeg_with_sof(0xC5), r"SOF5"),
    "12-bit-jpeg": (lambda: jpeg_with_sof(0xC1, 12), r"12-bit JPEG samples"),
    "gif": (lambda: pil_bytes("GIF"), r"not a JPEG or PNG or BMP"),
    "tiff": (lambda: pil_bytes("TIFF"), r"not a JPEG or PNG or BMP"),
    "webp": (lambda: pil_bytes("WEBP"), r"not a JPEG or PNG or BMP"),
}


# Refused until the codec read these formats: each now decodes to PIL's
# pixels (``tests/test_torch_formats_more.py`` holds their variants).
NOW_DECODED = {"gif", "tiff", "webp"}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_what_stays_refused_raises_naming_the_file(kind, tmp_path):
    make_bytes, message = REFUSED[kind]
    path = tmp_path / f"{kind}.img"
    path.write_bytes(make_bytes())
    if kind in NOW_DECODED:
        assert np.array_equal(image_io.read_rgb(path), pil_rgb(path.read_bytes()))
        with Image.open(path) as im:
            assert image_io.read_size(path) == im.size
        return
    with pytest.raises(ValueError, match=message) as info:
        image_io.read_rgb(path)
    assert str(path) in str(info.value)
