"""Writes the image-format fixtures of this folder and ``digests.json``,
from seeded scenes:

    python tests/fixtures/formats/make_fixtures.py

What PIL writes, it writes: progressive JPEGs (a 640x480 4:2:0 file, grey,
4:2:2, 33x47 and with a restart interval), a CMYK JPEG and an RGB-coded
one (``keep_rgb=True``, Adobe transform 0).  What PIL cannot write is built
here by hand: a YCCK JPEG (PIL's CMYK file with its Adobe transform byte
set to 2, which libjpeg then reads as YCCK), interlaced (Adam7) PNGs of
every colour type and depth, 16-bit PNGs of every colour type, and BMPs
(1-, 4- and 8-bit palette, 16-bit 5-5-5, 24- and 32-bit, bit fields 5-6-5,
5-5-5 and 32-bit with alpha, top-down and OS/2 headers).  The JSON holds
each file's PIL size and the shape and sha256 of its pixels as PIL decodes
them (``np.asarray(Image.open(f).convert("RGB"))``), for machines without
PIL.  ``png`` and ``bmp`` are the hand builders; the tests use them too.
"""

import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# Adam7's passes: first column and row, column and row step.
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def scene(seed: int, h: int, w: int, channels: int = 3, top: int = 255) -> np.ndarray:
    """A smooth gradient with a few flat rectangles and light noise, as
    integers in [0, top]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / np.array([max(h, 1), max(w, 1)])[:, None, None]
    c0, c1 = rng.uniform(0.15, 0.85, channels), rng.uniform(0.15, 0.85, channels)
    t = (0.6 * xx + 0.4 * yy)[..., None]
    img = c0 * (1 - t) + c1 * t
    for _ in range(3):
        x0, y0 = rng.uniform(0, 0.7, 2)
        inside = (xx >= x0) & (xx < x0 + 0.3) & (yy >= y0) & (yy < y0 + 0.3)
        img[inside] = rng.uniform(0, 1, channels)
    img += rng.normal(0, 0.01, img.shape)
    return np.clip(np.round(img * top), 0, top).astype(np.int64)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _pack_row(samples: np.ndarray, depth: int) -> np.ndarray:
    if depth == 16:
        return np.frombuffer(samples.astype(">u2").tobytes(), np.uint8)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = np.unpackbits(samples.astype(np.uint8)[:, None], axis=1)[:, 8 - depth:].reshape(-1)
    return np.packbits(bits)


def png(samples: np.ndarray, depth: int, color_type: int, interlace: bool = False,
        palette: np.ndarray | None = None, seed: int = 0) -> bytes:
    """A PNG of ``samples`` ((H, W, channels) integers of ``depth`` bits),
    sequential or Adam7, each row under a filter type (0-4) drawn from
    ``seed``."""
    rng = np.random.default_rng(seed)
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    out = bytearray()
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue  # an empty pass has no rows
        prev = np.zeros(len(_pack_row(sub[0].reshape(-1), depth)), np.int32)
        for row in sub:
            raw = _pack_row(row.reshape(-1), depth).astype(np.int32)
            left = np.concatenate([np.zeros(bpp, np.int32), raw[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
            ftype = int(rng.integers(0, 5))
            pred = [0 * raw, left, prev, (left + prev) >> 1, _paeth(left, prev, upleft)][ftype]
            out += bytes([ftype]) + ((raw - pred) & 255).astype(np.uint8).tobytes()
            prev = raw
    data = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, int(interlace)))
    if palette is not None:
        data += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return data + _chunk(b"IDAT", zlib.compress(bytes(out), 9)) + _chunk(b"IEND", b"")


def bmp(rows: list[bytes], width: int, bits: int, palette=None, header: int = 40,
        compression: int = 0, masks=(0, 0, 0, 0), top_down: bool = False) -> bytes:
    """A BMP of ``rows`` (top to bottom, unpadded); ``header`` 12 is the OS/2
    core header (BGR palette entries), 40 BITMAPINFOHEADER (bit fields after
    it), 108 and 124 the V4 and V5 headers (bit fields inside)."""
    height = len(rows)
    stride = ((width * bits + 31) >> 3) & ~3
    padded = [r + bytes(stride - len(r)) for r in rows]
    pixels = b"".join(padded if top_down else padded[::-1])
    entry = 3 if header == 12 else 4
    table = b"".join(bytes([b, g, r]) + bytes(entry - 3) for r, g, b in (palette if palette is not None else ()))
    extra = b""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        colors = 0 if palette is None else len(palette)
        info = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1, bits,
                           compression, len(pixels), 2835, 2835, colors, 0)
        if header > 40:
            info += struct.pack("<4I", *masks) + bytes(header - 56)
        elif compression == 3:
            extra = struct.pack("<3I", *masks[:3])
    offset = 14 + len(info) + len(extra) + len(table)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + extra + table
            + pixels)


def _jpegs():
    from PIL import Image

    def save(img, **options):
        buf = io.BytesIO()
        img.save(buf, "JPEG", **options)
        return buf.getvalue()

    rgb = lambda seed, h, w: Image.fromarray(scene(seed, h, w).astype(np.uint8))  # noqa: E731
    cmyk = save(rgb(16, 48, 64).convert("CMYK"), quality=90)
    adobe = cmyk.index(b"Adobe") + 11  # the APP14 transform byte
    yield "progressive_640x480.jpg", save(rgb(10, 480, 640), quality=92, subsampling=2, progressive=True)
    yield "progressive_grey.jpg", save(rgb(11, 120, 160).convert("L"), quality=92, progressive=True)
    yield "progressive_422.jpg", save(rgb(12, 120, 160), quality=92, subsampling=1, progressive=True)
    yield "progressive_33x47.jpg", save(rgb(13, 33, 47), quality=90, subsampling=2, progressive=True)
    yield "progressive_restart.jpg", save(rgb(14, 72, 96), quality=90, subsampling=2, progressive=True,
                                          restart_marker_blocks=3)
    yield "adobe_rgb.jpg", save(rgb(15, 48, 64), quality=90, keep_rgb=True)
    yield "cmyk.jpg", cmyk
    yield "ycck.jpg", cmyk[:adobe] + b"\x02" + cmyk[adobe + 1:]


def _pngs():
    seed = 20
    for color_type, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)),
                               (4, (8, 16)), (6, (8, 16))):
        for depth in depths:
            for interlace in (True, False) if depth == 16 else (True,):
                seed += 1
                top = (1 << depth) - 1
                palette = None
                if color_type == 3:
                    palette = np.random.default_rng(seed).integers(0, 256, (top + 1, 3))
                samples = scene(seed, 17, 23, PNG_CHANNELS[color_type], top)
                kind = "interlaced" if interlace else "sequential"
                yield f"png_{kind}_type{color_type}_{depth}bit.png", png(
                    samples, depth, color_type, interlace, palette, seed)


def _bmps():
    h, w = 11, 27
    rng = np.random.default_rng(30)
    img = scene(31, h, w).astype(np.uint8)
    bgr = [bytes(r[:, ::-1].reshape(-1)) for r in img]
    bgrx = [bytes(np.concatenate([r[:, ::-1], np.full((w, 1), 255, np.uint8)], 1).reshape(-1)) for r in img]
    for bits in (1, 4, 8):
        palette = rng.integers(0, 256, (1 << bits, 3)).tolist()
        index = scene(32 + bits, h, w, 1, (1 << bits) - 1)[..., 0]
        packed = [bytes(np.packbits(np.unpackbits(r.astype(np.uint8)[:, None], axis=1)[:, 8 - bits:]))
                  for r in index]
        yield f"bmp_palette_{bits}bit.bmp", bmp(packed, w, bits, palette)
        if bits == 8:
            yield "bmp_palette_8bit_top_down.bmp", bmp(packed, w, bits, palette, top_down=True)
            yield "bmp_palette_8bit_os2.bmp", bmp(packed, w, bits, palette, header=12)
    yield "bmp_24bit.bmp", bmp(bgr, w, 24)
    yield "bmp_24bit_top_down.bmp", bmp(bgr, w, 24, top_down=True)
    yield "bmp_32bit.bmp", bmp(bgrx, w, 32)
    yield "bmp_32bit_bitfields_alpha_v5.bmp", bmp(bgrx, w, 32, header=124, compression=3,
                                                  masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    # Every value of each 5-6-5 field: 64 pixels, field values i % 32,
    # i % 64 and 31 - i % 32.
    i = np.arange(64)
    every = ((i % 32) << 11 | (i % 64) << 5 | (31 - i % 32)).astype("<u2").reshape(4, 16)
    yield "bmp_16bit_565_bitfields.bmp", bmp([bytes(r.tobytes()) for r in every], 16, 16,
                                             compression=3, masks=(0xF800, 0x7E0, 0x1F, 0))
    small = [bytes(r.tobytes()) for r in rng.integers(0, 65536, (h, w)).astype("<u2")]
    yield "bmp_16bit_555.bmp", bmp(small, w, 16)
    yield "bmp_16bit_555_bitfields_v4.bmp", bmp(small, w, 16, header=108, compression=3,
                                                masks=(0x7C00, 0x3E0, 0x1F, 0))


def fixtures():
    """(name, bytes) of every fixture."""
    yield from _jpegs()
    yield from _pngs()
    yield from _bmps()


def main() -> None:
    from PIL import Image

    digests = {}
    for name, data in fixtures():
        (HERE / name).write_bytes(data)
        with Image.open(HERE / name) as im:
            size = list(im.size)
            pixels = np.asarray(im.convert("RGB"))
        digests[name] = {
            "shape": list(pixels.shape),
            "size": size,
            "sha256": hashlib.sha256(pixels.tobytes()).hexdigest(),
        }
    (HERE / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")


if __name__ == "__main__":
    main()
