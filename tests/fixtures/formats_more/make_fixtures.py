"""Writes the GIF, TIFF and WebP fixtures of this folder and
``digests.json``, from seeded scenes:

    python tests/fixtures/formats_more/make_fixtures.py

What PIL writes, it writes: a quantized GIF, TIFFs (uncompressed, LZW,
PackBits, Deflate and JPEG RGB, grey, grey with alpha, palette, RGBA and
CMYK), and WebPs (lossy, lossless, with alpha, with EXIF, animated).  What
PIL cannot write is built here: GIFs (``gif``: GIF87a, local and global
colour tables, interlaced rows, a grey-ramp palette, no palette, a frame
smaller than the screen or past it, a transparency index, a full LZW table
without a clear, clear codes), TIFFs (``tiff``: either byte order, tiles,
ragged strips, planar configuration 2, predictor 2, fill order 2, 1-, 2-,
4- and 16-bit samples, associated alpha, JPEG strips over a JPEGTables tag
with the YCbCr photometric; since the CCITT, LZMA and Zstandard readers
also libtiff's own data for those codecs, taken from a one-strip file PIL
writes of each strip or tile (``pil_codec``), float and signed samples,
predictor 3 and YCbCr sampling blocks) and animated WebPs whose first frame sits
inside a larger canvas (``webp_animation``).  Lossy WebPs with the simple
loop filter, a sharpness and several token partitions come from libwebp's
own encoder, which PIL bundles, driven through its advanced API
(``libwebp_encode``).  The JSON holds each file's PIL size and the shape
and sha256 of its pixels as PIL decodes them
(``np.asarray(Image.open(f).convert("RGB"))``), for machines without PIL.
The builders are the tests' too.
"""

import hashlib
import importlib.util
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("format_fixtures", HERE.parent / "formats" / "make_fixtures.py")
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
scene, _pack_row = _base.scene, _base._pack_row


# ---------------------------------------------------------------- GIF

def lzw_gif(indices: np.ndarray, code_size: int, clear_every: int = 0) -> bytes:
    """Palette indices as GIF LZW data (least significant bit first): a
    clear code first, the code width growing after entry 2^width is made,
    a full table (4096 entries) kept without a clear (deferred clear) unless
    ``clear_every`` codes ask for one, and the end code."""
    clear, end = 1 << code_size, (1 << code_size) + 1
    out, acc, nacc = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def reset():
        return {}, code_size + 1, end + 1

    table, width, nxt = reset()
    put(clear, width)
    emitted, prefix = 0, None
    for b in np.asarray(indices, np.uint8).ravel().tolist():
        if prefix is None:
            prefix = b
            continue
        if (prefix, b) in table:
            prefix = table[(prefix, b)]
            continue
        put(prefix, width)
        emitted += 1
        if nxt < 4096:
            table[(prefix, b)] = nxt
            nxt += 1
            if nxt - 1 == (1 << width) and width < 12:
                width += 1
        prefix = b
        if clear_every and emitted % clear_every == 0:
            put(clear, width)
            table, width, nxt = reset()
    if prefix is not None:
        put(prefix, width)
        if nxt < 4096:  # the entry the decoder makes on reading that code
            nxt += 1
            if nxt - 1 == (1 << width) and width < 12:
                width += 1
    put(end, width)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes, size: int = 255) -> bytes:
    return b"".join(bytes([len(data[i:i + size])]) + data[i:i + size]
                    for i in range(0, len(data), size)) + b"\x00"


def gif(indices: np.ndarray, palette=None, screen=None, at=(0, 0), local_palette=None,
        transparency=None, interlace=False, version=b"GIF89a", code_size=None,
        clear_every=0, background=0) -> bytes:
    """A one-frame GIF of (h, w) palette indices: a global (``palette``)
    and/or local colour table of 2^k entries, a logical screen larger than
    the frame placed ``at`` (x, y), a transparency index, interlaced rows."""
    h, w = indices.shape
    sw, sh = screen or (w, h)

    def table(colours):
        colours = np.asarray(colours, np.uint8).reshape(-1, 3)
        bits = max(1, int(np.ceil(np.log2(max(len(colours), 2)))))
        padded = np.zeros((1 << bits, 3), np.uint8)
        padded[: len(colours)] = colours
        return bits, padded.tobytes()

    head = version + struct.pack("<HHBBB", sw, sh, 0, background, 0)
    if palette is not None:
        bits, body = table(palette)
        head = version + struct.pack("<HHBBB", sw, sh, 0x80 | (bits - 1), background, 0) + body
    if transparency is not None:
        head += b"\x21\xf9\x04" + bytes([1, 0, 0, transparency, 0])
    flags = (0x40 if interlace else 0)
    local = b""
    if local_palette is not None:
        bits, local = table(local_palette)
        flags |= 0x80 | (bits - 1)
    rows = np.asarray(indices, np.uint8)
    if interlace:
        order = [*range(0, h, 8), *range(4, h, 8), *range(2, h, 4), *range(1, h, 2)]
        rows = rows[order]
    size = code_size or max(2, int(rows.max()).bit_length())
    desc = b"\x2c" + struct.pack("<HHHHB", at[0], at[1], w, h, flags) + local
    return head + desc + bytes([size]) + _sub_blocks(lzw_gif(rows, size, clear_every)) + b"\x3b"


# --------------------------------------------------------------- TIFF

def lzw_tiff(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: most significant bit first, 256
    first, the width growing once the next free entry needs it, a clear
    when the next free entry would be 4094, 257 last."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8
        acc &= (1 << nacc) - 1

    table, width, nxt = {}, 9, 258
    put(256, width)
    prefix = None
    for b in data:
        if prefix is None:
            prefix = b
            continue
        if (prefix, b) in table:
            prefix = table[(prefix, b)]
            continue
        put(prefix, width)
        table[(prefix, b)] = nxt
        nxt += 1
        if nxt == 4094:
            put(256, width)
            table, width, nxt = {}, 9, 258
        elif nxt > (1 << width) - 1:
            width += 1
        prefix = b
    if prefix is not None:
        put(prefix, width)
        nxt += 1
        if nxt == 4094:
            put(256, width)
            width = 9
        elif nxt > (1 << width) - 1:
            width += 1
    put(257, width)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits runs (repeats of 2..128 bytes) and literals (up to 128)."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


_PIL_CODECS = {2: "tiff_ccitt", 3: "group3", 4: "group4", 34925: "lzma", 50000: "zstd"}


def pil_codec(pixels: np.ndarray, compression: int, tiffinfo: dict | None = None) -> bytes:
    """The one strip libtiff (through PIL) writes for ``pixels``: (rows,
    bytes) uint8 as grey, or (rows, cols) bool as bilevel for the CCITT
    codecs; so a file built here carries libtiff's own LZMA, Zstandard or
    fax data for any tile, byte order or layout."""
    from PIL import Image

    buf = io.BytesIO()
    info = {278: pixels.shape[0], **(tiffinfo or {})}
    Image.fromarray(pixels).save(buf, "TIFF", compression=_PIL_CODECS[compression], tiffinfo=info)
    data = buf.getvalue()
    order = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(order + "I", data, 4)
    (count,) = struct.unpack_from(order + "H", data, ifd)
    tags = {}
    for i in range(count):
        tag, kind, _, value = struct.unpack_from(order + "HHII", data, ifd + 2 + 12 * i)
        if kind == 3:
            value = struct.unpack_from(order + "H", data, ifd + 10 + 12 * i)[0]
        tags[tag] = value
    return data[tags[273]:tags[273] + tags[279]]


def _tiff_compress(raw: bytes, compression: int) -> bytes:
    if compression == 1:
        return raw
    if compression == 5:
        return lzw_tiff(raw)
    if compression in (8, 32946):
        return zlib.compress(raw)
    if compression == 32773:
        return packbits(raw)
    if compression in (34925, 50000):
        return pil_codec(np.frombuffer(raw, np.uint8)[None], compression)
    raise ValueError(compression)


def _float_predictor(rows: np.ndarray, spp: int) -> np.ndarray:
    """libtiff's floating-point predictor (3) over (rows, samples) float32:
    each row's bytes as four planes, most significant first, then each
    byte less the byte a sample before it."""
    n = rows.shape[0]
    planes = rows.astype(">f4").view(np.uint8).reshape(n, -1, 4).transpose(0, 2, 1).reshape(n, -1, spp)
    planes = planes.astype(np.int64)
    return (np.concatenate([planes[:, :1], np.diff(planes, axis=1)], axis=1) % 256).astype(np.uint8)


def _pack_ycbcr(block: np.ndarray, sh: int, sv: int) -> bytes:
    """(rows, cols, 3) Y, Cb, Cr as libtiff's subsampled blocks: sh x sv
    lumas (edge blocks padded by repeating the last row and column), then
    the block's top-left Cb and Cr."""
    rows, cols, _ = block.shape
    bv, bh = -(-rows // sv), -(-cols // sh)
    padded = np.pad(block, ((0, bv * sv - rows), (0, bh * sh - cols), (0, 0)), mode="edge")
    luma = padded[..., 0].reshape(bv, sv, bh, sh).transpose(0, 2, 1, 3).reshape(bv, bh, sv * sh)
    chroma = padded[::sv, ::sh, 1:]
    return np.concatenate([luma, chroma], -1).astype(np.uint8).tobytes()


def _pack_samples(block: np.ndarray, bits: int, order: str, predictor: int) -> bytes:
    """(rows, cols, spp) samples as the bytes of a strip or tile, each row
    differenced along itself under predictor 2 (or 3, for float32); a
    float or signed array is written as its own type."""
    rows = block.shape[0]
    if predictor == 3:
        return _float_predictor(block.reshape(rows, -1), block.shape[2]).tobytes()
    if block.dtype.kind in "fi":
        kind = {"f": "f", "i": "i"}[block.dtype.kind]
        block = block.astype(f"{order}{kind}{bits // 8}").view(f"{order}u{bits // 8}")
    if predictor == 2:
        block = block.astype(np.int64)
        block = np.concatenate([block[:, :1], np.diff(block, axis=1)], axis=1) % (1 << bits)
    flat = block.reshape(rows, -1)
    if bits in (16, 32):
        return flat.astype(f"{order}u{bits // 8}").tobytes()
    if bits == 8:
        return flat.astype(np.uint8).tobytes()
    return b"".join(_pack_row(r, bits).tobytes() for r in flat)


def tiff(samples: np.ndarray, photometric: int, bits: int = 8, order: str = "<",
         compression: int = 1, predictor: int = 1, planar: int = 1, rows_per_strip=None,
         tile=None, extra=(), colormap=None, fill_order: int = 1, jpeg=None,
         more_tags: dict | None = None, sample_format: int = 1, subsampling=None,
         t4options: int = 0) -> bytes:
    """A one-IFD TIFF of (h, w, spp) samples: strips of ``rows_per_strip``
    rows (the last one ragged) or ``tile`` = (width, length) tiles (edge
    tiles padded), chunky or planar, uncompressed, LZW, Deflate, PackBits,
    LZMA, Zstandard or CCITT (2, 3 with ``t4options``, 4; the last three
    from libtiff through ``pil_codec``), predictor 2 or 3, either byte
    order, float or signed samples (``sample_format`` 3 or 2), YCbCr in
    ``subsampling`` = (h, v) blocks; ``jpeg`` = (tables, [stream per
    strip]) writes JPEG-compressed (7) strips instead."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, spp = samples.shape
    if tile:
        tw, th = tile
        across, down = -(-w // tw), -(-h // th)
        padded = np.zeros((down * th, across * tw, spp), samples.dtype)
        padded[:h, :w] = samples
        boxes = [(y * th, x * tw, th, tw) for y in range(down) for x in range(across)]
    else:
        rps = rows_per_strip or h
        boxes = [(y, 0, min(rps, h - y), w) for y in range(0, h, rps)]
        padded = samples
    blocks = []
    if jpeg is not None:
        blocks = list(jpeg[1])
    else:
        planes = range(spp) if planar == 2 else [None]
        for p in planes:
            for y, x, bh, bw in boxes:
                block = padded[y:y + bh, x:x + bw]
                block = block if p is None else block[..., p:p + 1]
                if compression in (2, 3, 4):
                    info = {292: t4options} if compression == 3 else {}
                    raw = pil_codec(block[..., 0] != 0, compression, info)
                elif subsampling:
                    raw = _tiff_compress(_pack_ycbcr(block, *subsampling), compression)
                else:
                    raw = _tiff_compress(_pack_samples(block, bits, order, predictor), compression)
                if fill_order == 2:  # libtiff reverses the bits of the stored bytes
                    raw = bytes(int(f"{b:08b}"[::-1], 2) for b in raw)
                blocks.append(raw)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if sample_format != 1:
        tags[339] = (3, [sample_format])
    if subsampling:
        tags[530] = (3, list(subsampling))
    if compression == 3 and t4options:
        tags[292] = (4, [t4options])
    if extra:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, list(colormap))
    if fill_order != 1:
        tags[266] = (3, [fill_order])
    if jpeg is not None and jpeg[0]:
        tags[347] = (7, jpeg[0])
    if tile:
        tags[322], tags[323] = (3, [tile[0]]), (3, [tile[1]])
    else:
        tags[278] = (4, [rows_per_strip or h])
    tags.update(more_tags or {})
    offset_tag, count_tag = (324, 325) if tile else (273, 279)
    # Layout: header, pixel data, then the IFD and its out-of-line values.
    out = bytearray((b"II*\x00" if order == "<" else b"MM\x00*") + b"\x00" * 4)
    offsets = []
    for b in blocks:
        offsets.append(len(out))
        out += b + (b"\x00" if len(b) % 2 else b"")
    tags[offset_tag] = (4, offsets)
    tags[count_tag] = (4, [len(b) for b in blocks])
    ifd_at = len(out)
    struct.pack_into(order + "I", out, 4, ifd_at)
    entries = sorted(tags.items())
    values_at = ifd_at + 2 + 12 * len(entries) + 4
    ifd, values = struct.pack(order + "H", len(entries)), bytearray()
    for tag, (kind, vals) in entries:
        if kind == 7:
            raw, count = bytes(vals), len(vals)
        else:
            code = {3: "H", 4: "I", 5: "I"}[kind]  # a rational is two longs
            raw, count = struct.pack(order + code * len(vals), *vals), len(vals) // (2 if kind == 5 else 1)
        if len(raw) <= 4:
            ifd += struct.pack(order + "HHI", tag, kind, count) + raw.ljust(4, b"\x00")
        else:
            ifd += struct.pack(order + "HHII", tag, kind, count, values_at + len(values))
            values += raw + (b"\x00" if len(raw) % 2 else b"")
    return bytes(out + ifd + b"\x00" * 4 + values)


def jpeg_in_tiff(jpeg: bytes) -> tuple[bytes, bytes]:
    """A JPEG file split into a JPEGTables stream (its DQT and DHT markers
    between an SOI and an EOI) and the abbreviated image stream (SOI, then
    the frame, scan and EOI)."""
    pos, tables, image = 2, bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8")
    while pos < len(jpeg):
        marker = jpeg[pos + 1]
        if marker == 0xDA:
            image += jpeg[pos:]
            break
        (length,) = struct.unpack(">H", jpeg[pos + 2:pos + 4])
        segment = jpeg[pos:pos + 2 + length]
        if marker in (0xDB, 0xC4):
            tables += segment
        elif 0xE0 > marker or marker > 0xEF:  # keep SOF, DRI; drop APPn
            image += segment
        pos += 2 + length
    return bytes(tables + b"\xff\xd9"), bytes(image)


# --------------------------------------------------------------- WebP

def riff_chunk(kind: bytes, body: bytes) -> bytes:
    return kind + struct.pack("<I", len(body)) + body + (b"\x00" if len(body) % 2 else b"")


def webp_file(chunks: list[bytes]) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def webp_chunks(data: bytes) -> list[tuple[bytes, bytes]]:
    """(fourcc, payload) of a WebP file's top-level chunks."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        kind, (n,) = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)
        out.append((kind, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def webp_animation(canvas, frames, background=(0, 0, 0, 0)) -> bytes:
    """An animated WebP (VP8X with the animation flag, ANIM, one ANMF per
    frame) of ``frames``: (x, y, still WebP file), x and y even."""
    width, height = canvas
    vp8x = bytes([0x02, 0, 0, 0]) + (width - 1).to_bytes(3, "little") + (height - 1).to_bytes(3, "little")
    anim = bytes(background) + struct.pack("<H", 0)
    chunks = [riff_chunk(b"VP8X", vp8x), riff_chunk(b"ANIM", anim)]
    for x, y, still in frames:
        inner = [c for c in webp_chunks(still) if c[0] in (b"ALPH", b"VP8 ", b"VP8L")]
        kind, body = inner[-1]
        if kind == b"VP8 ":
            w, h = (v & 0x3FFF for v in struct.unpack_from("<HH", body, 6))
        else:
            bits = int.from_bytes(body[1:5], "little")
            w, h = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
        head = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
                + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
                + (100).to_bytes(3, "little") + b"\x00")
        chunks.append(riff_chunk(b"ANMF", head + b"".join(riff_chunk(k, b) for k, b in inner)))
    return webp_file(chunks)


def flat_scene(h: int, w: int) -> np.ndarray:
    """An (h, w, 3) uint8 image of gradients and two flat rectangles, no
    noise: the 640 x 480 files stay small."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // (w - 1), yy * 255 // (h - 1), (xx + yy) * 255 // (w + h)], -1)
    img[h // 5:h // 2, w // 4:w * 5 // 8] = (200, 30, 60)
    img[h * 5 // 8:h * 7 // 8, w // 2:w * 15 // 16] = (20, 180, 90)
    return img.astype(np.uint8)


def libwebp_encode(rgb: np.ndarray, quality: float = 75.0, **config) -> bytes:
    """A lossy WebP of (h, w, 3) uint8 pixels through libwebp's advanced
    encoding API (``WebPEncode`` with a ``WebPConfig``), for the settings
    PIL does not pass on: ``filter_type`` 0 (the simple loop filter),
    ``filter_sharpness``, ``partitions`` (token partitions), ``segments``.
    The library is the one bundled with PIL."""
    import ctypes
    import glob
    import os

    import PIL

    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
    for dep in sorted(glob.glob(os.path.join(libs, "libsharpyuv*"))):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(sorted(glob.glob(os.path.join(libs, "libwebp-*")))[0])
    c_int, c_void_p, c_u32 = ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32

    class Picture(ctypes.Structure):  # WebPPicture (encode.h)
        _fields_ = [("use_argb", c_int), ("colorspace", c_int), ("width", c_int), ("height", c_int),
                    ("y", c_void_p), ("u", c_void_p), ("v", c_void_p), ("y_stride", c_int),
                    ("uv_stride", c_int), ("a", c_void_p), ("a_stride", c_int), ("pad1", c_u32 * 2),
                    ("argb", c_void_p), ("argb_stride", c_int), ("pad2", c_u32 * 3),
                    ("writer", c_void_p), ("custom_ptr", c_void_p), ("extra_info_type", c_int),
                    ("extra_info", c_void_p), ("stats", c_void_p), ("error_code", c_int),
                    ("progress_hook", c_void_p), ("user_data", c_void_p), ("pad3", c_u32 * 3),
                    ("pad4", c_void_p), ("pad5", c_void_p), ("pad6", c_u32 * 8),
                    ("memory_", c_void_p), ("memory_argb_", c_void_p), ("pad7", c_void_p * 2)]

    class MemoryWriter(ctypes.Structure):
        _fields_ = [("mem", c_void_p), ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                    ("pad", c_u32 * 1)]

    # WebPConfig's fields, each four bytes, in order (encode.h).
    fields = ["lossless", "quality", "method", "image_hint", "target_size", "target_PSNR",
              "segments", "sns_strength", "filter_strength", "filter_sharpness", "filter_type",
              "autofilter", "alpha_compression", "alpha_filtering", "alpha_quality", "pass",
              "show_compressed", "preprocessing", "partitions", "partition_limit"]
    cfg = (c_int * 64)()
    abi = 0x0200  # the encoder ABI's major version
    if not lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(quality), abi):
        raise RuntimeError("WebPConfigInit failed")
    for key, value in config.items():
        cfg[fields.index(key)] = value
    if not lib.WebPValidateConfig(cfg):
        raise ValueError(f"invalid libwebp config {config}")
    pic, writer = Picture(), MemoryWriter()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), abi):
        raise RuntimeError("WebPPictureInit failed")
    rgb = np.ascontiguousarray(rgb, np.uint8)
    pic.height, pic.width = rgb.shape[:2]
    if not lib.WebPPictureImportRGB(ctypes.byref(pic), rgb.ctypes.data_as(c_void_p), 3 * rgb.shape[1]):
        raise RuntimeError("WebPPictureImportRGB failed")
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, c_void_p).value
    pic.custom_ptr = ctypes.addressof(writer)
    try:
        if not lib.WebPEncode(cfg, ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode failed ({pic.error_code})")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPMemoryWriterClear(ctypes.byref(writer))
        lib.WebPPictureFree(ctypes.byref(pic))


def _gifs():
    from PIL import Image

    rng = np.random.default_rng(60)
    pil = Image.fromarray(flat_scene(480, 640)).quantize(256)
    buf = io.BytesIO()
    pil.save(buf, "GIF")
    yield "gif_640x480.gif", buf.getvalue()
    index = scene(61, 23, 31, 1, 15)[..., 0]
    palette = rng.integers(0, 256, (16, 3))
    yield "gif87a_global.gif", gif(index, palette, version=b"GIF87a")
    yield "gif_local_interlaced.gif", gif(index, palette[:1], local_palette=palette, interlace=True)
    yield "gif_grey_ramp.gif", gif(index * 13, np.repeat(np.arange(256)[:, None], 3, 1))
    yield "gif_no_palette.gif", gif(index * 7)
    # A first frame smaller than the screen: the rest is index 0, or the
    # transparency index where there is one (PIL's fill).
    yield "gif_small_frame.gif", gif(index[:12, :17], palette, screen=(31, 23), at=(9, 5))
    yield "gif_small_frame_transparent.gif", gif(index[:12, :17], palette, screen=(31, 23),
                                                 at=(9, 5), transparency=11)
    yield "gif_frame_past_screen.gif", gif(index, palette, screen=(25, 19), at=(4, 6))
    # 256 colours of noise fill the 4096-entry table: the codes go on at 12
    # bits until a clear (a deferred clear), here only at the end.
    yield "gif_deferred_clear.gif", gif(rng.integers(0, 256, (72, 72)), rng.integers(0, 256, (256, 3)))
    yield "gif_clear_codes.gif", gif(rng.integers(0, 256, (40, 40)), rng.integers(0, 256, (256, 3)),
                                     clear_every=500)


def _tiffs():
    from PIL import Image

    def save(img, **options):
        buf = io.BytesIO()
        img.save(buf, "TIFF", **options)
        return buf.getvalue()

    rgb = scene(70, 21, 29).astype(np.uint8)
    big = flat_scene(480, 640)
    yield "tiff_640x480_lzw.tif", tiff(big, 2, compression=5, predictor=2, rows_per_strip=16)
    yield "tiff_rgb_raw.tif", save(Image.fromarray(rgb))
    yield "tiff_rgb_lzw.tif", save(Image.fromarray(rgb), compression="tiff_lzw")
    yield "tiff_rgb_packbits.tif", save(Image.fromarray(rgb), compression="packbits")
    yield "tiff_rgb_deflate.tif", save(Image.fromarray(rgb), compression="tiff_adobe_deflate")
    yield "tiff_rgb_jpeg.tif", save(Image.fromarray(rgb), compression="jpeg")
    yield "tiff_rgb_deflate32946_predictor_be.tif", tiff(rgb, 2, order=">", compression=32946,
                                                         predictor=2, rows_per_strip=10)
    yield "tiff_rgb_lzw_tiles.tif", tiff(rgb, 2, compression=5, tile=(16, 32))
    yield "tiff_rgb_packbits_ragged_strips.tif", tiff(rgb, 2, compression=32773, rows_per_strip=8)
    yield "tiff_rgb_planar_deflate.tif", tiff(rgb, 2, compression=8, planar=2, rows_per_strip=12)
    yield "tiff_rgb_planar_raw_tiles.tif", tiff(rgb, 2, planar=2, tile=(32, 16))
    yield "tiff_rgb_lzw_fill_order2.tif", tiff(rgb, 2, compression=5, fill_order=2)
    yield "tiff_rgb16_lzw_predictor_be.tif", tiff(scene(72, 17, 19, 3, 65535), 2, 16, order=">",
                                                  compression=5, predictor=2)
    yield "tiff_rgb16_raw_le.tif", tiff(scene(73, 17, 19, 3, 65535), 2, 16)
    rgba = np.concatenate([rgb, scene(74, 21, 29, 1).astype(np.uint8)], -1)
    associated = rgba.copy()
    associated[..., :3] = (rgba[..., :3].astype(int) * rgba[..., 3:] // 255).astype(np.uint8)
    yield "tiff_rgba_unassociated.tif", save(Image.fromarray(rgba, "RGBA"))
    yield "tiff_rgba_associated_lzw.tif", tiff(associated, 2, compression=5, extra=(1,))
    yield "tiff_rgbx_deflate.tif", tiff(rgba, 2, compression=8, extra=(0,))
    yield "tiff_rgba16_unassociated_be.tif", tiff(scene(75, 13, 11, 4, 65535), 2, 16, order=">",
                                                  extra=(2,))
    grey = scene(76, 21, 29, 1)[..., 0].astype(np.uint8)
    yield "tiff_grey8.tif", save(Image.fromarray(grey))
    yield "tiff_grey8_miniswhite_lzw.tif", tiff(grey, 0, compression=5)
    yield "tiff_grey8_jpeg.tif", tiff(grey, 1, compression=7, rows_per_strip=16,
                                      jpeg=jpeg_in_tiff_strips(grey, 16))
    yield "tiff_grey4_packbits.tif", tiff(grey >> 4, 1, 4, compression=32773)
    yield "tiff_grey2_miniswhite.tif", tiff(grey >> 6, 0, 2)
    yield "tiff_grey16_le.tif", tiff(scene(77, 13, 17, 1, 300), 1, 16)
    yield "tiff_grey16_be_deflate.tif", tiff(scene(78, 13, 17, 1, 65535), 1, 16, order=">",
                                             compression=8)
    yield "tiff_grey_alpha.tif", save(Image.fromarray(np.stack([grey, 255 - grey], -1), "LA"))
    bilevel = grey > 128
    yield "tiff_bilevel_minisblack.tif", tiff(bilevel.astype(np.uint8), 1, 1)
    yield "tiff_bilevel_miniswhite_packbits.tif", tiff(bilevel.astype(np.uint8), 0, 1,
                                                       compression=32773, rows_per_strip=7)
    yield "tiff_palette8.tif", save(Image.fromarray(rgb).quantize(200))
    colormap = np.random.default_rng(79).integers(0, 65536, 3 * 16).tolist()
    yield "tiff_palette4_lzw.tif", tiff(grey >> 4, 3, 4, compression=5, colormap=colormap)
    yield "tiff_cmyk.tif", save(Image.fromarray(rgb).convert("CMYK"))
    yield "tiff_cmyk16_lzw.tif", tiff(scene(80, 11, 13, 4, 65535), 5, 16, compression=5)
    # JPEG-in-TIFF with YCbCr photometric: libjpeg's colour conversion.
    for sub, factors in (("4:2:0", (2, 2)), ("4:4:4", (1, 1))):
        yield (f"tiff_ycbcr_jpeg_{sub.replace(':', '')}.tif",
               tiff(rgb, 6, compression=7, rows_per_strip=16, jpeg=jpeg_in_tiff_strips(rgb, 16, sub),
                    more_tags={530: (3, list(factors))}))


def jpeg_in_tiff_strips(img: np.ndarray, rows: int, subsampling: str = "4:2:0", quality: int = 85):
    """(JPEGTables, [abbreviated stream per strip]) of PIL JPEGs of each
    ``rows``-row strip of ``img``, as a JPEG-compressed TIFF holds them."""
    from PIL import Image

    tables, strips = None, []
    for y in range(0, img.shape[0], rows):
        buf = io.BytesIO()
        options = {"subsampling": subsampling} if img.ndim == 3 else {}
        Image.fromarray(img[y:y + rows]).save(buf, "JPEG", quality=quality, **options)
        t, s = jpeg_in_tiff(buf.getvalue())
        tables = tables or t
        strips.append(s)
    return tables, strips


def _webps():
    from PIL import Image

    def save(img, **options):
        buf = io.BytesIO()
        img.save(buf, "WEBP", **options)
        return buf.getvalue()

    rgb = Image.fromarray(scene(90, 37, 45).astype(np.uint8))
    yield "webp_640x480.webp", save(Image.fromarray(flat_scene(480, 640)), quality=80)
    yield "webp_640x480_lossless.webp", save(Image.fromarray(flat_scene(480, 640)), lossless=True)
    yield "webp_lossy.webp", save(rgb)
    yield "webp_lossy_q5.webp", save(rgb, quality=5, method=6)
    yield "webp_lossy_odd_33x47.webp", save(Image.fromarray(scene(92, 33, 47).astype(np.uint8)), quality=90)
    yield "webp_lossless.webp", save(rgb, lossless=True)
    yield "webp_lossless_palette.webp", save(rgb.quantize(12).convert("RGB"), lossless=True)
    rgba = Image.fromarray(np.concatenate([scene(93, 37, 45), scene(94, 37, 45, 1)], -1).astype(np.uint8), "RGBA")
    yield "webp_lossy_alpha.webp", save(rgba, quality=70)
    yield "webp_lossless_alpha.webp", save(rgba, lossless=True, exact=True)
    yield "webp_lossy_exif.webp", save(rgb, exif=b"Exif\x00\x00II*\x00\x08\x00\x00\x00\x00\x00")
    frames = [Image.fromarray(scene(95 + i, 37, 45).astype(np.uint8)) for i in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=100)
    yield "webp_animated.webp", buf.getvalue()
    small = save(Image.fromarray(scene(97, 20, 24).astype(np.uint8)))
    yield "webp_animated_offset_frame.webp", webp_animation((45, 37), [(10, 6, small)])
    lossless = save(Image.fromarray(scene(98, 20, 24).astype(np.uint8)), lossless=True)
    yield "webp_animated_offset_lossless.webp", webp_animation((45, 37), [(4, 12, lossless)])
    img = scene(99, 61, 75).astype(np.uint8)
    yield "webp_simple_filter.webp", libwebp_encode(img, 40, filter_type=0, filter_strength=60)
    yield "webp_sharpness6.webp", libwebp_encode(img, 30, filter_sharpness=6, filter_strength=80)
    yield "webp_partitions4_segments2.webp", libwebp_encode(img, 60, partitions=2, segments=2)


def fixtures():
    """(name, bytes) of every fixture."""
    yield from _gifs()
    yield from _tiffs()
    yield from _webps()


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
