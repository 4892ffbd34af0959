"""Image files to uint8 RGB arrays, without PIL: the port's counterpart of
``np.asarray(PIL.Image.open(path).convert("RGB"))`` and of PIL's
header-only ``Image.open(path).size``.

JPEG (baseline and extended sequential) and PNG are decoded by the C++
library ``native/imagecodec.cpp``, built with g++ at first use and bound
with ctypes, so a decode runs without the interpreter lock and a thread
pool of decoders scales with its threads.  The JPEG pixels are libjpeg's
(islow IDCT, fancy upsampling, its YCbCr tables), which PIL decodes with;
a PNG's zlib stream is inflated here with the standard library and
unfiltered in the library.  A file the codec does not decode
(progressive, arithmetic-coded, 12-bit or CMYK JPEG, interlaced or 16-bit
PNG, any other format) raises ``ValueError`` naming the file; nothing
falls back to another decoder.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import zlib

import numpy as np

from batchai_retinanet_horovod_coco_tpu_torch.native import build

_JPEG_MAGIC = b"\xff\xd8"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_ERR_LEN = 256
_MAX_PIXELS = 1 << 28  # as the codec's limit: a larger image is refused, not allocated
# JPEG markers that carry a frame header (SOFn): not DHT C4, JPG C8, DAC CC.
_SOF_MARKERS = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


@functools.cache
def _library() -> ctypes.CDLL:
    """The codec, built at the first call, with its C signatures declared."""
    lib = build.load("imagecodec")
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.codec_jpeg_header.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, c_int_p, c_int_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.codec_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.codec_png_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
    ]
    for fn in (lib.codec_jpeg_header, lib.codec_jpeg_decode, lib.codec_png_decode):
        fn.restype = ctypes.c_int
    return lib


def _check(rc: int, err: ctypes.Array, name: str) -> None:
    if rc != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")


def _decode_jpeg(data: bytes, name: str) -> np.ndarray:
    lib = _library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    w, h = ctypes.c_int(), ctypes.c_int()
    _check(lib.codec_jpeg_header(data, len(data), ctypes.byref(w), ctypes.byref(h), err, _ERR_LEN),
           err, name)
    out = np.empty((h.value, w.value, 3), dtype=np.uint8)
    _check(lib.codec_jpeg_decode(data, len(data), out.ctypes.data, w.value, h.value, err, _ERR_LEN),
           err, name)
    return out


def _png_chunks(data: bytes, name: str):
    pos = len(_PNG_MAGIC)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: truncated PNG (no IEND chunk)")


def _png_header(body: bytes, name: str) -> tuple[int, int, int, int, int]:
    if len(body) != 13:
        raise ValueError(f"{name}: bad PNG IHDR")
    width, height, depth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", body)
    return width, height, depth, color_type, interlace


def _decode_png(data: bytes, name: str) -> np.ndarray:
    header, palette, idat = None, b"", []
    for kind, body in _png_chunks(data, name):
        if kind == b"IHDR":
            header = _png_header(body, name)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG has no IHDR chunk")
    width, height, depth, color_type, interlace = header
    if width * height > _MAX_PIXELS:
        raise ValueError(f"{name}: PNG too large ({width} x {height})")
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) PNG is not supported")
    if depth == 16:
        raise ValueError(f"{name}: 16-bit PNG is not supported")
    if color_type == 3 and not palette:
        raise ValueError(f"{name}: palette PNG has no PLTE chunk")
    try:
        pixels = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG image data ({e})") from None
    out = np.empty((height, width, 3), dtype=np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_library().codec_png_decode(pixels, len(pixels), width, height, color_type, depth,
                                       palette, len(palette) // 3, out.ctypes.data, err, _ERR_LEN),
           err, name)
    return out


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An encoded JPEG or PNG as an (H, W, 3) uint8 RGB array; ``name``
    labels the errors."""
    if data.startswith(_JPEG_MAGIC):
        return _decode_jpeg(data, name)
    if data.startswith(_PNG_MAGIC):
        return _decode_png(data, name)
    raise ValueError(f"{name}: not a JPEG or PNG file")


def read_rgb(path: str | os.PathLike) -> np.ndarray:
    """The image file at ``path`` as an (H, W, 3) uint8 RGB array."""
    with open(path, "rb") as f:
        data = f.read()
    return decode(data, os.fspath(path))


def _jpeg_size(f, name: str) -> tuple[int, int]:
    f.seek(2)
    while True:
        byte = f.read(1)
        if not byte:
            raise ValueError(f"{name}: JPEG has no frame header (SOF)")
        if byte != b"\xff":
            continue
        marker = f.read(1)
        while marker == b"\xff":
            marker = f.read(1)
        if not marker:
            raise ValueError(f"{name}: JPEG has no frame header (SOF)")
        m = marker[0]
        if m == 0x00 or m == 0x01 or 0xD0 <= m <= 0xD7:
            continue  # stuffed byte or standalone marker
        if m in (0xD9, 0xDA):
            raise ValueError(f"{name}: JPEG has no frame header (SOF)")
        raw = f.read(2)
        if len(raw) != 2:
            raise ValueError(f"{name}: truncated JPEG")
        (length,) = struct.unpack(">H", raw)
        if m in _SOF_MARKERS:
            body = f.read(5)
            if len(body) != 5:
                raise ValueError(f"{name}: truncated JPEG frame header")
            _, height, width = struct.unpack(">BHH", body)
            return width, height
        f.seek(length - 2, os.SEEK_CUR)


def read_size(path: str | os.PathLike) -> tuple[int, int]:
    """``(width, height)`` of the JPEG or PNG at ``path``, from its header
    only (PIL's ``Image.open(path).size``)."""
    name = os.fspath(path)
    with open(path, "rb") as f:
        head = f.read(len(_PNG_MAGIC))
        if head.startswith(_JPEG_MAGIC):
            return _jpeg_size(f, name)
        if head == _PNG_MAGIC:
            chunk = f.read(8 + 13)
            if len(chunk) != 21 or chunk[4:8] != b"IHDR":
                raise ValueError(f"{name}: PNG has no IHDR chunk")
            width, height, *_ = _png_header(chunk[8:], name)
            return width, height
    raise ValueError(f"{name}: not a JPEG or PNG file")


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """An (H, W, 3) uint8 RGB array as PNG bytes: every row with filter 0
    (none), deflated with the standard library's zlib."""
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {image.dtype} {image.shape}")
    h, w = image.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), dtype=np.uint8)
    rows[:, 1:] = image.reshape(h, 3 * w)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (
        _PNG_MAGIC
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
        + chunk(b"IEND", b"")
    )
