"""Image files to uint8 RGB arrays, without PIL: the port's counterpart of
``np.asarray(PIL.Image.open(path).convert("RGB"))`` and of PIL's
header-only ``Image.open(path).size``.

JPEG (baseline, extended sequential and progressive; grey, YCbCr, RGB,
CMYK and YCCK) and PNG (every colour type and depth, sequential or Adam7)
are decoded by the C++ library ``native/imagecodec.cpp``, built with g++ at
first use and bound with ctypes, so a decode runs without the interpreter
lock and a thread pool of decoders scales with its threads.  The JPEG
pixels are libjpeg's (islow IDCT, fancy upsampling, its colour tables),
which PIL decodes with; a PNG's zlib stream is inflated here with the
standard library and unfiltered in the library.  BMP (uncompressed 1-, 4-
and 8-bit palette, 16-, 24- and 32-bit, the bit-field layouts PIL reads,
and RLE8 and RLE4 as PIL's ``BmpRleDecoder`` expands them) is unpacked
here.  A file the codec does not decode (arithmetic-coded, 12-bit,
lossless or hierarchical JPEG, GIF, TIFF, WebP or any other format) raises
``ValueError`` naming the file; nothing falls back to another decoder.
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
_BMP_MAGIC = b"BM"
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
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.codec_resize_bilinear.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    for fn in (lib.codec_jpeg_header, lib.codec_jpeg_decode, lib.codec_png_decode,
               lib.codec_resize_bilinear):
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
    if color_type == 3 and not palette:
        raise ValueError(f"{name}: palette PNG has no PLTE chunk")
    try:
        pixels = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG image data ({e})") from None
    out = np.empty((height, width, 3), dtype=np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_library().codec_png_decode(pixels, len(pixels), width, height, color_type, depth,
                                       interlace, palette, len(palette) // 3, out.ctypes.data,
                                       err, _ERR_LEN),
           err, name)
    return out


# BMP, as PIL's BmpImagePlugin reads it: the header sizes it knows, and for
# each bit-field layout it accepts, the byte (32-bit) or field (16-bit) of
# red, green and blue.
_BMP_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_BMP_RLE = {1: "RLE8", 2: "RLE4"}
_BMP_MASKS_32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
    (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000),
}
_BMP_565, _BMP_555 = (0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)


def _bmp_header(data: bytes, name: str) -> dict:
    """The fields of a BMP's file and info headers that the pixels need."""
    if len(data) < 18:
        raise ValueError(f"{name}: truncated BMP header")
    offset, size = struct.unpack_from("<I", data, 10)[0], struct.unpack_from("<I", data, 14)[0]
    if size not in _BMP_HEADERS:
        raise ValueError(f"{name}: BMP header of {size} bytes is not supported")
    if len(data) < 14 + size:
        raise ValueError(f"{name}: truncated BMP header")
    h = dict(offset=offset, size=size, masks=None, top_down=False)
    if size == 12:  # OS/2 BITMAPCOREHEADER: 16-bit sizes, BGR palette
        h["width"], h["height"], _, h["bits"] = struct.unpack_from("<HHHH", data, 18)
        h.update(compression=0, colors=0, entry=3)
    else:
        width, height, _, bits, compression = struct.unpack_from("<IIHHI", data, 18)
        h["top_down"] = data[25] == 0xFF  # a negative height, as PIL tests it
        h.update(width=width, height=2**32 - height if h["top_down"] else height, bits=bits,
                 compression=compression, colors=struct.unpack_from("<I", data, 46)[0], entry=4)
        if compression == 3:  # BI_BITFIELDS: in the header from V2 on, else after it
            at = 54
            count = 4 if size >= 56 else 3
            if len(data) < at + 4 * count:
                raise ValueError(f"{name}: truncated BMP bit fields")
            h["masks"] = struct.unpack_from(f"<{count}I", data, at) + (0,) * (4 - count)
    return h


def _bmp_channels(pixels: np.ndarray, bits: int, masks) -> np.ndarray:
    """(H, W, 3) RGB from the (H, W * bytes) rows of a 16-, 24- or 32-bit BMP."""
    h = pixels.shape[0]
    if bits == 16:
        p = pixels.view("<u2").astype(np.uint32)
        r_mask, g_mask, b_mask = masks[:3] if masks is not None else _BMP_555
        fields = []
        for mask in (r_mask, g_mask, b_mask):
            shift = (mask & -mask).bit_length() - 1
            top = mask >> shift
            fields.append(((p & mask) >> shift) * 255 // top)
        return np.stack(fields, -1).astype(np.uint8)
    step = bits // 8
    px = pixels.reshape(h, -1, step)
    if bits == 24 or masks is None or not any(masks):
        return np.ascontiguousarray(px[..., 2::-1])  # BGR(X)
    return np.stack([px[..., ((m & -m).bit_length() - 1) // 8] for m in masks[:3]], -1)


def _bmp_rle_indices(data: bytes, pos: int, width: int, height: int, rle4: bool,
                     name: str) -> np.ndarray:
    """The (height, width) palette indices of an RLE8 or RLE4 stream that
    starts at ``data[pos]``, top row first, as PIL's ``BmpRleDecoder``
    expands them: an encoded run is cut at the row's end (the row's count
    is not reset until an end of line); an absolute run is not cut, and in
    RLE4 it reads count // 2 bytes, two nibbles each, then skips to an even
    file offset; end of line pads the row with index 0; a delta reads four
    bytes after the escape and skips (right + up * width) pixels of the last
    two, at index 0; a stream that ends before the image is full raises."""
    out = bytearray()
    x, end, dest = 0, len(data), width * height
    while len(out) < dest:
        if pos + 2 > end:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # an encoded run
            count = min(count, max(0, width - x))
            if rle4:
                out += (bytes((byte >> 4, byte & 15)) * ((count + 1) // 2))[:count]
            else:
                out += bytes((byte,)) * count
            x += count
        elif byte == 0:  # end of line
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta
            if pos + 2 > end:
                break
            if pos + 4 > end:
                raise ValueError(f"{name}: truncated delta in the RLE-compressed BMP")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * width)
            x = len(out) % width
        else:  # an absolute run
            take = byte // 2 if rle4 else byte
            chunk = data[pos:pos + take]
            pos += take
            if rle4:
                nibbles = np.frombuffer(chunk, np.uint8)
                out += np.stack([nibbles >> 4, nibbles & 15], 1).tobytes()
            else:
                out += chunk
            if len(chunk) < take:
                break
            x += byte
            pos += pos % 2  # to an even offset in the file
    if len(out) < dest:
        raise ValueError(f"{name}: not enough image data in the RLE-compressed BMP")
    return np.frombuffer(bytes(out[:dest]), np.uint8).reshape(height, width)


def _bmp_palette(data: bytes, h: dict, colors: int) -> np.ndarray:
    """The (256, 3) RGB colours of a palette file's indices; an index past
    the table is black, as PIL has it."""
    entry = h["entry"]
    count = min(colors, 256, (len(data) - 14 - h["size"]) // entry)
    table = np.frombuffer(data, np.uint8, count * entry, 14 + h["size"])
    palette = np.zeros((256, 3), np.uint8)
    got = table.reshape(count, entry)[:, 2::-1]
    palette[: len(got)] = got
    return palette


def _decode_bmp(data: bytes, name: str) -> np.ndarray:
    h = _bmp_header(data, name)
    width, height, bits, compression = h["width"], h["height"], h["bits"], h["compression"]
    if width * height > _MAX_PIXELS:
        raise ValueError(f"{name}: BMP too large ({width} x {height})")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{name}: BMP pixel depth {bits} is not supported")
    if compression in _BMP_RLE and bits > 8:
        raise ValueError(f"{name}: {_BMP_RLE[compression]}-compressed BMP of {bits}-bit pixels "
                         "is not supported")
    masks = h["masks"]
    if compression == 3:
        layout_ok = (bits == 32 and (masks in _BMP_MASKS_32 or not any(masks))) or (
            bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF)) or (
            bits == 16 and masks[:3] in (_BMP_565, _BMP_555))
        if not layout_ok:
            raise ValueError(f"{name}: BMP bit-field layout {tuple(hex(m) for m in masks)} is not supported")
    elif compression != 0 and compression not in _BMP_RLE:
        raise ValueError(f"{name}: BMP compression {compression} is not supported")
    colors = h["colors"] or 1 << bits
    offset = h["offset"]
    if offset == 14 + h["size"] and bits <= 8:
        offset += 4 * colors  # as PIL: an offset that points at the palette skips it
    if bits <= 8 and not 0 < colors <= 65536:
        raise ValueError(f"{name}: BMP palette of {colors} colours is not supported")
    if compression in _BMP_RLE:
        index = _bmp_rle_indices(data, offset, width, height, compression == 2, name)
        if not h["top_down"]:
            index = index[::-1]
        return _bmp_palette(data, h, colors)[index]
    stride = ((width * bits + 31) >> 3) & ~3
    end = offset + stride * height
    if len(data) < end:
        raise ValueError(f"{name}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
    if not h["top_down"]:
        rows = rows[::-1]
    if bits > 8:
        return _bmp_channels(rows[:, : width * bits // 8], bits, masks)
    palette = _bmp_palette(data, h, colors)
    if bits == 8:
        index = rows[:, :width]
    else:
        index = np.unpackbits(rows, axis=1, bitorder="big")
        index = index.reshape(height, -1, bits)[:, :width]
        index = (index << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)
    return palette[index]


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An encoded JPEG, PNG or BMP as an (H, W, 3) uint8 RGB array; ``name``
    labels the errors."""
    if data.startswith(_JPEG_MAGIC):
        return _decode_jpeg(data, name)
    if data.startswith(_PNG_MAGIC):
        return _decode_png(data, name)
    if data.startswith(_BMP_MAGIC):
        return _decode_bmp(data, name)
    raise ValueError(f"{name}: not a JPEG or PNG or BMP file")


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
    """``(width, height)`` of the JPEG, PNG or BMP at ``path``, from its
    header only (PIL's ``Image.open(path).size``)."""
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
        if head.startswith(_BMP_MAGIC):
            f.seek(0)
            h = _bmp_header(f.read(14 + 124), name)
            return h["width"], h["height"]
    raise ValueError(f"{name}: not a JPEG or PNG or BMP file")


def resize_bilinear(image: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """An (H, W, 3) uint8 image resized to (nh, nw, 3) by the codec's
    bilinear resize: ``F.interpolate``'s half-pixel taps and weights (no
    antialias), in f32 on one thread, rounded half to even.  Its pixels do
    not depend on the thread or process that runs it; ``F.interpolate``'s
    last bit depends on how it splits the work over torch's threads."""
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {image.dtype} {image.shape}")
    image = np.ascontiguousarray(image)
    out = np.empty((nh, nw, 3), dtype=np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_library().codec_resize_bilinear(image.ctypes.data, image.shape[0], image.shape[1],
                                            out.ctypes.data, nh, nw, err, _ERR_LEN), err, "resize")
    return out


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
