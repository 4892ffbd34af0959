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
here.

GIF, TIFF and WebP are read as PIL 12 reads them.  GIF: the first frame,
its LZW data expanded in the library, on the logical screen (grown to hold
the frame, as PIL grows it) whose other pixels hold the frame's
transparency index, else index 0; a palette that is the identity grey ramp
is no palette (PIL's mode "L").  TIFF: the first IFD, either byte order,
strips or tiles, chunky or planar, uncompressed, PackBits, LZW, CCITT RLE,
Group 3 and Group 4 fax and Zstandard (in the library), Deflate (zlib here),
LZMA (the standard library's liblzma, libtiff's own decoder) and JPEG (the
library's JPEG decoder over the JPEGTables tag, YCbCr or RGB as the
photometric tag says), predictors 2 and 3, and the modes of PIL's
``OPEN_INFO`` that convert to RGB without a colour profile (bilevel, 2-, 4-,
8- and 16-bit grey, 16- and 32-bit signed, 32-bit unsigned and 32-bit float
grey, grey with alpha, palette, RGB, RGBA with associated or unassociated
alpha, 8- and 16-bit, CMYK, and YCbCr, JPEG-compressed or not: PIL reads an
uncompressed one with its raw decoder as "RGBX", a compressed one through
libtiff's RGBA interface), turned by the orientation tag as PIL's
``exif_transpose`` turns them.
WebP: lossy (VP8) and lossless (VP8L) bitstreams decoded in the library as
libwebp decodes them, a VP8X file's image (its ALPH chunk dropped, as
``convert("RGB")`` drops alpha), and an animation's first frame on a canvas
of zeros, as libwebp's ``WebPAnimDecoder``, which PIL decodes with, lays
it out.

A file the codec does not decode (arithmetic-coded, 12-bit, lossless or
hierarchical JPEG; old-style JPEG, WebP (which PIL's libtiff refuses too) or
other compressions of TIFF, a Zstandard strip that needs a dictionary, an
xz filter chain libtiff does not write; any other format) raises
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
_GIF_MAGIC = (b"GIF87a", b"GIF89a")
_TIFF_MAGIC = (b"II*\x00", b"MM\x00*")
_NOT_DECODED = "not a JPEG, PNG, BMP, GIF, TIFF or WebP file"
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
    lib.codec_jpeg_decode_as.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.codec_gif_lzw.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.codec_tiff_fax.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.codec_tiff_unpack.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_int,
    ]
    for fn in (lib.codec_vp8_decode, lib.codec_vp8l_decode):
        fn.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int,
        ]
    for fn in (lib.codec_jpeg_header, lib.codec_jpeg_decode, lib.codec_png_decode,
               lib.codec_resize_bilinear, lib.codec_jpeg_decode_as, lib.codec_gif_lzw,
               lib.codec_tiff_unpack, lib.codec_tiff_fax, lib.codec_vp8_decode,
               lib.codec_vp8l_decode):
        fn.restype = ctypes.c_int
    return lib


def _check(rc: int, err: ctypes.Array, name: str) -> None:
    if rc != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")


def _decode_jpeg(data: bytes, name: str, as_rgb: int = -1) -> np.ndarray:
    """``as_rgb`` sets the colour space of three components: 1 as stored,
    0 YCbCr, -1 the one libjpeg infers."""
    lib = _library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    w, h = ctypes.c_int(), ctypes.c_int()
    _check(lib.codec_jpeg_header(data, len(data), ctypes.byref(w), ctypes.byref(h), err, _ERR_LEN),
           err, name)
    out = np.empty((h.value, w.value, 3), dtype=np.uint8)
    _check(lib.codec_jpeg_decode_as(data, len(data), out.ctypes.data, w.value, h.value, as_rgb,
                                    err, _ERR_LEN),
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


# ---------------------------------------------------------------- GIF

def _gif_sub_blocks(data: bytes, pos: int, name: str) -> tuple[list[bytes], int]:
    """The data sub-blocks that start at ``pos`` up to their terminator, and
    the position after it."""
    blocks = []
    while True:
        if pos >= len(data):
            raise ValueError(f"{name}: truncated GIF")
        n = data[pos]
        if n == 0:
            return blocks, pos + 1
        blocks.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n


def _gif_palette(data: bytes, pos: int, flags: int, name: str) -> tuple[bytes | None, int]:
    """A colour table of ``3 << bits`` bytes at ``pos``, or None where PIL
    keeps none: the table is the identity grey ramp (its mode "L")."""
    size = 3 << ((flags & 7) + 1)
    table = data[pos:pos + size]
    if len(table) < size:
        raise ValueError(f"{name}: truncated GIF colour table")
    grey = np.arange(size // 3, dtype=np.uint8).repeat(3).tobytes()
    return (None if table == grey else table), pos + size


def _gif_frame(data: bytes, name: str) -> dict:
    """What PIL's GifImageFile reads up to the first frame's image data."""
    if len(data) < 13:
        raise ValueError(f"{name}: truncated GIF header")
    width, height, flags = struct.unpack_from("<HHB", data, 6)
    pos, palette = 13, None
    if flags & 128:
        palette, pos = _gif_palette(data, pos, flags, name)
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError(f"{name}: GIF has no image")
        kind = data[pos]
        pos += 1
        if kind == 0x21:  # an extension
            if pos >= len(data):
                raise ValueError(f"{name}: truncated GIF")
            label = data[pos]
            blocks, pos = _gif_sub_blocks(data, pos + 1, name)
            if label == 0xF9 and blocks and len(blocks[0]) >= 4 and blocks[0][0] & 1:
                transparency = blocks[0][3]
        elif kind == 0x2C:  # the image descriptor
            if pos + 10 > len(data):
                raise ValueError(f"{name}: truncated GIF image descriptor")
            x0, y0, w, h, iflags = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            if iflags & 128:
                palette, pos = _gif_palette(data, pos, iflags, name)
            code_size = data[pos]
            blocks, _ = _gif_sub_blocks(data, pos + 1, name)
            return dict(size=(max(width, x0 + w), max(height, y0 + h)), box=(x0, y0, w, h),
                        interlace=bool(iflags & 64), palette=palette, transparency=transparency,
                        code_size=code_size, lzw=b"".join(blocks))
        # PIL skips any other byte between blocks.


def _decode_gif(data: bytes, name: str) -> np.ndarray:
    f = _gif_frame(data, name)
    (width, height), (x0, y0, w, h) = f["size"], f["box"]
    if width * height > _MAX_PIXELS:
        raise ValueError(f"{name}: GIF too large ({width} x {height})")
    fill = f["transparency"] or 0
    index = np.full((height, width), fill, np.uint8)
    frame = np.full((h, w), fill, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_library().codec_gif_lzw(f["lzw"], len(f["lzw"]), f["code_size"], w, h,
                                    int(f["interlace"]), frame.ctypes.data, err, _ERR_LEN),
           err, name)
    index[y0:y0 + h, x0:x0 + w] = frame
    if f["palette"] is None:  # mode "L": the index is the grey level
        return np.repeat(index[..., None], 3, axis=2)
    palette = np.zeros((256, 3), np.uint8)
    table = np.frombuffer(f["palette"], np.uint8).reshape(-1, 3)
    palette[: len(table)] = table
    return palette[index]


# --------------------------------------------------------------- TIFF

# Field types: the struct code of one value (rationals are two).
_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i",
               10: "ii", 11: "f", 12: "d", 13: "I"}
# PIL's OPEN_INFO modes that this codec reads: (photometric, bits per
# sample, extra samples) -> the mode PIL unpacks the samples to.
_TIFF_MODES = {
    (0, (1,), ()): "1;I", (1, (1,), ()): "1",
    (0, (2,), ()): "L;I", (1, (2,), ()): "L", (0, (4,), ()): "L;I", (1, (4,), ()): "L",
    (0, (8,), ()): "L;I", (1, (8,), ()): "L", (1, (16,), ()): "I;16", (0, (16,), ()): "I;16",
    (1, (8, 8), (2,)): "LA",
    (2, (8,) * 3, ()): "RGB", (2, (8,) * 4, ()): "RGBA", (2, (8,) * 4, (0,)): "RGB",
    (2, (8,) * 5, (0, 0)): "RGB", (2, (8,) * 6, (0, 0, 0)): "RGB",
    (2, (8,) * 4, (1,)): "RGBa", (2, (8,) * 5, (1, 0)): "RGBa", (2, (8,) * 6, (1, 0, 0)): "RGBa",
    (2, (8,) * 4, (2,)): "RGBA", (2, (8,) * 5, (2, 0)): "RGBA", (2, (8,) * 6, (2, 0, 0)): "RGBA",
    (2, (8,) * 4, (999,)): "RGBA",
    (2, (16,) * 3, ()): "RGB", (2, (16,) * 4, ()): "RGBA", (2, (16,) * 4, (0,)): "RGB",
    (2, (16,) * 4, (1,)): "RGBa", (2, (16,) * 4, (2,)): "RGBA",
    (3, (1,), ()): "P", (3, (2,), ()): "P", (3, (4,), ()): "P", (3, (8,), ()): "P",
    (3, (8, 8), (0,)): "P", (3, (8, 8), (2,)): "P",
    (5, (8,) * 4, ()): "CMYK", (5, (8,) * 5, (0,)): "CMYK", (5, (8,) * 6, (0, 0)): "CMYK",
    (5, (16,) * 4, ()): "CMYK",
    (6, (8,) * 3, ()): "YCbCr",
}
# Grey samples PIL opens as mode "I" or "F": (byte order, photometric,
# sample format, bits) -> PIL's raw mode, whose "B" reads big-endian.
_TIFF_NUMERIC = {
    ("<", 1, 2, 16): "I;16S", (">", 1, 2, 16): "I;16BS",
    ("<", 1, 1, 32): "I;32N", ("<", 1, 2, 32): "I;32S", (">", 1, 2, 32): "I;32BS",
    ("<", 0, 3, 32): "F;32F", (">", 0, 3, 32): "F;32BF",
    ("<", 1, 3, 32): "F;32F", (">", 1, 3, 32): "F;32BF",
}
_TIFF_REFUSED = {6: "old-style JPEG",
                 50001: "WebP (a libtiff built without WebP, as PIL's, refuses it too)"}
_TIFF_FAX = (2, 3, 4)  # CCITT RLE, Group 3 and Group 4, in the library
_TIFF_COMPRESSIONS = (1, 2, 3, 4, 5, 7, 8, 32773, 32946, 34925, 50000)
# libtiff's predictor belongs to these codecs; PackBits, CCITT and
# uncompressed data ignore the tag.
_TIFF_PREDICTED = (5, 8, 32946, 34925, 50000)
# Orientation -> PIL's exif_transpose of the decoded image.
_TIFF_ORIENT = {
    2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
    5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, -1),
    7: lambda a: a[::-1, ::-1].transpose(1, 0, 2), 8: lambda a: np.rot90(a),
}
_YCBCR_SUBSAMPLING = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))


def _tiff_tags(data: bytes, name: str) -> tuple[str, dict]:
    """The byte order and the tags of the first IFD (values as tuples, the
    BYTE/ASCII/UNDEFINED ones as bytes); tags of unknown types or whose
    values lie past the end are left out, as PIL leaves them."""
    order = "<" if data[:2] == b"II" else ">"
    if len(data) < 8:
        raise ValueError(f"{name}: truncated TIFF header")
    (offset,) = struct.unpack_from(order + "I", data, 4)
    if offset + 2 > len(data):
        raise ValueError(f"{name}: truncated TIFF (no first IFD)")
    (count,) = struct.unpack_from(order + "H", data, offset)
    tags = {}
    for i in range(count):
        at = offset + 2 + 12 * i
        if at + 12 > len(data):
            raise ValueError(f"{name}: truncated TIFF IFD")
        tag, kind, n = struct.unpack_from(order + "HHI", data, at)
        code = _TIFF_TYPES.get(kind)
        if code is None:
            continue
        size = struct.calcsize(order + code) * n
        if size <= 4:
            raw = data[at + 8:at + 8 + size]
        else:
            (ptr,) = struct.unpack_from(order + "I", data, at + 8)
            raw = data[ptr:ptr + size]
            if len(raw) < size:
                continue
        tags[tag] = raw if kind in (1, 2, 7) else struct.unpack(f"{order}{n * len(code)}{code[0]}", raw)
    return order, tags


def _tiff_int(tags: dict, tag: int, default=None):
    value = tags.get(tag)
    if value is None:
        return default
    return value[0]


def _tiff_tuple(tags: dict, tag: int, default: tuple) -> tuple:
    value = tags.get(tag, default)
    return tuple(value) if isinstance(value, (bytes, tuple)) else (value,)


def _tiff_layout(order: str, tags: dict, name: str) -> dict:
    """The first IFD's image layout and its mode, or ValueError for what
    this codec (or PIL) does not read."""
    width, height = _tiff_int(tags, 256), _tiff_int(tags, 257)
    if width is None or height is None:
        raise ValueError(f"{name}: TIFF has no image size")
    compression = _tiff_int(tags, 259, 1)
    if compression in _TIFF_REFUSED:
        raise ValueError(f"{name}: {_TIFF_REFUSED[compression]} (compression {compression}) TIFF "
                         "is not supported")
    if compression not in _TIFF_COMPRESSIONS:
        raise ValueError(f"{name}: TIFF compression {compression} is not supported")
    photometric = _tiff_int(tags, 262, 0)
    spp = _tiff_int(tags, 277, 1)
    bps = _tiff_tuple(tags, 258, (1,))
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"{name}: TIFF has {len(bps)} bits-per-sample values for {spp} samples")
    sample_format = _tiff_tuple(tags, 339, (1,))
    if len(sample_format) > 1 and set(sample_format) == {1}:
        sample_format = (1,)
    extra = _tiff_tuple(tags, 338, ())
    mode = _TIFF_MODES.get((photometric, bps, extra))
    signed_grey = sample_format == (2,) and bps == (8,) and photometric == 1
    numeric = None
    if len(sample_format) == 1 and not extra and spp == 1:
        numeric = _TIFF_NUMERIC.get((order, photometric, sample_format[0], bps[0]))
    if numeric:
        mode = numeric[0]  # "I" or "F"
    elif mode is None or (sample_format != (1,) and not signed_grey) or (
            mode == "I;16" and (photometric == 0 and order == ">")):
        raise ValueError(f"{name}: TIFF of photometric {photometric}, {bps} bits per sample, extra "
                         f"samples {extra} and sample format {sample_format} is not supported")
    planar = _tiff_int(tags, 284, 1)
    if mode == "RGBA" and not extra and planar == 2 and compression != 1:
        mode = "RGBa"  # PIL reads these planes through libtiff as associated alpha
    predictor = _tiff_int(tags, 317, 1) if compression in _TIFF_PREDICTED else 1
    if not (predictor == 1 or (predictor == 2 and bps[0] in (8, 16, 32))
            or (predictor == 3 and mode == "F")):
        raise ValueError(f"{name}: TIFF predictor {predictor} over {bps[0]}-bit samples "
                         "is not supported")
    subsampling = _tiff_tuple(tags, 530, (2, 2))[:2]
    if mode == "YCbCr" and compression != 7:
        # PIL reads an uncompressed one with its own decoder, as raw "RGBX";
        # libtiff's RGBA interface reads the others.
        if planar != 1:
            raise ValueError(f"{name}: YCbCr TIFF in planar configuration {planar} is not supported")
        if compression != 1 and subsampling not in _YCBCR_SUBSAMPLING:
            raise ValueError(f"{name}: YCbCr subsampling {subsampling} is not supported")
        if compression != 1 and predictor != 1 and subsampling != (1, 1):
            raise ValueError(f"{name}: predictor {predictor} over subsampled YCbCr is not supported")
        mode = "YCbCr raw" if compression == 1 else "YCbCr RGBA"
    if mode == "YCbCr" and planar != 1:
        raise ValueError(f"{name}: YCbCr TIFF that is JPEG-compressed in planes is not supported")
    if compression == 7 and (planar != 1 or bps[0] != 8 or spp not in (1, 3)):
        raise ValueError(f"{name}: JPEG-compressed TIFF of {spp} samples of {bps[0]} bits "
                         f"in planar configuration {planar} is not supported")
    if compression in _TIFF_FAX and bps != (1,):
        raise ValueError(f"{name}: CCITT-compressed TIFF of {bps} bits per sample is not supported "
                         "(libtiff reads 1)")
    if len(set(bps)) != 1:
        raise ValueError(f"{name}: TIFF with bits per sample {bps} is not supported")
    if width * height > _MAX_PIXELS:
        raise ValueError(f"{name}: TIFF too large ({width} x {height})")
    if 322 in tags:
        tw, th = _tiff_int(tags, 322), _tiff_int(tags, 323)
        offsets, counts = tags.get(324), tags.get(325)
    else:
        tw, th = width, min(_tiff_int(tags, 278, 2**32 - 1), height)
        offsets, counts = tags.get(273), tags.get(279)
    if not tw or not th or offsets is None or counts is None or len(offsets) != len(counts):
        raise ValueError(f"{name}: TIFF has no valid strip or tile offsets")
    pil_bands = (3 if photometric in (2, 6, 8) else 4 if photometric == 5 else 1) + len(extra)
    return dict(width=width, height=height, compression=compression, photometric=photometric,
                mode=mode, bits=bps[0], spp=spp, planar=planar, predictor=predictor,
                pil_bands=pil_bands, numeric=numeric, subsampling=subsampling,
                t4options=_tiff_int(tags, 292, 0), orientation=_tiff_int(tags, 274, 1),
                pil_th=th if 322 in tags else _tiff_int(tags, 278, height),
                fill_order=_tiff_int(tags, 266, 1), tiled=322 in tags, tw=tw, th=th,
                offsets=offsets, counts=counts, order=order)


_XZ_MAGIC = b"\xfd7zXZ\x00"
# The filter chains libtiff's LZMA codec writes: Delta (0x03), then LZMA2
# (0x21); and LZMA2 alone.
_XZ_CHAINS = ([0x03, 0x21], [0x21])


def _xz_varint(raw: bytes, pos: int, name: str) -> tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(raw) or shift > 63:
            raise ValueError(f"{name}: corrupt xz block header in the TIFF")
        byte = raw[pos]
        value |= (byte & 0x7F) << shift
        pos, shift = pos + 1, shift + 7
        if byte < 0x80:
            return value, pos


def _tiff_xz(raw: bytes, size: int, name: str) -> bytes:
    """An LZMA (34925) strip or tile: the xz stream libtiff's codec writes.
    Its first block's filter chain must be one libtiff writes; the stream's check
    (none, CRC32, CRC64 or SHA-256) is verified by the standard library's
    liblzma, libtiff's own decoder."""
    import lzma  # optional in a Python build: only an LZMA TIFF needs it

    if not raw.startswith(_XZ_MAGIC) or len(raw) < 14:
        raise ValueError(f"{name}: LZMA-compressed TIFF strip is not an xz stream")
    if raw[12]:  # a block header (0 starts the index of an empty stream)
        header = raw[12:12 + 4 * (raw[12] + 1)]
        flags, pos, chain = header[1] if len(header) > 1 else 0, 2, []
        for present in (flags & 0x40, flags & 0x80):  # compressed and uncompressed sizes
            if present:
                _, pos = _xz_varint(header, pos, name)
        for _ in range((flags & 3) + 1):
            filter_id, pos = _xz_varint(header, pos, name)
            props, pos = _xz_varint(header, pos, name)
            chain.append(filter_id)
            pos += props
        if chain not in _XZ_CHAINS:
            raise ValueError(f"{name}: xz filter chain {[hex(f) for f in chain]} in the TIFF is not "
                             "supported (libtiff writes Delta then LZMA2, 0x3 and 0x21)")
    try:
        return lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(raw, size)
    except lzma.LZMAError as e:
        raise ValueError(f"{name}: corrupt LZMA data in the TIFF ({e})") from None


def _tiff_unpack(raw: bytes, compression: int, size: int, name: str) -> bytes:
    """A strip or tile's bytes, decompressed to ``size`` bytes."""
    if compression == 1:
        out = raw[:size]
    elif compression in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, size)
        except zlib.error as e:
            raise ValueError(f"{name}: corrupt Deflate data in the TIFF ({e})") from None
    elif compression == 34925:
        out = _tiff_xz(raw, size, name)
    else:
        buf = np.empty(size, np.uint8)
        got = ctypes.c_size_t()
        err = ctypes.create_string_buffer(_ERR_LEN)
        _check(_library().codec_tiff_unpack(raw, len(raw), compression, buf.ctypes.data, size,
                                            ctypes.byref(got), err, _ERR_LEN), err, name)
        out = buf[: got.value].tobytes()
    if len(out) < size:
        raise ValueError(f"{name}: not enough image data in a TIFF strip or tile")
    return out


_REVERSED_BITS = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _tiff_fax(raw: bytes, lay: dict, rows: int, cols: int, name: str) -> np.ndarray:
    """A CCITT strip or tile as (rows, stride) packed bits; a Group 4 strip
    that ends early keeps zero rows after the rows it holds."""
    out = np.zeros((rows, (cols + 7) // 8), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_library().codec_tiff_fax(raw, len(raw), lay["compression"], lay["t4options"], cols, rows,
                                     out.ctypes.data, err, _ERR_LEN), err, name)
    return out


def _unpredict_float(buf: np.ndarray, cols: int, spp: int) -> np.ndarray:
    """libtiff's floating-point predictor (3) undone over (rows, bytes) of
    32-bit samples: bytes summed along the row a sample apart, then the
    row's four byte planes, most significant first, put back together."""
    summed = np.cumsum(buf.reshape(buf.shape[0], -1, spp), axis=1, dtype=np.uint8)
    planes = summed.reshape(buf.shape[0], 4, cols * spp)
    return np.ascontiguousarray(planes.transpose(0, 2, 1)).view(">u4").reshape(-1, cols, spp)


def _tiff_block(data: bytes, lay: dict, index: int, rows: int, cols: int, spp: int,
                tables: bytes | None, name: str) -> np.ndarray:
    """Strip or tile ``index`` as (rows, cols, spp) samples: uint8, uint16
    or uint32 (native order, as the file's byte order reads them) or, under
    8 bits, one value per sample."""
    offset, count = lay["offsets"][index], lay["counts"][index]
    raw = data[offset:offset + count]
    if lay["fill_order"] == 2:
        raw = _REVERSED_BITS[np.frombuffer(raw, np.uint8)].tobytes()
    bits = lay["bits"]
    if lay["compression"] == 7:
        if tables and raw.startswith(b"\xff\xd8") and tables.endswith(b"\xff\xd9"):
            raw = tables[:-2] + raw[2:]
        rgb = _decode_jpeg(raw, name, {2: 1, 6: 0}.get(lay["photometric"], -1))
        if rgb.shape[0] < rows or rgb.shape[1] < cols:
            raise ValueError(f"{name}: a TIFF JPEG strip or tile is smaller than its layout")
        return rgb[:rows, :cols, :spp]
    stride = (cols * spp * bits + 7) // 8
    if lay["compression"] in _TIFF_FAX:
        buf = _tiff_fax(raw, lay, rows, cols, name)
    else:
        buf = np.frombuffer(_tiff_unpack(raw, lay["compression"], stride * rows, name), np.uint8)
        buf = buf.reshape(rows, stride)
    if bits < 8:
        values = np.unpackbits(buf, axis=1)[:, : cols * spp * bits].reshape(rows, cols * spp, bits)
        values = (values << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)
        return values.reshape(rows, cols, spp)
    if lay["predictor"] == 3:
        return _unpredict_float(buf, cols, spp).astype(np.uint32)
    if bits in (16, 32):
        kind = np.uint16 if bits == 16 else np.uint32
        values = buf.view(f"{lay['order']}u{bits // 8}").astype(kind).reshape(rows, cols, spp)
    else:
        values = buf.reshape(rows, cols, spp)
    if lay["predictor"] == 2:  # horizontal differencing, per sample
        values = np.cumsum(values, axis=1, dtype=values.dtype)
    return values


def _pil_raw_plane(data: bytes, lay: dict, index: int, x0: int, rows: int, cols: int,
                   name: str) -> np.ndarray:
    """One plane of an uncompressed planar strip or tile as PIL's own raw
    decoder reads it (PIL reads uncompressed files without libtiff): one
    byte a sample whatever the depth, rows back to back, except in a tile
    past the right edge, whose rows step by the tile's bytes a row over
    PIL's count of bands (its photometric's bands and the extra samples)."""
    tw = lay["tw"]
    step = cols
    if x0 + tw > lay["width"]:
        step = int(tw * lay["bits"] * lay["spp"] / 8 / lay["pil_bands"])
    offset, need = lay["offsets"][index], (rows - 1) * step + cols
    raw = np.frombuffer(data[offset:offset + need], np.uint8)
    if len(raw) < need:
        raise ValueError(f"{name}: truncated TIFF strip or tile")
    return np.lib.stride_tricks.as_strided(raw, (rows, cols), (step, 1))


def _tiff_samples(data: bytes, lay: dict, tables: bytes | None, name: str) -> np.ndarray:
    """The image's (height, width, samples) array, from its strips or tiles."""
    width, height, spp = lay["width"], lay["height"], lay["spp"]
    planes = spp if lay["planar"] == 2 else 1
    per_block = 1 if planes > 1 else spp
    tw, th = lay["tw"], lay["th"]
    across, down = (width + tw - 1) // tw, (height + th - 1) // th
    if len(lay["offsets"]) < planes * across * down:
        raise ValueError(f"{name}: TIFF has {len(lay['offsets'])} strips or tiles for "
                         f"{planes * across * down}")
    dtype = {16: np.uint16, 32: np.uint32}.get(lay["bits"], np.uint8)
    out = np.zeros((height, width, spp), dtype)
    for plane in range(planes):
        for ty in range(down):
            for tx in range(across):
                index = (plane * down + ty) * across + tx
                y0, x0 = ty * th, tx * tw
                rows = th if lay["tiled"] else min(th, height - y0)
                h, w = min(th, height - y0), min(tw, width - x0)
                if planes > 1 and lay["compression"] == 1:
                    out[y0:y0 + h, x0:x0 + w, plane] = _pil_raw_plane(data, lay, index, x0, h, w, name)
                    continue
                block = _tiff_block(data, lay, index, rows, tw, per_block, tables, name)
                channels = slice(plane, plane + 1) if planes > 1 else slice(None)
                out[y0:y0 + h, x0:x0 + w, channels] = block[:h, :w]
    return out


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def _tiff_rgb(samples: np.ndarray, lay: dict, tags: dict, name: str) -> np.ndarray:
    """PIL's convert("RGB") of the samples in the layout's mode."""
    mode, bits = lay["mode"], lay["bits"]
    if lay["numeric"]:
        if lay["compression"] != 1 and "B" in lay["numeric"]:
            # libtiff hands PIL native (little-endian) samples, which its
            # big-endian raw mode then reads byte-swapped.
            samples = samples.byteswap()
        if mode == "F":  # PIL's F -> L: clipped to 0..255 (NaN to 0), truncated
            grey = np.clip(np.nan_to_num(samples.view(np.float32)[..., 0]), 0, 255)
        else:  # "I": clipped
            v = samples.view(np.int16 if bits == 16 else np.int32)[..., 0]
            grey = np.clip(v, 0, 255)
        return np.repeat(grey.astype(np.uint8)[..., None], 3, axis=2)
    s = samples.astype(np.int64)
    if bits == 16 and lay["planar"] == 2 and lay["compression"] == 1:
        bits = 8  # PIL's raw decoder read one byte a sample (_pil_raw_plane)
    elif bits == 16:
        s = s if mode == "I;16" else s >> 8  # PIL's RGB;16 and CMYK;16 keep the high byte
    if mode in ("1;I", "1"):
        grey = np.where((s[..., 0] != 0) == (mode == "1"), 255, 0)
    elif mode in ("L", "L;I", "LA"):
        grey = s[..., 0] * (255 // ((1 << bits) - 1))
        grey = 255 - grey if mode == "L;I" else grey
    elif mode == "I;16":
        grey = np.minimum(s[..., 0], 255)  # PIL's I;16 -> L clips
    elif mode == "P":
        colormap = tags.get(320)
        if colormap is None:
            raise ValueError(f"{name}: palette TIFF has no colour map")
        planes = np.asarray(colormap, np.int64).reshape(3, -1) // 256
        palette = np.zeros((256, 3), np.int64)
        palette[: planes.shape[1]] = planes.T[:256]
        return palette[s[..., 0]].astype(np.uint8)
    elif mode in ("RGB", "RGBA", "YCbCr"):
        return s[..., :3].astype(np.uint8)
    elif mode == "RGBa":  # associated alpha: PIL's unpacker divides it out
        a = s[..., 3:4]
        rgb = np.where(a == 0, 0, np.minimum(s[..., :3] * 255 // np.maximum(a, 1), 255))
        return np.where(a == 255, s[..., :3], rgb).astype(np.uint8)
    else:  # CMYK: PIL's cmyk2rgb
        nk = 255 - s[..., 3:4]
        return np.clip(nk - _muldiv255(s[..., :3], nk), 0, 255).astype(np.uint8)
    return np.repeat(grey.astype(np.uint8)[..., None], 3, axis=2)


def _tiff_ycbcr_raw(data: bytes, lay: dict, name: str) -> np.ndarray:
    """An uncompressed YCbCr TIFF as PIL's raw decoder reads it, with raw
    mode "RGBX": each strip or tile read from its offset, four bytes a
    pixel of which the first three are kept, a row of four bytes a pixel
    (or, for a tile past the right edge, of the tile's bytes) whatever
    the strip holds, so the rows run on past it into the rest of the file."""
    width, height, w, h = lay["width"], lay["height"], lay["tw"], lay["pil_th"]
    offsets = list(lay["offsets"])
    if w == width and h == height:
        offsets = offsets[-1:]
    out = np.zeros((height, width, 3), np.uint8)
    x = y = 0
    for offset in offsets:
        cols, rows = min(x + w, width) - x, min(y + h, height) - y
        line = 4 * cols
        step = 3 * w if x + w > width else line
        if step < line:
            raise ValueError(f"{name}: YCbCr TIFF tile rows shorter than PIL reads them")
        need = (rows - 1) * step + line
        if offset + need > len(data):
            raise ValueError(f"{name}: truncated TIFF (an uncompressed YCbCr strip or tile is read "
                             "as four bytes a pixel)")
        raw = np.frombuffer(data, np.uint8, need, offset)
        out[y:y + rows, x:x + cols] = np.lib.stride_tricks.as_strided(raw, (rows, cols, 3),
                                                                        (step, 4, 1))
        x += w
        if x >= width:
            x, y = 0, y + h
            if y >= height:
                y = 0
    return out


def _tiff_rationals(tags: dict, tag: int, count: int, default: tuple) -> np.ndarray:
    value = tags.get(tag)
    if value is None or len(value) < 2 * count:
        return np.asarray(default, np.float32)
    return np.asarray([value[2 * i] / value[2 * i + 1] if value[2 * i + 1] else 0.0
                       for i in range(count)], np.float64).astype(np.float32)


def _ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, tags: dict,
                  name: str) -> np.ndarray:
    """libtiff's TIFFYCbCrToRGBInit tables and TIFFYCbCrtoRGB (tif_color.c):
    float32 coefficients, 16 fraction bits, over the YCbCrCoefficients and
    ReferenceBlackWhite tags (defaults 0.299, 0.587, 0.114 and 0, 255,
    128, 255, 128, 255)."""
    f32 = np.float32
    lr, lg, lb = _tiff_rationals(tags, 529, 3, (0.299, 0.587, 0.114))
    rbw = _tiff_rationals(tags, 532, 6, (0, 255, 128, 255, 128, 255))
    if np.isnan([lr, lg, lb]).any() or lg == 0 or np.isnan(rbw).any():
        raise ValueError(f"{name}: invalid YCbCrCoefficients or ReferenceBlackWhite in the TIFF")

    def fix(v):  # FIX(CLAMP(v, 0, 2))
        v = f32(0) if not v >= 0 else f32(2) if v > 2 else v
        return int(float(f32(v * f32(65536))) + 0.5)

    f1 = f32(f32(2) - f32(2) * lr)
    f3 = f32(f32(2) - f32(2) * lb)
    d1, d2 = fix(f1), -fix(f32(f32(lr * f1) / lg))
    d3, d4 = fix(f3), -fix(f32(f32(lb * f3) / lg))
    x = np.arange(-128, 128)

    def code2v(c, black, white, scale):  # Code2V, clamped to +-4096, truncated
        span = f32(white - black)
        v = (c - np.trunc(black)).astype(f32) * f32(scale) / (span if span != 0 else f32(1))
        return np.trunc(np.clip(v.astype(f32), -4096, 4096)).astype(np.int64)

    cr_v = code2v(x, f32(rbw[4] - f32(128)), f32(rbw[5] - f32(128)), 127)
    cb_v = code2v(x, f32(rbw[2] - f32(128)), f32(rbw[3] - f32(128)), 127)
    y_tab = code2v(x + 128, rbw[0], rbw[1], 255)
    cr_r, cb_b = (d1 * cr_v + 32768) >> 16, (d3 * cb_v + 32768) >> 16
    cr_g, cb_g = d2 * cr_v, d4 * cb_v + 32768
    yv = y_tab[y]
    rgb = np.stack([yv + cr_r[cr], yv + ((cb_g[cb] + cr_g[cr]) >> 16), yv + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _tiff_ycbcr_rgba(data: bytes, lay: dict, tags: dict, name: str) -> np.ndarray:
    """A compressed YCbCr TIFF as PIL reads it, through libtiff's RGBA
    interface (tif_getimage.c): each strip or tile's sampling blocks (sh x
    sv lumas, then Cb and Cr) spread over their pixels and converted as
    libtiff converts them.  As libtiff reads them: a strip decodes only
    its rows times TIFFScanlineSize bytes, a sampling row over sv rounded
    down (the bytes past that are zero), and a tile clipped at the right
    edge steps past its hidden blocks ten bytes a block under 4 x 4
    subsampling (putcontig8bitYCbCr44tile's skew)."""
    width, height, tw, th = lay["width"], lay["height"], lay["tw"], lay["th"]
    sh, sv = lay["subsampling"]
    bs = sh * sv + 2
    across, down = (width + tw - 1) // tw, (height + th - 1) // th
    if len(lay["offsets"]) < across * down:
        raise ValueError(f"{name}: TIFF has {len(lay['offsets'])} strips or tiles for {across * down}")
    out = np.zeros((height, width, 3), np.uint8)
    for ty in range(down):
        y0 = ty * th
        band = min(th, height - y0)
        for tx in range(across):
            x0 = tx * tw
            rows = th if lay["tiled"] else band
            stored_across = -(-tw // sh)
            size = -(-rows // sv) * stored_across * bs
            read = size if lay["tiled"] else min(size, -(-rows // sv) * sv * (stored_across * bs // sv))
            offset, count = lay["offsets"][ty * across + tx], lay["counts"][ty * across + tx]
            raw = data[offset:offset + count]
            if lay["fill_order"] == 2:
                raw = _REVERSED_BITS[np.frombuffer(raw, np.uint8)].tobytes()
            flat = np.zeros(size, np.uint8)
            flat[:read] = np.frombuffer(_tiff_unpack(raw, lay["compression"], read, name), np.uint8, read)
            if lay["predictor"] == 2:  # (1, 1) only: three samples a pixel
                flat = np.cumsum(flat.reshape(rows, tw, 3), axis=1, dtype=np.uint8).reshape(-1)
            w = min(tw, width - x0)
            shown = -(-w // sh)
            skip = (tw - w) // sh * (10 if (sh, sv) == (4, 4) else bs)
            blocks = np.lib.stride_tricks.as_strided(flat, (-(-band // sv), shown, bs),
                                                     (shown * bs + skip, bs, 1))
            luma = blocks[..., : sh * sv].reshape(blocks.shape[0], shown, sv, sh)
            luma = luma.transpose(0, 2, 1, 3).reshape(blocks.shape[0] * sv, shown * sh)
            chroma = [np.repeat(np.repeat(blocks[..., sh * sv + k], sv, 0), sh, 1) for k in (0, 1)]
            out[y0:y0 + band, x0:x0 + w] = _ycbcr_to_rgb(luma[:band, :w], chroma[0][:band, :w],
                                                         chroma[1][:band, :w], tags, name)
    return out


def _decode_tiff(data: bytes, name: str) -> np.ndarray:
    order, tags = _tiff_tags(data, name)
    lay = _tiff_layout(order, tags, name)
    if lay["mode"] == "YCbCr raw":
        rgb = _tiff_ycbcr_raw(data, lay, name)
    elif lay["mode"] == "YCbCr RGBA":
        rgb = _tiff_ycbcr_rgba(data, lay, tags, name)
    else:
        tables = tags.get(347)
        samples = _tiff_samples(data, lay, bytes(tables) if tables else None, name)
        rgb = _tiff_rgb(samples, lay, tags, name)
    transpose = _TIFF_ORIENT.get(lay["orientation"])
    return np.ascontiguousarray(transpose(rgb)) if transpose else rgb


# --------------------------------------------------------------- WebP

def _riff_chunks(data: bytes, pos: int, end: int, name: str):
    """(fourcc, payload) of the RIFF chunks in data[pos:end]."""
    while pos + 8 <= end:
        kind = data[pos:pos + 4]
        (n,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8:pos + 8 + n]
        if len(body) < n:
            raise ValueError(f"{name}: truncated WebP chunk {kind!r}")
        yield kind, body
        pos += 8 + n + (n & 1)


def _webp_bitstream_size(kind: bytes, body: bytes, name: str) -> tuple[int, int]:
    if kind == b"VP8 ":
        if len(body) < 10:
            raise ValueError(f"{name}: truncated VP8 frame header")
        w, h = struct.unpack_from("<HH", body, 6)
        return w & 0x3FFF, h & 0x3FFF
    if len(body) < 5 or body[0] != 0x2F:
        raise ValueError(f"{name}: bad VP8L header")
    bits = int.from_bytes(body[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


def _webp_image(chunks, name: str) -> tuple[bytes, bytes]:
    """The first VP8 or VP8L chunk; an ALPH chunk before it is skipped."""
    for kind, body in chunks:
        if kind in (b"VP8 ", b"VP8L"):
            return kind, body
    raise ValueError(f"{name}: WebP has no image data")


def _decode_webp_bitstream(kind: bytes, body: bytes, name: str) -> np.ndarray:
    w, h = _webp_bitstream_size(kind, body, name)
    if w * h > _MAX_PIXELS:
        raise ValueError(f"{name}: WebP too large ({w} x {h})")
    out = np.empty((h, w, 3), np.uint8)
    fn = _library().codec_vp8_decode if kind == b"VP8 " else _library().codec_vp8l_decode
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(fn(body, len(body), out.ctypes.data, w, h, err, _ERR_LEN), err, name)
    return out


def _webp_layout(data: bytes, name: str) -> dict:
    """The canvas, and the first image's bitstream and place on it."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError(f"{name}: {_NOT_DECODED}")
    end = min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
    chunks = list(_riff_chunks(data, 12, end, name))
    if not chunks:
        raise ValueError(f"{name}: WebP has no chunks")
    kind, body = chunks[0]
    if kind in (b"VP8 ", b"VP8L"):
        w, h = _webp_bitstream_size(kind, body, name)
        return dict(size=(w, h), image=(kind, body), at=(0, 0))
    if kind != b"VP8X" or len(body) < 10:
        raise ValueError(f"{name}: WebP does not start with a VP8, VP8L or VP8X chunk")
    size = (1 + int.from_bytes(body[4:7], "little"), 1 + int.from_bytes(body[7:10], "little"))
    if not body[0] & 2:  # a still image
        return dict(size=size, image=_webp_image(chunks[1:], name), at=(0, 0))
    for kind, frame in chunks[1:]:
        if kind == b"ANMF":
            if len(frame) < 16:
                raise ValueError(f"{name}: truncated WebP ANMF chunk")
            at = (2 * int.from_bytes(frame[0:3], "little"), 2 * int.from_bytes(frame[3:6], "little"))
            image = _webp_image(_riff_chunks(frame, 16, len(frame), name), name)
            return dict(size=size, image=image, at=at)
    raise ValueError(f"{name}: animated WebP has no frame")


def _decode_webp(data: bytes, name: str) -> np.ndarray:
    lay = _webp_layout(data, name)
    (width, height), (x0, y0) = lay["size"], lay["at"]
    image = _decode_webp_bitstream(*lay["image"], name)
    h, w = image.shape[:2]
    if x0 + w > width or y0 + h > height:
        raise ValueError(f"{name}: WebP frame lies outside its canvas")
    if (x0, y0, w, h) == (0, 0, width, height):
        return image
    canvas = np.zeros((height, width, 3), np.uint8)  # WebPAnimDecoder's transparent black
    canvas[y0:y0 + h, x0:x0 + w] = image
    return canvas


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An encoded JPEG, PNG, BMP, GIF, TIFF or WebP image as an (H, W, 3)
    uint8 RGB array; ``name`` labels the errors."""
    if data.startswith(_JPEG_MAGIC):
        return _decode_jpeg(data, name)
    if data.startswith(_PNG_MAGIC):
        return _decode_png(data, name)
    if data.startswith(_BMP_MAGIC):
        return _decode_bmp(data, name)
    if data.startswith(_GIF_MAGIC):
        return _decode_gif(data, name)
    if data.startswith(_TIFF_MAGIC):
        return _decode_tiff(data, name)
    if data.startswith(b"RIFF") and data[8:12] == b"WEBP":
        return _decode_webp(data, name)
    raise ValueError(f"{name}: {_NOT_DECODED}")


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
    """``(width, height)`` of the image at ``path``, from its headers only
    (PIL's ``Image.open(path).size``; a GIF's screen grown to hold its
    first frame, a WebP's canvas)."""
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
        if head.startswith(_GIF_MAGIC + _TIFF_MAGIC + (b"RIFF",)):
            f.seek(0)
            data = f.read()
            if data.startswith(_GIF_MAGIC):
                return _gif_frame(data, name)["size"]
            if data.startswith(_TIFF_MAGIC):
                _, tags = _tiff_tags(data, name)
                width, height = _tiff_int(tags, 256), _tiff_int(tags, 257)
                if width is None or height is None:
                    raise ValueError(f"{name}: TIFF has no image size")
                # PIL swaps the size of a file whose rows are its columns.
                return (height, width) if _tiff_int(tags, 274, 1) in (5, 6, 7, 8) else (width, height)
            return _webp_layout(data, name)["size"]
    raise ValueError(f"{name}: {_NOT_DECODED}")


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
