"""Writes the TIFF fixtures of this folder and ``digests.json``, from
seeded scenes:

    python tests/fixtures/formats_tiff/make_fixtures.py

CCITT fax (RLE, Group 3 in one and two dimensions with fill bits, Group
4), LZMA and Zstandard strips, float and signed grey samples, the eight
orientations, and YCbCr that is not JPEG-compressed.  What PIL writes, it
writes; the rest is built with ``formats_more/make_fixtures.py``'s
``tiff``, whose LZMA, Zstandard and fax data is libtiff's own, taken from
a file PIL wrote of each strip or tile (``pil_codec``): tiles, either byte
order, fill order 2, predictors 2 and 3, rows shorter or longer than the
width, YCbCr sampling blocks.  The JSON holds each file's PIL size and the
shape and sha256 of its pixels as PIL decodes them
(``np.asarray(Image.open(f).convert("RGB"))``), for machines without PIL.
"""

import hashlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("format_more_fixtures", HERE.parent / "formats_more" / "make_fixtures.py")
more = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(more)
tiff, scene, flat_scene = more.tiff, more.scene, more.flat_scene


def save(img, **options) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **options)
    return buf.getvalue()


def fax_page(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w) 0/1 of text-like strokes: runs short and long, rows alike."""
    rng = np.random.default_rng(seed)
    page = np.zeros((h, w), np.uint8)
    for _ in range(h * w // 400 + 1):
        y, x = rng.integers(0, h), rng.integers(0, w)
        page[y:y + rng.integers(1, 12), x:x + rng.integers(1, 40)] = 1
    return page


def fixtures():
    """(name, bytes) of every fixture."""
    from PIL import Image

    big = flat_scene(480, 640)
    yield "tiff_640x480_ccitt_g4.tif", save(Image.fromarray(fax_page(480, 640, 0).astype(bool)),
                                            compression="group4")
    yield "tiff_640x480_zstd.tif", save(Image.fromarray(big), compression="zstd", tiffinfo={317: 2})
    # CCITT: PIL's strips, then built ones.
    page = fax_page(37, 61, 1)
    yield "tiff_ccitt_rle.tif", save(Image.fromarray(page.astype(bool)), compression="tiff_ccitt")
    yield "tiff_ccitt_g3_1d.tif", save(Image.fromarray(page.astype(bool)), compression="group3")
    yield "tiff_ccitt_g3_2d_fill.tif", save(Image.fromarray(page.astype(bool)), compression="group3",
                                            tiffinfo={292: 5})
    yield "tiff_ccitt_g4_wide.tif", save(Image.fromarray(fax_page(9, 2700, 2).astype(bool)),
                                         compression="group4")
    yield "tiff_ccitt_g4_tiles_be.tif", tiff(page, 0, 1, order=">", compression=4, tile=(32, 16))
    yield "tiff_ccitt_g3_2d_fill_order2_minisblack.tif", tiff(page, 1, 1, compression=3, t4options=1,
                                                               fill_order=2, rows_per_strip=10)
    yield "tiff_ccitt_rle_strips_be.tif", tiff(page, 0, 1, order=">", compression=2, rows_per_strip=8)
    # The width tag 5 more or 3 less than the coded rows: libtiff finishes a
    # short row in white and cuts a long one.
    yield "tiff_ccitt_g3_short_rows.tif", tiff(page, 0, 1, compression=3, more_tags={256: (4, [66])})
    yield "tiff_ccitt_g3_long_rows.tif", tiff(page, 0, 1, compression=3, more_tags={256: (4, [58])})
    yield "tiff_ccitt_rle_long_rows.tif", tiff(page, 0, 1, compression=2, more_tags={256: (4, [58])})
    # LZMA and Zstandard.
    rgb = scene(110, 21, 29).astype(np.uint8)
    grey = scene(111, 23, 31, 1)[..., 0].astype(np.uint8)
    yield "tiff_rgb_lzma.tif", save(Image.fromarray(rgb), compression="lzma")
    yield "tiff_grey_lzma_tiles_be_predictor.tif", tiff(grey, 1, order=">", compression=34925,
                                                        predictor=2, tile=(16, 16))
    yield "tiff_rgb_zstd.tif", save(Image.fromarray(rgb), compression="zstd")
    yield "tiff_rgb16_zstd_tiles_be.tif", tiff(scene(112, 17, 19, 3, 65535), 2, 16, order=">",
                                               compression=50000, tile=(16, 16))
    yield "tiff_rgb_zstd_planar_strips.tif", tiff(rgb, 2, compression=50000, planar=2, rows_per_strip=8)
    # Float and signed grey.
    values = scene(113, 19, 23, 1)[..., 0].astype(np.float32) * 1.3 - 40.5
    values[0, :3] = (np.nan, np.inf, -np.inf)
    yield "tiff_float32_le.tif", save(Image.fromarray(values, "F"))
    yield "tiff_float32_le_lzw_predictor3.tif", tiff(values, 1, 32, compression=5, predictor=3,
                                                     sample_format=3, rows_per_strip=7)
    yield "tiff_float32_be_deflate_predictor3.tif", tiff(values, 0, 32, order=">", compression=8,
                                                         predictor=3, sample_format=3)
    yield "tiff_float32_be_raw_tiles.tif", tiff(values, 1, 32, order=">", sample_format=3, tile=(16, 16))
    yield "tiff_float32_zstd.tif", save(Image.fromarray(values, "F"), compression="zstd")
    ints = (scene(114, 19, 23, 1)[..., 0] * 1.5 - 60).astype(np.int32)
    yield "tiff_int16_le_lzw.tif", tiff(ints.astype(np.int16), 1, 16, compression=5, sample_format=2)
    yield "tiff_int16_be_raw.tif", tiff(ints.astype(np.int16), 1, 16, order=">", sample_format=2)
    yield "tiff_int16_be_zstd_predictor.tif", tiff(ints.astype(np.int16), 1, 16, order=">",
                                                   compression=50000, predictor=2, sample_format=2)
    yield "tiff_int32_lzma.tif", save(Image.fromarray(ints, "I"), compression="lzma")
    yield "tiff_int32_be_lzw_predictor.tif", tiff(ints, 1, 32, order=">", compression=5, predictor=2,
                                                  sample_format=2)
    yield "tiff_uint32_le.tif", tiff(ints.clip(0).astype(np.uint32), 1, 32)
    # Orientations: PIL returns the image transposed, 5-8 with the size swapped.
    small = scene(115, 11, 17).astype(np.uint8)
    for o in range(2, 9):
        compression = (1, 5, 8, 50000, 34925, 32773, 1)[o - 2]
        yield f"tiff_orientation{o}.tif", tiff(small, 2, compression=compression, rows_per_strip=4,
                                               more_tags={274: (3, [o])})
    yield "tiff_orientation6_ccitt_g4.tif", tiff(page, 0, 1, compression=4, more_tags={274: (3, [6])})
    # YCbCr that is not JPEG-compressed.
    ycc = scene(116, 21, 29).astype(np.uint8)
    yield "tiff_ycbcr_raw.tif", tiff(ycc, 6, rows_per_strip=8, more_tags={530: (3, [1, 1])})
    yield "tiff_ycbcr_lzw_22.tif", tiff(ycc, 6, compression=5, subsampling=(2, 2), rows_per_strip=6)
    yield "tiff_ycbcr_deflate_44_tiles.tif", tiff(ycc, 6, compression=8, subsampling=(4, 4), tile=(16, 16))
    yield "tiff_ycbcr_zstd_44_strips.tif", tiff(ycc, 6, compression=50000, subsampling=(4, 4),
                                                rows_per_strip=8)
    yield "tiff_ycbcr_packbits_21_coefficients.tif", tiff(
        ycc, 6, compression=32773, subsampling=(2, 1), more_tags={
            529: (5, [2126, 10000, 7152, 10000, 722, 10000]),
            532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])})
    yield "tiff_ycbcr_lzma_11_predictor_orientation8.tif", tiff(
        ycc, 6, compression=34925, subsampling=(1, 1), predictor=2, more_tags={274: (3, [8])})


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
