"""The port's OpenCV-free image reading and writing against OpenCV.

- The JPEG decoder equals ``cv2.imdecode`` bit for bit on files that
  OpenCV writes: 4:2:0, 4:2:2 and 4:4:4 chroma, gray, qualities 50 to 100,
  a restart interval, and sizes that are no multiple of 16, read in color
  and in gray.
- The port's JPEG encoder writes files that OpenCV decodes to the same
  arrays as the port does, close to the source (mean error within 4 codes
  at quality 95, as OpenCV's own encoder of the same image is).
- The PNG reader equals ``cv2.imread`` bit for bit on gray, BGR, BGRA and
  palette files, in color and in gray, and on files whose rows use each of
  the five filter types; the PNG writers round-trip through OpenCV.
- The BMP reader equals ``cv2.imdecode`` bit for bit, in color and in gray,
  on the files ``cv2.imencode('.bmp', ...)`` writes (24-bit, and 8-bit
  with a gray palette) and on uncompressed 32-bit, top-down and color
  palette files built here; RLE and bit-field files raise.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from osvos_torch.data import image_io
from osvos_torch.data.synthetic import _frame

SIZES = [(33, 49), (17, 29), (96, 160), (8, 8)]


def _image(hw, seed=2):
    img, _ = _frame(*hw, t=0.3, seed=seed)
    return img


def _check_decode(img, params):
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    for gray in (False, True):
        want = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        got = image_io.decode_jpeg(buf.tobytes(), gray)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", [50, 75, 90, 100])
@pytest.mark.parametrize("hw", SIZES)
def test_jpeg_decoder_equals_opencv_420(hw, quality):
    _check_decode(_image(hw), [cv2.IMWRITE_JPEG_QUALITY, quality])


@pytest.mark.parametrize("sampling", ["444", "422"])
@pytest.mark.parametrize("hw", SIZES)
def test_jpeg_decoder_equals_opencv_other_sampling(hw, sampling):
    factor = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
              "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422}[sampling]
    _check_decode(_image(hw), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
                               cv2.IMWRITE_JPEG_QUALITY, 85])


@pytest.mark.parametrize("hw", SIZES)
def test_jpeg_decoder_equals_opencv_gray_and_restarts(hw):
    img = _image(hw)
    _check_decode(np.ascontiguousarray(img[..., 1]), [cv2.IMWRITE_JPEG_QUALITY, 90])
    _check_decode(img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])


def test_jpeg_decoder_at_davis_size_with_noise():
    """480x854 (no multiple of 16 across) with noise: many AC symbols."""
    rng = np.random.RandomState(0)
    img = np.clip(_image((480, 854)).astype(int) + rng.randint(-20, 20, (480, 854, 3)),
                  0, 255).astype(np.uint8)
    _check_decode(img, [cv2.IMWRITE_JPEG_QUALITY, 95])


def test_jpeg_decoder_refuses_progressive():
    ok, buf = cv2.imencode(".jpg", _image((33, 49)), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive"):
        image_io.decode_jpeg(buf.tobytes())


@pytest.mark.parametrize("hw", SIZES + [(480, 854)])
def test_jpeg_encoder_decodes_the_same_in_opencv(hw):
    img = _image(hw)
    blob = image_io.encode_jpeg(img, 95)
    want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    got = image_io.decode_jpeg(blob)
    np.testing.assert_array_equal(got, want)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    theirs = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    ours_err = np.abs(got.astype(int) - img).mean()
    theirs_err = np.abs(theirs.astype(int) - img).mean()
    assert ours_err <= max(4.0, 1.5 * theirs_err), (ours_err, theirs_err)


def _png_with_filters(img: np.ndarray) -> bytes:
    """An 8-bit PNG of (H, W) or (H, W, 3) RGB ``img`` whose row y uses
    filter type y % 5."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch).astype(np.int64)
    out = []
    prior = np.zeros(w * ch, np.int64)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), prior[:-ch]])
        ftype = y % 5
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        out.append(bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if ch == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


def _check_png(path):
    for gray in (False, True):
        want = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        got = image_io.imread(path, gray=gray)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra", "palette"])
@pytest.mark.parametrize("hw", [(33, 49), (96, 160)])
def test_png_reader_equals_opencv(tmp_path, hw, kind):
    img, mask = _frame(*hw, t=0.6, seed=5)
    path = str(tmp_path / f"{kind}.png")
    if kind == "palette":
        from PIL import Image

        Image.fromarray(img[..., ::-1]).quantize(200).save(path)
    else:
        arr = {"gray": mask, "bgr": img,
               "bgra": np.concatenate([img, mask[..., None]], axis=-1)}[kind]
        assert cv2.imwrite(path, arr)
    _check_png(path)


@pytest.mark.parametrize("channels", [1, 3])
def test_png_reader_undoes_every_filter_type(tmp_path, channels):
    rng = np.random.RandomState(channels)
    img = rng.randint(0, 256, (23, 31) if channels == 1 else (23, 31, 3)).astype(np.uint8)
    path = str(tmp_path / "filters.png")
    with open(path, "wb") as f:
        f.write(_png_with_filters(img))
    _check_png(path)
    want = img if channels == 1 else img[..., ::-1]
    np.testing.assert_array_equal(image_io.imread(path), want if channels == 3
                                  else np.repeat(img[..., None], 3, axis=2))


def test_png_writers_round_trip_through_opencv(tmp_path):
    img, mask = _frame(33, 49, t=0.1, seed=3)
    image_io.write_png_rgb(str(tmp_path / "rgb.png"), img[..., ::-1])
    image_io.write_png_gray(str(tmp_path / "g.png"), mask)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "rgb.png")), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "g.png"), 0), mask)


def test_gray_png_writer_refuses_other_shapes(tmp_path):
    path = tmp_path / "mask.png"
    with pytest.raises(ValueError, match="expected an"):
        image_io.write_png_gray(str(path), np.zeros((4, 5, 3), np.uint8))
    assert not path.exists()


def test_imread_chooses_by_magic_bytes_and_refuses_others(tmp_path):
    img = _image((17, 29))
    path = str(tmp_path / "frame.png")  # a JPEG under a PNG name
    with open(path, "wb") as f:
        f.write(image_io.encode_jpeg(img))
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))
    bmp = str(tmp_path / "frame.jpg")  # a BMP under a JPEG name
    assert cv2.imwrite(str(tmp_path / "x.bmp"), img)
    os.replace(str(tmp_path / "x.bmp"), bmp)
    np.testing.assert_array_equal(image_io.imread(bmp), cv2.imread(bmp))
    bad = str(tmp_path / "x.gif")
    with open(bad, "wb") as f:
        f.write(b"GIF89a" + bytes(32))
    with pytest.raises(ValueError, match="not a JPEG, PNG or BMP"):
        image_io.imread(bad)
    assert os.path.exists(bad)


def _bmp(img, bpp, top_down=False, palette=None, compression=0):
    """An uncompressed BMP (BITMAPINFOHEADER) of ``img``'s rows: (H, W, 3 or
    4) BGR(A) bytes at 24 or 32 bits, or (H, W) palette indexes at 8."""
    h, w = img.shape[:2]
    stride = (w * bpp // 8 + 3) & ~3
    order = range(h) if top_down else range(h - 1, -1, -1)
    pixels = b"".join(img[r].tobytes().ljust(stride, b"\0") for r in order)
    table = b"" if palette is None else palette.tobytes()
    offset = 14 + 40 + len(table)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
            + struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp,
                          compression, len(pixels), 2835, 2835,
                          0 if palette is None else len(palette), 0)
            + table + pixels)


def _check_bmp(data):
    for gray in (False, True):
        want = cv2.imdecode(np.frombuffer(data, np.uint8),
                            cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        got = image_io.imdecode(data, gray)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("hw", [(33, 49), (17, 29), (8, 8)])
def test_bmp_reader_equals_opencv_on_its_files(hw, channels):
    """cv2.imencode('.bmp') writes 24-bit BGR and 8-bit gray-palette files
    (rows padded to 4 bytes, bottom-up)."""
    img = _image(hw)
    if channels == 1:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    ok, buf = cv2.imencode(".bmp", img)
    assert ok
    _check_bmp(buf.tobytes())


@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("kind", ["bgr24", "bgrx32", "palette8"])
def test_bmp_reader_equals_opencv_on_other_layouts(kind, top_down):
    """32-bit pixels (the fourth byte dropped), top-down rows and a color
    palette of 40 entries, gray made entry by entry as OpenCV makes it."""
    rng = np.random.RandomState(7)
    if kind == "palette8":
        palette = np.concatenate([rng.randint(0, 256, (40, 3)),
                                  np.zeros((40, 1))], 1).astype(np.uint8)
        data = _bmp(rng.randint(0, 40, (13, 21)).astype(np.uint8), 8, top_down,
                    palette)
    else:
        ch = 3 if kind == "bgr24" else 4
        data = _bmp(rng.randint(0, 256, (13, 21, ch)).astype(np.uint8), 8 * ch,
                    top_down)
    _check_bmp(data)


@pytest.mark.parametrize("compression,name", [(1, "RLE8"), (3, "bit-field")])
def test_bmp_reader_refuses_compressed_files(compression, name):
    data = _bmp(np.zeros((4, 5), np.uint8), 8, palette=np.zeros((2, 4), np.uint8),
                compression=compression)
    with pytest.raises(image_io.UnsupportedImage, match=name):
        image_io.imdecode(data)
    ok, buf = cv2.imencode(".bmp", np.zeros((4, 5, 4), np.uint8))  # BGRA: bit fields
    with pytest.raises(image_io.UnsupportedImage, match="bit-field"):
        image_io.imdecode(buf.tobytes())


def test_bmp_reader_refuses_a_cut_file():
    ok, buf = cv2.imencode(".bmp", _image((17, 29)))
    with pytest.raises(ValueError, match="truncated or corrupt"):
        image_io.imdecode(buf.tobytes()[:-40])


def test_png_reader_refuses_16_bit(tmp_path):
    path = str(tmp_path / "deep.png")
    assert cv2.imwrite(path, np.zeros((4, 5), np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        image_io.imread(path)
