"""The port's image codec (humanrf_torch/core/image_io.py, csrc/jpeg_codec.c)
against OpenCV, which the JAX package reads and writes every image with.

Decoding is bit-exact (max |diff| = 0): the codec does what libjpeg does by
default under `cv2.imread` (islow integer IDCT, fancy upsampling, the
fixed-point YCbCr→RGB tables). Encoding writes the bytes `cv2.imwrite`
writes at the same quality, so a port-written JPEG decodes (by cv2) to
exactly what cv2's own file decodes to."""
import cv2
import numpy as np
import pytest
from scipy.ndimage import gaussian_filter

from humanrf_torch.core import image_io


def _image(h=61, w=83, seed=0):
    """A smooth colour image with sharp edges: noise blurred, plus a bright
    disc (odd sizes exercise partial MCUs)."""
    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.random((h, w, 3)) * 255, (2, 2, 0))
    yy, xx = np.mgrid[:h, :w]
    img[(yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 4) ** 2] = (20, 230, 90)
    return np.clip(img, 0, 255).astype(np.uint8)


_SAMPLING = {
    "420": [],
    "422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
    "444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
}


@pytest.mark.parametrize("quality", [98, 75])
@pytest.mark.parametrize("sampling", sorted(_SAMPLING))
def test_decode_equals_cv2(tmp_path, quality, sampling):
    path = tmp_path / "a.jpg"
    assert cv2.imwrite(str(path), _image(), [cv2.IMWRITE_JPEG_QUALITY, quality, *_SAMPLING[sampling]])
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(str(path)))


@pytest.mark.parametrize("kind", ["gray", "restart_interval"])
def test_decode_gray_and_restart_markers_equal_cv2(tmp_path, kind):
    path = tmp_path / "b.jpg"
    if kind == "gray":
        assert cv2.imwrite(str(path), _image()[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 90])
    else:
        assert cv2.imwrite(str(path), _image(), [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
        assert b"\xff\xdd" in path.read_bytes()  # a DRI marker
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(str(path)))


@pytest.mark.parametrize("quality", [98, 95, 75])
def test_encode_writes_what_cv2_writes(tmp_path, quality):
    img = _image(48, 70, seed=1)
    ours, theirs = tmp_path / "ours.jpg", tmp_path / "theirs.jpg"
    image_io.imwrite(ours, img, quality=quality)
    assert cv2.imwrite(str(theirs), img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    np.testing.assert_array_equal(cv2.imread(str(ours)), cv2.imread(str(theirs)))
    assert ours.read_bytes() == theirs.read_bytes()


def test_encode_gray_is_read_by_cv2(tmp_path):
    gray = _image()[..., 0]
    path = tmp_path / "g.jpg"
    image_io.imwrite(path, gray, quality=90)
    ok, buf = cv2.imencode(".jpg", gray, [cv2.IMWRITE_JPEG_QUALITY, 90])
    np.testing.assert_array_equal(cv2.imread(str(path)), cv2.imdecode(buf, cv2.IMREAD_COLOR))


def test_png_round_trips_both_ways(tmp_path):
    bgr = _image(33, 47, seed=2)
    mask = ((_image(33, 47, seed=3)[..., 0] > 128) * 255).astype(np.uint8)
    for name, img in (("rgb", bgr), ("mask", mask)):
        ours, theirs = tmp_path / f"{name}_ours.png", tmp_path / f"{name}_theirs.png"
        image_io.imwrite(ours, img)
        assert cv2.imwrite(str(theirs), img)
        expected = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
        np.testing.assert_array_equal(cv2.imread(str(ours)), expected)
        np.testing.assert_array_equal(image_io.imread(theirs), expected)


def _filtered_png(img: np.ndarray) -> bytes:
    """An 8-bit PNG of `img` (H, W, C), C = 1, 2, 3 or 4, whose row r uses
    filter r % 5 (None, Sub, Up, Average, Paeth)."""
    import struct
    import zlib

    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int16)
    prev = np.zeros(w * c, np.int16)
    raw = []
    for r, row in enumerate(rows):
        left = np.concatenate([np.zeros(c, np.int16), row[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int16), prev[:-c]])
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        pred = [np.zeros_like(row), left, prev, (left + prev) // 2, paeth][r % 5]
        raw.append(bytes([r % 5]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prev = row

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_of_every_colour_type_and_filter_decodes_as_cv2(tmp_path, channels):
    """Gray, gray+alpha, RGB and RGBA, rows through all five filters; alpha
    is dropped and gray replicated as `cv2.imread` does."""
    rgb = _image(40, 52, seed=4)
    img = np.concatenate([rgb, rgb[..., :1]], axis=-1)[..., :channels] if channels != 2 else rgb[..., :2]
    path = tmp_path / f"c{channels}.png"
    path.write_bytes(_filtered_png(img))
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(str(path)))


def test_progressive_jpeg_raises_naming_the_file(tmp_path):
    path = tmp_path / "progressive.jpg"
    assert cv2.imwrite(str(path), _image(), [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive.jpg"):
        image_io.imread(path)
