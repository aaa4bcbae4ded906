"""The port's JPEG codec (`combo_avs_torch/native/jpeg.c` through
`data/jpeg.py`, dispatched by `data/image.py::read_image`) against libjpeg on
the CPU: every case of the matrix below decodes byte for byte as
`cv2.imread` (converted to RGB; cv2 5.0.0 bundles libjpeg-turbo 3.1.2) and
the JAX package's native reader (the system libjpeg) decode it, colour and
gray reads alike; the port's encoder writes cv2's own bytes, which all three
readers decode alike; the forms the decoder refuses raise ValueError; and the
host build route (`ops/_build.py::load_host`) rebuilds an edited source and
raises without a compiler."""

import glob
import importlib.util
import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest

from combo_avs_tpu import native
from combo_avs_torch.data import jpeg
from combo_avs_torch.data.image import read_image
from combo_avs_torch.data.png import write_png
from combo_avs_torch.ops import _build
from tests.test_torch_slice import one_torch_thread, release_worker_memory  # noqa: F401

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, "gray": None}
MATRIX = [(sub, q, mode, hw) for sub in ("420", "422", "444", "gray") for q in (50, 95)
          for mode in ("baseline", "progressive", "restart") for hw in ((131, 223), (1, 1))]
# replicated ratios (4:4:0's h1v2 filter, 4:1:1's 4x) and a source-sized frame
MATRIX += [("440", 95, "baseline", (131, 223)), ("440", 50, "progressive", (17, 9)),
           ("411", 95, "restart", (131, 223)), ("420", 95, "baseline", (720, 1280))]


@pytest.fixture(scope="module")
def native_io(tmp_path_factory):
    """The JAX package's native reader: the one built in place, or else a
    private build of its sources (building in place would race the other
    workers' tests/test_native_io.py)."""
    mod = native.get_io()
    if mod is not None:
        return mod
    d = tmp_path_factory.mktemp("native_io")
    for f in ("combo_io.cpp", "setup.py"):
        shutil.copy(os.path.join(os.path.dirname(native.__file__), f), d)
    subprocess.run([sys.executable, "setup.py", "build_ext", "--inplace"], cwd=d, check=True,
                   capture_output=True)
    spec = importlib.util.spec_from_file_location(
        "_combo_io", glob.glob(str(d / "_combo_io*.so"))[0])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frame(h, w, seed=0):
    """Smooth gradients with noise: every DCT band in use."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(xx * 3 + yy) % 256, (yy * 2 + 40) % 256, ((xx - yy) * 5) % 256], -1)
    noise = np.random.RandomState(seed).randint(-40, 40, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _cv2_read(path, gray):
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    return img if gray else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("sub,quality,mode,hw", MATRIX,
                         ids=[f"{s}-q{q}-{m}-{h}x{w}" for s, q, m, (h, w) in MATRIX])
def test_decoder_matches_libjpeg(native_io, tmp_path, sub, quality, mode, hw):
    """A file cv2 writes at this sampling, quality and mode (progressive:
    cv2's simple progression, successive approximation and EOB runs
    included; restart: an interval of 3 MCUs) decodes as cv2 and the
    native reader decode it, byte for byte, read in colour and in gray."""
    img = _frame(*hw, seed=quality)
    path = str(tmp_path / "f.jpg")
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(mode == "progressive"),
              cv2.IMWRITE_JPEG_RST_INTERVAL, 3 if mode == "restart" else 0]
    if sub == "gray":
        assert cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2GRAY), params)
    else:
        assert cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                           params + [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sub]])
    data = open(path, "rb").read()
    assert (b"\xff\xc2" in data) == (mode == "progressive")
    assert (b"\xff\xdd" in data) == (mode == "restart")
    for gray in (False, True):
        got = read_image(path, gray=gray)
        want = _cv2_read(path, gray)
        assert got.shape == (hw if gray else (*hw, 3)) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, native_io.decode(path, gray=gray))


ENCODED = [(sub, q, hw) for sub in ("420", "444", "gray") for q in (50, 95)
           for hw in ((224, 224), (131, 223), (1, 1))]


@pytest.mark.parametrize("sub,quality,hw", ENCODED,
                         ids=[f"{s}-q{q}-{h}x{w}" for s, q, (h, w) in ENCODED])
def test_encoder_writes_cv2_bytes(native_io, tmp_path, sub, quality, hw):
    """`write_jpeg` writes the bytes cv2.imwrite writes for the same pixels,
    quality and sampling (baseline, the Annex K tables), and the file
    decodes alike through the port, cv2 and the native reader."""
    img = _frame(*hw, seed=1)
    if sub == "gray":
        img = np.ascontiguousarray(img[..., 0])
        want = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
    else:
        want = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                            [cv2.IMWRITE_JPEG_QUALITY, quality,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sub]])[1].tobytes()
    path = str(tmp_path / "p.jpg")
    jpeg.write_jpeg(path, img, quality=quality, subsampling="444" if sub == "444" else "420")
    assert open(path, "rb").read() == want
    for gray in (False, True):
        got = read_image(path, gray=gray)
        np.testing.assert_array_equal(got, _cv2_read(path, gray))
        np.testing.assert_array_equal(got, native_io.decode(path, gray=gray))


def _sof(data: bytes) -> int:
    return data.index(b"\xff\xc0")


def _patched(data: bytes, at: int, value: bytes) -> bytes:
    return data[:at] + value + data[at + len(value):]


def _refused():
    """(name, file bytes, what the message names) for each refused form,
    made from a 4:2:0 baseline file cv2 writes."""
    img = _frame(32, 48)
    base = cv2.imencode(".jpg", img)[1].tobytes()
    prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    s = _sof(base)
    no_jfif = base[:2] + base[2 + 18:]  # the JFIF APP0 cut: libjpeg guesses from the ids
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    cmyk = (b"\xff\xd8\xff\xc0\x00\x14\x08\x00\x08\x00\x08\x04"
            + b"".join(bytes([i, 0x11, 0]) for i in range(1, 5)) + b"\xff\xd9")
    rgb_ids = bytearray(no_jfif)
    s2 = _sof(no_jfif)
    rgb_ids[s2 + 10], rgb_ids[s2 + 13], rgb_ids[s2 + 16] = b"RGB"  # the components' ids
    return [
        ("arithmetic", _patched(base, s + 1, b"\xc9"), "arithmetic coding"),
        ("lossless", _patched(base, s + 1, b"\xc3"), "lossless"),
        ("hierarchical", _patched(base, s + 1, b"\xc5"), "hierarchical"),
        ("12bit", _patched(base, s + 4, b"\x0c"), "12-bit"),
        ("dnl", _patched(base, s + 5, b"\x00\x00"), "DNL"),
        ("cmyk", cmyk, "CMYK"),
        ("adobe_rgb", no_jfif[:2] + adobe + no_jfif[2:], "RGB"),
        ("rgb_ids", bytes(rgb_ids), "RGB"),
        ("unrefined", prog[:prog.rindex(b"\xff\xda")] + b"\xff\xd9", "unrefined"),
        ("truncated_header", base[:s + 6], "truncated"),
    ]


@pytest.mark.parametrize("case", _refused(), ids=lambda c: c[0] if isinstance(c, tuple) else "")
def test_refusals_raise_value_error(tmp_path, case):
    """Each refused form raises ValueError naming what the file uses; no
    other decoder is tried."""
    name, data, says = case
    path = str(tmp_path / f"{name}.jpg")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=says):
        read_image(path)


def test_read_image_dispatches_on_content(tmp_path):
    """PNG and JPEG are told apart by their magic bytes, not the file's
    name; anything else raises ValueError."""
    img = _frame(9, 11)
    png_named_jpg = str(tmp_path / "png.jpg")
    write_png(png_named_jpg, img)
    np.testing.assert_array_equal(read_image(png_named_jpg), img)
    jpg_named_png = str(tmp_path / "jpg.png")
    jpeg.write_jpeg(jpg_named_png, img)
    np.testing.assert_array_equal(read_image(jpg_named_png), _cv2_read(jpg_named_png, False))
    other = str(tmp_path / "x.bmp")
    cv2.imwrite(other, img)
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        read_image(other)


def test_host_build_rebuilds_and_needs_a_compiler(tmp_path, monkeypatch):
    """`load_host` compiles a host C source into a library named by the
    source's hash; an edited source is built anew (the stale library is not
    served); a source that does not compile, a compiler that cannot run and
    no compiler at all each raise RuntimeError."""
    pkg = tmp_path / "pkg"
    (pkg / "native").mkdir(parents=True)
    src = pkg / "native" / "probe.c"
    monkeypatch.setattr(_build, "_PKG", str(pkg))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_libs", {})
    src.write_text("int probe(void) { return 1; }\n")
    first = _build.host_library_path("native/probe.c")
    assert _build.load_host("native/probe.c").probe() == 1 and os.path.isfile(first)
    src.write_text("int probe(void) { return 2; }\n")
    second = _build.host_library_path("native/probe.c")
    assert second != first and not os.path.exists(second)
    monkeypatch.setattr(_build, "_libs", {})  # a new process
    assert _build.load_host("native/probe.c").probe() == 2 and os.path.isfile(second)
    assert not [f for f in os.listdir(tmp_path / "_build") if f.endswith(".tmp")]

    monkeypatch.setattr(_build, "_libs", {})
    src.write_text("int probe(void) { return }\n")
    with pytest.raises(RuntimeError, match="failed"):
        _build.load_host("native/probe.c")
    src.write_text("int probe(void) { return 3; }\n")
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(RuntimeError, match="cannot run"):
        _build.load_host("native/probe.c")
    monkeypatch.delenv("CC")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="no C compiler"):
        _build.load_host("native/probe.c")
