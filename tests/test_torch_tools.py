"""The port's offline data tools and log-mel frontend against the JAX
package's on the CPU: `models/audio_frontend.py` against
`combo_avs_tpu/models/audio_frontend.py` (log-mel within 1e-4, the tables
exactly), the `preprocess_audio` pickles against `process_wav`'s (44.1 kHz
stereo resampled, and 16 kHz mono padded), `maskige` and `resize_frames`
run on the same synthetic trees as the JAX tools (which use cv2, the oracle
here: the Maskige and PNG pixels equal, the JPEG bytes equal),
`make_sam_mask`'s gate and `masks_to_array`, and the tools' imports (no
cv2, yaml or jax)."""

import os
import pickle
import shutil
import subprocess
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from combo_avs_tpu.models import audio_frontend as jax_frontend
from combo_avs_tpu.tools import make_sam_mask as jax_sam
from combo_avs_tpu.tools import maskige as jax_maskige
from combo_avs_tpu.tools import preprocess_audio as jax_preprocess
from combo_avs_tpu.tools import resize_frames as jax_resize
from combo_avs_torch.models import audio_frontend
from combo_avs_torch.tools import make_sam_mask, maskige, preprocess_audio, resize_frames
from tests.test_torch_slice import REPO
from tests.test_torch_slice import one_torch_thread, release_worker_memory  # noqa: F401

LOG_MEL_ATOL = 1e-4


def _wav(path, seconds, rate, channels, seed=0):
    """A synthetic int16 wav: tones and noise, `channels` of them."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * rate)) / rate
    chans = [0.4 * np.sin(2 * np.pi * (220 + 330 * c) * t) + 0.05 * rng.randn(t.size)
             for c in range(channels)]
    data = (np.stack(chans, -1) * 32767 * 0.8).astype(np.int16)
    wavfile.write(path, rate, data if channels > 1 else data[:, 0])
    return data


def test_tables_match_jax():
    np.testing.assert_array_equal(audio_frontend.periodic_hann(400),
                                  jax_frontend.periodic_hann(400))
    np.testing.assert_array_equal(audio_frontend.mel_filterbank(257),
                                  jax_frontend.mel_filterbank(257))
    assert (audio_frontend.mel_filterbank(257)[0] == 0).all()


@pytest.mark.parametrize("n", [0, 399, 400, 1000, 16000 + 37])
def test_log_mel_spectrogram_matches_jax(n):
    x = np.random.RandomState(n).uniform(-1, 1, n).astype(np.float32)
    got = audio_frontend.log_mel_spectrogram(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_frontend.log_mel_spectrogram(jnp.asarray(x)))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=LOG_MEL_ATOL)


@pytest.mark.parametrize("rate, channels", [(16000, 1), (44100, 2), (22050, 1)])
def test_waveform_to_examples_matches_jax(rate, channels):
    """Mono averaging, `resample_poly` from other rates, the STFT and the
    framing into [N, 96, 64]."""
    rng = np.random.RandomState(rate)
    data = rng.uniform(-0.8, 0.8, (int(3.3 * rate), channels)).squeeze()
    got = audio_frontend.waveform_to_examples(data, rate, device="cpu").numpy()
    want = np.asarray(jax_frontend.waveform_to_examples(data, rate))
    assert got.shape == want.shape == (3, 96, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOG_MEL_ATOL)


def test_frontend_runs_on_the_card_by_default():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            audio_frontend.waveform_to_examples(np.zeros(16000), 16000)


@pytest.mark.parametrize("seconds, rate, channels", [(10, 44100, 2), (2.5, 16000, 1),
                                                     (12, 16000, 1)])
def test_process_wav_pickle_matches_jax(tmp_path, seconds, rate, channels):
    """The [10, 1, 96, 64] pickle: a 10 s 44.1 kHz stereo clip, a short one
    zero-padded, a long one cut at 10 examples."""
    path = str(tmp_path / "audio.wav")
    _wav(path, seconds, rate, channels)
    got = preprocess_audio.process_wav(path, pad_to=10, device="cpu")
    want = jax_preprocess.process_wav(path, pad_to=10)
    assert got.shape == want.shape == (10, 1, 96, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=LOG_MEL_ATOL)
    n = min(int(seconds / 0.96), 10)
    assert np.abs(got[:n]).sum() > 0 and (got[n:] == 0).all()


def test_preprocess_audio_cli_writes_the_pickles(tmp_path):
    for v in ("a", "b"):
        os.makedirs(tmp_path / v)
        _wav(str(tmp_path / v / "audio.wav"), 2.0, 44100, 2, seed=len(v))
    assert preprocess_audio.main(["--root", str(tmp_path), "--device", "cpu"]) == 2
    assert preprocess_audio.main(["--root", str(tmp_path), "--device", "cpu"]) == 0
    for v in ("a", "b"):
        with open(tmp_path / v / "audio.pkl", "rb") as f:
            got = pickle.load(f)
        want = jax_preprocess.process_wav(str(tmp_path / v / "audio.wav"))
        np.testing.assert_allclose(got, want, rtol=0, atol=LOG_MEL_ATOL)


# ---------------------------------------------------------------- maskige


def _sam_tree(root, seed=0):
    """Per-frame SAM mask arrays: overlapping rectangles of several sizes at
    640^2 and 360x480, an empty result and a pickled non-array."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "v1"))
    os.makedirs(os.path.join(root, "v2"))
    for i, (h, w, n) in enumerate([(640, 640, 5), (360, 480, 12), (360, 480, 1)]):
        masks = np.zeros((n, h, w), bool)
        for k in range(n):
            y, x = rng.randint(0, h - 20), rng.randint(0, w - 20)
            masks[k, y:y + rng.randint(10, h - y), x:x + rng.randint(10, w - x)] = True
        np.save(os.path.join(root, "v1", f"{i}.npy"), masks)
    np.save(os.path.join(root, "v2", "0.npy"), np.zeros((0, 0, 0), np.uint8))
    np.save(os.path.join(root, "v2", "1.npy"), np.array(None, dtype=object), allow_pickle=True)


def _run_jax_tool(module, argv):
    old = sys.argv
    sys.argv = ["tool", *argv]
    try:
        module.main()
    finally:
        sys.argv = old


def test_maskige_matches_jax_tool(tmp_path):
    """The port's CLI and the JAX tool on copies of one tree: every
    `*_mask_color.png` has the same RGB pixels (read with cv2)."""
    _sam_tree(str(tmp_path / "port"))
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    assert maskige.main(["--root", str(tmp_path / "port")]) == 5
    _run_jax_tool(jax_maskige, ["--root", str(tmp_path / "jax")])
    for v, f in (("v1", "0"), ("v1", "1"), ("v1", "2"), ("v2", "0"), ("v2", "1")):
        got = cv2.imread(str(tmp_path / "port" / v / f"{f}_mask_color.png"), cv2.IMREAD_UNCHANGED)
        want = cv2.imread(str(tmp_path / "jax" / v / f"{f}_mask_color.png"), cv2.IMREAD_UNCHANGED)
        assert got.shape == want.shape == (224, 224, 3)
        np.testing.assert_array_equal(got, want)


def test_maskige_functions_match_jax():
    rng = np.random.RandomState(1)
    masks = (rng.rand(7, 50, 70) > 0.7).astype(np.uint8)
    np.testing.assert_array_equal(maskige.ade_palette(), jax_maskige.ade_palette())
    np.testing.assert_array_equal(maskige.composite_instance_masks(masks),
                                  jax_maskige.composite_instance_masks(masks))
    for size in (224, 33):
        np.testing.assert_array_equal(maskige.render_maskige(masks, size),
                                      jax_maskige.render_maskige(masks, size))


# ---------------------------------------------------------------- resize_frames


def _avss_tree(root, seed=0):
    """Two AVSS videos: colour JPEG frames (720p and a portrait one), gray
    and palette PNG labels, a gray JPEG frame."""
    rng = np.random.RandomState(seed)
    for v, (h, w) in (("va", (360, 640)), ("vb", (300, 200))):
        fr, lb = os.path.join(root, v, "frames"), os.path.join(root, v, "labels_semantic")
        os.makedirs(fr)
        os.makedirs(lb)
        for i in range(2):
            img = cv2.GaussianBlur(rng.randint(0, 256, (h, w, 3)).astype(np.uint8), (7, 7), 2)
            cv2.imwrite(os.path.join(fr, f"{i}.jpg"), img)
            lab = np.zeros((h, w), np.uint8)
            lab[h // 4: h // 2 + 17 * i, w // 3: w // 2 + 11] = 5 + i
            cv2.imwrite(os.path.join(lb, f"{i}.png"), lab)
        gray = cv2.GaussianBlur(rng.randint(0, 256, (h, w)).astype(np.uint8), (5, 5), 1)
        cv2.imwrite(os.path.join(fr, "2.jpg"), gray)
        # a palette PNG, as AVSBench-semantic's labels are
        from PIL import Image

        pal = Image.fromarray(np.where(np.arange(w)[None, :] > w // 2, 3, 1).astype(np.uint8)
                              .repeat(h, 0), mode="P")
        pal.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0] + [0] * 756)
        pal.save(os.path.join(lb, "2.png"))


@pytest.mark.parametrize("mode", ["crop", "resize"])
def test_resize_frames_matches_jax_tool(tmp_path, mode):
    """The port's CLI and the JAX tool (cv2) on copies of one tree: the PNG
    labels' pixels equal (gray stays gray, a palette one becomes RGB), the
    JPEG frames' bytes equal (colour and gray)."""
    _avss_tree(str(tmp_path / "port"))
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    size = 96
    assert resize_frames.main(["--root", str(tmp_path / "port"), "--mode", mode,
                               "--size", str(size)]) == 12
    _run_jax_tool(jax_resize, ["--root", str(tmp_path / "jax"), "--mode", mode,
                               "--size", str(size)])
    for v in ("va", "vb"):
        for sub, files in (("processed_frames", ("0.jpg", "1.jpg", "2.jpg")),
                           ("processed_labels_semantic", ("0.png", "1.png", "2.png"))):
            for f in files:
                got, want = tmp_path / "port" / v / sub / f, tmp_path / "jax" / v / sub / f
                if f.endswith(".jpg"):
                    assert got.read_bytes() == want.read_bytes(), (v, f)
                else:
                    a = cv2.imread(str(got), cv2.IMREAD_UNCHANGED)
                    b = cv2.imread(str(want), cv2.IMREAD_UNCHANGED)
                    assert a.shape == b.shape and a.shape[:2] == (size, size), (v, f)
                    np.testing.assert_array_equal(a, b)


def test_resize_functions_match_jax():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (100, 173, 3)).astype(np.uint8)
    lbl = rng.randint(0, 9, (100, 173)).astype(np.uint8)
    for size in (64, 224):
        np.testing.assert_array_equal(resize_frames.crop_resize(img, size),
                                      jax_resize.crop_resize(img, size))
        np.testing.assert_array_equal(resize_frames.crop_resize(lbl, size, is_mask=True),
                                      jax_resize.crop_resize(lbl, size, is_mask=True))
        np.testing.assert_array_equal(resize_frames.resize(img, size),
                                      jax_resize.resize(img, size))


def test_resize_frames_refuses_alpha(tmp_path):
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, np.zeros((8, 8, 4), np.uint8))
    with pytest.raises(ValueError, match="colour type 6"):
        resize_frames.read_unchanged(path)


# ---------------------------------------------------------------- SAM


def test_make_sam_mask_gate_and_arrays():
    """Without segment_anything both tools exit with the same message; the
    mask stack is the JAX tool's."""
    with pytest.raises(SystemExit) as got:
        make_sam_mask.build_generator("nonexistent.pth", "vit_h")
    with pytest.raises(SystemExit) as want:
        jax_sam.build_generator("nonexistent.pth", "vit_h")
    assert str(got.value) == str(want.value) == make_sam_mask.MISSING
    masks = [{"segmentation": np.random.RandomState(k).rand(5, 6) > 0.5} for k in range(3)]
    np.testing.assert_array_equal(make_sam_mask.masks_to_array(masks),
                                  jax_sam.masks_to_array(masks))
    assert make_sam_mask.masks_to_array([]).shape == jax_sam.masks_to_array([]).shape


def test_tools_import_no_cv2_yaml_or_jax(tmp_path):
    """The tools and the frontend in a fresh process: none of cv2, yaml, jax,
    PIL, soundfile or the JAX package gets imported, and the SAM CLI exits
    with its message."""
    code = ("import sys\n"
            "import combo_avs_torch.tools.preprocess_audio, combo_avs_torch.tools.maskige\n"
            "import combo_avs_torch.tools.resize_frames, combo_avs_torch.tools.make_sam_mask\n"
            "bad = [m for m in ('cv2', 'yaml', 'jax', 'flax', 'PIL', 'soundfile',\n"
            "                    'combo_avs_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(tmp_path), env=env)
    r = subprocess.run([sys.executable, "-m", "combo_avs_torch.tools.make_sam_mask", "--root",
                        str(tmp_path), "--checkpoint", "x.pth"], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True)
    assert r.returncode == 1 and make_sam_mask.MISSING in r.stderr
