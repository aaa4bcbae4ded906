"""Log-mel audio frontend (the VGGish input convention), on a torch device.

Port of `combo_avs_tpu/models/audio_frontend.py`, the frontend that turns
AVSBench's wavs into the `audio_log_mel` pickles the datasets ship (ref:
torchvggish mel_features.py:21-202, vggish_input.py:30-76):

* 16 kHz mono: channels averaged, other rates resampled with
  `scipy.signal.resample_poly` (in float64 on the host, as the JAX
  function does), `scipy.io.wavfile` reading int16 wavs scaled to [-1, 1];
* STFT: 25 ms periodic-Hann window (400 samples), 10 ms hop (160), the
  magnitude of `torch.fft.rfft` at 512, no centering;
* 64 HTK mel bins over 125-7500 Hz with the DC row zeroed, a matmul;
* log(mel + 0.01);
* framed into non-overlapping 0.96 s examples of 96 frames -> [N, 96, 64].

The window and the filterbank are numpy float32 tables made as the JAX
module makes them; the STFT and the mel product run in float32 on the
waveform tensor's device. These are library calls that the JAX function
also makes outside any Pallas kernel.
"""

from __future__ import annotations

import functools
from math import gcd
from typing import Optional

import numpy as np
import torch

SAMPLE_RATE = 16000
STFT_WINDOW_SECONDS = 0.025
STFT_HOP_SECONDS = 0.010
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
EXAMPLE_WINDOW_SECONDS = 0.96
EXAMPLE_HOP_SECONDS = 0.96

_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0


def hertz_to_mel(freq_hz):
    """HTK mel scale."""
    return _MEL_HIGH_FREQUENCY_Q * np.log1p(np.asarray(freq_hz, np.float64)
                                            / _MEL_BREAK_FREQUENCY_HERTZ)


@functools.lru_cache(maxsize=None)
def mel_filterbank(num_spectrogram_bins: int, sample_rate: int = SAMPLE_RATE,
                   num_mel_bins: int = NUM_MEL_BINS, lower_edge_hz: float = MEL_MIN_HZ,
                   upper_edge_hz: float = MEL_MAX_HZ) -> np.ndarray:
    """Triangular HTK mel weights [num_spectrogram_bins, num_mel_bins],
    float32, the DC row zeroed. Cached: treat the result as read-only."""
    nyquist = sample_rate / 2.0
    mel_freqs = hertz_to_mel(np.linspace(0.0, nyquist, num_spectrogram_bins))
    band_edges = np.linspace(hertz_to_mel(lower_edge_hz), hertz_to_mel(upper_edge_hz),
                             num_mel_bins + 2)
    lower, center, upper = band_edges[:-2], band_edges[1:-1], band_edges[2:]
    lower_slope = (mel_freqs[:, None] - lower[None, :]) / (center - lower)[None, :]
    upper_slope = (upper[None, :] - mel_freqs[:, None]) / (upper - center)[None, :]
    weights = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    weights[0, :] = 0.0
    return weights.astype(np.float32)


def periodic_hann(window_length: int) -> np.ndarray:
    """The periodic (DFT-even) Hann window, float32 (np.hanning is the
    symmetric one)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi / window_length * np.arange(window_length))
            ).astype(np.float32)


def frame(signal: torch.Tensor, window_length: int, hop_length: int) -> torch.Tensor:
    """Frames along axis 0: [num_frames, window_length, ...]; none when the
    signal is shorter than a window."""
    n = signal.shape[0]
    if n < window_length:
        return signal.new_zeros((0, window_length) + tuple(signal.shape[1:]))
    frames = signal.unfold(0, window_length, hop_length)  # [F, ..., window]
    return frames.movedim(-1, 1)


def log_mel_spectrogram(waveform: torch.Tensor, sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    """[num_samples] float32 waveform -> [num_frames, 64] log-mel, on the
    waveform's device."""
    window_length = int(round(sample_rate * STFT_WINDOW_SECONDS))
    hop_length = int(round(sample_rate * STFT_HOP_SECONDS))
    fft_length = 2 ** int(np.ceil(np.log2(window_length)))
    dev = waveform.device
    frames = frame(waveform, window_length, hop_length)
    if frames.shape[0] == 0:
        return waveform.new_zeros((0, NUM_MEL_BINS))
    window = torch.from_numpy(periodic_hann(window_length)).to(dev)
    spec = torch.fft.rfft(frames * window, n=fft_length).abs()
    mel = spec @ torch.from_numpy(mel_filterbank(fft_length // 2 + 1, sample_rate)).to(dev)
    return torch.log(mel + LOG_OFFSET)


def resample_to_16k(data: np.ndarray, sample_rate: int) -> np.ndarray:
    """Mono (channels averaged) at 16 kHz, float64: `resample_poly` by the
    reduced ratio, as the JAX function resamples."""
    data = np.asarray(data)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if sample_rate != SAMPLE_RATE:
        from scipy.signal import resample_poly

        g = gcd(int(SAMPLE_RATE), int(sample_rate))
        data = resample_poly(data, SAMPLE_RATE // g, sample_rate // g)
    return data


def waveform_to_examples(data: np.ndarray, sample_rate: int,
                         device: Optional[torch.device | str] = None) -> torch.Tensor:
    """A waveform (float, [-1, 1], [n] or [n, channels]) -> [num_examples,
    96, 64] float32 log-mel examples on `device` (the current CUDA device
    when None; "cpu" to run on the host)."""
    from combo_avs_torch.models.meta_arch import default_device

    mono = resample_to_16k(data, sample_rate)
    wave = torch.from_numpy(np.asarray(mono, np.float32)).to(default_device(device))
    log_mel = log_mel_spectrogram(wave)
    frames_per_example = int(round(EXAMPLE_WINDOW_SECONDS / STFT_HOP_SECONDS))
    return frame(log_mel, frames_per_example, frames_per_example)


def read_wav(path: str):
    """(int16 samples [n] or [n, channels], sample rate) of a PCM wav."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype != np.int16:
        raise ValueError(f"expected int16 wav, got {data.dtype} in {path}")
    return data, sr


def wavfile_to_examples(path: str, device: Optional[torch.device | str] = None) -> torch.Tensor:
    """An int16 wav file -> [num_examples, 96, 64] log-mel examples."""
    data, sr = read_wav(path)
    return waveform_to_examples(data / 32768.0, sr, device)
