"""Offline audio preprocessing: wav -> padded log-mel pickle.

Port of `combo_avs_tpu/tools/preprocess_audio.py` (ref:
avs_tools/preprocess_avss_audio.py:50-64): the VGGish log-mel frontend
(`models/audio_frontend.py`) on each `audio.wav` under a tree, zero-padded
to `pad_to` examples, pickled next to the wav as `audio.pkl` in the
[pad_to, 1, 96, 64] float32 layout the dataset mappers load. The STFT runs
on the card unless `--device cpu` asks for the host.

Usage:
  python -m combo_avs_torch.tools.preprocess_audio --root AVS_dataset/AVSS [--pad-to 10]
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Optional

import numpy as np
import torch

from combo_avs_torch.models.audio_frontend import wavfile_to_examples


def process_wav(path: str, pad_to: int = 10,
                device: Optional[torch.device | str] = None) -> np.ndarray:
    x = wavfile_to_examples(path, device).cpu().numpy()  # [N, 96, 64]
    out = np.zeros((pad_to, 1, 96, 64), np.float32)
    n = min(x.shape[0], pad_to)
    out[:n, 0] = x[:n]
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True, help="directory tree containing audio.wav files")
    p.add_argument("--pad-to", type=int, default=10)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: the current card)")
    args = p.parse_args(argv)

    n = 0
    for dirpath, _, files in os.walk(args.root):
        for f in sorted(files):
            if not f.endswith(".wav"):
                continue
            wav = os.path.join(dirpath, f)
            pkl = wav[:-4] + ".pkl"
            if os.path.exists(pkl) and not args.overwrite:
                continue
            with open(pkl, "wb") as fw:
                pickle.dump(process_wav(wav, args.pad_to, args.device), fw)
            n += 1
    print(f"wrote {n} audio pickles under {args.root}")
    return n


if __name__ == "__main__":
    main()
