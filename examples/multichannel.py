#!/usr/bin/env python
"""Multichannel example: synthesize a stereo WAV, compress it with
channel preservation (the reference can only fold to mono —
fractal.py:81-113), decode it back, and report per-channel quality and
the keep-vs-mid/side rate trade.

    python examples/multichannel.py [--channels keep|ms] [--seconds N]

`ms` stores mid=(L+R)/2 and side=(L-R)/2: it wins rate when the channels
nearly coincide (the side channel falls under the silence gate) and loses
it on decorrelated stereo — try both on the two fixtures this script
builds.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from fwav import compute_snr
from fwav.io.wav import read_wav, write_wav
from fwav.models.codec import process_file_compress, process_file_decompress


def stereo_fixture(seconds, sr, decorrelated):
    t = np.arange(int(sr * seconds)) / sr
    base = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.15 * np.sin(2 * np.pi * 1320 * t)
    if decorrelated:
        left = base
        right = 0.3 * np.sin(2 * np.pi * 770 * t)  # a different image
    else:
        left = base + 0.03 * np.sin(2 * np.pi * 550 * t)
        right = base - 0.03 * np.sin(2 * np.pi * 550 * t)
    ch = np.stack([left, right], axis=1)
    ch[int(0.4 * sr):int(0.55 * sr)] = 0.0  # shared silence gap
    return np.round(ch * 16000).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", default="keep", choices=["keep", "ms"])
    ap.add_argument("--decorrelated", action="store_true",
                    help="use a decorrelated stereo image (where ms loses)")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--sr", type=int, default=16000)
    args = ap.parse_args()

    ch = stereo_fixture(args.seconds, args.sr, args.decorrelated)
    with tempfile.TemporaryDirectory() as d:
        wav = os.path.join(d, "stereo.wav")
        write_wav(wav, ch, args.sr, 2)
        fwav = os.path.join(d, "stereo.fwav")

        r = process_file_compress(wav, fwav, channels=args.channels)
        if "error" in r:
            raise SystemExit(f"compress failed: {r['error']}")
        print(f"channels={args.channels}  ratio={r['ratio']:.2f}  "
              f"encode={r['time_s']:.2f}s")

        r = process_file_decompress(fwav, d)
        if "error" in r:
            raise SystemExit(f"decompress failed: {r['error']}")
        recon, _, _ = read_wav(r["output"])
        for c in range(ch.shape[1]):
            print(f"  ch{c}: SNR {compute_snr(ch[:, c], recon[:, c]):.2f} dB")


if __name__ == "__main__":
    main()
