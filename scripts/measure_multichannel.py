#!/usr/bin/env python
"""Reproduce PARITY.md's multichannel rows on the GPU.

Runs the CLI surface in-process (compiles stay warm across modes; a fresh
process pays its compiles unless the persistent compilation cache has
them) on two
10 s 44.1 kHz stereo fixtures of bench content:

- decorrelated: R = 0.92 L + 1% noise — the case where mid/side honestly
  LOSES rate (the side channel is not silent);
- identical channels — the case where ms wins ~2x (the side channel falls
  under the silence gate and stores as -1 sentinels).

Also measures the mono CLI end-to-end time on the same content so the
"second channel costs ~17% extra wall time via the shared vmapped packed
dispatch" claim is a same-process A/B. Emits one JSON line per
measurement. Run from the repository root.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import make_signal  # noqa: E402
from fwav import cli  # noqa: E402
from fwav.io.wav import read_wav, write_wav  # noqa: E402
from fwav.utils.metrics import compute_snr  # noqa: E402


def run_stereo(tag, wav_path, mode):
    out = f"{wav_path}.{mode}.fwav"
    in_bytes = os.path.getsize(wav_path)
    warm = None
    for _rep in range(2):  # rep 1 pays any compile; rep 2 is the number
        t0 = time.time()
        assert cli.main(["compress", wav_path, out, "--channels", mode]) == 0
        warm = time.time() - t0
    rec = out + ".wav"
    assert cli.main(["decompress", out, "--out", rec]) == 0
    a, _, _ = read_wav(wav_path)
    b, _, _ = read_wav(rec)
    snr = [round(float(compute_snr(a[:, c], b[:, c])), 2)
           for c in range(a.shape[1])]
    print(json.dumps({
        "fixture": tag, "mode": mode,
        "ratio": round(in_bytes / os.path.getsize(out), 3),
        "snr_per_ch": snr, "warm_s": round(warm, 3),
    }), flush=True)


def main(workdir="/tmp/fwav_multich"):
    os.makedirs(workdir, exist_ok=True)
    sr = 44100
    sig = make_signal(10.0, sr)

    mono = os.path.join(workdir, "mono.wav")
    write_wav(mono, sig, sr, 2)
    for _rep in range(3):
        t0 = time.time()
        assert cli.main(["compress", mono, mono + ".fwav"]) == 0
        mono_t = time.time() - t0
    print(json.dumps({"fixture": "mono-cli-baseline",
                      "warm_s": round(mono_t, 3)}), flush=True)

    rng = np.random.default_rng(7)
    right = 0.92 * sig + rng.normal(0, np.abs(sig).max() * 0.01, sig.shape)
    decorr = os.path.join(workdir, "stereo_decorr.wav")
    write_wav(decorr, np.stack([sig, right], 1).astype(np.float32), sr, 2)
    ident = os.path.join(workdir, "stereo_ident.wav")
    write_wav(ident, np.stack([sig, sig], 1).astype(np.float32), sr, 2)

    for tag, path in (("decorrelated", decorr), ("identical", ident)):
        for mode in ("keep", "ms"):
            run_stereo(tag, path, mode)


if __name__ == "__main__":
    main()
