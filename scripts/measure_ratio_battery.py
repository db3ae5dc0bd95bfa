"""Rate/quality battery for the container formats over diverse content.

Measures, per fixture: v1-pruned and compact-v2 sizes, the v2 ratio vs the
16-bit WAV payload, round-trip SNR (default decode), and whether the v2
entropy stage picked the whole-value coding for s/o (so_enc). CPU-pinned —
container bytes are a pure host function of the records, and the encoder's
selections on the CPU backend round-trip the same contracts as on the GPU.

Run: python scripts/measure_ratio_battery.py   (from the repository root)
"""

import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, "/root/repo")

from bench import make_signal  # noqa: E402
from fwav import compress_audio_arrays, compute_snr, decompress_audio  # noqa: E402
from fwav.io.compact import (  # noqa: E402
    _EXT, _EXT_OFFSET, FLAG_ENTROPY, compact_bytes, parse_compact_bytes,
)
from fwav.io.container import matches_to_struct, save_compressed  # noqa: E402
from fwav.models.encode import prune_bank  # noqa: E402


def fixtures():
    sr = 44100
    n = sr * 10
    t = np.arange(n) / sr
    rng = np.random.default_rng(0)
    amp = 0.5 * (2**15 - 1)
    yield "bench_speechlike", make_signal(10.0, sr), sr
    yield "pure_tone_440", np.round(amp * np.sin(2 * np.pi * 440 * t)).astype(np.float32), sr
    yield "white_noise", np.round(amp * 0.3 * rng.standard_normal(n)).clip(-32767, 32767).astype(np.float32), sr
    sil = make_signal(10.0, sr)
    mask = np.ones(n, bool)
    for k in range(10):  # ~80% silence
        a = int((k + 0.1) * sr)
        mask[a : a + int(0.8 * sr)] = False
    sil[~mask] = 0.0
    yield "silence_heavy", sil, sr
    yield "chirp_sweep", np.round(amp * 0.7 * np.sin(2 * np.pi * (50 + 400 * t) * t)).astype(np.float32), sr
    harm = sum(np.sin(2 * np.pi * 220 * (k + 1) * t) / (k + 1) for k in range(6))
    yield "harmonic_rich", np.round(amp * 0.4 * harm / np.abs(harm).max()).astype(np.float32), sr


def main():
    import tempfile, os

    print(f"{'fixture':18s} {'v1_pruned':>10s} {'v2':>9s} {'ratio':>6s} "
          f"{'snr_db':>7s} {'so_enc':>6s} {'enc_s':>6s}")
    for name, sig, sr in fixtures():
        t0 = time.perf_counter()
        rec, bank, n_ranges, N, tile, step, thr, olen = compress_audio_arrays(
            sig, sr, 2
        )
        enc_s = time.perf_counter() - t0
        rec_p, bank_p = prune_bank(rec, bank)
        with tempfile.NamedTemporaryFile(suffix=".fwav", delete=False) as f:
            tmp = f.name
        try:
            save_compressed(tmp, rec_p, bank_p, N, sr, 2, tile, step, thr, olen)
            v1 = os.path.getsize(tmp)
        finally:
            os.unlink(tmp)
        blob = compact_bytes(rec_p, bank_p, N, sr, 2, tile, step, thr, olen)
        so_enc = (
            blob[_EXT_OFFSET + _EXT.size + 3]
            if blob[_EXT_OFFSET + 3] & FLAG_ENTROPY else -1
        )
        # decode from the PARSED v2 blob, so the SNR column measures the
        # container being sized (entropy-stage quantization included) and
        # would catch a whole-value encode/decode defect
        rec_v2, bank_v2, *_ = parse_compact_bytes(blob)
        recon = decompress_audio(
            rec_v2, bank_v2, n_ranges, N, original_len=len(sig)
        )
        snr = compute_snr(sig, recon)
        ratio = len(sig) * 2 / len(blob)
        print(f"{name:18s} {v1:>10d} {len(blob):>9d} {ratio:>6.2f} "
              f"{snr:>7.2f} {so_enc:>6d} {enc_s:>6.1f}")


if __name__ == "__main__":
    main()
