#!/usr/bin/env python
"""Encode and decode rate for 10 s of 44.1 kHz mono on one GPU.

    python bench.py

Prints one JSON line {"metric", "value", "unit", ..., "device"}: warm
encode x-realtime (median over 12 in-process runs, with min and max),
decode time, round-trip SNR and the compact container's ratio. The device
(platform, device_kind, count) rides on the line; any backend but the GPU
is refused — a CPU number is never reported as a device number.
"""

from __future__ import annotations

import json
import time

import numpy as np


def make_signal(seconds: float = 10.0, sr: int = 44100) -> np.ndarray:
    """Deterministic speech-like test content: chirp + harmonics + noise with
    silence gaps, int16 full-scale-ish."""
    rng = np.random.default_rng(42)
    t = np.arange(int(sr * seconds)) / sr
    sig = 0.35 * np.sin(2 * np.pi * (180 + 40 * np.sin(2 * np.pi * 0.5 * t)) * t * 8)
    sig += 0.2 * np.sin(2 * np.pi * 850 * t)
    sig += 0.08 * np.sin(2 * np.pi * 2700 * t)
    sig += 0.01 * rng.standard_normal(len(t))
    # silence gaps every ~2 s
    for k in range(1, int(seconds / 2) + 1):
        a = int((2 * k - 0.3) * sr)
        sig[a : a + int(0.15 * sr)] = 0.0
    # true int16 sample values — what read_wav_mono yields for every real
    # 16-bit WAV (the values a codec encoding 16-bit PCM actually sees)
    return np.round(sig * 0.5 * (2**15 - 1)).astype(np.float32)


def measure():
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench: needs an NVIDIA GPU, JAX runs on "
                         f"{jax.default_backend()!r}")
    from fwav.utils.compile_cache import enable_compile_cache
    from fwav.utils.logging import configure_cli_logging

    enable_compile_cache()
    configure_cli_logging()  # standalone script: keep the banner visible
    from fwav import compress_audio_arrays, compute_snr, decompress_audio

    sr = 44100
    seconds = 10.0
    sig = make_signal(seconds, sr)

    # warmup (compile both directions)
    rec, domains, n_ranges, range_size, *_ = compress_audio_arrays(sig, sr, 2)
    decompress_audio(rec, domains, n_ranges, range_size, original_len=len(sig))

    times = []
    for _ in range(12):
        t0 = time.perf_counter()
        rec, domains, n_ranges, range_size, tile, step, thr, olen = (
            compress_audio_arrays(sig, sr, 2)
        )
        times.append(time.perf_counter() - t0)
    enc_s = float(np.median(times))

    dts = []
    for _ in range(3):
        t0 = time.perf_counter()
        recon = decompress_audio(rec, domains, n_ranges, range_size, original_len=len(sig))
        dts.append(time.perf_counter() - t0)
    dec_s = float(np.median(dts))
    snr = compute_snr(sig, recon)

    # compression ratio of the opt-in compact v2 container (the rate-focused
    # layout; the default v1-pruned container is the interchange format)
    import os

    from fwav.io.compact import save_compressed_compact
    from fwav.models.encode import prune_bank

    rec_p, bank_p = prune_bank(rec, domains)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".smoke")
    os.makedirs(work, exist_ok=True)
    tmp = os.path.join(work, "bench_compact.fwav")
    try:
        save_compressed_compact(
            tmp, rec_p, bank_p, range_size, sr, 2, tile, step, thr, olen
        )
        ratio_compact = (len(sig) * 2) / os.path.getsize(tmp)
    finally:
        os.unlink(tmp)

    xrt = (len(sig) / sr) / enc_s
    dev = jax.devices()[0]
    return {
        "metric": "encode_x_realtime_44k1_mono_10s",
        "value": xrt,
        "unit": "x_realtime",
        "encode_s": enc_s,
        "encode_s_min": float(np.min(times)),
        "encode_s_max": float(np.max(times)),
        "decode_s": dec_s,
        "round_trip_snr_db": snr,
        "n_ranges": int(n_ranges),
        "n_domains": int(len(domains)),
        "ratio_compact": ratio_compact,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }


if __name__ == "__main__":
    print(json.dumps(measure()))
