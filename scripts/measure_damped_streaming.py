"""Reproduce the PARITY.md damped-streaming quality row (round 4).

Encodes the 100 s bench fixture through the production streaming path with
the damped objective, with and without the whole-file global-candidate
pass, and reports round-trip SNR under the damped decoder
(--damping 0.25). Expected (bit-deterministic on the CPU mesh):

    pass ON  : 38.57 dB
    pass OFF : 31.45 dB

Runs anywhere (defaults to whatever backend JAX selects; pass --cpu to pin
the host CPU — the quality numbers are the contract; a timing is a device
number only when JAX ran on the GPU).

Usage: python scripts/measure_damped_streaming.py [--cpu] [--seconds 100]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="pin the CPU backend")
    ap.add_argument("--seconds", type=float, default=100.0)
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from bench import make_signal
    from fwav import compute_snr, decompress_audio
    from fwav.models.stream import (
        compress_audio_streaming,
        domain_block_iter,
    )

    sr = 44100
    sig = make_signal(args.seconds, sr)
    results = {}
    for label, gc in (("on", None), ("off", False)):
        t0 = time.perf_counter()
        rec, _, n_ranges, rs, tile, step, _, olen = compress_audio_streaming(
            sig, sr, 2, objective="damped", global_candidates=gc,
        )
        dt = time.perf_counter() - t0
        bank = np.concatenate(list(domain_block_iter(sig, tile, rs, step)))
        out = decompress_audio(
            rec, bank, n_ranges, rs, original_len=olen, s_damping=0.25
        )
        snr = compute_snr(sig, out)
        results[label] = (snr, dt)
        print(
            f"global pass {label:3s}: SNR {snr:6.2f} dB  "
            f"encode {dt:6.1f}s ({args.seconds / dt:6.1f}x realtime)",
            flush=True,
        )
    gain = results["on"][0] - results["off"][0]
    print(f"pass recovers {gain:+.2f} dB")


if __name__ == "__main__":
    main()
