#!/usr/bin/env python
"""Long-file streaming encode with the damped quality profile.

Demonstrates the streaming API directly (models.stream) on a signal split
into several time shards, with:
  - the clip-aware "damped" objective (decode with s_damping > 0),
  - the whole-file global-candidate pass (auto-on for this profile; it
    recovers matches a halo-restricted shard search misses),
  - shard-level crash recovery via resume_dir (re-run this script with the
    same --resume-dir and completed shards load from disk).

    python examples/long_damped.py [--seconds 8] [--resume-dir DIR]

File-level callers get all of this automatically: process_file_compress /
the CLI select streaming for long inputs (`--profile damped`,
`--global-candidates`, `--resume-dir`).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from fwav import compute_snr, decompress_audio
from fwav.models.stream import (
    compress_audio_streaming,
    domain_block_iter,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--resume-dir", default=None)
    ap.add_argument("--cpu", action="store_true", help="pin the CPU backend")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    # a slowly-modulated partial makes good matches REMOTE — the content
    # the halo-restricted search struggles with
    sr = 8000
    rng = np.random.default_rng(0)
    t = np.arange(int(sr * args.seconds)) / sr
    sig = (
        0.5 * np.sin(2 * np.pi * 220 * t)
        + 0.2 * np.sin(2 * np.pi * 2213 * t * (1 + 0.2 * np.sin(2 * np.pi * 0.5 * t)))
        + 0.01 * rng.standard_normal(len(t))
    ).astype(np.float32)

    kw = dict(
        shard_samples=1 << 13,  # small shards so this demo streams; the
        halo=1 << 12,           # defaults suit multi-minute files
        objective="damped",
        resume_dir=args.resume_dir,
    )
    t0 = time.perf_counter()
    rec, _, n_ranges, rs, tile, step, _, olen = compress_audio_streaming(
        sig, sr, 2, **kw
    )
    dt = time.perf_counter() - t0
    bank = np.concatenate(list(domain_block_iter(sig, tile, rs, step)))
    out = decompress_audio(
        rec, bank, n_ranges, rs, original_len=olen, s_damping=0.25
    )
    print(f"damped + global pass: SNR {compute_snr(sig, out):6.2f} dB  "
          f"({len(sig) // kw['shard_samples'] + 1} shards, {dt:.1f}s)")

    rec_off, *_ = compress_audio_streaming(
        sig, sr, 2, global_candidates=False, **kw
    )
    out_off = decompress_audio(
        rec_off, bank, n_ranges, rs, original_len=olen, s_damping=0.25
    )
    print(f"pass disabled:        SNR {compute_snr(sig, out_off):6.2f} dB  "
          f"({int((rec['idx'] != rec_off['idx']).sum())} matches differ)")


if __name__ == "__main__":
    main()
