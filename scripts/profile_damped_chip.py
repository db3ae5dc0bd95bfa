"""Split the damped-streaming encode (global pass on) into compile vs
steady state.

One cold encode folds the per-process compile tax (shard cores at the
file's bucket shapes + the global core) into its wall time. This script
runs the identical encode TWICE in one process, collecting the per-phase
table each time: run 1 pays every compile, run 2 is the steady-state
device + transfer cost.

Usage: python scripts/profile_damped_chip.py [--seconds 100] [--reps 2]
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=100.0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
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
    from fwav.utils.trace import collect_phases

    sr = 44100
    sig = make_signal(args.seconds, sr)
    last = None
    for rep in range(args.reps):
        with collect_phases() as phases:
            t0 = time.perf_counter()
            rec, _, n_ranges, rs, tile, step, _, olen = (
                compress_audio_streaming(
                    sig, sr, 2, objective="damped",
                )
            )
            dt = time.perf_counter() - t0
        print(json.dumps({
            "rep": rep,
            "encode_s": round(dt, 3),
            "x_realtime": round(args.seconds / dt, 1),
            "phases": {k: round(v, 3) for k, v in sorted(phases.items())},
        }), flush=True)
        last = (rec, n_ranges, rs, tile, step, olen)
    rec, n_ranges, rs, tile, step, olen = last
    bank = np.concatenate(list(domain_block_iter(sig, tile, rs, step)))
    from fwav.config import DAMPED_DECODE_DAMPING

    out = decompress_audio(
        rec, bank, n_ranges, rs, original_len=olen,
        s_damping=DAMPED_DECODE_DAMPING,
    )
    print(json.dumps({"snr_db": round(float(compute_snr(sig, out)), 2)}),
          flush=True)


if __name__ == "__main__":
    main()
