#!/usr/bin/env python
"""Time the Pallas (Triton) scan kernel over its block sizes and warp
counts at the production shapes, on the GPU.

    python scripts/tune_scan.py

Shapes (chip_smoke.py builds them the same way, at the encoder's bucket
sizes): the 10 s fixture's coarse lobe scan (114,688 ranges x 3,584
subsampled rows, top-1 and top-4) and the 120 s fixture's global-pass
nomination (1,572,864 ranges x 12,288 rows, top-4). Prints the median
per-call time of every configuration; the best one goes into
ops/pallas_search.py (BLOCK_M, BLOCK_D, NUM_WARPS).
"""

from __future__ import annotations

import itertools
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"tune_scan: needs the GPU, JAX runs on "
                 f"{jax.default_backend()!r}")
    from bench import make_signal
    from chip_smoke import _chunked, _median_time, _scan_operands
    from fwav.ops import pallas_search
    from fwav.ops.affine import affine_stats
    from fwav.ops.search import domain_thresh, domain_weights
    from fwav.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    kind = jax.devices()[0].device_kind
    coarse = _scan_operands(make_signal(10.0, 44100), 128)
    nominate = _scan_operands(make_signal(120.0, 44100), 512, nom_bucket=16)
    shapes = [("coarse_top1_10s", coarse, 1, "balanced"),
              ("coarse_top4_10s", coarse, 4, "damped"),
              ("global_top4_120s", nominate, 4, "damped")]
    grid = list(itertools.product((32, 64, 128), (64, 128, 256), (4, 8)))
    for label, (r_c, bank, valid), top_c, objective in shapes:
        dm, dd = affine_stats(bank)
        w = domain_weights(dm, dd, 4, objective)
        t = domain_thresh(dd, objective, 16.0)
        best = None
        for bm, bd, warps in grid:
            fn = jax.jit(lambda r_c, bm=bm, bd=bd, warps=warps: _chunked(
                lambda rc: pallas_search.scan_topc(
                    rc, bank, w, valid, top_c, d_thresh=t, s_clip=16.0,
                    block_m=bm, block_d=bd, num_warps=warps), r_c))
            try:
                ms = _median_time(lambda: fn(r_c)) * 1e3
            except Exception as e:  # noqa: BLE001 — a config Triton refuses
                print(f"tune {label} bm={bm} bd={bd} warps={warps}: "
                      f"refused ({type(e).__name__})", flush=True)
                continue
            print(f"tune {label} bm={bm} bd={bd} warps={warps}: "
                  f"{ms:.3f} ms [{kind}]", flush=True)
            if best is None or ms < best[0]:
                best = (ms, bm, bd, warps)
        print(f"tune {label} best: bm={best[1]} bd={best[2]} warps={best[3]} "
              f"{best[0]:.3f} ms [{kind}]", flush=True)


if __name__ == "__main__":
    main()
