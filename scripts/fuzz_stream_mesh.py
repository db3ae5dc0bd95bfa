"""Extended streaming x mesh fuzz round (CPU mesh).

Random (dp, tp) x search x objective x shard/halo/tile geometry through the
streaming encoder, asserting records bit-equal to the single-device
streaming encode. When a flip occurs, it is only accepted if it matches the
documented carve-out (CLAUDE.md): every flipped selection is an EXACT f64
selection-score tie and the decode outputs agree within 1 PCM LSB.

Usage: python scripts/fuzz_stream_mesh.py [--n 20] [--seed0 5000]
"""

import argparse
import os
import sys
import time

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 "
    + os.environ.get("XLA_FLAGS", "")
)
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, "/root/repo")

from fwav.models.stream import compress_audio_streaming, domain_block_iter
from fwav.ops.domains import bank_rows_host
from fwav.ops.vad import voiced_detection
from fwav.parallel.mesh import make_mesh
from fwav import decompress_audio


def _random_signal(rng, n, sr):
    kind = rng.integers(0, 5)
    t = np.arange(n) / sr
    if kind == 0:
        sig = 0.5 * np.sin(2 * np.pi * rng.uniform(100, sr / 4) * t)
    elif kind == 1:
        sig = 0.02 * rng.standard_normal(n)
        for _ in range(4):
            a = rng.integers(0, max(1, n - 100))
            sig[a : a + rng.integers(50, 400)] += 0.4 * rng.standard_normal(1)
    elif kind == 2:
        sig = 0.4 * np.sin(2 * np.pi * (100 + 50 * t) * t)
        a = rng.integers(0, max(1, n // 2))
        sig[a : a + n // 8] = 0.0
    elif kind == 3:  # near-periodic, the tie-heavy class
        sig = 0.4 * np.sin(2 * np.pi * 451.8 * t)
        sig += 0.01 * rng.standard_normal(n)
    else:
        sig = 1e-5 * rng.standard_normal(n)
        sig[n // 2 : n // 2 + 64] += 0.3
    return np.round(sig * (2**14)).astype(np.float32)


def sel_gain_check(sig, rec1, recm, rs, tile, step, thr, objective):
    # live<->sentinel disagreements are NEVER the carve-out (the silence
    # gate is replicated arithmetic, no ties) — check them unconditionally,
    # not only when no regular flip exists
    sent = (recm["idx"] >= 0) != (rec1["idx"] >= 0)
    if sent.any():
        return False
    d = (recm["idx"] != rec1["idx"]) & (rec1["idx"] >= 0) & (recm["idx"] >= 0)
    if not d.any():
        return True
    if objective != "balanced":
        # the closed-form gain below reproduces only the balanced
        # objective's selection score; no cheap oracle for affine/damped —
        # report "no oracle" and let the caller fall back to the decode
        # bound alone
        return None
    voiced = voiced_detection(sig, frame_size=2 * rs, energy_threshold=thr)
    w = sig * voiced
    pad = (rs - (len(sig) % rs)) % rs
    if pad:
        w = np.pad(w, (0, pad), mode="reflect")
    ranges = w.reshape(-1, rs).astype(np.float64)

    def sel_gain(rows, idxs):
        tl = bank_rows_host(sig, tile, rs, step, rows.astype(np.int64)).astype(np.float64)
        r = ranges[idxs]
        rc = r - r.mean(1, keepdims=True)
        tc = tl - tl.mean(1, keepdims=True)
        den = (tc * tc).sum(1) + 1e-300
        num = np.maximum(np.abs((rc * tc).sum(1)), np.abs((rc[:, ::-1] * tc).sum(1)))
        return num * num / den

    ii = np.nonzero(d)[0]
    g1 = sel_gain(rec1["idx"][ii], ii)
    g2 = sel_gain(recm["idx"][ii], ii)
    rel = np.abs(g1 - g2) / np.maximum(g1, 1e-12)
    return float(rel.max()) < 1e-12


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--seed0", type=int, default=5000)
    args = ap.parse_args()
    fails = 0
    for k in range(args.n):
        seed = args.seed0 + k
        rng = np.random.default_rng(seed)
        sr = int(rng.choice([8000, 16000, 44100]))
        n = int(rng.integers(6000, 40000))
        tile = int(rng.choice([128, 512, 1024]))
        search = str(rng.choice(["auto", "exact", "coarse", "topk"]))
        objective = str(rng.choice(["balanced", "affine", "damped"]))
        dp, tp = [(8, 1), (4, 2), (2, 4), (1, 8)][int(rng.integers(0, 4))]
        shard = int(rng.choice([4096, 8192, 16384]))
        halo = int(rng.choice([2048, 4096, 8192]))
        sig = _random_signal(rng, n, sr)
        kw = dict(tile_size=tile, search=search, objective=objective,
                  shard_samples=shard, halo=halo)
        t0 = time.time()
        try:
            rec1, _, n_ranges, rs, tile_o, step, thr, olen = (
                compress_audio_streaming(sig, sr, 2, **kw)
            )
            mesh = make_mesh(8, dp=dp, tp=tp)
            recm, *_ = compress_audio_streaming(sig, sr, 2, mesh=mesh, **kw)
        except Exception as e:
            print(f"[{k}] seed={seed} ERROR {type(e).__name__}: {e}", flush=True)
            fails += 1
            continue
        geo = (f"seed={seed} sr={sr} n={n} tile={tile} {search}/{objective} "
               f"dp={dp} tp={tp} shard={shard} halo={halo}")
        if np.array_equal(rec1, recm):
            print(f"[{k}] {geo} bit-equal ({time.time()-t0:.0f}s)", flush=True)
            continue
        ok = sel_gain_check(sig, rec1, recm, rs, tile_o, step, thr, objective)
        bank = np.concatenate(list(domain_block_iter(sig, tile_o, rs, step)))
        o1 = decompress_audio(rec1, bank, n_ranges, rs, original_len=olen)
        o2 = decompress_audio(recm, bank, n_ranges, rs, original_len=olen)
        lsb = float(np.abs(o1 - o2).max())
        if ok is None:  # no tie oracle: accept only on the measured
            verdict = (  # carve-out decode bound (<= 0.5 PCM LSB)
                "CARVE-OUT-OK(lsb-only)" if lsb <= 0.5 else "FAIL"
            )
        else:
            verdict = "CARVE-OUT-OK" if ok and lsb <= 1.0 else "FAIL"
        if verdict == "FAIL":
            fails += 1
        nflip = int(((recm["idx"] != rec1["idx"]) & (rec1["idx"] >= 0)).sum())
        print(f"[{k}] {geo} {verdict}: {nflip} flips, exact-tie={ok}, "
              f"decode-delta={lsb:.3g} ({time.time()-t0:.0f}s)", flush=True)
    print(f"DONE: {args.n - fails}/{args.n} clean", flush=True)
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
