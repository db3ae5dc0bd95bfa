#!/usr/bin/env python
"""Prototype: slice-based bank build + reshape-framed VAD vs current. Measurement only."""

from __future__ import annotations

import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def mintime(fn, reps=6):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main():
    import jax
    import jax.numpy as jnp

    from bench import make_signal
    from fwav.ops.domains import box_sums, build_bank_jax

    sig = make_signal(10.0, 44100)
    n = len(sig)
    nb = 524288
    db = 524288
    N, B, step = 4, 256, 1
    n_domains = n - 1024 + 1
    raw = np.zeros(nb, np.float32)
    raw[:n] = sig / np.abs(sig).max()
    rd = jnp.asarray(raw)

    def sync(x):
        jax.device_get(jax.tree_util.tree_leaves(x)[0].ravel()[:1])

    sync(rd)
    LAT = mintime(lambda: sync(rd))
    print(f"lat {LAT*1e3:.1f} ms")

    # current gather-based
    f_old = jax.jit(partial(build_bank_jax, tile_size=1024, range_size=N,
                            domain_step=step, d_bucket=db))
    b0 = f_old(rd, n_domains=n_domains)
    sync(b0)
    print(f"bank gather: {(mintime(lambda: sync(f_old(rd, n_domains=n_domains)))-LAT)*1e3:.1f} ms")

    # slice-based (D, N)
    @jax.jit
    def f_slice(x, nd):
        means = box_sums(x, B) * (1.0 / B)
        need = (N - 1) * B + (db - 1) * step + 1
        if need > nb:
            means = jnp.concatenate([means, jnp.zeros(need - nb, jnp.float32)])
        cols = [
            jax.lax.slice(means, (j * B,), (j * B + (db - 1) * step + 1,), (step,))
            for j in range(N)
        ]
        bank = jnp.stack(cols, axis=1)
        valid = jnp.arange(db, dtype=jnp.int32) < nd
        return jnp.where(valid[:, None], bank, 0.0)

    b1 = f_slice(rd, n_domains)
    sync(b1)
    print("slice == gather:", bool(jnp.array_equal(b0, b1)))
    print(f"bank slice (D,N): {(mintime(lambda: sync(f_slice(rd, n_domains)))-LAT)*1e3:.1f} ms")

    # slice-based transposed (N, D)
    @jax.jit
    def f_slice_t(x, nd):
        means = box_sums(x, B) * (1.0 / B)
        need = (N - 1) * B + (db - 1) * step + 1
        if need > nb:
            means = jnp.concatenate([means, jnp.zeros(need - nb, jnp.float32)])
        bank_t = jnp.stack(
            [jax.lax.slice(means, (j * B,), (j * B + (db - 1) * step + 1,), (step,))
             for j in range(N)], axis=0)
        valid = jnp.arange(db, dtype=jnp.int32) < nd
        return jnp.where(valid[None, :], bank_t, 0.0)

    b2 = f_slice_t(rd, n_domains)
    sync(b2)
    print("sliceT == gather.T:", bool(jnp.array_equal(b0.T, b2)))
    print(f"bank slice (N,D): {(mintime(lambda: sync(f_slice_t(rd, n_domains)))-LAT)*1e3:.1f} ms")

    # VAD: current gather-framed vs reshape-framed
    from fwav.ops.vad import voiced_mask_jax

    f_vad_old = jax.jit(partial(voiced_mask_jax, frame_size=8))
    m0 = f_vad_old(rd, n, energy_threshold=1e-4)
    sync(m0)
    print(f"vad gather-framed: {(mintime(lambda: sync(f_vad_old(rd, n, energy_threshold=1e-4)))-LAT)*1e3:.1f} ms")

    from fwav.ops.vad import hysteresis_jax

    @partial(jax.jit, static_argnames=())
    def f_vad_new(x, ns):
        F = 8
        nf_b = nb // F
        ns = jnp.asarray(ns, jnp.int32)
        n_frames = (ns + F - 1) // F
        fr = x.reshape(nf_b, F)
        e = jnp.mean(fr * fr, axis=1)
        # tail frame reflect patch
        tf = n_frames - 1
        tpos = tf * F + jnp.arange(F, dtype=jnp.int32)
        refl = jnp.where(tpos < ns, tpos, 2 * ns - 2 - tpos)
        refl = jnp.clip(refl, 0, nb - 1)
        tw = jnp.take(x, refl, axis=0)
        e_tail = jnp.mean(tw * tw)
        fidx = jnp.arange(nf_b, dtype=jnp.int32)
        e = jnp.where(fidx == tf, e_tail, e)
        fvalid = fidx < n_frames
        e = jnp.where(fvalid, e, 0.0)
        kernel = jnp.ones((5,), jnp.float32) / 5
        e = jnp.convolve(e, kernel, mode="same")
        e = jnp.where(fvalid, e, 0.0)
        fmask = hysteresis_jax(e, 1e-4, 0.5e-4)
        m = jnp.broadcast_to(fmask[:, None], (nf_b, F)).reshape(nb)
        return jnp.where(jnp.arange(nb, dtype=jnp.int32) < ns, m, 0)

    m1 = f_vad_new(rd, n)
    sync(m1)
    print("vad new == old:", bool(jnp.array_equal(m0, m1)))
    print(f"vad reshape-framed: {(mintime(lambda: sync(f_vad_new(rd, n)))-LAT)*1e3:.1f} ms")


if __name__ == "__main__":
    main()
