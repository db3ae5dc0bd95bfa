"""Batched mirrored affine least-squares matching.

For a range r and domain tile d, the optimal affine map r ~ s*d + o has the
closed form s = sum(d_c * r_c) / sum(d_c^2), o = mean(r) - s*mean(d) with
centered vectors; the L2 reconstruction error satisfies
||r - (s*d + o)||^2 = ||r_c||^2 - 2*s*num + s^2*denom.

`batched_affine_match` reproduces the reference's batched GPU solve
(_process_gpu_batch, fractal.py:757-850) semantics exactly:
- candidates gathered per range, -1 pads clamped to 0 then masked to +inf err;
- mirrored copies appended AFTER the originals, so argmin tie-breaks prefer
  the original orientation and earlier candidates;
- err computed with the UNclipped s, clip to +/- s_clip applied after argmin.
Instead of materializing a (B, 2K, N) mirrored concat it reverses the ranges
(sum(r_c * reverse(d)) == sum(reverse(r_c) * d)), halving the gather traffic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-12
#: Orientation tie tolerance, relative to the Cauchy-Schwarz bound
#: sqrt(sum r_c^2)*sqrt(sum t_c^2) on |num|. Must exceed n*ulp_f32
#: (~1e-6 at n=16) so the numpy and native refits — which accumulate in
#: different orders — agree on every mathematically-tied orientation.
#: Keep in sync with TIE_TOL in native/fwavio.cpp.
_TIE_TOL = 1e-5


def affine_stats(tiles: jnp.ndarray):
    """Per-tile mean and centered energy over the last axis."""
    mean = jnp.mean(tiles, axis=-1)
    centered = tiles - mean[..., None]
    denom = jnp.sum(centered * centered, axis=-1)
    return mean, denom


def batched_affine_match(
    ranges: jnp.ndarray,      # (B, N) float32
    cand_idx: jnp.ndarray,    # (B, K) int32, -1 = padded slot
    bank: jnp.ndarray,        # (D, N) float32
    s_clip: float = 16.0,
    objective: str = "affine",
    return_score: bool = False,
):
    """Pick the best (domain, orientation) per range from its candidate list.

    objective="affine" selects by plain L2 reconstruction error (the
    reference's argmin, fractal.py:820); "balanced" adds the shipped
    decoder's offset-deviation penalty N*(s*d_mean)^2 to the selection score
    (see ops.search.exact_search_block) — stored err is the affine error
    either way.

    Returns (idx, s, o, sym, err) each (B,). For a range whose candidates are
    all -1 the err is +inf and idx is the clamped slot-0 domain — callers
    decide sentinel policy (see models.encode). With return_score=True two
    extra outputs are appended: the winner's selection score (minimized;
    +inf when every slot is invalid) and its argmin position in the
    originals-then-mirrors arrangement (sym*K + slot) — the tp shortlist
    merge keys its cross-shard tie-break on that position so the sharded
    pick replicates this function's slot-order tie-break exactly."""
    safe = jnp.maximum(cand_idx, 0)
    tiles = bank[safe]  # (B, K, N)
    return affine_match_tiles(
        ranges, tiles, safe, cand_idx < 0, s_clip=s_clip, objective=objective,
        return_score=return_score,
    )


def affine_match_tiles(
    ranges: jnp.ndarray,      # (B, N)
    tiles: jnp.ndarray,       # (B, K, N) pre-gathered candidate tiles
    cand_idx: jnp.ndarray,    # (B, K) global domain index of each tile
    invalid: jnp.ndarray,     # (B, K) bool, True = masked slot
    s_clip: float = 16.0,
    objective: str = "affine",
    selection_precision=None,
    return_score: bool = False,
):
    """Core of batched_affine_match for callers that already hold the tiles
    (e.g. the coarse-to-fine refiner). `selection_precision` controls only
    which candidate WINS (the winner is refit exactly either way); the
    noise-tolerant balanced coarse path passes DEFAULT for speed."""
    B, N = ranges.shape
    safe = cand_idx
    prec = selection_precision or jax.lax.Precision.HIGHEST

    d_mean, d_denom = affine_stats(tiles)            # (B, K) — mirror-invariant
    r_mean = jnp.mean(ranges, axis=1, keepdims=True)  # (B, 1)
    r_c = ranges - r_mean                             # (B, N)
    r_e = jnp.sum(r_c * r_c, axis=1, keepdims=True)   # (B, 1)

    # num for original and mirrored orientation via reversed ranges
    num_o = jnp.einsum("bkn,bn->bk", tiles, r_c, precision=prec)
    num_m = jnp.einsum("bkn,bn->bk", tiles, r_c[:, ::-1], precision=prec)
    # (B, 2K): originals first — argmin tie-break prefers sym=0
    num = jnp.concatenate([num_o, num_m], axis=1)
    denom = jnp.concatenate([d_denom, d_denom], axis=1) + _EPS
    mean2 = jnp.concatenate([d_mean, d_mean], axis=1)

    s = num / denom
    o = r_mean - s * mean2
    err2 = r_e - 2.0 * s * num + s * s * (denom - _EPS)
    err = jnp.sqrt(jnp.maximum(err2, 0.0))

    if objective == "balanced":
        score = err2 + N * (s * mean2) ** 2
    elif objective == "damped":
        # clip-aware: the residual actually achievable with the CLIPPED
        # scale — what the damped decoder's fixed point reconstructs
        # (ops.search._gain_from_num rationale)
        s_cl = jnp.clip(s, -abs(s_clip), abs(s_clip))
        score = r_e - 2.0 * s_cl * num + s_cl * s_cl * (denom - _EPS)
    else:
        score = err
    invalid2 = jnp.concatenate([invalid, invalid], axis=1)
    err = jnp.where(invalid2, jnp.inf, err)
    score = jnp.where(invalid2, jnp.inf, score)

    pick = jnp.argmin(score, axis=1)  # first occurrence wins ties
    rows = jnp.arange(B)
    best_idx = jnp.concatenate([safe, safe], axis=1)[rows, pick]
    best_sym = (pick >= cand_idx.shape[1]).astype(jnp.uint8)

    # exact refit on the winning tile: the err2 closed form cancels
    # catastrophically in float32 when the fit is near-perfect; the explicit
    # residual does not. s/o/err below are bit-exact for the chosen pair.
    K = cand_idx.shape[1]
    tile = tiles[rows, jnp.where(pick >= K, pick - K, pick)]      # (B, N)
    tile = jnp.where(best_sym[:, None].astype(bool), tile[:, ::-1], tile)
    t_mean = jnp.mean(tile, axis=1)
    t_c = tile - t_mean[:, None]
    t_denom = jnp.sum(t_c * t_c, axis=1)
    t_num = jnp.sum(r_c * t_c, axis=1)
    best_s = t_num / (t_denom + _EPS)
    best_o = r_mean[:, 0] - best_s * t_mean
    resid = r_c - best_s[:, None] * t_c
    best_err = jnp.sqrt(jnp.sum(resid * resid, axis=1))
    best_err = jnp.where(jnp.isinf(err[rows, pick]), jnp.inf, best_err)
    best_s = jnp.clip(best_s, -abs(s_clip), abs(s_clip))
    out = (best_idx.astype(jnp.int32), best_s, best_o, best_sym, best_err)
    if return_score:
        out = (*out, score[rows, pick], pick.astype(jnp.int32))
    return out


def find_best_domain_affine(range_block, domains, candidate_idxs, range_size=None,
                            use_gpu: bool = False, s_clip: float = 16.0):
    """Reference-shaped single-range candidate solve (fractal.py:404-486
    signature — which is DEAD and crashes on an undefined name at
    fractal.py:428 if ever called; this one works). `domains` may be a
    (D, N) array or a path to a float32 domain memmap; returns the
    (best_idx, s, o, sym, err) tuple with -1/inf for empty candidates."""
    import numpy as np

    if isinstance(domains, (str, bytes)) or hasattr(domains, "__fspath__"):
        import os

        if range_size is None:
            range_size = len(np.asarray(range_block).reshape(-1))
        size = os.path.getsize(domains)
        row = 4 * int(range_size)
        if size % row:
            raise ValueError(
                f"domain memmap size {size} is not a multiple of the "
                f"{row}-byte row (range_size={range_size})"
            )
        domains = np.memmap(
            domains, dtype="float32", mode="r", shape=(size // row, int(range_size))
        )
    bank = np.asarray(domains, dtype=np.float32)
    cand = np.asarray(
        [int(c) for c in (candidate_idxs if candidate_idxs is not None else []) if int(c) >= 0],
        dtype=np.int32,
    )
    if cand.size == 0:
        return -1, 0.0, 0.0, 0, float("inf")
    idx, s, o, sym, err = batched_affine_match(
        jnp.asarray(range_block, jnp.float32)[None, :],
        jnp.asarray(cand)[None, :],
        jnp.asarray(bank),
        s_clip=s_clip,
    )
    return int(idx[0]), float(s[0]), float(o[0]), int(sym[0]), float(err[0])


def affine_solve_single(range_block: jnp.ndarray, tile: jnp.ndarray):
    """(s, o, err) for one range/tile pair, both orientations considered.
    Public op mirroring find_best_domain_affine's per-candidate math
    (fractal.py:443-478)."""
    idx, s, o, sym, err = batched_affine_match(
        range_block[None, :], jnp.zeros((1, 1), jnp.int32), tile[None, :]
    )
    return s[0], o[0], sym[0], err[0]


#: Test hook: force the numpy reference path even when the native kernel is
#: available (tests/test_native_refit.py compares the two head to head).
_FORCE_NUMPY_REFIT = False


def refit_host(ranges, bank, idx, s_clip: float = 16.0):
    """Exact float32 affine refit of already-selected domain positions, on
    the host, against the host-built (serialized) bank — the host half of
    the idx-only device->host protocol (models.encode build_encode_core).

    The ORIENTATION is re-derived here rather than trusted from the device:
    for a fixed position, the better orientation maximizes num^2 (the
    per-domain selection weight is orientation-invariant, so this is the
    exact device rule for every objective; original wins ties,
    fractal.py:779-787 ordering). Deciding it in shape-stable host numpy
    makes the stored records bit-reproducible across device shardings —
    XLA recompiles per (dp, tp) slab shape and may flip fp near-ties.

    Mirrors ops.search.exact_refit: s from centered sums with the +1e-12
    denominator guard, o = mean(r) - s*mean(d), err from the UNclipped s,
    s clipped to +/- s_clip afterwards (reference: fractal.py:802-825).
    Mirroring is realized on the RANGE side (sum(r_c * reverse(t_c)) ==
    sum(reverse(r_c) * t_c); tile mean/energy are mirror-invariant), and the
    per-row reductions run as one BLAS matvec + einsum products instead of
    axis-1 ufunc reductions.

    ranges (M, N) float32; idx (M,) int32 (valid rows only — callers mask
    sentinels). Returns (s, o, err, sym) — float32 x3 + bool.

    The hot implementation is the native one-pass-per-row kernel
    (native/fwavio.cpp fwav_refit, same semantics; measured ~6x faster than
    the numpy path below on the 10 s bench shapes — the numpy version is
    ~15 full-array passes). The numpy path is the always-available fallback
    and the executable specification the native kernel is tested against
    (tests/test_native_refit.py).

    Large temporaries in the numpy path come from a per-shape workspace
    pool: freed MB-scale numpy blocks go back to the OS, so without pooling
    every call pays page-fault cost on ~25 MB of fresh allocations."""
    import numpy as np

    r = np.ascontiguousarray(ranges, dtype=np.float32)
    if not _FORCE_NUMPY_REFIT:
        from ..io import native

        out = native.refit(r, bank, idx, s_clip)
        if out is not None:
            return out
    m, n = r.shape
    ws = _refit_workspace(m, n)
    q = np.full((n, 1), np.float32(1.0 / n))
    t = np.take(np.asarray(bank, dtype=np.float32), idx, axis=0, out=ws["t"])
    r_mean = np.matmul(r, q, out=ws["m1"])[:, 0]
    t_mean = np.matmul(t, q, out=ws["m2"])[:, 0]
    r_c = np.subtract(r, r_mean[:, None], out=ws["rc"])
    t_c = np.subtract(t, t_mean[:, None], out=ws["tc"])
    num_o = np.einsum("ij,ij->i", r_c, t_c, out=ws["v1"])
    num_m = np.einsum("ij,ij->i", r_c[:, ::-1], t_c, out=ws["v2"])
    denom = np.einsum("ij,ij->i", t_c, t_c, out=ws["v3"])
    # Orientation: original unless mirror wins by more than a tolerance
    # scaled to the Cauchy-Schwarz bound on |num| (sqrt(sum r_c^2 * sum
    # t_c^2)). For palindromic tiles num_o and num_m are the SAME terms
    # summed in different orders, so a strict |num_m| > |num_o| resolves
    # by accumulation-order noise — and flips between this path and the
    # native sequential kernel (identical margin there, fwavio.cpp
    # refit_one). The margin (1e-5 > n*ulp_f32) makes both paths agree on
    # every mathematical tie; a mirror that truly wins by less than 1e-5
    # of the correlation bound changes err only at the 1e-10 level.
    rcss = np.einsum("ij,ij->i", r_c, r_c, out=ws["v4"])
    tol = np.float32(_TIE_TOL) * np.sqrt(rcss) * np.sqrt(denom)
    sym = np.abs(num_m) > np.abs(num_o) + tol
    num = np.where(sym, num_m, num_o)
    s = num / (denom + np.float32(_EPS))
    o = r_mean - s * t_mean
    r_c_eff = np.where(sym[:, None], r_c[:, ::-1], r_c)
    resid = np.subtract(r_c_eff, s[:, None] * t_c, out=r_c_eff)
    err = np.sqrt(np.einsum("ij,ij->i", resid, resid))
    s = np.clip(s, -abs(s_clip), abs(s_clip))
    return s, o, err, sym


_REFIT_TLS = __import__("threading").local()


def _refit_workspace(m: int, n: int):
    """Reusable large buffers for refit_host, keyed by problem shape (one
    live entry per THREAD — batch workers refit concurrently outside the
    device lock; encode shapes repeat within a batch)."""
    import numpy as np

    ws = getattr(_REFIT_TLS, "ws", None)
    if ws is None or ws["key"] != (m, n):
        ws = dict(
            key=(m, n),
            t=np.empty((m, n), np.float32),
            rc=np.empty((m, n), np.float32),
            tc=np.empty((m, n), np.float32),
            m1=np.empty((m, 1), np.float32),
            m2=np.empty((m, 1), np.float32),
            v1=np.empty(m, np.float32),
            v2=np.empty(m, np.float32),
            v3=np.empty(m, np.float32),
            v4=np.empty(m, np.float32),
        )
        _REFIT_TLS.ws = ws
    return ws
