"""Candidate search kernels.

Two searches, both single fused XLA programs scanning device-resident banks
in blocks (replacing the reference's CPU worker processes + hnswlib
HNSW graph + mp.Queue pipeline, fractal.py:353-401, 556-632):

1. `exact_search` (default): globally optimal matched-filter search. For the
   affine fit, err^2 = ||r_c||^2 - num^2/denom with num = sum(r_c * d) and
   denom = ||d_c||^2 — so the best (domain, orientation) maximizes the gain
   num^2/denom. num over a whole block of domains is one (M, N) @ (N, Db)
   matmul (rank-N structure: domains enter only through raw dot products with
   centered ranges), so the entire search+solve is matmul + running argmax.
   This strictly dominates the reference's two-stage embed->top-32->solve in
   match quality AND removes the embedding/ANN stages from the hot path.

2. `topk_search`: the reference-shaped two-stage path — multi-head DCT
   embeddings, blockwise top-k MIPS (the on-device replacement for hnswlib),
   then the batched mirrored affine solve over the shortlist. Kept as a
   selectable mode for behavior parity and as the scalable building block
   (top-k over sharded banks merges with a single gather).

Tie-breaking matches the reference argmin conventions: earlier domain index
wins, original orientation beats mirrored on equal gain.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .affine import batched_affine_match
from .dct import multi_head_embedding_batch

_EPS = 1e-12
_NEG = -jnp.inf


def fold_sum(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Sum over a short axis (the range_size taps) as an explicit left fold
    of adds, so every element sees the same f32 operations in the same
    order whatever the array's other dimensions. XLA's GPU reduction
    codegen picks its summation order by shape, so a jnp.sum here made the
    window refine's near-tied picks depend on the compiled range-chunk
    shape, which differs between one device and a mesh slab (CLAUDE.md,
    cross-sharding bit-equality)."""
    axis = axis % x.ndim
    acc = jax.lax.index_in_dim(x, 0, axis, keepdims=False)
    for i in range(1, x.shape[axis]):
        acc = acc + jax.lax.index_in_dim(x, i, axis, keepdims=False)
    return acc


def fold_mean(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """fold_sum(x, axis) / x.shape[axis]."""
    return fold_sum(x, axis) / x.shape[axis]


def _range_stats(ranges: jnp.ndarray):
    r_mean = jnp.mean(ranges, axis=1)
    r_c = ranges - r_mean[:, None]
    r_e = jnp.sum(r_c * r_c, axis=1)
    return r_mean, r_c, r_e


def exact_search_block(
    ranges: jnp.ndarray,    # (M, N) one block of ranges
    bank: jnp.ndarray,      # (Db_total, N) full bank, scanned in blocks
    d_mean: jnp.ndarray,    # (Db_total,)
    d_denom: jnp.ndarray,   # (Db_total,)
    d_valid: jnp.ndarray,   # (Db_total,) bool
    domain_block: int,
    s_clip: float,
    objective: str = "balanced",
    return_score: bool = False,
):
    """Optimal (idx, s, o, sym, err) for every range in the block against the
    ENTIRE bank, via a lax.scan over domain blocks carrying the running best
    (score, idx, sym).

    Objectives (selection only; stored s/o/err are always the exact affine
    fit of the chosen pair):

    - "affine": minimize the affine residual ||r_c - s*d_c||^2
      = r_e - num^2/denom, i.e. maximize num^2/denom. This is what the
      reference's argmin does over its shortlist (fractal.py:820).
    - "balanced" (default): minimize the affine residual PLUS the shipped
      decoder's offset deviation N*(s*d_mean)^2. The reference decoder's
      s_damping=0 fixed point reconstructs exactly the stored offset o
      (fractal.py:1434-1449 with a range-constant reconstruction gives
      s_opt = 0), so round-trip distortion is ||r_c||^2 + N*(s*d_mean)^2;
      the combined objective J = r_e - num^2 * (denom - N*d_mean^2)/denom^2
      optimizes the shape fit AND the shipped decode together. Both reduce
      to maximizing num^2 * w with a per-domain precomputed weight w.

    A final refit pass recomputes (s, o, err) against the gathered winning
    tile directly — the scan's score arithmetic suffers float32 cancellation
    when fits are near-perfect; the explicit residual does not.
    """
    r_mean, r_c, r_e = _range_stats(ranges)
    best_score, best_idx, best_sym = exact_search_scan(
        r_c, bank, d_mean, d_denom, d_valid, domain_block, objective,
        s_clip=s_clip,
    )
    out = exact_refit(
        r_mean, r_c, bank, best_score, best_idx, best_sym, s_clip
    )
    if return_score:
        return (*out, best_score)
    return out


def domain_weights(d_mean, d_denom, n: int, objective: str):
    """Per-domain selection weight w such that the best pair maximizes
    num^2 * w (see exact_search_block). For "damped" the weight is the
    affine 1/denom — the clip branch rides the separate per-domain
    threshold vector (domain_thresh + _gain_from_num)."""
    denom_eps = d_denom + _EPS
    if objective == "balanced":
        return (d_denom - n * d_mean * d_mean) / (denom_eps * denom_eps)
    return 1.0 / denom_eps


def domain_thresh(d_denom, objective: str, s_clip: float):
    """Per-domain clip threshold t = s_clip * denom for the clip-aware
    "damped" objective (None for every other objective): the optimal scale
    s* = num/denom exceeds the +/-s_clip clip exactly when |num| > t."""
    if objective != "damped":
        return None
    return abs(s_clip) * d_denom


def _gain_from_num(num, weight, thresh, s_clip):
    """Selection gain for ONE orientation from raw dot products `num`
    against per-domain `weight` (domain_weights) and optional clip
    threshold `thresh` (domain_thresh), broadcastable against num.

    Without thresh: the quadratic gain num^2 * w (objectives "affine" /
    "balanced" — maximizing it minimizes their respective residuals).

    With thresh (objective "damped"): the CLIP-AWARE gain — the centered
    residual reduction achievable with s clipped to +/-s_clip, i.e. the
    stored affine transform the damped decoder (s_damping > 0,
    fractal.py:1445) converges to:
        ||r_c||^2 - ||r_c - clip(s*) d_c||^2
          = num^2/denom                  when |s*| <= c  (|num| <= c*denom)
          = 2c|num| - c^2*denom          when |s*| >  c
    (c = s_clip; both branches are monotone in |num| for a fixed domain and
    agree at the switch point, so orientation selection and the host
    refit's |num|-magnitude orientation rule remain exact). Plain
    quadratic gains ignore the clip and chase matches whose optimal scale
    clips to a far worse fit — measured 24.9 dB vs 52.5 dB
    stored-transform SNR on the speechlike parity fixture.

    Known approximation: the stored offset pairs with the UNCLIPPED scale
    (reference refit semantics, fractal.py:802-805 — o = mean(r) -
    s*mean(d) before the clip), so the decode's mean error adds an
    N*((s*-c)*d_mean)^2 term this gain omits when the clip fires.
    Measured cost vs a clip-consistent-offset oracle: < 0.1 dB on the
    parity fixtures (the linear branch already penalizes hard-clipping
    candidates, so surviving winners barely clip)."""
    g = num * num * weight
    if thresh is None:
        return g
    a = jnp.abs(num)
    c = abs(s_clip)
    return jnp.where(a > thresh, c * (2.0 * a - thresh), g)


def exact_search_scan(
    r_c: jnp.ndarray,       # (M, N) centered ranges
    bank: jnp.ndarray,      # (D, N)
    d_mean: jnp.ndarray,
    d_denom: jnp.ndarray,
    d_valid: jnp.ndarray,
    domain_block: int,
    objective: str,
    idx_offset=0,
    d_weight=None,
    precision=None,
    s_clip=None,
    d_thresh=None,
):
    """The scan stage: running (best_score, best_idx, best_sym) per range
    over domain blocks. `idx_offset` shifts emitted indices — used by the
    bank-sharded search to produce global domain indices per shard.
    `d_weight` overrides the objective-derived selection weights; for the
    clip-aware "damped" objective the per-domain clip threshold rides
    along as `d_thresh` (derived from d_denom + s_clip when omitted)."""
    M, N = r_c.shape
    D = bank.shape[0]
    assert D % domain_block == 0
    n_blocks = D // domain_block

    # both orientations in one matmul operand: (2M, N)
    r_both = jnp.concatenate([r_c, r_c[:, ::-1]], axis=0)
    if d_weight is None:
        d_weight = domain_weights(d_mean, d_denom, N, objective)
    if d_thresh is None:
        d_thresh = domain_thresh(d_denom, objective, s_clip)

    bank_blocks = bank.reshape(n_blocks, domain_block, N)
    weight_blocks = d_weight.reshape(n_blocks, domain_block)
    valid_blocks = d_valid.reshape(n_blocks, domain_block)
    thresh_blocks = (
        None if d_thresh is None else d_thresh.reshape(n_blocks, domain_block)
    )

    def step(carry, xs):
        best_score, best_idx, best_sym = carry
        if thresh_blocks is None:
            blk_i, bank_blk, weight_blk, valid_blk = xs
            thresh_blk = None
        else:
            blk_i, bank_blk, weight_blk, valid_blk, thresh_blk = xs

        # num for both orientations: (2M, Db)
        num2 = jax.lax.dot_general(
            r_both, bank_blk,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=precision or jax.lax.Precision.HIGHEST,
        )
        num_o, num_m = num2[:M], num2[M:]
        score_o = _gain_from_num(num_o, weight_blk, thresh_blk, s_clip)
        score_m = _gain_from_num(num_m, weight_blk, thresh_blk, s_clip)

        use_m = score_m > score_o  # strict: original wins ties
        score = jnp.where(use_m, score_m, score_o)
        score = jnp.where(valid_blk[None, :], score, _NEG)

        arg = jnp.argmax(score, axis=1)  # first max -> lowest domain idx
        rows = jnp.arange(M)
        g = score[rows, arg]
        upd = g > best_score  # strict: earlier block wins ties
        new_carry = (
            jnp.where(upd, g, best_score),
            jnp.where(upd, blk_i * domain_block + arg.astype(jnp.int32), best_idx),
            jnp.where(upd, use_m[rows, arg], best_sym),
        )
        return new_carry, None

    init = (
        jnp.full((M,), _NEG, jnp.float32),
        jnp.full((M,), idx_offset, jnp.int32),
        jnp.zeros((M,), bool),
    )
    xs = (
        jnp.arange(n_blocks, dtype=jnp.int32) + idx_offset // domain_block,
        bank_blocks, weight_blocks, valid_blocks,
    )
    if thresh_blocks is not None:
        xs = xs + (thresh_blocks,)
    return jax.lax.scan(step, init, xs)[0]


def exact_refit(
    r_mean: jnp.ndarray,    # (M,)
    r_c: jnp.ndarray,       # (M, N)
    bank: jnp.ndarray,      # (D, N)  (local index space)
    best_score: jnp.ndarray,
    best_idx: jnp.ndarray,  # indices into `bank`
    best_sym: jnp.ndarray,  # bool
    s_clip: float,
):
    """The refit stage: exact (s, o, err) on the gathered winning tile —
    no cancellation, exact stored parameters."""
    tile = bank[best_idx]                                   # (M, N)
    tile = jnp.where(best_sym[:, None], tile[:, ::-1], tile)
    t_mean = jnp.mean(tile, axis=1)
    t_c = tile - t_mean[:, None]
    denom = jnp.sum(t_c * t_c, axis=1)
    num = jnp.sum(r_c * t_c, axis=1)
    s = num / (denom + _EPS)
    o = r_mean - s * t_mean
    resid = r_c - s[:, None] * t_c
    err = jnp.sqrt(jnp.sum(resid * resid, axis=1))
    # no valid domain at all -> +inf err so callers can sentinel it
    err = jnp.where(jnp.isfinite(best_score), err, jnp.inf)
    s = jnp.clip(s, -abs(s_clip), abs(s_clip))
    return best_idx, s, o, best_sym.astype(jnp.uint8), err


def _extract_topk_iter(score, idx, k):
    """(M, k) best (score, idx) pairs by k rounds of max-extract-mask —
    plain elementwise reductions instead of lax.top_k's sort for small k.
    First-max argmax keeps the stable earlier-index tie-break."""
    lane = jax.lax.broadcasted_iota(jnp.int32, score.shape, 1)
    outs_s, outs_i = [], []
    for _ in range(k):
        a = jnp.argmax(score, axis=1)
        outs_s.append(jnp.max(score, axis=1))
        outs_i.append(jnp.take_along_axis(idx, a[:, None], axis=1)[:, 0])
        score = jnp.where(lane == a[:, None], _NEG, score)
    return jnp.stack(outs_s, axis=1), jnp.stack(outs_i, axis=1)


def _topk_merge_scan(score_fn, xs_blocks, M, k, domain_block, n_blocks):
    """Blockwise running best-k merge over domain blocks: each scan step
    scores one block via score_fn(*block_inputs) -> (M, Db) with invalid
    slots at -inf, then merges into the carried (M, k) best — via k rounds
    of max-extraction for small k (the coarse lobe scan), via
    concat + lax.top_k for large k (the reference-shaped MIPS shortlist);
    both are stable (earlier/global-lower indices win ties). Shared by the
    coarse candidate scan (gain scores) and the exact top-k MIPS
    (embedding scores) so the merge/tie-break semantics live in one place.
    Returns (scores (M, k) desc, idx (M, k) int32, -1 where no finite
    score survived)."""
    iter_extract = k <= 8

    def step(carry, xs):
        best_s, best_i = carry
        blk_i = xs[0]
        score = score_fn(*xs[1:])
        idx = jnp.broadcast_to(
            blk_i * domain_block
            + jnp.arange(domain_block, dtype=jnp.int32)[None, :],
            score.shape,
        )
        if iter_extract:
            blk_s, blk_i_top = _extract_topk_iter(score, idx, k)
            # carried entries FIRST: on exact ties the earlier block's
            # (lower-index) candidate wins, same as lax.top_k's stability
            merged_s = jnp.concatenate([best_s, blk_s], axis=1)
            merged_i = jnp.concatenate([best_i, blk_i_top], axis=1)
            top_s, top_i = _extract_topk_iter(merged_s, merged_i, k)
        else:
            merged_s = jnp.concatenate([best_s, score], axis=1)
            merged_i = jnp.concatenate([best_i, idx], axis=1)
            top_s, pos = jax.lax.top_k(merged_s, k)
            top_i = jnp.take_along_axis(merged_i, pos, axis=1)
        return (top_s, top_i), None

    init = (
        jnp.full((M, k), _NEG, jnp.float32),
        jnp.full((M, k), -1, jnp.int32),
    )
    xs = (jnp.arange(n_blocks, dtype=jnp.int32),) + tuple(xs_blocks)
    (scores, idx), _ = jax.lax.scan(step, init, xs)
    return scores, jnp.where(jnp.isfinite(scores), idx, -1)


def gain_topk_scan(
    r_c: jnp.ndarray,        # (M, N) centered ranges
    bank_sub: jnp.ndarray,   # (Dc, N) subsampled bank
    d_weight: jnp.ndarray,   # (Dc,)
    d_valid: jnp.ndarray,    # (Dc,)
    top_c: int,
    domain_block: int,
    d_thresh=None,
    s_clip=None,
    precision=None,
):
    """Top-C *gain* candidates per range over a (subsampled) bank —
    orientation folded in with max (the refine stage re-evaluates both).
    Returns idx (M, C) into the subsampled index space, -1 where invalid.
    `d_thresh`/`s_clip`: clip-aware gains for the "damped" objective.

    `precision` defaults to Precision.DEFAULT — TF32 products on the H100,
    full f32 on the CPU: this picks coarse lobes only; the refine stage
    re-scores in full f32 and the refit is exact, so score noise here costs
    nothing (balanced-objective near-ties are quality-equivalent by
    construction). Oracles pass Precision.HIGHEST."""
    if precision is None:
        precision = jax.lax.Precision.DEFAULT
    M, N = r_c.shape
    Dc = bank_sub.shape[0]
    assert Dc % domain_block == 0
    n_blocks = Dc // domain_block

    if top_c == 1:
        # top-1 degenerates to the running-argmax scan — cheaper than the
        # concat + lax.top_k merge
        score, idx, _ = exact_search_scan(
            r_c, bank_sub, None, None, d_valid, domain_block, "",
            d_weight=d_weight, precision=precision,
            s_clip=s_clip, d_thresh=d_thresh,
        )
        return jnp.where(jnp.isfinite(score), idx, -1)[:, None]

    r_both = jnp.concatenate([r_c, r_c[:, ::-1]], axis=0)
    bank_blocks = bank_sub.reshape(n_blocks, domain_block, N)
    weight_blocks = d_weight.reshape(n_blocks, domain_block)
    valid_blocks = d_valid.reshape(n_blocks, domain_block)
    xs_blocks = [bank_blocks, weight_blocks, valid_blocks]
    if d_thresh is not None:
        xs_blocks.append(d_thresh.reshape(n_blocks, domain_block))

    def score_block(bank_blk, weight_blk, valid_blk, thresh_blk=None):
        num2 = jax.lax.dot_general(
            r_both, bank_blk,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=precision,
        )
        num_o, num_m = num2[:M], num2[M:]
        score = jnp.maximum(
            _gain_from_num(num_o, weight_blk, thresh_blk, s_clip),
            _gain_from_num(num_m, weight_blk, thresh_blk, s_clip),
        )
        return jnp.where(valid_blk[None, :], score, _NEG)

    _, idx = _topk_merge_scan(
        score_block, tuple(xs_blocks),
        M, top_c, domain_block, n_blocks,
    )
    return idx


def _window_gains(r_c, bank_t, cand_t, valid_t, objective, s_clip=None):
    """Gains (and orientation pick) for per-range candidate positions.
    r_c (N, M) centered-transposed ranges; cand_t (K, M) positions into the
    full bank; returns (score, use_m) each (K, M). Lane-major throughout."""
    N = r_c.shape[0]
    K, M = cand_t.shape
    tiles = jnp.take(bank_t, cand_t.reshape(-1), axis=1).reshape(N, K, M)
    d_mean = fold_mean(tiles, 0)
    d_c = tiles - d_mean[None]
    denom = fold_sum(d_c * d_c, 0) + _EPS
    num_o = fold_sum(d_c * r_c[:, None, :], 0)
    num_m = fold_sum(d_c * r_c[::-1][:, None, :], 0)
    if objective == "balanced":
        w = (denom - _EPS - N * d_mean * d_mean) / (denom * denom)
    else:
        w = 1.0 / denom
    thresh = domain_thresh(denom - _EPS, objective, s_clip)
    score_o = _gain_from_num(num_o, w, thresh, s_clip)
    score_m = _gain_from_num(num_m, w, thresh, s_clip)
    use_m = score_m > score_o                                # orig wins ties
    score = jnp.where(use_m, score_m, score_o)
    return jnp.where(valid_t, score, _NEG), use_m


def refine_from_lobes(
    ranges: jnp.ndarray,    # (M, N)
    bank: jnp.ndarray,      # (D, N) full bank, or a LOCAL row shard (+halo)
    d_valid: jnp.ndarray,   # (D,)
    coarse: jnp.ndarray,    # (M, C) coarse lobe indices (subsampled space)
    stride: int,
    s_clip: float,
    objective: str = "balanced",
    two_stage: bool = None,
    bank_offset=0,
    n_valid=None,
    return_score: bool = False,
):
    """The window-refinement stage of the coarse search: the bank is scanned
    at `stride` (gain_topk_scan or the fused kernel in ops.pallas_search),
    and each range's top-C coarse lobes are refined here at full
    resolution.

    Why this is near-exact: with domain_step=1 adjacent domains are
    block_len-sample box means shifted by ONE input sample
    (fractal.py:301,326-327 semantics), so the gain surface num(p)^2*w(p) is
    smooth at the block_len scale (~256 at defaults). Sampling it at
    stride << block_len and refining around the best lobes loses
    essentially nothing — validated against brute-force exact in
    tests/test_search_affine.py and by round-trip SNR. Cost: M*D/stride
    coarse scores + M*W*top_c refine solves, vs M*D for brute force.

    With two_stage (default on for stride >= 32), the +/-stride window is
    sampled at coarse steps first and only a small dense window around the
    best position is evaluated — far less gather volume; safe because the
    gain surface is smooth at the block_len (~256) scale.

    Bank tensor-sharding (models.encode tp path): `bank` may be this
    shard's rows [bank_offset, bank_offset + D_local) of the global bank
    (built with a >= 1.25*stride halo each side so every owned lobe's
    window is resident); `n_valid` is then the GLOBAL valid-domain count
    (defaults to sum(d_valid)). All emitted indices are global; positions
    outside the local shard are masked invalid.
    """
    M, N = ranges.shape
    D = bank.shape[0]
    top_c = coarse.shape[1]
    if two_stage is None:
        two_stage = stride >= 32 and top_c == 1
    local = not (isinstance(bank_offset, int) and bank_offset == 0)
    if local:
        bank_offset = jnp.asarray(bank_offset, jnp.int32)

    def to_loc(pos):
        """Global position -> in-shard row (clamped) + residency mask."""
        if not local:
            return jnp.minimum(pos, D - 1), None
        rel = pos - bank_offset
        return jnp.clip(rel, 0, D - 1), (rel >= 0) & (rel < D)

    # Refine windows of W = 1.25*stride positions around each lobe (the true
    # peak lies within ~stride/2 of the best coarse sample, so W only needs
    # to cover ~0.625*stride each side; measured: widening to 2*stride buys
    # no SNR and costs gather volume). Window starts clamp to
    # [0, n_valid - W] so every fetched row is a real domain; callers
    # guarantee n_valid >= W for the coarse path (models.encode auto rule).
    #
    # Everything below runs in (N, K, M) / (K, M) layout: ranges on the
    # minor axis, so each gathered tap and each per-candidate reduction
    # touches contiguous memory across ranges; the tiny N axis (4 at the
    # defaults) is never the minor one.
    W = max(2, stride + stride // 4)
    K = top_c * W
    if n_valid is None:
        n_valid = jnp.sum(d_valid.astype(jnp.int32))
    lobe_ok = coarse >= 0                                   # (M, C)
    starts = jnp.clip(coarse * stride - W // 2, 0, jnp.maximum(n_valid - W, 0))
    # (K, M) candidate matrix, K = C*W
    cand_t = (
        starts.T[:, None, :] + jnp.arange(W, dtype=jnp.int32)[None, :, None]
    ).reshape(K, M)
    valid_t = jnp.broadcast_to(lobe_ok.T[:, None, :], (top_c, W, M)).reshape(K, M)

    bank_t = bank.T                                          # (N, D)
    r_t = ranges.T                                           # (N, M)
    r_mean = fold_mean(r_t, 0)                               # (M,)
    r_c = r_t - r_mean[None, :]
    cols = jnp.arange(M)

    if two_stage:
        # staged descent: sample the window at step s, halving the peak
        # uncertainty to s/2 per stage, finish with a small dense window.
        # (16, 4) for W >= 64 costs 6+5+6 = 17 gathered positions vs 11+10
        # for the single (8,) stage — same smoothness assumption (the gain
        # surface varies at the block_len ~ 256 scale, far coarser than 16).
        steps = (16, 4) if W >= 64 else (8,)
        st = steps[0]
        k1 = W // st + 1
        mid = (starts.T[:, None, :]
               + (st * jnp.arange(k1, dtype=jnp.int32))[None, :, None]
               ).reshape(top_c * k1, M)
        mid = jnp.minimum(mid, jnp.maximum(n_valid - 1, 0))
        v1 = jnp.broadcast_to(lobe_ok.T[:, None, :], (top_c, k1, M)
                              ).reshape(top_c * k1, M)
        mloc, res = to_loc(mid)
        v1 = v1 & (mid < n_valid)
        if res is not None:
            v1 = v1 & res
        s1, _ = _window_gains(r_c, bank_t, mloc, v1, objective, s_clip)
        center = mid[jnp.argmax(s1, axis=0), cols]
        ok_any = jnp.any(lobe_ok, axis=1)
        for st2 in steps[1:]:
            # cover center +/- st/2 at the finer step st2
            u = st // 2
            k = 2 * u // st2 + 1
            mid = (center[None, :] - u) + st2 * jnp.arange(k, dtype=jnp.int32)[:, None]
            mid = jnp.clip(mid, 0, jnp.maximum(n_valid - 1, 0))
            vk = jnp.broadcast_to(ok_any[None, :], (k, M)) & (mid < n_valid)
            mloc, res = to_loc(mid)
            if res is not None:
                vk = vk & res
            sk, _ = _window_gains(r_c, bank_t, mloc, vk, objective, s_clip)
            center = mid[jnp.argmax(sk, axis=0), cols]
            st = st2
        # final stage: dense +/- st/2 (+1 margin) around the best sample
        w2 = st + 2
        starts2 = jnp.clip(center - w2 // 2, 0, jnp.maximum(n_valid - w2, 0))
        cand_t = starts2[None, :] + jnp.arange(w2, dtype=jnp.int32)[:, None]
        valid_t = jnp.broadcast_to(ok_any[None, :], (w2, M))
    # else: cand_t / valid_t from the dense single-stage window above

    # bank rows past n_valid are zero padding: they score exactly 0, which
    # can beat real (negative-weight) balanced scores — mask them out so an
    # out-of-range index can never be emitted (window starts are clamped to
    # n_valid - W, but that is not enough when n_valid < W)
    valid_t = valid_t & (cand_t < n_valid)

    cand_loc, res = to_loc(cand_t)
    if res is not None:
        valid_t = valid_t & res
    score, use_m = _window_gains(r_c, bank_t, cand_loc, valid_t, objective, s_clip)
    pick = jnp.argmax(score, axis=0)                         # (M,) first max
    # emitted indices are GLOBAL; in the non-sharded case clamp exactly as
    # the gather did (only reachable when every candidate is invalid)
    best_idx = (cand_t if local else jnp.minimum(cand_t, D - 1))[pick, cols]
    best_sym = use_m[pick, cols]
    best_score = score[pick, cols]

    # exact refit on the winning tile, still transposed
    tile = jnp.take(bank_t, cand_loc[pick, cols], axis=1)    # (N, M)
    tile = jnp.where(best_sym[None, :], tile[::-1, :], tile)
    t_mean = jnp.mean(tile, axis=0)
    t_c = tile - t_mean[None, :]
    t_denom = jnp.sum(t_c * t_c, axis=0)
    t_num = jnp.sum(r_c * t_c, axis=0)
    s = t_num / (t_denom + _EPS)
    o = r_mean - s * t_mean
    resid = r_c - s[None, :] * t_c
    err = jnp.sqrt(jnp.sum(resid * resid, axis=0))
    err = jnp.where(jnp.isfinite(best_score), err, jnp.inf)
    s = jnp.clip(s, -abs(s_clip), abs(s_clip))
    if return_score:
        # selection score of the winner — the tp path merges per-shard
        # refinements with it (a shard seeing only part of a window yields
        # a subset-max that can never beat the owning shard's full max)
        return best_idx, s, o, best_sym.astype(jnp.uint8), err, best_score
    return best_idx, s, o, best_sym.astype(jnp.uint8), err


def merge_shard_bests(score, idx, sym, axis_name):
    """all_gather the per-shard (score, idx, sym) winners and reduce with
    the single-device tie-break order: max score, then min global domain
    idx, then original orientation (sym=0) first. Inputs (M,) per shard;
    returns merged (M,) triples, replicated over `axis_name`. Used by the
    bank-tensor-sharded (tp) search paths (models.encode, parallel.shard)."""
    scores = jax.lax.all_gather(score, axis_name)   # (S, M)
    idxs = jax.lax.all_gather(idx, axis_name)
    syms = jax.lax.all_gather(sym, axis_name)

    n_shards = scores.shape[0]
    best_s, best_i, best_y = scores[0], idxs[0], syms[0]
    for k in range(1, n_shards):
        s_k, i_k, y_k = scores[k], idxs[k], syms[k]
        better = s_k > best_s
        tie = s_k == best_s
        take = better | (tie & (i_k < best_i)) | (
            tie & (i_k == best_i) & (~y_k & best_y)
        )
        best_s = jnp.where(take, s_k, best_s)
        best_i = jnp.where(take, i_k, best_i)
        best_y = jnp.where(take, y_k, best_y)
    return best_s, best_i, best_y


def topk_scores_block(
    q: jnp.ndarray,          # (M, E) query embeddings
    bank_emb: jnp.ndarray,   # (D, E) bank embeddings
    d_valid: jnp.ndarray,    # (D,) bool
    top_k: int,
    domain_block: int,
):
    """Blockwise exact top-k MIPS with a running best-k merge — the on-device
    replacement for the hnswlib index (reference: fractal.py:353-381,
    605-620). Returns (scores (M, k) desc, idx (M, k) int32; invalid slots
    idx=-1)."""
    M, E = q.shape
    D = bank_emb.shape[0]
    assert D % domain_block == 0
    n_blocks = D // domain_block

    emb_blocks = bank_emb.reshape(n_blocks, domain_block, E)
    valid_blocks = d_valid.reshape(n_blocks, domain_block)

    def score_block(emb_blk, valid_blk):
        scores = jax.lax.dot_general(
            q, emb_blk,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # (M, Db)
        return jnp.where(valid_blk[None, :], scores, _NEG)

    return _topk_merge_scan(
        score_block, (emb_blocks, valid_blocks), M, top_k, domain_block,
        n_blocks,
    )


def topk_search_block(
    ranges: jnp.ndarray,
    bank: jnp.ndarray,
    bank_emb: jnp.ndarray,
    d_valid: jnp.ndarray,
    top_k: int,
    domain_block: int,
    s_clip: float,
    emb_dim: int = 16,
    objective: str = "affine",
    return_score: bool = False,
):
    """Reference-shaped two-stage search for one range block: true range
    embeddings (fixing the reference's range/domain embedding swap,
    fractal.py:1190-1195) -> blockwise top-k MIPS -> batched mirrored affine
    solve over the shortlist. return_score appends the winner's selection
    score and argmin position (see ops.affine.batched_affine_match)."""
    q = multi_head_embedding_batch(ranges, tonal_k=emb_dim // 2, transient_k=emb_dim // 2)
    _, cand = topk_scores_block(q, bank_emb, d_valid, top_k, domain_block)
    return batched_affine_match(ranges, cand, bank, s_clip=s_clip,
                                objective=objective, return_score=return_score)


def range_candidates_from_embedding(range_block, domain_embs, emb_dim: int = 16,
                                    top_k: int = 32):
    """Reference-shaped candidate selection that recomputes the query
    embedding from the raw range (fractal.py:337-351 signature)."""
    from .dct import multi_head_embedding

    q = multi_head_embedding(
        range_block, tonal_k=emb_dim // 2, transient_k=emb_dim - emb_dim // 2
    )
    return range_candidates_from_embedding_emb(q, domain_embs, top_k=top_k)


def range_candidates_from_embedding_emb(q, domain_embs, top_k: int = 64):
    """Dense top-k by inner product for a single query (reference:
    fractal.py:535-541 API shape), returned in descending score order."""
    import numpy as np

    q = np.asarray(q, dtype=np.float32)
    domain_embs = np.asarray(domain_embs, dtype=np.float32)
    scores = domain_embs @ q
    if top_k >= len(scores):
        return np.argsort(scores)[::-1].astype(np.int32)
    idxs = np.argpartition(scores, -top_k)[-top_k:]
    return idxs[np.argsort(scores[idxs])[::-1]].astype(np.int32)


def pad_candidates(idxs, top_k: int):
    """Pad/truncate a candidate list to fixed top_k with -1 fill (reference:
    fractal.py:544-552)."""
    import numpy as np

    if idxs is None or len(idxs) == 0:
        return np.full(top_k, -1, dtype=np.int32)
    idxs = np.asarray(idxs, dtype=np.int32)
    if len(idxs) >= top_k:
        return idxs[:top_k]
    out = np.full(top_k, -1, dtype=np.int32)
    out[: len(idxs)] = idxs
    return out
