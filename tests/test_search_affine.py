"""Search + affine solve vs brute-force numpy goldens.

The golden implements the reference's batched solve math
(_process_gpu_batch, fractal.py:757-850): gather, mirror-concat, center,
closed-form (s, o), full recon L2, pad-mask to inf, argmin, clip-after."""

import jax.numpy as jnp
import numpy as np

from fwav.ops.affine import batched_affine_match
from fwav.ops.dct import multi_head_embedding_batch
from fwav.ops.search import (
    exact_search_block,
    pad_candidates,
    range_candidates_from_embedding_emb,
    topk_scores_block,
)
from fwav.ops.affine import affine_stats


def _ref_affine_batch(ranges, domain_idxs, bank, s_clip=16.0):
    B, N = ranges.shape
    K = domain_idxs.shape[1]
    safe = np.where(domain_idxs < 0, 0, domain_idxs)
    d = bank[safe]
    d_sym = np.concatenate([d, d[:, :, ::-1]], axis=1)
    sym_flags = np.concatenate([np.zeros((B, K), np.int8), np.ones((B, K), np.int8)], 1)
    idx_sym = np.concatenate([safe, safe], axis=1)
    r_mean = ranges.mean(1, keepdims=True)
    r_c = ranges - r_mean
    d_mean = d_sym.mean(2, keepdims=True)
    d_c = d_sym - d_mean
    num = np.sum(d_c * r_c[:, None, :], axis=2)
    denom = np.sum(d_c * d_c, axis=2) + 1e-12
    s = num / denom
    o = r_mean - s * d_mean[:, :, 0]
    recon = s[:, :, None] * d_sym + o[:, :, None]
    err = np.linalg.norm(recon - ranges[:, None, :], axis=2)
    err = np.where(np.concatenate([domain_idxs < 0] * 2, axis=1), np.inf, err)
    pick = np.argmin(err, axis=1)
    rows = np.arange(B)
    return (
        idx_sym[rows, pick],
        np.clip(s[rows, pick], -s_clip, s_clip),
        o[rows, pick],
        sym_flags[rows, pick],
        err[rows, pick],
    )


def _rand_problem(seed, B=16, K=8, D=64, N=4):
    rng = np.random.default_rng(seed)
    ranges = rng.standard_normal((B, N)).astype(np.float32)
    bank = rng.standard_normal((D, N)).astype(np.float32)
    cand = rng.integers(0, D, size=(B, K)).astype(np.int32)
    cand[0, 3:] = -1  # padded slots
    cand[1, :] = -1   # fully padded row
    return ranges, bank, cand


def test_affine_match_vs_golden():
    for seed in range(3):
        ranges, bank, cand = _rand_problem(seed)
        gi, gs, go, gy, ge = _ref_affine_batch(ranges, cand, bank)
        idx, s, o, sym, err = (
            np.asarray(x)
            for x in batched_affine_match(jnp.asarray(ranges), jnp.asarray(cand), jnp.asarray(bank))
        )
        np.testing.assert_array_equal(idx, gi)
        np.testing.assert_array_equal(sym, gy)
        np.testing.assert_allclose(s, gs, atol=1e-4)
        np.testing.assert_allclose(o, go, atol=1e-4)
        finite = np.isfinite(ge)
        np.testing.assert_allclose(err[finite], ge[finite], atol=1e-4)
        assert np.all(np.isinf(err[~finite]))


def test_affine_constructed_exact_match():
    # r = 2*d + 0.5 exactly -> s=2, o=0.5, err~0, sym=0
    rng = np.random.default_rng(9)
    d = rng.standard_normal((1, 8)).astype(np.float32)
    r = 2.0 * d + 0.5
    idx, s, o, sym, err = batched_affine_match(
        jnp.asarray(r), jnp.zeros((1, 1), jnp.int32), jnp.asarray(d)
    )
    np.testing.assert_allclose(float(s[0]), 2.0, atol=1e-4)
    np.testing.assert_allclose(float(o[0]), 0.5, atol=1e-4)
    assert float(err[0]) < 1e-3
    assert int(sym[0]) == 0


def test_affine_mirror_detection():
    rng = np.random.default_rng(10)
    d = rng.standard_normal((1, 8)).astype(np.float32)
    r = 1.5 * d[:, ::-1] - 0.2
    idx, s, o, sym, err = batched_affine_match(
        jnp.asarray(np.ascontiguousarray(r)), jnp.zeros((1, 1), jnp.int32), jnp.asarray(d)
    )
    assert int(sym[0]) == 1
    np.testing.assert_allclose(float(s[0]), 1.5, atol=1e-4)
    assert float(err[0]) < 1e-3


def test_exact_search_matches_full_affine_over_all_domains():
    """Exact search == affine solve with ALL domains as candidates."""
    for seed in range(3):
        rng = np.random.default_rng(100 + seed)
        M, D, N = 32, 128, 4
        ranges = rng.standard_normal((M, N)).astype(np.float32)
        bank = rng.standard_normal((D, N)).astype(np.float32)
        all_cand = np.broadcast_to(np.arange(D, dtype=np.int32), (M, D)).copy()
        gi, gs, go, gy, ge = _ref_affine_batch(ranges, all_cand, bank)

        d_mean, d_denom = affine_stats(jnp.asarray(bank))
        idx, s, o, sym, err = (
            np.asarray(x)
            for x in exact_search_block(
                jnp.asarray(ranges), jnp.asarray(bank), d_mean, d_denom,
                jnp.ones(D, bool), domain_block=32, s_clip=16.0,
                objective="affine",
            )
        )
        np.testing.assert_allclose(err, ge, atol=1e-3)
        np.testing.assert_allclose(s, gs, atol=1e-3)
        np.testing.assert_allclose(o, go, atol=1e-3)
        # index/sym can differ only on near-exact err ties
        differs = idx != gi
        if differs.any():
            np.testing.assert_allclose(err[differs], ge[differs], rtol=1e-4)


def test_exact_search_respects_domain_validity():
    rng = np.random.default_rng(11)
    M, D, N = 8, 64, 4
    ranges = rng.standard_normal((M, N)).astype(np.float32)
    bank = rng.standard_normal((D, N)).astype(np.float32)
    valid = np.zeros(D, bool)
    valid[:10] = True
    d_mean, d_denom = affine_stats(jnp.asarray(bank))
    for objective in ("affine", "balanced"):
        idx, *_ = exact_search_block(
            jnp.asarray(ranges), jnp.asarray(bank), d_mean, d_denom,
            jnp.asarray(valid), domain_block=16, s_clip=16.0,
            objective=objective,
        )
        assert np.all(np.asarray(idx) < 10)


def test_topk_scores_match_dense():
    rng = np.random.default_rng(12)
    M, D, E, K = 8, 256, 16, 32
    tiles = rng.standard_normal((D, 4)).astype(np.float32)
    bank_emb = np.asarray(multi_head_embedding_batch(jnp.asarray(tiles)))
    q = np.asarray(multi_head_embedding_batch(jnp.asarray(rng.standard_normal((M, 4)).astype(np.float32))))
    scores, idx = topk_scores_block(
        jnp.asarray(q), jnp.asarray(bank_emb), jnp.ones(D, bool), K, 64
    )
    scores, idx = np.asarray(scores), np.asarray(idx)
    dense = q @ bank_emb.T
    for i in range(M):
        want = np.sort(dense[i])[::-1][:K]
        np.testing.assert_allclose(np.sort(scores[i])[::-1], want, atol=1e-5)
        # returned indices really achieve the returned scores
        np.testing.assert_allclose(dense[i, idx[i]], scores[i], atol=1e-5)


def test_pad_and_dense_candidate_helpers():
    assert list(pad_candidates(None, 4)) == [-1, -1, -1, -1]
    assert list(pad_candidates([7, 3], 4)) == [7, 3, -1, -1]
    assert list(pad_candidates(np.arange(10), 4)) == [0, 1, 2, 3]
    rng = np.random.default_rng(13)
    embs = rng.standard_normal((50, 16)).astype(np.float32)
    q = rng.standard_normal(16).astype(np.float32)
    got = range_candidates_from_embedding_emb(q, embs, top_k=5)
    want = np.argsort(embs @ q)[::-1][:5]
    np.testing.assert_array_equal(got, want)


def test_batched_affine_match_return_score_contract():
    """return_score=True appends (selection score at the winner, argmin
    position in the originals-then-mirrors arrangement) without changing
    the first five outputs; the position decodes back to (slot, sym) and
    an all-invalid row reports +inf score. The tp shortlist merge keys its
    cross-shard tie-break on this position."""
    rng = np.random.default_rng(7)
    B, K, D, N = 32, 6, 64, 8
    ranges = rng.standard_normal((B, N)).astype(np.float32)
    bank = rng.standard_normal((D, N)).astype(np.float32)
    cand = rng.integers(0, D, (B, K)).astype(np.int32)
    cand[0, :] = -1                     # all-invalid row
    cand[1, 3:] = -1                    # partially padded row

    base = batched_affine_match(jnp.asarray(ranges), jnp.asarray(cand),
                                jnp.asarray(bank), objective="balanced")
    idx, s, o, sym, err, sel, pick = batched_affine_match(
        jnp.asarray(ranges), jnp.asarray(cand), jnp.asarray(bank),
        objective="balanced", return_score=True,
    )
    for a, b in zip((idx, s, o, sym, err), base):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    pick = np.asarray(pick)
    sel = np.asarray(sel)
    idx = np.asarray(idx)
    sym = np.asarray(sym)
    assert np.isinf(sel[0]) and np.isinf(np.asarray(err)[0])
    live = ~np.isinf(sel)
    slot = np.where(pick >= K, pick - K, pick)
    # position decodes to the winning (candidate slot, orientation)
    safe = np.where(cand < 0, 0, cand)
    np.testing.assert_array_equal(idx[live], safe[np.arange(B), slot][live])
    np.testing.assert_array_equal(sym[live], (pick >= K).astype(np.uint8)[live])
    # the winner's slot is a valid (non-padded) candidate
    assert np.all(cand[np.arange(B), slot][live] >= 0)


def test_fold_sum_is_a_left_fold_whatever_the_shape():
    """fold_sum pins the tap-axis summation order to ((a+b)+c)+d for every
    element, whatever the other dimensions (the selection must not depend
    on the compiled chunk shape): [1e8, 1, -1e8, 1] sums to 1 left to right
    in f32 and to 0 pairwise."""
    from fwav.ops.search import fold_mean, fold_sum

    row = np.array([1e8, 1.0, -1e8, 1.0], np.float32)
    for m in (1, 3, 64):
        x = jnp.asarray(np.tile(row, (m, 1)))
        np.testing.assert_array_equal(np.asarray(fold_sum(x, 1)), np.ones(m))
        np.testing.assert_array_equal(np.asarray(fold_sum(x.T, 0)), np.ones(m))
        np.testing.assert_array_equal(np.asarray(fold_mean(x, -1)),
                                      np.full(m, 0.25, np.float32))
