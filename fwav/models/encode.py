"""Encode engine: compress_audio (reference: fractal.py:1045-1273).

The reference's encode is a heterogeneous pipeline — N CPU search processes
feeding a GPU solve process through bounded mp.Queues, with memmapped domain
banks and an optional hnswlib index. Here all of that collapses into ONE
jitted XLA program per shape bucket:

    padded signal -> VAD mask (cummax hysteresis) -> ranges
    raw signal    -> box-mean domain bank (shifted adds + gather)
    search        -> blockwise matched-filter argmax (exact, default)
                     or embeddings + blockwise top-k MIPS + affine solve
    sentinels     -> energy-pruned / padded ranges emit (-1, 1, 0, 0, 0)

Static-shape discipline: signal length, range count and domain count are
bucketed ({2^k, 3*2^(k-1)} grid) and masked; one compile per bucket triple.

The public compress_audio keeps the reference's signature and 8-tuple return
(matches list, domains, n_ranges, range_size, tile_size, domain_step,
energy_thresh, original_len). compress_audio_arrays is the fast-path variant
returning a packed match record array instead of a Python tuple list.

Sentinel policy: silent (energy-pruned) ranges are stored as the format's
true (-1, 1.0, 0.0, 0, 0.0) sentinel. The reference's live pipeline instead
stored (domain 0, s~0, o~0, 0, +inf) because its all-inf argmin picked slot 0
(fractal.py:816-825); its own decoder fully supports -1 (fractal.py:1398-1426)
and the dead _worker_batch path emitted exactly this tuple (fractal.py:1037).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EncoderConfig
from ..io.container import MATCH_DTYPE
from ..ops.affine import affine_stats
from ..ops.dct import multi_head_embedding_batch
from ..ops.domains import build_bank_jax, build_domains_host, n_domains_for
from ..ops import pallas_search
from ..ops.search import (
    domain_thresh,
    domain_weights,
    exact_search_block,
    gain_topk_scan,
    refine_from_lobes,
    topk_search_block,
)
from ..ops.vad import voiced_detection
from ..parallel.mesh import fetch_global
from ..utils.buckets import bucket, pad_to
from ..utils.logging import device_banner
from ..utils.trace import phase


import threading

#: One device, one compute queue: jitted dispatch from batch worker threads
#: is serialized behind this lock (the device runs one program at a time
#: anyway). Host-side work stays parallel.
DEVICE_LOCK = threading.Lock()

#: Largest whole-file bank (rows) the global pass ships over the shards'
#: 3-byte idx protocol; beyond it the pass falls back to int32 both ways
#: (models.stream._global_pass mirrors this switch; module attribute so
#: tests can drive the int32 branch without a 6-minute fixture).
PACK3_MAX_ROWS = (1 << 24) - 1
#: The 3-byte little-endian idx transport's dead-slot marker; valid
#: indices stay below it by the callers' 2^24 guards. The helpers below
#: are the ONLY pack/unpack implementations — the byte order and sentinel
#: must stay bit-identical between the device (jnp) and host (np) halves.
IDX3_SENTINEL = 0xFFFFFF


def pack3_jnp(code):
    """(m,) int32 codes (IDX3_SENTINEL = dead) -> (m, 3) uint8, on device."""
    return jnp.stack(
        [
            (code & 0xFF).astype(jnp.uint8),
            ((code >> 8) & 0xFF).astype(jnp.uint8),
            ((code >> 16) & 0xFF).astype(jnp.uint8),
        ],
        axis=1,
    )


def unpack3_jnp(b3):
    """(m, 3) uint8 -> (m,) int32 rows, -1 where the sentinel, on device."""
    c = (
        b3[:, 0].astype(jnp.int32)
        | (b3[:, 1].astype(jnp.int32) << 8)
        | (b3[:, 2].astype(jnp.int32) << 16)
    )
    return jnp.where(c == IDX3_SENTINEL, -1, c)


def pack3_np(rows):
    """(m,) integer rows (< 0 = dead) -> (m, 3) uint8, host side."""
    code = np.where(rows < 0, IDX3_SENTINEL, rows).astype(np.int64)
    return np.stack(
        [code & 0xFF, (code >> 8) & 0xFF, (code >> 16) & 0xFF], axis=1
    ).astype(np.uint8)


def unpack3_np(b3):
    """(m, 3) uint8 -> (m,) int64 rows, -1 where the sentinel, host side."""
    b3 = b3.astype(np.int64)
    c = b3[:, 0] | (b3[:, 1] << 8) | (b3[:, 2] << 16)
    return np.where(c == IDX3_SENTINEL, -1, c)


def _pow2_divisor(n: int, cap: int) -> int:
    p = 1
    while n % (p * 2) == 0 and p * 2 <= cap:
        p *= 2
    return p


def build_encode_core(
    nb: int,
    lb: int,
    db: int,
    tile_size: int,
    range_size: int,
    domain_step: int,
    search: str,
    top_k: int,
    emb_dim: int,
    fast_mode: bool,
    s_clip: float,
    domain_block: int,
    range_block: int,
    objective: str,
    coarse_stride: int = 128,
    coarse_topc: int = 1,
    use_pallas: bool = False,
    mode: str = "raw",
    in_i16: bool = False,
    energy_thresh: float = None,
    dp: int = 1,
    tp: int = 1,
    dp_axis: str = "dp",
    tp_axis: str = "tp",
):
    """Build the (unjitted) fused encode program for one shape bucket.

    Two input protocols (static `mode`), both shipping ONE signal array
    (int16 when the content is 16-bit-exact — `in_i16`) and doing scale
    normalization + range construction on device:

    - mode="raw" (single-shot files): the VAD mask (fractal.py:1074-1079
      semantics) and the reflect range padding (fractal.py:1095-1097) are
      computed on device; fn(raw (nb,), meta int32[3] = [n_samples,
      n_ranges, n_domains]). Counts ride ONE tiny array (one transfer, not
      three) and the raw-scale `energy_thresh` is compiled
      in (static: it is a config constant, not per-file data).
    - mode="masked" (streaming shards, models.stream): VAD decisions must be
      GLOBAL across shards (hysteresis state carries from t=0), so the host
      ships its per-sample voiced mask as PACKED BITS (1 bit/sample —
      nb/8 bytes) alongside the raw window; fn(raw (nb,), mask_bytes
      (nb/8,), meta int32[4] = [n_window_samples, range_offset,
      n_ranges_shard, n_domains_window]). Emitted indices are window-local.

    One output protocol: (mb, 3) uint8 — the selected domain index in 3
    little-endian bytes (0xFFFFFF = sentinel; valid indices stay below it
    by the 2^24 guard). s/o/err AND the mirror orientation are recomputed
    HOST-side with the exact f32 refit against the serialized bank
    (ops.affine.refit_host + collect_idx_matches): only the selection
    crosses the slow device->host path, and the stored parameters are
    exactly consistent with the stored bank.

    Multi-chip (SURVEY.md §2.5; the reference's np.array_split over CPU
    workers, fractal.py:1180-1207, and the codec analog of TP): with dp>1
    and/or tp>1 the returned core MUST run inside jax.shard_map over a mesh
    with axes {dp_axis: dp, tp_axis: tp} (parallel.shard wires this up).
    Each device slices its own contiguous range slab (dp — zero
    communication) and/or builds + scans only its bank row-shard (tp — one
    all_gather of per-shard winners, merged with the single-device
    tie-break order). Because only the SELECTION leaves the device and the
    stored s/o/err come from the host refit, sharded output is bit-equal to
    single-device output by construction."""
    n = range_size
    mb = lb // n
    dblk = _pow2_divisor(db, domain_block)
    assert mode in ("raw", "masked", "global")
    # coarse's tp sharding splits RANGES (see finish below), so the range
    # axis must divide dp*tp ways there; exact/topk shard bank rows instead
    rsplit = dp * (tp if (tp > 1 and search == "coarse") else 1)
    assert mb % rsplit == 0 and db % tp == 0 and nb % 8 == 0
    assert mode != "global" or dp * tp == 1  # the pass runs unsharded
    assert energy_thresh is not None
    thresh = float(energy_thresh)

    def lobe_scan(r_c, bank_sub, w_sub, v_sub, topc, cdblk, t_sub):
        """(m, topc) coarse lobes: the fused Triton scan, or the lax.scan
        path (ops.search.gain_topk_scan) that is its oracle."""
        with jax.named_scope("lobe_scan"):
            if use_pallas:
                return pallas_search.scan_topc(
                    r_c, bank_sub, w_sub, v_sub, topc, d_thresh=t_sub,
                    s_clip=s_clip,
                )[1]
            return gain_topk_scan(
                r_c, bank_sub, w_sub, v_sub, topc, cdblk, d_thresh=t_sub,
                s_clip=s_clip,
            )

    def refine(rb, bank, d_valid, lobes, stride):
        """Full-resolution window refinement of the lobes: (idx, score)."""
        with jax.named_scope("refine"):
            out = refine_from_lobes(rb, bank, d_valid, lobes, stride, s_clip,
                                    objective, return_score=True)
        return out[0], out[-1]

    def sub_bank(bank, d_valid, stride):
        """Stride-subsampled bank rows with their selection stats (weights
        are per-row, so this is bit-equal to subsampling full-bank
        weights at 1/stride of the work)."""
        dc = bank.shape[0] // stride
        bank_sub = bank.reshape(dc, stride, n)[:, 0, :]
        sub_mean, sub_denom = affine_stats(bank_sub)
        return (
            bank_sub,
            domain_weights(sub_mean, sub_denom, n, objective),
            d_valid.reshape(dc, stride)[:, 0],
            domain_thresh(sub_denom, objective, s_clip),
            _pow2_divisor(dc, domain_block),
        )

    def run_search(ranges, bank, d_valid):
        """(idx, score) per range: the selected domain and its selection
        score (non-finite = no valid candidate)."""
        rblk = _pow2_divisor(ranges.shape[0], range_block)
        if search == "exact":
            d_mean, d_denom = affine_stats(bank)
            if use_pallas:
                d_weight = domain_weights(d_mean, d_denom, n, objective)
                d_thr = domain_thresh(d_denom, objective, s_clip)

            @jax.named_scope("exact_scan")
            def do_block(rb):
                if use_pallas:
                    r_c = rb - jnp.mean(rb, axis=1, keepdims=True)
                    score, idx = pallas_search.scan_topc(
                        r_c, bank, d_weight, d_valid, 1, d_thresh=d_thr,
                        s_clip=s_clip,
                    )
                    return idx[:, 0], score[:, 0]
                out = exact_search_block(
                    rb, bank, d_mean, d_denom, d_valid, dblk, s_clip,
                    objective=objective, return_score=True,
                )
                return out[0], out[-1]
        elif search == "coarse":
            bank_sub, w_sub, v_sub, t_sub, cdblk = sub_bank(
                bank, d_valid, coarse_stride
            )

            def do_block(rb):
                r_c = rb - jnp.mean(rb, axis=1, keepdims=True)
                lobes = lobe_scan(r_c, bank_sub, w_sub, v_sub, coarse_topc,
                                  cdblk, t_sub)
                return refine(rb, bank, d_valid, lobes, coarse_stride)
        else:
            bank_emb = multi_head_embedding_batch(
                bank, tonal_k=emb_dim // 2, transient_k=emb_dim // 2
            )

            def do_block(rb):
                idx, s, o, sym, err, sel, _pick = topk_search_block(
                    rb, bank, bank_emb, d_valid, top_k, dblk, s_clip, emb_dim,
                    objective=objective, return_score=True,
                )
                # the true selection score (negated: callers treat larger
                # as better, +inf marks no-valid-candidate rows)
                return idx, jnp.where(jnp.isfinite(sel), -sel, -jnp.inf)

        m = ranges.shape[0]
        outs = jax.lax.map(do_block, ranges.reshape(m // rblk, rblk, n))
        return tuple(x.reshape(m) for x in outs)

    def pack_out(ranges, idx, score, n_ranges, energy_thresh_n, row0=0):
        # sentinels: energy-pruned (fast_mode, 0.75*thresh on mean power —
        # fractal.py:602), bucket-pad rows, and no-valid-candidate rows
        # (non-finite selection score — using the score rather than the
        # refit error lets XLA dead-code-eliminate the device-side refit
        # chain entirely; s/o/err/sym are host-refit).
        # Output: 3 bytes per range — the domain index (< 2^24-1 by the
        # encoder guard; 0xFFFFFF = sentinel). idx is ALL that crosses the
        # slow device->host link.
        m = ranges.shape[0]
        r_pow = jnp.mean(ranges * ranges, axis=1)
        r_valid = row0 + jnp.arange(m, dtype=jnp.int32) < n_ranges
        silent = (r_pow < energy_thresh_n * 0.75) if fast_mode else jnp.zeros(m, bool)
        dead = silent | ~r_valid | ~jnp.isfinite(score)
        return pack3_jnp(jnp.where(dead, IDX3_SENTINEL, idx).astype(jnp.int32))

    if tp > 1:
        assert search in ("exact", "coarse", "topk"), search

    def run_search_tp(ranges, raw_norm, n_domains):
        """Bank tensor-sharded search for exact/topk (runs inside shard_map
        over `tp_axis`): each device builds + scans only its contiguous
        bank row-shard; per-shard winners merge with one all_gather in the
        single-device tie-break order. Returns (idx GLOBAL, sym, ok),
        replicated over tp. (Coarse tp sharding splits ranges instead —
        see finish.)"""
        assert search in ("exact", "topk"), search
        from ..ops.search import exact_search_scan, merge_shard_bests

        j = jax.lax.axis_index(tp_axis)
        dloc = db // tp
        rblk = _pow2_divisor(ranges.shape[0], range_block)

        # shared shard-bank setup: each device owns a contiguous, disjoint
        # slice of dloc bank rows
        off = j * dloc
        bank_loc = build_bank_jax(
            raw_norm, tile_size, range_size, domain_step, db, n_domains,
            row_offset=off, d_rows=dloc,
        )
        v_loc = off + jnp.arange(dloc, dtype=jnp.int32) < n_domains
        ldblk = _pow2_divisor(dloc, domain_block)

        if search == "exact":
            d_mean, d_denom = affine_stats(bank_loc)

            def do_chunk(rb):
                r_c = rb - jnp.mean(rb, axis=1, keepdims=True)
                if use_pallas:
                    w = domain_weights(d_mean, d_denom, n, objective)
                    t = domain_thresh(d_denom, objective, s_clip)
                    # orientation is host-derived under the idx protocol,
                    # and the cross-shard sym tie-break can never fire
                    # (shard winners live in disjoint index spaces)
                    score, lidx = pallas_search.scan_topc(
                        r_c, bank_loc, w, v_loc, 1, d_thresh=t, s_clip=s_clip,
                    )
                    score, idx = score[:, 0], off + jnp.maximum(lidx[:, 0], 0)
                    sym = jnp.zeros(score.shape, bool)
                else:
                    score, idx, sym = exact_search_scan(
                        r_c, bank_loc, d_mean, d_denom, v_loc, ldblk,
                        objective, idx_offset=off, s_clip=s_clip,
                    )
                score, idx, sym = merge_shard_bests(score, idx, sym, tp_axis)
                return idx, sym, jnp.isfinite(score)

        else:  # topk
            # reference-shaped two-stage search under tp: each shard runs
            # the exact top-k MIPS over its own bank rows, the per-shard
            # shortlists all_gather into the EXACT global top-k (multi-key
            # sort by (score desc, idx asc) — the same total order
            # _topk_merge_scan's lower-index-stable merge realizes on one
            # device), then each shard solves the affine pick for the
            # candidates IT owns and the winners merge keyed on the argmin
            # position, replicating the single-device slot-order tie-break
            # bit-for-bit (fractal.py:353-381,535-552 parallelized).
            from ..ops.affine import batched_affine_match
            from ..ops.search import topk_scores_block

            bank_emb_loc = multi_head_embedding_batch(
                bank_loc, tonal_k=emb_dim // 2, transient_k=emb_dim // 2
            )
            imax = jnp.iinfo(jnp.int32).max

            def do_chunk(rb):
                q = multi_head_embedding_batch(
                    rb, tonal_k=emb_dim // 2, transient_k=emb_dim // 2
                )
                sc, lidx = topk_scores_block(
                    q, bank_emb_loc, v_loc, top_k, ldblk
                )                                             # (m, k) each
                key = jnp.where(lidx >= 0, off + lidx, imax)  # idx asc key
                sc_all = jax.lax.all_gather(sc, tp_axis, axis=1, tiled=True)
                key_all = jax.lax.all_gather(key, tp_axis, axis=1, tiled=True)
                _, key_sorted = jax.lax.sort(
                    (-sc_all, key_all), num_keys=2
                )                                             # (m, S*k)
                cand_g = jnp.where(
                    key_sorted == imax, -1, key_sorted
                )[:, :top_k]                                  # global top-k
                own = (cand_g >= off) & (cand_g < off + dloc)
                cand_loc = jnp.where(own, cand_g - off, -1)
                _i, _s, _o, _y, _e, sel, pick = batched_affine_match(
                    rb, cand_loc, bank_loc, s_clip=s_clip,
                    objective=objective, return_score=True,
                )
                # cross-shard merge on (-sel, argmin position): slots are
                # owned by exactly one shard, so equal positions never tie
                score_m, pick_m, _ = merge_shard_bests(
                    jnp.where(jnp.isfinite(sel), -sel, -jnp.inf), pick,
                    jnp.zeros_like(pick, bool), tp_axis,
                )
                slot = jnp.where(pick_m >= top_k, pick_m - top_k, pick_m)
                sym = pick_m >= top_k
                rows = jnp.arange(rb.shape[0])
                idx = cand_g[rows, slot]
                return idx, sym, jnp.isfinite(score_m) & (idx >= 0)

        # same lax.map range chunking as the unsharded run_search, so the
        # compiled score/refine programs see identically-shaped tensors
        m = ranges.shape[0]
        outs = jax.lax.map(do_chunk, ranges.reshape(m // rblk, rblk, n))
        return tuple(x.reshape(m) for x in outs)

    def finish(ranges, raw_norm, n_ranges, n_domains, inv):
        if dp > 1:
            # contiguous range slab for this dp shard — embarrassingly
            # parallel, zero communication (fractal.py:1180-1182 analog)
            i = jax.lax.axis_index(dp_axis)
            mloc = mb // dp
            row0 = i * mloc
            ranges = jax.lax.dynamic_slice(
                ranges, (row0, jnp.int32(0)), (mloc, n)
            )
        else:
            row0 = 0

        if tp > 1 and search == "coarse":
            # Coarse under tp shards RANGES, not bank rows (VERDICT r3
            # item 3, replacing the halo-staged refine that diverged from
            # the tp=1 dense window kernel): the coarse stage's "bank" is a
            # strided view of the box-mean sequence, which every device
            # derives from the replicated raw signal — there is no bank to
            # shard. Each tp shard runs the IDENTICAL single-device
            # per-range program (same scan kernel and refine) on its range
            # sub-slab, so tp>1 selections are bit-equal to tp=1 by
            # construction; one tiled all_gather reassembles the dp slab.
            t = jax.lax.axis_index(tp_axis)
            msub = ranges.shape[0] // tp
            ranges_t = jax.lax.dynamic_slice(
                ranges, (t * msub, jnp.int32(0)), (msub, n)
            )
            bank = build_bank_jax(
                raw_norm, tile_size, range_size, domain_step, db, n_domains
            )
            d_valid = jnp.arange(db, dtype=jnp.int32) < n_domains
            idx_t, score_t = run_search(ranges_t, bank, d_valid)
            idx = jax.lax.all_gather(idx_t, tp_axis, axis=0, tiled=True)
            score = jax.lax.all_gather(score_t, tp_axis, axis=0, tiled=True)
        elif tp > 1:
            idx, sym, ok = run_search_tp(ranges, raw_norm, n_domains)
            score = jnp.where(ok, 0.0, -jnp.inf)
        else:
            bank = build_bank_jax(
                raw_norm, tile_size, range_size, domain_step, db, n_domains
            )
            d_valid = jnp.arange(db, dtype=jnp.int32) < n_domains
            idx, score = run_search(ranges, bank, d_valid)
        return pack_out(ranges, idx, score, n_ranges, thresh * inv * inv, row0)

    def _norm(raw):
        # scale normalization on device (see compress_audio_arrays notes):
        # float32 search arithmetic near unit range keeps squared terms
        # well-conditioned; s is scale-invariant and o/err are refit on the
        # host at raw scale, so inv never leaves the device.
        rawf = raw.astype(jnp.float32) if in_i16 else raw
        scale = jnp.max(jnp.abs(rawf))
        return rawf, jnp.where(scale > 0, 1.0 / scale, 1.0)

    def _mask_weighted(raw, mask_bytes):
        """Shared by masked/global: normalized voiced-weighted signal from
        the packed per-sample VAD bits (little-endian within each byte —
        expanded with shifts + reshape, no gather)."""
        rawf, inv = _norm(raw)
        bits = (
            mask_bytes[:, None]
            >> jnp.arange(8, dtype=mask_bytes.dtype)[None, :]
        ) & 1
        weighted = rawf * (bits.reshape(nb).astype(jnp.float32) * inv)
        return rawf, inv, weighted

    if mode == "global":
        # Whole-file global-candidate pass (models.stream._global_pass,
        # round 4): a halo-restricted time shard starves the clip-aware
        # "damped" objective on content whose self-similarity is not local
        # (the reference searches every domain for every range,
        # fractal.py:556-632). This core nominates the top-C remote windows
        # for EVERY range against the stride-subsampled whole-file bank,
        # refines each lobe column at full resolution (staged XLA window
        # descent — a grid-snapped candidate costs 12-25 dB, so nominations
        # only pick windows), and compares the best against the shard-local
        # winner ON DEVICE with one consistent f32 metric. Only winner
        # indices cross D2H (int32 — a whole-file row can exceed the
        # shards' 3-byte protocol) and the host refits them against the
        # serialized bank, so the exact-refit invariant holds and the pass
        # has no host-side merge math at all. Runs unsharded even under a
        # mesh: one replicated program -> identical records at every
        # (dp, tp). fn(raw (nb,), mask_bytes (nb/8,), meta int32[4] =
        # [n_samples, 0, n_ranges, n_domains_total], local_rows (mb,)
        # int32, -1 = dead/sentinel). Returns (mb,) int32: the winning
        # global row where a nominated candidate STRICTLY beats the local
        # winner, else -1 (sentinel ranges are never resurrected).
        from ..ops.search import _window_gains

        stride, topc = coarse_stride, coarse_topc
        assert db % stride == 0
        grblk = _pow2_divisor(mb, range_block)
        # rows fit the shards' 3-byte idx protocol whenever the whole-file
        # bank stays under 2^24 rows (~6 min of 44.1 kHz at step 1): both
        # the local-winner input and the winner output then ship as
        # (mb, 3) uint8 with the 0xFFFFFF sentinel — 25% less transfer
        pack3 = db < PACK3_MAX_ROWS

        def core(raw, mask_bytes, meta, local_rows):
            rawf, inv, weighted = _mask_weighted(raw, mask_bytes)
            base = weighted[:lb] if lb <= nb else jnp.concatenate(
                [weighted, jnp.zeros(lb - nb, jnp.float32)]
            )
            ranges = base.reshape(mb, n)
            if pack3:
                local_rows = unpack3_jnp(local_rows)
            n_domains = jnp.asarray(meta[3], jnp.int32)
            bank = build_bank_jax(
                rawf * inv, tile_size, range_size, domain_step, db, n_domains
            )
            d_valid = jnp.arange(db, dtype=jnp.int32) < n_domains
            bank_sub, w_sub, v_sub, t_sub, cdblk = sub_bank(
                bank, d_valid, stride
            )

            def do_block(rb):
                r_c = rb - jnp.mean(rb, axis=1, keepdims=True)
                lobes = lobe_scan(r_c, bank_sub, w_sub, v_sub, topc, cdblk,
                                  t_sub)                        # (m, C)
                best_s = jnp.full(rb.shape[0], -jnp.inf, jnp.float32)
                best_i = jnp.zeros(rb.shape[0], jnp.int32)
                for c_i in range(topc):
                    i_c, s_c = refine(
                        rb, bank, d_valid, lobes[:, c_i : c_i + 1], stride
                    )
                    take = s_c > best_s  # earlier (higher) lobe wins ties
                    best_s = jnp.where(take, s_c, best_s)
                    best_i = jnp.where(take, i_c, best_i)
                return best_i, best_s

            gi, gs = jax.lax.map(
                do_block, ranges.reshape(mb // grblk, grblk, n)
            )
            gi, gs = gi.reshape(mb), gs.reshape(mb)
            # the shard-local winner's gain on the SAME device bank — one
            # consistent f32 metric on both sides of the comparison; the
            # host-refit stored values are unaffected by which side wins
            r_t = ranges.T
            r_c = r_t - jnp.mean(r_t, axis=0)[None, :]
            live = local_rows >= 0
            ls, _ = _window_gains(
                r_c, bank.T, jnp.clip(local_rows, 0, db - 1)[None, :],
                live[None, :], objective, s_clip,
            )
            win = jnp.isfinite(gs) & (gs > ls[0]) & live
            if pack3:
                return pack3_jnp(jnp.where(win, gi, IDX3_SENTINEL))
            return jnp.where(win, gi, -1).astype(jnp.int32)

        return core

    if mode == "masked":
        def core(raw, mask_bytes, meta):
            rawf, inv, weighted = _mask_weighted(raw, mask_bytes)
            base = jax.lax.dynamic_slice(
                weighted, (jnp.asarray(meta[1], jnp.int32),), (lb,)
            )
            ranges = base.reshape(mb, n)
            return finish(ranges, rawf * inv, meta[2], meta[3], inv)

        return core

    from ..ops.vad import voiced_mask_jax

    def core(raw, meta):
        n_samples, n_ranges, n_domains = meta[0], meta[1], meta[2]
        rawf, inv = _norm(raw)
        ns = jnp.asarray(n_samples, jnp.int32)
        mask = voiced_mask_jax(rawf, ns, 2 * n, thresh)
        weighted = rawf * (mask.astype(jnp.float32) * inv)
        if lb <= nb:
            base = weighted[:lb]
        else:
            base = jnp.concatenate([weighted, jnp.zeros(lb - nb, jnp.float32)])
        ranges = base.reshape(mb, n)
        # reflect-pad the tail range (np.pad(..., 'reflect') parity,
        # fractal.py:1095-1097): position p >= ns reads sample 2*ns-2-p
        last = jnp.maximum(ns - 1, 0) // n
        tpos = last * n + jnp.arange(n, dtype=jnp.int32)
        refl = jnp.where(tpos < ns, tpos, 2 * ns - 2 - tpos)
        tail = jnp.take(weighted, jnp.clip(refl, 0, nb - 1), axis=0)
        need_tail = (ns % n) != 0
        ranges = jnp.where(
            ((jnp.arange(mb, dtype=jnp.int32) == last) & need_tail)[:, None],
            tail[None, :],
            ranges,
        )
        return finish(ranges, rawf * inv, n_ranges, n_domains, inv)

    return core


@lru_cache(maxsize=64)
def _encode_core(*key):
    """Jitted + cached variant of build_encode_core, one entry per bucket.
    cached_jit == jax.jit unless FWAV_EXEC_CACHE opts into the
    cross-process executable cache (utils/aot_cache.py — the per-process
    compile tax is the cold-start bottleneck, PARITY.md)."""
    from ..utils.aot_cache import cached_jit

    return cached_jit(build_encode_core(*key))


@lru_cache(maxsize=64)
def _encode_core_chunked(k, *key):
    """build_encode_core behind a k-way raw-chunk concatenate: the caller
    device_puts the padded raw buffer as k equal back-to-back transfers
    (EncoderConfig.h2d_chunks — wire pipelining on transports that overlap
    puts) and the program reassembles the IDENTICAL buffer on device. The
    downstream values match the single-put core's on everything except the
    usual recompilation scope: this is a different compiled program, so
    EXACT selection-score ties fall under the CLAUDE.md carve-out (same as
    any shape-bucket change); tie-free content matches bit for bit."""
    f = build_encode_core(*key)

    def g(*args):
        *parts, meta = args
        return f(jnp.concatenate(parts), meta)

    from ..utils.aot_cache import cached_jit

    return cached_jit(g)


def _resolve_h2d_chunks(cfg: EncoderConfig, nb: int) -> int:
    """How many device_puts the single-shot raw upload splits into. Auto
    (None) stays at 1: chunking only pays on transports whose puts
    pipeline, which no measurement has shown yet. Non-dividing or
    degenerate values fall back to 1."""
    k = cfg.h2d_chunks
    if k is None or k <= 1 or nb % k:
        return 1
    return int(k)


def _empty_result(range_size, tile_size, domain_step, energy_thresh, original_len, arrays):
    matches = np.empty(0, dtype=MATCH_DTYPE) if arrays else []
    return (
        matches,
        np.zeros((0, range_size), dtype=np.float32),
        0,
        range_size,
        tile_size,
        domain_step,
        energy_thresh,
        original_len,
    )


def compress_audio_arrays(
    signal,
    framerate,
    sampwidth,
    tile_size: int = 1024,
    emb_dim: int = 16,
    top_k: int = 32,
    ef_search: int = 50,
    use_gpu: bool = False,
    energy_thresh: float = 1e-4,
    domains_tmpdir=None,
    batch_size_gpu: int = 512,
    batch_size_cpu: int = 128,
    fast_mode: bool = True,
    transient_weight: float = 1.0,
    n_mels: int = 40,
    cpu_workers=None,
    search: str = "auto",
    objective: str = "balanced",
    global_candidates: bool | None = None,
    config: EncoderConfig | None = None,
):
    """Fast-path encode returning a packed match record array.

    The reference-signature kwargs (ef_search, use_gpu, batch sizes,
    cpu_workers, domains_tmpdir, transient_weight, n_mels) are accepted for
    API compatibility; here there are no worker processes, no ANN index and
    no memmap staging for in-memory signals, so they are no-ops.
    `global_candidates` is likewise a no-op here (single-shot encodes always
    search the whole bank); it rides the config so file-level callers can
    pass one kwarg set to both this and the streaming path.
    """
    del ef_search, use_gpu, domains_tmpdir, batch_size_gpu, batch_size_cpu
    del transient_weight, n_mels, cpu_workers
    device_banner()

    cfg = config or EncoderConfig(
        tile_size=tile_size,
        emb_dim=emb_dim,
        top_k=top_k,
        energy_thresh=energy_thresh,
        fast_mode=fast_mode,
        search=search,
        objective=objective,
        global_candidates=global_candidates,
    )
    range_size = cfg.range_size
    domain_step = cfg.domain_step

    signal = np.ascontiguousarray(np.asarray(signal, dtype=np.float32))
    return _compress_fast(signal, cfg)


#: Files per packed dispatch: bounds device memory (B x bank blocks) while
#: amortizing the per-dispatch transport round trip over many small files.
PACK_B_MAX = 16


@lru_cache(maxsize=64)
def _packed_encode_core(*key):
    """jit(vmap(core)): one dispatch encodes a whole stack of same-bucket
    files (compress_audio_packed). jit re-traces per leading-axis size, so
    callers pad stacks to powers of two to bound retraces."""
    from ..utils.aot_cache import cached_jit

    return cached_jit(jax.vmap(build_encode_core(*key)))


@lru_cache(maxsize=32)
def _packed_sharded_core(mesh, flat_axes, *key):
    """jit(shard_map(vmap(core))): FILE-level data parallelism — the packed
    stack's batch axis shards over EVERY mesh device (whole files per
    device, zero communication). This is the SPMD analog of the
    reference's file-level multiprocessing.Pool fan-out across workers
    (fractal.py:1605-1617): one SPMD program over a stack of files, N
    chips each encoding their own slice, instead of N processes contending
    for one accelerator. Per-file programs are independent, so records
    match the unsharded packed dispatch bit for bit."""
    from jax.sharding import PartitionSpec as P

    spec = P(flat_axes)
    from ..utils.aot_cache import cached_jit

    return cached_jit(
        jax.shard_map(
            jax.vmap(build_encode_core(*key)), mesh=mesh,
            in_specs=(spec, spec), out_specs=spec, check_vma=False,
        )
    )


def compress_audio_packed(
    signals,
    framerate,
    sampwidth,
    tile_size: int = 1024,
    energy_thresh: float = 1e-4,
    fast_mode: bool = True,
    search: str = "auto",
    objective: str = "balanced",
    global_candidates: bool | None = None,  # no-op: whole-bank search
    config: EncoderConfig | None = None,
    mesh=None,
):
    """Encode MANY short signals with one device dispatch per same-bucket
    stack of up to PACK_B_MAX files (vmap over the fused encode core).
    With a multi-device `mesh`, the stack's batch axis additionally shards
    over every device — FILE-level data parallelism (whole files per chip,
    zero communication), records bit-equal to the unsharded packed
    dispatch (_packed_sharded_core).

    Small-file batch throughput is transport-bound: each single-file
    dispatch pays a device round trip for a few ms of compute, capping
    the thread-pool batch mode (cli --batch) near 1/round-trip files/s
    however many workers run. Packing amortizes that
    round trip across the stack. Files group by their shape bucket
    (nb, lb, db) + dtype, so mixed-length inputs still pack whenever they
    share buckets; host-side bank builds and the exact refit stay per-file
    (overlapped with the packed D2H fetch, same protocol as the single-shot
    path). Selections come from the same core vmapped — records match the
    single-shot encoder's exactly on tie-free content (vmap batching may
    legally flip fp near-ties; the decoder contract never changes).

    Replaces the reference's file-level multiprocessing.Pool fan-out
    (fractal.py:1605-1617) rather than translating it: one SPMD program
    over a stack of files instead of N processes contending for one GPU.

    Returns a list of compress_audio_arrays-shaped 8-tuples, input order.
    """
    del framerate, sampwidth  # shape-independent; kept for API symmetry
    del global_candidates  # streaming-only knob (see compress_audio_arrays)
    device_banner()
    n_dev = 1
    if mesh is not None and mesh.devices.size > 1:
        n_dev = int(mesh.devices.size)
    cfg = config or EncoderConfig(
        tile_size=tile_size, energy_thresh=energy_thresh,
        fast_mode=fast_mode, search=search, objective=objective,
    )
    range_size = cfg.range_size
    domain_step = cfg.domain_step

    results = [None] * len(signals)
    groups: dict = {}
    prepped: dict = {}
    for i, sig in enumerate(signals):
        signal = np.ascontiguousarray(np.asarray(sig, dtype=np.float32))
        original_len = len(signal)
        try:
            prep = _prep_signal(signal, cfg)
        except ValueError as e:
            raise ValueError(f"signal {i}: {e}") from None
        if prep is None:
            results[i] = _empty_result(
                range_size, cfg.tile_size, domain_step, cfg.energy_thresh,
                original_len, arrays=True,
            )
            continue
        raw_p, meta, key, n_ranges, n_domains = prep
        groups.setdefault(key, []).append(i)
        prepped[i] = (signal, raw_p, meta, n_ranges, n_domains, original_len)

    for key, idxs in groups.items():
        if n_dev > 1:
            from ..parallel.mesh import DP_AXIS, TP_AXIS

            core = _packed_sharded_core(mesh, (DP_AXIS, TP_AXIS), *key)
        else:
            core = _packed_encode_core(*key)
        for c0 in range(0, len(idxs), PACK_B_MAX):
            chunk = idxs[c0 : c0 + PACK_B_MAX]
            b_real = len(chunk)
            b_pad = 1 << (b_real - 1).bit_length()  # pow2 bounds retraces
            if n_dev > 1:  # the batch axis must split over every device
                b_pad = -(-b_pad // n_dev) * n_dev
            rows = chunk + [chunk[-1]] * (b_pad - b_real)
            raws = np.stack([prepped[i][1] for i in rows])
            metas = np.stack([prepped[i][2] for i in rows])
            with DEVICE_LOCK, phase("device"):
                codes = core(jnp.asarray(raws), jnp.asarray(metas))
                box: dict = {}

                def _fetch(codes=codes, box=box):
                    try:
                        box["codes"] = fetch_global(codes)
                    except BaseException as e:  # surfaced after join
                        box["exc"] = e

                fetcher = threading.Thread(target=_fetch, daemon=True)
                with phase("d2h"):
                    fetcher.start()
                    banks = {}
                    with phase("host_bank"):
                        for i in chunk:
                            banks[i] = build_domains_host(
                                prepped[i][0], cfg.tile_size, range_size,
                                domain_step,
                            )
                    fetcher.join()
            if "exc" in box:
                raise box["exc"]
            for j, i in enumerate(chunk):
                signal, _raw, _meta, n_ranges, n_domains, olen = prepped[i]
                assert len(banks[i]) == n_domains
                results[i] = _finalize_encode(
                    box["codes"][j][:n_ranges], signal, cfg, range_size,
                    domain_step, n_ranges, n_domains, olen, banks[i],
                )
    return results


@lru_cache(maxsize=32)
def _sharded_encode_core(mesh, dp_axis, n_in, *key):
    """jit(shard_map(core)) over a (dp, tp) mesh — one entry per
    (mesh, shape-bucket). Inputs replicated (`n_in` of them: 2 for
    mode="raw", 3 for the streaming mode="masked" protocol); the (mb, 3)
    idx-code output is stitched from per-device dp slabs."""
    from jax.sharding import PartitionSpec as P

    core = build_encode_core(*key)
    from ..utils.aot_cache import cached_jit

    return cached_jit(
        jax.shard_map(
            core, mesh=mesh, in_specs=(P(),) * n_in, out_specs=P(dp_axis),
            check_vma=False,
        )
    )


def _range_split_factor(cfg: EncoderConfig, range_size: int, db: int,
                        dp: int, tp: int) -> int:
    """How many ways the range axis splits across the mesh — dp always;
    times tp when the search resolves to "coarse", whose tp sharding splits
    RANGES rather than bank rows (see build_encode_core: the coarse stage's
    bank is a strided view of the box-mean sequence every device derives
    from the replicated raw signal, so running the single-device per-range
    program on range sub-slabs is what makes tp>1 selections bit-equal to
    tp=1 by construction). Shared by _prep_signal and the streaming path so
    their bucket padding can never disagree with the core's slab split."""
    if tp > 1 and _resolve_search(cfg, range_size, db)[0] == "coarse":
        return dp * tp
    return dp


def _compress_fast(signal: np.ndarray, cfg: EncoderConfig, mesh=None):
    """The default single-shot encode: device-side VAD, idx-only D2H, host
    refit. With a multi-device `mesh`, the same core runs under shard_map —
    ranges data-parallel over the mesh's dp axis, the bank tensor-sharded
    over tp (parallel.shard.compress_audio_sharded) — and produces
    BIT-EQUAL records to the single-device path."""
    range_size = cfg.range_size
    domain_step = cfg.domain_step
    original_len = len(signal)

    if mesh is not None and mesh.devices.size > 1:
        from ..parallel.mesh import DP_AXIS, TP_AXIS

        dp, tp = mesh.shape[DP_AXIS], mesh.shape[TP_AXIS]
    else:
        mesh, dp, tp = None, 1, 1

    prep = _prep_signal(signal, cfg, dp, tp)
    if prep is None:
        return _empty_result(
            range_size, cfg.tile_size, domain_step, cfg.energy_thresh,
            original_len, arrays=True,
        )
    raw_p, meta, key, n_ranges, n_domains = prep
    if mesh is not None:
        from ..parallel.mesh import DP_AXIS, TP_AXIS

        core = _sharded_encode_core(
            mesh, DP_AXIS, 2, *key, dp, tp, DP_AXIS, TP_AXIS
        )
        h2d_k = 1
    else:
        h2d_k = _resolve_h2d_chunks(cfg, len(raw_p))
        core = (
            _encode_core_chunked(h2d_k, *key) if h2d_k > 1
            else _encode_core(*key)
        )

    # The fetch runs in its own thread (blocked in C, GIL released) while
    # the main thread rebuilds the serialized bank host-side (cumsum box
    # means — cheaper than pulling the bank over the device->host link);
    # the bank build overlaps the device work and the fetch.
    with DEVICE_LOCK, phase("device"):
        if h2d_k > 1:
            csz = len(raw_p) // h2d_k
            parts = [
                jax.device_put(raw_p[j * csz : (j + 1) * csz])
                for j in range(h2d_k)
            ]
            codes = core(*parts, jnp.asarray(meta))
        else:
            codes = core(jnp.asarray(raw_p), jnp.asarray(meta))
        box = {}

        def _fetch():
            try:
                box["codes"] = fetch_global(codes)
            except BaseException as e:  # surfaced after join
                box["exc"] = e

        fetcher = threading.Thread(target=_fetch, daemon=True)
        with phase("d2h"):
            fetcher.start()
            with phase("host_bank"):
                bank = build_domains_host(
                    signal, cfg.tile_size, range_size, domain_step
                )
            fetcher.join()
    if "exc" in box:
        raise box["exc"]
    c = box["codes"][:n_ranges]
    assert len(bank) == n_domains
    return _finalize_encode(
        c, signal, cfg, range_size, domain_step, n_ranges, n_domains,
        original_len, bank,
    )


def _finalize_encode(c, signal, cfg, range_size, domain_step, n_ranges,
                     n_domains, original_len, bank):
    """Host half of the idx-only encode protocol, per file: sentinel/silent
    classification and the exact refit of the device's selections against
    the serialized bank. Shared by the single-shot path and
    compress_audio_packed (which fetches many files' codes in one D2H)."""
    pad_len = (range_size - (original_len % range_size)) % range_size
    if cfg.fast_mode and bool(np.all(c == 0xFF)):  # every 3-byte code 0xFFFFFF
        # every range pruned: distinguish the reference's all-silent empty
        # container (fractal.py:1083-1093) from an all-sentinel file — only
        # here is the host VAD pass actually needed
        with phase("vad"):
            voiced = voiced_detection(
                signal, frame_size=range_size * 2,
                energy_threshold=cfg.energy_thresh,
            )
        if float(np.sum((signal * voiced).astype(np.float64) ** 2)) < 1e-8:
            return _empty_result(
                range_size, cfg.tile_size, domain_step, cfg.energy_thresh,
                original_len, arrays=True,
            )
        ranges_host = None  # all sentinels: no refit targets needed
    elif cfg.fast_mode:
        # refit against the RAW ranges: the VAD frame (2*range_size) aligns
        # with range boundaries, so every range is either fully voiced
        # (weighted == raw on it) or fully zeroed (device emitted a sentinel
        # — its refit row is ignored). The host VAD pass is skipped
        # entirely on this, the common, path. The reflect-padded TAIL
        # range's reflected samples source from the last range_size+1 raw
        # samples — at most one frame back — and that frame is voiced
        # whenever the tail is live: the centered 5-frame box smoothing
        # gives smoothed(tail) <= smoothed(prev) (prev's window is a
        # superset containing the tail's terms), so tail above either
        # hysteresis threshold implies prev above it too; raw == weighted
        # on the reflected sources of every live tail
        # (tests/test_e2e.py::test_fast_mode_tail_refit_matches_weighted_semantics).
        if pad_len:
            padded = np.pad(signal, (0, pad_len), mode="reflect")
        else:
            padded = signal
        ranges_host = padded.reshape(n_ranges, range_size)
    else:
        # fast_mode=False keeps live matches for sub-threshold ranges, whose
        # content IS the weighted signal — the VAD pass is load-bearing
        with phase("vad"):
            voiced = voiced_detection(
                signal, frame_size=range_size * 2,
                energy_threshold=cfg.energy_thresh,
            )
            weighted = signal * voiced
        if float(np.sum(weighted.astype(np.float64) ** 2)) < 1e-8:
            return _empty_result(
                range_size, cfg.tile_size, domain_step, cfg.energy_thresh,
                original_len, arrays=True,
            )
        if pad_len:
            weighted = np.pad(weighted, (0, pad_len), mode="reflect")
        ranges_host = weighted.reshape(n_ranges, range_size)

    with phase("refit"):
        rec = collect_idx_matches(c, n_ranges, ranges_host, bank, cfg.s_clip)

    return (
        rec,
        bank,
        n_ranges,
        range_size,
        cfg.tile_size,
        domain_step,
        cfg.energy_thresh,
        original_len,
    )


def _as_i16_or_f32(signal: np.ndarray):
    """The transport's int16 detection rule — the single source of truth for
    every encode path (single-shot, packed, streaming): 16-bit-exact content
    (every real 8/16-bit WAV) ships host->device as int16, half the bytes of
    float32; the device casts back to f32 exactly. Returns (src, in_i16)."""
    peak = float(np.max(np.abs(signal))) if len(signal) else 0.0
    if np.isfinite(peak) and peak <= 32767.0:
        as_i16 = signal.astype(np.int16)
        if np.array_equal(signal, as_i16):
            return as_i16, True
    return signal, False


def resolve_use_pallas(cfg: EncoderConfig) -> bool:
    """EncoderConfig.use_pallas with auto (None) resolved: the Triton scan
    kernel on the gpu backend, the lax.scan path everywhere else."""
    if cfg.use_pallas is None:
        return jax.default_backend() == "gpu"
    return bool(cfg.use_pallas)


def _core_key(cfg: EncoderConfig, nb: int, lb: int, db: int, mode: str,
              in_i16: bool, tp: int = 1):
    """The jit-core cache key for one shape bucket — every static argument
    of build_encode_core in order (minus the trailing mesh args the sharded
    wrapper appends). Centralized so the single-shot, packed and streaming
    paths can never drift apart on which knobs select a compiled program.
    Also runs the tp-composition check (it needs the resolved mode)."""
    range_size = cfg.range_size
    search_mode, stride = _resolve_search(cfg, range_size, db)
    use_pallas = resolve_use_pallas(cfg)
    # the clip-aware damped objective needs several coarse lobes per range:
    # the best clip-FEASIBLE domain is often not near the largest
    # unclipped-gain lobe (measured 29 -> 46 dB from topc 1 -> 4 on the
    # speechlike fixture); exact/topk searches are unaffected
    topc = cfg.coarse_topc
    if cfg.objective == "damped" and search_mode == "coarse":
        topc = max(topc, 4)
    if mode == "global":
        # the whole-file global-candidate pass rides the coarse knob slots:
        # its nomination grid and lobe depth are the global_* config fields
        # (models.stream._global_pass). use_pallas gates the fused top-C
        # nomination scan there; the refine is the staged XLA descent
        search_mode, stride, topc = "coarse", cfg.global_stride, cfg.global_topc
    return (
        nb, lb, db, cfg.tile_size, range_size, cfg.domain_step, search_mode,
        cfg.top_k, cfg.emb_dim, cfg.fast_mode, cfg.s_clip, cfg.domain_block,
        cfg.range_block, cfg.objective, stride, topc,
        bool(use_pallas), mode, in_i16, float(cfg.energy_thresh),
    )


def _prep_signal(signal: np.ndarray, cfg: EncoderConfig, dp: int = 1,
                 tp: int = 1):
    """Shared host prep for the mode="raw" encode paths (single-shot and
    packed): derive counts, bucket the shapes (with mesh-divisibility
    padding on real meshes only — pad_to at dp=1/tp=1 would round the
    quarter-octave bucket values back up to 256-multiples and undo the
    small-shape padding cap), probe the int16 transport rule, fill the
    padded raw buffer and build the jit-core cache key.

    Returns (raw_p, meta, key, n_ranges, n_domains), or None when the
    signal produces no ranges or no domains (caller emits the empty
    result). Raises ValueError when the bank exceeds the 3-byte index
    protocol's 2^24 range."""
    range_size = cfg.range_size
    original_len = len(signal)
    n_ranges = -(-original_len // range_size) if original_len else 0
    n_domains = n_domains_for(original_len, cfg.tile_size, cfg.domain_step)
    if n_ranges == 0 or n_domains == 0:
        return None
    if n_domains >= 1 << 24:
        raise ValueError(
            f"{n_domains} domains exceeds the single-dispatch encoder's "
            "2^24 index range; encode long files with "
            "models.stream.compress_audio_streaming "
            "(process_file_compress selects it automatically)"
        )
    nb = bucket(original_len, 4096)
    # bucket the RANGE COUNT, not the sample count: lb must be an exact
    # multiple of range_size for the (mb, N) reshape (range_size can have
    # odd factors, e.g. tile_size=1536 -> range_size=6).
    rb = bucket(n_ranges, 256)
    dbk = bucket(n_domains, 256)
    db = pad_to(dbk, tp * 256) if tp > 1 else dbk
    rsplit = _range_split_factor(cfg, range_size, db, dp, tp)
    lb = (pad_to(rb, rsplit * 256) if rsplit > 1 else rb) * range_size
    src, in_i16 = _as_i16_or_f32(signal)
    raw_p = np.zeros(nb, dtype=np.int16 if in_i16 else np.float32)
    raw_p[:original_len] = src
    key = _core_key(cfg, nb, lb, db, "raw", in_i16, tp)
    meta = np.array([original_len, n_ranges, n_domains], np.int32)
    return raw_p, meta, key, n_ranges, n_domains


def _resolve_search(cfg: EncoderConfig, range_size: int, db: int):
    """Resolve search mode + coarse stride for a bucketed bank size: coarse
    pays off once the bank dwarfs the refine windows; the stride must stay
    well under the box-mean width."""
    block_len = cfg.tile_size // range_size
    stride = min(cfg.coarse_stride, max(1, block_len // 2))
    stride = 1 << (stride.bit_length() - 1)  # largest pow2 <= stride
    search_mode = cfg.search
    if search_mode == "auto":
        search_mode = (
            "coarse"
            if db >= max(cfg.auto_coarse_threshold, 256 * stride) and stride > 1
            else "exact"
        )
    return search_mode, stride


def collect_idx_matches(codes, n_ranges: int, ranges: np.ndarray,
                        bank: np.ndarray, s_clip: float) -> np.ndarray:
    """Device->host transfer + record materialization for the idx-only
    encode output: exactly 3 bytes per range — 0xFFFFFF sentinel, else the
    selected domain index in bits 0..23. The mirror orientation is NOT
    transmitted: refit_host re-derives it on the host (see
    build_encode_core's docstring and CLAUDE.md — deriving orientation
    host-side is what makes records bit-reproducible across shardings).
    s/o/err are recomputed here with the exact f32 refit against the
    SERIALIZED bank (ops.affine.refit_host), so the stored parameters are
    self-consistent with the stored bank and only 3 bytes/range cross the
    slow device->host path (vs 16 for the full packed protocol)."""
    from ..ops.affine import refit_host

    b3 = np.ascontiguousarray(fetch_global(codes)[:n_ranges])
    if ranges is not None:
        from ..io import native

        rec = native.collect(
            b3, np.ascontiguousarray(ranges, dtype=np.float32), bank, s_clip
        )
        if rec is not None:
            return rec

    b = b3.astype(np.int32)
    c = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    dead = c == 0xFFFFFF
    rec = np.empty(n_ranges, dtype=MATCH_DTYPE)
    if ranges is None or bool(np.all(dead)):
        rec["idx"] = -1
        rec["s"] = 1.0
        rec["o"] = 0.0
        rec["sym"] = 0
        rec["err"] = 0.0
        return rec
    idx = np.where(dead, 0, c).astype(np.int32)
    # orientation is re-derived inside refit_host (shape-stable, identical
    # across device shardings — no trust in device fp near-ties)
    s, o, err, sym = refit_host(ranges, bank, idx, s_clip)
    rec["idx"] = np.where(dead, -1, idx)
    rec["s"] = np.where(dead, np.float32(1.0), s)
    rec["o"] = np.where(dead, np.float32(0.0), o)
    rec["sym"] = np.where(dead, False, sym).astype(np.uint8)
    rec["err"] = np.where(dead, np.float32(0.0), err)
    return rec


def prune_bank(rec: np.ndarray, bank: np.ndarray):
    """Drop every domain row the match table never references and reindex.

    The reference serializes the ENTIRE sliding-window bank — n_domains ~
    n_samples rows — which inflates the container ~10x over the input
    (SURVEY.md §2.4.5, README.md:356 'not yet competitive'). Matches
    reference at most n_ranges distinct domains, so the pruned bank is
    bounded by the range count regardless of duration. The output is still
    a perfectly ordinary .fwav: decoders (ours and the reference's) only
    ever gather rows by index. Round-trip output is bit-identical.

    When every match is a sentinel, one zero row is kept instead of an
    empty bank: the reference's load_compressed crashes on n_domains=0
    (np.vstack of nothing, fractal.py:1372), so an all-silent pruned file
    stays loadable by both decoders.

    Returns (rec', bank') — rec is not modified in place."""
    used = np.unique(rec["idx"][rec["idx"] >= 0])
    if used.size == 0 and len(bank):
        return rec.copy(), np.zeros((1, bank.shape[1]), dtype=np.float32)
    return remap_matches(rec, used), np.ascontiguousarray(bank[used])


def remap_matches(rec: np.ndarray, used: np.ndarray) -> np.ndarray:
    """Reindex live matches against the SORTED kept-row list `used` —
    O(live log used), no bank-sized allocation. Shared by prune_bank and
    the streaming prune path (models.codec)."""
    out = rec.copy()
    live = out["idx"] >= 0
    out["idx"][live] = np.searchsorted(used, out["idx"][live]).astype(np.int32)
    return out


def compress_audio(signal, framerate, sampwidth, **kwargs):
    """Reference-shaped encode: returns (matches LIST of 5-tuples, domains,
    n_ranges, range_size, tile_size, domain_step, energy_thresh,
    original_len) exactly like fractal.py:1045's public API."""
    from ..io.container import struct_to_matches

    rec, *rest = compress_audio_arrays(signal, framerate, sampwidth, **kwargs)
    matches = struct_to_matches(rec) if isinstance(rec, np.ndarray) else rec
    return (matches, *rest)
