"""Configuration for the FWAV codec.

One frozen dataclass per pipeline stage, defaults matching the reference's
keyword defaults (reference: fractal.py:1045-1061 for encode,
fractal.py:1378-1380 for decode). The CLI and the Python API both map onto
these.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

FWAV_VERSION = 1  # reference: fractal.py:59

#: Number of candidate domains per range in the embedding-shortlist search
#: path (reference: fractal.py:77).
TOP_K = 32

#: DCT coefficients for the standalone tile embedding (reference: fractal.py:141).
EMBED_K = 32

#: The decoder s_damping the damped encode profile is tuned for — the value
#: the clip-aware objective optimizes against and the one stored as the
#: v2/v3 FLAG_DECODE_HINT so a bare `decompress` realizes the profile's
#: quality win (measured +34 dB over the hintless default decode on the
#: bench fixture). Matches the long-standing `decompress --damping 0.25`
#: recommendation.
DAMPED_DECODE_DAMPING = 0.25


def derive_range_size(tile_size: int) -> int:
    """reference: fractal.py:1070 (note README.md:95 says //128; code wins)."""
    return max(4, tile_size // 256)


def derive_domain_step(range_size: int) -> int:
    """reference: fractal.py:1071."""
    return max(1, range_size // 4)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encode-side knobs. Defaults mirror compress_audio's keyword defaults
    (reference: fractal.py:1045-1061)."""

    tile_size: int = 1024
    emb_dim: int = 16
    top_k: int = TOP_K
    ef_search: int = 50          # kept for API parity; no ANN index here
    energy_thresh: float = 1e-4
    fast_mode: bool = True       # energy-prune silent ranges at 0.75*thresh
    transient_weight: float = 1.0
    n_mels: int = 40
    s_clip: float = 16.0         # reference: fractal.py:764
    # --- additions beyond the reference ---------------------------------
    #: "exact": globally optimal matched-filter search over every domain
    #:   (one blockwise matmul + running argmax; subsumes embeddings + ANN
    #:   + affine re-rank of the reference).
    #: "topk": reference-shaped two-stage search (embedding top-k shortlist
    #:   then batched mirrored affine solve over the shortlist). This is a
    #:   COMPATIBILITY MODE kept to mirror the reference's architecture
    #:   (fractal.py:353-401, 535-552): "auto" never selects it and it has
    #:   no Pallas kernel (the MIPS stage is one matmul + top_k, which XLA
    #:   already handles well; the exact-family modes dominate it in both
    #:   match quality and speed). It composes with tp bank
    #:   sharding: per-shard shortlists merge into the exact global top-k,
    #:   bit-equal to the single-device pick (models.encode.run_search_tp).
    #: "coarse": coarse-to-fine exact-family search — stride-subsampled scan
    #:   + top-C window refinement; ~stride-fold cheaper, near-exact because
    #:   adjacent domains are one-sample-shifted box means.
    #: "auto" (default): "coarse" for large banks, "exact" for small ones.
    search: str = "auto"
    #: Bank size above which "auto" switches from brute-force to coarse.
    auto_coarse_threshold: int = 32768
    #: Coarse scan stride (power of two; auto-capped to block_len // 2 —
    #: adjacent domains are block_len-wide box means shifted one sample, so
    #: the gain surface is smooth well past this). 128 measured +0.09 dB
    #: SNR over 64 on the 10 s bench with the staged refine (the wider
    #: 1.25*stride refine window catches more true peaks).
    coarse_stride: int = 128
    #: Number of coarse lobes refined per range (1 measured within 0.005 dB
    #: of 2 on the parity fixtures at ~25% less encode time).
    coarse_topc: int = 1
    #: Use the Pallas (Triton) fused scan kernel (ops/pallas_search.py) for
    #: the exact scan, the coarse lobe scan and the global-pass nomination:
    #: scores and the running top-C stay in registers instead of
    #: round-tripping device memory. None (default) = auto: on for the gpu
    #: backend, off elsewhere (the lax.scan path is the portable oracle).
    #: True on a backend without a Triton lowering raises.
    use_pallas: bool | None = None
    #: Match-selection objective. "balanced" (default) minimizes the affine
    #: residual plus the shipped decoder's offset-deviation penalty
    #: N*(s*d_mean)^2 — the s_damping=0 decoder reconstructs exactly the
    #: stored offset (see models.decode), so this optimizes true round-trip
    #: distortion. "affine" is the reference's plain-L2 argmin. "damped"
    #: is the CLIP-AWARE objective matched to the damped decoder
    #: (s_damping > 0, fractal.py:1445): it minimizes the residual of the
    #: stored transform clip(s)*d + o that decode converges to — decode
    #: such files with s_damping > 0 (CLI `decompress --damping 0.25`) to
    #: realize the quality win (measured +13 to +28 dB over the
    #: piecewise-constant bound at identical rate; the container is
    #: unchanged and any decoder reads it). Damped-profile files are MEANT
    #: for the damped decoder: decoding them at the default damping=0 can
    #: land well below the default profile on some content (the stored
    #: offsets serve the transform fit, not the piecewise-constant decode).
    objective: str = "balanced"
    #: Streaming global-candidate pass (round 4): the time-sharded encoder
    #: restricts each shard's search to its halo window, which starves the
    #: clip-aware "damped" objective of feasible candidates on some content
    #: (measured 31.4 vs 40.2 dB whole-file on the 100 s bench fixture —
    #: remote winners are spread over the ENTIRE file, not clustered). When
    #: on, a whole-file nomination scan (one range per `global_group`,
    #: clip-aware top-`global_topc` over the stride-`global_stride`
    #: subsampled bank) routes each range's remote candidates to the time
    #: shard that owns them for FULL-RESOLUTION window refinement (coarse
    #: grid granularity in stored records measurably poisons the damped
    #: refit); the host then merges local vs global winners by exact
    #: raw-scale gain. None (default) = auto: on for objective="damped"
    #: in the streaming path, off otherwise (the balanced objective
    #: measures halo-insensitive).
    global_candidates: Optional[bool] = None
    #: Whole-file nomination grid (rows of the subsampled bank). 512
    #: measured EQUAL to 128 on the 100 s fixture (40.23 dB both in the
    #: whole-file oracle) — the full-res refine window (1.25x stride)
    #: absorbs the grid error. Note the nomination scan is O(M * D/stride)
    #: = quadratic in duration; raise the stride for multi-hour content.
    global_stride: int = 512
    #: Global lobes nominated per range, each refined at full resolution
    #: and merged against the shard-local winner on device. Refinement
    #: cost scales linearly in topc; the measured 100 s-fixture curve is
    #: topc 1/2/4/6/8 -> 35.96/36.97/38.57/39.36/39.95 dB against the
    #: 40.23 dB whole-file oracle — 4 is the knee; raise to 8 to buy the
    #: last ~1.4 dB at ~2x the pass's refine work. (Grouped/shared
    #: nominations were evaluated and rejected: (group 4, topc 1) loses
    #: 4.8 dB vs (1, 4) — the refinement, not the scan, dominates.)
    global_topc: int = 4
    #: Single-shot raw H2D chunking: split the padded raw buffer into this
    #: many equal device_puts issued back to back before the dispatch,
    #: instead of one put inside it. On transports where puts pipeline
    #: (chunk k+1 on the wire while k lands) this overlaps the serial raw
    #: upload with itself and with dispatch overhead; on transports that
    #: serialize transfers it is a no-op plus one on-device concatenate.
    #: The core concatenates the chunks back into the IDENTICAL raw buffer, so
    #: records match the single-put path bit for bit on tie-free content
    #: (tests/test_review_regressions.py); being a separate compiled
    #: program, EXACT selection-score ties carry the same carve-out as any
    #: recompilation (CLAUDE.md). None (default) = 1 until the
    #: chunked path measures faster; values that do not divide the padded
    #: buffer fall back to 1.
    h2d_chunks: Optional[int] = None
    #: Domain-block size of the lax.scan search (rows scored per scan step).
    domain_block: int = 2048
    #: Range-block size for the outer search loop (lax.map chunks; the
    #: Pallas kernel's grid tiles each chunk again).
    range_block: int = 32768

    @property
    def range_size(self) -> int:
        return derive_range_size(self.tile_size)

    @property
    def domain_step(self) -> int:
        return derive_domain_step(self.range_size)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Decode-side knobs (reference: fractal.py:1378-1380)."""

    iterations: int = 8
    convergence_eps: float = 1e-3
    s_clip: float = 16.0
    s_damping: float = 0.0


@dataclasses.dataclass(frozen=True)
class VADConfig:
    """Voiced/silent detection (reference: fractal.py:880-909; live call at
    fractal.py:1074-1078 uses frame_size = 2*range_size)."""

    energy_threshold: float = 1e-4
    smooth_window: int = 5
    low_threshold: Optional[float] = None  # defaults to 0.5 * energy_threshold
