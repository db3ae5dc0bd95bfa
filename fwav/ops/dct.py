"""Orthonormal DCT-II shape embeddings as single matmuls.

The reference computes per-tile embeddings in a Python loop over
scipy.fftpack.dct calls (fractal.py:238-280, 145-208) — its CPU bottleneck.
Tiles here are tiny (range_size = 4..32), so an FFT buys nothing: the whole
embedding (difference op, HF weighting, DCT, coefficient slice, zero-pad) is
one precomputed (N, k) linear map, and embedding an entire bank is one
(B, N) @ (N, k) matmul followed by a masked L2 row-normalize.

Semantics parity (verified against scipy in tests):
- tile_embedding   (fractal.py:178-208): DCT-II ortho, linspace(1,2) HF weight
  applied BEFORE dropping DC, take k coeffs from index 1, zero-pad, normalize.
- transient_embedding (fractal.py:154-164): first difference with
  prepend=tile[0] (so element 0 is 0), linspace weight, DCT, FIRST k coeffs
  (DC of the diff kept), normalize.
- tonal_embedding  (fractal.py:145-152): plain DCT drop-DC, NO weighting
  (defined-but-unused in the reference; kept for capability parity).
- multi_head_embedding (fractal.py:166-175): concat tonal-head(tile_embedding)
  + transient head, zero-pad to tonal_k+transient_k. This 16-D vector is the
  live encoder's embedding (emb_dim=16 -> 8+8).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EMBED_K

_NORM_EPS = 1e-8  # reference normalizes only when ||e|| > 1e-8


@lru_cache(maxsize=None)
def dct2_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix C with (C @ x)[k] == scipy dct(x, norm='ortho')[k].

    C[k, t] = a_k * cos(pi * (2t + 1) * k / (2n)),  a_0 = sqrt(1/n), a_k = sqrt(2/n).
    """
    t = np.arange(n, dtype=np.float64)
    k = np.arange(n, dtype=np.float64)[:, None]
    c = np.cos(np.pi * (2.0 * t[None, :] + 1.0) * k / (2.0 * n))
    c *= np.sqrt(2.0 / n)
    c[0, :] *= np.sqrt(0.5)
    return c


@lru_cache(maxsize=None)
def _tile_embed_map(n: int, k: int) -> np.ndarray:
    """(n, k) map for tile_embedding: weighted DCT, drop DC, slice, zero-pad."""
    c = dct2_matrix(n)
    w = np.linspace(1.0, 2.0, n)
    take = min(k, max(0, n - 1))
    m = np.zeros((n, k), dtype=np.float64)
    # column j picks weighted coefficient j+1
    m[:, :take] = (c[1 : 1 + take, :] * w[1 : 1 + take, None]).T
    return m.astype(np.float32)


@lru_cache(maxsize=None)
def _transient_embed_map(n: int, k: int) -> np.ndarray:
    """(n, k) map for transient_embedding: diff-with-prepend, weight, DCT, first k."""
    c = dct2_matrix(n)
    w = np.linspace(1.0, 2.0, n)
    # D @ x = diff(x, prepend=x[0]) -> row 0 is zero, row t is x[t]-x[t-1]
    d = np.eye(n) - np.eye(n, k=-1)
    d[0, :] = 0.0
    take = min(k, n)
    m = np.zeros((n, k), dtype=np.float64)
    m[:, :take] = (c[:take, :] @ (np.diag(w) @ d)).T
    return m.astype(np.float32)


@lru_cache(maxsize=None)
def _tonal_embed_map(n: int, k: int) -> np.ndarray:
    """(n, min(k, n-1)) map for the unweighted tonal_embedding (dead in the
    reference live path; capability parity only). NOTE: unlike tile_embedding
    this one does NOT zero-pad (fractal.py:145-152 returns a short vector)."""
    c = dct2_matrix(n)
    take = min(k, max(0, n - 1))
    return c[1 : 1 + take, :].T.astype(np.float32)


def _normalize_rows(e: jnp.ndarray) -> jnp.ndarray:
    nrm = jnp.linalg.norm(e, axis=-1, keepdims=True)
    return jnp.where(nrm > _NORM_EPS, e / jnp.where(nrm > 0, nrm, 1.0), e)


def tile_embedding_batch(tiles: jnp.ndarray, k: int = EMBED_K) -> jnp.ndarray:
    """(B, N) tiles -> (B, k) normalized tonal-head embeddings."""
    m = jnp.asarray(_tile_embed_map(tiles.shape[-1], k))
    return _normalize_rows(jnp.dot(tiles, m, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST))


def transient_embedding_batch(tiles: jnp.ndarray, k: int = 16) -> jnp.ndarray:
    """(B, N) tiles -> (B, min(k, N) zero-padded to k) transient embeddings.

    The reference returns an unpadded min(k, N) vector; batched shapes must be
    static so we zero-pad to k here — multi_head_embedding pads identically,
    so the live 16-D layout is unchanged."""
    n = tiles.shape[-1]
    m = jnp.asarray(_transient_embed_map(n, k))
    e = jnp.dot(tiles, m, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    # normalize over the real (unpadded) coefficients only
    take = min(k, n)
    real = e[..., :take]
    nrm = jnp.linalg.norm(real, axis=-1, keepdims=True)
    real = jnp.where(nrm > _NORM_EPS, real / jnp.where(nrm > 0, nrm, 1.0), real)
    if take < k:
        return jnp.concatenate([real, jnp.zeros(e.shape[:-1] + (k - take,), e.dtype)], -1)
    return real


def tonal_embedding_batch(tiles: jnp.ndarray, k: int = 16) -> jnp.ndarray:
    """(B, N) tiles -> (B, min(k, N-1)) unweighted tonal embeddings."""
    m = jnp.asarray(_tonal_embed_map(tiles.shape[-1], k))
    return _normalize_rows(jnp.dot(tiles, m, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST))


def multi_head_embedding_batch(
    tiles: jnp.ndarray, tonal_k: int = 8, transient_k: int = 8
) -> jnp.ndarray:
    """(B, N) tiles -> (B, tonal_k + transient_k) multi-head embeddings.

    Layout matches the reference exactly (fractal.py:166-175): the transient
    head's zero-pad lands at the tail because the reference pads the concat.
    For N >= transient_k the transient head is unpadded and layouts coincide;
    for N < transient_k the reference produces
      [tonal(tonal_k) | transient(N) | zeros(transient_k - N)]
    which is what transient_embedding_batch's tail padding yields."""
    return jnp.concatenate(
        [
            tile_embedding_batch(tiles, k=tonal_k),
            transient_embedding_batch(tiles, k=transient_k),
        ],
        axis=-1,
    )


# --- scalar conveniences (reference per-tile API shape) ---------------------

def tile_embedding(x, k: int = EMBED_K) -> np.ndarray:
    return np.asarray(tile_embedding_batch(jnp.asarray(x, jnp.float32)[None, :], k=k)[0])


def transient_embedding(tile, k: int = 16) -> np.ndarray:
    n = len(tile)
    e = np.asarray(transient_embedding_batch(jnp.asarray(tile, jnp.float32)[None, :], k=k)[0])
    return e[: min(k, n)]  # reference returns the unpadded vector


def tonal_embedding(tile, k: int = 16) -> np.ndarray:
    return np.asarray(tonal_embedding_batch(jnp.asarray(tile, jnp.float32)[None, :], k=k)[0])


def multi_head_embedding(tile, tonal_k: int = 8, transient_k: int = 8) -> np.ndarray:
    return np.asarray(
        multi_head_embedding_batch(
            jnp.asarray(tile, jnp.float32)[None, :], tonal_k=tonal_k, transient_k=transient_k
        )[0]
    )


def quick_energy(x) -> float:
    """Sum of squares (reference: fractal.py:210-211)."""
    x = np.asarray(x)
    return float(np.sum(x * x))


def correlation_upper_bound(r_c, d_c, r_norm, d_norm) -> float:
    """|corr| <= 1 bound (reference: fractal.py:213-217)."""
    if d_norm < 1e-12 or r_norm < 1e-12:
        return 0.0
    return abs(float(np.dot(r_c, d_c))) / (r_norm * d_norm)
