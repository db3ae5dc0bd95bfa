"""Embedding ops vs scipy/numpy goldens (reference math: fractal.py:145-208)."""

import numpy as np
import pytest
from scipy.fftpack import dct

from fwav.ops.dct import (
    dct2_matrix,
    multi_head_embedding,
    multi_head_embedding_batch,
    tile_embedding,
    tonal_embedding,
    transient_embedding,
)


def _ref_tile_embedding(x, k=32):
    x = np.asarray(x, dtype=np.float32)
    v = dct(x, norm="ortho")
    v = v * np.linspace(1.0, 2.0, len(v))
    take = min(k, max(0, len(v) - 1))
    e = v[1 : 1 + take].astype(np.float32) if take > 0 else np.zeros(0, np.float32)
    if take < k:
        e = np.concatenate([e, np.zeros(k - take, np.float32)])
    nrm = np.linalg.norm(e)
    return e / nrm if nrm > 1e-8 else e


def _ref_transient_embedding(tile, k=16):
    diff = np.diff(tile, prepend=tile[0])
    diff = diff * np.linspace(1.0, 2.0, len(diff))
    v = dct(diff, norm="ortho")[:k]
    nrm = np.linalg.norm(v)
    return (v / nrm if nrm > 1e-8 else v).astype(np.float32)


def _ref_tonal_embedding(tile, k=16):
    v = dct(tile, norm="ortho")[1 : k + 1]
    nrm = np.linalg.norm(v)
    return (v / nrm if nrm > 1e-8 else v).astype(np.float32)


def _ref_multi_head(tile, tonal_k=8, transient_k=8):
    e = np.concatenate(
        [_ref_tile_embedding(tile, k=tonal_k), _ref_transient_embedding(tile, k=transient_k)]
    )
    if len(e) < tonal_k + transient_k:
        e = np.pad(e, (0, tonal_k + transient_k - len(e)))
    return e.astype(np.float32)


def test_dct_matrix_matches_scipy():
    rng = np.random.default_rng(1)
    for n in (4, 8, 16, 32):
        x = rng.standard_normal(n).astype(np.float32)
        np.testing.assert_allclose(
            dct2_matrix(n) @ x, dct(x.astype(np.float64), norm="ortho"), atol=1e-6
        )


@pytest.mark.parametrize("n,k", [(4, 8), (8, 8), (16, 32), (32, 16)])
def test_tile_embedding_vs_scipy(n, k):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(tile_embedding(x, k=k), _ref_tile_embedding(x, k=k), atol=2e-5)


@pytest.mark.parametrize("n,k", [(4, 8), (8, 4), (16, 16)])
def test_transient_embedding_vs_scipy(n, k):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(
        transient_embedding(x, k=k), _ref_transient_embedding(x, k=k), atol=2e-5
    )


@pytest.mark.parametrize("n,k", [(8, 4), (16, 8)])
def test_tonal_embedding_vs_scipy(n, k):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(tonal_embedding(x, k=k), _ref_tonal_embedding(x, k=k), atol=2e-5)


@pytest.mark.parametrize("n", [4, 8, 16])
def test_multi_head_vs_reference_layout(n):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(multi_head_embedding(x), _ref_multi_head(x), atol=2e-5)


def test_batched_embedding_matches_per_tile():
    rng = np.random.default_rng(6)
    tiles = rng.standard_normal((64, 4)).astype(np.float32)
    batched = np.asarray(multi_head_embedding_batch(tiles))
    for i in range(0, 64, 7):
        np.testing.assert_allclose(batched[i], _ref_multi_head(tiles[i]), atol=2e-5)


def test_zero_tile_not_normalized():
    z = np.zeros(8, dtype=np.float32)
    np.testing.assert_array_equal(tile_embedding(z, k=8), np.zeros(8, np.float32))
    np.testing.assert_array_equal(multi_head_embedding(z), np.zeros(16, np.float32))
