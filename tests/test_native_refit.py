"""Native refit kernel (native/fwavio.cpp fwav_refit) vs the numpy
specification in ops/affine.refit_host.

The numpy path is the executable spec: same centered-sum refit the device
performs (reference solve semantics, fractal.py:802-825), orientation
re-derived host-side. The native kernel must agree on the ORIENTATION
decision exactly (it feeds the stored sym bit) and on s/o/err to float32
round-off (accumulation order differs: one fused pass vs BLAS reductions).
"""

import numpy as np
import pytest

from fwav.io import native
from fwav.ops import affine


needs_native = pytest.mark.skipif(
    not native.available(), reason="native runtime unavailable"
)


def _numpy_refit(ranges, bank, idx, s_clip):
    prev = affine._FORCE_NUMPY_REFIT
    affine._FORCE_NUMPY_REFIT = True
    try:
        return affine.refit_host(ranges, bank, idx, s_clip)
    finally:
        affine._FORCE_NUMPY_REFIT = prev


def _compare(ranges, bank, idx, s_clip=16.0):
    s_n, o_n, e_n, y_n = _numpy_refit(ranges, bank, idx, s_clip)
    out = native.refit(
        np.ascontiguousarray(ranges, np.float32), bank, idx, s_clip
    )
    assert out is not None
    s_c, o_c, e_c, y_c = out
    np.testing.assert_array_equal(y_c, y_n)
    np.testing.assert_allclose(s_c, s_n, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(o_c, o_n, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(e_c, e_n, rtol=2e-5, atol=1e-5)


@needs_native
@pytest.mark.parametrize("n", [4, 6, 8, 16])
def test_native_matches_numpy_random(n):
    rng = np.random.default_rng(7)
    m, d = 4096, 1024
    ranges = rng.standard_normal((m, n)).astype(np.float32) * 100
    bank = rng.standard_normal((d, n)).astype(np.float32) * 100
    idx = rng.integers(0, d, m).astype(np.int32)
    _compare(ranges, bank, idx)


@needs_native
def test_native_matches_numpy_edge_rows():
    # constant tiles (denom ~ 0), constant ranges, huge s needing the clip,
    # and exact-fit rows (err == 0)
    n = 4
    ranges = np.array(
        [
            [1.0, 1.0, 1.0, 1.0],          # constant range
            [1000.0, -1000.0, 500.0, 0.0], # needs s clip vs tiny-denom tile
            [2.0, 4.0, 6.0, 8.0],          # exact affine image of tile 2
            [8.0, 6.0, 4.0, 2.0],          # mirrored exact fit
        ],
        np.float32,
    )
    bank = np.array(
        [
            [3.0, 3.0, 3.0, 3.0],               # zero-variance tile
            [3.0, 3.0000001, 3.0, 3.0],         # near-zero variance
            [1.0, 2.0, 3.0, 4.0],
        ],
        np.float32,
    )
    idx = np.array([0, 1, 2, 2], np.int32)
    _compare(ranges, bank, idx, s_clip=16.0)


@needs_native
def test_native_refit_used_by_default_and_equivalent_end_to_end():
    # the public refit_host must route to the native kernel and produce
    # selection-identical results to the forced-numpy path on real-ish data
    rng = np.random.default_rng(11)
    m, d, n = 2000, 5000, 4
    bank = rng.standard_normal((d, n)).astype(np.float32)
    idx = rng.integers(0, d, m).astype(np.int32)
    s_true = rng.uniform(-2, 2, m).astype(np.float32)
    o_true = rng.uniform(-1, 1, m).astype(np.float32)
    ranges = (
        bank[idx] * s_true[:, None]
        + o_true[:, None]
        + 0.01 * rng.standard_normal((m, n)).astype(np.float32)
    ).astype(np.float32)

    s, o, err, sym = affine.refit_host(ranges, bank, idx, 16.0)
    s2, o2, e2, y2 = _numpy_refit(ranges, bank, idx, 16.0)
    np.testing.assert_array_equal(sym, y2)
    np.testing.assert_allclose(s, s2, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(o, o2, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(err, e2, rtol=2e-5, atol=1e-5)


@needs_native
def test_native_collect_matches_numpy_collect(monkeypatch):
    # the fused 3-byte-code -> record pass vs the numpy implementation in
    # models/encode.collect_idx_matches (selection fields must be identical;
    # refit floats to float32 round-off)
    from fwav.models import encode as enc

    rng = np.random.default_rng(5)
    m, d, n = 3000, 8000, 4
    ranges = rng.standard_normal((m, n)).astype(np.float32)
    bank = rng.standard_normal((d, n)).astype(np.float32)
    idx = rng.integers(0, d, m).astype(np.int32)
    codes = np.stack(
        [idx & 0xFF, (idx >> 8) & 0xFF, (idx >> 16) & 0xFF], axis=1
    ).astype(np.uint8)
    codes[::7] = 0xFF  # sprinkle sentinels

    rec_native = enc.collect_idx_matches(codes, m, ranges, bank, 16.0)

    import fwav.io.native as native_mod

    monkeypatch.setattr(native_mod, "collect", lambda *a: None)
    affine._FORCE_NUMPY_REFIT = True
    try:
        rec_numpy = enc.collect_idx_matches(codes, m, ranges, bank, 16.0)
    finally:
        affine._FORCE_NUMPY_REFIT = False

    np.testing.assert_array_equal(rec_native["idx"], rec_numpy["idx"])
    np.testing.assert_array_equal(rec_native["sym"], rec_numpy["sym"])
    np.testing.assert_allclose(rec_native["s"], rec_numpy["s"], rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(rec_native["o"], rec_numpy["o"], rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(rec_native["err"], rec_numpy["err"], rtol=2e-5, atol=1e-5)
    dead = rec_native["idx"] == -1
    assert dead.any() and np.all(rec_native["s"][dead] == 1.0)
    assert np.all(rec_native["err"][dead] == 0.0)


@needs_native
def test_native_refit_rejects_out_of_range_index():
    ranges = np.zeros((2, 4), np.float32)
    bank = np.zeros((3, 4), np.float32)
    with pytest.raises(IndexError):
        native.refit(ranges, bank, np.array([0, 3], np.int32), 16.0)
    with pytest.raises(IndexError):
        native.refit(ranges, bank, np.array([-1, 0], np.int32), 16.0)


@needs_native
@pytest.mark.parametrize("n", [4, 8, 16, 6])
def test_orientation_agrees_on_palindromic_tiles(n):
    # palindromic bank rows make num_orig and num_mirror the SAME terms
    # summed in different orders: a strict |num_m| > |num_o| would resolve
    # by accumulation-order noise and flip between the native sequential
    # kernel and numpy's BLAS reductions (measured 607/2000 rows before
    # the Cauchy-Schwarz-scaled tie tolerance). Both paths must now pick
    # the ORIGINAL orientation on every mathematical tie.
    rng = np.random.default_rng(5)
    M = 2000
    half = rng.standard_normal((M, n // 2)).astype(np.float32)
    mid = rng.standard_normal((M, n % 2)).astype(np.float32)
    bank = np.concatenate([half, mid, half[:, ::-1]], axis=1)
    ranges = (rng.standard_normal((M, n)) * 100).astype(np.float32)
    idx = np.arange(M, dtype=np.int32)
    *_, y_n = _numpy_refit(ranges, bank, idx, 16.0)
    *_, y_c = native.refit(np.ascontiguousarray(ranges), bank, idx, 16.0)
    np.testing.assert_array_equal(y_c, y_n)
    assert not y_n.any()  # ties resolve to original in both paths
