"""io.rans — lane-interleaved static rANS (the compact container's round-4
entropy stage). Properties: exact round trip at any (alphabet, length,
skew) incl. lane-boundary lengths; near-entropy rate on skewed data;
corrupt/truncated streams raise instead of looping."""

import numpy as np
import pytest

from fwav.io import rans


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_round_trip(seed):
    rng = np.random.default_rng(seed)
    A = int(rng.choice([1, 2, 3, 17, 256, 554, 4096]))
    m = int(rng.choice([0, 1, 5, 127, 128, 129, 257, 1000, 32768, 100001]))
    p = rng.dirichlet(np.full(A, float(rng.choice([0.02, 0.3, 1.0, 5.0]))))
    sym = rng.choice(A, size=m, p=p) if m else np.zeros(0, np.int64)
    counts = np.bincount(sym, minlength=A) if m else np.ones(A, np.int64)
    f = rans.quantize_freqs(counts)
    buf = rans.encode(sym, f)
    np.testing.assert_array_equal(rans.decode(buf, m, f), sym)


def test_lane_boundary_lengths():
    # every m around the lane-count switch points and partial last steps
    rng = np.random.default_rng(42)
    f = rans.quantize_freqs(np.array([7, 1, 92, 400]))
    for m in [0, 1, 2, 255, 256, 257, 511, 512, 513, 4095, 4096, 4097]:
        sym = rng.choice(4, size=m, p=[0.014, 0.002, 0.184, 0.8])
        buf = rans.encode(sym, f)
        np.testing.assert_array_equal(rans.decode(buf, m, f), sym)


def test_near_entropy_rate():
    rng = np.random.default_rng(0)
    m = 60000
    p = rng.dirichlet(np.full(300, 0.05))
    sym = rng.choice(300, size=m, p=p)
    counts = np.bincount(sym, minlength=300)
    f = rans.quantize_freqs(counts)
    nz = counts > 0
    h = -(counts[nz] / m * np.log2(counts[nz] / m)).sum()
    buf = rans.encode(sym, f)
    # within 3% of the order-0 floor plus the per-lane state flush
    assert len(buf) <= h * m / 8 * 1.03 + 4 * 128, (len(buf), h * m / 8)


def test_single_symbol_alphabet_costs_nothing():
    f = rans.quantize_freqs(np.array([123]))
    sym = np.zeros(10000, np.int64)
    buf = rans.encode(sym, f)
    assert len(buf) <= 4 * 128  # states only, zero stream bytes
    np.testing.assert_array_equal(rans.decode(buf, 10000, f), sym)


def test_quantize_freqs_contract():
    f = rans.quantize_freqs(np.array([1, 0, 10**9, 3, 0, 1]))
    assert int(f.sum()) == 1 << rans.PROB_BITS
    assert f[1] == 0 and f[4] == 0          # absent symbols stay absent
    assert f[0] >= 1 and f[3] >= 1 and f[5] >= 1  # observed stay encodable
    with pytest.raises(ValueError):
        rans.quantize_freqs(np.zeros(4, np.int64))
    with pytest.raises(ValueError):
        rans.quantize_freqs(np.ones((1 << rans.PROB_BITS) + 1, np.int64))


def test_truncated_stream_raises():
    rng = np.random.default_rng(1)
    sym = rng.choice(5, size=5000, p=[0.5, 0.3, 0.1, 0.06, 0.04])
    f = rans.quantize_freqs(np.bincount(sym, minlength=5))
    buf = rans.encode(sym, f)
    with pytest.raises(ValueError, match="Truncated"):
        rans.decode(buf[: len(buf) // 2], 5000, f)
    with pytest.raises(ValueError, match="Truncated"):
        rans.decode(b"", 5000, f)


def test_parse_freqs_rejects_bad_table():
    f = rans.quantize_freqs(np.array([3, 5]))
    buf = rans.serialize_freqs(f)
    assert np.array_equal(rans.parse_freqs(buf, 2), f)
    with pytest.raises(ValueError, match="frequency table"):
        rans.parse_freqs(buf[:2], 2)
    bad = bytearray(buf)
    bad[0] ^= 1
    with pytest.raises(ValueError, match="frequency table"):
        rans.parse_freqs(bytes(bad), 2)


# --- round-5 prob_bits parameterization ------------------------------------

def test_prob_bits_bounds():
    with pytest.raises(ValueError, match="prob_bits"):
        rans.quantize_freqs(np.array([1, 2]), 0)
    with pytest.raises(ValueError, match="prob_bits"):
        rans.quantize_freqs(np.array([1, 2]), rans.MAX_PROB_BITS + 1)
    f = rans.quantize_freqs(np.array([1, 2]), rans.MAX_PROB_BITS)
    with pytest.raises(ValueError, match="prob_bits"):
        rans.encode(np.zeros(4, np.int64), f, 17)
    with pytest.raises(ValueError, match="prob_bits"):
        rans.decode(b"", 4, f, 0)


def test_wide_alphabet_needs_16_bits():
    """The motivating case for prob_bits (idx_enc=2): an alphabet wider
    than 2^12 is rejected at the default resolution and codes near its
    entropy at 16 bits."""
    rng = np.random.default_rng(3)
    A, m = 6000, 80000
    p = rng.dirichlet(np.full(A, 0.05))
    # every symbol observed at least once: the alphabet itself, then the
    # skewed bulk (matches the damped profile's every-row-is-referenced
    # unique list, where the table must cover all of them)
    sym = np.concatenate([np.arange(A), rng.choice(A, size=m - A, p=p)])
    counts = np.bincount(sym, minlength=A)
    with pytest.raises(ValueError, match="at most"):
        rans.quantize_freqs(counts)  # default 12-bit table cannot hold it
    f = rans.quantize_freqs(counts, 16)
    assert int(f.sum()) == 1 << 16
    buf = rans.encode(sym, f, 16)
    np.testing.assert_array_equal(rans.decode(buf, m, f, 16), sym)
    nz = counts > 0
    h = -(counts[nz] / m * np.log2(counts[nz] / m)).sum()
    # near the order-0 floor (the 12-bit coder could not beat uniform here)
    assert len(buf) <= h * m / 8 * 1.05 + 4 * 128, (len(buf), h * m / 8)


@pytest.mark.parametrize("pb", [2, 8, 16])
def test_prob_bits_round_trip_and_stream_mismatch(pb):
    rng = np.random.default_rng(pb)
    A = min(1 << pb, 300)
    sym = rng.integers(0, A, 20000)
    f = rans.quantize_freqs(np.bincount(sym, minlength=A), pb)
    buf = rans.encode(sym, f, pb)
    np.testing.assert_array_equal(rans.decode(buf, 20000, f, pb), sym)
    # a table quantized at a different resolution must be rejected up front
    with pytest.raises(ValueError, match="sum"):
        rans.decode(buf, 20000, f, pb - 1 if pb > 1 else pb + 1)
