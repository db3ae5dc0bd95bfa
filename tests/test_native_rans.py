"""Native C++ rANS coder vs the numpy executable spec (io/rans.py).

The native coder must produce BYTE-IDENTICAL streams (same constants, lane
schedule, push/pop order) and decode the spec's streams exactly — the same
head-to-head discipline as test_native_refit.py."""

import numpy as np
import pytest

from fwav.io import native, rans
from fwav.io.rans import _decode_np, _encode_np, quantize_freqs

pytestmark = pytest.mark.skipif(
    not native.available()
    or getattr(native._load(), "fwav_rans_encode", None) is None,
    reason="native library unavailable",
)


def _case(m, alphabet, skew, seed):
    rng = np.random.default_rng(seed)
    counts = np.maximum(rng.zipf(skew, alphabet) if skew else
                        rng.integers(1, 100, alphabet), 1)
    freqs = quantize_freqs(counts)
    live = np.nonzero(freqs)[0]
    sym = rng.choice(live, size=m, p=freqs[live] / freqs.sum())
    return sym.astype(np.int64), freqs


@pytest.mark.parametrize("m,alphabet,skew", [
    (0, 1, 0),
    (1, 1, 0),
    (5, 3, 0),
    (255, 256, 0),
    (256, 256, 0),
    (257, 17, 0),
    (5000, 961, 2.0),
    (100_000, 4096, 1.5),
    (100_000, 256, 0),
])
def test_native_stream_bit_identical(m, alphabet, skew):
    sym, freqs = _case(m, alphabet, skew, seed=m + alphabet)
    np_bytes = _encode_np(sym, freqs)
    nat_bytes = native.rans_encode(sym, freqs)
    assert nat_bytes == np_bytes
    # cross-decode both ways
    np.testing.assert_array_equal(_decode_np(nat_bytes, m, freqs), sym)
    nat_dec = native.rans_decode(np_bytes, m, freqs)
    np.testing.assert_array_equal(nat_dec, sym)
    # and the public dispatchers agree end to end
    np.testing.assert_array_equal(rans.decode(rans.encode(sym, freqs), m, freqs), sym)


def test_native_truncation_raises_like_spec():
    sym, freqs = _case(5000, 200, 0, seed=9)
    buf = _encode_np(sym, freqs)
    short = buf[: 4 * rans._lanes_for(5000) - 1]  # inside the lane states
    with pytest.raises(ValueError, match="Truncated"):
        native.rans_decode(short, 5000, freqs)
    with pytest.raises(ValueError, match="Truncated"):
        _decode_np(short, 5000, freqs)
    # mid-stream cut: both implementations must flag it (never garbage out)
    cut = buf[: len(buf) // 2]
    with pytest.raises(ValueError, match="Truncated"):
        native.rans_decode(cut, 5000, freqs)
    with pytest.raises(ValueError, match="Truncated"):
        _decode_np(cut, 5000, freqs)


@pytest.mark.parametrize("m,bits", [(1, 1), (7, 3), (255, 19), (4096, 24),
                                    (100_001, 25), (50_000, 12)])
def test_native_pack_bits_bit_identical(m, bits):
    from fwav.io import compact as C

    rng = np.random.default_rng(m + bits)
    v = rng.integers(0, 1 << bits, m).astype(np.int64)
    # numpy spec path (bypass the native fast path by calling internals)
    shifts = np.arange(bits, dtype=np.uint64)[None, :]
    chunks = []
    for i in range(0, m, C._BITPACK_CHUNK):
        b = ((v[i : i + C._BITPACK_CHUNK].astype(np.uint64)[:, None] >> shifts) & 1).astype(np.uint8)
        chunks.append(np.packbits(b.reshape(-1), bitorder="little").tobytes())
    spec = b"".join(chunks)
    nat = native.pack_bits(v, bits)
    assert nat == spec
    np.testing.assert_array_equal(native.unpack_bits(spec, m, bits), v)
    # the public helpers agree end to end
    np.testing.assert_array_equal(C._unpack_bits(C._pack_bits(v, bits), m, bits), v)


@pytest.mark.parametrize("pb,alphabet", [(2, 4), (8, 200), (16, 6000)])
def test_native_prob_bits_bit_identical(pb, alphabet):
    """round-5 _pb entry points: native streams stay byte-identical to the
    numpy spec at every probability resolution (16 bits is the idx_enc=2
    rank coder; without it wide alphabets degenerate to uniform)."""
    rng = np.random.default_rng(pb * 31 + alphabet)
    m = 50_000
    sym = np.concatenate(
        [np.arange(alphabet), rng.zipf(1.4, m - alphabet) % alphabet]
    ).astype(np.int64)
    freqs = quantize_freqs(np.bincount(sym, minlength=alphabet), pb)
    np_bytes = _encode_np(sym, freqs, pb)
    nat_bytes = native.rans_encode(sym, freqs, pb)
    if nat_bytes is None:
        pytest.skip("stale native library without the _pb entry points")
    assert nat_bytes == np_bytes
    np.testing.assert_array_equal(_decode_np(nat_bytes, m, freqs, pb), sym)
    np.testing.assert_array_equal(native.rans_decode(np_bytes, m, freqs, pb), sym)
    np.testing.assert_array_equal(
        rans.decode(rans.encode(sym, freqs, pb), m, freqs, pb), sym
    )
