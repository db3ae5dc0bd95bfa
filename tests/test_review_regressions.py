"""Regressions for bugs found in the round-1 code review."""

import numpy as np
import pytest

from fwav import compress_audio_arrays, compute_snr, decompress_audio
from fwav.models.encode import prune_bank


def test_tile_size_with_odd_range_factor():
    """tile_size=1536 -> range_size=6: the encode bucket must stay a multiple
    of range_size (used to crash in reshape for ~half of all lengths)."""
    rng = np.random.default_rng(0)
    t = np.arange(4000) / 8000.0
    sig = (10000 * np.sin(2 * np.pi * 440 * t) + 50 * rng.standard_normal(4000)).astype(np.float32)
    rec, domains, n_ranges, rs, tile, *_ = compress_audio_arrays(
        sig, 8000, 2, tile_size=1536
    )
    assert (tile, rs) == (1536, 6)
    recon = decompress_audio(rec, domains, n_ranges, rs, original_len=len(sig))
    assert recon.shape == (4000,)
    assert np.all(rec["idx"] < len(domains))


def test_coarse_tiny_bank_never_emits_out_of_range_idx():
    """Forced coarse search with fewer valid domains than the refine window
    used to pick zero-padded bank rows (score 0 beats negative balanced
    scores) and emit idx >= n_domains — which crashed prune_bank and the
    reference decoder."""
    rng = np.random.default_rng(1)
    sig = (np.full(271, 5000.0) + 100 * rng.standard_normal(271)).astype(np.float32)
    rec, domains, n_ranges, rs, *_ = compress_audio_arrays(
        sig, 8000, 2, tile_size=256, search="coarse"
    )
    live = rec["idx"] >= 0
    assert np.all(rec["idx"][live] < len(domains)), (
        rec["idx"][live].max(), len(domains)
    )
    # and pruning such an encode must work
    rec_p, bank_p = prune_bank(rec, domains)
    assert np.all(rec_p["idx"][rec_p["idx"] >= 0] < len(bank_p))


@pytest.mark.parametrize("n_dev", [3, 6])
def test_sharded_encode_odd_device_counts(tone, n_dev):
    """mb padding for non-power-of-two device counts used to loop forever."""
    from fwav.parallel.mesh import make_mesh
    from fwav.parallel.shard import compress_audio_sharded

    sig, sr, sw = tone
    mesh = make_mesh(n_dev, dp=n_dev, tp=1)
    rec, domains, n_ranges, rs, *_ = compress_audio_sharded(
        sig, sr, sw, mesh=mesh, tile_size=128
    )
    recon = decompress_audio(rec, domains, n_ranges, rs, original_len=len(sig))
    assert compute_snr(sig, recon) > 4.0


def test_streaming_forwards_encoder_knobs():
    """fast_mode (and friends) must reach the shard encoder; unknown kwargs
    must raise instead of being silently dropped."""
    from fwav.models.stream import compress_audio_streaming

    rng = np.random.default_rng(2)
    sr = 8000
    sig = (8000 * np.sin(2 * np.pi * 300 * np.arange(4 * sr) / sr)).astype(np.float32)
    sig[sr : 2 * sr] = 0.0  # a silent second

    rec_fast, *_ = compress_audio_streaming(
        sig, sr, 2, tile_size=128, shard_samples=4096, halo=1024, fast_mode=True
    )
    rec_slow, *_ = compress_audio_streaming(
        sig, sr, 2, tile_size=128, shard_samples=4096, halo=1024, fast_mode=False
    )
    assert np.any(rec_fast["idx"] == -1)
    assert np.all(rec_slow["idx"] >= 0)

    with pytest.raises(TypeError, match="unknown compress kwargs"):
        compress_audio_streaming(sig, sr, 2, not_a_knob=1)


def test_cli_batch_decompress_uppercase_extension(tmp_path, tone):
    """X.FWAV must produce X_recon.wav and be skipped on rerun."""
    import os

    from fwav.cli import main
    from fwav.io.wav import write_wav

    sig, sr, _ = tone
    wav = tmp_path / "x.wav"
    write_wav(wav, sig, sr, 2)
    main(["compress", str(wav), str(tmp_path / "X.FWAV"), "--tile", "128"])
    out = tmp_path / "out"
    main(["decompress", str(tmp_path), "--batch", "--out", str(out)])
    assert (out / "X_recon.wav").exists(), os.listdir(out)
    mtime = (out / "X_recon.wav").stat().st_mtime
    main(["decompress", str(tmp_path), "--batch", "--out", str(out)])
    assert (out / "X_recon.wav").stat().st_mtime == mtime  # skip-resume held


@pytest.mark.parametrize("k", [2, 3, 4])
def test_h2d_chunked_records_bit_equal(speechlike, k):
    """EncoderConfig.h2d_chunks reassembles the identical raw buffer on
    device: records and banks must match the single-put path bit for bit
    (k=3 never divides the pow2-factored bucket, exercising the fallback).
    Covers both transport dtypes: the int16-exact fixture and a float
    variant that fails the int16 rule."""
    from fwav.config import EncoderConfig

    sig, sr, sw = speechlike
    for signal in (sig, sig + np.float32(0.25)):
        base = compress_audio_arrays(signal, sr, sw)
        cfg = EncoderConfig(h2d_chunks=k)
        chunked = compress_audio_arrays(signal, sr, sw, config=cfg)
        assert np.array_equal(base[0], chunked[0])
        assert np.array_equal(base[1], chunked[1])
        assert base[2:] == chunked[2:]


def test_unpack_bits_truncated_raises():
    """A truncated packed idx stream must raise the format ValueError, not
    zero-pad: np.unpackbits(count=N) silently pads a short buffer, which
    would decode truncation as silent zero indices (review round 4)."""
    from fwav.io.compact import _pack_bits, _unpack_bits

    vals = np.arange(100, dtype=np.int64)
    buf = _pack_bits(vals, 7)
    assert np.array_equal(_unpack_bits(buf, 100, 7), vals)
    with pytest.raises(ValueError, match="Truncated"):
        _unpack_bits(buf[:-1], 100, 7)
    with pytest.raises(ValueError, match="Truncated"):
        _unpack_bits(b"\x01", 100, 7)
