"""Compact v2 container (io/compact.py; CLI --compact).

Selection streams (idx / sym / live bitmap) must round-trip bit-exactly;
s and the bank are float16-quantized, o is int16 FIXED point (the decoded
output is o per range, so uniform absolute error — bounded by half an LSB
of the pow2 scale, 0.5 PCM LSB on 16-bit content — is what minimizes
round-trip distortion). The format is opt-in: v1 stays the default and
the only reference-compatible layout (a v2 file fails the reference's
version check cleanly).
"""

import numpy as np
import pytest

from fwav import compute_snr, decompress_audio, load_compressed_arrays
from fwav.io.compact import (
    load_compressed_compact,
    save_compressed_compact,
)
from fwav.io.container import (
    MATCH_DTYPE,
    read_matches,
    read_version,
    save_compressed,
)
from fwav.models.encode import compress_audio_arrays, prune_bank


def _assert_o_fixed_point(got, want):
    # o is int16 fixed point: uniform absolute error <= 0.5 * 2^o_exp,
    # and the pow2 scale lands the peak in (16384, 32768] -> bound is
    # peak * 2^-15 (0.5 LSB on full-scale 16-bit PCM content); the single
    # saturated peak sample may cost 1 ulp (covered separately). Holds
    # as-is for err=0 fixtures, where the distortion-bounded o_shift
    # quantization is disabled by its own contract.
    bound = float(np.abs(want).max()) * 2.0**-15 + 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def _sig(seconds=1.2, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    sig = 0.4 * np.sin(2 * np.pi * 330 * t) + 0.15 * np.sin(2 * np.pi * 990 * t)
    sig += 0.01 * rng.standard_normal(len(t))
    sig[int(0.5 * sr) : int(0.62 * sr)] = 0.0
    return np.round(sig * 16000).astype(np.float32), sr


@pytest.fixture(scope="module")
def _encoded(tmp_path_factory):
    sig, sr = _sig()
    rec, bank, n_ranges, N, tile, step, thr, olen = compress_audio_arrays(
        sig, sr, 2, tile_size=128
    )
    rec, bank = prune_bank(rec, bank)
    d = tmp_path_factory.mktemp("compact")
    p1, p2 = d / "v1.fwav", d / "v2.fwav"
    save_compressed(p1, rec, bank, N, sr, 2, tile, step, thr, olen)
    save_compressed_compact(p2, rec, bank, N, sr, 2, tile, step, thr, olen)
    return sig, sr, rec, bank, (n_ranges, N, tile, step, thr, olen), p1, p2


def test_round_trip_fields(_encoded):
    sig, sr, rec, bank, (n_ranges, N, tile, step, thr, olen), p1, p2 = _encoded
    assert read_version(p2) == 2 and read_version(p1) == 1
    out = load_compressed_compact(p2)
    rec2, bank2 = out[0], out[1]
    assert out[2:] == (n_ranges, N, sr, 2, tile, step, np.float32(thr), olen)
    # selection is bit-exact
    np.testing.assert_array_equal(rec2["idx"], rec["idx"])
    np.testing.assert_array_equal(rec2["sym"], rec["sym"])
    live = rec["idx"] >= 0
    assert live.any() and (~live).any()
    # parameter contract (round 4, distortion-bounded quantization): the
    # EXTRA noise beyond the fp16/int16 baseline stays under _QUANT_GAMMA
    # of the encoder's residual energy, per stream (io/compact.py)
    from fwav.io.compact import _QUANT_GAMMA, _o_exp_for

    err = rec["err"][live].astype(np.float64)
    anchor = float(np.dot(err, err))
    s_base = rec["s"][live].astype(np.float16).astype(np.float64)
    d_energy = (bank2[rec["idx"][live]].astype(np.float64) ** 2).sum(axis=1)
    e_s = rec2["s"][live].astype(np.float64) - s_base
    assert float(np.dot(e_s * e_s, d_energy)) <= _QUANT_GAMMA * anchor + 1e-9
    o_exp = _o_exp_for(rec["o"][live])
    o_base = np.clip(
        np.round(rec["o"][live].astype(np.float64) * 2.0 ** -o_exp),
        -32767, 32767,
    ) * 2.0 ** o_exp
    e_o = rec2["o"][live].astype(np.float64) - o_base
    assert N * float(np.dot(e_o, e_o)) <= _QUANT_GAMMA * anchor + 1e-9
    # per-value sanity on top of the energy contract: no single range may
    # carry more decode noise than the whole budget (a fixed rtol would
    # re-encode the pre-round-4-fix behavior, where a mis-scaled budget
    # kept s_drop artificially small on this fixture's bank_exp)
    assert np.all(
        np.abs(e_s) * np.sqrt(d_energy)
        <= np.sqrt(_QUANT_GAMMA * anchor) + 1e-9
    )
    np.testing.assert_array_equal(np.sign(rec2["s"]), np.sign(rec["s"]))
    o_atol = float(np.sqrt(_QUANT_GAMMA * anchor / N)) + 1e-9
    np.testing.assert_allclose(rec2["o"], rec["o"], rtol=0,
                               atol=max(o_atol, 2.0 ** o_exp))
    np.testing.assert_allclose(bank2, bank, rtol=1e-3, atol=1e-3)
    # sentinels carry the format's exact tuple; err is not stored
    assert np.all(rec2["s"][~live] == 1.0) and np.all(rec2["o"][~live] == 0.0)
    assert np.all(rec2["err"] == 0.0)


def test_public_loader_routes_by_version(_encoded):
    *_, p1, p2 = _encoded
    rec2, bank2, *rest2 = load_compressed_arrays(p2)
    recc, bankc, *restc = load_compressed_compact(p2)
    np.testing.assert_array_equal(rec2, recc)
    np.testing.assert_array_equal(bank2, bankc)
    assert rest2 == restc
    np.testing.assert_array_equal(read_matches(p2), recc)


def test_decode_quality_and_size(_encoded):
    sig, sr, rec, bank, (n_ranges, N, *_), p1, p2 = _encoded
    r1, b1, *_ = load_compressed_arrays(p1)
    r2, b2, *_ = load_compressed_arrays(p2)
    a = decompress_audio(r1, b1, n_ranges, N, original_len=len(sig))
    b = decompress_audio(r2, b2, n_ranges, N, original_len=len(sig))
    snr1, snr2 = compute_snr(sig, a), compute_snr(sig, b)
    assert abs(snr1 - snr2) < 0.02, (snr1, snr2)
    # the rate claim: >2x smaller than pruned v1 AND smaller than the input
    v1, v2 = p1.stat().st_size, p2.stat().st_size
    assert v2 * 2 < v1, (v1, v2)
    assert v2 < len(sig) * 2, (v2, len(sig) * 2)  # actually compresses


def test_checksum_and_truncation(_encoded, tmp_path):
    *_, p2 = _encoded
    raw = bytearray(p2.read_bytes())
    raw[-1] ^= 0xFF
    bad = tmp_path / "bad.fwav"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="Checksum mismatch"):
        load_compressed_compact(bad)
    from fwav.io.compact import _EXT_OFFSET, FLAG_DEFLATE

    if raw[_EXT_OFFSET + 3] & FLAG_DEFLATE:
        # SHA opt-out honored, but the zlib stream's own adler32 still
        # catches payload corruption — deflated files are never silently
        # garbage even with verify_checksum=False
        with pytest.raises(ValueError, match="payload"):
            load_compressed_compact(bad, verify_checksum=False)
    else:
        load_compressed_compact(bad, verify_checksum=False)  # opt-out honored
    short = tmp_path / "short.fwav"
    short.write_bytes(p2.read_bytes()[:-3])
    with pytest.raises(ValueError, match="payload"):
        load_compressed_compact(short, verify_checksum=False)


def test_scale_exp_handles_loud_content(tmp_path):
    # o / bank values beyond float16 max must survive via the pow2 scale
    rng = np.random.default_rng(1)
    n_ranges, n_dom, N = 64, 32, 4
    rec = np.zeros(n_ranges, MATCH_DTYPE)
    rec["idx"] = rng.integers(0, n_dom, n_ranges)
    rec["s"] = rng.uniform(-16, 16, n_ranges).astype(np.float32)
    rec["o"] = rng.uniform(-3e5, 3e5, n_ranges).astype(np.float32)
    rec["sym"] = rng.integers(0, 2, n_ranges)
    bank = (rng.standard_normal((n_dom, N)) * 2e5).astype(np.float32)
    p = tmp_path / "loud.fwav"
    save_compressed_compact(p, rec, bank, N, 8000, 2, 1024, 1, 1e-4, 256)
    rec2, bank2, *_ = load_compressed_compact(p)
    assert np.all(np.isfinite(rec2["o"])) and np.all(np.isfinite(bank2))
    _assert_o_fixed_point(rec2["o"], rec["o"])
    np.testing.assert_allclose(bank2, bank, rtol=1e-3, atol=1e-12)
    np.testing.assert_array_equal(rec2["idx"], rec["idx"])


@pytest.mark.parametrize("peak", [2.0**20, 1.0])
def test_s_drop_budget_is_scale_invariant(tmp_path, peak):
    # regression (round-4 review): the s-quantization noise budget used the
    # fp16-SCALED bank energy without restoring 2^(2*bank_exp), so loud
    # float content (bank_exp > 0) over-dropped mantissa bits (measured
    # 4.8 dB of damped-decode loss at peak 2^20) and quiet content
    # (bank_exp = -14) never dropped any. The budget must hold at every
    # scale: compact round-trip decode within the documented ~0.03 dB of
    # the unquantized records' decode.
    rng = np.random.default_rng(3)
    sr = 16000
    t = np.arange(int(sr * 1.2)) / sr
    sig = (
        0.4 * np.sin(2 * np.pi * 330 * t)
        + 0.15 * np.sin(2 * np.pi * (900 + 200 * t) * t)
        + 0.01 * rng.standard_normal(len(t))
    ).astype(np.float32) * np.float32(peak)
    rec, bank, n_ranges, N, tile, step, thr, olen = compress_audio_arrays(
        sig, sr, 2, objective="damped"
    )
    rec_p, bank_p = prune_bank(rec, bank)
    want = decompress_audio(rec_p, bank_p, n_ranges, N, original_len=olen,
                            s_damping=0.25)
    p = tmp_path / "scale.fwav"
    save_compressed_compact(p, rec_p, bank_p, N, sr, 2, tile, step, thr, olen)
    rec2, bank2, n2, N2, *_ = load_compressed_compact(p)
    got = decompress_audio(rec2, bank2, n2, N2, original_len=olen,
                           s_damping=0.25)
    snr_w = compute_snr(sig, want)
    snr_g = compute_snr(sig, got)
    assert snr_w - snr_g < 0.05, (peak, snr_w, snr_g)


def test_subnormal_content_does_not_crash(tmp_path):
    # peaks below float32's normal range clamp the pow2 exponent to the
    # int8 header field instead of crashing struct.pack / overflowing 2^k
    rec = np.zeros(8, MATCH_DTYPE)
    rec["idx"] = np.arange(8) % 2
    rec["s"] = 1.0
    rec["o"] = np.float32(1e-41)
    bank = np.full((2, 4), 1e-41, np.float32)
    p = tmp_path / "tiny.fwav"
    save_compressed_compact(p, rec, bank, 4, 8000, 2, 1024, 1, 1e-4, 32)
    rec2, bank2, *_ = load_compressed_compact(p)
    np.testing.assert_array_equal(rec2["idx"], rec["idx"])
    assert np.all(np.isfinite(bank2)) and np.all(np.isfinite(rec2["o"]))
    # reduced precision is acceptable down here: the fp16 bank keeps its
    # relative scale; fixed-point o under the clamped exponent may flush
    # to zero but stays within half an LSB of the clamped scale (2^-127)
    np.testing.assert_allclose(bank2, bank, rtol=2e-3)
    np.testing.assert_allclose(rec2["o"], rec["o"], rtol=0, atol=2.0**-126)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_round_trip(tmp_path, seed):
    # property: any record table + bank round-trips with exact selection
    # and fp16-bounded parameters, at any shape (incl. n_ranges=0, no
    # sentinels, all sentinels, n_domains=1, non-pow2 N)
    rng = np.random.default_rng(seed)
    n_ranges = int(rng.integers(0, 400))
    n_dom = int(rng.integers(1, 900))
    N = int(rng.choice([4, 5, 8, 16]))
    rec = np.zeros(n_ranges, MATCH_DTYPE)
    live = rng.random(n_ranges) < rng.random()
    rec["idx"] = np.where(live, rng.integers(0, n_dom, n_ranges), -1)
    rec["s"] = np.where(live, rng.uniform(-16, 16, n_ranges), 1.0).astype(np.float32)
    rec["o"] = np.where(live, rng.uniform(-4e4, 4e4, n_ranges), 0.0).astype(np.float32)
    rec["sym"] = np.where(live, rng.integers(0, 2, n_ranges), 0)
    scale = float(rng.choice([1.0, 1e-3, 1e5]))
    bank = (rng.standard_normal((n_dom, N)) * scale).astype(np.float32)
    p = tmp_path / f"f{seed}.fwav"
    save_compressed_compact(p, rec, bank, N, 44100, 2, 1024, 1, 1e-4, n_ranges * N)
    rec2, bank2, n_r, N2, *_ = load_compressed_compact(p)
    assert (n_r, N2) == (n_ranges, N)
    np.testing.assert_array_equal(rec2["idx"], rec["idx"])
    np.testing.assert_array_equal(rec2["sym"], rec["sym"])
    np.testing.assert_allclose(rec2["s"], rec["s"], rtol=1e-3, atol=1e-4)
    _assert_o_fixed_point(rec2["o"], rec["o"])
    np.testing.assert_allclose(bank2, bank, rtol=1e-3, atol=1e-12)


def _flags_of(path):
    from fwav.io.compact import _EXT_OFFSET

    return path.read_bytes()[_EXT_OFFSET + 3]


def test_idx_delta_variant_selected_and_exact(tmp_path):
    # smoothly drifting domain indices: zigzag first-differences are tiny
    # constants, so the writer must pick FLAG_IDX_DELTA — and the stream
    # must still round-trip bit-exactly at idx_bits+1 packing
    from fwav.io.compact import FLAG_IDX_DELTA

    n_ranges, n_dom = 4096, 5000
    rec = np.zeros(n_ranges, MATCH_DTYPE)
    rec["idx"] = (np.arange(n_ranges) + (np.arange(n_ranges) % 3)) % n_dom
    rec["s"] = 1.0
    rng = np.random.default_rng(7)
    bank = rng.standard_normal((n_dom, 4)).astype(np.float32)
    p = tmp_path / "drift.fwav"
    save_compressed_compact(p, rec, bank, 4, 8000, 2, 1024, 1, 1e-4, n_ranges * 4)
    assert _flags_of(p) & FLAG_IDX_DELTA
    rec2, *_ = load_compressed_compact(p)
    np.testing.assert_array_equal(rec2["idx"], rec["idx"])


def test_raw_fallback_branch(tmp_path, monkeypatch):
    # if deflate ever loses (incompressible content), the writer must store
    # the raw stream layout (flags=0) and the loader must read it back
    import fwav.io.compact as compact

    real = compact.zlib.compress
    monkeypatch.setattr(
        compact.zlib, "compress", lambda b, lvl=6: real(b, lvl) + b"\0" * len(b)
    )
    # disable the entropy layout so the legacy raw-fallback branch decides
    monkeypatch.setattr(compact, "_entropy_variant", lambda *a, **k: None)
    sig, sr = _sig()
    rec, bank, n_ranges, N, tile, step, thr, olen = compress_audio_arrays(
        sig, sr, 2, tile_size=128
    )
    rec, bank = prune_bank(rec, bank)
    p = tmp_path / "raw.fwav"
    save_compressed_compact(p, rec, bank, N, sr, 2, tile, step, thr, olen)
    monkeypatch.undo()
    from fwav.io.compact import FLAG_DEFLATE, FLAG_O_INT16

    assert _flags_of(p) == FLAG_O_INT16  # raw layout, no deflate bits
    rec2, bank2, *_ = load_compressed_compact(p)
    np.testing.assert_array_equal(rec2["idx"], rec["idx"])
    np.testing.assert_array_equal(rec2["sym"], rec["sym"])
    np.testing.assert_allclose(rec2["s"], rec["s"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(bank2, bank, rtol=1e-3, atol=1e-3)


def test_large_payload_level1_path(tmp_path):
    # >64 MB of raw streams routes through the fast (level-1) deflate and
    # the bounded idx probe; round trip must stay exact on selections. The
    # bank carries the bulk (cheap to build) while n_ranges stays >1 chunk
    # of the chunked bit-packer (tests/test_compact.py is CPU-only).
    rng = np.random.default_rng(3)
    n_ranges, n_dom = 2_000_000, 4_000_000
    rec = np.zeros(n_ranges, MATCH_DTYPE)
    rec["idx"] = rng.integers(0, n_dom, n_ranges)
    rec["s"] = rng.uniform(-16, 16, n_ranges).astype(np.float32)
    rec["o"] = rng.uniform(-3e4, 3e4, n_ranges).astype(np.float32)
    rec["sym"] = rng.integers(0, 2, n_ranges)
    bank = rng.standard_normal((n_dom, 4)).astype(np.float32)
    p = tmp_path / "big.fwav"
    save_compressed_compact(p, rec, bank, 4, 44100, 2, 1024, 1, 1e-4, n_ranges * 4)
    rec2, bank2, n_r, *_ = load_compressed_compact(p)
    assert n_r == n_ranges
    np.testing.assert_array_equal(rec2["idx"], rec["idx"])
    np.testing.assert_array_equal(rec2["sym"], rec["sym"])
    np.testing.assert_allclose(rec2["s"], rec["s"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(bank2, bank, rtol=1e-3, atol=1e-12)


def test_all_silent_round_trip(tmp_path):
    rec = np.zeros(16, MATCH_DTYPE)
    rec["idx"] = -1
    rec["s"] = 1.0
    bank = np.zeros((1, 4), np.float32)
    p = tmp_path / "silent.fwav"
    save_compressed_compact(p, rec, bank, 4, 8000, 2, 1024, 1, 1e-4, 64)
    rec2, bank2, *_ = load_compressed_compact(p)
    np.testing.assert_array_equal(rec2, rec)
    np.testing.assert_array_equal(bank2, bank)


def test_streaming_compact_file_level(tmp_path, monkeypatch):
    # long-file branch: streaming encode -> pruned rows -> compact container
    import fwav.models.codec as codec
    from fwav.io.wav import read_wav_mono, write_wav
    from fwav.models.codec import (
        process_file_compress,
        process_file_decompress,
    )

    monkeypatch.setattr(codec, "STREAMING_THRESHOLD", 8000)
    sig, sr = _sig(seconds=1.5, seed=7)
    wav = tmp_path / "in.wav"
    write_wav(wav, sig, sr, 2)
    r = process_file_compress(
        str(wav), str(tmp_path / "out.fwav"), tile=128, compact=True,
        shard_samples=4096, halo=2048,
    )
    assert "error" not in r, r
    assert read_version(r["output"]) == 2
    assert r["ratio"] > 1.0, r  # actually compresses
    r2 = process_file_decompress(r["output"], str(tmp_path / "rec.wav"))
    assert "error" not in r2, r2
    recon, _, _ = read_wav_mono(r2["output"])
    assert compute_snr(sig, recon) > 8.0


def test_cli_compact_round_trip(tmp_path):
    from fwav.cli import main
    from fwav.io.wav import read_wav_mono, write_wav

    sig, sr = _sig(seconds=0.6, seed=4)
    wav = tmp_path / "in.wav"
    write_wav(wav, sig, sr, 2)
    main(["compress", str(wav), str(tmp_path / "c.fwav"), "--tile", "128",
          "--compact"])
    assert read_version(tmp_path / "c.fwav") == 2
    main(["decompress", str(tmp_path / "c.fwav"),
          "--out", str(tmp_path / "r.wav")])
    recon, _, _ = read_wav_mono(tmp_path / "r.wav")
    assert compute_snr(sig, recon) > 8.0
    # the non-compact default still writes v1
    main(["compress", str(wav), str(tmp_path / "d.fwav"), "--tile", "128"])
    assert read_version(tmp_path / "d.fwav") == 1


def test_o_saturation_edge_and_nonfinite_rejection(tmp_path):
    from fwav.io.compact import _o_exp_for

    # a peak whose scaled value rounds to the window edge 32768 saturates
    # to 32767 at exactly 1 ulp cost on that sample
    rec = np.zeros(2, MATCH_DTYPE)
    rec["idx"] = [0, 1]
    rec["s"] = 1.0
    rec["o"] = [32768.0, 100.0]
    bank = np.ones((2, 4), np.float32)
    p = tmp_path / "edge.fwav"
    save_compressed_compact(p, rec, bank, 4, 8000, 2, 1024, 1, 1e-4, 8)
    rec2, *_ = load_compressed_compact(p)
    assert abs(rec2["o"][0] - 32768.0) <= 1.0
    assert abs(rec2["o"][1] - 100.0) <= 0.5
    # non-finite offsets are rejected loudly, not silently quantized
    rec["o"] = [np.inf, 0.0]
    with pytest.raises(ValueError, match="non-finite"):
        save_compressed_compact(tmp_path / "bad.fwav", rec, bank, 4, 8000,
                                2, 1024, 1, 1e-4, 8)
    rec["o"] = [np.nan, 0.0]
    with pytest.raises(ValueError, match="non-finite"):
        save_compressed_compact(tmp_path / "bad.fwav", rec, bank, 4, 8000,
                                2, 1024, 1, 1e-4, 8)
    # window: peak lands in (16384, 32768]
    assert _o_exp_for(np.array([32768.0])) == 0
    assert _o_exp_for(np.array([32769.0])) == 1
    assert _o_exp_for(np.array([16384.0])) == -1


def test_legacy_fp16_o_files_still_decode(tmp_path):
    # files written before FLAG_O_INT16 carry fp16 o streams; the loader
    # must honor the clear flag instead of reinterpreting the bytes
    import hashlib
    import struct

    from fwav.io.compact import _EXT, _EXT_OFFSET, FLAG_O_INT16

    rec = np.zeros(4, MATCH_DTYPE)
    rec["idx"] = np.arange(4)
    rec["s"] = 1.0
    rec["o"] = [100.0, -250.0, 0.5, 12000.0]
    bank = np.ones((4, 4), np.float32)
    p = tmp_path / "new.fwav"
    save_compressed_compact(p, rec, bank, 4, 8000, 2, 1024, 1, 1e-4, 16)
    blob = bytearray(p.read_bytes())
    # forge a legacy file: clear FLAG_O_INT16, re-encode o as fp16 under a
    # legacy-window exponent, fix the checksum
    (idx_bits, bank_exp, o_exp, flags, n_live, raw_len) = _EXT.unpack(
        blob[_EXT_OFFSET : _EXT_OFFSET + _EXT.size]
    )
    assert flags & FLAG_O_INT16
    legacy_exp = 0
    o16 = rec["o"].astype(np.float16).tobytes()
    assert flags & 1 == 0 or True  # writer may or may not deflate; rebuild raw
    from fwav.io.compact import _pack_bits, _pack_mask

    live = rec["idx"] >= 0
    raw = (
        (bank * 2.0**-bank_exp).astype(np.float16).tobytes()
        + _pack_mask(live)
        + _pack_mask(rec["sym"][live] != 0)
        + _pack_bits(rec["idx"][live].astype(np.int64), idx_bits)
        + rec["s"][live].astype(np.float16).tobytes()
        + o16
    )
    ext = _EXT.pack(idx_bits, bank_exp, legacy_exp, 0, n_live, len(raw))
    sha = hashlib.sha256()
    sha.update(ext)
    sha.update(raw)
    legacy = bytes(blob[:34]) + sha.digest() + ext + raw
    q = tmp_path / "legacy.fwav"
    q.write_bytes(legacy)
    rec2, *_ = load_compressed_compact(q)
    np.testing.assert_allclose(rec2["o"], rec["o"], rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(rec2["idx"], rec["idx"])


def test_entropy_layout_selected_and_smaller(_encoded, tmp_path):
    """Real encoder output picks the round-4 FLAG_ENTROPY layout and beats
    the legacy (deflate) encoding; loaders keep routing by version."""
    sig, sr, rec, bank, (n_ranges, N, tile, step, thr, olen), p1, p2 = _encoded
    from fwav.io.compact import FLAG_ENTROPY, FLAG_O_INT16
    import fwav.io.compact as compact

    assert _flags_of(p2) == FLAG_ENTROPY | FLAG_O_INT16
    # the legacy encoding of the same inputs, for the size comparison
    import unittest.mock as mock

    with mock.patch.object(compact, "_entropy_variant", lambda *a, **k: None):
        p_old = tmp_path / "legacy.fwav"
        save_compressed_compact(p_old, rec, bank, N, sr, 2, tile, step, thr,
                                olen)
    assert p2.stat().st_size < p_old.stat().st_size


def test_entropy_quantization_cost_damped_profile(tmp_path):
    """Worst case for o/s quantization: a damped-profile encode whose
    stored-transform decode reaches high SNR — the distortion-bounded
    quantizer must keep the cost under 0.05 dB there too (small residuals
    shrink the budget automatically)."""
    sig, sr = _sig(seconds=1.0)
    rec, bank, n_ranges, N, tile, step, thr, olen = compress_audio_arrays(
        sig, sr, 2, tile_size=128, search="exact", objective="damped"
    )
    rec, bank = prune_bank(rec, bank)
    p = tmp_path / "damped.fwav"
    save_compressed_compact(p, rec, bank, N, sr, 2, tile, step, thr, olen)
    rec2, bank2, *_ = load_compressed_arrays(p)
    kw = dict(original_len=len(sig), s_damping=0.25, iterations=24,
              convergence_eps=0.0)
    snr0 = compute_snr(sig, decompress_audio(rec, bank, n_ranges, N, **kw))
    snr1 = compute_snr(sig, decompress_audio(rec2, bank2, n_ranges, N, **kw))
    assert snr0 > 20.0, snr0  # the fixture exercises a high-SNR decode
    assert snr0 - snr1 < 0.05, (snr0, snr1)


def test_entropy_unknown_flag_combo_rejected(_encoded, tmp_path):
    # ENTROPY combined with the legacy deflate bits is not a defined layout
    *_, p2 = _encoded
    from fwav.io.compact import _EXT_OFFSET, FLAG_DEFLATE

    raw = bytearray(p2.read_bytes())
    assert raw[_EXT_OFFSET + 3] & 8  # FLAG_ENTROPY set on this fixture
    raw[_EXT_OFFSET + 3] |= FLAG_DEFLATE
    bad = tmp_path / "combo.fwav"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        load_compressed_compact(bad, verify_checksum=False)


def test_entropy_corrupt_stream_rejected(_encoded, tmp_path):
    # with the SHA pass skipped, corrupt section lengths / zlib section /
    # idx stream must still raise the format ValueError, never garbage out
    *_, p2 = _encoded
    from fwav.io.compact import _EXT, _EXT_OFFSET

    raw = bytearray(p2.read_bytes())
    ext2_off = _EXT_OFFSET + _EXT.size
    for mutate in (
        lambda b: b.__setitem__(ext2_off + 4, b[ext2_off + 4] ^ 0x7F),  # z_len
        lambda b: b.__setitem__(ext2_off + 30, b[ext2_off + 30] ^ 0xFF),  # zsec
        lambda b: b.__setitem__(len(b) - 1, b[-1] ^ 0xFF),  # tail stream
    ):
        bad = bytearray(raw)
        mutate(bad)
        f = tmp_path / "corrupt.fwav"
        f.write_bytes(bytes(bad))
        with pytest.raises(ValueError):
            rec2, dom2, *_ = load_compressed_compact(f, verify_checksum=False)
            # a tail bit-flip may decode: it must then at least fail the
            # idx range check or produce a live-bitmap mismatch — if it
            # parsed cleanly, re-raise via the checksum path
            load_compressed_compact(f)


def test_whole_value_stream_round_trip(tmp_path):
    """A low-alphabet s stream selects so_enc bit0 (whole-value rANS) and
    round-trips exactly; the synthetic record's s values repeat heavily so
    the whole-value stream must beat the byte planes."""
    from fwav.io.compact import _EXT, _EXT_OFFSET, _EXT2, compact_bytes, parse_compact_bytes

    rng = np.random.default_rng(7)
    n = 4096
    rec = np.zeros(n, dtype=MATCH_DTYPE)
    rec["idx"] = rng.integers(0, 64, n)
    rec["s"] = rng.choice(np.float32([0.25, 0.5, 1.0, 1.5]), n)
    rec["o"] = rng.normal(0.0, 800.0, n).astype(np.float32)
    rec["sym"] = rng.integers(0, 2, n).astype(np.uint8)
    rec["err"] = np.float32(1.0)
    bank = rng.normal(0, 1000.0, (64, 4)).astype(np.float32)
    blob = compact_bytes(rec, bank, 4, 8000, 2, 1024, 1, 1e-4, 4 * n)
    so_enc = blob[_EXT_OFFSET + _EXT.size + 3]
    assert so_enc & 1, f"whole-value s coding not selected (so_enc={so_enc})"
    rec2, bank2, *_ = parse_compact_bytes(blob)
    np.testing.assert_array_equal(rec2["idx"], rec["idx"])
    np.testing.assert_array_equal(rec2["sym"] != 0, rec["sym"] != 0)
    # fixed point: re-encoding the decoded values must reproduce them exactly
    blob2 = compact_bytes(rec2, bank2, 4, 8000, 2, 1024, 1, 1e-4, 4 * n)
    rec3, *_ = parse_compact_bytes(blob2)
    np.testing.assert_array_equal(rec3["s"], rec2["s"])
    np.testing.assert_array_equal(rec3["o"], rec2["o"])


def test_whole_value_corrupt_alphabet_rejected(tmp_path):
    """Unknown so_enc bits and out-of-range alphabet sizes must raise the
    format ValueError, never decode garbage."""
    from fwav.io.compact import _EXT, _EXT_OFFSET, compact_bytes, parse_compact_bytes

    from fwav.io.compact import FLAG_ENTROPY

    rng = np.random.default_rng(8)
    n = 4096
    rec = np.zeros(n, dtype=MATCH_DTYPE)
    rec["idx"] = rng.integers(0, 64, n)
    rec["s"] = rng.choice(np.float32([0.25, 0.5, 1.0, 1.5]), n)
    rec["o"] = rng.normal(0.0, 800.0, n).astype(np.float32)
    rec["err"] = np.float32(1.0)
    bank = rng.normal(0, 1000.0, (64, 4)).astype(np.float32)
    blob = bytearray(compact_bytes(rec, bank, 4, 8000, 2, 1024, 1, 1e-4, 4 * n))
    assert blob[_EXT_OFFSET + 3] & FLAG_ENTROPY
    so_off = _EXT_OFFSET + _EXT.size + 3
    assert blob[so_off] & 1
    for bad in (0x04, 0xFF):  # undefined bits
        b = bytearray(blob)
        b[so_off] = bad
        with pytest.raises(ValueError):
            parse_compact_bytes(bytes(b), verify_checksum=False)
    # alphabet size of zero (s_lo_len field when bit0 set)
    b = bytearray(blob)
    b[so_off + 1 + 4 + 4 + 4 : so_off + 1 + 4 + 4 + 4 + 4] = (0).to_bytes(4, "little")
    with pytest.raises(ValueError):
        parse_compact_bytes(bytes(b), verify_checksum=False)


def test_whole_value_o_stream_round_trip():
    """so_enc bit1 (whole-value o coding) engages on repeated offsets and
    round-trips exactly."""
    from fwav.io.compact import _EXT, _EXT_OFFSET, FLAG_ENTROPY, compact_bytes, parse_compact_bytes

    rng = np.random.default_rng(11)
    n = 4096
    rec = np.zeros(n, dtype=MATCH_DTYPE)
    rec["idx"] = rng.integers(0, 64, n)
    rec["s"] = rng.uniform(-4, 4, n).astype(np.float32)
    rec["o"] = rng.choice(np.float32([-1200.0, -300.0, 0.0, 450.0, 900.0]), n)
    rec["err"] = np.float32(1.0)
    bank = rng.normal(0, 1000.0, (64, 4)).astype(np.float32)
    blob = compact_bytes(rec, bank, 4, 8000, 2, 1024, 1, 1e-4, 4 * n)
    assert blob[_EXT_OFFSET + 3] & FLAG_ENTROPY
    so_enc = blob[_EXT_OFFSET + _EXT.size + 3]
    assert so_enc & 2, f"whole-value o coding not selected (so_enc={so_enc})"
    rec2, bank2, *_ = parse_compact_bytes(blob)
    np.testing.assert_array_equal(rec2["idx"], rec["idx"])
    blob2 = compact_bytes(rec2, bank2, 4, 8000, 2, 1024, 1, 1e-4, 4 * n)
    rec3, *_ = parse_compact_bytes(blob2)
    np.testing.assert_array_equal(rec3["o"], rec2["o"])
    np.testing.assert_array_equal(rec3["s"], rec2["s"])


def test_cli_info_reports_v2_layout(_encoded, tmp_path, capsys):
    """`info` on a v2 file reports the header-level layout description
    (which keep-smallest encoding won + the entropy stage's choices)."""
    import json

    from fwav.cli import main
    from fwav.io.compact import describe_layout

    *_, p2 = _encoded
    assert main(["info", str(p2)]) == 0
    info = json.loads(capsys.readouterr().out)
    lay = info["v2_layout"]
    assert lay["layout"] in ("entropy", "deflate", "raw")
    if lay["layout"] == "entropy":
        assert lay["idx_coding"] in ("rans", "packed")
        assert lay["s_coding"] in ("whole_value", "byte_planes")
        assert lay["o_coding"] in ("whole_value", "byte_planes")
        assert 0 <= lay["o_shift"] <= 12
    # header-level: must also work on a payload-corrupt file
    raw = bytearray(p2.read_bytes())
    raw[-1] ^= 0xFF
    assert describe_layout(bytes(raw)) == lay
    # and not report on v1
    assert describe_layout(b"\x00" * 200) is None


# --- round-5 idx_enc=2 (rank-split rANS over wide idx alphabets) -----------

def _wide_idx_rec(seed=13, n=90_000, n_domains=50_000, spread=20_000):
    """Records whose live idx alphabet exceeds the dense rANS cap (2^12
    uniques) with a skewed distribution — the damped profile's shape."""
    rng = np.random.default_rng(seed)
    rec = np.zeros(n, dtype=MATCH_DTYPE)
    live = rng.random(n) > 0.05
    rec["idx"] = np.where(live, rng.zipf(1.25, n) % spread, -1)
    rec["s"] = np.where(live, rng.normal(0.4, 0.2, n), 1.0).astype(np.float32)
    rec["o"] = np.where(live, rng.normal(0, 300, n), 0.0).astype(np.float32)
    rec["err"] = np.where(live, np.abs(rng.normal(0, 10, n)), 0.0).astype(np.float32)
    bank = rng.normal(0, 500.0, (n_domains, 4)).astype(np.float32)
    return rec, bank


def test_rank_split_idx_selected_and_exact():
    """A wide skewed idx alphabet (here ~9.5k uniques > the 2^12 dense cap)
    must select idx_enc=2, shrink the file vs the packed fallback, and
    round-trip every record exactly."""
    from fwav.io import rans
    from fwav.io.compact import (
        _EXT, _EXT_OFFSET, compact_bytes, describe_layout, parse_compact_bytes,
    )

    rec, bank = _wide_idx_rec()
    live = rec["idx"] >= 0
    assert len(np.unique(rec["idx"][live])) > (1 << rans.PROB_BITS)
    blob = compact_bytes(rec, bank, 4, 44100, 2, 1024, 1, 1e-4, 4 * len(rec))
    assert blob[_EXT_OFFSET + _EXT.size + 2] == 2, "idx_enc=2 not selected"
    assert describe_layout(blob)["idx_coding"] == "rank_split"
    rec2, bank2, *_ = parse_compact_bytes(blob)
    np.testing.assert_array_equal(rec2["idx"], rec["idx"])
    # fixed point: re-encoding the decoded records reproduces them exactly
    blob2 = compact_bytes(rec2, bank2, 4, 44100, 2, 1024, 1, 1e-4, 4 * len(rec))
    rec3, *_ = parse_compact_bytes(blob2)
    np.testing.assert_array_equal(rec3["idx"], rec2["idx"])
    np.testing.assert_array_equal(rec3["s"], rec2["s"])
    np.testing.assert_array_equal(rec3["o"], rec2["o"])


def test_rank_split_single_unique_row():
    """> 2^16 domains with ONE referenced row: the rank-split layout stores
    no streams and no tables (both alphabets are 1), beating 17-bit packing
    outright, and decodes deterministically."""
    from fwav.io.compact import (
        _EXT, _EXT_OFFSET, compact_bytes, parse_compact_bytes,
    )

    rng = np.random.default_rng(5)
    n, n_domains = 20_000, 70_000
    rec = np.zeros(n, dtype=MATCH_DTYPE)
    rec["idx"] = 68_123
    rec["s"] = rng.normal(0.4, 0.2, n).astype(np.float32)
    rec["o"] = rng.normal(0, 300, n).astype(np.float32)
    rec["err"] = np.float32(1.0)
    bank = rng.normal(0, 500.0, (n_domains, 4)).astype(np.float32)
    blob = compact_bytes(rec, bank, 4, 44100, 2, 1024, 1, 1e-4, 4 * n)
    assert blob[_EXT_OFFSET + _EXT.size + 2] == 2
    rec2, *_ = parse_compact_bytes(blob)
    np.testing.assert_array_equal(rec2["idx"], rec["idx"])


def test_rank_split_hi_stream_mechanism(monkeypatch):
    """Exercise the hi-stream branch (idx_alpha > split) cheaply by
    shrinking the split to 2^8 for both writer and parser — the production
    16-bit split only engages it past 65536 uniques (hour-scale files).
    Validates the two-stream reassembly and the present-tables layout."""
    from fwav.io import compact as C

    monkeypatch.setattr(C, "_IDX_SPLIT_BITS", 8)
    rec, bank = _wide_idx_rec(seed=21)
    blob = C.compact_bytes(rec, bank, 4, 44100, 2, 1024, 1, 1e-4, 4 * len(rec))
    assert blob[C._EXT_OFFSET + C._EXT.size + 2] == 2
    # hi stream actually present (uniques >> 256)
    ext2_off = C._EXT_OFFSET + C._EXT.size
    idx_hi_len = int.from_bytes(blob[ext2_off + 28 : ext2_off + 32], "little")
    assert idx_hi_len > 0
    rec2, *_ = C.parse_compact_bytes(blob)
    np.testing.assert_array_equal(rec2["idx"], rec["idx"])


def test_rank_split_corrupt_fields_rejected():
    """Structural idx_enc=2 violations must raise the format ValueError:
    stray idx fields on other encodings, zero/oversized alphabets, and
    stream lengths inconsistent with the alphabet-1 rules."""
    from fwav.io.compact import (
        _EXT, _EXT_OFFSET, compact_bytes, parse_compact_bytes,
    )

    rec, bank = _wide_idx_rec(seed=17)
    blob = bytearray(
        compact_bytes(rec, bank, 4, 44100, 2, 1024, 1, 1e-4, 4 * len(rec))
    )
    ext2 = _EXT_OFFSET + _EXT.size
    assert blob[ext2 + 2] == 2

    def corrupt(off, value, width=4):
        b = bytearray(blob)
        b[off : off + width] = int(value).to_bytes(width, "little")
        with pytest.raises(ValueError):
            parse_compact_bytes(bytes(b), verify_checksum=False)

    corrupt(ext2 + 2, 3, width=1)            # unknown idx_enc
    corrupt(ext2 + 32, 0)                     # alphabet 0
    corrupt(ext2 + 32, 2**31)                 # alphabet beyond n_live
    corrupt(ext2 + 32, 1)                     # alphabet-1 but streams present
    # idx fields on a non-rank-split encoding
    b = bytearray(blob)
    b[ext2 + 2] = 0
    with pytest.raises(ValueError):
        parse_compact_bytes(bytes(b), verify_checksum=False)


def test_ext2_tail_only_on_rank_split():
    """Format pin: the ext2 struct stays 28 bytes and the _EXT2_RS tail
    appears EXACTLY when idx_enc == 2 — pre-round-5 v2 entropy files
    (idx_enc 0/1) keep their byte layout and must keep parsing."""
    import zlib

    from fwav.io.compact import (
        _EXT, _EXT2, _EXT2_RS, _EXT_OFFSET, FLAG_ENTROPY, compact_bytes,
        parse_compact_bytes,
    )

    assert _EXT2.size == 28 and _EXT2_RS.size == 8

    rng = np.random.default_rng(23)
    n = 4096
    rec = np.zeros(n, dtype=MATCH_DTYPE)
    rec["idx"] = rng.integers(0, 64, n)
    rec["s"] = rng.normal(0.4, 0.2, n).astype(np.float32)
    rec["o"] = rng.normal(0, 300, n).astype(np.float32)
    rec["err"] = np.float32(1.0)
    bank = rng.normal(0, 500.0, (64, 4)).astype(np.float32)
    blob = compact_bytes(rec, bank, 4, 8000, 2, 1024, 1, 1e-4, 4 * n)
    assert blob[_EXT_OFFSET + 3] & FLAG_ENTROPY
    ext2 = _EXT_OFFSET + _EXT.size
    assert blob[ext2 + 2] == 1  # dense idx coding: no tail
    z_len = int.from_bytes(blob[ext2 + 4 : ext2 + 8], "little")
    # the deflated section begins immediately after the 28-byte ext2
    zlib.decompress(blob[ext2 + 28 : ext2 + 28 + z_len])  # must not raise
    parse_compact_bytes(blob)

    rec2, bank2 = _wide_idx_rec(seed=29)
    blob2 = compact_bytes(rec2, bank2, 4, 44100, 2, 1024, 1, 1e-4, 4 * len(rec2))
    ext2 = _EXT_OFFSET + _EXT.size
    assert blob2[ext2 + 2] == 2  # rank-split: tail present, then zsec
    z_len = int.from_bytes(blob2[ext2 + 4 : ext2 + 8], "little")
    zlib.decompress(blob2[ext2 + 36 : ext2 + 36 + z_len])
