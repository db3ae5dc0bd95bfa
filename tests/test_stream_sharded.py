"""Streaming x multi-chip composition (SURVEY.md §2.5 SP/CP + DP/TP): the
time-sharded encode dispatching every shard through shard_map over a
(dp, tp) mesh must produce records BIT-EQUAL to the single-device streaming
encode — the idx-only device->host protocol + host refit make selections the
only device output, and per-shard searches see identical bucketed shapes.

Runs on the virtual 8-device CPU mesh (tests/conftest.py).
"""

import numpy as np
import pytest

from fwav.models.stream import compress_audio_streaming
from fwav.parallel.mesh import make_mesh


def _noise_sig(seconds=1.5, sr=8000, seed=3):
    # noise-bearing content: no mirror ties, so selections are unambiguous
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    sig = 0.4 * np.sin(2 * np.pi * 310 * t) + 0.12 * np.sin(2 * np.pi * 1100 * t)
    sig += 0.02 * rng.standard_normal(len(t))
    sig[int(0.6 * sr) : int(0.72 * sr)] = 0.0  # silence gap -> sentinels
    return np.round(sig * 12000).astype(np.float32), sr


KW = dict(tile_size=128, shard_samples=4096, halo=2048)


@pytest.fixture(scope="module")
def _single_device_stream():
    sig, sr = _noise_sig()
    rec, *rest = compress_audio_streaming(sig, sr, 2, **KW)
    return sig, sr, rec, rest


@pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_streaming_sharded_bit_equal(dp, tp, _single_device_stream):
    sig, sr, want, rest = _single_device_stream
    mesh = make_mesh(dp * tp, dp=dp, tp=tp)
    got, *rest_s = compress_audio_streaming(
        sig, sr, 2, mesh=mesh, search="exact" if tp > 1 else "auto", **KW
    )
    if tp == 1:
        np.testing.assert_array_equal(got, want)
    else:
        # tp forces exact search; the auto mode on these shapes is exact
        # too, so records still match bit for bit
        np.testing.assert_array_equal(got, want)
    assert rest_s[:3] == rest[:3]
    assert np.any(got["idx"] == -1)  # sentinels survive the composition


def test_streaming_sharded_coarse_bit_equal(_single_device_stream):
    # coarse + tp under streaming: the tp axis range-splits each time
    # shard's slab (encode._range_split_factor pads the range bucket)
    sig, sr = _noise_sig(seconds=4.0, seed=9)
    kw = dict(tile_size=512, shard_samples=16384, halo=8192, search="coarse")
    want, *_ = compress_audio_streaming(sig, sr, 2, **kw)
    mesh = make_mesh(4, dp=2, tp=2)
    got, *_ = compress_audio_streaming(sig, sr, 2, mesh=mesh, **kw)
    np.testing.assert_array_equal(got, want)


def test_tie_heavy_content_flips_are_exact_ties_and_decode_equal():
    """The bit-equality contract's measured carve-out (round 4): on
    near-periodic content at large block_len, tiles tie EXACTLY in the
    selection gain, and XLA's shape-dependent codegen may break the tie
    differently between the mesh path's padded range bucket and the
    unpadded single-device bucket. The guarantees that must survive:
    (1) mesh configs sharing padded buckets stay mutually bit-equal,
    (2) every flipped selection is an exact f64 selection-score tie,
    (3) decode output matches within 1 PCM LSB."""
    from fwav import decompress_audio
    from fwav.models.stream import domain_block_iter
    from fwav.ops.domains import bank_rows_host
    from fwav.ops.vad import voiced_detection

    rng = np.random.default_rng(7)
    n = 6188
    t = np.arange(n) / 8000
    sig = 0.4 * np.sin(2 * np.pi * 451.8 * t)
    sig += 0.15 * np.sin(2 * np.pi * (800 + 400 * np.sin(2 * np.pi * 0.3 * t)) * t)
    sig += 0.02 * rng.standard_normal(n)
    sig[2000 : 2000 + n // 8] = 0.0
    sig = np.round(sig * 12000).astype(np.float32)
    kw = dict(tile_size=512, shard_samples=8192, halo=4096,
              search="coarse", objective="affine")
    single = compress_audio_streaming(sig, 8000, 2, **kw)
    rec1, _, n_ranges, rs, tile, step, thr, olen = single
    mesh_recs = [
        compress_audio_streaming(
            sig, 8000, 2, mesh=make_mesh(dp * tp, dp=dp, tp=tp), **kw
        )[0]
        for dp, tp in ((2, 1), (4, 2))
    ]
    np.testing.assert_array_equal(mesh_recs[0], mesh_recs[1])  # (1)

    recm = mesh_recs[0]
    d = (recm["idx"] != rec1["idx"]) & (rec1["idx"] >= 0)
    if d.any():  # (2): flips only on exact selection-score ties
        voiced = voiced_detection(sig, frame_size=2 * rs,
                                  energy_threshold=thr)
        w = sig * voiced
        pad = (rs - (len(sig) % rs)) % rs
        if pad:
            w = np.pad(w, (0, pad), mode="reflect")
        ranges = w.reshape(-1, rs).astype(np.float64)

        def sel_gain(rows, idxs):
            tl = bank_rows_host(
                sig, tile, rs, step, rows.astype(np.int64)
            ).astype(np.float64)
            r = ranges[idxs]
            rc = r - r.mean(1, keepdims=True)
            tc = tl - tl.mean(1, keepdims=True)
            den = (tc * tc).sum(1) + 1e-300
            num = np.maximum(np.abs((rc * tc).sum(1)),
                             np.abs((rc[:, ::-1] * tc).sum(1)))
            return num * num / den

        ii = np.nonzero(d)[0]
        g1 = sel_gain(rec1["idx"][ii], ii)
        g2 = sel_gain(recm["idx"][ii], ii)
        rel = np.abs(g1 - g2) / np.maximum(g1, 1e-12)
        assert rel.max() < 1e-12, rel.max()

    bank = np.concatenate(list(domain_block_iter(sig, tile, rs, step)))
    o1 = decompress_audio(rec1, bank, n_ranges, rs, original_len=olen)
    o2 = decompress_audio(recm, bank, n_ranges, rs, original_len=olen)
    assert np.abs(o1 - o2).max() <= 1.0  # (3): <= 1 PCM LSB at 16-bit scale


def test_streaming_file_level_with_devices(tmp_path, monkeypatch):
    # process_file_compress composes streaming with --devices/--tp
    import fwav.models.codec as codec
    from fwav import compute_snr
    from fwav.io.wav import read_wav_mono, write_wav
    from fwav.models.codec import (
        process_file_compress,
        process_file_decompress,
    )

    monkeypatch.setattr(codec, "STREAMING_THRESHOLD", 8000)
    sig, sr = _noise_sig()
    wav = tmp_path / "in.wav"
    write_wav(wav, sig, sr, 2)
    r = process_file_compress(
        str(wav), str(tmp_path / "out.fwav"), tile=128, devices=4, tp=2,
        search="exact", shard_samples=4096, halo=2048,
    )
    assert "error" not in r, r
    r2 = process_file_decompress(r["output"], str(tmp_path / "rec.wav"))
    assert "error" not in r2, r2
    recon, _, _ = read_wav_mono(r2["output"])
    assert compute_snr(sig, recon) > 8.0


def test_streaming_sharded_topk_bit_equal(_single_device_stream):
    """topk + tp under streaming: every time shard's per-shard MIPS
    shortlists merge into the exact global top-k (same core as the
    single-shot path), bit-equal to single-device streaming topk."""
    sig, sr, _, _ = _single_device_stream
    kw = dict(search="topk", **KW)
    want, *_ = compress_audio_streaming(sig, sr, 2, **kw)
    mesh = make_mesh(8, dp=2, tp=4)
    got, *_ = compress_audio_streaming(sig, sr, 2, mesh=mesh, **kw)
    np.testing.assert_array_equal(got, want)
