"""Long-file streaming encode (models.stream) + streaming container writer."""

import numpy as np

from fwav import compute_snr, decompress_audio, load_compressed_arrays
from fwav.io.container import save_compressed, save_compressed_streaming
from fwav.models.encode import compress_audio_arrays
from fwav.models.stream import compress_audio_streaming, domain_block_iter
from fwav.ops.domains import build_domains_host, build_domains_np, n_domains_for


def _sig(seconds=2.0, sr=8000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    sig = 0.4 * np.sin(2 * np.pi * 300 * t) + 0.1 * np.sin(2 * np.pi * 1200 * t)
    sig += 0.005 * rng.standard_normal(len(t))
    sig[int(0.8 * sr) : int(0.95 * sr)] = 0.0
    return (sig * 12000).astype(np.float32), sr


def test_domain_block_iter_matches_reference_builder():
    sig, sr = _sig(0.5)
    tile, N, step = 128, 4, 1
    want = build_domains_np(sig, tile, N, step)
    got = np.concatenate(list(domain_block_iter(sig, tile, N, step, block_rows=777)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    # and the one-shot host builder agrees
    np.testing.assert_allclose(build_domains_host(sig, tile, N, step), want, atol=1e-4)


def test_streaming_writer_bytes_equal_plain_writer(tmp_path):
    sig, sr = _sig(0.4)
    rec, domains, n_ranges, N, tile, step, thr, olen = compress_audio_arrays(
        sig, sr, 2, tile_size=128
    )
    p1 = tmp_path / "a.fwav"
    p2 = tmp_path / "b.fwav"
    save_compressed(p1, rec, domains, N, sr, 2, tile, step, thr, olen)
    save_compressed_streaming(
        p2, rec, domain_block_iter(sig, tile, N, step, block_rows=100),
        len(domains), N, sr, 2, tile, step, thr, olen,
    )
    a, b = p1.read_bytes(), p2.read_bytes()
    # identical except for float32 rounding inside the bank payload: compare
    # structure by parsing both
    ra, da, *ha = load_compressed_arrays(p1)
    rb, dbk, *hb = load_compressed_arrays(p2)
    assert ha == hb
    np.testing.assert_array_equal(ra, rb)
    np.testing.assert_allclose(da, dbk, atol=1e-4)


def test_streaming_encode_round_trip_matches_whole_file():
    sig, sr = _sig(2.0)
    tile = 128

    rec_w, domains, n_ranges, N, *_ = compress_audio_arrays(sig, sr, 2, tile_size=tile)
    whole = decompress_audio(rec_w, domains, n_ranges, N, original_len=len(sig))

    rec_s, none_bank, n_ranges_s, N_s, tile_s, step_s, thr_s, olen_s = (
        compress_audio_streaming(
            sig, sr, 2, tile_size=tile, shard_samples=4096, halo=2048
        )
    )
    assert none_bank is None
    assert (n_ranges_s, N_s) == (n_ranges, N)
    bank = np.concatenate(list(domain_block_iter(sig, tile, N, step_s)))
    assert np.all(rec_s["idx"] < len(bank))
    streamed = decompress_audio(rec_s, bank, n_ranges_s, N_s, original_len=len(sig))

    snr_whole = compute_snr(sig, whole)
    snr_streamed = compute_snr(sig, streamed)
    # halo-restricted search must not cost meaningful quality
    assert snr_streamed > snr_whole - 0.3, (snr_streamed, snr_whole)
    # silence sentinels survive sharding
    assert np.any(rec_s["idx"] == -1)


def test_streaming_file_level(tmp_path, monkeypatch):
    """process_file_compress auto-streams above the threshold and the result
    decodes through the normal file path."""
    import fwav.models.codec as codec
    from fwav.io.wav import read_wav_mono, write_wav

    monkeypatch.setattr(codec, "STREAMING_THRESHOLD", 8000)  # force streaming
    sig, sr = _sig(2.0)
    wav = tmp_path / "long.wav"
    write_wav(wav, sig, sr, 2)
    m = codec.process_file_compress(str(wav), str(tmp_path / "out"), tile=128)
    assert "error" not in m, m
    d = codec.process_file_decompress(m["output"], str(tmp_path / "rec"))
    assert "error" not in d, d
    out, _, _ = read_wav_mono(d["output"])
    assert compute_snr(sig, out) > 8.0


def test_streaming_shard_resume(tmp_path):
    """resume_dir checkpoints each shard; a rerun skips completed shards and
    produces identical matches."""
    import fwav.models.stream as S

    sig, sr = _sig(2.0)
    ck = tmp_path / "ck"
    rec1, *_ = compress_audio_streaming(
        sig, sr, 2, tile_size=128, shard_samples=4096, halo=2048,
        resume_dir=str(ck),
    )
    files = sorted(ck.rglob("shard_*.npy"))
    assert len(files) >= 2

    # delete the LAST checkpoint and rerun: only that shard recomputes;
    # earlier shards must be served from disk (count core dispatches to
    # prove it — the streaming loop fetches one compiled core per shard)
    files[-1].unlink()
    n_calls = 0
    orig = S._encode_core

    def counting(*a, **k):
        nonlocal n_calls
        n_calls += 1
        return orig(*a, **k)

    S._encode_core = counting
    try:
        rec2, *_ = compress_audio_streaming(
            sig, sr, 2, tile_size=128, shard_samples=4096, halo=2048,
            resume_dir=str(ck),
        )
    finally:
        S._encode_core = orig
    assert n_calls == 1  # only the missing shard ran
    np.testing.assert_array_equal(rec1, rec2)


def test_shared_resume_dir_isolates_inputs_and_params(tmp_path):
    """One resume_dir shared by different inputs (same length, same shard
    grid — the --batch hazard from ADVICE r2) and by different encoder
    settings must never cross-serve checkpoints: each encode resumes only
    its own shards and its records match a checkpoint-free encode."""
    ck = tmp_path / "shared"
    sig_a, sr = _sig(2.0, seed=3)
    sig_b, _ = _sig(2.0, seed=4)  # identical length => identical shard grid
    kw = dict(tile_size=128, shard_samples=4096, halo=2048)

    rec_a, *_ = compress_audio_streaming(sig_a, sr, 2, resume_dir=str(ck), **kw)
    rec_b, *_ = compress_audio_streaming(sig_b, sr, 2, resume_dir=str(ck), **kw)
    rec_b_fresh, *_ = compress_audio_streaming(sig_b, sr, 2, **kw)
    np.testing.assert_array_equal(rec_b, rec_b_fresh)
    assert not np.array_equal(rec_a, rec_b)

    # same input, changed record-affecting setting: separate namespace too
    rec_a2, *_ = compress_audio_streaming(
        sig_a, sr, 2, resume_dir=str(ck), tile_size=128,
        shard_samples=4096, halo=2048, objective="affine",
    )
    rec_a2_fresh, *_ = compress_audio_streaming(
        sig_a, sr, 2, tile_size=128, shard_samples=4096, halo=2048,
        objective="affine",
    )
    np.testing.assert_array_equal(rec_a2, rec_a2_fresh)
    # three distinct (input, params) namespaces materialized
    assert len({p.parent for p in ck.rglob("shard_*.npy")}) == 3


def test_short_encodes_interleave_with_streaming(monkeypatch):
    """DEVICE_LOCK is held per dispatch/collect pair, not per file: short
    encodes submitted while a long streaming encode is in flight complete
    before it finishes instead of starving behind it (VERDICT r1 item 6)."""
    import threading
    import time

    sr = 8000
    long_sig, _ = _sig(60.0, sr, seed=1)
    short_sig, _ = _sig(0.3, sr, seed=2)

    # warm the compile caches so the interleaving test measures lock
    # behavior, not compilation
    compress_audio_streaming(long_sig[: 1 << 17], sr, 2, shard_samples=1 << 15,
                             halo=1 << 13)
    compress_audio_arrays(short_sig, sr, 2)

    order = []
    def long_job():
        compress_audio_streaming(long_sig, sr, 2, shard_samples=1 << 15,
                                 halo=1 << 13)
        order.append("long")

    t = threading.Thread(target=long_job)
    t.start()
    time.sleep(0.2)  # let the long encode get shards in flight
    long_was_running = t.is_alive()
    for i in range(3):
        compress_audio_arrays(short_sig, sr, 2)
        order.append(f"short{i}")
    shorts_done_while_long_running = t.is_alive()
    t.join()

    assert long_was_running, "fixture too small to exercise interleaving"
    assert shorts_done_while_long_running, (
        "short encodes should finish while the long streaming encode is "
        f"still in flight; completion order: {order}"
    )


def test_streaming_uses_one_compiled_program_for_all_shards():
    """Round-4 compile-count guarantee: the first shard (no left halo) and
    the tail shard (short) must reuse the middle shards' bucket so a cold
    long-file encode pays exactly ONE encode-core compile."""
    from fwav.models.encode import _encode_core

    sig, sr = _sig(3.1)  # 3.1 s at 8 kHz -> 4 shards at 1<<13, short tail
    _encode_core.cache_clear()
    rec, _, n_ranges, N, tile, step, thr, olen = compress_audio_streaming(
        sig, sr, 2, shard_samples=1 << 13, halo=1 << 11
    )
    info = _encode_core.cache_info()
    assert info.currsize == 1, info
    assert len(rec) == n_ranges
    # and the records still decode sanely
    bank = np.concatenate(list(domain_block_iter(sig, tile, N, step)))
    out = decompress_audio(rec, bank, n_ranges, N, original_len=olen)
    assert compute_snr(sig, out) > 4.0
