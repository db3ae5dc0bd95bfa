"""End-to-end round trips (the reference's golden test, test_e2e.py:13-38,
plus wider coverage: both search modes, speech-like content, file-level API,
silent input, short input)."""

import numpy as np
import pytest

from fwav import (
    compress_audio,
    compress_audio_arrays,
    compute_snr,
    decompress_audio,
    load_compressed,
    save_compressed,
)
from fwav.io.wav import read_wav_mono, write_wav
from fwav.models.codec import process_file_compress, process_file_decompress


def test_compress_decompress_e2e(tone, tmp_path):
    """The reference's e2e: tone -> encode -> .fwav -> decode -> SNR > 4 dB."""
    sig, sr, sampwidth = tone
    (matches, domains, n_ranges, range_size, tile_size, domain_step,
     energy_thresh, orig_len) = compress_audio(
        sig, sr, sampwidth, tile_size=128, energy_thresh=1e-4,
        use_gpu=False, domains_tmpdir=str(tmp_path), fast_mode=True,
    )
    assert len(matches) == n_ranges
    assert domains.shape[1] == range_size

    fwav = tmp_path / "test_e2e.fwav"
    save_compressed(str(fwav), matches, domains, range_size, sr, sampwidth,
                    tile_size, domain_step, energy_thresh, len(sig))
    (matches2, domains2, n_ranges2, range_size2, fr2, sw2, tile2,
     domain_step2, energy2, orig_len2) = load_compressed(str(fwav))
    assert (n_ranges2, range_size2, fr2, sw2) == (n_ranges, range_size, sr, sampwidth)

    recon = decompress_audio(matches2, domains2, n_ranges2, range_size2,
                             iterations=8, convergence_eps=1e-3,
                             use_gpu=False, original_len=orig_len2)
    assert len(recon) == len(sig)
    snr = compute_snr(sig, np.asarray(recon))
    assert snr > 4.0, snr


@pytest.mark.parametrize("search", ["exact", "topk"])
def test_round_trip_both_search_modes(speechlike, search):
    """The reference (CPU, defaults) measures 11.457 dB on this exact signal
    (SURVEY.md §6 methodology; rerun via /tmp-stubbed fractal.py). Our
    default balanced objective reaches the piecewise-constant decode bound
    (11.742 dB) in both search modes — strictly above reference parity."""
    sig, sr, sw = speechlike
    rec, domains, n_ranges, range_size, *rest = compress_audio_arrays(
        sig, sr, sw, tile_size=1024, search=search
    )
    recon = decompress_audio(rec, domains, n_ranges, range_size,
                             original_len=len(sig))
    snr = compute_snr(sig, recon)
    assert snr > 11.457, (search, snr)  # reference parity bar


def test_exact_match_error_dominates_topk(speechlike):
    """Exact search must find affine fits at least as good as the top-32
    embedding shortlist, range by range (it searches a superset) — up to
    float32 score resolution: selection compares gains = r_e - err^2 in
    float32, so err^2 is only resolved to ~eps32 * r_e."""
    sig, sr, sw = speechlike
    errs = {}
    for search in ("exact", "topk"):
        rec, domains, n_ranges, range_size, *_ = compress_audio_arrays(
            sig, sr, sw, tile_size=1024, search=search, objective="affine"
        )
        errs[search] = rec
    live = (errs["exact"]["idx"] >= 0) & (errs["topk"]["idx"] >= 0)
    ex = errs["exact"]["err"][live].astype(np.float64)
    tk = errs["topk"]["err"][live].astype(np.float64)
    # per-range centered energy bound for the score-resolution slack
    from fwav.ops.vad import voiced_detection

    w = sig * voiced_detection(sig, frame_size=2 * range_size,
                               energy_threshold=1e-4)
    L = n_ranges * range_size
    w = np.pad(w, (0, L - len(w)), mode="reflect")
    R = w.reshape(-1, range_size).astype(np.float64)
    r_e = ((R - R.mean(1, keepdims=True)) ** 2).sum(1)[live]
    # score = num^2/denom carries a few ulps from the dot product, squaring
    # and the weight multiply; 32 eps covers the worst observed case with
    # margin while still catching real selection bugs (which show up as
    # O(r_e) violations, not O(eps * r_e)).
    slack = 32.0 * np.finfo(np.float32).eps * r_e
    assert np.all(ex**2 <= tk**2 + slack + 1e-6), (
        "exact worse than topk beyond f32 score resolution",
        float((ex**2 - tk**2 - slack).max()),
    )
    # and in aggregate it must be strictly better (it searches 15k domains
    # vs a 32-candidate shortlist)
    assert ex.mean() < tk.mean()


def test_silent_ranges_get_sentinels(speechlike):
    sig, sr, sw = speechlike
    rec, domains, n_ranges, range_size, *_ = compress_audio_arrays(sig, sr, sw)
    # the carved silence gaps must produce -1 sentinel matches
    assert np.any(rec["idx"] == -1)
    sent = rec[rec["idx"] == -1]
    assert np.all(sent["s"] == 1.0)
    assert np.all(sent["o"] == 0.0)
    assert np.all(sent["sym"] == 0)
    assert np.all(sent["err"] == 0.0)
    # and voiced ranges real matches
    assert np.any(rec["idx"] >= 0)
    assert np.all(rec["idx"] < len(domains))


def test_all_silent_input_early_return():
    sig = np.zeros(8000, dtype=np.float32)
    matches, domains, n_ranges, range_size, tile, step, thr, olen = compress_audio(
        sig, 8000, 2
    )
    assert matches == [] and n_ranges == 0
    assert domains.shape == (0, range_size)
    assert olen == 8000
    recon = decompress_audio(matches, domains, n_ranges, range_size, original_len=olen)
    assert len(recon) == 8000 and np.all(recon == 0)


def test_input_shorter_than_tile():
    rng = np.random.default_rng(0)
    sig = (rng.standard_normal(500) * 10000).astype(np.float32)
    matches, domains, n_ranges, *_ = compress_audio(sig, 8000, 2, tile_size=1024)
    assert matches == [] and n_ranges == 0


def test_decoder_handles_legacy_inf_err_encoding(tone):
    """The reference live pipeline stored silent ranges as
    (domain 0, s~0, o~0, 0, inf) instead of -1 sentinels; the decoder must
    accept both (SURVEY.md §2.4.2)."""
    sig, sr, sw = tone
    rec, domains, n_ranges, range_size, *_ = compress_audio_arrays(
        sig, sr, sw, tile_size=128
    )
    legacy = rec.copy()
    silent = legacy["idx"] == -1
    legacy["idx"][silent] = 0
    legacy["s"][silent] = 0.0
    legacy["o"][silent] = 0.0
    legacy["err"][silent] = np.inf
    r1 = decompress_audio(rec, domains, n_ranges, range_size, original_len=len(sig))
    r2 = decompress_audio(legacy, domains, n_ranges, range_size, original_len=len(sig))
    # both decode; silent ranges reconstruct near-zero either way
    assert compute_snr(sig, r1) > 4.0
    assert compute_snr(sig, r2) > 4.0


def test_file_level_round_trip_all_widths(tmp_path, tone):
    sig, sr, _ = tone
    for sw, scale in ((1, 1 / 256.0), (2, 1.0), (3, 256.0), (4, 1 / 32768.0)):
        wav = tmp_path / f"in_{sw}.wav"
        write_wav(wav, sig * scale, sr, sw)
        m = process_file_compress(str(wav), str(tmp_path / f"out{sw}"), tile=128)
        assert "error" not in m, m
        d = process_file_decompress(m["output"], str(tmp_path / f"rec{sw}"))
        assert "error" not in d, d
        out, fr, sw2 = read_wav_mono(d["output"])
        assert sw2 == sw and fr == sr
        ref, _, _ = read_wav_mono(wav)
        assert compute_snr(ref, out) > 3.0, (sw, compute_snr(ref, out))


def test_matches_accept_list_dict_and_recarray(tone):
    sig, sr, sw = tone
    matches, domains, n_ranges, range_size, *_ = compress_audio(sig, sr, sw, tile_size=128)
    as_list = decompress_audio(matches, domains, n_ranges, range_size, original_len=len(sig))
    from fwav.io.container import matches_to_struct

    rec = matches_to_struct(matches)
    as_rec = decompress_audio(rec, domains, n_ranges, range_size, original_len=len(sig))
    as_dict = decompress_audio(
        {k: rec[k] for k in ("idx", "s", "o", "sym", "err")},
        domains, n_ranges, range_size, original_len=len(sig),
    )
    np.testing.assert_array_equal(as_list, as_rec)
    np.testing.assert_array_equal(as_list, as_dict)


def test_encode_is_deterministic(tone, tmp_path):
    """The fused single-program design removes the reference's process/queue
    race surface (SURVEY.md §5): two encodes of the same input must produce
    byte-identical .fwav files."""
    from fwav.io.container import save_compressed

    sig, sr, sw = tone
    paths = []
    for k in range(2):
        rec, dom, n, rs, tile, step, thr, olen = compress_audio_arrays(
            sig, sr, sw, tile_size=128
        )
        p = tmp_path / f"det{k}.fwav"
        save_compressed(p, rec, dom, rs, sr, sw, tile, step, thr, olen)
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_multichannel_file_round_trip(tmp_path, tone):
    """BASELINE config 2: stereo input folds to mono and round-trips at the
    original sample width."""
    import wave

    sig, sr, _ = tone
    left = sig.astype(np.int16)
    right = (sig * 0.25).astype(np.int16)
    inter = np.empty(2 * len(sig), dtype=np.int16)
    inter[0::2] = left
    inter[1::2] = right
    p = tmp_path / "stereo.wav"
    with wave.open(str(p), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(inter.tobytes())

    m = process_file_compress(str(p), str(tmp_path / "o"), tile=128)
    assert "error" not in m, m
    d = process_file_decompress(m["output"], str(tmp_path / "r"))
    out, fr, sw = read_wav_mono(d["output"])
    assert (fr, sw) == (sr, 2)
    mono = (left.astype(np.float64) + right) / 2.0
    assert compute_snr(mono, out) > 4.0


def test_fast_mode_off_no_sentinels(speechlike):
    """fast_mode=False disables the energy prune: every range gets a real
    match even in the carved-out silence (fractal.py:602 semantics)."""
    sig, sr, sw = speechlike
    rec, domains, n_ranges, rs, *_ = compress_audio_arrays(
        sig, sr, sw, fast_mode=False
    )
    assert np.all(rec["idx"] >= 0)
    recon = decompress_audio(rec, domains, n_ranges, rs, original_len=len(sig))
    assert compute_snr(sig, recon) > 11.0


@pytest.mark.parametrize("tile", [512, 2048, 4096])
def test_round_trip_other_tile_sizes(tone, tile):
    """Non-default tiles exercise range_size 4/8/16 shape paths."""
    sig, sr, sw = tone
    sig = np.tile(sig, 8)  # long enough for a 4096 tile
    rec, domains, n_ranges, rs, tile_out, step, *_ = compress_audio_arrays(
        sig, sr, sw, tile_size=tile
    )
    assert tile_out == tile
    assert rs == max(4, tile // 256)
    assert domains.shape[1] == rs
    recon = decompress_audio(rec, domains, n_ranges, rs, original_len=len(sig))
    # the shipped decoder's quality ceiling is the piecewise-constant mean
    # (docs/ARCHITECTURE.md §4) and it drops with range_size on a pure tone;
    # assert we are within 0.5 dB of the bound rather than a fixed floor
    L = (len(sig) // rs) * rs
    bound = compute_snr(
        sig[:L], np.repeat(sig[:L].reshape(-1, rs).mean(1), rs)
    )
    got = compute_snr(sig, recon)
    assert got > bound - 0.5, (tile, got, bound)


def test_signal_exactly_one_tile():
    rng = np.random.default_rng(1)
    sig = (rng.standard_normal(1024) * 10000).astype(np.float32)
    rec, domains, n_ranges, rs, *_ = compress_audio_arrays(sig, 8000, 2, tile_size=1024)
    assert len(domains) == 1  # exactly one sliding window
    recon = decompress_audio(rec, domains, n_ranges, rs, original_len=len(sig))
    assert recon.shape == (1024,)


def test_all_sentinel_file_round_trip(tmp_path):
    """A file whose every match is the -1 sentinel (nonzero n_ranges, zero
    usable domains) must decode to silence of the right length."""
    from fwav.io.container import MATCH_DTYPE

    rec = np.zeros(10, dtype=MATCH_DTYPE)
    rec["idx"] = -1
    rec["s"] = 1.0
    domains = np.zeros((0, 4), np.float32)
    p = tmp_path / "sent.fwav"
    save_compressed(p, rec, domains, 4, 8000, 2, 128, 1, 1e-4, 37)
    m2, d2, n2, rs2, fr2, sw2, *_rest, olen2 = load_compressed(p)
    out = decompress_audio(m2, d2, n2, rs2, original_len=olen2)
    assert out.shape == (37,)
    assert np.all(out == 0)


def test_file_level_all_silent(tmp_path):
    sig = np.zeros(9000, dtype=np.float32)
    wav = tmp_path / "quiet.wav"
    write_wav(wav, sig, 8000, 2)
    m = process_file_compress(str(wav), str(tmp_path / "o"))
    assert "error" not in m, m
    d = process_file_decompress(m["output"], str(tmp_path / "r"))
    assert "error" not in d, d
    out, _, _ = read_wav_mono(d["output"])
    assert len(out) == 9000 and np.all(out == 0)


@pytest.mark.parametrize("emb_dim", [8, 16, 32])
def test_topk_emb_dim_variants(tone, emb_dim):
    """The embedding-shortlist family works across emb_dim (reference
    default 16 = 8 tonal + 8 transient; fractal.py:1050)."""
    sig, sr, sw = tone
    rec, domains, n_ranges, rs, *_ = compress_audio_arrays(
        sig, sr, sw, tile_size=128, search="topk", emb_dim=emb_dim
    )
    recon = decompress_audio(rec, domains, n_ranges, rs, original_len=len(sig))
    assert compute_snr(sig, recon) > 4.0


def test_fast_mode_tail_refit_matches_weighted_semantics():
    # reflect-padded tail: the reflected samples can source from a
    # DIFFERENT, unvoiced (zeroed-on-device) frame. fast_mode must refit
    # the tail against the device's weighted signal, not raw — compare the
    # tail record against fast_mode=False, whose refit is weighted by
    # construction. ns = 2049 (pad_len=3): tail range holds 1 raw + 3
    # reflected samples reaching back into a 6-frame quiet stretch.
    import numpy as np

    from fwav.models.encode import compress_audio_arrays

    rng = np.random.default_rng(17)
    ns = 2049
    sig = 0.1 * np.sin(2 * np.pi * 440 * np.arange(ns) / 8000)
    sig += 0.002 * rng.standard_normal(ns)
    sig[2000:2048] = 0.005 * rng.standard_normal(48)  # quiet: VAD off
    sig[2048] = 0.25  # loud tail sample keeps the final frame voiced
    sig = sig.astype(np.float32)

    fast = compress_audio_arrays(sig, 8000, 4, tile_size=128, fast_mode=True)
    slow = compress_audio_arrays(sig, 8000, 4, tile_size=128, fast_mode=False)
    rec_f, rec_s = fast[0], slow[0]
    assert rec_f["idx"][-1] >= 0, "tail range must be live for this test"
    # the tail's reflected sources must actually be zeroed by VAD in the
    # weighted view (otherwise the fixture does not cover the bug)
    for field in ("idx", "sym", "s", "o", "err"):
        np.testing.assert_array_equal(
            rec_f[field][-1:], rec_s[field][-1:],
            err_msg=f"tail record field {field}",
        )


def test_auto_never_resolves_to_topk():
    """search='auto' picks only the exact-family modes ('exact'/'coarse');
    'topk' is the reference-shaped compatibility mode and must be an
    explicit opt-in (VERDICT r2 item 8) — asserted across bank sizes
    spanning both sides of every auto threshold."""
    from fwav.config import EncoderConfig
    from fwav.models.encode import _resolve_search

    for tile in (128, 1024, 4096):
        cfg = EncoderConfig(tile_size=tile, search="auto")
        for db in (256, 4096, 32768, 1 << 20, 1 << 23):
            mode, _ = _resolve_search(cfg, cfg.range_size, db)
            assert mode in ("exact", "coarse"), (tile, db, mode)
