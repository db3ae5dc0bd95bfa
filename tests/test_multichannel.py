"""Multichannel support (beyond the reference, which can only fold to mono
— fractal.py:81-113): channel-preserving WAV I/O (io/wav.py read_wav /
2-D write_wav), the v3 multichannel container (io/multich.py — per-channel
v2 compact blobs under an 8-byte outer header), the mid/side transform,
and the keep/ms CLI + file-API paths. Per-channel decode semantics stay
reference-exact; only WHAT gets encoded per channel changes."""

import json
import os

import numpy as np
import pytest

from fwav.cli import main as cli_main
from fwav.io.multich import (
    TRANSFORM_DIRECT,
    TRANSFORM_MS,
    load_compressed_multi,
    ms_forward,
    ms_inverse,
    save_compressed_multi,
)
from fwav.io.wav import read_wav, read_wav_mono, write_wav
from fwav.models.codec import process_file_compress, process_file_decompress
from fwav.utils.metrics import compute_snr


def _stereo(seconds=1.2, sr=16000, seed=0, corr=True):
    """Deterministic stereo content: correlated tones with a distinct image
    per channel and a shared silence gap (gap -> -1 sentinels per channel)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    base = 0.4 * np.sin(2 * np.pi * 330 * t) + 0.15 * np.sin(2 * np.pi * 990 * t)
    if corr:
        left = base + 0.05 * np.sin(2 * np.pi * 550 * t)
        right = base - 0.05 * np.sin(2 * np.pi * 550 * t)
    else:
        left = base
        right = 0.3 * np.sin(2 * np.pi * 770 * t)
    ch = np.stack([left, right], axis=1)
    ch += 0.01 * rng.standard_normal(ch.shape)
    ch[int(0.5 * sr): int(0.62 * sr)] = 0.0
    return np.round(ch * 16000).astype(np.float32), sr


# ---------------------------------------------------------------- WAV I/O

@pytest.mark.parametrize("sampwidth", [1, 2, 3, 4])
@pytest.mark.parametrize("nch", [2, 3])
def test_wav_multichannel_round_trip(tmp_path, sampwidth, nch):
    rng = np.random.default_rng(7)
    n = 400
    if sampwidth == 1:
        data = rng.integers(-128, 128, (n, nch)).astype(np.float32)
    elif sampwidth == 2:
        data = rng.integers(-32768, 32768, (n, nch)).astype(np.float32)
    elif sampwidth == 3:
        data = rng.integers(-(2**23), 2**23, (n, nch)).astype(np.float32)
    else:
        data = rng.uniform(-1, 1, (n, nch)).astype(np.float32)
    p = tmp_path / "mc.wav"
    write_wav(p, data, 8000, sampwidth)
    got, sr, sw = read_wav(p)
    assert (sr, sw) == (8000, sampwidth)
    assert got.shape == (n, nch)
    np.testing.assert_array_equal(got, data)


def test_read_wav_matches_mono_fold(tmp_path):
    ch, sr = _stereo()
    p = tmp_path / "st.wav"
    write_wav(p, ch, sr, 2)
    full, _, _ = read_wav(p)
    mono, _, _ = read_wav_mono(p)
    # the mono fold averages the integer-sourced values in float64 before
    # the float32 cast; the per-channel read must agree to float32 rounding
    np.testing.assert_allclose(full.mean(axis=1), mono, atol=1e-3)
    # mono files: read_wav returns the identical samples as (n, 1)
    write_wav(tmp_path / "m.wav", ch[:, 0], sr, 2)
    one, _, _ = read_wav(tmp_path / "m.wav")
    assert one.shape == (len(ch), 1)
    np.testing.assert_array_equal(one[:, 0], ch[:, 0])


def test_write_wav_mono_unchanged(tmp_path):
    # 1-D data still writes a 1-channel file byte-identically to before
    sig = np.round(1000 * np.sin(np.arange(500) * 0.1)).astype(np.float32)
    write_wav(tmp_path / "a.wav", sig, 16000, 2)
    got, sr, sw = read_wav_mono(tmp_path / "a.wav")
    np.testing.assert_array_equal(got, sig)


# ---------------------------------------------------------------- mid/side

def test_ms_transform_inverse_exact():
    ch, _ = _stereo()
    ms = ms_forward(ch)
    back = ms_inverse(ms)
    # int16-valued content halves exactly in float32, so the round trip is
    # bit-exact (not just close) on PCM-sourced data
    np.testing.assert_array_equal(back, ch)
    with pytest.raises(ValueError):
        ms_forward(ch[:, :1])


# ------------------------------------------------------------ v3 container

def _encode_channels(ch, sr, **kw):
    from fwav.models.encode import compress_audio_arrays, prune_bank

    out = []
    for c in range(ch.shape[1]):
        rec, bank, _n, N, tile, step, thr, olen = compress_audio_arrays(
            np.ascontiguousarray(ch[:, c]), sr, 2, **kw
        )
        rec, bank = prune_bank(rec, bank)
        out.append((rec, bank, N, sr, 2, tile, step, thr, olen))
    return out


def test_v3_container_round_trip(tmp_path):
    ch, sr = _stereo()
    tuples = _encode_channels(ch, sr)
    p = tmp_path / "mc.fwav"
    save_compressed_multi(p, tuples, transform=TRANSFORM_DIRECT)
    channels, transform = load_compressed_multi(p)
    assert transform == TRANSFORM_DIRECT
    assert len(channels) == 2
    for (rec, bank, *_), (rec2, bank2, _n, N2, sr2, sw2, *_rest) in zip(
        tuples, channels
    ):
        np.testing.assert_array_equal(rec["idx"], rec2["idx"])
        np.testing.assert_array_equal(rec["sym"], rec2["sym"])
        assert (sr2, sw2) == (sr, 2)
        # bank/s/o are fp16/int16 quantized exactly like a v2 file
        np.testing.assert_allclose(bank2, bank, rtol=2e-3, atol=0)


def test_v3_rejected_by_mono_loaders(tmp_path):
    from fwav.io.compact import load_compressed_compact
    from fwav.io.container import (
        load_compressed_arrays,
        read_matches,
        read_version,
    )

    ch, sr = _stereo()
    p = tmp_path / "mc.fwav"
    save_compressed_multi(p, _encode_channels(ch, sr))
    assert read_version(p) == 3
    with pytest.raises(ValueError, match="[Mm]ultichannel"):
        load_compressed_arrays(p)
    with pytest.raises(ValueError, match="[Mm]ultichannel"):
        read_matches(p)
    with pytest.raises(ValueError, match="version"):
        load_compressed_compact(p)


def test_v3_loader_rejects_non_v3(tmp_path):
    ch, sr = _stereo()
    t = _encode_channels(ch[:, :1], sr)[0]
    from fwav.io.compact import save_compressed_compact

    p2 = tmp_path / "v2.fwav"
    save_compressed_compact(p2, *t)
    with pytest.raises(ValueError, match="version"):
        load_compressed_multi(p2)
    with pytest.raises(ValueError, match="Not a FWAV"):
        load_compressed_multi(__file__)


def test_v3_corruption_detected(tmp_path):
    ch, sr = _stereo()
    p = tmp_path / "mc.fwav"
    save_compressed_multi(p, _encode_channels(ch, sr))
    blob = bytearray(open(p, "rb").read())

    # truncation inside a channel blob
    open(tmp_path / "t.fwav", "wb").write(bytes(blob[:-7]))
    with pytest.raises(ValueError):
        load_compressed_multi(tmp_path / "t.fwav")

    # bit flip inside a channel payload -> that blob's SHA-256 catches it
    flip = bytearray(blob)
    flip[-20] ^= 0x40
    open(tmp_path / "f.fwav", "wb").write(bytes(flip))
    with pytest.raises(ValueError):
        load_compressed_multi(tmp_path / "f.fwav")

    # unknown transform / nonzero reserved byte fail loudly
    for off, val in ((6, 9), (7, 1)):
        bad = bytearray(blob)
        bad[off] = val
        open(tmp_path / "b.fwav", "wb").write(bytes(bad))
        with pytest.raises(ValueError, match="Unknown"):
            load_compressed_multi(tmp_path / "b.fwav")

    # trailing garbage after the last blob is structural corruption
    open(tmp_path / "g.fwav", "wb").write(bytes(blob) + b"xx")
    with pytest.raises(ValueError, match="[Cc]orrupt"):
        load_compressed_multi(tmp_path / "g.fwav")


def test_save_multi_validates(tmp_path):
    ch, sr = _stereo()
    tuples = _encode_channels(ch, sr)
    with pytest.raises(ValueError, match="mid/side"):
        save_compressed_multi(tmp_path / "x.fwav", tuples[:1],
                              transform=TRANSFORM_MS)
    with pytest.raises(ValueError, match="transform"):
        save_compressed_multi(tmp_path / "x.fwav", tuples, transform=7)
    with pytest.raises(ValueError, match="channel count"):
        save_compressed_multi(tmp_path / "x.fwav", [])


# ------------------------------------------------------------- file API

def test_file_api_keep_round_trip(tmp_path):
    ch, sr = _stereo()
    wav = tmp_path / "st.wav"
    write_wav(wav, ch, sr, 2)
    out = process_file_compress(str(wav), str(tmp_path / "st.fwav"),
                                channels="keep")
    assert "error" not in out, out
    assert out["channels"] == 2
    dec = process_file_decompress(str(tmp_path / "st.fwav"),
                                  str(tmp_path / "st_recon.wav"))
    assert "error" not in dec, dec
    assert dec["channels"] == 2
    recon, sr2, sw = read_wav(tmp_path / "st_recon.wav")
    assert (sr2, sw) == (sr, 2)
    assert recon.shape == ch.shape
    for c in range(2):
        assert compute_snr(ch[:, c], recon[:, c]) > 4.0
    # the shared silence gap decodes to exact zeros in every channel
    gap = recon[int(0.52 * sr): int(0.60 * sr)]
    assert np.abs(gap).max() == 0.0


def test_file_api_ms_round_trip(tmp_path):
    ch, sr = _stereo(corr=True)
    wav = tmp_path / "st.wav"
    write_wav(wav, ch, sr, 2)
    out = process_file_compress(str(wav), str(tmp_path / "ms.fwav"),
                                channels="ms")
    assert "error" not in out, out
    _, transform = load_compressed_multi(tmp_path / "ms.fwav")
    assert transform == TRANSFORM_MS
    dec = process_file_decompress(str(tmp_path / "ms.fwav"),
                                  str(tmp_path / "ms_recon.wav"))
    assert "error" not in dec, dec
    recon, _, _ = read_wav(tmp_path / "ms_recon.wav")
    for c in range(2):
        assert compute_snr(ch[:, c], recon[:, c]) > 4.0


def test_file_api_ms_requires_stereo(tmp_path):
    rng = np.random.default_rng(3)
    tri = np.round(
        8000 * rng.uniform(-1, 1, (16000, 3))
    ).astype(np.float32)
    wav = tmp_path / "tri.wav"
    write_wav(wav, tri, 16000, 2)
    out = process_file_compress(str(wav), str(tmp_path / "tri.fwav"),
                                channels="ms")
    assert "error" in out and "stereo" in out["error"]


def test_file_api_keep_on_mono_degrades_to_mono_container(tmp_path):
    ch, sr = _stereo()
    wav = tmp_path / "m.wav"
    write_wav(wav, ch[:, 0], sr, 2)
    out = process_file_compress(str(wav), str(tmp_path / "m.fwav"),
                                channels="keep")
    assert "error" not in out, out
    from fwav.io.container import read_version

    assert read_version(tmp_path / "m.fwav") == 1
    dec = process_file_decompress(str(tmp_path / "m.fwav"),
                                  str(tmp_path / "m_recon.wav"))
    assert "error" not in dec, dec


def test_keep_matches_per_channel_mono_encode(tmp_path):
    """Selections in a v3 container equal encoding each channel alone —
    channel packing must not change results (same contract as --packed)."""
    ch, sr = _stereo(seed=5)
    wav = tmp_path / "st.wav"
    write_wav(wav, ch, sr, 2)
    process_file_compress(str(wav), str(tmp_path / "st.fwav"),
                          channels="keep")
    channels, _ = load_compressed_multi(tmp_path / "st.fwav")
    # re-read through the SAME ingest path the multi encoder used
    full, _, _ = read_wav(wav)
    solo = _encode_channels(full, sr)
    for (rec_m, *_), (rec_s, *_rest) in zip(channels, solo):
        np.testing.assert_array_equal(rec_m["idx"], rec_s["idx"])
        np.testing.assert_array_equal(rec_m["sym"], rec_s["sym"])


def test_segment_decode_multichannel(tmp_path):
    ch, sr = _stereo()
    wav = tmp_path / "st.wav"
    write_wav(wav, ch, sr, 2)
    process_file_compress(str(wav), str(tmp_path / "st.fwav"),
                          channels="keep")
    process_file_decompress(str(tmp_path / "st.fwav"),
                            str(tmp_path / "full.wav"))
    seg = process_file_decompress(str(tmp_path / "st.fwav"),
                                  str(tmp_path / "seg.wav"),
                                  start_s=0.25, duration_s=0.5)
    assert "error" not in seg, seg
    full, _, _ = read_wav(tmp_path / "full.wav")
    segd, _, _ = read_wav(tmp_path / "seg.wav")
    a = int(round(0.25 * sr))
    np.testing.assert_array_equal(segd, full[a: a + len(segd)])
    assert len(segd) == int(round(0.5 * sr))


# ------------------------------------------------------------------- CLI

def test_cli_keep_round_trip_and_info(tmp_path, capsys):
    ch, sr = _stereo()
    wav = tmp_path / "st.wav"
    write_wav(wav, ch, sr, 2)
    fwav = tmp_path / "st.fwav"
    assert cli_main(["compress", str(wav), str(fwav),
                     "--channels", "keep"]) == 0
    assert cli_main(["decompress", str(fwav),
                     "--out", str(tmp_path / "recon.wav")]) == 0
    recon, _, _ = read_wav(tmp_path / "recon.wav")
    assert recon.shape == ch.shape

    capsys.readouterr()
    assert cli_main(["info", str(fwav), "--verify"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["version"] == 3
    assert info["n_channels"] == 2
    assert info["channel_transform"] == "direct"
    assert info["checksum"] == "verified"
    assert len(info["silent_sentinel_ranges"]) == 2
    assert all(s > 0 for s in info["silent_sentinel_ranges"])
    lays = info["v2_layout_per_channel"]
    assert len(lays) == 2
    assert all(l["layout"] in ("entropy", "deflate", "raw") for l in lays)

    # per-channel + overall SNR report on matching channel counts
    assert cli_main(["snr", str(wav), str(tmp_path / "recon.wav")]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["channels"] == 2
    assert len(rep["snr_db_per_channel"]) == 2
    assert rep["snr_db"] > 4.0


def test_cli_info_verify_catches_v3_corruption(tmp_path, capsys):
    ch, sr = _stereo()
    wav = tmp_path / "st.wav"
    write_wav(wav, ch, sr, 2)
    fwav = tmp_path / "st.fwav"
    assert cli_main(["compress", str(wav), str(fwav),
                     "--channels", "ms"]) == 0
    blob = bytearray(open(fwav, "rb").read())
    blob[-11] ^= 0x08
    open(fwav, "wb").write(bytes(blob))
    capsys.readouterr()
    assert cli_main(["info", str(fwav), "--verify"]) == 1
    rep = json.loads(capsys.readouterr().out)
    assert rep["checksum"].startswith("FAILED")


def test_cli_flag_validation(tmp_path):
    ch, sr = _stereo()
    wav = tmp_path / "st.wav"
    write_wav(wav, ch, sr, 2)
    for extra in (["--full-bank"], ["--resume-dir", str(tmp_path / "r")]):
        with pytest.raises(SystemExit):
            cli_main(["compress", str(wav), str(tmp_path / "x.fwav"),
                      "--channels", "keep", *extra])
    with pytest.raises(SystemExit):
        cli_main(["compress", str(tmp_path), "--batch", "--packed",
                  "--channels", "keep", "--out", str(tmp_path / "o")])


def test_cli_snr_folds_on_channel_mismatch(tmp_path, capsys):
    ch, sr = _stereo()
    write_wav(tmp_path / "st.wav", ch, sr, 2)
    write_wav(tmp_path / "m.wav", ch.mean(axis=1), sr, 2)
    capsys.readouterr()
    assert cli_main(["snr", str(tmp_path / "st.wav"),
                     str(tmp_path / "m.wav")]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["compared"] == "mono_fold"
    assert rep["snr_db"] > 30.0  # folds are near-identical (write rounding)


# ------------------------------------------------------------- rate: m/s

def test_ms_wins_on_near_identical_channels(tmp_path):
    """The mechanism ms exists for: when the channels nearly coincide the
    side channel falls under the silence gate, its ranges store as -1
    sentinels, and the file shrinks vs keep. (On decorrelated content ms
    can LOSE rate — it is opt-in, not auto; the CLI help says so.)"""
    ch, sr = _stereo(corr=True)
    ch[:, 1] = ch[:, 0]
    burst = slice(int(0.8 * sr), int(0.9 * sr))
    ch[burst, 1] = np.round(
        ch[burst, 0] + 3000 * np.sin(np.arange(burst.stop - burst.start) * 0.3)
    )
    wav = tmp_path / "st.wav"
    write_wav(wav, ch, sr, 2)
    process_file_compress(str(wav), str(tmp_path / "keep.fwav"),
                          channels="keep")
    process_file_compress(str(wav), str(tmp_path / "ms.fwav"),
                          channels="ms")
    keep_b = os.path.getsize(tmp_path / "keep.fwav")
    ms_b = os.path.getsize(tmp_path / "ms.fwav")
    assert ms_b < keep_b
    # and the image still reconstructs: both channels, including the burst
    process_file_decompress(str(tmp_path / "ms.fwav"),
                            str(tmp_path / "ms_recon.wav"))
    recon, _, _ = read_wav(tmp_path / "ms_recon.wav")
    for c in range(2):
        assert compute_snr(ch[:, c], recon[:, c]) > 4.0


# ------------------------------------------------- composition coverage

def test_keep_composes_with_mesh(tmp_path):
    """Stereo keep under a (dp, tp) mesh encodes each channel through
    compress_audio_sharded — records bit-equal to the single-device path
    (same contract as the mono sharded encode)."""
    ch, sr = _stereo(seed=11)
    wav = tmp_path / "st.wav"
    write_wav(wav, ch, sr, 2)
    out1 = process_file_compress(str(wav), str(tmp_path / "d1.fwav"),
                                 channels="keep")
    out8 = process_file_compress(str(wav), str(tmp_path / "d8.fwav"),
                                 channels="keep", devices=8, tp=2)
    assert "error" not in out1 and "error" not in out8, (out1, out8)
    a, ta = load_compressed_multi(tmp_path / "d1.fwav")
    b, tb = load_compressed_multi(tmp_path / "d8.fwav")
    assert ta == tb
    for ca, cb in zip(a, b):
        np.testing.assert_array_equal(ca[0]["idx"], cb[0]["idx"])
        np.testing.assert_array_equal(ca[0]["sym"], cb[0]["sym"])
        np.testing.assert_array_equal(ca[0]["s"], cb[0]["s"])
        np.testing.assert_array_equal(ca[0]["o"], cb[0]["o"])


def test_keep_composes_with_damped_profile(tmp_path):
    """channels=keep + objective='damped' + decompress --damping: the
    quality profile applies per channel exactly as in mono."""
    ch, sr = _stereo(seed=2)
    wav = tmp_path / "st.wav"
    write_wav(wav, ch, sr, 2)
    out = process_file_compress(str(wav), str(tmp_path / "d.fwav"),
                                channels="keep", objective="damped")
    assert "error" not in out, out
    base = process_file_compress(str(wav), str(tmp_path / "b.fwav"),
                                 channels="keep")
    assert "error" not in base, base
    dec = process_file_decompress(str(tmp_path / "d.fwav"),
                                  str(tmp_path / "d_recon.wav"),
                                  s_damping=0.25)
    assert "error" not in dec, dec
    dec0 = process_file_decompress(str(tmp_path / "b.fwav"),
                                   str(tmp_path / "b_recon.wav"))
    assert "error" not in dec0, dec0
    damped, _, _ = read_wav(tmp_path / "d_recon.wav")
    plain, _, _ = read_wav(tmp_path / "b_recon.wav")
    for c in range(2):
        snr_damped = compute_snr(ch[:, c], damped[:, c])
        snr_plain = compute_snr(ch[:, c], plain[:, c])
        assert snr_damped > snr_plain + 10.0, (c, snr_damped, snr_plain)


def test_keep_streaming_path_matches_single_shot(tmp_path, monkeypatch):
    """Long multichannel files stream per channel (_streamed_pruned);
    the records must match the single-shot packed encode exactly."""
    from fwav.models import codec

    ch, sr = _stereo(seed=4)
    wav = tmp_path / "st.wav"
    write_wav(wav, ch, sr, 2)
    out1 = process_file_compress(str(wav), str(tmp_path / "one.fwav"),
                                 channels="keep")
    monkeypatch.setattr(codec, "STREAMING_THRESHOLD", 8000)
    out2 = process_file_compress(str(wav), str(tmp_path / "str.fwav"),
                                 channels="keep")
    assert "error" not in out1 and "error" not in out2, (out1, out2)
    a, _ = load_compressed_multi(tmp_path / "one.fwav")
    b, _ = load_compressed_multi(tmp_path / "str.fwav")
    for ca, cb in zip(a, b):
        np.testing.assert_array_equal(ca[0]["idx"], cb[0]["idx"])
        np.testing.assert_array_equal(ca[0]["sym"], cb[0]["sym"])
        np.testing.assert_array_equal(ca[0]["s"], cb[0]["s"])
        np.testing.assert_array_equal(ca[0]["o"], cb[0]["o"])


def test_cli_batch_composes_with_channels_keep(tmp_path, capsys):
    """--batch x --channels keep: a mixed directory (stereo + mono) encodes
    per file through the thread pool, stereo lands in a v3 container, mono
    degrades to its mono container (batch naming convention: base.wav.fwav,
    same as the mono batch path), and batch decompress restores each file's
    channel shape. The metrics JSON records every file."""
    ch, sr = _stereo()
    write_wav(tmp_path / "st.wav", ch, sr, 2)
    write_wav(tmp_path / "mono.wav", ch[:, 0], sr, 2)
    outdir = tmp_path / "out"
    assert cli_main(["compress", str(tmp_path), "--batch", "--workers", "2",
                     "--channels", "keep", "--out", str(outdir)]) == 0
    from fwav.io.container import read_version

    assert read_version(outdir / "st.wav.fwav") == 3
    assert read_version(outdir / "mono.wav.fwav") != 3
    metrics = json.loads((outdir / "compression_metrics.json").read_text())
    by_input = {os.path.basename(m["input"]): m for m in metrics}
    assert by_input["st.wav"]["channels"] == 2
    assert "error" not in by_input["mono.wav"]

    recdir = tmp_path / "rec"
    assert cli_main(["decompress", str(outdir), "--batch",
                     "--out", str(recdir)]) == 0
    st, _, _ = read_wav(recdir / "st.wav_recon.wav")
    mono, _, _ = read_wav(recdir / "mono.wav_recon.wav")
    assert st.shape == ch.shape
    assert mono.shape == (len(ch), 1)
