"""WAV round-trips for all four sample widths + multichannel fold
(reference behavior: fractal.py:81-137; SURVEY.md §2.4.10)."""

import wave

import numpy as np

from fwav.io.wav import read_wav_mono, write_wav


def _write_raw(path, raw, nchan, sampwidth, framerate):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(nchan)
        w.setsampwidth(sampwidth)
        w.setframerate(framerate)
        w.writeframes(raw)


def test_round_trip_16bit(tmp_path):
    sig = (np.sin(np.linspace(0, 20, 1000)) * 12000).astype(np.int16)
    p = tmp_path / "a.wav"
    write_wav(p, sig.astype(np.float32), 8000, 2)
    out, fr, sw = read_wav_mono(p)
    assert fr == 8000 and sw == 2
    np.testing.assert_array_equal(out, sig.astype(np.float32))


def test_round_trip_8bit(tmp_path):
    # 8-bit is unsigned on disk, centered (u8 - 128) in memory
    sig = np.array([-128, -1, 0, 1, 127], dtype=np.float32)
    p = tmp_path / "b.wav"
    write_wav(p, sig, 8000, 1)
    out, fr, sw = read_wav_mono(p)
    assert sw == 1
    np.testing.assert_array_equal(out, sig)


def test_round_trip_24bit(tmp_path):
    vals = np.array([-(2**23), -1, 0, 1, 2**23 - 1, 123456, -654321], dtype=np.float32)
    p = tmp_path / "c.wav"
    write_wav(p, vals, 44100, 3)
    out, fr, sw = read_wav_mono(p)
    assert sw == 3 and fr == 44100
    np.testing.assert_array_equal(out, vals)


def test_round_trip_float32(tmp_path):
    sig = np.linspace(-1, 1, 777).astype(np.float32)
    p = tmp_path / "d.wav"
    write_wav(p, sig, 48000, 4)
    out, fr, sw = read_wav_mono(p)
    assert sw == 4
    np.testing.assert_allclose(out, sig, rtol=0, atol=0)


def test_multichannel_mean_fold(tmp_path):
    left = np.array([100, 200, -300], dtype=np.int16)
    right = np.array([300, -200, 100], dtype=np.int16)
    inter = np.empty(6, dtype=np.int16)
    inter[0::2] = left
    inter[1::2] = right
    p = tmp_path / "st.wav"
    _write_raw(p, inter.tobytes(), nchan=2, sampwidth=2, framerate=16000)
    out, fr, sw = read_wav_mono(p)
    np.testing.assert_allclose(out, (left.astype(np.float64) + right) / 2.0)


def test_24bit_sign_extension_exact_bytes(tmp_path):
    # -1 is 0xFFFFFF little-endian; 1 is 0x000001
    raw = bytes([0xFF, 0xFF, 0xFF, 0x01, 0x00, 0x00, 0x00, 0x00, 0x80])
    p = tmp_path / "s24.wav"
    _write_raw(p, raw, nchan=1, sampwidth=3, framerate=8000)
    out, _, _ = read_wav_mono(p)
    np.testing.assert_array_equal(out, np.array([-1, 1, -(2**23)], dtype=np.float32))


def test_write_clipping_16bit(tmp_path):
    sig = np.array([40000.0, -40000.0], dtype=np.float32)
    p = tmp_path / "clip.wav"
    write_wav(p, sig, 8000, 2)
    out, _, _ = read_wav_mono(p)
    np.testing.assert_array_equal(out, np.array([32767, -32768], dtype=np.float32))
