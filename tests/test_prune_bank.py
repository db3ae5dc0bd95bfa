"""Bank pruning: much smaller .fwav, bit-identical decode, cross-decoder
validity (the reference's decoder only gathers rows by index, so a pruned
file is an ordinary .fwav to it)."""

import os

import numpy as np
import pytest

from fwav import compress_audio_arrays, compute_snr, decompress_audio
from fwav.io.wav import read_wav_mono, write_wav
from fwav.models.codec import process_file_compress, process_file_decompress
from fwav.models.encode import prune_bank


def test_prune_bank_decodes_identically(speechlike):
    sig, sr, sw = speechlike
    rec, bank, n_ranges, rs, *_ = compress_audio_arrays(sig, sr, sw)
    rec_p, bank_p = prune_bank(rec, bank)
    assert len(bank_p) < len(bank) // 2
    assert np.all(rec_p["idx"] < len(bank_p))
    # sentinel rows untouched
    np.testing.assert_array_equal(rec_p["idx"] < 0, rec["idx"] < 0)
    full = decompress_audio(rec, bank, n_ranges, rs, original_len=len(sig))
    pruned = decompress_audio(rec_p, bank_p, n_ranges, rs, original_len=len(sig))
    np.testing.assert_array_equal(full, pruned)


def test_prune_bank_file_level_ratio(tmp_path, tone):
    sig, sr, _ = tone
    wav = tmp_path / "t.wav"
    write_wav(wav, sig, sr, 2)
    m_full = process_file_compress(str(wav), str(tmp_path / "full"), tile=128)
    m_pruned = process_file_compress(str(wav), str(tmp_path / "pruned"),
                                     tile=128, prune_bank=True)
    assert "error" not in m_pruned, m_pruned
    full_sz = os.path.getsize(m_full["output"])
    pruned_sz = os.path.getsize(m_pruned["output"])
    assert pruned_sz < full_sz / 1.5
    d = process_file_decompress(m_pruned["output"], str(tmp_path / "rec"))
    out, _, _ = read_wav_mono(d["output"])
    full_rec, _, _ = read_wav_mono(
        process_file_decompress(m_full["output"], str(tmp_path / "recf"))["output"]
    )
    np.testing.assert_array_equal(out, full_rec)
    assert compute_snr(sig, out) > 4.0


def test_pruned_file_decodes_with_reference(tmp_path, tone):
    ref_path = "/root/reference/fractal.py"
    if not os.path.exists(ref_path):
        pytest.skip("reference checkout not available")
    import sys
    import types

    if "librosa" not in sys.modules:
        stub = types.ModuleType("librosa")

        class _F:
            @staticmethod
            def mel(sr=22050, n_fft=2048, n_mels=128, fmin=0.0, fmax=None, **kw):
                return np.zeros((n_mels, 1 + n_fft // 2), dtype=np.float32)

        stub.filters = _F()
        sys.modules["librosa"] = stub
    sys.path.insert(0, "/root/reference")
    try:
        import fractal

        sig, sr, _ = tone
        wav = tmp_path / "t.wav"
        write_wav(wav, sig, sr, 2)
        m = process_file_compress(str(wav), str(tmp_path / "p"), tile=128,
                                  prune_bank=True)
        (m2, d2, n2, rs2, fr2, sw2, *_rest, olen2) = fractal.load_compressed(
            m["output"]
        )
        recon = np.asarray(
            fractal.decompress_audio(m2, d2, n2, rs2, original_len=olen2,
                                     use_gpu=False)
        )
        assert compute_snr(sig, recon) > 4.0
    finally:
        sys.path.remove("/root/reference")


def test_streaming_prune_bank(tmp_path, monkeypatch):
    import fwav.models.codec as codec

    monkeypatch.setattr(codec, "STREAMING_THRESHOLD", 8000)
    rng = np.random.default_rng(0)
    sr = 8000
    t = np.arange(int(sr * 2.0)) / sr
    sig = (0.4 * np.sin(2 * np.pi * 330 * t) * 12000).astype(np.float32)
    wav = tmp_path / "long.wav"
    write_wav(wav, sig, sr, 2)
    m = codec.process_file_compress(str(wav), str(tmp_path / "o"), tile=128,
                                    prune_bank=True)
    assert "error" not in m, m
    d = codec.process_file_decompress(m["output"], str(tmp_path / "r"))
    out, _, _ = read_wav_mono(d["output"])
    assert compute_snr(sig, out) > 8.0
