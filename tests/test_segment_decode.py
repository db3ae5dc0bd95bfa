"""Random-access segment decode (models.decode.decompress_segment; CLI
`decompress --start --duration`).

Fractal reconstruction is per-range independent (non-overlapping ranges,
fractal.py:1112), so decoding only the ranges covering a window must be
BIT-IDENTICAL to slicing the full decode for the default s_damping=0
closed form, at any alignment. This capability does not exist in the
reference (whole-file decoder only, fractal.py:1378-1473).
"""

import numpy as np
import pytest

from fwav import (
    compress_audio_arrays,
    decompress_audio,
    decompress_segment,
)
from fwav.models.encode import prune_bank


def _sig(seconds=1.3, sr=16000, seed=2):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    sig = 0.4 * np.sin(2 * np.pi * 330 * t) + 0.1 * np.sin(2 * np.pi * 990 * t)
    sig += 0.01 * rng.standard_normal(len(t))
    sig[int(0.4 * sr) : int(0.55 * sr)] = 0.0  # sentinel region
    return np.round(sig * 16000).astype(np.float32), sr


@pytest.fixture(scope="module")
def _enc():
    sig, sr = _sig()
    rec, bank, n_ranges, N, *_rest, olen = compress_audio_arrays(
        sig, sr, 2, tile_size=128
    )
    rec, bank = prune_bank(rec, bank)
    full = decompress_audio(rec, bank, n_ranges, N, original_len=olen)
    return sig, sr, rec, bank, n_ranges, N, olen, full


@pytest.mark.parametrize(
    "a,b",
    [
        (0, 4096),           # aligned head
        (4097, 9337),        # unaligned both ends, crosses the silence gap
        (3, 5),              # sub-range window
        (20000, 10**9),      # tail, end clamped to the file
        (-5, 100),           # negative start clamps to 0
    ],
)
def test_segment_bit_equals_sliced_full_decode(_enc, a, b):
    sig, sr, rec, bank, n_ranges, N, olen, full = _enc
    seg = decompress_segment(rec, bank, n_ranges, N, a, b, original_len=olen)
    lo, hi = max(0, a), min(b, olen)
    np.testing.assert_array_equal(seg, full[lo:hi])


def test_segment_empty_windows(_enc):
    _, _, rec, bank, n_ranges, N, olen, _ = _enc
    assert decompress_segment(rec, bank, n_ranges, N, 100, 100).size == 0
    assert decompress_segment(rec, bank, n_ranges, N, 500, 100).size == 0
    assert (
        decompress_segment(rec, bank, n_ranges, N, olen + 5, olen + 9,
                           original_len=olen).size == 0
    )


def test_segment_damped_mode(_enc):
    # the device while_loop path: same fixed point per range; assert close
    # (early-break counts may differ) and sentinel region exactly zero
    sig, sr, rec, bank, n_ranges, N, olen, _ = _enc
    a, b = int(0.35 * sr), int(0.6 * sr)
    full = decompress_audio(
        rec, bank, n_ranges, N, original_len=olen, s_damping=0.5
    )
    seg = decompress_segment(
        rec, bank, n_ranges, N, a, b, original_len=olen, s_damping=0.5
    )
    np.testing.assert_allclose(seg, full[a:b], rtol=1e-5, atol=1e-3)
    gap = slice(int(0.42 * sr) - a, int(0.53 * sr) - a)
    assert np.all(seg[gap] == 0.0)


def test_cli_start_duration(tmp_path, _enc):
    from fwav.cli import main as cli_main
    from fwav.io.container import save_compressed
    from fwav.io.wav import read_wav_mono

    sig, sr, rec, bank, n_ranges, N, olen, full = _enc
    p = tmp_path / "x.fwav"
    save_compressed(p, rec, bank, N, sr, 2, 128, 1, 1e-4, olen)
    out = tmp_path / "seg.wav"
    cli_main(["decompress", str(p), "--out", str(out),
              "--start", "0.25", "--duration", "0.5"])
    from fwav.io.wav import write_wav

    got, sr2, _ = read_wav_mono(out)
    assert sr2 == sr
    a = int(round(0.25 * sr))
    ref = tmp_path / "want.wav"
    write_wav(ref, full[a : a + int(round(0.5 * sr))], sr, 2)
    want, _, _ = read_wav_mono(ref)
    np.testing.assert_array_equal(got, want)


def test_cli_segment_output_naming(tmp_path, _enc):
    # segment outputs must not collide with full-decode outputs: a 0.2 s
    # excerpt may never masquerade as <name>_recon.wav nor trip the batch
    # skip-resume against a later full decode
    import os

    from fwav.cli import main as cli_main
    from fwav.io.container import save_compressed
    from fwav.io.wav import read_wav_mono

    sig, sr, rec, bank, n_ranges, N, olen, full = _enc
    d = tmp_path / "batch"
    d.mkdir()
    save_compressed(d / "x.fwav", rec, bank, N, sr, 2, 128, 1, 1e-4, olen)
    cli_main(["decompress", str(d), "--batch", "--start", "0.2",
              "--duration", "0.2"])
    seg_name = "x_recon_seg_0.2s+0.2s.wav"
    assert (d / seg_name).exists() and not (d / "x_recon.wav").exists()
    cli_main(["decompress", str(d), "--batch"])  # full decode NOT skipped
    assert (d / "x_recon.wav").exists()
    got, _, _ = read_wav_mono(d / seg_name)
    assert len(got) == int(0.2 * sr)
