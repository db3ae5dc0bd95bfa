"""Cross-implementation compatibility against the actual reference codec.

Skipped when /root/reference/fractal.py isn't present. The reference has a
hard `import librosa` (fractal.py:488) whose output is never consumed
(SURVEY.md §2.4.9) and librosa is not installed, so a minimal stub is
injected before import. The reference is exercised as a black box — its
multiprocessing pipeline runs for real (CPU mode).
"""

import os
import sys
import types

import numpy as np
import pytest

REF = "/root/reference"
pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(REF, "fractal.py")),
    reason="reference checkout not available",
)


@pytest.fixture(scope="module")
def reference():
    if "librosa" not in sys.modules:
        stub = types.ModuleType("librosa")

        class _Filters:
            @staticmethod
            def mel(sr=22050, n_fft=2048, n_mels=128, fmin=0.0, fmax=None, **kw):
                return np.zeros((n_mels, 1 + n_fft // 2), dtype=np.float32)

        stub.filters = _Filters()
        sys.modules["librosa"] = stub
    sys.path.insert(0, REF)
    import fractal

    yield fractal
    sys.path.remove(REF)


@pytest.fixture
def tone16k():
    sr = 8000
    t = np.linspace(0, 0.25, int(sr * 0.25), endpoint=False)
    sig = (0.4 * (2**15) * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    return sig, sr


def test_reference_fwav_decodes_with_ours(reference, tone16k, tmp_path):
    """reference encode -> reference save -> OUR load + decode."""
    from fwav import compute_snr, decompress_audio, load_compressed

    sig, sr = tone16k
    matches, domains, n_ranges, range_size, tile, step, thr, olen = (
        reference.compress_audio(
            sig, sr, 2, tile_size=128, use_gpu=False,
            domains_tmpdir=str(tmp_path),
        )
    )
    p = tmp_path / "ref.fwav"
    reference.save_compressed(
        str(p), matches, np.asarray(domains), range_size, sr, 2, tile, step,
        thr, olen,
    )

    (m2, d2, n2, rs2, fr2, sw2, t2, st2, thr2, olen2) = load_compressed(p)
    assert (n2, rs2, fr2, sw2, t2, st2, olen2) == (
        n_ranges, range_size, sr, 2, tile, step, olen
    )
    ours = decompress_audio(m2, d2, n2, rs2, original_len=olen2)
    theirs = np.asarray(
        reference.decompress_audio(matches, np.asarray(domains), n_ranges,
                                   range_size, original_len=olen)
    )
    # same matches, same bank -> BIT-IDENTICAL output (VERDICT r2 item 3).
    # The math: the reference starts recon at zero, so the first-iteration
    # refit scale is exactly 0 wherever the tile has centered energy and
    # every later iteration reproduces itself (our closed form,
    # models/decode.py); its bincount-average runs in float64 but each bin
    # has count 1, so out[i]/1.0 assigned back into the float32 recon is
    # exactly the f32 value of s_used*tile + o — the same f32 expression
    # our closed form evaluates. Exact equality, not a tolerance.
    assert theirs.dtype == ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    assert compute_snr(sig, ours) > 4.0


def test_our_fwav_decodes_with_reference(reference, tone16k, tmp_path):
    """OUR encode + save -> reference load + decode."""
    from fwav import compress_audio, compute_snr, save_compressed

    sig, sr = tone16k
    matches, domains, n_ranges, range_size, tile, step, thr, olen = (
        compress_audio(sig, sr, 2, tile_size=128)
    )
    p = tmp_path / "ours.fwav"
    save_compressed(str(p), matches, domains, range_size, sr, 2, tile, step,
                    thr, olen)

    (m2, d2, n2, rs2, fr2, sw2, t2, st2, thr2, olen2) = (
        reference.load_compressed(str(p))
    )
    assert (n2, rs2, fr2, sw2) == (n_ranges, range_size, sr, 2)
    recon = np.asarray(
        reference.decompress_audio(m2, d2, n2, rs2, original_len=olen2,
                                   use_gpu=False)
    )
    snr = compute_snr(sig, recon)
    assert snr > 4.0, snr  # the reference e2e quality floor, on OUR file


def test_round_trip_snr_beats_reference(reference, tmp_path):
    """Same signal through both full pipelines: our default round trip must
    meet or beat the reference's."""
    from fwav import compress_audio_arrays, compute_snr, decompress_audio

    rng = np.random.default_rng(0)
    sr = 8000
    t = np.arange(int(sr * 0.6)) / sr
    sig = 0.3 * np.sin(2 * np.pi * (250 + 200 * t) * t) + 0.1 * np.sin(2 * np.pi * 900 * t)
    sig += 0.01 * rng.standard_normal(len(t))
    sig = (sig * (2**14)).astype(np.float32)

    m_r, d_r, n_r, rs_r, *_ = reference.compress_audio(
        sig, sr, 2, tile_size=128, use_gpu=False, domains_tmpdir=str(tmp_path)
    )
    ref_recon = np.asarray(
        reference.decompress_audio(m_r, np.asarray(d_r), n_r, rs_r,
                                   original_len=len(sig))
    )
    ref_snr = compute_snr(sig, ref_recon)

    rec, dom, n, rs, *_ = compress_audio_arrays(sig, sr, 2, tile_size=128)
    our_recon = decompress_audio(rec, dom, n, rs, original_len=len(sig))
    our_snr = compute_snr(sig, our_recon)
    assert our_snr >= ref_snr - 1e-6, (our_snr, ref_snr)
