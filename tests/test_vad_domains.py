"""VAD hysteresis vs the reference's scalar loop; domain bank builder vs the
numpy golden (sliding_window_view formulation)."""

import jax.numpy as jnp
import numpy as np

from fwav.ops.domains import box_sums, build_bank_jax, build_domains_np, n_domains_for
from fwav.ops.vad import voiced_detection, voiced_mask_jax


def _ref_voiced_detection(signal, frame_size=64, energy_threshold=1e-4,
                          smooth_window=5, low_threshold=None):
    """Scalar-loop transcription of fractal.py:880-909 (golden)."""
    signal = np.asarray(signal, dtype=np.float32)
    n = len(signal)
    n_frames = (n + frame_size - 1) // frame_size
    pad_len = n_frames * frame_size - n
    padded = np.pad(signal, (0, pad_len), mode="reflect")
    frames = padded.reshape(n_frames, frame_size)
    energies = np.mean(frames * frames, axis=1)
    if smooth_window > 1:
        kernel = np.ones(smooth_window, dtype=np.float32) / smooth_window
        energies = np.convolve(energies, kernel, mode="same")
    if low_threshold is None:
        low_threshold = energy_threshold * 0.5
    mask = np.zeros_like(energies, dtype=np.uint8)
    voiced = False
    for i, e in enumerate(energies):
        if e > energy_threshold:
            voiced = True
        elif e < low_threshold:
            voiced = False
        mask[i] = 1 if voiced else 0
    return np.repeat(mask, frame_size)[:n]


def _burst_signal(seed=0, n=5000):
    rng = np.random.default_rng(seed)
    sig = 0.001 * rng.standard_normal(n).astype(np.float32)
    sig[500:1500] += 0.5 * np.sin(np.linspace(0, 100, 1000)).astype(np.float32)
    sig[3000:3800] += 0.3 * rng.standard_normal(800).astype(np.float32)
    return sig


def test_hysteresis_matches_scalar_loop():
    for seed in range(4):
        sig = _burst_signal(seed)
        for fs in (8, 64):
            got = voiced_detection(sig, frame_size=fs, energy_threshold=1e-3)
            want = _ref_voiced_detection(sig, frame_size=fs, energy_threshold=1e-3)
            np.testing.assert_array_equal(got, want)


def test_hysteresis_holds_between_thresholds():
    # energies that rise above hi, drift in the hold band, then drop below lo
    fs = 4
    hi = 1.0
    vals = np.array([0.1, 2.0, 0.9, 0.9, 0.3, 0.9, 2.0, 0.1], dtype=np.float32)
    sig = np.repeat(np.sqrt(vals), fs).astype(np.float32)
    got = voiced_detection(sig, frame_size=fs, energy_threshold=hi, smooth_window=1)
    want = _ref_voiced_detection(sig, frame_size=fs, energy_threshold=hi, smooth_window=1)
    np.testing.assert_array_equal(got, want)


def test_jax_vad_matches_numpy():
    sig = _burst_signal(7, n=3900)
    nb = 4096
    padded = np.zeros(nb, np.float32)
    padded[: len(sig)] = sig
    got = np.asarray(
        voiced_mask_jax(jnp.asarray(padded), len(sig), frame_size=8,
                        energy_threshold=1e-3)
    )[: len(sig)]
    want = voiced_detection(sig, frame_size=8, energy_threshold=1e-3)
    np.testing.assert_array_equal(got, want)


def test_box_sums():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(512).astype(np.float32)
    for w in (1, 3, 7, 16, 32, 256):
        got = np.asarray(box_sums(jnp.asarray(x), w))
        want = np.convolve(x, np.ones(w), mode="full")[w - 1 :]
        np.testing.assert_allclose(got[: 512 - w + 1], want[: 512 - w + 1], atol=1e-4)


def test_bank_matches_reference_builder():
    rng = np.random.default_rng(2)
    sig = rng.standard_normal(2000).astype(np.float32)
    for tile, step in ((128, 1), (1024, 1), (128, 3)):
        range_size = max(4, tile // 256)
        want = build_domains_np(sig, tile, range_size, step)
        d = n_domains_for(len(sig), tile, step)
        assert d == len(want)
        nb = 4096
        padded = np.zeros(nb, np.float32)
        padded[: len(sig)] = sig
        db = ((d + 255) // 256) * 256
        got = np.asarray(
            build_bank_jax(jnp.asarray(padded), tile, range_size, step, db, d)
        )
        np.testing.assert_allclose(got[:d], want, atol=1e-4)
        assert np.all(got[d:] == 0)
