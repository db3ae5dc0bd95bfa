"""Perceptual weighting ops (reference: fractal.py:488-533, 913-1010).

The reference computes a librosa mel filterbank and per-range transient masks
in the live encoder (fractal.py:1210-1214) and threads them into the GPU
worker, which never consumes them (SURVEY.md §2.4.9); the perceptual error
itself lives only in dead code (perceptual_error_batch fractal.py:490-519,
exact_affine_gpu fractal.py:913-1010). The capability is preserved here as
first-class, working ops:

- mel_filterbank: pure-numpy Slaney-scale mel bank, matching
  librosa.filters.mel(htk=False, norm='slaney') so there is no librosa
  runtime dependency (it is not even installed alongside the reference's
  other deps — importing the reference fails without it).
- compute_transient_mask: local energy-rise mask (fractal.py:527-533).
- perceptual_error_batch: mel + transient-envelope weighted L2
  (fractal.py:490-519 semantics), vectorized in JAX.
- pruned_affine_search: the exact_affine_gpu capability — energy-ratio and
  correlation-upper-bound pruning before a weighted affine solve
  (fractal.py:963-1008) — expressed as masking (static shapes under jit
  have no ragged shortlists; pruned candidates simply can't win).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_EPS = 1e-12


def _hz_to_mel(f):
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f < min_log_hz, f / f_sp, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m < min_log_mel, m * f_sp, min_log_hz * np.exp(logstep * (m - min_log_mel)))


def mel_filterbank(sr: int = 44100, n_fft: int = 1024, n_mels: int = 40,
                   fmin: float = 20.0, fmax=None) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular Slaney-normalized mel filterbank —
    the get_mel_filterbank capability (fractal.py:522-525) without librosa."""
    fmax = fmax or sr // 2
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))

    weights = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        lower = (fftfreqs - lo) / max(ctr - lo, 1e-10)
        upper = (hi - fftfreqs) / max(hi - ctr, 1e-10)
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
        weights[i] *= 2.0 / (hi - lo)  # Slaney area normalization
    return weights.astype(np.float32)


# alias with the reference's public name/signature (fractal.py:522)
def get_mel_filterbank(sr=44100, n_fft=1024, n_mels=40, fmin=20, fmax=None):
    return mel_filterbank(sr=sr, n_fft=n_fft, n_mels=n_mels, fmin=fmin, fmax=fmax)


def compute_transient_mask(signal, frame_size: int = 256) -> np.ndarray:
    """Local energy-rise transient mask, normalized to [0, 1]
    (fractal.py:527-533)."""
    signal = np.abs(np.asarray(signal, dtype=np.float32))
    mask = np.zeros_like(signal)
    if len(signal) > frame_size:
        mask[frame_size:] = np.maximum(0.0, signal[frame_size:] - signal[:-frame_size])
    mask /= mask.max() + 1e-8
    return mask


def transient_envelope(r: jnp.ndarray) -> jnp.ndarray:
    """|first difference| envelope, zero-padded at the tail
    (fractal.py:510-511, 937-938)."""
    env = jnp.abs(r[..., 1:] - r[..., :-1])
    pad = [(0, 0)] * (env.ndim - 1) + [(0, 1)]
    return jnp.pad(env, pad)


def perceptual_error_batch(
    candidate_tiles, target_tile, mel_fb=None, transient_mask=None,
    transient_weight: float = 1.0,
):
    """Weighted L2 between candidates (K, N) and a target (N,): weights are a
    mel-ish taper (linspace(1, 0.5) default) times (1 + w * transient
    envelope). Matches fractal.py:490-519 semantics, in JAX."""
    tiles = jnp.asarray(candidate_tiles, jnp.float32)
    r = jnp.asarray(target_tile, jnp.float32)
    n = r.shape[-1]
    mel_weights = (
        jnp.linspace(1.0, 0.5, n, dtype=jnp.float32)
        if mel_fb is None
        else jnp.asarray(mel_fb, jnp.float32)
    )
    env = transient_envelope(r)
    if transient_mask is not None:
        env = env * jnp.asarray(transient_mask, jnp.float32)
    diff = (tiles - r[None, :]) * mel_weights[None, :]
    diff = diff * (1.0 + transient_weight * env[None, :])
    return jnp.linalg.norm(diff, axis=-1)


def pruned_affine_search(
    range_block,
    domain_idxs,
    bank,
    transient_weight: float = 1.0,
    mel_weights=None,
    transient_mask=None,
    energy_ratio_bounds=(0.25, 4.0),
):
    """The exact_affine_gpu capability (fractal.py:913-1010): per-candidate
    mirrored affine solve with energy-ratio pruning and perceptually weighted
    error, selecting the best (domain, orientation).

    The reference drops pruned candidates from the arrays; under static
    shapes we mask them to +inf instead (identical winners). The correlation
    upper-bound prune (fractal.py:977-988) is a sequential best-so-far
    shortcut — a compute saving on CPU, a no-op for the selected result — so
    it is not replicated on the device, where the batched solve is already
    cheaper than the data movement it would save.

    Returns (idx, s, o, sym, err) scalars for the single range.
    """
    r = jnp.asarray(range_block, jnp.float32)
    cand = jnp.asarray(domain_idxs, jnp.int32)
    bank = jnp.asarray(bank, jnp.float32)
    n = r.shape[0]

    tiles = bank[jnp.maximum(cand, 0)]           # (K, N)
    tiles2 = jnp.concatenate([tiles, tiles[:, ::-1]], axis=0)  # orig then mirror
    sym_flags = jnp.concatenate(
        [jnp.zeros(cand.shape[0], jnp.uint8), jnp.ones(cand.shape[0], jnp.uint8)]
    )
    idx2 = jnp.concatenate([cand, cand])

    r_mean = jnp.mean(r)
    r_c = r - r_mean
    r_energy = jnp.sum(r_c * r_c)

    d_mean = jnp.mean(tiles2, axis=1)
    d_c = tiles2 - d_mean[:, None]
    d_energy = jnp.sum(d_c * d_c, axis=1)

    lo, hi = energy_ratio_bounds
    ratio = d_energy / (r_energy + _EPS)
    valid = (ratio > lo) & (ratio < hi) & (idx2 >= 0) & (d_energy > 1e-8)

    num = d_c @ r_c
    s = jnp.where(d_energy > 1e-8, num / jnp.where(d_energy > 0, d_energy, 1.0), 0.0)
    o = r_mean - s * d_mean

    if mel_weights is None:
        mel_weights = jnp.linspace(1.0, 0.5, n, dtype=jnp.float32)
    else:
        mel_weights = jnp.asarray(mel_weights, jnp.float32)
    env = transient_envelope(r) if transient_mask is None else jnp.asarray(transient_mask, jnp.float32)
    weight = mel_weights * (1.0 + transient_weight * env)

    recon = s[:, None] * tiles2 + o[:, None]
    err = jnp.linalg.norm((recon - r[None, :]) * weight[None, :], axis=1)
    err = jnp.where(valid, err, jnp.inf)

    pick = jnp.argmin(err)
    return (
        jnp.where(jnp.isfinite(err[pick]), idx2[pick], -1),
        jnp.where(jnp.isfinite(err[pick]), s[pick], 0.0),
        jnp.where(jnp.isfinite(err[pick]), o[pick], 0.0),
        jnp.where(jnp.isfinite(err[pick]), sym_flags[pick], 0).astype(jnp.uint8),
        err[pick],
    )
