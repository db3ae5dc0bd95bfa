"""Voiced/silent detection with hysteresis (reference: fractal.py:880-909).

The reference runs a sequential Python loop over frame energies. Hysteresis
(on above `hi`, off below `lo`, hold otherwise) is a last-event forward-fill,
which vectorizes as a cumulative max over event positions — O(n) with no
sequential scan, identical output. Both a numpy host version (the live
encode prepass) and a JAX version (for the fully on-device pipeline) are
provided.

Live call site parity: compress_audio uses frame_size = 2 * range_size and
the mask MULTIPLIES the signal — silence is zeroed, not skipped
(fractal.py:1074-1079).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def frame_energies_np(signal: np.ndarray, frame_size: int) -> np.ndarray:
    """Per-frame mean energy over reflect-padded frames (fractal.py:885-891)."""
    signal = np.asarray(signal, dtype=np.float32)
    n = len(signal)
    n_frames = (n + frame_size - 1) // frame_size
    pad_len = n_frames * frame_size - n
    padded = np.pad(signal, (0, pad_len), mode="reflect") if pad_len else signal
    frames = padded.reshape(n_frames, frame_size)
    return np.mean(frames * frames, axis=1)


def hysteresis_np(energies: np.ndarray, hi: float, lo: float) -> np.ndarray:
    """Vectorized hysteresis: state turns on above `hi`, off below `lo`,
    holds otherwise; initial state off. Equivalent to the reference's
    sequential loop (fractal.py:900-907): the state after frame i is the sign
    of the most recent on/off event at or before i."""
    energies = np.asarray(energies)
    on = energies > hi
    off = energies < lo  # `elif` in the reference: on wins when both hold
    event = np.where(on, 1, np.where(off & ~on, -1, 0)).astype(np.int8)
    pos = np.arange(len(energies))
    marked = np.where(event != 0, pos, -1)
    last = np.maximum.accumulate(marked)
    state = np.where(last >= 0, event[np.clip(last, 0, None)] > 0, False)
    return state.astype(np.uint8)


def voiced_detection(
    signal,
    frame_size: int = 64,
    energy_threshold: float = 1e-4,
    smooth_window: int = 5,
    low_threshold=None,
):
    """Per-sample 0/1 voiced mask, same length as `signal`. Host (numpy)
    version; parity with reference fractal.py:880-909."""
    signal = np.asarray(signal, dtype=np.float32)
    n = len(signal)
    energies = frame_energies_np(signal, frame_size)

    if smooth_window > 1:
        kernel = np.ones(smooth_window, dtype=np.float32) / smooth_window
        energies = np.convolve(energies, kernel, mode="same")

    if low_threshold is None:
        low_threshold = energy_threshold * 0.5

    mask = hysteresis_np(energies, energy_threshold, low_threshold)
    return np.repeat(mask, frame_size)[:n]


# --- JAX version (static-shape, for the fully fused on-device pipeline) ----

def hysteresis_jax(energies: jnp.ndarray, hi, lo) -> jnp.ndarray:
    """Same forward-fill formulation with lax.cummax — an associative
    scan, no sequential loop."""
    import jax

    on = energies > hi
    off = (energies < lo) & ~on
    event = jnp.where(on, 1, jnp.where(off, -1, 0)).astype(jnp.int8)
    pos = jnp.arange(energies.shape[0], dtype=jnp.int32)
    marked = jnp.where(event != 0, pos, -1)
    last = jax.lax.cummax(marked, axis=0)
    state = jnp.where(last >= 0, jnp.take(event, jnp.clip(last, 0), axis=0) > 0, False)
    return state.astype(jnp.uint8)


def voiced_mask_jax(
    signal_padded: jnp.ndarray,
    n,
    frame_size: int,
    energy_threshold,
    smooth_window: int = 5,
    low_threshold=None,
) -> jnp.ndarray:
    """Per-sample voiced mask over a bucket-padded signal whose true length
    `n` is a traced scalar. Reflect framing of the tail frame is realized by
    index arithmetic (position p >= n reads sample 2n-2-p), matching
    np.pad(..., 'reflect') for pad < frame_size.

    When the padded length divides evenly into frames (the default
    frame_size=2*range_size always does — buckets are multiples of 4096),
    framing is a reshape and only the one partial tail frame is patched via
    an index gather — measured 8.0 -> 0.9 ms on the 10 s bench shapes,
    bit-equal to the gather-framed formulation."""
    nb = signal_padded.shape[0]
    n = jnp.asarray(n, jnp.int32)
    n_frames = (n + frame_size - 1) // frame_size

    if nb % frame_size == 0:
        n_frames_b = nb // frame_size
        framed = signal_padded.reshape(n_frames_b, frame_size)
        energies = jnp.mean(framed * framed, axis=1)
        # reflect-patch the (single, possibly partial) tail frame: the
        # buffer's zero padding does not match np.pad(..., 'reflect')
        tf = n_frames - 1
        tpos = tf * frame_size + jnp.arange(frame_size, dtype=jnp.int32)
        refl = jnp.where(tpos < n, tpos, 2 * n - 2 - tpos)
        tw = jnp.take(signal_padded, jnp.clip(refl, 0, nb - 1), axis=0)
        fidx = jnp.arange(n_frames_b, dtype=jnp.int32)
        energies = jnp.where(fidx == tf, jnp.mean(tw * tw), energies)
        fvalid = fidx < n_frames
    else:
        n_frames_b = nb // frame_size
        pos = jnp.arange(n_frames_b * frame_size, dtype=jnp.int32)
        refl = jnp.where(pos < n, pos, 2 * n - 2 - pos)
        refl = jnp.clip(refl, 0, nb - 1)
        framed = jnp.take(signal_padded, refl, axis=0).reshape(n_frames_b, frame_size)
        energies = jnp.mean(framed * framed, axis=1)
        fvalid = jnp.arange(n_frames_b, dtype=jnp.int32) < n_frames
    energies = jnp.where(fvalid, energies, 0.0)

    if smooth_window > 1:
        kernel = jnp.ones((smooth_window,), jnp.float32) / smooth_window
        energies = jnp.convolve(energies, kernel, mode="same")
        energies = jnp.where(fvalid, energies, 0.0)

    if low_threshold is None:
        low_threshold = energy_threshold * 0.5

    fmask = hysteresis_jax(energies, energy_threshold, low_threshold)
    sample_mask = jnp.broadcast_to(
        fmask[:, None], (n_frames_b, frame_size)
    ).reshape(n_frames_b * frame_size)
    if sample_mask.shape[0] < nb:
        sample_mask = jnp.concatenate(
            [sample_mask, jnp.zeros(nb - sample_mask.shape[0], sample_mask.dtype)]
        )
    return jnp.where(jnp.arange(nb, dtype=jnp.int32) < n, sample_mask, 0)
