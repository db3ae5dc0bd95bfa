"""WAV ingest/egress, behavior-compatible with the reference
(read_wav_mono fractal.py:81-113, write_wav fractal.py:116-137).

Supported sample widths: 8-bit unsigned (stored as int16-128), 16-bit signed,
24-bit signed (manual little-endian pack + sign extension), 32-bit float.
read_wav_mono folds multichannel input to mono by mean (the reference's only
behavior); read_wav preserves channels as an (n_frames, n_channels) array
for the multichannel codec path (beyond the reference — it has no
channel-preserving mode). write_wav accepts (n,) mono or (n, ch)
frame-major data and writes the matching channel count.

All conversions are vectorized numpy — this is host-side ingest, the device
pipeline receives float32.
"""

from __future__ import annotations

import wave

import numpy as np


def _read_frames(path):
    """Shared WAV decode: returns (interleaved 1-D sample array in the
    width's native numeric type, n_channels, framerate, sampwidth)."""
    with wave.open(str(path), "rb") as w:
        nchan = w.getnchannels()
        sampwidth = w.getsampwidth()
        framerate = w.getframerate()
        nframes = w.getnframes()
        comptype = w.getcomptype()
        if comptype != "NONE":
            raise ValueError(f"Unsupported WAV compression type: {comptype}")
        raw = w.readframes(nframes)

    if sampwidth == 1:
        # 8-bit PCM is unsigned; center at zero (reference convention: u8 - 128)
        data = np.frombuffer(raw, dtype=np.uint8).astype(np.int16) - 128
    elif sampwidth == 2:
        data = np.frombuffer(raw, dtype=np.int16)
    elif sampwidth == 3:
        data = _unpack_int24(raw)
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype=np.float32)
    else:
        raise ValueError(f"Unsupported sample width: {sampwidth}")
    return data, nchan, framerate, sampwidth


def read_wav_mono(path, mmap=False):
    """Read a WAV file, fold to mono, return (float32 signal, framerate,
    sampwidth). Raises on compressed WAV (comptype != 'NONE').

    mmap is accepted for API parity with the reference (fractal.py:81 —
    unused even there: its scipy path ignores it after the fold) and is a
    no-op: the fold materializes a float array regardless, so mapping the
    raw PCM buys nothing."""
    del mmap
    data, nchan, framerate, sampwidth = _read_frames(path)
    if nchan > 1:
        data = data.reshape(-1, nchan).mean(axis=1)
    return data.astype(np.float32), framerate, sampwidth


def read_wav(path):
    """Read a WAV file preserving channels: returns (float32 array of shape
    (n_frames, n_channels), framerate, sampwidth). Mono files come back as
    (n, 1). The mean over axis 1 equals read_wav_mono's fold up to float32
    rounding (the fold averages in the integer-sourced float64)."""
    data, nchan, framerate, sampwidth = _read_frames(path)
    return (
        data.reshape(-1, nchan).astype(np.float32),
        framerate,
        sampwidth,
    )


def write_wav(path, data, framerate: int, sampwidth: int) -> None:
    """Write a WAV at the given sample width, with the inverse conversions
    of read_wav_mono/read_wav (including 24-bit byte packing). data is (n,)
    for mono or (n_frames, n_channels) frame-major for multichannel."""
    data = np.asarray(data)
    nchan = 1 if data.ndim == 1 else int(data.shape[1])
    flat = data.reshape(-1)  # frame-major rows interleave naturally
    if sampwidth == 1:
        out = (flat + 128).clip(0, 255).astype(np.uint8)
    elif sampwidth == 2:
        out = flat.clip(-32768, 32767).astype(np.int16)
    elif sampwidth == 3:
        out = _pack_int24(flat)
    elif sampwidth == 4:
        out = flat.astype(np.float32)
    else:
        raise ValueError(f"Unsupported sample width: {sampwidth}")

    with wave.open(str(path), "wb") as w:
        w.setnchannels(nchan)
        w.setsampwidth(sampwidth)
        w.setframerate(framerate)
        w.writeframes(out.tobytes())


def _unpack_int24(raw: bytes) -> np.ndarray:
    """Little-endian 24-bit PCM -> int32 with sign extension."""
    b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
    val = (
        b[:, 0].astype(np.int32)
        | (b[:, 1].astype(np.int32) << 8)
        | (b[:, 2].astype(np.int32) << 16)
    )
    sign = val & 0x800000
    return val - (sign << 1)


def _pack_int24(data: np.ndarray) -> np.ndarray:
    """int-valued samples -> packed little-endian 24-bit byte stream."""
    d32 = np.asarray(data).clip(-(2**23), 2**23 - 1).astype(np.int32)
    b0 = (d32 & 0xFF).astype(np.uint8)
    b1 = ((d32 >> 8) & 0xFF).astype(np.uint8)
    b2 = ((d32 >> 16) & 0xFF).astype(np.uint8)
    return np.column_stack([b0, b1, b2]).reshape(-1)
