"""Domain-bank construction (reference: build_domains_memmap fractal.py:285-334).

A domain is a tile_size-sample sliding window (stride domain_step) of the raw
signal, block-averaged down to range_size samples: bank[i, j] is the mean of
block_len = tile_size // range_size consecutive samples starting at
i*domain_step + j*block_len (windows trimmed to block_len*range_size).

Device formulation: every bank entry is a width-block_len box mean of the
signal, so we compute the box-mean sequence once with O(2*sqrt(block_len))
shifted adds (elementwise, no gather per tap) and gather the (D, range_size)
bank from it. No sliding_window_view materialization, no memmap blocking
loop — the whole bank for minutes of audio fits device memory as
(D, range_size) float32.

Also provides frame_ranges (stride-trick framing util, reference
fractal.py:222-234, capability parity) and a numpy golden builder for tests.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np


def n_domains_for(n_samples: int, tile_size: int, domain_step: int) -> int:
    """Number of sliding windows: 0 if the signal is shorter than a tile."""
    if n_samples < tile_size:
        return 0
    return (n_samples - tile_size) // domain_step + 1


def box_sums(x: jnp.ndarray, width: int) -> jnp.ndarray:
    """s[p] = sum(x[p : p + width]) for every position (tail positions wrap
    garbage — callers only read p <= len(x) - width). Two-stage shifted-add
    decomposition: width = b1*b2 + rem costs b1 + b2 + rem adds instead of
    width, with no long cumsum (so no float32 prefix-sum precision loss)."""
    if width == 1:
        return x
    b1 = max(1, math.isqrt(width))
    b2 = width // b1
    rem = width - b1 * b2
    s1 = x
    for t in range(1, b1):
        s1 = s1 + jnp.roll(x, -t)
    out = s1
    for k in range(1, b2):
        out = out + jnp.roll(s1, -k * b1)
    for t in range(b1 * b2, width):
        out = out + jnp.roll(x, -t)
    return out


def build_bank_jax(
    signal_padded: jnp.ndarray,
    tile_size: int,
    range_size: int,
    domain_step: int,
    d_bucket: int,
    n_domains,
    row_offset=0,
    d_rows: int = None,
) -> jnp.ndarray:
    """(d_rows or d_bucket, range_size) domain bank rows
    [row_offset, row_offset + d_rows) from a bucket-padded raw signal.
    Rows with global index >= n_domains (traced scalar) are zeroed.

    Column j of the bank is the strided slice means[j*block_len ::
    domain_step] — pure slices + one stack, no (D, range_size) gather
    (measured 18 -> 1.1 ms for a 10 s bench bank; bit-equal).

    `row_offset` may be a traced scalar (bank tensor-sharding: each chip
    builds only its own row shard, models.encode tp path) — the strided
    column slice stays static and only the row window is dynamic."""
    import jax

    block_len = tile_size // range_size
    nb = signal_padded.shape[0]
    if d_rows is None:
        d_rows = d_bucket
    means = box_sums(signal_padded, block_len) * (1.0 / block_len)
    need = (range_size - 1) * block_len + (d_bucket - 1) * domain_step + 1
    if need > nb:
        means = jnp.concatenate([means, jnp.zeros(need - nb, means.dtype)])
    span = (d_bucket - 1) * domain_step + 1
    cols = [
        jax.lax.slice(
            means, (j * block_len,), (j * block_len + span,), (domain_step,)
        )
        for j in range(range_size)
    ]
    if d_rows != d_bucket or not isinstance(row_offset, int) or row_offset != 0:
        off = jnp.clip(jnp.asarray(row_offset, jnp.int32), 0, d_bucket - d_rows)
        cols = [jax.lax.dynamic_slice(c, (off,), (d_rows,)) for c in cols]
        rows = off + jnp.arange(d_rows, dtype=jnp.int32)
    else:
        rows = jnp.arange(d_rows, dtype=jnp.int32)
    bank = jnp.stack(cols, axis=1)
    valid = rows < jnp.asarray(n_domains, jnp.int32)
    return jnp.where(valid[:, None], bank, 0.0)


def build_domains_host(
    signal: np.ndarray, tile_size: int, range_size: int, domain_step: int = 1
) -> np.ndarray:
    """Fast host-side bank builder: float64 cumulative sums turn every
    block mean into two lookups — O(n + D*range_size), no window
    materialization. Used for .fwav serialization so the 16-bytes-per-domain
    bank never crosses the (slow) device->host path; the device builds its
    own copy from the raw signal (build_bank_jax) for searching."""
    d = n_domains_for(len(signal), tile_size, domain_step)
    if d == 0:
        return np.zeros((0, range_size), dtype=np.float32)
    return bank_rows_host(
        signal, tile_size, range_size, domain_step, np.arange(d, dtype=np.int64)
    )


def bank_rows_host(signal, tile_size: int, range_size: int, domain_step: int,
                   rows: np.ndarray) -> np.ndarray:
    """Build only the given bank rows — the ONE host-side implementation of
    the box-mean math (build_domains_host and models.stream.domain_block_iter
    both delegate here). Cumulative sums cover only [min(rows), max(rows) +
    tile span), so memory is O(covered span), not O(file)."""
    signal = np.asarray(signal, dtype=np.float32)
    rows = np.asarray(rows, dtype=np.int64)
    if rows.size == 0:
        return np.zeros((0, range_size), dtype=np.float32)
    block_len = tile_size // range_size
    span = range_size * block_len
    s0 = int(rows.min()) * domain_step
    s1 = min(len(signal), int(rows.max()) * domain_step + span)
    seg = signal[s0:s1]
    cs = np.zeros(len(seg) + 1, dtype=np.float64)
    np.cumsum(seg, dtype=np.float64, out=cs[1:])

    d = len(rows)
    contiguous = d > 1 and rows[-1] - rows[0] == d - 1 and bool(
        np.all(np.diff(rows[:: max(1, d // 16)]) > 0)
    ) and bool(np.all(np.diff(rows) == 1)) if d > 1 else True
    if contiguous:
        # contiguous row blocks (the serialization path): column j of the
        # bank is a strided SLICE of the cumulative sums — N slice
        # subtractions instead of a (D, N) fancy-index gather (~6x faster,
        # keeps the host bank build off the encode critical path)
        out = np.empty((d, range_size), dtype=np.float32)
        base = rows[0] * domain_step - s0
        for j in range(range_size):
            lo = base + j * block_len
            a = cs[lo + block_len : lo + block_len + d * domain_step : domain_step]
            b = cs[lo : lo + d * domain_step : domain_step]
            np.multiply(a - b, 1.0 / block_len, out=out[:, j], casting="unsafe")
        return out

    # scattered rows: gather per COLUMN with 1-D index vectors — the 2-D
    # fancy-index form allocates (d, N) int64/float64 temporaries and runs
    # 21x slower at millions of rows (measured 6.8 s -> 0.32 s at 4.4M).
    # Reciprocal-multiply matches division bit-exactly when block_len is a
    # power of two (true for every pow2 / 256-multiple tile size); for
    # non-pow2 block_len it may differ by <=1 ulp — which is the
    # load-bearing direction: it aligns this branch with the contiguous
    # and serialized-bank branches above, which already multiply
    out = np.empty((d, range_size), dtype=np.float32)
    base = rows * domain_step - s0
    for j in range(range_size):
        lo = base + j * block_len
        np.multiply(
            cs[lo + block_len] - cs[lo], 1.0 / block_len,
            out=out[:, j], casting="unsafe",
        )
    return out


def build_domains_np(
    signal: np.ndarray, tile_size: int, range_size: int, domain_step: int = 1
) -> np.ndarray:
    """Golden numpy builder with the reference's exact formulation
    (sliding_window_view -> trim -> reshape -> mean; fractal.py:301-327).
    Used in tests and as a host fallback."""
    signal = np.asarray(signal, dtype=np.float32)
    if len(signal) < tile_size:
        return np.zeros((0, range_size), dtype=np.float32)
    windows = np.lib.stride_tricks.sliding_window_view(signal, tile_size)[::domain_step]
    block_len = tile_size // range_size
    usable = block_len * range_size
    trimmed = windows[:, :usable]
    return trimmed.reshape(len(windows), range_size, block_len).mean(
        axis=2, dtype=np.float32
    )


def frame_ranges(signal, range_size: int, hop=None) -> np.ndarray:
    """Strided frame view (reference: fractal.py:222-234; unused in the live
    path but part of the public surface)."""
    hop = hop or range_size
    signal = np.asarray(signal)
    total = signal.shape[0]
    if total < range_size:
        return np.empty((0, range_size), dtype=signal.dtype)
    num_frames = 1 + (total - range_size) // hop
    shape = (num_frames, range_size)
    strides = (signal.strides[0] * hop, signal.strides[0])
    return np.lib.stride_tricks.as_strided(signal, shape=shape, strides=strides)


def apply_symmetry(tile):
    """[tile, mirrored tile] (reference: fractal.py:874-875)."""
    tile = np.asarray(tile)
    return [tile, tile[::-1]]
