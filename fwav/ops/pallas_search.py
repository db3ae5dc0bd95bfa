"""Fused matched-filter scan as a Pallas kernel for the GPU (Triton route).

The exact search and the coarse lobe scan score two orientations of every
(range, domain) pair and keep the best C per range (ops.search
exact_search_scan / gain_topk_scan: lax.scan programs that write a
(2*range_block, domain_block) f32 score tile to device memory at every step
and read it back for the argmax or top-C). This kernel fuses scoring and
reduction, so no score tensor ever reaches device memory:

- the grid runs over range blocks only; each program walks the whole bank
  in `block_d`-row steps (a fori_loop) and carries its sorted running
  top-C in registers as C separate vectors, updated by a C-deep
  compare/shift insertion;
- the contraction depth is range_size (4 at the defaults), far below what
  tensor cores take, so each score is a handful of f32 FMAs on the CUDA
  cores, one tap at a time: ranges ride as (N, M) and the bank as (N, D),
  so every tap is a contiguous 1-D load;
- the (subsampled) bank is tens to hundreds of KB and stays L2-resident
  across programs.

The wrapper pads M with masked rows and D with invalid rows up to the
power-of-two blocks Triton needs, and N to a power of two with zero taps
the kernel never reads, so any shape runs.

Orientation is folded with max: the refine stage re-scores both
orientations and the host refit re-derives it for stored records.

Tie order is the lax.scan path's: within a block the lowest domain index
wins, across blocks the earlier block wins (strict compares everywhere).
Scores are exact f32 FMAs, so they agree with the lax.scan path at
Precision.HIGHEST up to summation order.

`interpret=True` runs the kernel in the Pallas interpreter (the CPU tests).
Without it the kernel needs the GPU backend; asking for it on any other
backend raises instead of silently interpreting.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_NEG = float("-inf")

#: The fastest of 18 configurations on one H100 at the 10 s coarse and
#: 120 s global-pass shapes (scripts/tune_scan.py; PERF.md).
BLOCK_M = 32
BLOCK_D = 256
NUM_WARPS = 4


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def require_kernel_backend(interpret: bool = False) -> None:
    """Raise unless the kernel can run as asked: compiled through Triton on
    the gpu backend, or in the interpreter when `interpret` is explicit."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the Pallas search kernel compiles only for the gpu backend "
            f"(this process runs on {jax.default_backend()!r}); set "
            "EncoderConfig.use_pallas=False, or pass interpret=True to the "
            "kernel to run it in the Pallas interpreter"
        )


def _topc_kernel(rT_ref, bT_ref, w_ref, v_ref, *rest, n: int, block_d: int,
                 n_blocks: int, top_c: int, s_clip: float, with_thresh: bool):
    if with_thresh:
        t_ref, score_ref, idx_ref = rest
    else:
        t_ref = None
        score_ref, idx_ref = rest
    taps = [rT_ref[j, :] for j in range(n)]              # n x (BM,)
    bm = taps[0].shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (bm, block_d), 1)

    def body(k, carry):
        best_s, best_i = list(carry[0]), list(carry[1])
        d0 = pl.multiple_of(k * block_d, block_d)
        sl = pl.ds(d0, block_d)
        num_o = num_m = None
        for j in range(n):
            b = bT_ref[j, sl][None, :]
            po = taps[j][:, None] * b
            pm = taps[n - 1 - j][:, None] * b
            num_o = po if num_o is None else num_o + po
            num_m = pm if num_m is None else num_m + pm
        w = w_ref[sl][None, :]
        if t_ref is None:
            # per-orientation gains BEFORE the max: balanced weights can be
            # negative (near-constant tiles), where max(no^2, nm^2)*w flips
            score = jnp.maximum(num_o * num_o * w, num_m * num_m * w)
        else:
            # clip-aware damped gain (ops.search._gain_from_num): monotone
            # in |num| for a fixed domain, so orientations fold first
            a = jnp.maximum(jnp.abs(num_o), jnp.abs(num_m))
            t = t_ref[sl][None, :]
            score = jnp.where(a > t, s_clip * (2.0 * a - t), a * a * w)
        score = jnp.where(v_ref[sl][None, :] != 0, score, _NEG)
        for r in range(top_c):
            g = jnp.max(score, axis=1)
            arg = jnp.min(jnp.where(score == g[:, None], lane, block_d), axis=1)
            if r + 1 < top_c:
                score = jnp.where(lane == arg[:, None], _NEG, score)
            cur_s, cur_i = g, d0 + arg
            # strict >: carried (earlier) candidates win ties, extracted
            # ones keep their lowest-lane-first order
            for c in range(top_c):
                take = cur_s > best_s[c]
                best_s[c], cur_s = (jnp.where(take, cur_s, best_s[c]),
                                    jnp.where(take, best_s[c], cur_s))
                best_i[c], cur_i = (jnp.where(take, cur_i, best_i[c]),
                                    jnp.where(take, best_i[c], cur_i))
        return tuple(best_s), tuple(best_i)

    init = (
        tuple(jnp.full((bm,), _NEG, jnp.float32) for _ in range(top_c)),
        tuple(jnp.zeros((bm,), jnp.int32) for _ in range(top_c)),
    )
    best_s, best_i = jax.lax.fori_loop(0, n_blocks, body, init)
    for c in range(top_c):
        score_ref[c, :] = best_s[c]
        idx_ref[c, :] = best_i[c]


def scan_topc(
    r_c: jnp.ndarray,       # (M, N) centered ranges
    bank: jnp.ndarray,      # (D, N) bank (or its subsampled rows)
    d_weight: jnp.ndarray,  # (D,) selection weights (ops.search.domain_weights)
    d_valid: jnp.ndarray,   # (D,) bool
    top_c: int = 1,
    d_thresh=None,
    s_clip: float = 0.0,
    block_m: int = BLOCK_M,
    block_d: int = BLOCK_D,
    num_warps: int = NUM_WARPS,
    interpret: bool = False,
):
    """Top-C gain candidates per range as one fused kernel: the same
    contract as ops.search.gain_topk_scan (and, at top_c=1, the score/idx
    of exact_search_scan). Returns (scores (M, C) descending, idx (M, C)
    int32, -1 where no finite score). `d_thresh`/`s_clip` select the
    clip-aware damped gain (ops.search.domain_thresh)."""
    require_kernel_backend(interpret)
    M, N = r_c.shape
    D = bank.shape[0]
    np2 = _pow2_ceil(N)
    bm = max(16, min(block_m, _pow2_ceil(M)))
    bd = max(16, min(block_d, _pow2_ceil(D)))
    mp = -(-M // bm) * bm
    dp = -(-D // bd) * bd
    f32 = jnp.float32

    rT = jnp.pad(r_c.astype(f32).T, ((0, np2 - N), (0, mp - M)))
    bT = jnp.pad(bank.astype(f32).T, ((0, np2 - N), (0, dp - D)))
    operands = [
        rT, bT,
        jnp.pad(d_weight.astype(f32), (0, dp - D)),
        jnp.pad(d_valid.astype(jnp.int32), (0, dp - D)),
    ]
    with_thresh = d_thresh is not None
    if with_thresh:
        operands.append(jnp.pad(d_thresh.astype(f32), (0, dp - D)))
    vec = pl.BlockSpec((dp,), lambda i: (0,))
    in_specs = [
        pl.BlockSpec((np2, bm), lambda i: (0, i)),
        pl.BlockSpec((np2, dp), lambda i: (0, 0)),
    ] + [vec] * (len(operands) - 2)
    out_spec = pl.BlockSpec((top_c, bm), lambda i: (0, i))
    kernel = partial(
        _topc_kernel, n=N, block_d=bd, n_blocks=dp // bd, top_c=top_c,
        s_clip=abs(float(s_clip)), with_thresh=with_thresh,
    )
    score, idx = pl.pallas_call(
        kernel,
        grid=(mp // bm,),
        in_specs=in_specs,
        out_specs=[out_spec, out_spec],
        out_shape=[
            jax.ShapeDtypeStruct((top_c, mp), f32),
            jax.ShapeDtypeStruct((top_c, mp), jnp.int32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="fwav_scan_topc",
    )(*operands)
    score, idx = score[:, :M].T, idx[:, :M].T
    return score, jnp.where(jnp.isfinite(score), idx, -1)
