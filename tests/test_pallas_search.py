"""The Pallas (Triton) search kernel vs the lax.scan reference: explicit
interpret mode on the CPU; the compiled kernel runs in the `gpu`-marked test
and in chip_smoke.py on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fwav.ops.affine import affine_stats
from fwav.ops.pallas_search import scan_topc
from fwav.ops.search import (
    domain_thresh,
    domain_weights,
    exact_search_scan,
    gain_topk_scan,
)

HIGHEST = jax.lax.Precision.HIGHEST


def _problem(seed, M, D, N, objective, r_scale=0.3, b_scale=0.3, n_invalid=37,
             s_clip=2.0):
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((M, N)) * r_scale).astype(np.float32)
    bank = (rng.standard_normal((D, N)) * b_scale).astype(np.float32)
    r_c = jnp.asarray(r - r.mean(1, keepdims=True))
    dm, dd = affine_stats(jnp.asarray(bank))
    valid = np.ones(D, bool)
    valid[D - n_invalid:] = False
    w = domain_weights(dm, dd, N, objective)
    t = domain_thresh(dd, objective, s_clip)
    return r_c, bank, dm, dd, jnp.asarray(valid), w, t


def _topk_oracle(r_c, bank, w, valid, C, t, s_clip):
    """gain_topk_scan on a bank padded to a block multiple (its scan needs
    D % domain_block == 0; padded rows are invalid)."""
    D = bank.shape[0]
    dp = -(-D // 64) * 64
    pad = (0, dp - D)
    return np.asarray(gain_topk_scan(
        r_c, jnp.asarray(np.pad(bank, (pad, (0, 0)))), jnp.pad(w, pad),
        jnp.pad(valid, pad), C, 64,
        d_thresh=None if t is None else jnp.pad(t, pad), s_clip=s_clip,
        precision=HIGHEST,
    ))


@pytest.mark.parametrize("objective", ["balanced", "affine"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pallas_scan_matches_reference(objective, seed):
    r_c, bank, dm, dd, valid, w, _ = _problem(seed, 256, 1024, 4, objective)
    s0, i0, _ = (np.asarray(x) for x in exact_search_scan(
        r_c, jnp.asarray(bank), dm, dd, valid, 256, objective
    ))
    s1, i1 = (np.asarray(x)[:, 0] for x in scan_topc(
        r_c, jnp.asarray(bank), w, valid, 1, block_m=128, block_d=256,
        interpret=True,
    ))
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(s0, s1, rtol=1e-6)


def test_pallas_scan_all_invalid():
    r_c, bank, _, _, _, w, _ = _problem(2, 128, 256, 4, "balanced")
    s, i = scan_topc(r_c, jnp.asarray(bank), w, jnp.zeros(256, bool), 3,
                     interpret=True)
    assert np.all(np.isneginf(np.asarray(s)))
    assert np.all(np.asarray(i) == -1)


@pytest.mark.parametrize("M,D,N,C,objective", [
    (77, 333, 6, 3, "affine"),      # odd M/D, non-pow2 N
    (5, 17, 3, 1, "balanced"),      # smaller than one block everywhere
    (300, 1000, 4, 4, "damped"),    # the damped profile's lobe depth
])
def test_padded_odd_shapes_match_oracle(M, D, N, C, objective):
    """The wrapper pads M (masked rows), D (invalid rows) and N (zero taps
    the kernel never reads); results must equal the unpadded oracle."""
    r_c, bank, _, _, valid, w, t = _problem(
        3, M, D, N, objective, r_scale=0.5, b_scale=0.2,
        n_invalid=min(7, D // 3),
    )
    want = _topk_oracle(r_c, bank, w, valid, C, t, 2.0)
    s, got = scan_topc(r_c, jnp.asarray(bank), w, valid, C, d_thresh=t,
                       s_clip=2.0, interpret=True)
    assert got.shape == (M, C) and s.shape == (M, C)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("block_m,block_d", [(16, 16), (32, 64), (128, 256)])
def test_block_sizes_do_not_change_results(block_m, block_d):
    """Block sizes are a tuning knob only: every choice yields the default
    blocks' scores and indices."""
    r_c, bank, _, _, valid, w, t = _problem(4, 200, 700, 4, "damped",
                                            r_scale=0.5, b_scale=0.2)
    args = (r_c, jnp.asarray(bank), w, valid, 4)
    kw = dict(d_thresh=t, s_clip=2.0, interpret=True)
    s0, i0 = scan_topc(*args, **kw)
    s1, i1 = scan_topc(*args, block_m=block_m, block_d=block_d, **kw)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i0))
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s0))


def test_small_bank_coarse_encode_with_pallas_requested(kernel_interpret):
    # search='coarse' + the kernel on a tiny file (a 160-row subsampled
    # bank, smaller than one kernel block) runs the kernel on the padded
    # bank and selects exactly what the lax.scan path selects
    from fwav.config import EncoderConfig
    from fwav.models.encode import compress_audio_arrays

    rng = np.random.default_rng(3)
    t = np.arange(19200) / 16000
    sig = np.round(
        (0.4 * np.sin(2 * np.pi * 330 * t) + 0.01 * rng.standard_normal(len(t)))
        * 16000
    ).astype(np.float32)
    want = compress_audio_arrays(
        sig, 16000, 2, config=EncoderConfig(search="coarse", use_pallas=False)
    )[0]
    assert kernel_interpret["scan_topc"] == 0
    rec, bank, n_ranges, *_ = compress_audio_arrays(
        sig, 16000, 2, config=EncoderConfig(search="coarse", use_pallas=True)
    )
    assert kernel_interpret["scan_topc"] >= 1
    assert (rec["idx"] >= 0).any() and n_ranges > 0
    np.testing.assert_array_equal(rec["idx"], want["idx"])


@pytest.mark.parametrize("seed", [0, 1])
def test_pallas_scan_damped_matches_reference(seed):
    """The clip-aware "damped" objective in the kernel (d_thresh + s_clip
    branch) must reproduce the lax.scan path's selections exactly."""
    s_clip = 2.0  # low clip so the linear branch fires often
    r_c, bank, dm, dd, valid, w, t = _problem(seed, 256, 1024, 4, "damped",
                                              r_scale=0.5, b_scale=0.1)
    s0, i0, _ = (np.asarray(x) for x in exact_search_scan(
        r_c, jnp.asarray(bank), dm, dd, valid, 256, "damped", s_clip=s_clip,
    ))
    s1, i1 = (np.asarray(x)[:, 0] for x in scan_topc(
        r_c, jnp.asarray(bank), w, valid, 1, d_thresh=t, s_clip=s_clip,
        block_m=128, block_d=256, interpret=True,
    ))
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(s0, s1, rtol=1e-6)
    # the low clip must actually exercise the linear branch somewhere
    num_max = np.abs(np.asarray(r_c) @ bank.T).max(1)
    assert (num_max > s_clip * np.asarray(dd)[None, :].max()).any()


@pytest.mark.parametrize("damped", [False, True])
def test_topc_scan_kernel_matches_lax_scan(damped):
    """scan_topc vs ops.search.gain_topk_scan: identical lobe sets in
    identical order (same stable tie-break)."""
    obj = "damped" if damped else "balanced"
    r_c, bank, _, _, valid, w, t = _problem(4, 256, 1024, 4, obj,
                                            r_scale=0.5, b_scale=0.2,
                                            n_invalid=57)
    want = _topk_oracle(r_c, bank, w, valid, 4, t, 2.0 if damped else None)
    _, got = scan_topc(r_c, jnp.asarray(bank), w, valid, 4, d_thresh=t,
                       s_clip=2.0, block_m=128, block_d=256, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_topc_tie_order_is_stable():
    """Exactly tied scores (duplicated bank rows) resolve lowest index
    first, within and across blocks, like the lax.scan merge."""
    r_c, bank, _, _, _, _, _ = _problem(5, 64, 64, 4, "affine")
    bank = np.concatenate([bank] * 4)            # every row appears 4 times
    dm, dd = affine_stats(jnp.asarray(bank))
    w = domain_weights(dm, dd, 4, "affine")
    valid = jnp.ones(len(bank), bool)
    want = _topk_oracle(r_c, bank, w, valid, 4, None, None)
    _, got = scan_topc(r_c, jnp.asarray(bank), w, valid, 4, block_d=32,
                       interpret=True)
    np.testing.assert_array_equal(np.asarray(got), want)
    # the four copies of the best row, in index order
    assert np.all(np.diff(np.asarray(got), axis=1) == 64)


@pytest.mark.parametrize("backend,want", [("gpu", True), ("cpu", False)])
def test_auto_kernel_choice_per_backend(monkeypatch, backend, want):
    """use_pallas=None picks the Triton kernel on the gpu backend and the
    lax.scan path elsewhere; explicit values are taken as given."""
    from fwav.config import EncoderConfig
    from fwav.models.encode import resolve_use_pallas

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert resolve_use_pallas(EncoderConfig()) is want
    assert resolve_use_pallas(EncoderConfig(use_pallas=False)) is False
    assert resolve_use_pallas(EncoderConfig(use_pallas=True)) is True


def test_kernel_without_interpret_raises_off_gpu():
    """No implicit interpreter: asking for the compiled kernel on a backend
    without a Triton lowering is an error, not a silent fallback."""
    r_c, bank, _, _, valid, w, _ = _problem(6, 32, 64, 4, "balanced")
    with pytest.raises(RuntimeError, match="gpu backend"):
        scan_topc(r_c, jnp.asarray(bank), w, valid, 1)


def test_encode_with_kernel_forced_raises_off_gpu():
    from fwav.config import EncoderConfig
    from fwav.models.encode import compress_audio_arrays

    sig = np.round(np.sin(np.arange(8192) / 7.0) * 8000).astype(np.float32)
    with pytest.raises(RuntimeError, match="use_pallas=False"):
        compress_audio_arrays(sig, 16000, 2,
                              config=EncoderConfig(use_pallas=True))


@pytest.mark.gpu
@pytest.mark.parametrize("top_c,objective", [(1, "balanced"), (4, "damped")])
def test_compiled_kernel_matches_oracle_on_gpu(gpu_backend, top_c, objective):
    """The kernel as Triton compiles it for the card vs the lax.scan oracle
    at HIGHEST precision on the same card."""
    r_c, bank, _, _, valid, w, t = _problem(7, 4096, 3000, 4, objective,
                                            r_scale=0.5, b_scale=0.2)
    want = _topk_oracle(r_c, bank, w, valid, top_c, t, 16.0)
    s, got = scan_topc(r_c, jnp.asarray(bank), w, valid, top_c, d_thresh=t,
                       s_clip=16.0)
    got = np.asarray(got)
    assert np.all(np.isfinite(np.asarray(s)[got >= 0]))
    assert (got == want).mean() > 0.99
