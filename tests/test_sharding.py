"""Multi-chip equivalence on the virtual 8-device CPU mesh (SURVEY.md §4):
sharded search must match the single-device kernel bit-for-bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from fwav.ops.affine import affine_stats
from fwav.ops.search import (
    exact_search_block,
    exact_search_scan,
    merge_shard_bests,
)
from fwav.parallel.mesh import make_mesh


def _problem(seed, M=64, D=512, N=4):
    rng = np.random.default_rng(seed)
    ranges = rng.standard_normal((M, N)).astype(np.float32)
    bank = rng.standard_normal((D, N)).astype(np.float32)
    valid = np.ones(D, bool)
    valid[-17:] = False  # padded tail rows
    return ranges, bank, valid


def test_devices_available():
    assert len(jax.devices()) >= 8, jax.devices()


def _tp_scan_merge(ranges, bank, valid, mesh, tp, domain_block, objective):
    """The production tp composition at op granularity, built from the SAME
    shared kernels models.encode.run_search_tp uses (exact_search_scan with
    idx_offset + merge_shard_bests) — there is deliberately no standalone
    sharded-search op to test instead (VERDICT r2 item 4)."""
    d_local = bank.shape[0] // tp

    def body(r_c, bank_shard, valid_shard):
        off = jax.lax.axis_index("tp") * d_local
        d_mean, d_denom = affine_stats(bank_shard)
        score, idx, sym = exact_search_scan(
            r_c, bank_shard, d_mean, d_denom, valid_shard, domain_block,
            objective, idx_offset=off,
        )
        return merge_shard_bests(score, idx, sym, "tp")

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, None), P("tp", None), P("tp")),
        out_specs=(P(), P(), P()),
        check_vma=False,
    ))
    r_c = ranges - ranges.mean(axis=1, keepdims=True)
    return [np.asarray(x) for x in fn(
        jnp.asarray(r_c), jnp.asarray(bank), jnp.asarray(valid)
    )]


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("objective", ["balanced", "affine"])
def test_bank_sharded_scan_merge_matches_single_device(tp, objective):
    """Per-shard scan + all_gather merge must reproduce the single-device
    running-best scan bit-for-bit: same winner, same orientation, same
    selection score, including the masked padded tail rows."""
    ranges, bank, valid = _problem(0)
    mesh = make_mesh(8, dp=8 // tp, tp=tp)

    d_mean, d_denom = affine_stats(jnp.asarray(bank))
    r_c = jnp.asarray(ranges - ranges.mean(axis=1, keepdims=True))
    want = [
        np.asarray(x)
        for x in jax.jit(exact_search_scan, static_argnums=(5, 6))(
            r_c, jnp.asarray(bank), d_mean, d_denom, jnp.asarray(valid),
            64, objective,
        )
    ]
    got = _tp_scan_merge(ranges, bank, valid, mesh, tp, 64, objective)
    np.testing.assert_array_equal(got[1], want[1])  # idx
    np.testing.assert_array_equal(got[2], want[2])  # sym
    # scores agree to fp rounding only: XLA compiles the sharded and
    # unsharded programs separately and may contract fma terms differently
    # (~1 ulp; the CLAUDE.md invariant — which is WHY the production
    # protocol ships only the selection and refits s/o/err on the host)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-6)


def test_merge_shard_bests_tie_break_order():
    """The merge's documented tie-break order (max score, then min global
    idx, then original orientation before mirror) — asserted directly with
    hand-built per-shard winners."""
    mesh = make_mesh(8, dp=1, tp=8)
    M = 4

    # per shard k, candidate triples for each of 4 ranges:
    # r0: scores strictly increase with k -> shard 7 wins (idx 37)
    # r1: all shards tie on score; min global idx wins -> idx 5 (shard 0)
    # r2: score+idx tie impossible across shards (disjoint index spaces) —
    #     emulate the idx tie via equal idx values: original orientation
    #     (sym=False, shard 2) must beat mirrored (sym=True, others)
    # r3: all -inf (no valid candidate anywhere) stays -inf
    scores = np.full((8, M), -np.inf, np.float32)
    idxs = np.zeros((8, M), np.int32)
    syms = np.zeros((8, M), bool)
    for k in range(8):
        scores[k, 0] = float(k)
        idxs[k, 0] = 30 + k
        scores[k, 1] = 7.0
        idxs[k, 1] = 5 + k
        scores[k, 2] = 3.0
        idxs[k, 2] = 9
        syms[k, 2] = k != 2
    fn = jax.jit(jax.shard_map(
        lambda s, i, y: merge_shard_bests(s[0], i[0], y[0], "tp"),
        mesh=mesh, in_specs=(P("tp"),) * 3, out_specs=(P(), P(), P()),
        check_vma=False,
    ))
    s, i, y = fn(jnp.asarray(scores)[:, None, :], jnp.asarray(idxs)[:, None, :],
                 jnp.asarray(syms)[:, None, :])
    s, i, y = np.asarray(s)[0], np.asarray(i)[0], np.asarray(y)[0]
    assert (s[0], i[0]) == (7.0, 37)
    assert (s[1], i[1]) == (7.0, 5)
    assert (s[2], i[2], bool(y[2])) == (3.0, 9, False)
    assert np.isinf(s[3]) and s[3] < 0


def test_range_dp_encode_matches_single_device():
    """Range-sharded (dp) execution of the search kernel must be exact: the
    ranges axis is embarrassingly parallel."""
    ranges, bank, valid = _problem(1, M=128, D=256)
    mesh = make_mesh(8, dp=8, tp=1)

    d_mean, d_denom = affine_stats(jnp.asarray(bank))

    def run(r):
        return exact_search_block(
            r, jnp.asarray(bank), d_mean, d_denom, jnp.asarray(valid),
            domain_block=64, s_clip=16.0, objective="balanced",
        )

    want = [np.asarray(x) for x in jax.jit(run)(jnp.asarray(ranges))]

    from jax.sharding import NamedSharding, PartitionSpec as P

    r_sharded = jax.device_put(
        jnp.asarray(ranges), NamedSharding(mesh, P("dp", None))
    )
    got = [np.asarray(x) for x in jax.jit(run)(r_sharded)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sharded_all_invalid_bank():
    """No valid domain on ANY shard: the merged score must stay -inf for
    every range (the encode core then emits sentinels)."""
    ranges, bank, valid = _problem(2, M=16, D=64)
    valid[:] = False
    mesh = make_mesh(8, dp=4, tp=2)
    score, idx, sym = _tp_scan_merge(
        ranges, bank, valid, mesh, 2, 32, "balanced"
    )
    assert np.all(np.isinf(score)) and np.all(score < 0)


def _noise_fixture():
    """Noise-bearing signal (no mirror ties, unlike a pure tone) with a
    silence gap so sentinel rows are exercised too."""
    rng = np.random.default_rng(3)
    sr = 44100
    t = np.arange(int(sr * 1.2)) / sr
    sig = (
        0.4 * np.sin(2 * np.pi * (200 + 60 * np.sin(2 * np.pi * t)) * t * 3)
        + 0.1 * np.sin(2 * np.pi * 950 * t)
        + 0.02 * rng.standard_normal(len(t))
    )
    sig[10000:12000] = 0.0
    return np.round(sig * 15000).astype(np.float32), sr


@pytest.fixture(scope="module")
def _single_device_records():
    from fwav.models.encode import compress_audio_arrays

    sig, sr = _noise_fixture()
    out = {}
    for mode in ("coarse", "exact"):
        out[mode] = compress_audio_arrays(sig, sr, 2, search=mode)
    return sig, sr, out


@pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_compress_audio_sharded_bit_equal_coarse(dp, tp, _single_device_records):
    """Full multi-chip encode — the SAME fused core under shard_map, ranges
    dp-sharded (and further tp-range-split: coarse's tp sharding divides
    ranges, not bank rows) — must produce
    BIT-EQUAL records to the single-device encoder on a tie-free fixture:
    only the selection leaves the device and s/o/err come from the shared
    host refit (VERDICT r1 item 4)."""
    from fwav.parallel.shard import compress_audio_sharded

    sig, sr, single = _single_device_records
    rec_1, dom_1, n1, rs1, *_ = single["coarse"]
    rec_8, dom_8, n8, rs8, *_ = compress_audio_sharded(
        sig, sr, 2, mesh=make_mesh(8, dp=dp, tp=tp), search="coarse"
    )
    assert (n8, rs8) == (n1, rs1)
    np.testing.assert_array_equal(dom_8, dom_1)
    for f in ("idx", "s", "o", "sym", "err"):
        np.testing.assert_array_equal(rec_8[f], rec_1[f], err_msg=f)
    assert (rec_1["idx"] == -1).sum() > 0  # sentinel rows exercised


def test_compress_audio_sharded_bit_equal_exact(_single_device_records):
    from fwav.parallel.shard import compress_audio_sharded

    sig, sr, single = _single_device_records
    rec_1, dom_1, n1, rs1, *_ = single["exact"]
    rec_8, _, n8, rs8, *_ = compress_audio_sharded(
        sig, sr, 2, mesh=make_mesh(8, dp=2, tp=4), search="exact"
    )
    assert (n8, rs8) == (n1, rs1)
    for f in ("idx", "s", "o", "sym", "err"):
        np.testing.assert_array_equal(rec_8[f], rec_1[f], err_msg=f)


def test_compress_audio_sharded_decodes(_single_device_records):
    """End to end: the sharded encode's records decode identically."""
    from fwav import compute_snr, decompress_audio
    from fwav.parallel.shard import compress_audio_sharded

    sig, sr, single = _single_device_records
    rec_1, dom_1, n1, rs1, *_ = single["coarse"]
    rec_8, dom_8, n8, rs8, *_ = compress_audio_sharded(
        sig, sr, 2, mesh=make_mesh(8, dp=4, tp=2), search="coarse"
    )
    d1 = decompress_audio(rec_1, dom_1, n1, rs1, original_len=len(sig))
    d8 = decompress_audio(rec_8, dom_8, n8, rs8, original_len=len(sig))
    np.testing.assert_array_equal(d1, d8)
    assert compute_snr(sig, d8) > 4.0


def test_sharded_damped_decode_matches_single_device(_single_device_records):
    """The damped (device while_loop) decode range-sharded over the dp axis
    must reproduce the single-device decode (VERDICT r1 item 7)."""
    from fwav import decompress_audio

    from fwav import compute_snr

    sig, sr, single = _single_device_records
    rec, dom, n, rs, *_ = single["coarse"]
    # with the early break disabled both loops run the same iterations and
    # the per-range math is identical
    d1f = decompress_audio(rec, dom, n, rs, original_len=len(sig),
                           s_damping=0.5, convergence_eps=0.0)
    d8f = decompress_audio(rec, dom, n, rs, original_len=len(sig),
                           s_damping=0.5, convergence_eps=0.0,
                           mesh=make_mesh(8, dp=8, tp=1))
    np.testing.assert_allclose(d8f, d1f, rtol=0, atol=1e-4)
    # with the default eps, the relative-delta early break becomes PER-SHARD
    # (the same documented semantics as the DECODE_SHARD_RANGES chunking):
    # shards may stop at different iteration counts, so only the converged
    # quality is asserted
    d1 = decompress_audio(rec, dom, n, rs, original_len=len(sig),
                          s_damping=0.5)
    d8 = decompress_audio(rec, dom, n, rs, original_len=len(sig),
                          s_damping=0.5, mesh=make_mesh(8, dp=8, tp=1))
    assert abs(compute_snr(sig, d8) - compute_snr(sig, d1)) < 0.05


def test_init_distributed_single_process():
    """Multi-host wrapper smoke (VERDICT r1 item 8): a num_processes=1
    jax.distributed cluster initializes and yields a working mesh. Runs in a
    subprocess because distributed init must precede backend init."""
    import subprocess
    import sys

    code = (
        "import jax;"
        "jax.config.update('jax_platforms', 'cpu');"
        "from fwav.parallel.mesh import init_distributed;"
        "mesh = init_distributed('localhost:12321', 1, 0);"
        "assert mesh.devices.size >= 1, mesh;"
        "import jax.numpy as jnp;"
        "assert float(jnp.arange(4.0).sum()) == 6.0;"
        "print('distributed-ok', mesh.shape)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=180, cwd="/root/repo",
        env={**__import__('os').environ, "JAX_PLATFORMS": "cpu"},
    )
    assert "distributed-ok" in out.stdout, (out.stdout, out.stderr)


@pytest.mark.parametrize("search", ["exact", "coarse"])
def test_damped_objective_tp_composition(search, _single_device_records):
    """objective='damped' composes with tp for BOTH exact (bank-sharded
    MIPS-free scan, merged winners) and coarse (range-split multi-lobe
    refine — round-4 unification; previously refused): records bit-equal to
    single device via the idx-only protocol + host refit."""
    from fwav.parallel.shard import compress_audio_sharded

    sig, sr, _ = _single_device_records
    from fwav.models.encode import compress_audio_arrays

    rec_1, dom_1, n1, rs1, *_ = compress_audio_arrays(
        sig, sr, 2, search=search, objective="damped"
    )
    rec_8, _, n8, rs8, *_ = compress_audio_sharded(
        sig, sr, 2, mesh=make_mesh(8, dp=2, tp=4), search=search,
        objective="damped",
    )
    assert (n8, rs8) == (n1, rs1)
    for f in ("idx", "s", "o", "sym", "err"):
        np.testing.assert_array_equal(rec_8[f], rec_1[f], err_msg=f)


@pytest.mark.parametrize("dp,tp", [(2, 4), (1, 8)])
def test_compress_audio_sharded_bit_equal_topk(dp, tp, _single_device_records):
    """search='topk' under tp bank sharding: per-shard exact top-k MIPS
    shortlists all_gather into the exact global top-k (multi-key sort in
    _topk_merge_scan's (score desc, idx asc) total order), each shard
    solves the affine pick for its owned candidates, and the winners merge
    keyed on the argmin position — so the sharded selection replicates the
    single-device slot-order tie-break bit-for-bit on a tie-free fixture
    (fractal.py:353-381,535-552 parallelized)."""
    from fwav.models.encode import compress_audio_arrays
    from fwav.parallel.shard import compress_audio_sharded

    sig, sr, _ = _single_device_records
    rec_1, dom_1, n1, rs1, *_ = compress_audio_arrays(
        sig, sr, 2, search="topk"
    )
    rec_8, dom_8, n8, rs8, *_ = compress_audio_sharded(
        sig, sr, 2, mesh=make_mesh(8, dp=dp, tp=tp), search="topk"
    )
    assert (n8, rs8) == (n1, rs1)
    np.testing.assert_array_equal(dom_8, dom_1)
    for f in ("idx", "s", "o", "sym", "err"):
        np.testing.assert_array_equal(rec_8[f], rec_1[f], err_msg=f)
    assert (rec_1["idx"] == -1).sum() > 0  # sentinel rows exercised


def test_mesh_path_ignores_h2d_chunks(_single_device_records):
    """h2d_chunks is a single-device transport knob: the sharded encode
    must ignore it (its replicated in_specs own the transfer) and stay
    bit-equal to the mesh encode without the knob."""
    from fwav.config import EncoderConfig
    from fwav.parallel.shard import compress_audio_sharded

    sig, sr, single = _single_device_records
    mesh = make_mesh(4, dp=2, tp=2)
    want = compress_audio_sharded(sig, sr, 2, mesh=mesh, search="exact")
    got = compress_audio_sharded(
        sig, sr, 2, mesh=mesh,
        config=EncoderConfig(search="exact", h2d_chunks=4),
    )
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])
