"""Decoder semantics vs a golden numpy transcription of the reference
decoder (fractal.py:1378-1473): damping blend, scale clip, stored-s
fallback on degenerate tiles, convergence early break, fixed point."""

import numpy as np
import pytest

from fwav import decompress_audio
from fwav.io.container import MATCH_DTYPE


def _golden_decode(matches, domains, n_ranges, range_size, iterations=8,
                   eps=1e-3, original_len=None, s_clip=16.0, s_damping=0.0):
    """Line-faithful numpy transcription of the reference decoder."""
    recon = np.zeros(n_ranges * range_size, dtype=np.float32)
    di = np.array([m[0] for m in matches], dtype=np.int32)
    s_st = np.array([m[1] for m in matches], dtype=np.float32)
    o_st = np.array([m[2] for m in matches], dtype=np.float32)
    sym = np.array([m[3] for m in matches], dtype=bool)
    invalid = di < 0
    di = np.where(invalid, 0, di)
    tiles_all = domains[di].copy()
    tiles_all[invalid] = 0
    s_st = np.where(invalid, 0.0, s_st)
    o_st = np.where(invalid, 0.0, o_st)
    sym = np.where(invalid, False, sym)
    tiles_all = np.where(sym[:, None], tiles_all[:, ::-1], tiles_all)
    for _ in range(iterations):
        rr = recon.reshape(n_ranges, range_size)
        d_mean = tiles_all.mean(1)
        d_c = tiles_all - d_mean[:, None]
        denom = (d_c * d_c).sum(1)
        valid = denom > 1e-12
        num = ((rr - rr.mean(1, keepdims=True)) * d_c).sum(1)
        s_opt = np.where(valid, num / np.where(valid, denom, 1.0), 0.0)
        if s_damping > 0:
            s_used = (1.0 - s_damping) * s_st + s_damping * s_opt
        else:
            s_used = np.where(valid, s_opt, s_st)
        s_used = np.clip(s_used, -abs(s_clip), abs(s_clip))
        nxt = (s_used[:, None] * tiles_all + o_st[:, None]).reshape(-1)
        dn = np.linalg.norm(recon) or 1.0
        delta = np.linalg.norm(nxt - recon) / dn
        recon = nxt.astype(np.float32)
        if delta < eps:
            break
    if original_len is not None:
        recon = recon[:original_len]
    return recon


def _fixture(seed=0, n_ranges=32, N=4, D=64):
    rng = np.random.default_rng(seed)
    domains = rng.standard_normal((D, N)).astype(np.float32)
    matches = []
    for i in range(n_ranges):
        if i % 7 == 3:
            matches.append((-1, 1.0, 0.0, 0, 0.0))
        else:
            matches.append((
                int(rng.integers(0, D)), float(rng.normal()),
                float(rng.normal()), int(rng.integers(0, 2)),
                float(abs(rng.normal())),
            ))
    return matches, domains


@pytest.mark.parametrize("s_damping", [0.0, 0.3, 0.9])
@pytest.mark.parametrize("iterations", [1, 8])
def test_decode_matches_golden(s_damping, iterations):
    matches, domains = _fixture()
    got = decompress_audio(matches, domains, len(matches), 4,
                           iterations=iterations, s_damping=s_damping)
    want = _golden_decode(matches, domains, len(matches), 4,
                          iterations=iterations, s_damping=s_damping)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_damped_decode_converges_to_stored_transform():
    """With 0 < s_damping < 1 the per-iteration refit converges to the
    STORED transform, i.e. recon -> s*d + o (the true fractal decode)."""
    rng = np.random.default_rng(1)
    D, N, M = 16, 8, 16
    domains = rng.standard_normal((D, N)).astype(np.float32)
    rec = np.zeros(M, dtype=MATCH_DTYPE)
    rec["idx"] = rng.integers(0, D, M)
    rec["s"] = rng.uniform(-2, 2, M).astype(np.float32)
    rec["o"] = rng.uniform(-1, 1, M).astype(np.float32)
    got = decompress_audio(rec, domains, M, N, iterations=200,
                           convergence_eps=1e-12, s_damping=0.5)
    want = (rec["s"][:, None] * domains[rec["idx"]] + rec["o"][:, None]).reshape(-1)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_default_decode_fixed_point_is_offset():
    """s_damping=0: the reconstruction is exactly the stored offsets
    (constant-per-range recon -> refit scale 0; SURVEY-level behavior the
    balanced objective optimizes for)."""
    matches, domains = _fixture(2)
    got = decompress_audio(matches, domains, len(matches), 4, iterations=8)
    o = np.array([m[2] if m[0] >= 0 else 0.0 for m in matches], np.float32)
    np.testing.assert_allclose(got, np.repeat(o, 4), atol=1e-6)


def test_s_clip_applies():
    domains = np.array([[0.0, 1.0, 2.0, 3.0]], dtype=np.float32)
    matches = [(0, 100.0, 0.5, 0, 0.0)]
    got = decompress_audio(matches, domains, 1, 4, iterations=1,
                           s_damping=1e-9, s_clip=2.0)
    # s_used ~ s_stored (heavy damping toward stored at iter 1: (1-d)*100+d*0)
    # clipped to 2.0
    d_c = domains[0] - domains[0].mean()
    want = 2.0 * domains[0] + 0.5
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_original_len_trim_and_zero_ranges():
    matches, domains = _fixture(3, n_ranges=8)
    got = decompress_audio(matches, domains, 8, 4, original_len=13)
    assert got.shape == (13,)
    z = decompress_audio([], np.zeros((0, 4), np.float32), 0, 4, original_len=5)
    np.testing.assert_array_equal(z, np.zeros(5, np.float32))


def test_fixed_point_fast_path_equals_device_loop():
    """The s_damping=0 closed form must match the jitted while_loop decoder
    bit-for-bit (including degenerate constant tiles, where the stored s is
    used and clipped)."""
    rng = np.random.default_rng(7)
    D, N, M = 32, 4, 64
    domains = rng.standard_normal((D, N)).astype(np.float32)
    domains[5] = 3.14          # constant tile -> degenerate denom
    domains[11] = 0.0
    rec = np.zeros(M, dtype=MATCH_DTYPE)
    rec["idx"] = rng.integers(0, D, M)
    rec["idx"][::9] = -1
    rec["idx"][3] = 5          # hits the degenerate tile
    rec["idx"][4] = 11
    rec["s"] = rng.uniform(-30, 30, M).astype(np.float32)  # exercises clip
    rec["o"] = rng.standard_normal(M).astype(np.float32)
    rec["sym"] = rng.integers(0, 2, M).astype(np.uint8)

    fast = decompress_audio(rec, domains, M, N, iterations=8, s_damping=0.0)
    # force the device loop by using an infinitesimal damping (same math as
    # damping 0 only in the limit, so compare against the golden instead)
    golden = _golden_decode(
        [(int(r["idx"]), float(r["s"]), float(r["o"]), int(r["sym"]), 0.0)
         for r in rec],
        domains, M, N, iterations=8, s_damping=0.0,
    )
    np.testing.assert_array_equal(fast, golden)


def test_decoder_config_object():
    from fwav.config import DecoderConfig

    matches, domains = _fixture(4)
    a = decompress_audio(matches, domains, len(matches), 4,
                         config=DecoderConfig(iterations=3, s_damping=0.4))
    b = decompress_audio(matches, domains, len(matches), 4,
                         iterations=3, s_damping=0.4)
    np.testing.assert_array_equal(a, b)


def test_sharded_device_decode_matches_golden(monkeypatch):
    """The damped (device while_loop) decode must shard over ranges without
    changing results — exercised by shrinking DECODE_SHARD_RANGES."""
    import fwav.models.decode as D

    monkeypatch.setattr(D, "DECODE_SHARD_RANGES", 16)
    matches, domains = _fixture(5, n_ranges=50)
    got = decompress_audio(matches, domains, 50, 4, iterations=6, s_damping=0.3)
    want = _golden_decode(matches, domains, 50, 4, iterations=6, s_damping=0.3)
    np.testing.assert_allclose(got, want, atol=1e-4)

    # and the closed-form path shards too
    monkeypatch.setattr(D, "DECODE_SHARD_RANGES", 7)
    got0 = decompress_audio(matches, domains, 50, 4, iterations=8)
    want0 = _golden_decode(matches, domains, 50, 4, iterations=8)
    np.testing.assert_allclose(got0, want0, atol=1e-6)


def test_long_damped_decode_does_not_block_short_decodes(monkeypatch):
    """DEVICE_LOCK is held per decode CHUNK, not across all chunks of a
    file (VERDICT r2 item 6, the same scope fix streaming encode got):
    short damped decodes submitted while a many-chunk decode is in flight
    complete before it finishes instead of starving behind it."""
    import threading

    import fwav.models.decode as D

    monkeypatch.setattr(D, "DECODE_SHARD_RANGES", 256)
    matches, domains = _fixture(6, n_ranges=40)
    long_matches = np.concatenate([matches] * 512)  # 80 chunks of 256
    short_matches = matches

    # warm both compiled cores so the test measures lock scope, not compiles
    decompress_audio(long_matches[:512], domains, 512, 4, iterations=40,
                     s_damping=0.3, convergence_eps=0.0)
    decompress_audio(short_matches, domains, 40, 4, iterations=40,
                     s_damping=0.3, convergence_eps=0.0)

    done = []

    def long_job():
        decompress_audio(long_matches, domains, len(long_matches), 4,
                         iterations=40, s_damping=0.3, convergence_eps=0.0)
        done.append("long")

    t = threading.Thread(target=long_job)
    t.start()
    for i in range(3):
        decompress_audio(short_matches, domains, 40, 4, iterations=40,
                         s_damping=0.3, convergence_eps=0.0)
        done.append(f"short{i}")
    shorts_done_while_long_running = t.is_alive()
    t.join()
    assert shorts_done_while_long_running, (
        "short decodes should finish while the many-chunk decode is still "
        f"in flight; completion order: {done}"
    )


def test_convergence_stats_closed_form():
    """Observability parity with fractal.py:1464-1466: the s_damping=0
    closed form reports the analytic loop counters — iteration 1 lands on
    the fixed point (delta = ||recon||, prev_norm 0 treated as 1),
    iteration 2 reproduces it (delta = 0)."""
    matches, domains = _fixture()
    stats = {}
    recon = decompress_audio(matches, domains, len(matches), 4,
                             iterations=8, s_damping=0.0, stats=stats)
    assert stats == {
        "iterations": 2, "final_delta": 0.0, "converged": True,
    }
    # an eps above ||recon|| converges at the first iteration
    stats = {}
    decompress_audio(matches, domains, len(matches), 4, iterations=8,
                     s_damping=0.0, stats=stats,
                     convergence_eps=float(np.linalg.norm(recon)) * 2)
    assert stats["iterations"] == 1
    assert stats["converged"]
    assert stats["final_delta"] == pytest.approx(float(np.linalg.norm(recon)))
    # zero ranges: nothing ran
    stats = {}
    decompress_audio(np.zeros(0, MATCH_DTYPE), domains, 0, 4,
                     original_len=0, stats=stats)
    assert stats["iterations"] == 0


def test_convergence_stats_damped_loop():
    matches, domains = _fixture()
    stats = {}
    decompress_audio(matches, domains, len(matches), 4, iterations=11,
                     s_damping=0.3, convergence_eps=0.0, stats=stats)
    assert stats["iterations"] == 11  # eps=0 never converges: runs the cap
    assert not stats["converged"]
    assert stats["final_delta"] > 0.0
    stats = {}
    decompress_audio(matches, domains, len(matches), 4, iterations=50,
                     s_damping=0.5, convergence_eps=1e-3, stats=stats)
    assert stats["converged"]
    assert 1 <= stats["iterations"] < 50
    assert stats["final_delta"] < 1e-3
