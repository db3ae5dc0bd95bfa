"""Streaming global-candidate pass (VERDICT r3 item 5).

The time-sharded encoder restricts each shard's search to its halo window,
which starves the clip-aware "damped" objective on content whose
self-similarity is not local (31.4 dB vs the 40.2 dB whole-file oracle on
the 100 s bench fixture). The recovery (models.stream._global_pass): ONE
extra device dispatch (models.encode mode="global") nominates top-C
whole-file windows per range on the stride-subsampled bank, refines each at
full resolution, compares against the shard-local winner on device, and the
host refits only the winning indices against the serialized bank — measured
38.6 dB on the 100 s fixture. Reference anchor: fractal.py:556-632 searches
the full bank for every range; streaming alone doesn't.
"""

import numpy as np
import pytest

from fwav import compute_snr, decompress_audio
from fwav.models.stream import (
    compress_audio_streaming,
    domain_block_iter,
)

KW = dict(tile_size=128, shard_samples=4096, halo=2048, objective="damped")


def _sig(seconds=1.5, sr=8000, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    sig = 0.4 * np.sin(2 * np.pi * 310 * t) + 0.12 * np.sin(2 * np.pi * 1100 * t)
    sig += 0.02 * rng.standard_normal(len(t))
    sig[int(0.6 * sr) : int(0.72 * sr)] = 0.0  # silence -> sentinels
    return np.round(sig * 12000).astype(np.float32), sr


@pytest.fixture(scope="module")
def enc():
    sig, sr = _sig()
    on = compress_audio_streaming(sig, sr, 2, **KW)
    off = compress_audio_streaming(sig, sr, 2, global_candidates=False, **KW)
    return sig, sr, on, off


def _decode(sig, res):
    rec, _, n_ranges, rs, tile, step, _, olen = res
    bank = np.concatenate(list(domain_block_iter(sig, tile, rs, step)))
    return decompress_audio(
        rec, bank, n_ranges, rs, original_len=olen, s_damping=0.25
    )


def test_global_pass_improves_damped_snr():
    # the halo has to HURT for the pass to show: at the default tile (1024)
    # a slowly-modulated partial needs remote candidates (measured 19.2 vs
    # 12.3 dB); the small-tile module fixture is halo-insensitive
    rng = np.random.default_rng(0)
    sr = 8000
    t = np.arange(sr * 3) / sr
    sig = (
        0.5 * np.sin(2 * np.pi * 220 * t)
        + 0.2 * np.sin(2 * np.pi * 2213 * t * (1 + 0.2 * np.sin(2 * np.pi * 0.5 * t)))
        + 0.01 * rng.standard_normal(sr * 3)
    ).astype(np.float32)
    kw = dict(shard_samples=1 << 13, halo=1 << 12, objective="damped")
    on = compress_audio_streaming(sig, sr, 2, **kw)
    off = compress_audio_streaming(sig, sr, 2, global_candidates=False, **kw)
    snr_on = compute_snr(sig, _decode(sig, on))
    snr_off = compute_snr(sig, _decode(sig, off))
    assert snr_on > snr_off + 3.0, (snr_on, snr_off)
    # the pass may only SWAP matches, never invalidate the record layout
    rec_on, rec_off = on[0], off[0]
    assert len(rec_on) == len(rec_off)
    # sentinels (energy-pruned ranges) are never resurrected by the merge
    np.testing.assert_array_equal(rec_on["idx"] == -1, rec_off["idx"] == -1)


def test_global_pass_auto_gate(enc):
    sig, sr, on, off = enc
    # damped default = auto-on: explicit True is the same encode
    explicit = compress_audio_streaming(
        sig, sr, 2, global_candidates=True, **KW
    )
    np.testing.assert_array_equal(explicit[0], on[0])
    assert np.any(on[0]["idx"] != off[0]["idx"])  # the pass changed records

    # balanced default = auto-off (halo-insensitive objective)
    kw = dict(KW, objective="balanced")
    base = compress_audio_streaming(sig, sr, 2, **kw)
    forced_off = compress_audio_streaming(
        sig, sr, 2, global_candidates=False, **kw
    )
    np.testing.assert_array_equal(base[0], forced_off[0])


@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 4)])
def test_global_pass_mesh_bit_equal(dp, tp, enc):
    # pair slabs split over every device (flat dp x tp); the per-pair
    # program is identical at every sharding and the merge is host-side
    # float64, so records stay bit-equal to single-device
    from fwav.parallel.mesh import make_mesh

    sig, sr, on, _ = enc
    mesh = make_mesh(dp * tp, dp=dp, tp=tp)
    got = compress_audio_streaming(sig, sr, 2, mesh=mesh, **KW)
    np.testing.assert_array_equal(got[0], on[0])


def test_global_pass_resume(tmp_path, enc):
    # per-shard checkpoints store PRE-pass local records; the pass re-runs
    # deterministically on resume, so resumed records match exactly
    sig, sr, on, _ = enc
    rdir = str(tmp_path / "ckpt")
    first = compress_audio_streaming(sig, sr, 2, resume_dir=rdir, **KW)
    np.testing.assert_array_equal(first[0], on[0])

    resumed = compress_audio_streaming(sig, sr, 2, resume_dir=rdir, **KW)
    np.testing.assert_array_equal(resumed[0], on[0])


def test_global_pass_auto_stride_valve(monkeypatch):
    # forcing a tiny nomination-grid cap doubles the stride (the long-file
    # cost valve); the pass still runs and still helps
    import fwav.models.stream as stream_mod

    sig, sr = _sig(seconds=1.0, seed=5)
    monkeypatch.setattr(stream_mod, "GLOBAL_NOM_ROWS", 2)
    on = compress_audio_streaming(sig, sr, 2, **KW)
    off = compress_audio_streaming(sig, sr, 2, global_candidates=False, **KW)
    assert np.any(on[0]["idx"] != off[0]["idx"])
    snr_on = compute_snr(sig, _decode(sig, on))
    snr_off = compute_snr(sig, _decode(sig, off))
    assert snr_on >= snr_off - 1e-6, (snr_on, snr_off)


def test_global_pass_device_budget_skip(monkeypatch, enc):
    # beyond the whole-file device budget the pass degrades to the
    # halo-local search (with a warning), never to an error
    import fwav.models.stream as stream_mod

    sig, sr, on, off = enc
    monkeypatch.setattr(stream_mod, "GLOBAL_PASS_MAX_ROWS", 1)
    skipped = compress_audio_streaming(sig, sr, 2, **KW)
    np.testing.assert_array_equal(skipped[0], off[0])


def test_global_pass_mesh_resume_compose(tmp_path, enc):
    # mesh x resume x global pass: checkpoints written under a mesh are
    # pre-pass local records; a resumed mesh encode re-runs the pass and
    # reproduces the single-device records bit for bit
    from fwav.parallel.mesh import make_mesh

    sig, sr, on, _ = enc
    rdir = str(tmp_path / "ckpt")
    mesh = make_mesh(4, dp=2, tp=2)
    first = compress_audio_streaming(sig, sr, 2, mesh=mesh, resume_dir=rdir,
                                     **KW)
    np.testing.assert_array_equal(first[0], on[0])
    resumed = compress_audio_streaming(sig, sr, 2, mesh=mesh,
                                       resume_dir=rdir, **KW)
    np.testing.assert_array_equal(resumed[0], on[0])


def test_bank_rows_host_scattered_matches_2d_gather():
    # the column-looped scattered path (21x faster at millions of rows)
    # must stay bit-identical to the plain 2-D fancy-index formula
    from fwav.ops.domains import bank_rows_host

    rng = np.random.default_rng(2)
    signal = rng.standard_normal(50_000).astype(np.float32)
    tile, n, step = 1024, 4, 2
    block = tile // n
    d = (50_000 - tile) // step + 1
    rows = np.unique(rng.integers(0, d, 5_000).astype(np.int64))
    got = bank_rows_host(signal, tile, n, step, rows)
    cs = np.zeros(len(signal) + 1, np.float64)
    np.cumsum(signal, dtype=np.float64, out=cs[1:])
    starts = rows[:, None] * step + np.arange(n, dtype=np.int64)[None, :] * block
    want = ((cs[starts + block] - cs[starts]) / block).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_global_pass_pallas_nomination_kernel(kernel_interpret):
    # with use_pallas forced on (the kernel interpreted explicitly) the
    # pass's nomination runs through the fused top-C scan kernel; the
    # resulting records must keep the sentinel discipline and quality
    # parity with the lax.scan nomination (selection-grade agreement —
    # near-ties may differ, the decode metric may not)
    from fwav.config import EncoderConfig

    sig, sr = _sig(seconds=1.0, seed=7)
    base_cfg = dict(tile_size=128, objective="damped")
    kw = dict(shard_samples=4096, halo=2048)
    want = compress_audio_streaming(
        sig, sr, 2, config=EncoderConfig(use_pallas=False, **base_cfg), **kw,
    )
    assert kernel_interpret["scan_topc"] == 0
    got = compress_audio_streaming(
        sig, sr, 2, config=EncoderConfig(use_pallas=True, **base_cfg), **kw,
    )
    assert kernel_interpret["scan_topc"] >= 1
    snr_w = compute_snr(sig, _decode(sig, want))
    snr_g = compute_snr(sig, _decode(sig, got))
    assert abs(snr_w - snr_g) < 0.5, (snr_w, snr_g)
    np.testing.assert_array_equal(got[0]["idx"] == -1, want[0]["idx"] == -1)


def test_global_pass_int32_protocol_branch(monkeypatch, enc):
    # whole-file banks past PACK3_MAX_ROWS switch both pass transfers to
    # int32; forcing the threshold to 0 must reproduce the 3-byte-protocol
    # records bit for bit (only the transport encoding changes)
    import fwav.models.encode as encode_mod
    from fwav.models.encode import _encode_core, _encode_core_chunked

    sig, sr, on, _ = enc
    monkeypatch.setattr(encode_mod, "PACK3_MAX_ROWS", 0)
    _encode_core.cache_clear()
    _encode_core_chunked.cache_clear()
    try:
        got = compress_audio_streaming(sig, sr, 2, **KW)
        np.testing.assert_array_equal(got[0], on[0])
    finally:
        _encode_core.cache_clear()
        _encode_core_chunked.cache_clear()


def test_streaming_phase_timings_cover_the_pass():
    # the tracing subsystem (SURVEY §5) must see the streaming stages,
    # including the global pass, so slow encodes are attributable
    from fwav.utils.trace import collect_phases

    sig, sr = _sig(seconds=1.0, seed=5)
    with collect_phases() as phases:
        compress_audio_streaming(sig, sr, 2, **KW)
    for key in ("vad", "dispatch", "fetch_wait", "host_refit",
                "global_pass"):
        assert phases.get(key, 0) > 0, (key, phases)


@pytest.mark.parametrize("seed", range(4))
def test_global_pass_geometry_fuzz(seed):
    # random length / shard / halo / tile geometry: the pass must keep its
    # invariants on awkward shapes — odd lengths, tail shards, halos
    # smaller than the refine window, strides near the bank size
    rng = np.random.default_rng(100 + seed)
    sr = 8000
    n_samp = int(rng.integers(6000, 26000)) | 1  # odd length
    t = np.arange(n_samp) / sr
    f0 = float(rng.uniform(150, 500))
    sig = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(
        2 * np.pi * (900 + 300 * np.sin(2 * np.pi * 0.4 * t)) * t
    )
    sig += 0.02 * rng.standard_normal(n_samp)
    gap = int(rng.integers(0, n_samp // 2))
    sig[gap : gap + n_samp // 10] = 0.0
    sig = np.round(sig * 12000).astype(np.float32)
    kw = dict(
        tile_size=int(rng.choice([128, 256])),
        shard_samples=int(rng.choice([2048, 4096, 8192])),
        halo=int(rng.choice([1024, 2048])),
        objective="damped",
    )
    on = compress_audio_streaming(sig, sr, 2, **kw)
    off = compress_audio_streaming(sig, sr, 2, global_candidates=False, **kw)
    rec_on, rec_off = on[0], off[0]
    assert len(rec_on) == len(rec_off) == on[2]
    # sentinels never resurrected; every rewritten row is a valid domain
    np.testing.assert_array_equal(rec_on["idx"] == -1, rec_off["idx"] == -1)
    from fwav.ops.domains import n_domains_for

    d_total = n_domains_for(len(sig), kw["tile_size"], on[5])
    live = rec_on["idx"] >= 0
    assert live.any()
    assert rec_on["idx"][live].max() < d_total
    # quality never degrades measurably
    snr_on = compute_snr(sig, _decode(sig, on))
    snr_off = compute_snr(sig, _decode(sig, off))
    assert snr_on >= snr_off - 0.01, (snr_on, snr_off)
    # and the mesh path stays bit-equal on this random geometry
    if seed == 0:
        from fwav.parallel.mesh import make_mesh

        got = compress_audio_streaming(
            sig, sr, 2, mesh=make_mesh(4, dp=2, tp=2), **kw
        )
        np.testing.assert_array_equal(got[0], rec_on)


def test_global_pass_winners_strictly_improve():
    # every range the pass rewrites must strictly beat its local match on
    # the decode-relevant metric: the exact refit against the serialized
    # bank rows (the host-refit stored err)
    sig, sr = _sig(seconds=1.0, seed=11)
    on = compress_audio_streaming(sig, sr, 2, **KW)
    off = compress_audio_streaming(sig, sr, 2, global_candidates=False, **KW)
    rec_on, rec_off = on[0], off[0]
    changed = rec_on["idx"] != rec_off["idx"]
    assert changed.any()
    live = rec_off["idx"] >= 0
    assert not (changed & ~live).any()  # sentinels never resurrected
    # the damped objective maximizes clip-aware gain, which lowers the
    # clipped-refit residual; spot-check via the stored err of the refit
    worse = changed & (rec_on["err"] > rec_off["err"] + 1e-4)
    assert worse.mean() < 0.05, worse.mean()
