#!/usr/bin/env python
"""Smoke test of fwav on an NVIDIA GPU: the quickest proof that the system
runs on the card.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi 4  # the sharded paths on 4 cards, nothing else

One process holds the card (a second JAX process on it would fail for want
of memory); the only other process it starts is a CPU-only child
(JAX_PLATFORMS=cpu), which never opens the card.

Phases on one card:
1. device: the gpu backend is required (any other backend exits non-zero
   before any result is printed); prints device kind, count and
   `nvidia-smi --query-gpu=name,power.limit`.
2. kernels: the Pallas (Triton) scan kernel, compiled for the card, vs the
   lax.scan reference (ops.search.gain_topk_scan at Precision.HIGHEST, on
   the card) at production widths: exact top-1 and coarse top-1/top-4 on
   the 10 s fixture, the global-pass top-4 nomination on the 120 s
   fixture, each for the balanced, affine and damped objectives. Scores
   must agree within 1e-5 of the row's best score; indices must agree
   wherever the reference's neighbouring scores differ by more than that.
   Prints the median per-call time of the kernel and of XLA's plain
   version (the lax.scan path at the precision production runs it).
3. round trips: the 10 s fixture through the CLI (default profile and
   --compact, then a bare decompress) on the card and in the CPU child:
   SNR within 0.1 dB, compact ratio within 1%, and the same file decoded
   on both within 1 PCM LSB. Encode wall times with the kernel on and off
   (10 s default, 10 s --compact, 120 s --compact streaming), and the 120 s
   --compact round trip with the kernel on and off: SNRs within 0.1 dB.

--multi N (N cards): make_mesh(N, dp=N) and make_mesh(N, dp=N/2, tp=2) on
the 10 s fixture (default and damped), the 120 s damped streaming encode
and a packed batch of clips, each against a one-card run in this process:
records bit-equal, or (exactly tied selection scores, CLAUDE.md) decoding
within 0.5 LSB; every card must have done work.

The fixtures are generated from a seed (bench.make_signal); nothing is
downloaded. Work files go to .smoke/ in the checkout. The last stdout line
is {"ok": true, "device": {...}} only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
SR = 44100
SHORT_S, LONG_S = 10.0, 120.0
SCORE_RTOL = 1e-5


def say(*parts):
    print(*parts, flush=True)


def require_gpu(n_devices: int):
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"chip_smoke: needs an NVIDIA GPU, but JAX runs on "
                 f"{backend!r}; there is no CPU fallback")
    if len(jax.devices()) < n_devices:
        sys.exit(f"chip_smoke: needs {n_devices} GPUs, found "
                 f"{len(jax.devices())}")
    from fwav.utils.compile_cache import enable_compile_cache

    say(f"compile cache: {enable_compile_cache()}")
    d = jax.devices()[0]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    say(f"device: platform={d.platform} kind={d.device_kind} "
        f"count={len(jax.devices())}")
    say(f"nvidia-smi: {smi}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}, smi


def fixtures():
    """The 10 s and 120 s fixtures as 16-bit WAVs (+ the float signals)."""
    from bench import make_signal
    from fwav.io.wav import write_wav

    os.makedirs(WORK, exist_ok=True)
    out = {}
    for name, secs in (("short", SHORT_S), ("long", LONG_S)):
        sig = make_signal(secs, SR)
        path = os.path.join(WORK, f"{name}.wav")
        write_wav(path, sig, SR, 2)
        out[name] = (path, sig)
    return out


def _median_time(fn, reps=5):
    import jax

    jax.block_until_ready(fn())  # warm-up (compiles)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# --------------------------------------------------------------- kernels


def _scan_operands(sig, stride, nom_bucket=None):
    """Production operands for one scan: centered ranges padded to their
    bucket, the (stride-subsampled) bank, its validity, and the bucket
    sizes, exactly as models.encode / models.stream build them."""
    import jax.numpy as jnp

    from fwav.ops.domains import build_bank_jax, n_domains_for
    from fwav.utils.buckets import bucket

    n, tile = 4, 1024
    x = sig / np.abs(sig).max()
    m = len(x) // n
    mb = bucket(m, 256)
    d = n_domains_for(len(x), tile, 1)
    if nom_bucket:  # models.stream._global_pass buckets the subsampled rows
        db = bucket(-(-d // stride), nom_bucket) * stride
    else:
        db = bucket(d, 256)
    bank = build_bank_jax(jnp.asarray(x), tile, n, 1, db, d)
    valid = jnp.arange(db) < d
    r = np.zeros((mb, n), np.float32)
    r[:m] = x[: m * n].reshape(m, n)
    r_c = jnp.asarray(r - r.mean(1, keepdims=True))
    dc = db // stride
    return (r_c, bank.reshape(dc, stride, n)[:, 0],
            valid.reshape(dc, stride)[:, 0])


def _rescore(r_c, bank, w, t, idx, s_clip):
    """Plain f32 gains at given candidate indices (folded orientation);
    -inf where idx < 0."""
    import jax.numpy as jnp

    from fwav.ops.search import _gain_from_num

    safe = jnp.maximum(idx, 0)
    rows = bank[safe]                                        # (M, K, N)
    num_o = jnp.sum(r_c[:, None, :] * rows, axis=-1)
    num_m = jnp.sum(r_c[:, None, ::-1] * rows, axis=-1)
    wi = w[safe]
    ti = None if t is None else t[safe]
    g = jnp.maximum(_gain_from_num(num_o, wi, ti, s_clip),
                    _gain_from_num(num_m, wi, ti, s_clip))
    return jnp.where(idx >= 0, g, -jnp.inf)


def _chunked(fn, r_c, chunk=32768):
    """lax.map over range chunks, as the encode core runs its search."""
    import jax

    m, n = r_c.shape
    c = min(chunk, m & -m)  # models.encode._pow2_divisor(m, range_block)
    outs = jax.lax.map(fn, r_c.reshape(m // c, c, n))
    return tuple(o.reshape((m,) + o.shape[2:]) for o in outs)


def kernel_case(label, r_c, bank, valid, top_c, objective, xla_precision):
    import jax

    from fwav.ops import pallas_search
    from fwav.ops.affine import affine_stats
    from fwav.ops.search import domain_thresh, domain_weights, gain_topk_scan

    s_clip = 16.0
    dm, dd = affine_stats(bank)
    w = domain_weights(dm, dd, r_c.shape[1], objective)
    t = domain_thresh(dd, objective, s_clip)
    dblk = min(2048, bank.shape[0] & -bank.shape[0])

    @jax.jit
    def kern(r_c):
        return _chunked(lambda rc: pallas_search.scan_topc(
            rc, bank, w, valid, top_c, d_thresh=t, s_clip=s_clip), r_c)

    def xla_fn(precision, k):
        @jax.jit
        def f(r_c):
            return _chunked(lambda rc: (gain_topk_scan(
                rc, bank, w, valid, k, dblk, d_thresh=t, s_clip=s_clip,
                precision=precision),), r_c)[0]
        return f

    xla_plain = xla_fn(xla_precision, top_c)
    oracle = xla_fn(jax.lax.Precision.HIGHEST, top_c + 1)

    ks, ki = (np.asarray(a) for a in kern(r_c))
    oi = oracle(r_c)
    os_ = np.asarray(jax.jit(_rescore, static_argnums=5)(
        r_c, bank, w, t, oi, s_clip))
    oi = np.asarray(oi)
    scale = np.maximum(np.abs(os_[:, :1]), 1e-30)
    fin = np.isfinite(os_[:, :top_c])
    same_inf = np.array_equal(fin, np.isfinite(ks))
    err = np.where(fin, np.abs(ks - os_[:, :top_c]) / scale, 0.0)
    gap_next = (os_[:, :top_c] - os_[:, 1:]) > SCORE_RTOL * scale
    gap_prev = np.ones_like(gap_next)
    gap_prev[:, 1:] = gap_next[:, :-1]
    decisive = gap_next & gap_prev & fin
    idx_ok = np.array_equal(ki[decisive], oi[:, :top_c][decisive])
    equal_share = float((ki == oi[:, :top_c]).mean())
    ok = same_inf and float(err.max()) <= SCORE_RTOL and idx_ok
    t_k = _median_time(lambda: kern(r_c))
    t_x = _median_time(lambda: xla_plain(r_c))
    say(f"kernel {label} {objective}: M={r_c.shape[0]} D={bank.shape[0]} "
        f"C={top_c} max_score_err={float(err.max()):.3g} "
        f"idx_equal_where_decisive={idx_ok} equal_share={equal_share:.6f} "
        f"kernel_ms={t_k * 1e3:.3f} xla_ms={t_x * 1e3:.3f} "
        f"({xla_precision}) {'ok' if ok else 'FAILED'}")
    return ok


def phase_kernels(fx):
    import jax

    coarse = _scan_operands(fx["short"][1], 128)
    # the global pass: EncoderConfig.global_stride (512 stays 512 at 120 s)
    nominate = _scan_operands(fx["long"][1], 512, nom_bucket=16)
    highest, default = jax.lax.Precision.HIGHEST, jax.lax.Precision.DEFAULT
    cases = [
        # exact_search_block runs its scan at HIGHEST; the lobe scans at
        # DEFAULT (TF32 on the H100)
        ("exact_top1_10s", _scan_operands(fx["short"][1], 1), 1, highest),
        ("coarse_top1_10s", coarse, 1, default),
        ("coarse_top4_10s", coarse, 4, default),
        ("global_top4_120s", nominate, 4, default),
    ]
    ok = True
    for label, (r_c, bank, valid), top_c, prec in cases:
        for objective in ("balanced", "affine", "damped"):
            ok &= kernel_case(label, r_c, bank, valid, top_c, objective, prec)
    return ok


# ----------------------------------------------------------- round trips


def _cli(*argv):
    from fwav.cli import main

    t0 = time.perf_counter()
    rc = main([str(a) for a in argv])
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"fwav {' '.join(map(str, argv))} exited {rc}")
    return dt


def _snr(wav_a, wav_b):
    from fwav.io.wav import read_wav_mono
    from fwav.utils.metrics import compute_snr

    return compute_snr(read_wav_mono(wav_a)[0], read_wav_mono(wav_b)[0])


def _pcm_diff(wav_a, wav_b):
    from fwav.io.wav import read_wav_mono

    a, b = read_wav_mono(wav_a)[0], read_wav_mono(wav_b)[0]
    return float(np.max(np.abs(a.astype(np.float64) - b))) if len(a) else 0.0


def _ratio(wav, fwav):
    return os.path.getsize(wav) / os.path.getsize(fwav)


def cli_round_trips(wav, tag):
    """Default profile and --compact through the CLI, then a bare
    decompress of each; returns {profile: (fwav, recon, enc_s, dec_s)}."""
    out = {}
    for profile, flags in (("default", []), ("compact", ["--compact"])):
        fw = os.path.join(WORK, f"short_{profile}_{tag}.fwav")
        rw = os.path.join(WORK, f"short_{profile}_{tag}.recon.wav")
        enc = _cli("compress", wav, fw, *flags)
        dec = _cli("decompress", fw, "--out", rw)
        out[profile] = (fw, rw, enc, dec)
    return out


def cpu_child():
    """Runs in the CPU-only child: the same CLI round trips, plus a decode
    of the card's containers; prints one JSON line."""
    import jax

    assert jax.default_backend() == "cpu", jax.default_backend()
    wav = os.path.join(WORK, "short.wav")
    res = {}
    for profile, (fw, rw, enc, dec) in cli_round_trips(wav, "cpu").items():
        gpu_fw = os.path.join(WORK, f"short_{profile}_gpu.fwav")
        cross = os.path.join(WORK, f"short_{profile}_gpu_on_cpu.recon.wav")
        _cli("decompress", gpu_fw, "--out", cross)
        res[profile] = dict(snr=_snr(wav, rw), ratio=_ratio(wav, fw),
                            encode_s=enc, decode_s=dec, cross=cross)
    print(json.dumps(res), flush=True)


def _encode_file(wav, out, compact, use_pallas, streaming):
    """process_file_compress as the CLI calls it, with the kernel forced on
    or off (EncoderConfig.use_pallas)."""
    from fwav.config import EncoderConfig
    from fwav.models.codec import process_file_compress

    objective = "damped" if compact else "balanced"
    kw = dict(objective=objective)
    if streaming:
        kw["use_pallas"] = use_pallas
    else:
        kw["config"] = EncoderConfig(objective=objective, use_pallas=use_pallas)
    t0 = time.perf_counter()
    r = process_file_compress(wav, out, prune_bank=True, compact=compact, **kw)
    dt = time.perf_counter() - t0
    if "error" in r:
        raise RuntimeError(f"encode {wav}: {r['error']}")
    return dt


def phase_round_trips(fx, card, gpu_runs, child):
    ok = True
    wav = fx["short"][0]
    # the CPU child was started after the card's CLI runs; collect it first
    out, err = child.communicate(timeout=900)
    if child.returncode != 0:
        say(f"cpu child failed ({child.returncode}):\n{err[-4000:]}")
        return False
    cpu = json.loads(out.strip().splitlines()[-1])
    for profile, (fw, rw, enc, dec) in gpu_runs.items():
        snr_g = _snr(wav, rw)
        c = cpu[profile]
        lsb = _pcm_diff(rw, c["cross"])
        d_snr = abs(snr_g - c["snr"])
        d_ratio = abs(_ratio(wav, fw) / c["ratio"] - 1.0)
        good = d_snr <= 0.1 and d_ratio <= 0.01 and lsb <= 1.0
        ok &= good
        say(f"round trip 10s {profile}: snr_gpu={snr_g:.4f} "
            f"snr_cpu={c['snr']:.4f} ratio_gpu={_ratio(wav, fw):.4f} "
            f"ratio_cpu={c['ratio']:.4f} same_file_decode_max_lsb={lsb:g} "
            f"encode_s gpu={enc:.3f} cpu={c['encode_s']:.3f} "
            f"decode_s gpu={dec:.3f} cpu={c['decode_s']:.3f} [{card}] "
            f"{'ok' if good else 'FAILED'}")

    # end to end with the kernel on and off, in turns (off, on, on, off) x 2
    runs = (("10s default", fx["short"][0], False, False),
            ("10s compact", fx["short"][0], True, False),
            ("120s compact", fx["long"][0], True, True))
    outs = {}
    for label, wav_i, compact, streaming in runs:
        times = {False: [], True: []}
        for flag in (False, True):  # warm-up: compile both programs
            _encode_file(wav_i, os.path.join(WORK, "warm.fwav"), compact,
                         flag, streaming)
        for flag in (False, True, True, False) * 2:
            fw = os.path.join(WORK, f"e2e_{len(outs)}_{int(flag)}.fwav")
            times[flag].append(_encode_file(wav_i, fw, compact, flag,
                                            streaming))
            outs[(label, flag)] = fw
        say(f"encode wall {label}: kernel_on_s={np.median(times[True]):.4f} "
            f"kernel_off_s={np.median(times[False]):.4f} "
            f"(runs on={[round(t, 4) for t in times[True]]} "
            f"off={[round(t, 4) for t in times[False]]}) [{card}]")

    # the 120 s --compact streaming round trip through the CLI (kernel on,
    # the gpu default) and with the kernel off
    long_wav = fx["long"][0]
    fw_on = os.path.join(WORK, "long_compact_gpu.fwav")
    rw_on = os.path.join(WORK, "long_compact_gpu.recon.wav")
    enc = _cli("compress", long_wav, fw_on, "--compact")
    dec = _cli("decompress", fw_on, "--out", rw_on)
    rw_off = os.path.join(WORK, "long_compact_off.recon.wav")
    dec_off = _cli("decompress", outs[("120s compact", False)], "--out", rw_off)
    snr_on, snr_off = _snr(long_wav, rw_on), _snr(long_wav, rw_off)
    good = abs(snr_on - snr_off) <= 0.1
    ok &= good
    say(f"round trip 120s compact: snr_kernel_on={snr_on:.4f} "
        f"snr_kernel_off={snr_off:.4f} ratio={_ratio(long_wav, fw_on):.4f} "
        f"encode_s={enc:.3f} decode_s={dec:.3f} decode_off_s={dec_off:.3f} "
        f"[{card}] {'ok' if good else 'FAILED'}")
    return ok


def run_one_card():
    device, card = require_gpu(1)
    fx = fixtures()
    # the card's CLI runs first: the CPU child decodes their containers
    gpu_runs = cli_round_trips(fx["short"][0], "gpu")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-child"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    try:
        ok_k = phase_kernels(fx)
        ok_r = phase_round_trips(fx, card, gpu_runs, child)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    return device, ok_k and ok_r


# ------------------------------------------------------------ four cards


def _records_match(got, want, decode_damping, signal):
    """Bit-equal records, or decodes within 0.5 LSB (the exactly tied
    selection scores of CLAUDE.md's carve-out)."""
    from fwav.models.decode import decompress_audio
    from fwav.ops.domains import build_domains_host

    rec_g, rec_w = got[0], want[0]
    same = all(np.array_equal(rec_g[f], rec_w[f])
               for f in ("idx", "s", "o", "sym", "err"))
    if same:
        return True, "bit-equal"
    n_diff = int(np.sum(rec_g["idx"] != rec_w["idx"]))
    bank = want[1]
    if bank is None:  # streaming returns no bank: rebuild the full one
        bank = build_domains_host(signal, want[4], want[3], want[5])
    kw = dict(original_len=want[7], s_damping=decode_damping)
    a = decompress_audio(rec_g, bank, got[2], got[3], **kw)
    b = decompress_audio(rec_w, bank, want[2], want[3], **kw)
    lsb = float(np.max(np.abs(np.asarray(a, np.float64) - b)))
    return lsb <= 0.5, f"{n_diff} records differ, decode max {lsb:g} LSB"


def run_multi(n):
    import jax

    from fwav.config import DAMPED_DECODE_DAMPING
    from fwav.models.encode import compress_audio_arrays, compress_audio_packed
    from fwav.models.stream import compress_audio_streaming
    from fwav.parallel.mesh import make_mesh
    from fwav.parallel.shard import compress_audio_sharded

    device, card = require_gpu(n)
    device["count"] = n
    fx = fixtures()
    short, long_ = fx["short"][1], fx["long"][1]
    meshes = [(n, 1), (n // 2, 2)]
    clips = [long_[k * SR: k * SR + s * SR].copy()
             for k, s in ((0, 2), (5, 3), (11, 5), (20, 3), (30, 7), (41, 2))]

    def timed(fn):
        fn()  # compile
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    ok = True
    for obj, damp in (("balanced", 0.0), ("damped", DAMPED_DECODE_DAMPING)):
        want, t1 = timed(lambda: compress_audio_arrays(short, SR, 2,
                                                       objective=obj))
        for dp, tp in meshes:
            mesh = make_mesh(n, dp=dp, tp=tp)
            got, tn = timed(lambda: compress_audio_sharded(
                short, SR, 2, mesh=mesh, objective=obj))
            good, how = _records_match(got, want, damp, short)
            ok &= good
            say(f"multi 10s {obj} dp={dp} tp={tp}: {how} "
                f"encode_s one_card={t1:.4f} mesh={tn:.4f} [{card}] "
                f"{'ok' if good else 'FAILED'}")
    want, t1 = timed(lambda: compress_audio_streaming(long_, SR, 2,
                                                      objective="damped"))
    for dp, tp in meshes:
        mesh = make_mesh(n, dp=dp, tp=tp)
        got, tn = timed(lambda: compress_audio_streaming(
            long_, SR, 2, objective="damped", mesh=mesh))
        good, how = _records_match(got, want, DAMPED_DECODE_DAMPING, long_)
        ok &= good
        say(f"multi 120s streaming damped dp={dp} tp={tp}: {how} "
            f"encode_s one_card={t1:.4f} mesh={tn:.4f} [{card}] "
            f"{'ok' if good else 'FAILED'}")
    want, t1 = timed(lambda: compress_audio_packed(clips, SR, 2))
    for dp, tp in meshes:
        mesh = make_mesh(n, dp=dp, tp=tp)
        got, tn = timed(lambda: compress_audio_packed(clips, SR, 2, mesh=mesh))
        res = [_records_match(g, w, 0.0, c)
               for g, w, c in zip(got, want, clips)]
        good = all(r[0] for r in res)
        ok &= good
        say(f"multi packed {len(clips)} clips dp={dp} tp={tp}: "
            f"{sorted(set(r[1] for r in res))} encode_s one_card={t1:.4f} "
            f"mesh={tn:.4f} [{card}] {'ok' if good else 'FAILED'}")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in jax.devices()[:n]]
    spread = min(peaks[1:]) > (1 << 20)
    ok &= spread
    say(f"multi per-card peak bytes: {peaks} "
        f"{'ok' if spread else 'FAILED: work stayed on device 0'}")
    return device, ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", type=int, default=0, metavar="N",
                    help="run only the sharded paths on N cards")
    ap.add_argument("--cpu-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cpu_child:
        cpu_child()
        return 0
    device, ok = run_multi(args.multi) if args.multi else run_one_card()
    if not ok:
        say("chip_smoke: FAILED (see the lines above)")
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
