"""Packed batch encode (models.encode.compress_audio_packed; CLI
`compress --batch --packed`).

One vmapped device dispatch encodes a stack of same-bucket files,
amortizing the per-dispatch transport round trip that bounds small-file
batch throughput. Records must match the single-shot encoder's exactly on
tie-free content; the host refit/bank protocol is shared
(_finalize_encode). Replaces the reference's file-level
multiprocessing.Pool (fractal.py:1605-1617) with one SPMD program.
"""

import json

import numpy as np
import pytest

from fwav import compress_audio_arrays, compress_audio_packed


def _sigs():
    rng = np.random.default_rng(4)
    sigs = []
    for k in range(5):
        n = 16000 + 700 * k  # varied lengths; first few share buckets
        t = np.arange(n) / 16000
        s = 0.4 * np.sin(2 * np.pi * (300 + 40 * k) * t)
        s += 0.01 * rng.standard_normal(n)
        s[2000:3000] = 0.0
        sigs.append(np.round(s * 16000).astype(np.float32))
    sigs.append(np.zeros(0, np.float32))      # empty input
    sigs.append(np.zeros(8000, np.float32))   # all-silent input
    sigs.append((rng.standard_normal(9000) * 0.3).astype(np.float32))  # float
    return sigs


def test_packed_matches_single_shot():
    sigs = _sigs()
    packed = compress_audio_packed(sigs, 16000, 2, tile_size=128)
    for i, sig in enumerate(sigs):
        single = compress_audio_arrays(sig, 16000, 2, tile_size=128)
        for f in ("idx", "s", "o", "sym", "err"):
            np.testing.assert_array_equal(
                packed[i][0][f], single[0][f], err_msg=f"file {i} field {f}"
            )
        np.testing.assert_array_equal(packed[i][1], single[1])
        assert packed[i][2:] == single[2:]


def test_packed_order_and_pack_boundary():
    # >PACK_B_MAX same-bucket files: exercises chunking + pow2 padding and
    # proves results return in input order
    from fwav.models.encode import PACK_B_MAX

    rng = np.random.default_rng(9)
    n = 12000
    t = np.arange(n) / 16000
    sigs = [
        np.round(
            (0.3 * np.sin(2 * np.pi * (200 + 17 * k) * t)
             + 0.01 * rng.standard_normal(n)) * 16000
        ).astype(np.float32)
        for k in range(PACK_B_MAX + 3)
    ]
    packed = compress_audio_packed(sigs, 16000, 2, tile_size=128)
    for k in (0, PACK_B_MAX - 1, PACK_B_MAX, PACK_B_MAX + 2):
        single = compress_audio_arrays(sigs[k], 16000, 2, tile_size=128)
        np.testing.assert_array_equal(packed[k][0]["idx"], single[0]["idx"])
        np.testing.assert_array_equal(packed[k][0]["o"], single[0]["o"])


def test_cli_packed_batch(tmp_path):
    from fwav.cli import main as cli_main
    from fwav.io.container import load_compressed_arrays
    from fwav.io.wav import write_wav

    rng = np.random.default_rng(11)
    indir = tmp_path / "wavs"
    indir.mkdir()
    n = 14000
    t = np.arange(n) / 16000
    for k in range(4):
        s = 0.4 * np.sin(2 * np.pi * (250 + 30 * k) * t)
        s += 0.01 * rng.standard_normal(n)
        write_wav(indir / f"f{k}.wav", np.round(s * 16000).astype(np.float32),
                  16000, 2)
    (indir / "broken.wav").write_bytes(b"RIFFgarbage")
    out = tmp_path / "out"
    cli_main(["compress", str(indir), "--batch", "--packed", "--out",
              str(out), "--tile", "128"])
    metrics = json.loads((out / "compression_metrics.json").read_text())
    ok = [m for m in metrics if "error" not in m]
    bad = [m for m in metrics if "error" in m]
    assert len(ok) == 4 and len(bad) == 1
    assert all(m.get("packed") for m in ok)
    for m in ok:
        rec, bank, n_r, N, sr, sw, *_ = load_compressed_arrays(m["output"])
        assert sr == 16000 and sw == 2 and n_r > 0
    # skip-resume parity: second run finds nothing to do
    cli_main(["compress", str(indir), "--batch", "--packed", "--out",
              str(out), "--tile", "128"])


def test_packed_routes_long_files_to_streaming(tmp_path, monkeypatch):
    # a "long" file (over STREAMING_THRESHOLD) in a packed batch must take
    # the single-file streaming path instead of sinking the whole run on
    # the packed encoder's index-range check
    import fwav.models.codec as codec
    from fwav.io.container import load_compressed_arrays
    from fwav.io.wav import write_wav
    from fwav.models.codec import process_files_compress_packed

    monkeypatch.setattr(codec, "STREAMING_THRESHOLD", 8000)
    rng = np.random.default_rng(13)
    t_long = np.arange(20000) / 16000
    t_short = np.arange(6000) / 16000
    write_wav(tmp_path / "long.wav", np.round(
        (0.4 * np.sin(2 * np.pi * 300 * t_long)
         + 0.01 * rng.standard_normal(len(t_long))) * 16000
    ).astype(np.float32), 16000, 2)
    write_wav(tmp_path / "short.wav", np.round(
        (0.4 * np.sin(2 * np.pi * 400 * t_short)
         + 0.01 * rng.standard_normal(len(t_short))) * 16000
    ).astype(np.float32), 16000, 2)
    jobs = [
        (str(tmp_path / "long.wav"), str(tmp_path / "long.fwav")),
        (str(tmp_path / "short.wav"), str(tmp_path / "short.fwav")),
    ]
    results = process_files_compress_packed(jobs, tile=128)
    assert all("error" not in r for r in results)
    assert not results[0].get("packed") and results[1].get("packed")
    for _, out in jobs:
        rec, *_ = load_compressed_arrays(out)
        assert (rec["idx"] >= 0).any()


def test_packed_falls_back_per_file_on_encoder_failure(tmp_path, monkeypatch):
    # packed-encode failure must resolve blame per file, not sink the batch
    import fwav.models.encode as encode
    from fwav.io.wav import write_wav
    from fwav.models.codec import process_files_compress_packed

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(encode, "compress_audio_packed", boom)
    t = np.arange(6000) / 16000
    write_wav(tmp_path / "a.wav",
              np.round(0.4 * np.sin(2 * np.pi * 330 * t) * 16000)
              .astype(np.float32), 16000, 2)
    jobs = [(str(tmp_path / "a.wav"), str(tmp_path / "a.fwav"))]
    results = process_files_compress_packed(jobs, tile=128)
    assert "error" not in results[0] and not results[0].get("packed")


def test_cli_packed_flag_conflicts():
    from fwav.cli import main as cli_main

    with pytest.raises(SystemExit):
        cli_main(["compress", "in.wav", "out.fwav", "--packed"])
    with pytest.raises(SystemExit):  # tp must divide devices, packed too
        cli_main(["compress", "d", "--batch", "--packed", "--devices", "3",
                  "--tp", "2"])


def test_packed_file_dp_bit_equal():
    # FILE-level data parallelism: the packed stack's batch axis shards
    # over the whole mesh (whole files per device, zero communication) —
    # records bit-equal to the unsharded packed dispatch, every input
    # shape class included (empty / all-silent / float / mixed buckets)
    from fwav.parallel.mesh import make_mesh

    sigs = _sigs()
    want = compress_audio_packed(sigs, 16000, 2)
    for dp, tp in ((8, 1), (2, 2)):
        mesh = make_mesh(dp * tp, dp=dp, tp=tp)
        got = compress_audio_packed(sigs, 16000, 2, mesh=mesh)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
            assert g[2:] == w[2:]


def test_packed_devices_overask_fails_cleanly(tmp_path):
    # asking for more devices than exist must produce per-file error dicts
    # and exit code 1 — not an uncaught traceback (the single-file path's
    # contract)
    from fwav.cli import main as cli_main
    from fwav.io.wav import write_wav

    write_wav(tmp_path / "a.wav", np.zeros(8000, np.float32), 16000, 2)
    rc = cli_main(["compress", str(tmp_path), "--batch", "--packed",
                   "--devices", "64", "--out", str(tmp_path / "out")])
    assert rc == 1
    metrics = json.loads(
        (tmp_path / "out" / "compression_metrics.json").read_text()
    )
    assert metrics and all("error" in m for m in metrics)


def test_cli_packed_batch_with_devices(tmp_path):
    # the CLI wires --batch --packed --devices N to the file-DP dispatch
    from fwav.cli import main as cli_main
    from fwav.io.wav import write_wav

    rng = np.random.default_rng(0)
    for k in range(3):
        t = np.arange(12000) / 16000
        s = 0.4 * np.sin(2 * np.pi * (320 + 60 * k) * t)
        s += 0.01 * rng.standard_normal(len(t))
        write_wav(tmp_path / f"f{k}.wav",
                  np.round(s * 16000).astype(np.float32), 16000, 2)
    out = tmp_path / "out"
    rc = cli_main(["compress", str(tmp_path), "--batch", "--packed",
                   "--devices", "4", "--out", str(out)])
    assert rc == 0
    metrics = json.loads((out / "compression_metrics.json").read_text())
    assert len(metrics) == 3 and all("error" not in m for m in metrics)
    assert all((out / f"f{k}.wav.fwav").exists() for k in range(3))
