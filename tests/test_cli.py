"""CLI behavior (cli.main run in-process on the CPU mesh): single-file
round trip, batch with skip-resume and metrics JSON, error handling."""

import json
import os

import numpy as np
import pytest

from fwav.cli import main
from fwav.io.wav import read_wav_mono, write_wav
from fwav.utils.metrics import compute_snr


@pytest.fixture
def wav_dir(tmp_path, tone):
    sig, sr, _ = tone
    d = tmp_path / "wavs"
    d.mkdir()
    write_wav(d / "a.wav", sig, sr, 2)
    write_wav(d / "b.wav", sig * 0.5, sr, 2)
    return d, sig, sr


def test_cli_single_file_round_trip(tmp_path, wav_dir):
    d, sig, sr = wav_dir
    fwav = tmp_path / "a.fwav"
    main(["compress", str(d / "a.wav"), str(fwav), "--tile", "128"])
    assert fwav.exists()
    out = tmp_path / "a_recon.wav"
    main(["decompress", str(fwav), "--out", str(out)])
    recon, fr, sw = read_wav_mono(out)
    assert (fr, sw) == (sr, 2)
    assert compute_snr(sig, recon) > 4.0


def test_cli_sharded_damped_decode_matches_single_device(tmp_path, wav_dir):
    """decompress --devices N runs the damped decode range-sharded over the
    8-device mesh and must match the single-device decode (VERDICT r2
    item 6). --eps 0 disables the early break so both run identical
    iteration counts; outputs agree to fp tolerance (sub-LSB after the
    int16 WAV write)."""
    d, sig, sr = wav_dir
    fwav = tmp_path / "a.fwav"
    assert main(["compress", str(d / "a.wav"), str(fwav), "--tile", "128"]) == 0
    out1 = tmp_path / "one.wav"
    out8 = tmp_path / "eight.wav"
    assert main(["decompress", str(fwav), "--out", str(out1),
                 "--damping", "0.5", "--eps", "0"]) == 0
    assert main(["decompress", str(fwav), "--out", str(out8),
                 "--damping", "0.5", "--eps", "0",
                 "--devices", "8"]) == 0
    a, _, _ = read_wav_mono(out1)
    b, _, _ = read_wav_mono(out8)
    assert np.max(np.abs(a - b)) <= 1.0  # <= 1 int16 LSB (fp-rounding only)
    assert compute_snr(sig, b) > 4.0

    # --tp shapes the mesh but decode shards over dp; still valid
    out42 = tmp_path / "tp.wav"
    assert main(["decompress", str(fwav), "--out", str(out42),
                 "--damping", "0.5", "--eps", "0", "--devices", "8",
                 "--tp", "2"]) == 0
    c, _, _ = read_wav_mono(out42)
    assert np.max(np.abs(a - c)) <= 1.0

    # invalid mesh split is an argparse error, not a crash
    with pytest.raises(SystemExit):
        main(["decompress", str(fwav), "--out", str(tmp_path / "x.wav"),
              "--devices", "8", "--tp", "3"])


def test_cli_batch_with_skip_resume_and_metrics(tmp_path, wav_dir):
    d, sig, sr = wav_dir
    out = tmp_path / "out"
    main(["compress", str(d), "--batch", "--out", str(out), "--tile", "128",
          "--workers", "2"])
    metrics = json.loads((out / "compression_metrics.json").read_text())
    assert len(metrics) == 2
    assert all("x_realtime" in m for m in metrics)
    produced = sorted(os.listdir(out))
    assert "a.wav.fwav" in produced and "b.wav.fwav" in produced

    # second run skips everything: metrics file untouched
    mtime = (out / "compression_metrics.json").stat().st_mtime
    main(["compress", str(d), "--batch", "--out", str(out), "--tile", "128"])
    assert (out / "compression_metrics.json").stat().st_mtime == mtime

    # batch decompress
    main(["decompress", str(out), "--batch", "--out", str(out)])
    dm = json.loads((out / "decompression_metrics.json").read_text())
    assert len(dm) == 2
    for m in dm:
        recon, _, _ = read_wav_mono(m["output"])
        assert len(recon) == len(sig)
        # decode convergence observability (fractal.py:1464-1466 parity)
        assert m["decode_converged"]
        assert m["decode_iterations"] >= 1
        assert m["decode_final_delta"] < 1e-3


def test_cli_compress_requires_output(wav_dir):
    d, _, _ = wav_dir
    with pytest.raises(SystemExit):
        main(["compress", str(d / "a.wav")])
    with pytest.raises(SystemExit):
        main(["compress", str(d / "a.wav"), "x.fwav", "--batch"])


def test_cli_batch_isolates_bad_files(tmp_path, wav_dir):
    d, sig, sr = wav_dir
    (d / "broken.wav").write_bytes(b"RIFFnotawav")
    out = tmp_path / "out2"
    main(["compress", str(d), "--batch", "--out", str(out), "--tile", "128",
          "--workers", "1"])
    metrics = json.loads((out / "compression_metrics.json").read_text())
    by_input = {os.path.basename(m["input"]): m for m in metrics}
    assert "error" in by_input["broken.wav"]
    assert "output" in by_input["a.wav"]


def test_cli_info(tmp_path, wav_dir, capsys):
    d, sig, sr = wav_dir
    fwav = tmp_path / "i.fwav"
    main(["compress", str(d / "a.wav"), str(fwav), "--tile", "128"])
    main(["info", str(fwav), "--verify"])
    info = json.loads(capsys.readouterr().out)
    assert info["framerate"] == sr
    assert info["checksum"] == "verified"
    assert info["n_ranges"] > 0
    assert info["duration_s"] == pytest.approx(len(sig) / sr, abs=1e-3)


def test_cli_batch_forwards_search_and_info_is_header_only(tmp_path, wav_dir, capsys):
    """--search must reach batch workers; `info` without --verify must not
    read the domain bank payload."""
    d, sig, sr = wav_dir
    out = tmp_path / "s"
    main(["compress", str(d), "--batch", "--out", str(out), "--tile", "128",
          "--search", "exact", "--workers", "1"])
    assert (out / "a.wav.fwav").exists()

    # truncate the bank payload of a copy: header+matches parse must still work
    import shutil

    src = out / "a.wav.fwav"
    main(["info", str(src)])
    info = json.loads(capsys.readouterr().out)
    trunc = tmp_path / "trunc.fwav"
    shutil.copy(src, trunc)
    with open(trunc, "r+b") as f:
        f.truncate(66 + 10)  # destroy most of the bank
    # header still parses even though the payload is gone
    from fwav.io.container import read_header

    hdr = read_header(trunc)
    assert hdr[6] == info["n_ranges"]


def test_cli_default_prunes_bank(tmp_path, wav_dir):
    """The default CLI round trip produces the PRUNED container (VERDICT r1
    item 5): far fewer stored domains than the full sliding-window bank,
    identical reconstruction, and --full-bank restores reference behavior."""
    from fwav.io.container import read_header

    d, sig, sr = wav_dir
    pruned = tmp_path / "p.fwav"
    full = tmp_path / "f.fwav"
    main(["compress", str(d / "a.wav"), str(pruned), "--tile", "128"])
    main(["compress", str(d / "a.wav"), str(full), "--tile", "128",
          "--full-bank"])
    nd_pruned = read_header(pruned)[7]
    nd_full = read_header(full)[7]
    assert nd_pruned < nd_full / 1.5, (nd_pruned, nd_full)
    assert os.path.getsize(pruned) < os.path.getsize(full) / 1.5

    rp = tmp_path / "p_recon.wav"
    rf = tmp_path / "f_recon.wav"
    main(["decompress", str(pruned), "--out", str(rp)])
    main(["decompress", str(full), "--out", str(rf)])
    a, _, _ = read_wav_mono(str(rp))
    b, _, _ = read_wav_mono(str(rf))
    np.testing.assert_array_equal(a, b)


def test_cli_exit_codes(tmp_path):
    # 0 on success, 1 when a file fails — scripts/CI depend on it (the
    # reference always exits 0)
    from fwav.cli import main as cli_main

    assert cli_main(["compress", str(tmp_path / "missing.wav"),
                     str(tmp_path / "o.fwav")]) == 1
    assert cli_main(["decompress", str(tmp_path / "missing.fwav"),
                     "--out", str(tmp_path / "o.wav")]) == 1


def test_cli_info_verify_reports_failed_checksum(tmp_path, capsys):
    import json

    import numpy as np

    from fwav.cli import main as cli_main
    from fwav.io.container import MATCH_DTYPE, save_compressed

    rec = np.zeros(8, MATCH_DTYPE)
    rec["idx"] = np.arange(8) % 2
    rec["s"] = 1.0
    bank = np.ones((2, 4), np.float32)
    p = tmp_path / "x.fwav"
    save_compressed(p, rec, bank, 4, 8000, 2, 1024, 1, 1e-4, 32)
    blob = bytearray(p.read_bytes())
    blob[-1] ^= 0xFF
    p.write_bytes(bytes(blob))
    rc = cli_main(["info", str(p), "--verify"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["checksum"].startswith("FAILED")
    # header info still reported despite the corrupt payload
    assert out["n_ranges"] == 8


def test_cli_info_verify_reports_corrupt_compact_payload(tmp_path, capsys):
    """A corrupt compact-v2 deflate payload raises 'Corrupt or truncated'
    rather than 'Checksum mismatch'; info --verify must report it as a clean
    FAILED verdict with exit code 1, not an uncaught traceback (ADVICE r2)."""
    import json

    import numpy as np

    from fwav.cli import main as cli_main
    from fwav.io.compact import save_compressed_compact
    from fwav.io.container import MATCH_DTYPE

    rec = np.zeros(8, MATCH_DTYPE)
    rec["idx"] = np.arange(8) % 2
    rec["s"] = 1.0
    bank = np.linspace(-1, 1, 8, dtype=np.float32).reshape(2, 4)
    p = tmp_path / "x.fwav"
    save_compressed_compact(p, rec, bank, 4, 8000, 2, 1024, 1, 1e-4, 32)
    blob = bytearray(p.read_bytes())
    blob[-8] ^= 0xFF  # inside the deflate stream
    p.write_bytes(bytes(blob))
    rc = cli_main(["info", str(p), "--verify"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["checksum"].startswith("FAILED")


def test_cli_workers_and_tp_validation(tmp_path):
    import pytest

    from fwav.cli import main as cli_main

    with pytest.raises(SystemExit):
        cli_main(["compress", str(tmp_path), "--batch", "--workers", "0"])
    with pytest.raises(SystemExit):
        cli_main(["compress", "a.wav", "b.fwav", "--devices", "4", "--tp", "3"])


def test_cli_snr_subcommand(tmp_path, capsys):
    import json

    import numpy as np

    from fwav.cli import main as cli_main
    from fwav.io.wav import write_wav

    t = np.arange(8000) / 8000
    a = np.round(8000 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    b = a.copy()
    b[::50] += 100.0
    write_wav(tmp_path / "a.wav", a, 8000, 2)
    write_wav(tmp_path / "b.wav", b, 8000, 2)
    rc = cli_main(["snr", str(tmp_path / "a.wav"), str(tmp_path / "b.wav")])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and 20.0 < out["snr_db"] < 60.0
    assert out["compared_samples"] == 8000


def test_cli_resume_dir_reaches_streaming(tmp_path, monkeypatch):
    # --resume-dir threads through to the streaming encoder: shard
    # checkpoints appear, and a rerun (after losing the output) reuses
    # them to produce a byte-identical file
    import numpy as np

    import fwav.models.codec as codec
    from fwav.cli import main as cli_main
    from fwav.io.wav import write_wav

    monkeypatch.setattr(codec, "STREAMING_THRESHOLD", 8000)
    rng = np.random.default_rng(21)
    t = np.arange(24000) / 16000
    sig = np.round(
        (0.4 * np.sin(2 * np.pi * 300 * t) + 0.01 * rng.standard_normal(len(t)))
        * 16000
    ).astype(np.float32)
    wav = tmp_path / "long.wav"
    write_wav(wav, sig, 16000, 2)
    out = tmp_path / "long.fwav"
    rd = tmp_path / "ckpt"
    rc = cli_main(["compress", str(wav), str(out), "--tile", "128",
                   "--resume-dir", str(rd)])
    assert rc == 0
    ckpts = sorted(rd.rglob("shard_*.npy"))
    assert ckpts, "no shard checkpoints written"
    first = out.read_bytes()
    out.unlink()
    rc = cli_main(["compress", str(wav), str(out), "--tile", "128",
                   "--resume-dir", str(rd)])
    assert rc == 0 and out.read_bytes() == first


def test_bench_refuses_non_gpu_backend():
    """bench.py reports device numbers only: on any backend but the GPU it
    exits with a message instead of printing a CPU measurement."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        bench.measure()


def test_cli_info_verify_header_corruption_clean_verdict(tmp_path, capsys):
    """Header-level corruption (bad magic) must produce a clean JSON error
    report with exit code 1, not a traceback (round-3 review)."""
    from fwav.cli import main as cli_main

    p = tmp_path / "junk.fwav"
    p.write_bytes(b"NOPE" + b"\x00" * 80)
    rc = cli_main(["info", str(p), "--verify"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and "error" in out


def test_decompress_devices_ignored_at_zero_damping(tmp_path, wav_dir,
                                                    monkeypatch):
    """--devices N with the default damping=0 must not even build a mesh
    (the closed-form decode ignores it) — so it stays harmless on hosts
    with fewer devices (round-3 review)."""
    import fwav.parallel.mesh as pm
    from fwav.cli import main as cli_main

    d, sig, sr = wav_dir
    fwav = tmp_path / "a.fwav"
    assert cli_main(["compress", str(d / "a.wav"), str(fwav),
                     "--tile", "128"]) == 0

    def boom(*a, **k):
        raise AssertionError("make_mesh must not be called at damping=0")

    monkeypatch.setattr(pm, "make_mesh", boom)
    out = tmp_path / "r.wav"
    assert cli_main(["decompress", str(fwav), "--out", str(out),
                     "--devices", "64"]) == 0
    assert out.exists()


def test_cli_warmup_populates_exec_cache(tmp_path, monkeypatch):
    """`warmup --exec-cache` pre-compiles the real encode program and
    persists it; a subsequent same-bucket compress must REUSE it (hit) —
    integral warmup samples must land on the same int16-transport program
    real WAVs use. The cross-process half lives in test_exec_cache.py."""
    from fwav.cli import main as cli_main
    from fwav.utils import aot_cache

    cache = tmp_path / "wc"
    # the --exec-cache flag writes os.environ; registering the var with
    # monkeypatch FIRST guarantees teardown removes it for later tests
    monkeypatch.setenv("FWAV_EXEC_CACHE", str(cache))
    before = dict(aot_cache.stats)
    assert cli_main(["warmup", "--seconds", "0.12", "--rate", "8000",
                     "--tile", "128", "--exec-cache", str(cache)]) == 0
    entries = list(cache.glob("*.fwexec"))
    if aot_cache.stats["unserializable"] > before["unserializable"]:
        pytest.skip("backend cannot serialize executables")
    assert len(entries) == 1
    # a tone WAV of the same duration buckets to the same program: the
    # compress must hit (fresh wrapper stands in for a fresh process via
    # the lru_cache clear)
    from fwav.models import encode as enc

    enc._encode_core.cache_clear()
    sr = 8000
    t = np.linspace(0, 0.12, int(sr * 0.12), endpoint=False)
    sig = (0.5 * (2**15 - 1) * np.sin(2 * np.pi * 440.0 * t)).astype(np.int16)
    from fwav.io.wav import write_wav

    wav = tmp_path / "w.wav"
    write_wav(str(wav), sig, sr, 2)
    hits0 = aot_cache.stats["hits"]
    assert cli_main(["compress", str(wav), str(tmp_path / "w.fwav"),
                     "--tile", "128"]) == 0
    assert aot_cache.stats["hits"] == hits0 + 1
