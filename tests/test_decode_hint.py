"""The stored decode hint (v2/v3 FLAG_DECODE_HINT; VERDICT r4 item 4).

The damped encode profile tunes matches for the s_damping=0.25 decoder
(config.DAMPED_DECODE_DAMPING); decoding such a file at the default
damping=0 lands measurably BELOW the default profile. The hint closes the
trap: compact/multichannel writers store the profile's preferred damping,
`decompress` defaults to it, explicit --damping (including 0) overrides,
and v1 — frozen for reference compat (fractal.py:1278-1322) — never
carries one.
"""

import json

import numpy as np
import pytest

from fwav.config import DAMPED_DECODE_DAMPING
from fwav.io.compact import (
    FLAG_DECODE_HINT,
    compact_bytes,
    describe_layout,
    parse_compact_bytes,
    parse_decode_hint,
)
from fwav.io.wav import write_wav
from fwav.models.codec import (
    _stored_decode_hint,
    process_file_compress,
    process_file_decompress,
)
from fwav.models.encode import compress_audio_arrays, prune_bank


def _sig(seconds=1.2, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    sig = 0.4 * np.sin(2 * np.pi * 330 * t) + 0.15 * np.sin(2 * np.pi * 990 * t)
    sig += 0.01 * rng.standard_normal(len(t))
    return np.round(sig * 16000).astype(np.float32), sr


@pytest.fixture(scope="module")
def _enc():
    sig, sr = _sig()
    rec, bank, n_ranges, N, tile, step, thr, olen = compress_audio_arrays(
        sig, sr, 2, tile_size=128
    )
    rec, bank = prune_bank(rec, bank)
    return sig, sr, rec, bank, (N, sr, 2, tile, step, thr, olen)


def test_hint_roundtrip_and_streams_unchanged(_enc):
    sig, sr, rec, bank, tail = _enc
    plain = compact_bytes(rec, bank, *tail)
    hinted = compact_bytes(rec, bank, *tail,
                           decode_damping=DAMPED_DECODE_DAMPING)
    assert parse_decode_hint(plain) is None
    assert parse_decode_hint(hinted) == DAMPED_DECODE_DAMPING
    # the hint rides the prefix alone
    assert parse_decode_hint(hinted[:83]) == DAMPED_DECODE_DAMPING
    lay = describe_layout(hinted)
    assert lay["decode_damping_hint"] == DAMPED_DECODE_DAMPING
    assert "decode_damping_hint" not in describe_layout(plain)
    # decode inputs are identical with and without the hint byte
    a = parse_compact_bytes(plain)
    b = parse_compact_bytes(hinted)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # exactly one byte of overhead
    assert len(hinted) == len(plain) + 1


def test_hint_zero_and_bounds(_enc):
    _sig_, _sr, rec, bank, tail = _enc
    z = compact_bytes(rec, bank, *tail, decode_damping=0.0)
    assert parse_decode_hint(z) == 0.0  # explicit 0 is stored, not elided
    for bad in (-0.01, 2.56, float("nan"), float("inf")):
        with pytest.raises(ValueError):
            compact_bytes(rec, bank, *tail, decode_damping=bad)


def test_hint_is_checksummed_and_truncation_fails(_enc):
    _sig_, _sr, rec, bank, tail = _enc
    hinted = bytearray(
        compact_bytes(rec, bank, *tail, decode_damping=DAMPED_DECODE_DAMPING)
    )
    hinted[82] ^= 0xFF  # flip the hint byte (first byte after the 16B ext)
    with pytest.raises(ValueError, match="Checksum"):
        parse_compact_bytes(bytes(hinted))
    # flag set but body cut off right after the ext header
    with pytest.raises(ValueError):
        parse_compact_bytes(bytes(hinted[:82]), verify_checksum=False)


def test_damped_compact_file_decodes_hinted(tmp_path, _enc):
    sig, sr, *_ = _enc
    wav = str(tmp_path / "in.wav")
    write_wav(wav, sig, sr, 2)  # int16-count scale, like read_wav returns

    m = process_file_compress(wav, str(tmp_path / "d.fwav"), tile=128,
                              compact=True, objective="damped")
    assert "error" not in m

    assert _stored_decode_hint(m["output"]) == DAMPED_DECODE_DAMPING

    # bare decode must equal the explicitly damped decode bit-for-bit...
    d_bare = process_file_decompress(m["output"], str(tmp_path / "bare.wav"))
    d_expl = process_file_decompress(m["output"], str(tmp_path / "expl.wav"),
                                     s_damping=DAMPED_DECODE_DAMPING)
    assert d_bare.get("s_damping") == DAMPED_DECODE_DAMPING
    assert d_bare.get("s_damping_from_hint") is True
    with open(d_bare["output"], "rb") as f1, open(d_expl["output"], "rb") as f2:
        assert f1.read() == f2.read()

    # ...and an explicit 0 still overrides the hint (different decoder)
    d_zero = process_file_decompress(m["output"], str(tmp_path / "z.wav"),
                                     s_damping=0.0)
    assert "s_damping" not in d_zero
    with open(d_bare["output"], "rb") as f1, open(d_zero["output"], "rb") as f2:
        assert f1.read() != f2.read()


def test_default_profile_files_stay_hintless(tmp_path, _enc):
    sig, sr, *_ = _enc
    wav = str(tmp_path / "in.wav")
    write_wav(wav, sig, sr, 2)
    m = process_file_compress(wav, str(tmp_path / "b.fwav"), tile=128,
                              compact=True)
    assert "error" not in m
    assert _stored_decode_hint(m["output"]) is None
    # v1 is frozen: never a hint, and bare decode is the damping=0 decode
    m1 = process_file_compress(wav, str(tmp_path / "v1.fwav"), tile=128)
    assert _stored_decode_hint(m1["output"]) is None
    d = process_file_decompress(m1["output"], str(tmp_path / "r1.wav"))
    assert "s_damping" not in d


def test_multichannel_hint(tmp_path):
    sr = 16000
    t = np.arange(int(sr * 1.0)) / sr
    left = 12000 * np.sin(2 * np.pi * 330 * t)
    right = 9000 * np.sin(2 * np.pi * 440 * t)
    wav = str(tmp_path / "st.wav")
    write_wav(wav, np.stack([left, right], axis=1).astype(np.float32), sr, 2)

    m = process_file_compress(wav, str(tmp_path / "st.fwav"), tile=128,
                              channels="keep", objective="damped")
    assert "error" not in m
    assert _stored_decode_hint(m["output"]) == DAMPED_DECODE_DAMPING

    d_bare = process_file_decompress(m["output"], str(tmp_path / "bare.wav"))
    d_expl = process_file_decompress(m["output"], str(tmp_path / "expl.wav"),
                                     s_damping=DAMPED_DECODE_DAMPING)
    with open(d_bare["output"], "rb") as f1, open(d_expl["output"], "rb") as f2:
        assert f1.read() == f2.read()


def test_cli_info_reports_hint(tmp_path, capsys):
    from fwav.cli import main

    sig, sr = _sig(seconds=0.6)
    wav = str(tmp_path / "in.wav")
    write_wav(wav, sig, sr, 2)
    out = str(tmp_path / "d.fwav")
    assert main(["compress", wav, out, "--tile", "128", "--compact",
                 "--profile", "damped"]) == 0
    capsys.readouterr()
    assert main(["info", out]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["decode_damping_hint"] == DAMPED_DECODE_DAMPING
    assert info["v2_layout"]["decode_damping_hint"] == DAMPED_DECODE_DAMPING


def test_cli_compact_defaults_to_damped_profile(tmp_path, capsys):
    """--compact with no --profile picks damped and stores the hint (the
    showcased one-command path: ratio ~2.7 AND the ~40 dB profile); v1 and
    --profile default stay hintless."""
    from fwav.cli import main

    sig, sr = _sig(seconds=0.6)
    wav = str(tmp_path / "in.wav")
    write_wav(wav, sig, sr, 2)

    auto = str(tmp_path / "auto.fwav")
    assert main(["compress", wav, auto, "--tile", "128", "--compact"]) == 0
    assert _stored_decode_hint(auto) == DAMPED_DECODE_DAMPING

    forced = str(tmp_path / "forced.fwav")
    assert main(["compress", wav, forced, "--tile", "128", "--compact",
                 "--profile", "default"]) == 0
    assert _stored_decode_hint(forced) is None

    v1 = str(tmp_path / "v1.fwav")
    assert main(["compress", wav, v1, "--tile", "128"]) == 0
    assert _stored_decode_hint(v1) is None
    # auto-profile v1 must carry the default profile's records: identical
    # bytes to an explicit --profile default encode
    v1d = str(tmp_path / "v1d.fwav")
    assert main(["compress", wav, v1d, "--tile", "128",
                 "--profile", "default"]) == 0
    with open(v1, "rb") as f1, open(v1d, "rb") as f2:
        assert f1.read() == f2.read()


def test_unknown_flag_still_rejected(_enc):
    _sig_, _sr, rec, bank, tail = _enc
    blob = bytearray(compact_bytes(rec, bank, *tail))
    flags_off = 66 + 3  # idx_bits u8, bank_exp i8, o_exp i8, flags u8
    blob[flags_off] |= 32  # first undefined bit above FLAG_DECODE_HINT
    assert FLAG_DECODE_HINT == 16
    with pytest.raises(ValueError, match="flags"):
        parse_compact_bytes(bytes(blob), verify_checksum=False)
