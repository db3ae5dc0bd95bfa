"""Byte-level golden tests of the .fwav container (SURVEY.md §2.3):
header layout, payload-only SHA-256, -1 sentinels, +inf err round-trip."""

import hashlib
import struct

import numpy as np
import pytest

from fwav.io.container import (
    MATCH_DTYPE,
    load_compressed,
    load_compressed_arrays,
    matches_to_struct,
    save_compressed,
)


def _golden_bytes(matches, domains, range_size, framerate, sampwidth,
                  tile_size, domain_step, energy_threshold, original_len):
    """Independent writer following the reference byte-for-byte
    (fractal.py:1278-1322)."""
    sha = hashlib.sha256()
    out = bytearray()
    out += b"FWAV"
    out += struct.pack("<B", 1)
    out += struct.pack("<I", range_size)
    out += struct.pack("<I", framerate)
    out += struct.pack("<B", sampwidth)
    out += struct.pack("<H", tile_size)
    out += struct.pack("<H", domain_step)
    out += struct.pack("<f", energy_threshold)
    out += struct.pack("<I", len(matches))
    out += struct.pack("<I", len(domains))
    out += struct.pack("<I", original_len)
    checksum_pos = len(out)
    out += b"\0" * 32
    for d in domains:
        b = np.asarray(d, np.float32).tobytes()
        out += b
        sha.update(b)
    for m in matches:
        b = struct.pack("<iffBf", int(m[0]), float(m[1]), float(m[2]), int(m[3]), float(m[4]))
        out += b
        sha.update(b)
    out[checksum_pos : checksum_pos + 32] = sha.digest()
    return bytes(out)


@pytest.fixture
def sample():
    domains = np.arange(12, dtype=np.float32).reshape(3, 4) * 0.25
    matches = [
        (0, 1.5, -0.25, 0, 0.125),
        (-1, 1.0, 0.0, 0, 0.0),           # silent sentinel
        (2, -3.0, 0.5, 1, float("inf")),  # inf err must survive f32
    ]
    hdr = dict(range_size=4, framerate=8000, sampwidth=2, tile_size=128,
               domain_step=1, energy_threshold=1e-4, original_len=11)
    return matches, domains, hdr


def test_bytes_identical_to_reference_layout(tmp_path, sample):
    matches, domains, hdr = sample
    p = tmp_path / "x.fwav"
    save_compressed(p, matches, domains, **hdr)
    got = p.read_bytes()
    want = _golden_bytes(matches, domains, **hdr)
    assert got == want


def test_round_trip_list_api(tmp_path, sample):
    matches, domains, hdr = sample
    p = tmp_path / "y.fwav"
    save_compressed(p, matches, domains, **hdr)
    (m2, d2, n_ranges, range_size, fr, sw, tile, step, ethr, olen) = load_compressed(p)
    assert n_ranges == 3 and range_size == 4 and fr == 8000 and sw == 2
    assert tile == 128 and step == 1 and olen == 11
    assert ethr == pytest.approx(1e-4)
    np.testing.assert_array_equal(d2, domains)
    assert m2[0] == (0, 1.5, -0.25, 0, 0.125)
    assert m2[1] == (-1, 1.0, 0.0, 0, 0.0)
    assert m2[2][0] == 2 and m2[2][3] == 1 and np.isinf(m2[2][4])


def test_checksum_detects_corruption(tmp_path, sample):
    matches, domains, hdr = sample
    p = tmp_path / "z.fwav"
    save_compressed(p, matches, domains, **hdr)
    raw = bytearray(p.read_bytes())
    raw[70] ^= 0xFF  # flip a payload byte
    p.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="Checksum mismatch"):
        load_compressed(p)
    # verify_checksum=False must still load
    load_compressed(p, verify_checksum=False)


def test_bad_magic_and_version(tmp_path, sample):
    matches, domains, hdr = sample
    p = tmp_path / "m.fwav"
    save_compressed(p, matches, domains, **hdr)
    raw = bytearray(p.read_bytes())
    bad = tmp_path / "bad.fwav"
    bad.write_bytes(b"NOPE" + bytes(raw[4:]))
    with pytest.raises(ValueError, match="Not a FWAV file"):
        load_compressed(bad)
    raw[4] = 9
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="Unsupported FWAV version"):
        load_compressed(bad)


def test_arrays_api_matches_list_api(tmp_path, sample):
    matches, domains, hdr = sample
    p = tmp_path / "a.fwav"
    save_compressed(p, matches_to_struct(matches), domains, **hdr)
    rec, d2, *_ = load_compressed_arrays(p)
    assert rec.dtype == MATCH_DTYPE
    np.testing.assert_array_equal(rec["idx"], [0, -1, 2])
    np.testing.assert_array_equal(rec["sym"], [0, 0, 1])
    assert np.isinf(rec["err"][2])


def test_match_record_is_17_bytes():
    assert MATCH_DTYPE.itemsize == 17
