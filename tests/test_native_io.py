"""Native C++ .fwav runtime (native/fwavio.cpp via io/native.py): byte
equality with the pure-Python writer, checksum behavior, error codes."""

import hashlib

import numpy as np
import pytest

from fwav.io import native
from fwav.io.container import (
    MATCH_DTYPE,
    load_compressed_arrays,
    matches_to_struct,
)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain to build libfwavio"
)


@pytest.fixture
def sample():
    rng = np.random.default_rng(0)
    domains = rng.standard_normal((37, 4)).astype(np.float32)
    rec = np.zeros(11, dtype=MATCH_DTYPE)
    rec["idx"] = np.arange(11) - 1  # includes a -1 sentinel
    rec["s"] = rng.standard_normal(11).astype(np.float32)
    rec["o"] = rng.standard_normal(11).astype(np.float32)
    rec["sym"] = (np.arange(11) % 2).astype(np.uint8)
    rec["err"] = np.abs(rng.standard_normal(11)).astype(np.float32)
    rec["err"][3] = np.inf
    hdr = dict(range_size=4, framerate=22050, sampwidth=3, tile_size=512,
               domain_step=2, energy_threshold=2e-4, original_len=12345)
    return rec, domains, hdr


def _python_bytes(rec, domains, hdr):
    """Reference-layout writer, independent of both implementations."""
    import struct

    out = bytearray()
    out += b"FWAV" + struct.pack("<B", 1)
    out += struct.pack(
        "<IIBHHfIII", hdr["range_size"], hdr["framerate"], hdr["sampwidth"],
        hdr["tile_size"], hdr["domain_step"], hdr["energy_threshold"],
        len(rec), len(domains), hdr["original_len"],
    )
    payload = domains.astype(np.float32).tobytes() + rec.tobytes()
    out += hashlib.sha256(payload).digest() + payload
    return bytes(out)


def test_native_write_bytes_identical(tmp_path, sample):
    rec, domains, hdr = sample
    p = tmp_path / "n.fwav"
    assert native.write(p, rec, domains, **hdr)
    assert p.read_bytes() == _python_bytes(rec, domains, hdr)


def test_native_read_round_trip(tmp_path, sample):
    rec, domains, hdr = sample
    p = tmp_path / "r.fwav"
    assert native.write(p, rec, domains, **hdr)
    out = native.read(p)
    rec2, dom2, n_ranges, range_size, fr, sw, tile, step, thr, olen = out
    np.testing.assert_array_equal(rec2, rec)
    np.testing.assert_array_equal(dom2, domains)
    assert (n_ranges, range_size, fr, sw) == (11, 4, 22050, 3)
    assert (tile, step, olen) == (512, 2, 12345)
    assert thr == pytest.approx(2e-4)


def test_native_checksum_and_magic_errors(tmp_path, sample):
    rec, domains, hdr = sample
    p = tmp_path / "c.fwav"
    native.write(p, rec, domains, **hdr)
    raw = bytearray(p.read_bytes())
    raw[70] ^= 0xFF
    p.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="Checksum mismatch"):
        native.read(p)
    assert native.read(p, verify_checksum=False) is not None

    bad = tmp_path / "bad.fwav"
    bad.write_bytes(b"JUNK" + bytes(raw[4:]))
    with pytest.raises(ValueError, match="Not a FWAV file"):
        native.read(bad)


def test_container_api_uses_native_transparently(tmp_path, sample):
    """load_compressed_arrays must give identical results whichever backend
    serviced it (it prefers native when built)."""
    rec, domains, hdr = sample
    from fwav.io.container import save_compressed

    p = tmp_path / "t.fwav"
    save_compressed(p, rec, domains, **hdr)
    assert p.read_bytes() == _python_bytes(rec, domains, hdr)
    out = load_compressed_arrays(p)
    np.testing.assert_array_equal(out[0], rec)
    np.testing.assert_array_equal(out[1], domains)
