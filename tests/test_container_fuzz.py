"""Corruption fuzz for the container loaders (v1 incl. the native C++
read path, v2 compact).

A hostile or damaged .fwav must never crash the process, hang, or raise
anything other than the format's ValueError family — the reference's
loader has the same contract via its checksum/size checks
(fractal.py:1331-1370). Mutations: truncation at every region boundary and
random offsets, random byte flips (header, checksum, payload), and header
field corruption. MemoryError is tolerated only for size-field corruption
(a u32 row count can legitimately describe a multi-GB file)."""

import numpy as np
import pytest

from fwav.io.compact import load_compressed_compact, save_compressed_compact
from fwav.io.container import MATCH_DTYPE, load_compressed_arrays, save_compressed


@pytest.fixture(scope="module")
def _files(tmp_path_factory):
    rng = np.random.default_rng(0)
    n_ranges, n_dom, N = 300, 120, 4
    rec = np.zeros(n_ranges, MATCH_DTYPE)
    live = rng.random(n_ranges) < 0.8
    rec["idx"] = np.where(live, rng.integers(0, n_dom, n_ranges), -1)
    rec["s"] = np.where(live, rng.uniform(-16, 16, n_ranges), 1.0).astype(np.float32)
    rec["o"] = np.where(live, rng.uniform(-3e4, 3e4, n_ranges), 0.0).astype(np.float32)
    rec["sym"] = np.where(live, rng.integers(0, 2, n_ranges), 0)
    bank = rng.standard_normal((n_dom, N)).astype(np.float32)
    d = tmp_path_factory.mktemp("fuzz")
    p1, p2 = d / "v1.fwav", d / "v2.fwav"
    save_compressed(p1, rec, bank, N, 16000, 2, 1024, 1, 1e-4, n_ranges * N)
    save_compressed_compact(p2, rec, bank, N, 16000, 2, 1024, 1, 1e-4, n_ranges * N)
    # a third corpus whose s stream selects the whole-value rANS coding
    # (so_enc bit0): heavy s repetition at a size where FLAG_ENTROPY wins
    from fwav.io.compact import _EXT, _EXT_OFFSET, FLAG_ENTROPY

    m = 4096
    rec3 = np.zeros(m, MATCH_DTYPE)
    rec3["idx"] = rng.integers(0, n_dom, m)
    rec3["s"] = rng.choice(np.float32([0.25, 0.5, 1.0, 1.5]), m)
    rec3["o"] = rng.normal(0.0, 800.0, m).astype(np.float32)
    rec3["sym"] = rng.integers(0, 2, m).astype(np.uint8)
    rec3["err"] = np.float32(1.0)
    p3 = d / "v2wv.fwav"
    save_compressed_compact(p3, rec3, bank, N, 16000, 2, 1024, 1, 1e-4, m * N)
    b3 = p3.read_bytes()
    assert b3[_EXT_OFFSET + 3] & FLAG_ENTROPY
    assert b3[_EXT_OFFSET + _EXT.size + 3] & 1  # whole-value s selected
    # a fourth corpus whose idx stream selects rank-split rANS (idx_enc=2):
    # a wide skewed alphabet past the dense 2^12 cap, enough live ranges
    # that the rank streams beat fixed-width packing despite the tables
    m4, dom4 = 60_000, 20_000
    rec4 = np.zeros(m4, MATCH_DTYPE)
    rec4["idx"] = rng.zipf(1.25, m4) % dom4
    rec4["s"] = rng.normal(0.4, 0.2, m4).astype(np.float32)
    rec4["o"] = rng.normal(0.0, 300.0, m4).astype(np.float32)
    rec4["err"] = np.float32(1.0)
    bank4 = rng.normal(0, 500.0, (dom4, N)).astype(np.float32)
    p4 = d / "v2rs.fwav"
    save_compressed_compact(p4, rec4, bank4, N, 16000, 2, 1024, 1, 1e-4, m4 * N)
    b4 = p4.read_bytes()
    assert b4[_EXT_OFFSET + _EXT.size + 2] == 2  # rank-split idx selected
    return p1.read_bytes(), p2.read_bytes(), b3, b4, d


def _attempt(loader, path, blob, tmp, tag):
    p = tmp / f"mut_{tag}.fwav"
    p.write_bytes(blob)
    try:
        loader(p)
    except ValueError:
        pass  # the format's error contract
    except MemoryError:
        pass  # size-field corruption can describe a multi-GB payload
    finally:
        p.unlink()


@pytest.fixture
def _force_python_loader(request, monkeypatch):
    # the v1 loader prefers the native C++ parser; fuzz BOTH paths
    if request.param:
        from fwav.io import native

        monkeypatch.setattr(native, "read", lambda *a, **k: None)
    return request.param


@pytest.mark.parametrize("which", ["v1", "v2", "v2wv", "v2rs"])
@pytest.mark.parametrize("_force_python_loader", [False, True], indirect=True)
def test_truncations(_files, tmp_path, which, _force_python_loader):
    v1, v2, v2wv, v2rs, _ = _files
    blob = {"v1": v1, "v2": v2, "v2wv": v2wv, "v2rs": v2rs}[which]
    loader = load_compressed_arrays if which == "v1" else load_compressed_compact
    cuts = {0, 3, 4, 5, 33, 34, 65, 66, 67, 81, 82, len(blob) - 1}
    rng = np.random.default_rng(1)
    cuts.update(int(x) for x in rng.integers(0, len(blob), 25))
    for cut in sorted(cuts):
        _attempt(loader, None, blob[:cut], tmp_path, f"{which}_t{cut}")


@pytest.mark.parametrize("which", ["v1", "v2", "v2wv", "v2rs"])
def test_byte_flips(_files, tmp_path, which):
    v1, v2, v2wv, v2rs, _ = _files
    blob = bytearray({"v1": v1, "v2": v2, "v2wv": v2wv, "v2rs": v2rs}[which])
    loader = load_compressed_arrays if which == "v1" else load_compressed_compact
    rng = np.random.default_rng(2)
    offsets = {0, 4, 34}  # magic, version, checksum
    offsets.update(range(5, 34, 4))  # header fields
    offsets.update(int(x) for x in rng.integers(0, len(blob), 40))
    for off in sorted(offsets):
        mut = bytearray(blob)
        mut[off] ^= 0xFF
        _attempt(loader, None, bytes(mut), tmp_path, f"{which}_f{off}")


@pytest.mark.parametrize("which", ["v1", "v2", "v2wv", "v2rs"])
def test_header_field_extremes(_files, tmp_path, which):
    # set each u32 header count to 0 and to 0xFFFFFFFF (verify off so the
    # size checks themselves are what gets exercised)
    import struct

    v1, v2, v2wv, v2rs, _ = _files
    blob = {"v1": v1, "v2": v2, "v2wv": v2wv, "v2rs": v2rs}[which]
    if which == "v1":
        def loader(p):
            return load_compressed_arrays(p, verify_checksum=False)
    else:
        def loader(p):
            return load_compressed_compact(p, verify_checksum=False)
    for off in (22, 26, 30):  # n_ranges, n_domains, original_len
        for val in (0, 0xFFFFFFFF):
            mut = bytearray(blob)
            mut[off : off + 4] = struct.pack("<I", val)
            _attempt(loader, None, bytes(mut), tmp_path, f"{which}_h{off}_{val}")
