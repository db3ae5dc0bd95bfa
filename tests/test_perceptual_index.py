"""Perceptual ops + MIPS index + parity helpers (reference: fractal.py
488-533, 353-401, 404-486, 913-1010)."""

import numpy as np
import pytest

from fwav.ops.affine import find_best_domain_affine
from fwav.ops.dct import multi_head_embedding_batch
from fwav.ops.index import (
    MIPSIndex,
    ann_query,
    build_ann_index,
    build_domain_embeddings,
)
from fwav.ops.perceptual import (
    compute_transient_mask,
    mel_filterbank,
    perceptual_error_batch,
    pruned_affine_search,
)
import jax.numpy as jnp


def test_mel_filterbank_properties():
    fb = mel_filterbank(sr=44100, n_fft=1024, n_mels=40)
    assert fb.shape == (40, 513)
    assert fb.dtype == np.float32
    assert np.all(fb >= 0)
    # each filter is a triangle: one contiguous support region
    for i in range(40):
        nz = np.nonzero(fb[i])[0]
        assert len(nz) > 0
        assert np.all(np.diff(nz) == 1), f"filter {i} support not contiguous"
    # centers increase monotonically
    centers = [np.argmax(fb[i]) for i in range(40)]
    assert all(a <= b for a, b in zip(centers, centers[1:]))
    # Slaney normalization: below 1 kHz filters are linearly spaced, so
    # area-normalized peak heights are roughly equal
    peaks = fb.max(axis=1)
    low = peaks[:5]
    assert low.max() / low.min() < 1.5


def test_transient_mask():
    sig = np.zeros(2000, dtype=np.float32)
    sig[1000:1100] = 1.0  # sharp onset
    mask = compute_transient_mask(sig, frame_size=256)
    assert mask.shape == sig.shape
    assert mask.max() == pytest.approx(1.0, rel=1e-5)
    assert np.argmax(mask) >= 1000  # fires at/after the onset
    assert np.all(mask[:1000] == 0)


def test_perceptual_error_batch_golden():
    rng = np.random.default_rng(0)
    tiles = rng.standard_normal((6, 8)).astype(np.float32)
    r = rng.standard_normal(8).astype(np.float32)
    got = np.asarray(perceptual_error_batch(tiles, r, transient_weight=1.0))
    # golden: reference formula (fractal.py:498-519)
    mel = np.linspace(1.0, 0.5, 8).astype(np.float32)
    env = np.pad(np.abs(np.diff(r)), (0, 1))
    diff = (tiles - r[None, :]) * mel[None, :] * (1.0 + env[None, :])
    want = np.linalg.norm(diff, axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pruned_affine_search_prunes_energy_ratio():
    rng = np.random.default_rng(1)
    r = rng.standard_normal(8).astype(np.float32)
    good = (2.0 * r + 0.1).astype(np.float32)       # perfect fit, ratio 4x.. wait
    good = (0.9 * r + 0.1).astype(np.float32)       # perfect fit, ratio in bounds
    loud = (10.0 * r).astype(np.float32)            # perfect fit but ratio 100x
    bank = np.stack([loud, good, rng.standard_normal(8).astype(np.float32)])
    idx, s, o, sym, err = pruned_affine_search(r, np.arange(3), bank)
    assert int(idx) == 1  # the energy-pruned perfect fit must lose


def test_mips_index_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    tiles = rng.standard_normal((300, 4)).astype(np.float32)
    emb = np.asarray(multi_head_embedding_batch(jnp.asarray(tiles)))
    ix = MIPSIndex(emb)
    p = tmp_path / "bank.fwix"
    ix.save(p)
    ix2 = MIPSIndex.load(p)
    np.testing.assert_array_equal(ix.embeddings, ix2.embeddings)

    q = emb[17][None, :]
    idx, scores = ix2.query(q, top_k=5)
    assert idx[0, 0] == 17  # a vector's own row is its best IP match (normalized)
    dense = emb @ q[0]
    np.testing.assert_allclose(np.sort(dense)[::-1][:5], scores[0], atol=1e-5)


def test_build_embeddings_and_ann_lifecycle(tmp_path):
    rng = np.random.default_rng(3)
    domains = rng.standard_normal((500, 4)).astype(np.float32)
    dpath = tmp_path / "d.domains"
    domains.tofile(dpath)
    emb_path = build_domain_embeddings(dpath, 500, 4, emb_dim=16, tmpdir=str(tmp_path))
    emb = np.memmap(emb_path, dtype="float32", mode="r", shape=(500, 16))
    want = np.asarray(multi_head_embedding_batch(jnp.asarray(domains)))
    np.testing.assert_allclose(np.asarray(emb), want, atol=1e-6)

    index_path = build_ann_index(emb_path, 500, emb_dim=16)
    cand = ann_query(domains[123], index_path, top_k=8, emb_dim=16)
    assert len(cand) == 8
    assert 123 in cand  # exact index: own tile must be found


def test_find_best_domain_affine_works():
    """The reference's version is dead AND crashes (NameError at
    fractal.py:428); ours must work and find the planted match."""
    rng = np.random.default_rng(4)
    bank = rng.standard_normal((50, 8)).astype(np.float32)
    r = 3.0 * bank[31] - 0.7
    idx, s, o, sym, err = find_best_domain_affine(r, bank, [5, 31, 40])
    assert idx == 31
    assert s == pytest.approx(3.0, abs=1e-3)
    assert o == pytest.approx(-0.7, abs=1e-3)
    assert err < 1e-2
    # empty candidates -> sentinel
    assert find_best_domain_affine(r, bank, [])[0] == -1
    assert find_best_domain_affine(r, bank, [-1, -1])[0] == -1
