"""Candidate index: the on-device replacement for the hnswlib ANN graph.

The reference builds an HNSW inner-product index over domain embeddings when
n_domains > 4096 (build_ann_index fractal.py:353-381, gating fractal.py:1165)
and queries it per range from CPU workers (fractal.py:587-614), falling back
to linear search on any failure. On an accelerator the economics invert:
one batched (M, E) @ (E, D) matmul + top-k over the whole bank is faster
than M graph walks and is EXACT (recall 1.0), so the "index" is just the
embedding matrix staged for blockwise scanning. This module keeps the
reference's index lifecycle (build / persist / load / query) so code
written against the ANN API has a drop-in equivalent.

File format: the reference persists hnswlib's opaque graph next to the
embedding memmap (emb_path + '.ann'). Here the persisted index IS the
embedding matrix (small header + float32 rows), so it doubles as the
embedding store.
"""

from __future__ import annotations

import struct

import jax.numpy as jnp
import numpy as np

from ..utils.buckets import bucket
from .search import topk_scores_block

_MAGIC = b"FWIX"


class MIPSIndex:
    """Exact maximum-inner-product 'index' over (n, emb_dim) embeddings."""

    def __init__(self, embeddings: np.ndarray):
        self.embeddings = np.ascontiguousarray(embeddings, dtype=np.float32)

    @property
    def n(self) -> int:
        return self.embeddings.shape[0]

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    def save(self, path) -> None:
        with open(path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<II", self.n, self.dim))
            f.write(self.embeddings.tobytes())

    @classmethod
    def load(cls, path) -> "MIPSIndex":
        with open(path, "rb") as f:
            if f.read(4) != _MAGIC:
                raise ValueError("Not a FWIX index file")
            n, dim = struct.unpack("<II", f.read(8))
            data = np.frombuffer(f.read(n * dim * 4), dtype=np.float32)
        return cls(data.reshape(n, dim))

    def query(self, queries, top_k: int = 32, domain_block: int = 2048):
        """(M, E) queries -> (idx (M, k) int32 desc-by-score, scores (M, k)).
        Exact top-k by inner product; -1 fills when k > n."""
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        db = bucket(max(self.n, 1), 256)
        emb = np.zeros((db, self.dim), np.float32)
        emb[: self.n] = self.embeddings
        valid = np.zeros(db, bool)
        valid[: self.n] = True
        blk = min(domain_block, db)
        while db % blk:
            blk //= 2
        scores, idx = topk_scores_block(
            jnp.asarray(q), jnp.asarray(emb), jnp.asarray(valid), top_k, blk
        )
        return np.asarray(idx), np.asarray(scores)


def build_domain_embeddings(
    domains_path,
    n_domains: int,
    range_size: int,
    emb_dim: int = 16,
    block_size: int = 4096,
    tmpdir=None,
):
    """Reference-shaped embedding-store builder (fractal.py:238-280
    signature): memmap the (n_domains, range_size) domain file, embed
    blockwise with the batched multi-head DCT op (one matmul per block — the
    reference loops Python per tile), write a float32 (n_domains, emb_dim)
    '.emb' memmap, return its path."""
    import tempfile

    from .dct import multi_head_embedding_batch

    emb_file = tempfile.NamedTemporaryFile(delete=False, suffix=".emb", dir=tmpdir)
    emb_path = emb_file.name
    emb_file.close()

    domains_mm = np.memmap(
        domains_path, dtype="float32", mode="r", shape=(n_domains, range_size)
    )
    emb_mm = np.memmap(emb_path, dtype="float32", mode="w+", shape=(n_domains, emb_dim))
    for i in range(0, n_domains, block_size):
        blk = np.asarray(domains_mm[i : i + block_size])
        emb_mm[i : i + len(blk)] = np.asarray(
            multi_head_embedding_batch(
                jnp.asarray(blk), tonal_k=emb_dim // 2,
                transient_k=emb_dim - emb_dim // 2,
            )
        )
    emb_mm.flush()
    return emb_path


def build_ann_index(emb_path, n_domains, emb_dim=16, index_path=None,
                    method="mips", ef=None, M=None):
    """Reference-shaped builder (fractal.py:353 signature): reads the raw
    float32 embedding file, persists the exact-MIPS index next to it,
    returns the index path. `method`/`ef`/`M` are accepted for parity; graph
    hyperparameters do not exist for an exact index."""
    if index_path is None:
        index_path = str(emb_path) + ".ann"
    emb = np.memmap(emb_path, dtype="float32", mode="r", shape=(n_domains, emb_dim))
    MIPSIndex(np.asarray(emb)).save(index_path)
    return index_path


def ann_query(range_block, index_path, top_k: int = 32, emb_dim: int = 16):
    """Reference-shaped standalone query (fractal.py:384-401): embeds the
    range with the SAME multi-head embedding used to build the index (the
    reference inconsistently used tile_embedding here) and returns candidate
    ids. Empty array on failure, like the reference."""
    from .dct import multi_head_embedding

    if index_path is None:
        return np.empty((0,), dtype=np.int32)
    try:
        index = MIPSIndex.load(index_path)
        q = multi_head_embedding(
            np.asarray(range_block, dtype=np.float32),
            tonal_k=index.dim // 2,
            transient_k=index.dim - index.dim // 2,
        )
        idx, _ = index.query(q[None, :], top_k=top_k)
        return idx[0][idx[0] >= 0].astype(np.int32)
    except Exception:
        return np.empty((0,), dtype=np.int32)
