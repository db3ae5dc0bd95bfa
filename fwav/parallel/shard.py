"""Multi-chip encode (SURVEY.md §2.5, §7 M5).

Two composable shardings on a (dp, tp) mesh, both running THE production
fused encode core (models.encode.build_encode_core) under shard_map — there
is deliberately no second, standalone sharded-search implementation to
drift from it (VERDICT r2 item 4; the round-1 `_dp_encode_core` lesson):

1. Range data-parallelism (dp): ranges are embarrassingly parallel — each
   device takes a contiguous range slab, zero communication. This replaces
   the reference's np.array_split over CPU worker processes
   (fractal.py:1180-1207).

2. Bank tensor-parallelism (tp): for exact/topk each chip builds + scans
   only its bank row-shard, and the per-shard winners merge with one
   all_gather in the single-device tie-break order
   (ops.search.merge_shard_bests: max score, then min global domain idx,
   then original orientation first). For "coarse" the tp axis splits
   RANGES instead — the coarse bank is a strided view of the box-mean
   sequence every device already derives from the replicated raw signal,
   so each tp shard runs the identical single-device per-range program on
   a range sub-slab (models.encode.build_encode_core finish()).

Because only the SELECTION leaves the device (3-byte idx protocol), the
stored s/o/err/orientation come from the host refit against the serialized
bank, and every search mode runs the same per-range math at every (dp, tp),
sharded output is bit-equal to single-device output for all combinations
(tests/test_sharding.py, tests/test_pallas_sharded.py; CLAUDE.md).
"""

from __future__ import annotations


def compress_audio_sharded(signal, framerate, sampwidth, mesh=None,
                           config=None, **kwargs):
    """Multi-device encode over a (dp, tp) mesh (SURVEY.md §2.5, §7 M5):
    ranges data-parallel over dp (the analog of the reference's
    np.array_split over CPU worker processes, fractal.py:1180-1182), the
    domain bank tensor-sharded over tp when it outgrows one device.

    Delegates to the SAME fused core as single-device encode
    (models.encode.build_encode_core run under shard_map — no forked
    pipeline): coarse/exact/Pallas modes, device-side VAD, idx-only
    device->host protocol and host refit all apply, and the output records
    are BIT-EQUAL to compress_audio_arrays on one device
    (tests/test_sharding.py). Same return contract as
    compress_audio_arrays; encoder knobs via EncoderConfig/kwargs."""
    import numpy as np

    from ..config import EncoderConfig
    from ..models.encode import _compress_fast
    from .mesh import make_mesh

    if mesh is None:
        mesh = make_mesh()
    cfg = config or EncoderConfig(**kwargs)
    signal = np.ascontiguousarray(np.asarray(signal, dtype=np.float32))
    return _compress_fast(signal, cfg, mesh=mesh)
