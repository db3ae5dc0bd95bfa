"""Resume-under-damage fuzz (CPU mesh).

The streaming encoder's shard checkpoints claim crash-safety: a rerun
pointed at a resume_dir containing ANY mixture of complete, missing,
truncated, garbage, wrong-shape, or stale-temp checkpoint files must
produce records bit-equal to an undamaged encode (models/stream.py writes
checkpoints via write-to-temp + atomic rename and re-encodes anything that
fails np.load or the dtype/length check). test_streaming.py pins the happy
path; this fuzzes the damage space across random content, geometry, and
(dp, tp) mesh configurations — all three encodes per iteration share one
configuration, so bit-equality is unconditional (same compiled programs;
the CLAUDE.md tie carve-out only concerns DIFFERENT shape bucketings).

Usage: python scripts/fuzz_resume.py [--n 20] [--seed0 9000]
"""

import argparse
import os
import shutil
import sys
import tempfile
import time

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 "
    + os.environ.get("XLA_FLAGS", "")
)
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, "/root/repo")

from fwav.models.stream import compress_audio_streaming
from fwav.parallel.mesh import make_mesh
from fuzz_stream_mesh import _random_signal  # same content classes


def _damage(rng, root):
    """Vandalize a random subset of shard checkpoints under `root`.
    Returns a summary string. Always leaves at least one damaged file so
    every iteration actually exercises the re-encode path."""
    files = []
    for dirpath, _, names in os.walk(root):
        files.extend(
            os.path.join(dirpath, f) for f in names if f.startswith("shard_")
        )
    files.sort()
    assert files, "no checkpoints were written"
    kinds = []
    damaged = 0
    for f in files:
        k = int(rng.integers(0, 6))
        if k == 0:  # keep intact
            continue
        damaged += 1
        if k == 1:  # missing (crash before this shard)
            os.unlink(f)
            kinds.append("del")
        elif k == 2:  # truncated write (crash mid-np.save, no atomic rename)
            size = os.path.getsize(f)
            with open(f, "r+b") as fh:
                fh.truncate(int(rng.integers(0, max(1, size))))
            kinds.append("trunc")
        elif k == 3:  # garbage bytes
            with open(f, "wb") as fh:
                fh.write(rng.bytes(int(rng.integers(1, 4096))))
            kinds.append("garb")
        elif k == 4:  # valid npy, wrong shape/dtype (foreign checkpoint)
            np.save(f[:-4], np.zeros(int(rng.integers(1, 7)), np.float32))
            kinds.append("shape")
        else:  # stale temp beside it (crash between write and rename)
            shutil.copy(f, f + ".tmp")
            os.unlink(f)
            kinds.append("tmp")
    if damaged == 0:  # force at least one
        os.unlink(files[int(rng.integers(0, len(files)))])
        kinds.append("del")
    return "+".join(sorted(set(kinds)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--seed0", type=int, default=9000)
    args = ap.parse_args()
    fails = 0
    for k in range(args.n):
        seed = args.seed0 + k
        rng = np.random.default_rng(seed)
        sr = int(rng.choice([8000, 16000, 44100]))
        n = int(rng.integers(9000, 40000))
        tile = int(rng.choice([128, 512, 1024]))
        search = str(rng.choice(["auto", "exact", "coarse", "topk"]))
        objective = str(rng.choice(["balanced", "affine", "damped"]))
        dp, tp = [(1, 1), (8, 1), (4, 2), (2, 4), (1, 8)][int(rng.integers(0, 5))]
        shard = int(rng.choice([4096, 8192]))
        halo = int(rng.choice([2048, 4096, 8192]))
        sig = _random_signal(rng, n, sr)
        mesh = make_mesh(8, dp=dp, tp=tp) if dp * tp > 1 else None
        kw = dict(tile_size=tile, search=search, objective=objective,
                  shard_samples=shard, halo=halo, mesh=mesh)
        geo = (f"seed={seed} sr={sr} n={n} tile={tile} {search}/{objective} "
               f"dp={dp} tp={tp} shard={shard} halo={halo}")
        t0 = time.time()
        root = tempfile.mkdtemp(prefix="fwav_fuzz_resume_")
        try:
            rec0, *_ = compress_audio_streaming(sig, sr, 2, **kw)
            rec1, *_ = compress_audio_streaming(
                sig, sr, 2, resume_dir=root, **kw
            )
            if not np.array_equal(rec0, rec1):
                print(f"[{k}] {geo} FAIL: checkpointed run != plain run",
                      flush=True)
                fails += 1
                continue
            dmg = _damage(rng, root)
            rec2, *_ = compress_audio_streaming(
                sig, sr, 2, resume_dir=root, **kw
            )
        except Exception as e:
            print(f"[{k}] {geo} ERROR {type(e).__name__}: {e}", flush=True)
            fails += 1
            continue
        finally:
            shutil.rmtree(root, ignore_errors=True)
        if np.array_equal(rec0, rec2):
            print(f"[{k}] {geo} dmg={dmg} bit-equal ({time.time()-t0:.0f}s)",
                  flush=True)
        else:
            nd = int((rec0 != rec2).sum())
            print(f"[{k}] {geo} dmg={dmg} FAIL: {nd} records differ after "
                  "damaged resume", flush=True)
            fails += 1
    print(f"DONE: {args.n - fails}/{args.n} clean", flush=True)
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
