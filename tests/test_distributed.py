"""Multi-process (multi-host analog) validation: 2-process CPU loopback.

The reference's only multi-process scaling is N CPU workers + mp.Queues on
one host (fractal.py:1176-1237). The analog here is JAX's distributed
runtime: parallel.mesh.init_distributed forms a GLOBAL mesh whose
collectives run across processes (VERDICT r4 item 8 — previously
smoke-tested at num_processes=1 only). This test launches two REAL
jax.distributed processes over localhost (CPU backend, 4 local devices
each), forms the 8-device global (dp=4, tp=2) mesh in each, and runs the
PRODUCTION sharded encode (parallel.shard.compress_audio_sharded — the
same fused core + shard_map path as single-host meshes, fetched through
parallel.mesh.fetch_global's allgather branch), asserting in BOTH
processes that the records are bit-equal to the single-device encode.
"""

import os
import socket
import subprocess
import sys

_CHILD = r"""
import sys
proc_id = int(sys.argv[1])
port = sys.argv[2]
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
jax.distributed.initialize(coordinator_address="localhost:" + port,
                           num_processes=2, process_id=proc_id)
import numpy as np

assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())
assert len(jax.local_devices()) == 4, len(jax.local_devices())

from fwav.parallel.mesh import make_mesh, init_distributed  # noqa: F401
from fwav.parallel.shard import compress_audio_sharded
from fwav.models.encode import compress_audio_arrays

rng = np.random.default_rng(7)
t = np.arange(16000 * 2) / 16000.0
sig = (0.4 * np.sin(2 * np.pi * 330 * t) + 0.1 * np.sin(2 * np.pi * 990 * t)
       + 0.01 * rng.standard_normal(len(t)))
sig[4000:5600] = 0.0  # silence gap -> sentinel ranges must agree too
sig = np.round(sig * 16000).astype(np.float32)

mesh = make_mesh(8, dp=4, tp=2)
rec, bank, *_ = compress_audio_sharded(sig, 16000, 2, mesh=mesh,
                                       tile_size=256)
rec1, bank1, *_ = compress_audio_arrays(sig, 16000, 2, tile_size=256)
for f in ("idx", "s", "o", "sym", "err"):
    assert np.array_equal(rec[f], rec1[f]), f
assert np.array_equal(bank, bank1)
assert (rec["idx"] >= 0).any() and (rec["idx"] < 0).any()
print(f"DIST_OK p{proc_id} n={len(rec)}", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_loopback_encode_bit_equal(tmp_path):
    """jax.distributed over localhost: global mesh forms, the production
    sharded encode runs across process boundaries, records bit-equal to
    single-device in BOTH processes."""
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    port = str(_free_port())
    env = dict(os.environ)
    # the child configures its own device count in-process; the parent
    # conftest's 8-device XLA flag must not leak in
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = (
        os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    ).rstrip(os.pathsep)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=os.getcwd(),
        )
        for i in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
        assert f"DIST_OK p{i}" in out, out[-4000:]
