"""Opt-in cross-process executable cache (FWAV_EXEC_CACHE=dir).

Every CLI process pays the encode core's compile. JAX's own persistent
compilation cache (utils/compile_cache.py, on by default) is the first
answer; this module is the older, opt-in alternative kept until the two
are compared on the GPU (ROADMAP Design 3). The reference has no analog
problem only because it has no compiler (CuPy kernels,
fractal.py:637-754).

`jax.experimental.serialize_executable` pickles the LOADED PJRT
executable — a mechanism that skips XLA compilation at load (jax.export
stores StableHLO and recompiles). When the backend supports it, a
content-keyed disk cache ends the per-process compile tax.

Key = SHA-256 of (jax version, backend platform, device kind, device
count, the lowered StableHLO text). The StableHLO hash keys the exact
program — shapes, constants, config-derived structure — so a hit IS the
same computation; the platform/device fields keep executables from
crossing backends or topologies. EVERY failure mode (serialization
unsupported by the plugin, corrupt or truncated cache file, version
drift, an executable that cannot run here) falls back to the normal
compile for that call, so the cache can only skip work, never break an
encode; `stats` counts hits/misses/unserializable/errors for tests and
diagnostics.

Off by default: executables are multi-megabyte and rig-specific, and the
cache dir is trusted local state (entries are pickles — point
FWAV_EXEC_CACHE only at a PRIVATE directory you own, never a shared
world-writable one; same trust model as JAX's own compilation cache).
The directory is bounded: after each write, oldest-mtime entries are
evicted past FWAV_EXEC_CACHE_MAX_MB (default 1024) — stale keys from
code/jax-version churn cannot grow it without bound.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import tempfile
import threading

logger = logging.getLogger("fwavc")

#: Live counters (per process): cross-process disk hits, compiles that
#: populated the cache, serialize() rejections by the backend, and every
#: other failure that fell back to the plain jitted path (IO errors,
#: corrupt entries, executables that would not run here).
stats = {"hits": 0, "misses": 0, "unserializable": 0, "errors": 0}


def cache_dir():
    """The active cache directory, or None (feature off)."""
    d = os.environ.get("FWAV_EXEC_CACHE")
    return d or None


def _arg_sig(args):
    """Signature under which one compiled executable is reusable: the
    ABSTRACT value of every leaf (shape, dtype, weak_type — via jax's own
    abstractification, so a weak-f32 scalar and a committed f32 scalar key
    DIFFERENT entries exactly where jit would retrace; a Python float keys
    once per dtype, not once per value)."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(args)
    from jax.api_util import shaped_abstractify

    return (treedef, tuple(str(shaped_abstractify(leaf)) for leaf in leaves))


def _prune(d, keep: str):
    """Bound the cache directory: evict oldest-mtime entries beyond
    FWAV_EXEC_CACHE_MAX_MB (default 1024), never the just-written one.
    Best-effort — races with concurrent writers only make it evict less."""
    try:
        cap = int(os.environ.get("FWAV_EXEC_CACHE_MAX_MB", "1024")) << 20
        entries = []
        with os.scandir(d) as it:
            for e in it:
                if e.name.endswith(".fwexec"):
                    st = e.stat()
                    entries.append((st.st_mtime, st.st_size, e.path))
        total = sum(sz for _, sz, _ in entries)
        for _, sz, path in sorted(entries):
            if total <= cap:
                break
            if os.path.basename(path) == keep:
                continue
            try:
                os.unlink(path)
                total -= sz
            except OSError:
                pass
    except OSError:
        pass


def _load_or_compile(jitted, args, d):
    """AOT half: lower, key on the StableHLO, reload a serialized
    executable on a key hit, else compile and (best-effort) persist.
    Returns (fn, reloaded_from_disk)."""
    import jax

    lowered = jitted.lower(*args)
    dev = jax.devices()[0]
    try:  # backend identity beyond the platform name (e.g. runtime build)
        pv = dev.client.platform_version
    except Exception:  # noqa: BLE001
        pv = ""
    meta = (
        f"{jax.__version__}|{dev.platform}|{dev.device_kind}|{pv}"
        f"|{jax.device_count()}|"
    ).encode()
    key = hashlib.sha256(meta + lowered.as_text().encode()).hexdigest()
    name = key[:32] + ".fwexec"
    path = os.path.join(d, name)

    if os.path.exists(path):
        try:
            from jax.experimental import serialize_executable as se

            with open(path, "rb") as f:
                payload, in_tree, out_tree = pickle.load(f)
            loaded = se.deserialize_and_load(payload, in_tree, out_tree)
            stats["hits"] += 1
            logger.info("exec-cache hit: %s", name)
            return loaded, True
        except Exception:  # noqa: BLE001 — corrupt/foreign entry: recompile
            stats["errors"] += 1
            logger.warning("exec-cache entry unusable, recompiling: %s", path)

    compiled = lowered.compile()
    try:
        from jax.experimental import serialize_executable as se

        blob = pickle.dumps(se.serialize(compiled))
    except Exception:  # noqa: BLE001 — genuinely plugin-side
        stats["unserializable"] += 1
        logger.info("exec-cache: backend cannot serialize executables")
        return compiled, False
    try:
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)  # atomic: readers never see a partial file
        except BaseException:
            os.unlink(tmp)
            raise
        stats["misses"] += 1
        _prune(d, keep=name)
    except Exception:  # noqa: BLE001 — IO problem, NOT a backend limitation
        stats["errors"] += 1
        logger.warning("exec-cache: cannot persist to %s", d, exc_info=True)
    return compiled, False


def cached_jit(fun, **jit_kwargs):
    """jax.jit with a cross-process executable cache when FWAV_EXEC_CACHE
    is set; plain jax.jit otherwise (zero overhead — the env var is read
    per call so tests can toggle it). Shape-polymorphic like jit: each
    distinct argument signature keys its own executable."""
    import jax

    jitted = jax.jit(fun, **jit_kwargs)
    compiled = {}
    lock = threading.Lock()

    def call(*args):
        d = cache_dir()
        if not d:
            return jitted(*args)
        try:
            sig = _arg_sig(args)
        except Exception:  # noqa: BLE001
            stats["errors"] += 1
            return jitted(*args)
        fn = compiled.get(sig)
        if fn is None:
            with lock:
                fn = compiled.get(sig)
                if fn is None:
                    try:
                        fn, _ = _load_or_compile(jitted, args, d)
                    except Exception:  # noqa: BLE001 — never block the encode
                        stats["errors"] += 1
                        logger.warning("exec-cache failed, using plain jit",
                                       exc_info=True)
                        fn = jitted
                    if fn is not jitted:
                        # runtime guard on BOTH AOT paths (reloaded and
                        # freshly compiled): an executable that cannot
                        # EXECUTE with these concrete args (topology drift
                        # the key missed, machine-feature mismatch on CPU
                        # AOT, an aval nuance _arg_sig missed where plain
                        # jit would just retrace) permanently drops this
                        # signature back to the plain jit — the cache may
                        # only skip work
                        fn = _guard(fn, jitted, compiled, sig)
                    compiled[sig] = fn
        return fn(*args)

    return call


def _guard(loaded, jitted, table, sig):
    def run(*args):
        try:
            return loaded(*args)
        except Exception:  # noqa: BLE001 — see comment at the call site
            stats["errors"] += 1
            logger.warning(
                "exec-cache executable failed to run; using plain jit"
            )
            table[sig] = jitted
            return jitted(*args)

    return run
