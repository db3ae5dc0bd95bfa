"""Logging + startup banner.

The reference prints a CPU/GPU capability banner at import (fractal.py:48-57).
We log the JAX device lazily (device discovery is not free) and never at
import time.
"""

from __future__ import annotations

import logging

#: A LIBRARY never calls logging.basicConfig (that would hijack the
#: embedding application's root-logger configuration); configure only our
#: own logger and let it propagate if the app has handlers. The CLI calls
#: configure_cli_logging() for the standalone experience.
logger = logging.getLogger("fwavc")
logger.setLevel(logging.INFO)


def configure_cli_logging() -> None:
    """Root-logger setup for the standalone CLI (not for library use)."""
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s: %(message)s"
    )


_banner_done = False


def device_banner() -> str:
    """One-line device summary + self-test, logged once on first pipeline
    use: the platform, device kind and count JAX selected, and a tiny
    jitted reduction that validates it (the reference's CuPy self-test,
    fractal.py:38-57). Which backend runs is JAX's choice (JAX_PLATFORMS);
    the banner only reports it."""
    global _banner_done
    if _banner_done:
        return _banner_msg
    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    platform = devs[0].platform if devs else "none"
    kind = devs[0].device_kind if devs else "none"
    try:
        ok = int(jax.jit(lambda: jnp.arange(2).sum())()) == 1
    except Exception:  # noqa: BLE001 — mirror the reference's broad self-test
        ok = False
    msg = (f"[FWAVC] platform={platform} device_kind={kind} "
           f"devices={len(devs)} self-test={'ok' if ok else 'FAILED'}")
    if ok:
        logger.info(msg)
    else:
        logger.warning(msg + " — device dispatch failed its smoke test")
    _set_banner(msg)
    return msg


_banner_msg = ""


def _set_banner(msg: str) -> None:
    global _banner_done, _banner_msg
    # publish the message BEFORE the done flag: a concurrent
    # device_banner() that observes _banner_done must never read the
    # empty-string placeholder
    _banner_msg = msg
    _banner_done = True
