"""Logging / message catalog.

Counterpart of the reference's printf macro catalog with three
compile-time levels (``pangulu_strings.h:1-69``, ``-DPANGULU_LOG_*``).
Here: a standard :mod:`logging` logger with the same level tiers and a
config-banner helper (pangulu_strings.h:91-147).
"""

from __future__ import annotations

import logging
import os

_LEVELS = {"error": logging.ERROR, "warning": logging.WARNING,
           "info": logging.INFO, "debug": logging.DEBUG}

# The environment settings the package reads.  Any other PANGULU_*
# variable (a misspelling, or a setting an earlier release read) is
# reported once instead of being ignored in silence; PANGULU_BENCH_*
# belong to bench.py.
KNOWN_SETTINGS = ("PANGULU_LOG", "PANGULU_DIST_DD")


def unknown_settings(environ=os.environ) -> list[str]:
    return sorted(k for k in environ
                  if k.startswith("PANGULU_") and k not in KNOWN_SETTINGS
                  and not k.startswith("PANGULU_BENCH_"))


def get_logger() -> logging.Logger:
    log = logging.getLogger("pangulu_jax")
    if not log.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[pangulu_jax %(levelname)s] %(message)s"))
        log.addHandler(h)
        log.setLevel(_LEVELS.get(
            os.environ.get("PANGULU_LOG", "warning").lower(),
            logging.WARNING))
        log.propagate = False
        unknown = unknown_settings()
        if unknown:
            log.warning("ignoring unknown environment settings %s; the "
                        "package reads %s", ", ".join(unknown),
                        ", ".join(KNOWN_SETTINGS))
    return log


def config_banner(opts, n: int, nnz: int, mesh_shape=None) -> str:
    """Config table printed at init (reference: pangulu_strings.h:91-147)."""
    rows = [
        ("n", n),
        ("nnz", nnz),
        ("nb", opts.nb),
        ("value type", opts.dtype),
        ("mc64", opts.mc64),
        ("ordering", opts.ordering),
        ("symbolic", opts.symbolic_mode),
        ("kernel backend", opts.backend),
        ("mesh", mesh_shape or "single-chip"),
    ]
    width = max(len(str(k)) for k, _ in rows)
    lines = ["pangulu_jax configuration:"]
    lines += [f"  {k:<{width}} : {v}" for k, v in rows]
    return "\n".join(lines)
