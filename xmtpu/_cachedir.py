"""Where the JAX persistent compilation cache lives.

Import-safe before jax (no jax imports). Rule: if
``JAX_COMPILATION_CACHE_DIR`` is set, the program uses that directory
and sets no other. If it is not set, the cache goes to one fixed
directory inside the checkout, ``<repo>/.jax_cache/<host fingerprint>``
(``.jax_cache`` is listed in ``.gitignore``): a fixed path keeps the
cache's key stable from run to run.

Why a host-fingerprint subdirectory: XLA:CPU executables record the
build machine's CPU feature set; loading them on a different host only
WARNS ("Machine type used for XLA:CPU compilation doesn't match ...")
and can then compute wrong numerics. Keying the subdirectory by the CPU
identity (model name and feature flags, which are stable on a host)
makes a host change start a fresh cache instead.
"""

from __future__ import annotations

import hashlib
import os
import platform

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# identity lines: x86 (flags/model name/...) and aarch64 (Features/CPU
# implementer/part/variant/architecture). Volatile lines ("cpu MHz",
# "bogomips") stay out: they change across boots.
_ID_PREFIXES = ("flags", "model name", "vendor_id", "cpu family",
                "model\t", "stepping", "Features", "CPU implementer",
                "CPU part", "CPU variant", "CPU architecture")


def host_fingerprint() -> str:
    """12 hex digits naming this host's CPU (machine + cpuinfo id lines)."""
    ident = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if ln.startswith(_ID_PREFIXES):
                    ident.append(ln.strip())
                if ln.strip() == "":
                    break  # one processor block is enough
    except OSError:
        ident.append(platform.processor())
    return hashlib.sha1("\n".join(sorted(set(ident))).encode()).hexdigest()[:12]


def cache_dir(environ=os.environ) -> str:
    """The cache directory: ``$JAX_COMPILATION_CACHE_DIR`` when set, else
    ``<repo>/.jax_cache/<host fingerprint>``."""
    explicit = environ.get(ENV)
    if explicit:
        return explicit
    return os.path.join(REPO_ROOT, ".jax_cache", host_fingerprint())
