"""Managed-platform / serverless entry point — the one CPU deployment.

Role of the reference's Vercel entry (reference: api/index.py:1-13, which
re-exports the FastAPI app with NUMBA_CACHE_DIR pointed at /tmp for the
read-only filesystem; routing in vercel.json:44-53). The equivalents here:

- the backend is the CPU unless the platform names another through
  `MCOS_BACKEND` (managed serverless containers are CPU-shaped; the
  reference's serverless deployment is CPU-only too),
- the JIT compilation cache goes where JAX_COMPILATION_CACHE_DIR says (a
  read-only filesystem sets it to a writable path), else to the fixed
  in-checkout directory (utils/checkpoint.py),
- `serve_wsgi` runs the stdlib transport on $PORT.

Usage:
    python -m mcos_tpu.api.serverless
"""

from __future__ import annotations

import os

# Must run before jax initializes.
os.environ.setdefault("JAX_PLATFORMS", os.environ.get("MCOS_BACKEND", "cpu"))


def serve_wsgi() -> None:
    """Resident ThreadingHTTPServer on $PORT."""
    from mcos_tpu.api.server import serve
    from mcos_tpu.utils.checkpoint import enable_compilation_cache

    enable_compilation_cache()
    port = int(os.environ.get("PORT", "8000"))
    serve(host="0.0.0.0", port=port).serve_forever()


if __name__ == "__main__":
    serve_wsgi()
