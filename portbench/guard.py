"""The import guard: the benchmark measures the PyTorch port alone, so no run
may load JAX, its libraries or the JAX package. Module names are compared by
their top-level name, whole (`nu_scaler_tpu_torch` is not `nu_scaler_tpu`)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "orbax", "nu_scaler_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among `modules` (default `sys.modules`)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)
