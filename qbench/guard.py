"""The import check: nothing the benchmark runs loads JAX or the JAX
package, and the reference loads nothing of the measured package either.

Names are compared by their top-level part (before the first dot), whole:
the measured package's name begins with the JAX package's, so a prefix
match would confuse them.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "qingdai_tpu"})
MEASURED = "qingdai_tpu_torch"


def top_levels(modules=None) -> set:
    return {name.split(".")[0] for name in (sys.modules if modules is None else modules)}


def forbidden_loaded(modules=None, also=()) -> list:
    """The forbidden top-level names among the loaded modules."""
    return sorted(top_levels(modules) & (FORBIDDEN | set(also)))
