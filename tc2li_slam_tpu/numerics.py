"""Numerics policy: float32 contractions run at full float32 precision.

A GPU with tensor cores may run a float32 matrix product in TF32, which
keeps about three decimal digits, unless the program asks for more. The
solvers here build f32 normal equations whose conditioning the reference
hides behind doubles, and the filters are held to f64 oracles, so every
function of ``geom/``, ``estimation/``, ``solver/``, ``ops/plane_fit.py``
and ``parallel/dist_ba.py`` that contracts float32 arrays is traced under
``jax.default_matmul_precision("highest")`` through ``f32_highest``.

The bf16 contractions elsewhere are exact by construction and keep the
default. No global setting is changed.
"""

from __future__ import annotations

import functools

import jax


def f32_highest(fn):
    """Trace ``fn``'s body with float32 matmul precision HIGHEST.

    The precision is resolved when each ``dot_general`` is traced, so it
    holds wherever ``fn`` is called from, inside any outer ``jit``, and
    whatever precision the caller or the global option asks for."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
