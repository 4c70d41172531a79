"""Particle state pytrees (structure-of-arrays, float32).

The reference stores particles as an array-of-structs ``struct particle
{x,y,u,v,m,rho,p}`` (`pi_sph_fluid.c:26-31`) and transposes neighbor copies to
SoA for vectorisation (`pi_sph_fluid.c:155-163`).  On an accelerator the SoA layout is
the native one, so state is SoA from the start: one flat float32 array per
field.  NamedTuples register as pytrees automatically, flow through jit /
scan / shard_map, and support donation.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

__all__ = ["FluidState", "BoundaryState", "save_state", "load_state"]


class FluidState(NamedTuple):
    """Dynamic fluid particles.  All fields shape (N,), float32."""

    x: jnp.ndarray    # position x
    y: jnp.ndarray    # position y
    u: jnp.ndarray    # velocity x
    v: jnp.ndarray    # velocity y
    m: jnp.ndarray    # mass (RHO_0*V for fluid, `pi_sph_fluid.c:502`)
    rho: jnp.ndarray  # SPH density
    p: jnp.ndarray    # WCSPH pressure

    @property
    def n(self) -> int:
        return self.x.shape[0]

    def permute(self, order: jnp.ndarray) -> "FluidState":
        """Reorder all fields by ``order`` (used by the counting-sort grid)."""
        return FluidState(*(f[order] for f in self))


class BoundaryState(NamedTuple):
    """Static Akinci boundary particles.  All fields shape (Nb,), float32.

    ``m`` holds the pseudo-mass psi computed once at scene build
    (`pi_sph_fluid.c:242-261`); ``rho`` is pinned at rho_0; velocities are
    zero but kept so boundary can be treated uniformly in pair math.
    """

    x: jnp.ndarray
    y: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    m: jnp.ndarray
    rho: jnp.ndarray

    @property
    def n(self) -> int:
        return self.x.shape[0]

    def permute(self, order: jnp.ndarray) -> "BoundaryState":
        return BoundaryState(*(f[order] for f in self))


def save_state(path: str, **pytrees) -> None:
    """Checkpoint arbitrary named pytrees of arrays to an .npz file.

    The reference has no checkpointing (state is ephemeral, SURVEY.md §5);
    this is the minimal save/load needed for parity fixtures and resume.
    """
    flat = {}
    for name, tree in pytrees.items():
        if hasattr(tree, "_fields"):
            for field, arr in zip(tree._fields, tree):
                flat[f"{name}.{field}"] = np.asarray(arr)
        else:
            flat[name] = np.asarray(tree)
    np.savez(path, **flat)


def load_state(path: str) -> dict:
    """Load a checkpoint back into a dict of {name: FluidState|BoundaryState|array}."""
    raw = dict(np.load(path))
    groups: dict = {}
    for key, arr in raw.items():
        if "." in key:
            name, field = key.split(".", 1)
            groups.setdefault(name, {})[field] = jnp.asarray(arr)
        else:
            groups[key] = jnp.asarray(arr)
    out: dict = {}
    for name, val in groups.items():
        if isinstance(val, dict):
            if set(val) == set(FluidState._fields):
                out[name] = FluidState(**val)
            elif set(val) == set(BoundaryState._fields):
                out[name] = BoundaryState(**val)
            else:
                out[name] = val
        else:
            out[name] = val
    return out
