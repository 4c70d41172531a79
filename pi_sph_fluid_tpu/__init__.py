"""pi_sph_fluid_tpu — a 2-D WCSPH fluid framework for the GPU (JAX/XLA/Pallas).

A ground-up rebuild of the capabilities of colonelwatch/pi-sph-fluid
(`pi_sph_fluid.c`) for an accelerator: counting-sort hash grid, maskless
Pallas (Triton) window kernels over a row-triple merged candidate layout,
whole-tick-in-XLA leapfrog stepping, on-device metaball rendering, async
host I/O shell, and shard_map slab domain decomposition for multi-device
scale-out.

The production single-device path is models.engine_v3.WindowEngine; the
multi-device path is parallel.domain_window.WindowDomain; models.simulation
is the jnp oracle both are validated against.
"""

from .config import DEFAULT_CONFIG, SPHConfig
from .state import BoundaryState, FluidState, load_state, save_state
from .models.scene import (
    build_dam_break_scene,
    build_drop_scene,
    build_pool_scene,
    pixel_centers,
)
from .models.boundary import prepare_boundary
from .models.simulation import (
    SimState,
    StepStats,
    make_multi_step,
    make_step,
    prime,
    stats,
)
from .models.engine_v3 import PackedSim, WindowEngine

__version__ = "0.1.0"

__all__ = [
    "SPHConfig",
    "DEFAULT_CONFIG",
    "FluidState",
    "BoundaryState",
    "save_state",
    "load_state",
    "build_drop_scene",
    "build_dam_break_scene",
    "build_pool_scene",
    "pixel_centers",
    "prepare_boundary",
    "SimState",
    "StepStats",
    "prime",
    "make_step",
    "make_multi_step",
    "stats",
    "WindowEngine",
    "PackedSim",
]
