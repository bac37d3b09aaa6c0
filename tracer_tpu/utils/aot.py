"""AOT export of compiled engine executables (jax.export / StableHLO).

The reference's build emits a generated C kernel library — tracer.c/.h,
compiled once and linked by the host apps, usable without the Futhark
compiler installed (SURVEY.md §2.2 "generated kernel library";
demo-interactive/Makefile consumes it). The analog here: serialize
the jitted engine executables as StableHLO artifacts via jax.export,
keyed to the engine-state shapes, and reload them in a fresh process
with NO Python retrace of the renderer. The persistent XLA compile
cache (utils/compile_cache.py) covers the same-machine rerun case; an exported
artifact is the shippable one.

Notes:
  * An artifact records its lowering platform (cpu / cuda); export on the
    platform that will run it.
  * The callable returned by load() takes the same EngineState pytree
    the function was exported with (same shapes/dtypes AND the same
    static fields — they live in the pytree treedef). Pair an artifact
    with utils/checkpoint.py (standalone state restore) to render in a
    process that never builds a scene.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp  # noqa: F401  (re-exported convenience)
from jax import export as _jexport


def _register_pytrees() -> None:
    """jax.export serializes treedefs by registered name; every custom
    pytree node reachable from EngineState needs a serialization entry.
    Idempotent (double-registration raises ValueError)."""
    from tracer_tpu.engine.state import EngineState
    from tracer_tpu.models.camera import Camera, CameraConfig
    from tracer_tpu.models.lights import Lights
    from tracer_tpu.models.scene import Scene
    from tracer_tpu.ops.bvh import LBVH
    from tracer_tpu.ops.intersect import DenseTris
    from tracer_tpu.ops.materials import MaterialTable
    from tracer_tpu.ops.radix_tree import RadixTree

    for nt in (CameraConfig, Camera, Scene, DenseTris, LBVH, Lights,
               MaterialTable, RadixTree):
        try:
            _jexport.register_namedtuple_serialization(
                nt, serialized_name=f"tracer_tpu.{nt.__name__}")
        except ValueError:
            pass
    try:
        # EngineState auxdata is the tuple of static fields
        # (width, height, subsampling, render_mode, transmitter_kind,
        # cam_conf_id) — all JSON scalars
        _jexport.register_pytree_node_serialization(
            EngineState,
            serialized_name="tracer_tpu.EngineState",
            serialize_auxdata=lambda aux: json.dumps(list(aux)).encode(),
            deserialize_auxdata=lambda b: tuple(json.loads(bytes(b).decode())),
        )
    except ValueError:
        pass


_register_pytrees()


def export_fn(fn, *example_args) -> bytes:
    """Serialize jit(fn) specialized to example_args' shapes/dtypes.

    example_args may be arbitrary pytrees (e.g. EngineState); leaves are
    reduced to ShapeDtypeStructs so no device values are captured.
    """
    shapes = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(jnp.shape(x), jnp.result_type(x)),
        example_args)
    exported = _jexport.export(jax.jit(fn))(*shapes)
    return exported.serialize()


def load(blob: bytes):
    """Deserialize an export_fn artifact into a callable.

    The call runs the stored StableHLO through XLA directly — the
    renderer's Python (integrator, kernels, scene assembly) is never
    retraced. The package must still be importable for the state
    pytree's class registrations (this module imports them).
    """
    exported = _jexport.deserialize(blob)
    return exported.call


def export_step(state) -> bytes:
    """The flagship artifact: one progressive path-traced frame
    (engine/api._step_core — the `step` entry point, lib.fut:97-117
    equivalent) specialized to `state`'s scene/image shapes."""
    from tracer_tpu.engine.api import _step_core

    return export_fn(_step_core, state)


def save_step(state, path: str) -> None:
    with open(path, "wb") as f:
        f.write(export_step(state))


def load_step(path: str):
    with open(path, "rb") as f:
        return load(f.read())
