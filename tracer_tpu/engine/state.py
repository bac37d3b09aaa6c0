"""Engine state pytree (replaces state.fut).

The reference threads one opaque functional state value through every
entry point (state.fut:8-19); here it is a frozen dataclass registered
as a pytree — traced leaves for everything that changes per frame (so
key presses don't recompile) and static meta fields for anything that
changes compiled shapes or code structure (dimensions, subsampling,
render mode, transmitter kind).

Being a pytree, the whole engine state checkpoints for free
(utils/checkpoint.py), covering the reference's implicit
"state is the checkpoint" design (SURVEY.md section 5).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax

from tracer_tpu.models import camera as cam_mod
from tracer_tpu.models import scene as scene_mod

_STATIC = ("width", "height", "subsampling", "render_mode",
           "transmitter_kind", "cam_conf_id")


@partial(jax.tree_util.register_dataclass,
         data_fields=["seed", "nonce", "img", "n_frames", "ambience", "mode",
                      "cam", "scene"],
         meta_fields=list(_STATIC))
@dataclasses.dataclass(frozen=True)
class EngineState:
    # --- static (recompile when changed)
    width: int
    height: int
    subsampling: int
    render_mode: str       # "color" | "distance"
    transmitter_kind: str  # camera.TRANSMITTER_*
    cam_conf_id: int

    # --- traced
    seed: jax.Array       # u32 scalar
    nonce: jax.Array      # u32 scalar; per-frame stream counter
    img: jax.Array        # (h_sub, w_sub, 3) f32 accumulated frame
    n_frames: jax.Array   # u32 scalar
    ambience: jax.Array   # (6, 2) sky spectrum
    mode: jax.Array       # bool scalar: progressive accumulation on
    cam: cam_mod.Camera
    scene: scene_mod.Scene

    def replace(self, **changes) -> "EngineState":
        """A copy with the given fields changed."""
        return dataclasses.replace(self, **changes)

    @property
    def sub_dims(self) -> tuple[int, int]:
        """(w, h) at the current subsampling (integrator.fut:105-107)."""
        ss = self.subsampling
        return (-(-self.width // ss), -(-self.height // ss))
