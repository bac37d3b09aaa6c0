"""Scene assembly: triangles + material table + lights + acceleration
structure (replaces scene.fut).

Acceleration is pluggable behind a common query interface, mirroring the
reference's module-type-abstracted bvh (bvh.fut:11-23):
  * "dense"  — the exhaustive chunked intersector (ops/intersect.py: a
               fused culling kernel on GPU, the XLA formulation
               elsewhere; also the correctness oracle, like mk_fake_bvh
               bvh.fut:25-43)
  * "lbvh"   — morton/Karras LBVH with stackless traversal (bvh.fut:75-168)
Light extraction happens host-side at scene build: light count must be
static under jit anyway (SURVEY.md section 7 "dynamic shapes").
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import jax
import jax.numpy as jnp

from tracer_tpu.models import lights as lights_mod
from tracer_tpu.ops import bvh as bvh_mod
from tracer_tpu.ops import intersect, materials, tables
from tracer_tpu.ops import linalg as la

Accel = Union[intersect.DenseTris, bvh_mod.LBVH]

# Triangle count at/below which "auto" picks the dense intersector. Dense
# is the production default; LBVH remains for parity, tests and host-side
# experimentation. Above the cap "auto" raises instead of silently
# routing onto the LBVH traversal: no size past it is verified. The cap
# predates the GPU kernel; which accelerator pays past ~1M triangles on
# the H100 is not measured (ROADMAP B5).
DENSE_THRESHOLD = 2_500_000


class Scene(NamedTuple):
    tris: jax.Array              # (T, 3, 3)
    mat_ix: jax.Array            # (max(T,1),) int32, input triangle order
    materials: materials.MaterialTable
    mat_rows: jax.Array          # (max(M,1), 28) raw material rows
    tri_mat: jax.Array           # (max(T,1),) int32 material id per triangle
                                 # in ACCEL STORAGE order (hit indices)
    lights: lights_mod.Lights    # emissive triangles (scene.fut:58-66)
    light_table: jax.Array       # (L, 23) packed [tri 9 | emission 12 | theta | kind]
    accel: Accel


def extract_lights(tris_np, tri_mats_np, mat_rows_np) -> lights_mod.Lights:
    """Host-side emissive-triangle extraction (get_lights, scene.fut:58-66):
    a material is emissive when any knot has wavelength >= 0 and
    intensity > 0."""
    mat_rows_np = np.asarray(mat_rows_np, np.float32)
    emission = mat_rows_np[:, 16:28].reshape(-1, 6, 2)
    emissive_mat = ((emission[:, :, 0] >= 0) & (emission[:, :, 1] > 0)).any(axis=1)
    mask = emissive_mat[np.asarray(tri_mats_np, np.int64)]
    sel = np.nonzero(mask)[0]
    if sel.size == 0:
        return lights_mod.empty_lights()
    tri = np.asarray(tris_np, np.float32)[sel]
    em = emission[np.asarray(tri_mats_np, np.int64)[sel]]
    return lights_mod.Lights(
        kind=jnp.full((sel.size,), lights_mod.KIND_DIFFUSE_AREA, jnp.int32),
        tri=jnp.asarray(tri),
        theta=jnp.zeros((sel.size,), jnp.float32),
        emission=jnp.asarray(em))


def build_scene(tris_np, tri_mats_np, mat_rows_np,
                accel: str = "auto") -> Scene:
    """Assemble + accelerate a scene from loader output
    (parse_triangles/parse_mats/accelerate_scene, scene.fut:26-76).

    tris_np: (T, 3, 3) f32; tri_mats_np: (T,) u32; mat_rows_np: (M, 28) f32.
    accel: "dense" | "lbvh" | "auto" (size-based choice).
    """
    tris_np = np.asarray(tris_np, np.float32).reshape(-1, 3, 3)
    tri_mats_np = np.asarray(tri_mats_np, np.int64)
    mat_rows_np = np.asarray(mat_rows_np, np.float32).reshape(-1, 28)
    t = tris_np.shape[0]
    # keep gather tables non-empty so empty scenes still trace (misses only)
    mat_ix_padded = tri_mats_np if t > 0 else np.zeros((1,), np.int64)
    if mat_rows_np.shape[0] == 0:
        mat_rows_np = np.zeros((1, 28), np.float32)
    if accel == "auto":
        if t > DENSE_THRESHOLD:
            raise ValueError(
                f"scene has {t} triangles, above the verified dense "
                f"cap ({DENSE_THRESHOLD}); pass accel='lbvh' or "
                f"accel='dense' explicitly to run past it")
        accel = "dense"
    tris = jnp.asarray(tris_np)
    # tri_mat is indexed by the accel's returned triangle index, so it
    # must follow the accel's storage order: the dense intersector
    # morton-sorts its triangles (intersect.build_dense), the LBVH maps
    # hits back to input order itself (bvh.closest_hit perm).
    if accel == "dense":
        acc: Accel = intersect.build_dense(
            tris, aux=mat_ix_padded[:t].astype(np.float32))
        order = np.asarray(acc.perm)[:max(t, 1)]
        order = np.where(order < max(t, 1), order, 0)
        row_ix = mat_ix_padded[order] if t > 0 else mat_ix_padded
    elif accel == "lbvh":
        acc = bvh_mod.build(tris)
        row_ix = mat_ix_padded
    else:
        raise ValueError(f"unknown accel {accel!r}")
    lights = extract_lights(tris_np, tri_mats_np, mat_rows_np)
    return Scene(
        tris=tris,
        mat_ix=jnp.asarray(mat_ix_padded, jnp.int32),
        materials=materials.parse_mats(mat_rows_np),
        mat_rows=jnp.asarray(mat_rows_np),
        tri_mat=jnp.asarray(row_ix, jnp.int32),
        lights=lights,
        light_table=pack_light_table(lights),
        accel=acc)


def add_point_light(scene: Scene, pos, emission) -> Scene:
    """Append a #pointlight (light.fut:10) to the scene's light set.

    The reference's loaders never emit point lights but its light type
    supports them; this is the API-level equivalent. pos: (3,) world
    position; emission: (6, 2) spectrum knots."""
    pos = np.asarray(pos, np.float32)
    tri = np.broadcast_to(pos, (1, 3, 3)).copy()  # vertex 0 holds pos
    lights = lights_mod.Lights(
        kind=jnp.concatenate([scene.lights.kind,
                              jnp.asarray([lights_mod.KIND_POINT],
                                          jnp.int32)]),
        tri=jnp.concatenate([scene.lights.tri, jnp.asarray(tri)]),
        theta=jnp.concatenate([scene.lights.theta,
                               jnp.zeros((1,), jnp.float32)]),
        emission=jnp.concatenate(
            [scene.lights.emission,
             jnp.asarray(emission, jnp.float32).reshape(1, 6, 2)]))
    return scene._replace(lights=lights, light_table=pack_light_table(lights))


def pack_light_table(lights: lights_mod.Lights) -> jax.Array:
    """Pack the light SoA into one (L, 23) f32 table so per-lane light
    selection is a single one-hot matmul row fetch:
    columns [tri(9) | emission knots(12) | theta | kind]."""
    l = lights.count
    if l == 0:
        return jnp.zeros((0, 23), jnp.float32)
    return jnp.concatenate([
        lights.tri.reshape(l, 9),
        lights.emission.reshape(l, 12),
        lights.theta[:, None],
        lights.kind.astype(jnp.float32)[:, None],
    ], axis=1)


def closest_hit(scene: Scene, tmax, origin, d):
    """Dispatch to the active acceleration structure. Rays are V3 (3,N);
    returns (ok, t, tri_idx, pos (3,N), normal (3,N)).

    tri_idx is in the accel's STORAGE order: morton order for the dense
    intersector (map through scene.accel.perm to recover input order —
    the hot path never needs to, per-triangle data rides the coeffs' aux
    column instead), input order for the LBVH (its leaves store input
    ids)."""
    if isinstance(scene.accel, intersect.DenseTris):
        return intersect.closest_hit(scene.accel, tmax, origin, d)[:5]
    n = jnp.broadcast_shapes(origin.shape, d.shape)[1]
    o_a = la.v3_to_array(jnp.broadcast_to(origin, (3, n)))
    d_a = la.v3_to_array(jnp.broadcast_to(d, (3, n)))
    ok, t, idx, pos, nrm = bvh_mod.closest_hit(scene.accel, tmax, o_a, d_a)
    return ok, t, idx, la.v3_from_array(pos), la.v3_from_array(nrm)


def any_hit(scene: Scene, tmax, origin, d):
    """Shadow query; rays are V3 (3,N)."""
    if isinstance(scene.accel, intersect.DenseTris):
        return intersect.any_hit(scene.accel, tmax, origin, d)
    n = jnp.broadcast_shapes(origin.shape, d.shape)[1]
    o_a = la.v3_to_array(jnp.broadcast_to(origin, (3, n)))
    d_a = la.v3_to_array(jnp.broadcast_to(d, (3, n)))
    return bvh_mod.any_hit(scene.accel, tmax, o_a, d_a)


class Interaction(NamedTuple):
    """Per-lane surface interaction (material.fut:22 'interaction')."""
    ok: jax.Array       # (N,) bool
    t: jax.Array        # (N,)
    pos: jax.Array      # V3 (3, N)
    normal: jax.Array   # V3 (3, N)
    mat: materials.MaterialLanes
    emission_at_wl: jax.Array  # (N,) emission spectrum at the hero wavelength


def closest_interaction(scene: Scene, tmax, origin, d, wavelen) -> Interaction:
    """closest_hit + material row fetch evaluated at the hero wavelength
    (closest_interaction, scene.fut:68-73). The fetch is two-level: a
    1-int-per-lane triangle->material-id lookup (for the dense
    intersector it rides the aux column), then a row fetch from the
    SMALL (M, 28) material table (ops/tables.py)."""
    if isinstance(scene.accel, intersect.DenseTris):
        # material id rides the dense intersector's aux column — no
        # extra per-lane fetch
        ok, t, tri_idx, pos, normal, aux = intersect.closest_hit(
            scene.accel, tmax, origin, d)
        lane_mat = aux.astype(jnp.int32)
    else:
        ok, t, tri_idx, pos, normal = closest_hit(scene, tmax, origin, d)
        safe_idx = jnp.where(ok, jnp.maximum(tri_idx, 0), 0)
        lane_mat = tables.take_scalar(scene.tri_mat, safe_idx)
    rows_t = tables.take_rows_t(scene.mat_rows, lane_mat)   # (28, N)
    mat, emission = materials.at_wavelength_rows(rows_t, wavelen)
    return Interaction(ok=ok, t=t, pos=pos, normal=normal, mat=mat,
                       emission_at_wl=emission)
