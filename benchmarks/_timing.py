"""Device and timing helpers shared by bench.py, benchmarks/run_all.py
and chip_smoke.py.

Discipline: warm every shape up first (compilation is set-up time), end
each timed region in `block_until_ready`, and report the median of
several reps. Every result names the device it ran on, and a measurement
path that finds no GPU fails instead of timing the CPU.
"""

import subprocess
import time

import numpy as np

# Published peaks of one H100 (NVIDIA H100 Tensor Core GPU data sheet,
# SXM5 part, dense rates, at its 700 W power limit), keyed by JAX's
# device_kind.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16_tflops=989.0, f32_tflops=67.0,
                                  hbm_tb_per_s=3.35),
}


def peaks(device_kind: str) -> dict:
    """The peak table entry for device_kind; an unknown device is an
    error, never a guessed peak."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(f"no published peaks for device {device_kind!r}; "
                         f"known: {sorted(PEAKS)}") from None


def device_info() -> dict:
    """{"platform", "kind", "count"} of the devices JAX selected."""
    import jax
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def require_gpu() -> dict:
    """device_info(), or SystemExit when JAX found no GPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX selected {info}; refusing to "
                         "measure")
    return info


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` (a child process that
    stays off JAX); the card's limit belongs beside every number."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def median_time(fn, *args, reps: int = 5):
    """(median seconds, all rep seconds) of fn(*args) after one warm-up
    call; each rep ends in block_until_ready."""
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def render_fn(state, spp: int):
    """Jitted (nonce) -> (img, rays_traced) pooled render of `state`'s
    scene and camera: the timed unit of the render benchmarks."""
    import jax

    from tracer_tpu.engine import integrator

    w, h = state.sub_dims

    @jax.jit
    def render(seed, nonce, scene, cam, ambience):
        out = integrator.render_pooled(
            seed, nonce, scene, cam, ambience, w, h,
            state.transmitter_kind, spp, state.render_mode)
        return out["img"], out["rays_traced"]

    return lambda nonce: render(state.seed, nonce, state.scene, state.cam,
                                state.ambience)
