"""Entry-point plumbing: the compile cache helper, the device and peak
helpers of the benchmarks, the engine state pytree, and chip_smoke's
phases at tiny sizes on the CPU (its device phase refuses the CPU)."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import chip_smoke
import tracer_tpu as T
from benchmarks import _timing
from tracer_tpu.engine.state import EngineState
from tracer_tpu.utils import compile_cache, testscenes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_state(h=8, w=8, conf=0):
    tris, tm, mats = testscenes.cornell_like()
    return T.init(0, h, w, conf, tris, tm, mats, cam_origin=(0.0, 0.8, 1.8))


def test_compile_cache_follows_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: seen.append(a))
    assert compile_cache.enable() == "/some/where"
    assert seen == []          # nothing set in code


def test_compile_cache_default_is_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    path = compile_cache.enable()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert seen["jax_compilation_cache_dir"] == path
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_peaks_known_h100():
    p = _timing.peaks("NVIDIA H100 80GB HBM3")
    assert p == dict(bf16_tflops=989.0, f32_tflops=67.0, hbm_tb_per_s=3.35)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100"])
def test_peaks_unknown_device_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        _timing.peaks(kind)


def test_require_gpu_refuses_cpu():
    assert _timing.device_info()["platform"] == "cpu"
    with pytest.raises(SystemExit, match="no GPU"):
        _timing.require_gpu()


def test_median_time_reports_every_rep():
    med, reps = _timing.median_time(jax.jit(lambda x: x + 1), jnp.ones(4),
                                    reps=3)
    assert len(reps) == 3 and med == float(np.median(reps))


def test_engine_state_pytree_roundtrip():
    """Static fields live in the treedef (meta fields), traced fields are
    leaves, and flatten/unflatten rebuilds an equal state."""
    s = small_state()
    leaves, tdef = jax.tree.flatten(s)
    assert not any(isinstance(x, (str, int)) for x in leaves)
    back = jax.tree.unflatten(tdef, leaves)
    assert isinstance(back, EngineState)
    assert (back.width, back.render_mode) == (s.width, s.render_mode)
    other = jax.tree.flatten(s.replace(subsampling=2))[1]
    assert other != tdef       # a static change is a new treedef


def test_engine_state_replace_is_functional():
    s = small_state()
    s2 = s.replace(nonce=s.nonce + 1, subsampling=2)
    assert int(s2.nonce) == int(s.nonce) + 1 and s2.subsampling == 2
    assert int(s.nonce) == 0 and s.subsampling == 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.width = 3
    assert s2.sub_dims == (4, 4)


def test_chip_smoke_check_raises():
    chip_smoke.check(True, "fine")
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.check(False, "broken")


def test_chip_smoke_device_phase_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.phase_device()


def test_chip_smoke_kernel_phase_tiny():
    recs = chip_smoke.phase_kernel(cases=((0, 16, 16), (2, 16, 8)),
                                   interpret=True, reps=0)
    assert len(recs) == 4 and all(r["hit_dis"] == 0 for r in recs)


def test_chip_smoke_render_phases_tiny():
    chip_smoke.phase_headline(size=16, spp=4, cmp_spp=2)
    chip_smoke.phase_multichunk(size=16, spp=2, levels=1)


def test_chip_smoke_lidar_phase_tiny():
    out = chip_smoke.phase_lidar(w=32, h=24, spp=4)
    assert out["returns"] >= 0.9


def test_chip_smoke_viewer_phase_tiny():
    assert chip_smoke.phase_viewer(w=16, h=12, frames=3)["frames_per_s"] > 0


def test_chip_smoke_four_phase_tiny(devices8):
    out = chip_smoke.phase_four(size=16, spp=4, lidar_wh=(16, 8),
                                lidar_spp=4)
    assert set(out) == {"render_4x1_s", "render_2x2_s", "points_2x2_s"}


def test_chip_smoke_compare_images_counts_pixels():
    a = np.ones((10, 10, 3), np.float32)
    b = a.copy()
    b[0, 0] = 1.01             # one flipped pixel in 100: 99% close
    with pytest.raises(chip_smoke.CheckFailed, match="99.5%"):
        chip_smoke.compare_images(b, a, "one flip")
    big = np.ones((100, 100, 3), np.float32)
    flipped = big.copy()
    flipped[0, 0] = 1.5        # one in 10,000 still passes
    chip_smoke.compare_images(flipped, big, "rare flip")
