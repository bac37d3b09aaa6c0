"""Aux subsystems: checkpoint/resume, profiling, PNG writer."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

import tracer_tpu as T
from tracer_tpu.utils import checkpoint, profiling, testscenes
from tracer_tpu.utils.image import argb_to_rgb, write_png


def small_state():
    tris, tm, mats = testscenes.cornell_like()
    return T.init(0, 8, 8, 0, tris, tm, mats, cam_origin=(0.0, 0.8, 1.8))


@pytest.mark.smoke
def test_checkpoint_save_load_resume(tmp_path):
    s = T.step(small_state())
    p = str(tmp_path / "ck.npz")
    checkpoint.save(p, s)
    restored = checkpoint.load(p, template=small_state())
    assert int(restored.n_frames) == int(s.n_frames)
    a = T.step(s)
    b = T.step(restored)
    np.testing.assert_array_equal(np.asarray(a.img), np.asarray(b.img))


def test_checkpoint_rejects_mismatched_template(tmp_path):
    s = small_state()
    p = str(tmp_path / "ck.npz")
    checkpoint.save(p, s)
    tris, tm, mats = testscenes.cornell_like()
    other = T.init(0, 16, 16, 0, tris, tm, mats)
    try:
        checkpoint.load(p, template=other)
        raise AssertionError("expected failure")
    except (ValueError, TypeError):
        pass


def test_checkpoint_refuses_malicious_treedef(tmp_path):
    """load() must not execute arbitrary pickle payloads: the stored
    treedef goes through a restricted unpickler that only admits the jax
    pytree machinery and tracer_tpu struct classes."""
    import json
    import pickle
    import pytest

    p = str(tmp_path / "evil.npz")
    static = {"version": 2, "width": 8, "height": 8, "subsampling": 1,
              "render_mode": "color", "transmitter_kind": "point",
              "cam_conf_id": 0}
    payload = pickle.dumps(eval, protocol=2)  # any non-allowlisted global
    np.savez_compressed(
        p,
        __static__=np.frombuffer(json.dumps(static).encode(), dtype=np.uint8),
        __treedef__=np.frombuffer(payload, dtype=np.uint8))
    with pytest.raises(pickle.UnpicklingError, match="disallowed"):
        checkpoint.load(p)


def test_phase_timer():
    t = profiling.PhaseTimer()
    x = jnp.arange(8.0)
    with t.phase("a", sync=x):
        x = x + 1
    with t.phase("a"):
        pass
    assert t.counts["a"] == 2
    assert "a" in t.report()
    assert "total_s" in t.as_json()


@pytest.mark.smoke
def test_compiled_stats():
    stats = profiling.compiled_stats(lambda x: x @ x, jnp.eye(64))
    # cost analysis shape varies by backend; just require it not to crash
    assert stats is not None


def test_png_roundtrip_shape(tmp_path):
    img = np.random.default_rng(0).uniform(size=(5, 7, 3)).astype(np.float32)
    p = str(tmp_path / "t.png")
    write_png(p, img)
    data = open(p, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert b"IEND" in data


def test_argb_roundtrip():
    fb = np.asarray([[0xFF112233, 0xFF445566]], np.uint32)
    rgb = argb_to_rgb(fb)
    assert rgb[0, 0].tolist() == [0x11, 0x22, 0x33]
    assert rgb[0, 1].tolist() == [0x44, 0x55, 0x66]


def test_aot_step_roundtrip(tmp_path):
    """jax.export artifact (the reference's generated-kernel-library
    analog, SURVEY §2.2): a serialized step executes bitwise-identically
    to the live jit, reloaded from disk, and is reusable across calls."""
    import jax

    from tracer_tpu.engine.api import _step_core
    from tracer_tpu.utils import aot

    s = small_state()
    p = str(tmp_path / "step.stablehlo")
    aot.save_step(s, p)
    call = aot.load_step(p)

    direct = jax.jit(_step_core)(s)
    out = call(s)
    assert type(out).__name__ == "EngineState"
    np.testing.assert_array_equal(np.asarray(out.img),
                                  np.asarray(direct.img))
    assert int(out.n_frames) == int(direct.n_frames)
    # same executable, new inputs (progressive accumulation continues)
    out2 = call(direct)
    direct2 = jax.jit(_step_core)(direct)
    np.testing.assert_array_equal(np.asarray(out2.img),
                                  np.asarray(direct2.img))


def test_aot_standalone_process(tmp_path):
    """Checkpoint + artifact together are shippable: a fresh process that
    never assembles a scene (no OBJ load, no accel build, no retrace)
    restores the state standalone and runs the exported step."""
    import subprocess
    import sys as _sys

    s = T.step(small_state())
    ck = str(tmp_path / "state.npz")
    art = str(tmp_path / "step.stablehlo")
    checkpoint.save(ck, s)
    from tracer_tpu.utils import aot
    aot.save_step(s, art)
    expect = float(np.asarray(T.step(s).img).mean())

    child = f"""
import sys
sys.path.insert(0, {repr(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))})
import numpy as np
from tracer_tpu.utils import aot, checkpoint
state = checkpoint.load({ck!r})          # standalone: no template
call = aot.load_step({art!r})
out = call(state)
print("MEAN", float(np.asarray(out.img).mean()))
"""
    proc = subprocess.run([_sys.executable, "-c", child],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-800:]
    mean = float(proc.stdout.split("MEAN ")[1].split()[0])
    assert mean == expect, (mean, expect)


def test_bench_merge_never_clobbers_good_records():
    """run_all.merge_results: an error record must not replace a stored
    good measurement (a failed rerun); fresh errors and
    fresh measurements merge normally."""
    import sys as _sys
    _sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "benchmarks"))
    import run_all

    good = {"config": "cornell-256spp", "value": 245.0,
            "metric": "mrays_per_sec"}
    out = run_all.merge_results(
        [good],
        [{"config": "cornell-256spp", "error": "timeout"},
         {"config": "spectrum", "error": "timeout"},
         {"config": "mirrorbox", "value": 219.0}])
    by = {r["config"]: r for r in out}
    assert by["cornell-256spp"]["value"] == 245.0
    assert by["cornell-256spp"]["last_error"] == "timeout"
    assert by["spectrum"] == {"config": "spectrum", "error": "timeout"}
    assert by["mirrorbox"]["value"] == 219.0
    # a fresh good record replaces an old error record
    out2 = run_all.merge_results(out, [{"config": "spectrum",
                                        "value": 60.0}])
    assert {r["config"]: r for r in out2}["spectrum"]["value"] == 60.0
