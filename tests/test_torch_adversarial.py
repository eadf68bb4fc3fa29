"""The port's numpy copy of the adversarial generator against the JAX
package's (io/adversarial.py), at an 80x60 camera over 3 frames.

The renderers are the same numpy code; the ground-truth poses differ only
through se3_exp (the port's on CPU tensors, the JAX one on the CPU), by
< 1e-6.  A pose that differs in the last float bit can move a depth value
across a millimetre rounding boundary, so depth agrees exactly except at
< 0.5% of pixels, and within 1 mm there.  RGB and the dynamic masks agree
exactly, and so does dynamic_iou on the same inputs.
"""

import dataclasses

import numpy as np
import pytest

import jax

from staticfusion_tpu.config import CameraConfig, SFConfig
from staticfusion_tpu.io import adversarial as jadv
from staticfusion_tpu_torch.io import adversarial as tadv

CONFIG = SFConfig(camera=CameraConfig(width=80, height=60))
N = 3
POSE_TOL = 1e-6
DEPTH_SHARE = 5e-3


@pytest.fixture(autouse=True)
def _drop_jax_caches():
    """Drop JAX's in-memory executables after every test (what
    tests/conftest.py does per module), so the process's memory maps stay
    far below vm.max_map_count."""
    yield
    jax.clear_caches()


def _compare(got, want):
    (tf, tgt), (jf, jgt) = got, want
    np.testing.assert_allclose(tgt, jgt, rtol=0, atol=POSE_TOL)
    assert len(tf) == len(jf) == N
    for (trgb, tdep, tdyn), (jrgb, jdep, jdyn) in zip(tf, jf):
        assert trgb.dtype == jrgb.dtype and tdep.dtype == jdep.dtype
        np.testing.assert_array_equal(trgb, jrgb)
        np.testing.assert_array_equal(tdyn, jdyn)
        diff = tdep != jdep
        assert diff.mean() < DEPTH_SHARE, diff.mean()
        assert np.abs(tdep - jdep).max() <= 1.0


@pytest.mark.parametrize("profile", ["walk_xyz", "fast_rot", "static",
                                     "walk_var", "walk_loop",
                                     "corridor_loop"])
def test_sequence_matches_jax(profile):
    got = tadv.make_adversarial_sequence(CONFIG, N, profile, seed=0)
    want = jadv.make_adversarial_sequence(CONFIG, N, profile, seed=0)
    _compare(got, want)
    if profile.startswith("walk"):
        assert any(f[2].any() for f in got[0])


def test_dynamic_iou_matches_jax():
    frames, _ = tadv.make_adversarial_sequence(CONFIG, N, "walk_xyz",
                                               seed=1)
    rng = np.random.default_rng(0)
    for rgb, depth, dyn in frames:
        prob = rng.random(depth.shape).astype(np.float32)
        prob[dyn] *= 0.3
        for thr in (0.3, 0.5):
            got = tadv.dynamic_iou(prob, dyn, depth, thr)
            assert got == jadv.dynamic_iou(prob, dyn, depth, thr)
            assert 0.0 < got < 1.0
    empty = np.zeros_like(frames[0][1])
    assert np.isnan(tadv.dynamic_iou(frames[0][1], frames[0][2], empty))


def test_sensor_model_and_cache(tmp_path):
    """SensorModel mirrors the JAX one; the npz cache returns what was
    rendered, under the JAX package's file name for the same request."""
    assert dataclasses.astuple(tadv.SensorModel()) == dataclasses.astuple(
        jadv.SensorModel())
    sensor = tadv.SensorModel(speckle_dropout=0.05, rgb_noise=0.0)
    fresh = tadv.make_adversarial_sequence(CONFIG, N, "static", sensor=sensor,
                                           seed=2, cache_dir=str(tmp_path))
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 1 and files[0].startswith("adv_static_3f_s2_80x60")
    cached = tadv.make_adversarial_sequence(CONFIG, N, "static",
                                            sensor=sensor, seed=2,
                                            cache_dir=str(tmp_path))
    np.testing.assert_array_equal(cached[1], fresh[1])
    for a, b in zip(cached[0], fresh[0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    want = jadv.make_adversarial_sequence(
        CONFIG, N, "static", sensor=jadv.SensorModel(speckle_dropout=0.05,
                                                     rgb_noise=0.0), seed=2)
    _compare(fresh, want)
    with pytest.raises(ValueError, match="unknown profile"):
        tadv.make_adversarial_sequence(CONFIG, 1, "no_such_profile")
