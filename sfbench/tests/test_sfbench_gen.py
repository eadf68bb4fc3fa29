"""The torch copy of the adversarial generator against the port's numpy
generator, at 160x120, with the sensor's random terms off (the two draw
their noise from different generators)."""

import numpy as np
import pytest
import torch

from sfbench.gen import adversarial as gen
from staticfusion_tpu_torch.config import CameraConfig, SFConfig
from staticfusion_tpu_torch.io import adversarial as port_gen

QUIET = dict(axial_noise=0.0, speckle_dropout=0.0, rgb_noise=0.0)


def _camera():
    c = SFConfig(camera=CameraConfig(width=160, height=120)).camera
    return gen.Camera(c.width, c.height, c.fx, c.fy, c.cx, c.cy)


def test_walk_xyz_matches_numpy_generator():
    n = 4
    cfg = SFConfig(camera=CameraConfig(width=160, height=120))
    frames, gt = port_gen.make_adversarial_sequence(
        cfg, n, "walk_xyz", sensor=port_gen.SensorModel(**QUIET), seed=0)
    seq = gen.render_sequence("walk_xyz", n, _camera(), 123, "cpu",
                              sensor=gen.SensorModel(**QUIET), batch=3)
    np.testing.assert_array_equal(seq.gt_poses, gt)
    for i, (rgb, depth, dyn) in enumerate(frames):
        np.testing.assert_array_equal(seq.depth_mm[i], depth)
        np.testing.assert_allclose(seq.rgb[i], rgb, atol=1e-6)
        np.testing.assert_array_equal(seq.dynamic[i], dyn)
        assert 0.2 < dyn.mean() < 0.5  # the walker is on screen


@pytest.mark.parametrize("frame", [40, 100])
def test_corridor_loop_matches_numpy_generator(frame):
    n = 300
    cfg = SFConfig(camera=CameraConfig(width=160, height=120))
    sc = gen.scene("corridor_loop", n)
    pose = gen.gt_poses(sc.twists)[frame]
    rgb, depth, dyn = port_gen.render_adversarial_frame(
        pose, cfg, frame,
        port_gen.corridor_clutter() + port_gen.make_corridor_walker(n),
        planes=port_gen.corridor_planes(),
        sensor=port_gen.SensorModel(**QUIET),
        rng=np.random.default_rng(0), texture_fn=port_gen._texture_corridor)
    g = torch.Generator().manual_seed(0)
    r, d, m = gen.render_batch(pose[None], np.array([frame]), _camera(), sc,
                               gen.SensorModel(**QUIET), g, "cpu")
    np.testing.assert_array_equal(d[0].numpy(), depth)
    np.testing.assert_allclose(r[0].numpy(), rgb, atol=1e-6)
    np.testing.assert_array_equal(m[0].numpy(), dyn)
    np.testing.assert_array_equal(port_gen.trajectory_corridor_loop(n),
                                  sc.twists)


def test_seed_sets_the_noise_only():
    cam = _camera()
    a = gen.render_sequence("walk_xyz", 2, cam, 7, "cpu", batch=2)
    b = gen.render_sequence("walk_xyz", 2, cam, 7, "cpu", batch=2)
    c = gen.render_sequence("walk_xyz", 2, cam, 2**31 + 5, "cpu", batch=2)
    np.testing.assert_array_equal(a.depth_mm, b.depth_mm)
    np.testing.assert_array_equal(a.rgb, b.rgb)
    assert not np.array_equal(a.depth_mm, c.depth_mm)
    np.testing.assert_array_equal(a.gt_poses, c.gt_poses)
    # The noise moves depth by the sensor model's few millimetres only.
    both = (a.depth_mm > 0) & (c.depth_mm > 0)
    assert np.median(np.abs(a.depth_mm - c.depth_mm)[both]) < 20.0
