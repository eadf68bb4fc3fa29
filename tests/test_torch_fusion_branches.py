"""The fuse branches above the packed z-buffer against the JAX package on
the same inputs (CPU): the exact two-pass z-buffer of maps above 2^21 - 1
surfels (render_texel_images in both materialize modes, zbuffer_winners,
associate_sparse), materialize_from_winners, and fuse_frame_sparse at
post_factor == index_factor.

The render and association run on a 16x12 camera (a 64x48 texel grid at
F=4) over a map of 1<<21 slots (22 id bits: the two-pass z-buffer) and,
as the control, 1<<16 slots (the packed keys), with a few hundred valid
surfels scattered over the whole slot range.  Both sides get the same
camera-frame surfels, several of them at exactly equal depth in one
texel, so the two-pass order is exact: winner ids, has-masks and
association winners must be identical, float attributes agree at rtol /
atol 1e-6.  fuse_frame_sparse is stepped from one JAX map (160x120, frame
1's surfels, frame 2's measurements): >= 99.9% of slots agree in validity
and position (1e-4), the carried prediction at >= 99.5% of pixels (the
tolerances of tests/test_torch_fusion_f1.py's end-to-end fuse).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from staticfusion_tpu.config import CameraConfig, FusionConfig, SFConfig
from staticfusion_tpu.fusion import sparse as js
from staticfusion_tpu.fusion import texelmap as jt
from staticfusion_tpu.fusion.surfels import SurfelMap as JMap
from staticfusion_tpu_torch.config import SFConfig as TorchConfig
from staticfusion_tpu_torch.fusion import sparse as ts
from staticfusion_tpu_torch.fusion import texelmap as tt

# The suite runs in parallel worker processes: a small intra-op pool per
# worker keeps them from oversubscribing the host's cores.
torch.set_num_threads(2)

TWO_PASS = 1 << 21   # 22 id bits
PACKED = 1 << 16
N_VALID = 300
TICK = 5


@pytest.fixture(autouse=True)
def _drop_jax_caches():
    """Drop JAX's in-memory executables after every test."""
    yield
    jax.clear_caches()


def _config(capacity, w=16, h=12, post_factor=2):
    cfg = SFConfig(camera=CameraConfig(width=w, height=h),
                   fusion=FusionConfig(capacity=capacity,
                                       post_factor=post_factor))
    return cfg, TorchConfig.from_json(cfg.to_json())


def T(x):
    """JAX/numpy leaf or NamedTuple -> torch (same structure); integer
    leaves become int64 (the port's index type)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[T(v) for v in x])
    a = np.array(x)
    if a.dtype == np.int32 and a.ndim > 0:
        a = a.astype(np.int64)
    return torch.as_tensor(a)


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _depth_image(cfg):
    cam = cfg.camera
    yy, xx = np.mgrid[0:cam.height, 0:cam.width].astype(np.float32)
    return (1.8 + 0.3 * np.sin(xx / 5.0) + 0.2 * np.cos(yy / 4.0)).astype(
        np.float32)


def _scene(capacity, seed=0):
    """(JAX map, JAX SurfelsLocal, raw depth, tied slots) on the 16x12
    camera: valid surfels in random slots of the whole range, each near the
    depth image's surface at a random sub-pixel position; every fifth
    surfel repeats the previous one's texel and exact depth (a tie; the
    larger slot of each tie is returned)."""
    cfg, _ = _config(capacity)
    cam, F = cfg.camera, cfg.fusion.index_factor
    rng = np.random.default_rng(seed)
    depth = _depth_image(cfg)
    slots = np.sort(rng.choice(capacity, N_VALID, replace=False))
    slots[-1] = capacity - 1
    uc = rng.uniform(0.0, cam.width, N_VALID).astype(np.float32)
    vc = rng.uniform(0.0, cam.height, N_VALID).astype(np.float32)
    z = (depth[vc.astype(int), uc.astype(int)]
         + rng.normal(0.0, 0.004, N_VALID)).astype(np.float32)
    z[rng.random(N_VALID) < 0.03] = 5.0   # beyond depth_max: culled
    for i in range(4, N_VALID, 5):
        uc[i], vc[i], z[i] = uc[i - 1], vc[i - 1], z[i - 1]
    x = ((uc - cam.cx) * z / cam.fx).astype(np.float32)
    y = ((vc - cam.cy) * z / cam.fy).astype(np.float32)
    nrm = rng.normal(0.0, 0.1, (N_VALID, 3)).astype(np.float32)
    nrm[:, 2] = -1.0
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)

    def full(shape, fill=0.0):
        return np.full((capacity,) + shape, fill, np.float32)
    pos, normal, color = full((3,)), full((3,)), full((3,))
    pos[slots] = np.stack([x, y, z], 1)
    normal[slots] = nrm
    color[slots] = rng.uniform(0, 1, (N_VALID, 3))
    conf, radius, hist = full(()), full(()), full(())
    conf[slots] = rng.uniform(0.1, 5.0, N_VALID)
    radius[slots] = rng.uniform(0.002, 0.01, N_VALID)
    hist[slots] = rng.integers(1, 9, N_VALID)
    init_time, last_time = full(()), full(())
    last_time[slots] = rng.integers(1, TICK + 1, N_VALID)
    init_time[slots] = 1.0
    valid = np.zeros(capacity, bool)
    valid[slots] = True
    smap = JMap(pos=jnp.asarray(pos), conf=jnp.asarray(conf),
                color=jnp.asarray(color), hist=jnp.asarray(hist),
                init_time=jnp.asarray(init_time),
                last_time=jnp.asarray(last_time),
                normal=jnp.asarray(normal), radius=jnp.asarray(radius),
                valid=jnp.asarray(valid),
                used=jnp.asarray(capacity, jnp.int32))
    # The camera is the world frame: local = world.
    local = jt.project_surfels(smap, jnp.eye(4), cfg)
    return smap, local, depth, slots[4::5]


@pytest.mark.parametrize("capacity", [TWO_PASS, PACKED])
@pytest.mark.parametrize("materialize", ["gather", "scatter"])
def test_render_texel_images(capacity, materialize):
    cfg, tcfg = _config(capacity)
    smap, local, _, tied = _scene(capacity)
    tick = jnp.asarray(TICK, jnp.int32)
    want = jt.render_texel_images(smap, local, tick, cfg,
                                  materialize=materialize)
    got = tt.render_texel_images(T(smap), T(local), T(tick), tcfg,
                                 materialize=materialize)
    same(got.idx, want.idx)
    same(got.has, want.has)
    for f in want._fields[2:]:
        close(getattr(got, f), getattr(want, f))
    has = np.asarray(want.has)
    winners = np.asarray(want.idx)[has]
    # Enough contested texels for the order to matter; no exact-depth tie
    # went to its larger id.
    assert 150 < has.sum() < N_VALID
    assert not np.isin(tied, winners).any()
    if capacity == TWO_PASS:
        assert (winners >= 1 << 20).any()


@pytest.mark.parametrize("capacity", [TWO_PASS, PACKED])
def test_zbuffer_winners_and_associate_sparse(capacity):
    from staticfusion_tpu.fusion.surfels import frame_cloud
    cfg, tcfg = _config(capacity)
    smap, local, depth, _ = _scene(capacity, seed=1)
    tick = jnp.asarray(TICK, jnp.int32)
    jok, jwin = js.zbuffer_winners(smap, local, tick, cfg)
    tok, twin = ts.zbuffer_winners(T(smap), T(local), T(tick), tcfg)
    same(tok, jok)
    same(twin, jwin)
    assert 150 < int(np.asarray(jwin).sum()) < int(np.asarray(jok).sum())

    rng = np.random.default_rng(2)
    raw = jnp.asarray(depth)
    filt = jnp.asarray(depth + rng.normal(0, 1e-3, depth.shape).astype(
        np.float32))
    rgb = jnp.asarray(rng.uniform(0, 1, depth.shape + (3,)).astype(
        np.float32))
    sp = jnp.asarray(rng.uniform(0.3, 1, depth.shape).astype(np.float32))
    w = jnp.asarray(0.8, jnp.float32)
    # Surfel normals that face their pixel's measured normal.
    n_meas = np.asarray(frame_cloud(filt, cfg).normal).reshape(-1, 3)
    u = np.clip(np.asarray(local.u4) // 4, 0, 15)
    v = np.clip(np.asarray(local.v4) // 4, 0, 11)
    nrm = np.where(np.asarray(smap.valid)[:, None], n_meas[v * 16 + u], 0.0)
    smap = smap._replace(normal=jnp.asarray(nrm, jnp.float32))
    local = jt.project_surfels(smap, jnp.eye(4), cfg)
    for t in (TICK, TICK + 1):   # both checkerboard parities
        tick = jnp.asarray(t, jnp.int32)
        ja = js.associate_sparse(smap, local, raw, filt, rgb, sp,
                                 jnp.eye(4), tick, w, cfg)
        ta = ts.associate_sparse(T(smap), T(local), T(raw), T(filt), T(rgb),
                                 T(sp), torch.eye(4), T(tick), T(w), tcfg)
        same(ta.best_id, ja.best_id)
        same(ta.matched, ja.matched)
        same(ta.is_winner, ja.is_winner)
        same(ta.flat, ja.flat)
        same(ta.updates.has_update, ja.updates.has_update)
        for f in ("pos", "conf", "color", "normal", "radius"):
            close(getattr(ta.updates, f), getattr(ja.updates, f), atol=1e-5)
        assert int(np.asarray(ja.matched).sum()) >= 5


@pytest.mark.parametrize("capacity", [TWO_PASS, PACKED])
def test_materialize_from_winners(capacity):
    cfg, tcfg = _config(capacity)
    smap, local, _, _ = _scene(capacity, seed=3)
    tick = jnp.asarray(TICK, jnp.int32)
    ok, win = js.zbuffer_winners(smap, local, tick, cfg)
    S = 64 * 48
    flat = jnp.where(ok, local.v4 * 64 + local.u4, S)
    # The post-merge map: attributes moved a little, the winners kept.
    rng = np.random.default_rng(4)
    merged = smap._replace(
        pos=smap.pos + jnp.asarray(rng.normal(0, 1e-3, (capacity, 3)),
                                   jnp.float32),
        conf=smap.conf + 1.0)
    mlocal = jt.project_surfels(merged, jnp.eye(4), cfg)
    want = js.materialize_from_winners(merged, mlocal, win, flat, cfg)
    got = ts.materialize_from_winners(T(merged), T(mlocal), T(win), T(flat),
                                      tcfg)
    same(got.idx, want.idx)
    same(got.has, want.has)
    for f in want._fields[2:]:
        close(getattr(got, f), getattr(want, f), rtol=0, atol=0)
    assert int(np.asarray(want.has).sum()) > 150


@pytest.fixture(scope="module")
def fuse_inputs():
    """Frames 1 and 2 of the synthetic sequence at 160x120 and one JAX map
    made from frame 1 (frame 2's measurements, a pose off the texel
    boundaries)."""
    from staticfusion_tpu.io import synthetic
    from staticfusion_tpu.ops import bilateral
    cfg, _ = _config(1 << 15, 160, 120)
    twist = np.array([0.004, -0.002, 0.006, 0.0015, -0.001, 0.002],
                     np.float32)
    frames, gt = synthetic.make_sequence(cfg, 3, twist)
    rng = np.random.default_rng(5)

    def meas(i):
        d = jnp.asarray(frames[i][1])
        return (bilateral.metricise_depth_mm(d, 4.5),
                bilateral.metricise_depth_mm(
                    bilateral.bilateral_filter_mm(d, 4.5), 4.5),
                jnp.asarray(frames[i][0]),
                jnp.asarray(rng.uniform(0.3, 1.0, d.shape).astype(
                    np.float32)))
    pose2 = gt[2].copy()
    pose2[:3, 3] += np.array([1e-4, -2e-4, 1.5e-4], np.float32)
    return meas(1), meas(2), gt[1], np.linalg.inv(gt[1]) @ pose2


def test_fuse_frame_sparse_post_eq_index(fuse_inputs, capacity=1 << 15):
    from staticfusion_tpu.fusion.backend import fuse_frame_sparse as jfuse
    from staticfusion_tpu.fusion.surfels import initialise_map
    from staticfusion_tpu_torch.fusion.backend import fuse_frame
    cfg, tcfg = _config(capacity, 160, 120, post_factor=4)
    (raw1, filt1, rgb1, sp1), (raw2, filt2, rgb2, sp2), pose1, T_odo = \
        fuse_inputs
    smap = initialise_map(capacity, raw1, filt1, rgb1, sp1,
                          jnp.asarray(pose1), cfg)
    tick = jnp.asarray(3, jnp.int32)
    T_odo = jnp.asarray(T_odo, jnp.float32)
    want = jfuse(smap, jnp.asarray(pose1), T_odo, raw2, filt2, rgb2, sp2,
                 tick, cfg)
    got = fuse_frame(T(smap), T(pose1), T(T_odo), T(raw2), T(filt2), T(rgb2),
                     T(sp2), T(tick), tcfg)
    close(got.curr_pose, want.curr_pose)
    jm, tm = want.smap, got.smap
    assert int(tm.used) == int(jm.used)
    valid = np.asarray(jm.valid)
    assert np.mean(np.asarray(tm.valid) == valid) >= 0.999
    both = valid & np.asarray(tm.valid)
    near = np.isclose(np.asarray(tm.pos)[both], np.asarray(jm.pos)[both],
                      rtol=0, atol=1e-4).all(-1)
    assert near.mean() >= 0.999, near.mean()
    agree = np.isclose(np.asarray(got.pred.depth),
                       np.asarray(want.pred.depth), rtol=1e-5, atol=1e-5)
    assert agree.mean() >= 0.995, agree.mean()
    assert float(np.asarray(want.pred.depth > 0).mean()) > 0.5


@pytest.mark.parametrize("capacity,bits", [((1 << 21) - 1, 21),
                                           (1 << 21, 22),
                                           ((1 << 30) - 1, 30)])
def test_id_bits_for_matches_jax(capacity, bits):
    """Above 2^21 - 1 slots the id needs more than the packed keys' 21
    bits (the two-pass render); ids stay int32 up to 30 bits."""
    assert tt.id_bits_for(capacity) == jt.id_bits_for(capacity) == bits


def test_id_bits_for_refuses_int32_overflow():
    with pytest.raises(ValueError, match="int32"):
        tt.id_bits_for(1 << 30)
