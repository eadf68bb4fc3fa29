"""Each module of the port against its JAX original on the same numpy
inputs (CPU): pyramid, clustering, warp, derivatives, segmentation,
temporal residuals, and the sparse fuse's z-buffer, association, merge,
lifecycle/insert, window clean, splat and composite.

Floats match at rtol 1e-5.  Integer winner/label sets match on >= 99.9% of
entries: packed keys quantise depth, so two surfels within one quantum may
order differently when float rounding differs in the last bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from staticfusion_tpu.config import CameraConfig, FusionConfig, SFConfig
from staticfusion_tpu.io import synthetic
from staticfusion_tpu_torch.config import SFConfig as TorchConfig

# The suite runs in parallel worker processes: a small intra-op pool per
# worker keeps them from oversubscribing the host's cores.
torch.set_num_threads(2)

CONFIG = SFConfig(camera=CameraConfig(width=160, height=120),
                  fusion=FusionConfig(capacity=1 << 16))
TCONFIG = TorchConfig.from_json(CONFIG.to_json())
TWIST = np.array([0.004, -0.002, 0.006, 0.0015, -0.001, 0.002], np.float32)


def T(x):
    """JAX/numpy leaf or NamedTuple -> torch (same structure)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[T(v) for v in x])
    return torch.as_tensor(np.array(x))


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def agree(got, want, frac=0.999):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.mean(got == want) >= frac, np.mean(got == want)


def close_fields(got, want, names=None, **kw):
    for f in names or want._fields:
        close(getattr(got, f), getattr(want, f), **kw)


@pytest.fixture(scope="module")
def seq():
    frames, gt = synthetic.make_sequence(CONFIG, 6, TWIST)
    return frames, gt


@pytest.fixture(scope="module")
def pyramids(seq):
    from staticfusion_tpu.ops.pyramid import build_pyramid_pair
    from staticfusion_tpu.pipeline.step import _intensity
    (rgb0, d0, _), (rgb1, d1, _) = seq[0][0], seq[0][1]
    args = (d0 / 1000.0, _intensity(jnp.asarray(rgb0)), d1 / 1000.0,
            _intensity(jnp.asarray(rgb1)))
    return args, build_pyramid_pair(*[jnp.asarray(a) for a in args], CONFIG)


def test_pyramid(pyramids):
    from staticfusion_tpu_torch.ops.pyramid import build_pyramid_pair
    args, (ja, jb) = pyramids
    ta, tb = build_pyramid_pair(*[T(a) for a in args], TCONFIG)
    assert len(ta) == len(ja) == CONFIG.ctf_levels
    for tl, jl in zip(ta + tb, ja + jb):
        close_fields(tl, jl)


def test_clustering(pyramids):
    from staticfusion_tpu.solver.clustering import cluster_frame as jcf
    from staticfusion_tpu_torch.solver.clustering import cluster_frame
    _, (_, jcur) = pyramids
    jc = jcf(jcur, CONFIG)
    tc = cluster_frame(tuple(T(l) for l in jcur), TCONFIG)
    close(tc.centers, jc.centers, rtol=1e-4, atol=1e-5)
    for tl, jl in zip(tc.labels, jc.labels):
        agree(tl, jl)
    agree(tc.connectivity, jc.connectivity, frac=0.99)


def test_warp_and_derivatives(pyramids, seq):
    from staticfusion_tpu.ops import derivatives as jd
    from staticfusion_tpu.ops.warp import warp_images_gather as jw
    from staticfusion_tpu_torch.ops import derivatives as td
    from staticfusion_tpu_torch.ops.warp import warp_images_gather as tw
    _, (jpred, jcur) = pyramids
    Tm = np.linalg.inv(seq[1][1]).astype(np.float32) @ seq[1][0]
    fovh = CONFIG.camera.fovh
    for lvl in (0, 2):
        jwarp = jw(jpred[lvl], jcur[lvl].depth, jnp.asarray(Tm), fovh)
        twarp = tw(T(jpred[lvl]), T(jcur[lvl].depth), T(Tm), fovh)
        close_fields(twarp, jwarp, atol=1e-5)
        # Derivatives from the same (JAX) warp on both sides.
        ji = jd.calculate_coords(jcur[lvl], jwarp)
        ti = td.calculate_coords(T(jcur[lvl]), T(jwarp))
        close_fields(ti, ji)
        jder = jd.calculate_derivatives(ji, jcur[lvl], jwarp)
        tder = td.calculate_derivatives(T(ji), T(jcur[lvl]), T(jwarp))
        close_fields(tder, jder, atol=1e-5)
        close_fields(td.compute_weights(T(jder), T(ji.valid)),
                     jd.compute_weights(jder, ji.valid), atol=1e-5)


def test_segmentation(pyramids):
    from staticfusion_tpu.solver import segmentation as js
    from staticfusion_tpu.solver.clustering import cluster_frame as jcf
    from staticfusion_tpu.solver.irls import cluster_onehot as joh
    from staticfusion_tpu_torch.solver import segmentation as ts
    from staticfusion_tpu_torch.solver.irls import cluster_onehot as toh
    _, (jpred, jcur) = pyramids
    jc = jcf(jcur, CONFIG)
    labels = jc.labels[0]
    rng = np.random.default_rng(0)
    null = rng.random(labels.shape) < 0.2
    ddt = (0.05 * rng.standard_normal(labels.shape)).astype(np.float32)
    jprior = js.compute_seg_prior(joh(labels), jnp.asarray(null),
                                  jnp.asarray(ddt), CONFIG)
    tprior = ts.compute_seg_prior(toh(T(labels)), T(null), T(ddt), TCONFIG)
    close_fields(tprior, jprior)
    jreg = js.reg_normal_matrix(jc.connectivity, CONFIG.solver.lambda_reg)
    treg = ts.reg_normal_matrix(T(jc.connectivity), TCONFIG.solver.lambda_reg)
    close(treg, jreg)
    arl = rng.uniform(0.001, 0.05, 24).astype(np.float32)
    for kb in (1.05, 1.5):
        jb = js.solve_segm_iteration(None, jnp.asarray(arl),
                                     jnp.asarray(0.02), jprior, jreg,
                                     CONFIG, kb=jnp.asarray(kb))
        tb = ts.solve_segm_iteration(T(arl), torch.tensor(0.02), T(jprior),
                                     treg, TCONFIG, kb=torch.tensor(kb))
        close(tb, jb, rtol=1e-4, atol=1e-5)
    res = np.where(rng.random(24) < 0.3, np.nan,
                   rng.uniform(0, 0.03, 24)).astype(np.float32)
    close(ts.build_segm_image(T(labels), T(jb), T(res), TCONFIG),
          js.build_segm_image(labels, jb, jnp.asarray(res), CONFIG))


def test_temporal_residuals(seq):
    from staticfusion_tpu.pipeline.state import RingBuffers as JR
    from staticfusion_tpu.pipeline.temporal import \
        compute_temporal_residuals as jt
    from staticfusion_tpu_torch.pipeline.state import RingBuffers as TR
    from staticfusion_tpu_torch.pipeline.temporal import \
        compute_temporal_residuals as tt
    frames, gt = seq
    L = CONFIG.buffer_length
    depth = np.stack([f[1] / 1000.0 for f in frames[:L]]).astype(np.float32)
    inten = np.stack([0.299 * f[0][..., 0] + 0.587 * f[0][..., 1]
                      + 0.114 * f[0][..., 2] for f in frames[:L]])
    odom = np.stack([np.eye(4, dtype=np.float32)]
                    + [(np.linalg.inv(gt[i - 1]) @ gt[i]).astype(np.float32)
                       for i in range(1, L)])
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 25, depth.shape[1:])
    T_odo = (np.linalg.inv(gt[L - 1]) @ gt[L]).astype(np.float32)
    cur_d = (frames[L][1] / 1000.0).astype(np.float32)
    cur_i = (0.299 * frames[L][0][..., 0] + 0.587 * frames[L][0][..., 1]
             + 0.114 * frames[L][0][..., 2]).astype(np.float32)
    want = jt(JR(jnp.asarray(depth), jnp.asarray(inten), jnp.asarray(odom)),
              jnp.asarray(T_odo), jnp.asarray(L, jnp.int32),
              jnp.asarray(cur_d), jnp.asarray(cur_i),
              jnp.asarray(labels, jnp.int32), CONFIG)
    got = tt(TR(T(depth), T(inten), T(odom)), T(T_odo),
             torch.tensor(L, dtype=torch.int32), T(cur_d), T(cur_i),
             T(labels), TCONFIG)
    close(got, want, rtol=1e-4, atol=1e-6)


# --- fusion: one map, one moved pose ---------------------------------------

@pytest.fixture(scope="module")
def fusion_inputs(seq):
    """A JAX map initialised from frame 1, the frame-2 measurements and a
    pose with small rotation/translation noise (so pixel-centre surfels do
    not sit on texel boundaries)."""
    from staticfusion_tpu.fusion.surfels import initialise_map
    from staticfusion_tpu.ops import bilateral
    frames, gt = seq
    rng = np.random.default_rng(2)
    d1 = jnp.asarray(frames[1][1])
    raw1 = bilateral.metricise_depth_mm(d1, 4.5)
    filt1 = bilateral.metricise_depth_mm(
        bilateral.bilateral_filter_mm(d1, 4.5), 4.5)
    sp1 = jnp.asarray(rng.uniform(0.3, 1.0, d1.shape).astype(np.float32))
    smap = initialise_map(1 << 15, raw1, filt1, jnp.asarray(frames[1][0]),
                          sp1, jnp.asarray(gt[1]), CONFIG)
    smap = smap._replace(conf=jnp.asarray(
        rng.uniform(0.05, 0.9, smap.conf.shape).astype(np.float32))
        * smap.valid)
    d2 = jnp.asarray(frames[2][1])
    pose2 = gt[2].copy()
    pose2[:3, 3] += np.array([1e-4, -2e-4, 1.5e-4], np.float32)
    return dict(
        smap=smap, pose=jnp.asarray(pose2), raw=bilateral.metricise_depth_mm(
            d2, 4.5),
        filt=bilateral.metricise_depth_mm(bilateral.bilateral_filter_mm(
            d2, 4.5), 4.5),
        rgb=jnp.asarray(frames[2][0]),
        sp=jnp.asarray(rng.uniform(0.3, 1.0, d2.shape).astype(np.float32)),
        tick=jnp.asarray(3, jnp.int32), sp1=sp1, raw1=raw1, filt1=filt1)


def test_initialise_map(fusion_inputs, seq):
    from staticfusion_tpu_torch.fusion.surfels import initialise_map
    fi = fusion_inputs
    frames, gt = seq
    from staticfusion_tpu.fusion.surfels import initialise_map as jinit
    want = jinit(1 << 15, fi["raw1"], fi["filt1"], jnp.asarray(frames[1][0]),
                 fi["sp1"], jnp.asarray(gt[1]), CONFIG)
    got = initialise_map(1 << 15, T(fi["raw1"]), T(fi["filt1"]),
                         T(frames[1][0]), T(fi["sp1"]), T(gt[1]), TCONFIG)
    close_fields(got, want, names=("pos", "conf", "color", "hist",
                                   "init_time", "last_time", "radius"))
    close(got.normal, want.normal, rtol=1e-4, atol=1e-4)
    agree(got.valid, want.valid, frac=1.0)
    assert int(got.used) == int(want.used)


def test_zbuffer_and_association(fusion_inputs):
    from staticfusion_tpu.fusion import sparse as js
    from staticfusion_tpu.fusion.backend import velocity_weighting as jvw
    from staticfusion_tpu_torch.fusion import sparse as ts
    from staticfusion_tpu_torch.fusion.backend import \
        velocity_weighting as tvw
    from staticfusion_tpu_torch.fusion.texelmap import \
        project_surfels as tt_project
    fi = fusion_inputs
    jl = js.project_surfels(fi["smap"], fi["pose"], CONFIG)
    tl = tt_project(T(fi["smap"]), T(fi["pose"]), TCONFIG)
    close(tl.pos, jl.pos, atol=1e-5)
    jok, jwin = js.zbuffer_winners(fi["smap"], jl, fi["tick"], CONFIG)
    tok, twin = ts.zbuffer_winners(T(fi["smap"]), tl, T(fi["tick"]), TCONFIG)
    agree(tok, jok)
    agree(twin, jwin)
    w = jvw(fi["pose"], jnp.asarray(np.eye(4, dtype=np.float32)), 1.0,
            CONFIG)
    close(tvw(T(fi["pose"]), torch.eye(4), 1.0, TCONFIG), w)
    ja = js.associate_sparse(fi["smap"], jl, fi["raw"], fi["filt"],
                             fi["rgb"], fi["sp"], fi["pose"], fi["tick"],
                             w, CONFIG)
    ta = ts.associate_sparse(T(fi["smap"]), tl, T(fi["raw"]), T(fi["filt"]),
                             T(fi["rgb"]), T(fi["sp"]), T(fi["pose"]),
                             T(fi["tick"]), T(w), TCONFIG)
    agree(ta.active, ja.active, frac=1.0)
    agree(ta.best_id, ja.best_id)
    agree(ta.matched, ja.matched)
    agree(ta.updates.has_update, ja.updates.has_update)
    both = np.asarray(ta.updates.has_update) & np.asarray(
        ja.updates.has_update)
    for f in ("pos", "conf", "color", "normal", "radius"):
        close(np.asarray(getattr(ta.updates, f))[both],
              np.asarray(getattr(ja.updates, f))[both], rtol=1e-4, atol=1e-4)
    agree(ta.new.is_new, ja.new.is_new)
    close_fields(ta.new, ja.new, names=("pos", "conf", "color", "radius"),
                 atol=1e-5)
    assert int(np.asarray(ja.matched).sum()) > 1000


def test_apply_updates_and_lifecycle(fusion_inputs):
    from staticfusion_tpu.fusion import sparse as js
    from staticfusion_tpu.fusion.backend import velocity_weighting as jvw
    from staticfusion_tpu.fusion.update import apply_updates as jau
    from staticfusion_tpu_torch.fusion import sparse as ts
    from staticfusion_tpu_torch.fusion.update import apply_updates as tau
    fi = fusion_inputs
    jl = js.project_surfels(fi["smap"], fi["pose"], CONFIG)
    w = jvw(fi["pose"], jnp.asarray(np.eye(4, dtype=np.float32)), 1.0,
            CONFIG)
    ja = js.associate_sparse(fi["smap"], jl, fi["raw"], fi["filt"],
                             fi["rgb"], fi["sp"], fi["pose"], fi["tick"],
                             w, CONFIG)
    jm = jau(fi["smap"], ja.updates, fi["tick"], CONFIG)
    tm = tau(T(fi["smap"]), T(ja.updates), T(fi["tick"]))
    close_fields(tm, jm, names=("pos", "conf", "color", "hist", "radius",
                                "last_time"), atol=1e-5)
    close(tm.normal, jm.normal, atol=1e-5)
    killed = np.random.default_rng(3).random(jm.conf.shape) < 0.01
    jo = js.lifecycle_and_insert(jm, jnp.asarray(killed), ja.new,
                                 fi["tick"], CONFIG)
    to = ts.lifecycle_and_insert(T(jm), T(killed), T(ja.new), T(fi["tick"]),
                                 TCONFIG)
    agree(to.valid, jo.valid, frac=1.0)
    assert int(to.used) == int(jo.used)
    close_fields(to, jo, names=("pos", "conf", "color", "hist", "init_time",
                                "last_time", "normal", "radius"))


def test_render_clean_splat_composite(fusion_inputs):
    from staticfusion_tpu.fusion import predict as jp
    from staticfusion_tpu.fusion.clean import (kill_mask_from_tex as jkm,
                                               window_kill_tex as jwk)
    from staticfusion_tpu.fusion.indexmap import predict_indices as jpi
    from staticfusion_tpu.fusion.sparse import post_factor_config
    from staticfusion_tpu_torch.fusion import predict as tp
    from staticfusion_tpu_torch.fusion.clean import (kill_mask_from_tex,
                                                     window_kill_tex)
    from staticfusion_tpu_torch.fusion.indexmap import predict_indices
    from staticfusion_tpu_torch.fusion.sparse import \
        post_factor_config as tpf
    fi = fusion_inputs
    cfg1, tcfg1 = post_factor_config(CONFIG), tpf(TCONFIG)
    jt, _ = jpi(fi["smap"], fi["pose"], fi["tick"], cfg1)
    tt, _ = predict_indices(T(fi["smap"]), T(fi["pose"]), T(fi["tick"]),
                            tcfg1)
    agree(tt.has, jt.has)
    agree(tt.idx, jt.idx)
    # Downstream stages from the same (JAX) texel images on both sides.
    jk = jwk(jt, fi["tick"], cfg1)
    tk = window_kill_tex(T(jt), T(fi["tick"]), tcfg1)
    agree(tk, jk)
    agree(kill_mask_from_tex(T(jk), T(jt.idx), 1 << 15),
          jkm(jk, jt.idx, 1 << 15), frac=1.0)
    jv = jp.splat_from_texels(jt, cfg1)
    tv = tp.splat_from_texels(T(jt), tcfg1)
    close_fields(tv, jv, atol=1e-5)
    assert float(np.asarray(jv.depth > 0).mean()) > 0.5
    jc = jp.composite_prediction(jv, fi["filt"], fi["rgb"], fi["sp"], CONFIG)
    tc = tp.composite_prediction(T(jv), T(fi["filt"]), T(fi["rgb"]),
                                 T(fi["sp"]), TCONFIG)
    close_fields(tc, jc, atol=1e-5)
    # The bootstrap render (F=4, low-confidence cull) end to end: a winner
    # flip in the render moves a whole splat, so compare per pixel.
    tl = tp.predict_low_view(T(fi["smap"]), T(fi["pose"]), T(fi["tick"]),
                             TCONFIG)
    jl = jp.predict_low_view(fi["smap"], fi["pose"], fi["tick"], CONFIG)
    same = np.isclose(np.asarray(tl.depth), np.asarray(jl.depth), rtol=1e-5,
                      atol=1e-5)
    for f in ("image", "vertex", "normal"):
        same &= np.isclose(np.asarray(getattr(tl, f)),
                           np.asarray(getattr(jl, f)), rtol=1e-5,
                           atol=1e-5).all(-1)
    assert same.mean() >= 0.995, same.mean()


@pytest.mark.parametrize("angle", [1e-6, 0.3, 2.5])
def test_se3_and_ate(angle):
    """se3_exp/log, so3_log, se3_inverse, transform_points at a rotation in
    the Taylor branch, a moderate one and one near pi; and the ATE of a
    noisy trajectory."""
    from staticfusion_tpu.geometry import se3 as jse3
    from staticfusion_tpu.io.trajectory import ate_rmse as jate
    from staticfusion_tpu_torch.geometry import se3 as tse3
    from staticfusion_tpu_torch.io.trajectory import ate_rmse as tate
    rng = np.random.default_rng(int(angle * 1e6))
    axis = rng.normal(size=(5, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    xi = np.concatenate([rng.normal(size=(5, 3)), angle * axis],
                        1).astype(np.float32)
    Tj = jse3.se3_exp(jnp.asarray(xi))
    Tt = tse3.se3_exp(torch.as_tensor(xi))
    close(Tt, Tj, atol=2e-6)
    close(tse3.se3_log(T(Tj)), jse3.se3_log(Tj), rtol=1e-4, atol=2e-5)
    close(tse3.so3_log(T(Tj)[:, :3, :3]), jse3.so3_log(Tj[:, :3, :3]),
          rtol=1e-4, atol=2e-5)
    close(tse3.se3_inverse(T(Tj)), jse3.se3_inverse(Tj), atol=1e-6)
    p = rng.normal(size=(5, 3)).astype(np.float32)
    close(tse3.transform_points(T(Tj), torch.as_tensor(p)),
          jse3.transform_points(Tj, jnp.asarray(p)), atol=2e-6)
    times = np.arange(5) / 30.0
    est = np.asarray(Tj, np.float64) + np.pad(
        rng.normal(0, 1e-3, (5, 3, 1)), ((0, 0), (0, 1), (3, 0)))
    assert tate(times, est, times, np.asarray(Tj)) == jate(
        times, est, times, np.asarray(Tj))
