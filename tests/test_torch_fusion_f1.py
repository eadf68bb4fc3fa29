"""The port's texel fuse (index_factor=1) and routed fusion against the JAX
package on the same inputs (CPU, 160x120).

The map, pose and tick come from one JAX state (a JAX SlamSystem run over
four frames at F=1) carried across with state_from_numpy; the frame-4
measurements are computed once by the JAX package and passed to both
sides as numpy arrays.  Each stage is fed the same (JAX) inputs on both
sides, so differences cannot accumulate between stages:

* floats agree at rtol 1e-5 / atol 1e-5 (positions, normals, colours,
  confidences; the same float32 formulas in another evaluation order);
* boolean and integer images agree exactly, except the render's winner
  set, which agrees on >= 99.9% of texels (packed keys quantise depth, so
  two surfels within one quantum may order differently when float
  rounding differs in the last bit);
* fuse_frame end to end: >= 99.9% of map slots agree in validity and
  position, and the carried prediction agrees at >= 99.5% of pixels (one
  flipped winner moves one splat).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from staticfusion_tpu.config import CameraConfig, FusionConfig, SFConfig
from staticfusion_tpu.io import synthetic
from staticfusion_tpu.pipeline.system import SlamSystem as JaxSlam
from staticfusion_tpu_torch.config import SFConfig as TorchConfig
from staticfusion_tpu_torch.pipeline.state import state_from_numpy

# The suite runs in parallel worker processes: a small intra-op pool per
# worker keeps them from oversubscribing the host's cores.
torch.set_num_threads(2)

CONFIG = SFConfig(camera=CameraConfig(width=160, height=120),
                  fusion=FusionConfig(capacity=1 << 15, index_factor=1))
TCONFIG = TorchConfig.from_json(CONFIG.to_json())
# Twice the camera, fused on the 160x120 grid.
ROUTED = SFConfig(camera=CameraConfig(width=320, height=240),
                  fusion=FusionConfig(capacity=1 << 15, index_factor=1,
                                      route_factor=2))
TROUTED = TorchConfig.from_json(ROUTED.to_json())
TWIST = np.array([0.004, -0.002, 0.006, 0.0015, -0.001, 0.002], np.float32)
N_STATE = 4  # frames the JAX system runs before the compared fuse


@pytest.fixture(autouse=True)
def _drop_jax_caches():
    """Drop JAX's in-memory executables after every test (what
    tests/conftest.py does per module), so the process's memory maps stay
    far below vm.max_map_count."""
    yield
    jax.clear_caches()


def T(x):
    """JAX/numpy leaf or NamedTuple -> torch (same structure)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[T(v) for v in x])
    return torch.as_tensor(np.array(x))


def close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def agree(got, want, frac=1.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.mean(got == want) >= frac, np.mean(got == want)


def _measurements(cfg, frame, rng):
    """(raw_m, filt_m, rgb, static_prob) of one frame, from the JAX
    package.  A block of the depth image comes 0.3 m closer (an object
    moving in), so the fuse inserts new surfels and kills some old ones."""
    from staticfusion_tpu.ops import bilateral
    depth_mm = frame[1].copy()
    r0, c0 = cfg.rows // 3, cfg.cols // 3
    block = depth_mm[r0:r0 + cfg.rows // 6, c0:c0 + cfg.cols // 6]
    block[block > 0] -= 300.0
    d = jnp.asarray(depth_mm)
    raw = bilateral.metricise_depth_mm(d, 4.5)
    filt = bilateral.metricise_depth_mm(bilateral.bilateral_filter_mm(d, 4.5),
                                        4.5)
    sp = rng.uniform(0.3, 1.0, d.shape).astype(np.float32)
    return raw, filt, jnp.asarray(frame[0]), jnp.asarray(sp)


@pytest.fixture(scope="module")
def inputs():
    frames, gt = synthetic.make_sequence(CONFIG, N_STATE + 1, TWIST)
    js = JaxSlam(CONFIG)
    for i, (rgb, d, _) in enumerate(frames[:N_STATE]):
        js.process(rgb, d, i / 30.0)
    jstate = jax.tree_util.tree_map(np.asarray, js.state)
    rng = np.random.default_rng(4)
    raw, filt, rgb, sp = _measurements(CONFIG, frames[N_STATE], rng)
    # The odometry of the last frame, with a little noise so pixel-centre
    # surfels do not sit on texel boundaries.
    T_odo = (np.linalg.inv(gt[N_STATE - 1]) @ gt[N_STATE]).astype(np.float32)
    T_odo[:3, 3] += np.array([1e-4, -2e-4, 1.5e-4], np.float32)
    pose = jnp.asarray(jstate.curr_pose) @ jnp.asarray(T_odo)
    return dict(jstate=jstate, tstate=state_from_numpy(jstate, device="cpu"),
                T_odo=T_odo, pose=pose, raw=raw, filt=filt, rgb=rgb, sp=sp,
                tick=jnp.asarray(jstate.tick))


@pytest.fixture(scope="module")
def stages(inputs):
    """The JAX texel fuse's stages on the fixture's inputs."""
    from staticfusion_tpu.fusion.association import associate_texels
    from staticfusion_tpu.fusion.backend import velocity_weighting
    from staticfusion_tpu.fusion.clean import window_kill_tex
    from staticfusion_tpu.fusion.indexmap import predict_indices
    from staticfusion_tpu.fusion.update import merge_texels
    fi = inputs
    smap = fi["jstate"].smap
    tex, local = predict_indices(smap, fi["pose"], fi["tick"], CONFIG)
    w = velocity_weighting(fi["pose"], jnp.asarray(fi["jstate"].curr_pose),
                           1.0, CONFIG)
    upd, new = associate_texels(tex, fi["raw"], fi["filt"], fi["rgb"],
                                fi["sp"], fi["pose"], fi["tick"], w, CONFIG)
    merged = merge_texels(tex, upd, fi["tick"], CONFIG)
    kill = window_kill_tex(merged, fi["tick"], CONFIG)
    return dict(tex=tex, local=local, w=w, upd=upd, new=new, merged=merged,
                kill=kill)


def test_render_at_f1(inputs, stages):
    from staticfusion_tpu_torch.fusion.indexmap import predict_indices
    fi = inputs
    tex, local = predict_indices(fi["tstate"].smap, T(fi["pose"]),
                                 fi["tstate"].tick, TCONFIG)
    jt = stages["tex"]
    agree(tex.has, jt.has, frac=0.999)
    agree(tex.idx, jt.idx, frac=0.999)
    both = np.asarray(tex.has) & np.asarray(jt.has) & (
        np.asarray(tex.idx) == np.asarray(jt.idx))
    for f in ("x", "y", "z", "nx", "ny", "nz", "radius", "conf", "r"):
        close(np.asarray(getattr(tex, f))[both],
              np.asarray(getattr(jt, f))[both])
    close(local.pos, stages["local"].pos)
    agree(local.u4, stages["local"].u4, frac=0.999)
    assert both.mean() > 0.5


def test_associate_texels(inputs, stages):
    from staticfusion_tpu_torch.fusion.association import associate_texels
    fi = inputs
    upd, new = associate_texels(T(stages["tex"]), T(fi["raw"]),
                                T(fi["filt"]), T(fi["rgb"]), T(fi["sp"]),
                                T(fi["pose"]), fi["tstate"].tick,
                                T(stages["w"]), TCONFIG)
    ju, jn = stages["upd"], stages["new"]
    agree(upd.has, ju.has)
    for f in ("pos", "conf", "color", "normal", "radius"):
        close(getattr(upd, f), getattr(ju, f))
    agree(new.is_new, jn.is_new)
    for f in ("pos", "conf", "color", "normal", "radius"):
        close(getattr(new, f), getattr(jn, f))
    assert int(np.asarray(ju.has).sum()) > 1000


def test_merge_texels(inputs, stages):
    from staticfusion_tpu_torch.fusion.update import merge_texels
    got = merge_texels(T(stages["tex"]), T(stages["upd"]),
                       inputs["tstate"].tick)
    want = stages["merged"]
    for f in want._fields:
        if f in ("idx", "has"):
            agree(getattr(got, f), getattr(want, f))
        else:
            close(getattr(got, f), getattr(want, f))


def test_window_kill_and_writeback_and_insert(inputs, stages):
    from staticfusion_tpu.fusion.clean import \
        writeback_and_insert as jwriteback
    from staticfusion_tpu_torch.fusion.clean import (window_kill_tex,
                                                     writeback_and_insert)
    fi = inputs
    tick = fi["tstate"].tick
    agree(window_kill_tex(T(stages["merged"]), tick, TCONFIG),
          stages["kill"])
    want = jwriteback(fi["jstate"].smap, stages["merged"], stages["upd"].has,
                      stages["kill"], stages["local"], stages["new"],
                      fi["pose"], fi["tick"], CONFIG)
    got = writeback_and_insert(
        fi["tstate"].smap, T(stages["merged"]), T(stages["upd"].has),
        T(stages["kill"]), T(stages["local"]), T(stages["new"]),
        T(fi["pose"]), tick, TCONFIG)
    agree(got.valid, want.valid)
    assert int(got.used) == int(want.used)
    for f in ("pos", "conf", "color", "hist", "init_time", "last_time",
              "normal", "radius"):
        close(getattr(got, f), getattr(want, f))
    # The stage did work of each kind: write-backs, kills and inserts.
    old = fi["jstate"].smap
    assert int(want.used) > int(old.used)
    assert np.any(np.asarray(want.valid)[:int(old.used)]
                  != np.asarray(old.valid)[:int(old.used)])


def _compare_fuse(got, want, rows, cols):
    """Map rows, live count and carried prediction of two FuseResults."""
    assert got.smap.capacity == want.smap.capacity
    agree(got.smap.valid, want.smap.valid, frac=0.999)
    assert abs(int(got.smap.used) - int(want.smap.used)) <= 0.001 * int(
        want.smap.used)
    nj, nt = int(want.smap.count()), int(got.smap.count())
    assert abs(nj - nt) <= 0.001 * nj, (nj, nt)
    pos_ok = np.isclose(np.asarray(got.smap.pos),
                        np.asarray(want.smap.pos), rtol=1e-5,
                        atol=1e-5).all(-1)
    assert pos_ok.mean() >= 0.999, pos_ok.mean()
    close(got.curr_pose, want.curr_pose)
    assert tuple(got.pred.depth.shape) == (rows, cols)
    same = np.isclose(np.asarray(got.pred.depth),
                      np.asarray(want.pred.depth), rtol=1e-5, atol=1e-5)
    for f in ("image", "vertex", "normal"):
        same &= np.isclose(np.asarray(getattr(got.pred, f)),
                           np.asarray(getattr(want.pred, f)), rtol=1e-5,
                           atol=1e-5).all(-1)
    assert same.mean() >= 0.995, same.mean()
    assert float(np.asarray(want.pred.depth > 0).mean()) > 0.5


def test_texel_fuse_frame(inputs):
    from staticfusion_tpu.fusion.backend import fuse_frame as jfuse
    from staticfusion_tpu_torch.fusion.backend import fuse_frame
    fi = inputs
    js, ts = fi["jstate"], fi["tstate"]
    want = jfuse(js.smap, jnp.asarray(js.curr_pose), jnp.asarray(fi["T_odo"]),
                 fi["raw"], fi["filt"], fi["rgb"], fi["sp"], fi["tick"],
                 CONFIG)
    got = fuse_frame(ts.smap, ts.curr_pose, T(fi["T_odo"]), T(fi["raw"]),
                     T(fi["filt"]), T(fi["rgb"]), T(fi["sp"]), ts.tick,
                     TCONFIG)
    _compare_fuse(got, want, CONFIG.rows, CONFIG.cols)


def test_routed_fuse_frame(inputs):
    """The routed branch at a 320x240 camera with route_factor=2: strided
    picks, the texel fuse on the 160x120 grid, the prediction repeated
    back up to 320x240."""
    from staticfusion_tpu.fusion.backend import fuse_frame as jfuse
    from staticfusion_tpu_torch.fusion.backend import fuse_frame
    fi = inputs
    frames, _ = synthetic.make_sequence(ROUTED, N_STATE + 1, TWIST)
    raw, filt, rgb, sp = _measurements(ROUTED, frames[N_STATE],
                                       np.random.default_rng(5))
    js, ts = fi["jstate"], fi["tstate"]
    want = jfuse(js.smap, jnp.asarray(js.curr_pose), jnp.asarray(fi["T_odo"]),
                 raw, filt, rgb, sp, fi["tick"], ROUTED)
    got = fuse_frame(ts.smap, ts.curr_pose, T(fi["T_odo"]), T(raw), T(filt),
                     T(rgb), T(sp), ts.tick, TROUTED)
    _compare_fuse(got, want, ROUTED.rows, ROUTED.cols)
    # Each 2x2 block of the carried view is one routed pixel.
    d = got.pred.depth.numpy()
    np.testing.assert_array_equal(d[0::2, 0::2], d[1::2, 1::2])


def test_routed_bootstrap_map(inputs):
    """bootstrap_step at a 320x240 camera with route_factor=2: the first
    map comes from the [::2, ::2] grid at the routed camera."""
    from staticfusion_tpu.pipeline.step import Frame as JFrame
    from staticfusion_tpu.pipeline.step import bootstrap_step as jboot
    from staticfusion_tpu_torch.pipeline.step import Frame, bootstrap_step
    frames, _ = synthetic.make_sequence(ROUTED, 2, TWIST)
    jf = [JFrame(jnp.asarray(f[0]), jnp.asarray(f[1])) for f in frames]
    tf = [Frame(torch.as_tensor(f[0]), torch.as_tensor(f[1]))
          for f in frames]
    eye = np.eye(4, dtype=np.float32)
    jstate, jout = jboot(jf[0], jf[1], jnp.asarray(eye), ROUTED)
    tstate, tout = bootstrap_step(tf[0], tf[1], torch.as_tensor(eye),
                                  TROUTED)
    jm, tm = jstate.smap, tstate.smap
    # 160x120 = 19200 routed pixels -> the 3 * 2^13 tier.
    assert tm.capacity == jm.capacity == 24576
    assert int(tm.used) == int(jm.used) == 19200
    agree(tm.valid, jm.valid)
    # Positions and the rendered view move with the bootstrap pose (one
    # IRLS solve; the tolerance of tests/test_torch_slice.py's stepped
    # poses, 2e-3, over lever arms up to 3.2 m).
    close(tout.curr_pose, jout.curr_pose, rtol=0, atol=2e-3)
    close(tm.pos, jm.pos, rtol=0, atol=1e-2)
    for f in ("conf", "color", "radius"):
        close(getattr(tm, f), getattr(jm, f), rtol=1e-4, atol=1e-4)
    assert tuple(tstate.pred.depth.shape) == (240, 320)
    same = np.isclose(tstate.pred.depth.numpy(),
                      np.asarray(jstate.pred.depth), rtol=0, atol=1e-2)
    assert same.mean() >= 0.99, same.mean()


@pytest.mark.parametrize("case", ["qvga_f1", "vga_routed", "qvga_f4",
                                  "post_eq_index", "capacity_2e21",
                                  "loop_closure"])
def test_check_supported(case):
    """SlamSystem accepts F=1 at QVGA and routed VGA, the F=4 default, the
    sparse fuse with post_factor == index_factor, capacities above
    2^21 - 1 (the two-pass z-buffer) and loop closure: no configuration
    is refused."""
    import dataclasses

    from staticfusion_tpu_torch.config import (CameraConfig as TCam,
                                               FusionConfig as TFus,
                                               LoopClosureConfig)
    from staticfusion_tpu_torch.config import SFConfig as TSF
    from staticfusion_tpu_torch.pipeline.system import SlamSystem
    qvga = TCam(width=320, height=240)
    cfg = {
        "qvga_f1": TSF(camera=qvga, fusion=TFus(capacity=1 << 18,
                                                index_factor=1)),
        "vga_routed": TSF(camera=TCam(width=640, height=480),
                          fusion=TFus(capacity=1 << 20, index_factor=1)),
        "qvga_f4": TSF(camera=qvga),
        "post_eq_index": TSF(camera=qvga, fusion=TFus(post_factor=4)),
        "capacity_2e21": TSF(camera=qvga, fusion=TFus(capacity=1 << 21,
                                                      index_factor=1)),
        "loop_closure": TSF(camera=qvga),
    }[case]
    if case == "loop_closure":
        cfg = cfg.replace(loop=dataclasses.replace(LoopClosureConfig(),
                                                   enabled=True))
    slam = SlamSystem(cfg, device="cpu")
    assert slam.device.type == "cpu"
    assert (slam._kf_db is not None) == (case == "loop_closure")
