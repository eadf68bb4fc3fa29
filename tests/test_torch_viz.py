"""The port's viewers (staticfusion_tpu_torch/viz) against the JAX
package's on the same inputs (CPU).

One JAX map (surfels.initialise_map at 80x60, capacity 1<<13, a wavy wall
2 m away) goes to the port with `state_from_numpy`.  Rendered from a moved
viewpoint, the port's `render_view` gives the JAX view's hit mask and
`colorize` its bytes in every mode; from the frontal viewpoint, where the
surfels were made, every surfel sits on an exact texel boundary (ROADMAP
§3) and last-bit differences move a few, so there the hit masks agree at
>= 99.9% of pixels and the colors at >= 99% (measured: 99.65%).  Colorize
of one view, the three panels, compose_panels, the live viewer's PNG,
build_html, save_html and load_ply are byte-identical to JAX's.  The
behaviour tests are the port's twins of tests/test_viz.py: the viewer's
endpoints on ephemeral ports, always closed, every request with a timeout.
"""

import base64
import json
import struct
import urllib.error
import urllib.request
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from staticfusion_tpu.config import CameraConfig, FusionConfig, SFConfig
from staticfusion_tpu.fusion import surfels as jsurfels
from staticfusion_tpu.fusion import texelmap as jtex
from staticfusion_tpu.geometry import se3 as jse3
from staticfusion_tpu.viz import live as jlive
from staticfusion_tpu.viz import offline as joff
from staticfusion_tpu.viz import render as jrender
from staticfusion_tpu.viz import webviewer as jweb
from staticfusion_tpu_torch.config import SFConfig as TorchConfig
from staticfusion_tpu_torch.fusion import texelmap as ttex
from staticfusion_tpu_torch.fusion.predict import PredictedView
from staticfusion_tpu_torch.fusion.surfels import SurfelMap
from staticfusion_tpu_torch.io.png import encode_png
from staticfusion_tpu_torch.pipeline.state import state_from_numpy
from staticfusion_tpu_torch.viz import live as tlive
from staticfusion_tpu_torch.viz import offline as toff
from staticfusion_tpu_torch.viz import render as trender
from staticfusion_tpu_torch.viz import webviewer as tweb

# The suite runs in parallel worker processes: a small intra-op pool per
# worker keeps them from oversubscribing the host's cores.
torch.set_num_threads(2)

CONFIG = SFConfig(camera=CameraConfig(width=80, height=60),
                  fusion=FusionConfig(capacity=1 << 13))
TCONFIG = TorchConfig.from_json(CONFIG.to_json())
MOVED = np.array([0.1, -0.05, -0.3, 0.02, 0.03, -0.01], np.float32)
HIT_AGREE = 0.999
FRONTAL_COLOR_AGREE = 0.99


@pytest.fixture(autouse=True)
def _drop_jax_caches():
    """Drop JAX's in-memory executables after every test."""
    yield
    jax.clear_caches()


def _jax_map(depth=2.0, wave=0.3):
    rows, cols = CONFIG.rows, CONFIG.cols
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    d = (depth + wave * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(
        np.float32)
    rgb = np.stack([0.5 + 0.4 * np.sin(xx / 17.0),
                    0.5 + 0.4 * np.cos(yy / 13.0),
                    np.full_like(xx, 0.5)], axis=-1).astype(np.float32)
    return jsurfels.initialise_map(
        CONFIG.fusion.capacity, jnp.asarray(d), jnp.asarray(d),
        jnp.asarray(rgb), jnp.asarray(np.ones_like(d)), jnp.eye(4), CONFIG)


def _to_port(jmap) -> SurfelMap:
    return state_from_numpy(jax.tree.map(np.asarray, jmap), device="cpu",
                            cls=SurfelMap)


def _pose(name):
    if name == "frontal":
        return np.eye(4, dtype=np.float32)
    return np.array(jse3.se3_exp(jnp.asarray(MOVED)))


@pytest.fixture(scope="module")
def maps():
    jmap = _jax_map()
    return jmap, _to_port(jmap)


@pytest.fixture(scope="module")
def views(maps):
    """{pose: (JAX view as numpy, port view)} at conf threshold 0.1."""
    jmap, tmap = maps
    out = {}
    for name in ("frontal", "moved"):
        T = _pose(name)
        jv = jrender.render_view(jmap, jnp.asarray(T), jnp.asarray(0.1),
                                 CONFIG)
        out[name] = (PredictedView(*(np.asarray(f) for f in jv)),
                     trender.render_view(tmap, T, 0.1, TCONFIG))
    jax.clear_caches()
    return out


@pytest.mark.parametrize("pose", ["frontal", "moved"])
@pytest.mark.parametrize("mode", trender.MODES)
def test_render_view_and_colorize_match_jax(views, pose, mode):
    jv, tv = views[pose]
    want = jrender.colorize(jv, mode, CONFIG)
    # colorize of one view: the JAX bytes.
    np.testing.assert_array_equal(trender.colorize(jv, mode, TCONFIG), want)
    got = trender.colorize(tv, mode, TCONFIG)
    assert got.shape == (CONFIG.rows, CONFIG.cols, 3)
    assert got.dtype == np.uint8
    hit_agree = np.mean((tv.depth.numpy() > 0) == (jv.depth > 0))
    same = np.mean(np.all(got == want, axis=-1))
    if pose == "moved":
        assert hit_agree == 1.0
        np.testing.assert_array_equal(got, want)
    else:
        assert hit_agree >= HIT_AGREE, hit_agree
        assert same >= FRONTAL_COLOR_AGREE, same
    assert (got.sum(axis=-1) > 0).mean() > 0.7


def test_time_delta_inf_renders_surfels_past_the_window(maps):
    """Surfels last seen 300 ticks ago leave the fuse path's render (time
    window 200) but not the viewer's (time_delta=inf), in both packages."""
    jmap, _ = maps
    old = np.zeros(CONFIG.fusion.capacity, np.float32)
    old[::2] = -300.0
    jold = jmap._replace(last_time=jnp.asarray(old))
    told = _to_port(jold)
    T = _pose("frontal")
    jlocal = jtex.project_surfels(jold, jnp.asarray(T), CONFIG)
    tlocal = ttex.project_surfels(told, torch.as_tensor(T), TCONFIG)
    tick = np.int32(0)
    hits = {}
    for td in (None, float("inf")):
        want = jtex.render_texel_images(jold, jlocal, jnp.asarray(tick),
                                        CONFIG, time_delta=td)
        got = ttex.render_texel_images(told, tlocal, torch.tensor(tick),
                                       TCONFIG, time_delta=td)
        np.testing.assert_array_equal(got.idx.numpy(),
                                      np.asarray(want.idx))
        hits[td] = int(got.has.sum())
    keep = ttex.render_cull(told, tlocal, torch.tensor(tick), TCONFIG)
    assert not bool(keep[::2].any()) and bool(keep[1::2].any())
    assert hits[float("inf")] > hits[None] > 0
    view = trender.render_view(told, T, 0.0, TCONFIG)
    assert (view.depth > 0).float().mean() > 0.95


def _panel_inputs(seed=0, h=24, w=32):
    rng = np.random.default_rng(seed)
    rgb = rng.random((h, w, 3)).astype(np.float32)
    depth_mm = (rng.random((h, w)) * 5000).astype(np.float32)
    depth_mm[rng.random((h, w)) < 0.1] = 0.0
    prob = rng.random((h, w)).astype(np.float32)
    labels = rng.integers(0, 25, (h, w)).astype(np.int32)
    model = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    return rgb, depth_mm, prob, labels, model


def test_panels_and_mosaics_are_jax_bytes():
    """The panels and both mosaic layouts, from tensors and from arrays."""
    rgb, depth_mm, prob, labels, model = _panel_inputs()
    T = torch.as_tensor
    for got, want in (
            (toff.weight_panel(T(prob), T(depth_mm)),
             joff.weight_panel(prob, depth_mm)),
            (toff.label_panel(T(labels)), joff.label_panel(labels)),
            (toff.depth_panel(T(depth_mm)), joff.depth_panel(depth_mm)),
            (tlive.compose_panels(T(rgb), T(depth_mm), T(prob), T(labels)),
             jlive.compose_panels(rgb, depth_mm, prob, labels)),
            (tlive.compose_panels(rgb, depth_mm, None, None, model=model,
                                  model_img=model),
             jlive.compose_panels(rgb, depth_mm, None, None, model=model,
                                  model_img=model)),
            (tlive.compose_panels(rgb, depth_mm, prob, None,
                                  model_img=model),
             jlive.compose_panels(rgb, depth_mm, prob, None,
                                  model_img=model))):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def _decode_png_rgb(blob: bytes) -> np.ndarray:
    """8-bit RGB PNG with filter 0 on every row (what encode_png writes)."""
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, ctype = struct.unpack(">IIBB", blob[16:26])
    assert depth == 8 and ctype == 2
    pos, idat = 8, b""
    while pos < len(blob):
        n, tag = struct.unpack(">I4s", blob[pos:pos + 8])
        if tag == b"IDAT":
            idat += blob[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_save_frame_panels_writes_the_mosaic_png(tmp_path):
    rgb, depth_mm, prob, labels, _ = _panel_inputs(1)

    out = SimpleNamespace(static_prob=torch.as_tensor(prob),
                          labels=torch.as_tensor(labels))
    path = tmp_path / "frame_00001.png"
    toff.save_frame_panels(str(path), rgb, depth_mm, out)
    img = _decode_png_rgb(path.read_bytes())
    np.testing.assert_array_equal(
        img, jlive.compose_panels(rgb, depth_mm, prob, labels))


def _extract_data(html: str) -> dict:
    start = html.index("const DATA = ") + len("const DATA = ")
    return json.loads(html[start:html.index(";\n", start)])


def _decode(b64: str, dtype) -> np.ndarray:
    return np.frombuffer(base64.b64decode(b64), dtype=dtype)


def test_build_html_is_the_jax_page():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    col = rng.random((100, 3)).astype(np.float32)
    traj = np.cumsum(np.ones((7, 3), np.float32) * 0.1, axis=0)
    trajs = [(traj, (80, 255, 120)), (traj[:0], (1, 2, 3))]
    html = tweb.build_html(pts, col, trajs, title="t")
    assert html == jweb.build_html(pts, col, trajs, title="t")
    data = _extract_data(html)
    np.testing.assert_array_equal(
        _decode(data["pos"], np.float32).reshape(-1, 3), pts)
    assert len(data["trajs"]) == 1
    u8 = (rng.random((100, 3)) * 255).astype(np.uint8)
    assert tweb.build_html(pts, u8) == jweb.build_html(pts, u8)


def test_save_html_applies_the_cut_as_jax(maps, tmp_path):
    """save_html of the port's map (tensors) against JAX's of the JAX map:
    the same page, the confidence cut and both trajectories."""
    jmap, tmap = maps
    rng = np.random.default_rng(3)
    conf = rng.random(CONFIG.fusion.capacity).astype(np.float32)
    jmap = jmap._replace(conf=jnp.asarray(conf))
    tmap = tmap._replace(conf=torch.as_tensor(conf))
    thr = 0.5
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[:, 0, 3] = np.linspace(0, 1, 5)
    gt = poses[:, :3, 3] + 0.01
    a, b = tmp_path / "port.html", tmp_path / "jax.html"
    tweb.save_html(str(a), tmap, thr, trajectory=poses, gt_trajectory=gt)
    jweb.save_html(str(b), jmap, thr, trajectory=poses, gt_trajectory=gt)
    assert a.read_text() == b.read_text()
    data = _extract_data(a.read_text())
    n_expect = int((np.asarray(jmap.valid) & (conf > thr)).sum())
    assert 0 < n_expect < int(np.asarray(jmap.valid).sum())
    assert _decode(data["pos"], np.float32).size == 3 * n_expect
    assert [t["color"] for t in data["trajs"]] == [[80, 255, 120],
                                                   [255, 90, 90]]
    np.testing.assert_array_equal(
        _decode(data["trajs"][0]["pts"], np.float32).reshape(-1, 3),
        poses[:, :3, 3])


def _write_ply(path, pos, rgb, extra_element=True):
    """A binary PLY in save_ply's vertex layout, with a face element
    after the vertices."""
    n = len(pos)
    nrm = np.zeros((n, 3), np.float32)
    rad = np.full(n, 0.01, np.float32)
    dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                   ("red", "u1"), ("green", "u1"), ("blue", "u1"),
                   ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
                   ("radius", "<f4")])
    rec = np.zeros(n, dt)
    for k, name in enumerate("xyz"):
        rec[name] = pos[:, k]
    for k, name in enumerate(("red", "green", "blue")):
        rec[name] = rgb[:, k]
    for k, name in enumerate(("nx", "ny", "nz")):
        rec[name] = nrm[:, k]
    rec["radius"] = rad
    head = ["ply", "format binary_little_endian 1.0", "comment fixture",
            f"element vertex {n}", "property float x", "property float y",
            "property float z", "property uchar red", "property uchar green",
            "property uchar blue", "property float nx", "property float ny",
            "property float nz", "property float radius"]
    if extra_element:
        head += ["element face 0", "property list uchar int vertex_indices"]
    with open(path, "wb") as f:
        f.write(("\n".join(head + ["end_header"]) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def test_load_ply_and_cli_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    pos = rng.normal(size=(50, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    ply = tmp_path / "map.ply"
    _write_ply(ply, pos, rgb)
    got, want = tweb.load_ply(str(ply)), jweb.load_ply(str(ply))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], pos)
    np.testing.assert_array_equal(got[1], rgb)
    a, b = tmp_path / "port.html", tmp_path / "jax.html"
    tweb.main([str(ply), str(a), "--title", "t"])
    jweb.save_html_from_ply(str(b), str(ply), title="t")
    assert a.read_text() == b.read_text()
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"ply\nformat ascii 1.0\nend_header\n")
    with pytest.raises(ValueError, match="unsupported PLY format"):
        tweb.load_ply(str(bad))


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=5).read()


def test_live_viewer_serves_panels_and_metrics():
    rgb, depth_mm, prob, labels, model = _panel_inputs(5)

    out = SimpleNamespace(static_prob=torch.as_tensor(prob),
                          labels=torch.as_tensor(labels))
    v = tlive.LiveViewer(port=0)
    try:
        v.update(rgb, depth_mm, out, model=model, model_img=model,
                 frame=7, fps=42.0)
        base = f"http://127.0.0.1:{v.port}"
        assert b"StaticFusion-TPU live" in _get(base, "/")
        png = _get(base, "/frame.png")
        assert png == encode_png(jlive.compose_panels(
            rgb, depth_mm, prob, labels, model=model, model_img=model))
        assert json.loads(_get(base, "/metrics.json")) == {"frame": 7,
                                                           "fps": 42.0}
        with pytest.raises(urllib.error.HTTPError):
            _get(base, "/nope")
    finally:
        v.close()
    assert not v._thread.is_alive()


def test_live_viewer_interactive_controls():
    v = tlive.LiveViewer(port=0, conf=0.25, depth=4.5)
    try:
        base = f"http://127.0.0.1:{v.port}"
        assert json.loads(_get(base, "/params.json")) == {
            "conf": 0.25, "depth": 4.5, "pause": False}
        p1 = json.loads(_get(base, "/set?conf=0.6&depth=3.0&pause=1"))
        assert p1 == {"conf": 0.6, "depth": 3.0, "pause": True}
        assert v.params() == p1
        # Out-of-range values clamp; pause toggles back off.
        _get(base, "/set?conf=7&depth=100&pause=0")
        assert v.params() == {"conf": 1.0, "depth": 60.0, "pause": False}
        page = _get(base, "/")
        for needle in (b'id="conf"', b'id="depth"', b'id="pause"'):
            assert needle in page
    finally:
        v.close()
    assert not v._thread.is_alive()


def test_render_map_modes_and_moved_viewpoint():
    """The port's twins of tests/test_viz.py's render checks on a flat
    wall 2 m away: every mode covers the frame, depth darkens with
    distance, the wall's normal color, and a camera backed away by 0.5 m
    sees the wall at 2.5 m."""
    tmap = _to_port(_jax_map(wave=0.0))
    for mode in trender.MODES:
        img = trender.render_map(tmap, np.eye(4), TCONFIG, mode=mode)
        assert img.shape == (CONFIG.rows, CONFIG.cols, 3)
        assert (img.sum(axis=-1) > 0).mean() > 0.95, mode
    center = trender.render_map(tmap, np.eye(4), TCONFIG, mode="normal")[
        CONFIG.rows // 2, CONFIG.cols // 2]
    assert abs(int(center[0]) - 128) <= 20
    assert abs(int(center[1]) - 128) <= 20 and center[2] >= 215
    far = _to_port(_jax_map(depth=4.0, wave=0.0))
    assert (trender.render_map(tmap, np.eye(4), TCONFIG, mode="depth").mean()
            > trender.render_map(far, np.eye(4), TCONFIG,
                                 mode="depth").mean())
    T = np.array(jse3.se3_exp(jnp.asarray(
        np.array([0.3, 0.0, -0.5, 0.0, 0.0, 0.0], np.float32))))
    view = trender.render_view(tmap, T, 0.0, TCONFIG)
    hit = view.depth > 0
    assert hit.float().mean() > 0.3
    np.testing.assert_allclose(float(view.depth[hit].mean()), 2.5,
                               atol=0.05)
    with pytest.raises(ValueError, match="mode must be one of"):
        trender.colorize(view, "bogus", TCONFIG)
