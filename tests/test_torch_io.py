"""The port's dataset I/O against the JAX package: the PNG encoder, the
native decoder and frame loader, the TUM assoc/ground-truth/trajectory
parsers and the ATE/RPE evaluators, the rawlog reader and writer (and the
golden records of tests/test_rawlog_golden.py), the PLY writer, the
metrics logger, and the native library's build.

No test here reaches the JAX package's native library: where its reader
would decode a PNG, the port is held against the arrays the file was
written from.  The native library is built by g++ into a temporary
directory (the `sfio` fixture), never into the repository.
"""

import gzip
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from staticfusion_tpu.io import png as jpng
from staticfusion_tpu.io import rawlog as jrawlog
from staticfusion_tpu.io import trajectory as jtraj
from staticfusion_tpu.io import tum as jtum
from staticfusion_tpu_torch.io import native, png, rawlog, trajectory, tum
from staticfusion_tpu_torch.kernels import _build

# The suite runs in parallel worker processes: a small intra-op pool per
# worker keeps them from oversubscribing the host's cores.
torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _drop_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def sfio(tmp_path_factory):
    """The native I/O library, built into a temporary directory."""
    root = tmp_path_factory.mktemp("sfio")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "BUILD_DIR", root / "build")
        mp.setenv("XDG_CACHE_HOME", str(root / "cache"))
        native.load()
        yield native


@pytest.mark.parametrize("name", ["png_decode.cpp", "loader.cpp",
                                  "ply_write.cpp"])
def test_native_sources_are_copies_of_native(name):
    """The port builds its own copies of native/*.cpp; a fix there must
    reach them too."""
    port = REPO / "staticfusion_tpu_torch" / "csrc" / "io" / name
    assert port.read_bytes() == (REPO / "native" / name).read_bytes()


def _images():
    rng = np.random.default_rng(0)
    return {"gray8": (rng.random((17, 23)) * 255).astype(np.uint8),
            "rgb8": (rng.random((32, 40, 3)) * 255).astype(np.uint8),
            "u16": (rng.random((24, 31)) * 65535).astype(np.uint16)}


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "u16"])
def test_png_encoder_bytes_match_jax(kind):
    img = _images()[kind]
    assert png.encode_png(img) == jpng.encode_png(img)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "u16"])
def test_native_decoder_round_trips(sfio, kind, tmp_path):
    img = _images()[kind]
    path = str(tmp_path / f"{kind}.png")
    png.write_png(path, img)
    got = sfio.decode_png(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)


def test_rejected_png_falls_back_to_pil_only(sfio, tmp_path, monkeypatch):
    """A file the native decoder rejects goes to Pillow; without Pillow it
    raises, naming the file."""
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40)
    assert sfio.decode_png(str(bad)) is None
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(IOError, match="bad.png"):
        tum._decode_png(str(bad))


def _write_assoc(root):
    (root / "rgbd_assoc.txt").write_text(
        "# color depth\n\n"
        "1305031102.175304 rgb/a.png 1305031102.160407 depth/a.png\n"
        "1305031102.211214 rgb/b.png 1305031102.226738 depth/b.png extra\n"
        "1305031102.3 short line\n")


def test_load_assoc_matches_jax(tmp_path):
    _write_assoc(tmp_path)
    got = tum.load_assoc(str(tmp_path))
    want = jtum.load_assoc(str(tmp_path))
    assert [(e.timestamp, e.rgb_path, e.depth_path) for e in got] == [
        (e.timestamp, e.rgb_path, e.depth_path) for e in want]
    assert len(got) == 2


def _random_poses(rng, n):
    from scipy.spatial.transform import Rotation

    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :3] = Rotation.from_rotvec(
        rng.normal(0, 0.2, (n, 3))).as_matrix()
    poses[:, :3, 3] = np.cumsum(rng.normal(0, 0.02, (n, 3)), axis=0)
    return poses


def test_trajectory_parsers_and_errors_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    n = 12
    times = 1000.0 + np.arange(n) / 30.0
    gt = _random_poses(rng, n)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.01, (n, 3))
    path = str(tmp_path / "traj.txt")
    trajectory.write_tum_trajectory(path, times, est)
    with open(path, "a") as f:
        f.write("# a comment\n1.0 2.0\n")
    t_got, p_got = trajectory.read_tum_trajectory(path)
    t_want, p_want = jtraj.read_tum_trajectory(path)
    np.testing.assert_allclose(t_got, t_want, rtol=1e-6)
    np.testing.assert_allclose(p_got, p_want, rtol=1e-6, atol=1e-12)
    for fn, jfn in ((trajectory.ate_rmse, jtraj.ate_rmse),
                    (trajectory.rpe_rmse, jtraj.rpe_rmse)):
        got = fn(t_got, p_got, times, gt)
        assert np.isfinite(got) and got > 0
        np.testing.assert_allclose(got, jfn(t_want, p_want, times, gt),
                                   rtol=1e-6)
    np.testing.assert_allclose(
        trajectory.rpe_rmse(t_got, p_got, times, gt, delta=3),
        jtraj.rpe_rmse(t_want, p_want, times, gt, delta=3), rtol=1e-6)


@pytest.fixture(scope="module")
def dataset(sfio, tmp_path_factory):
    """A 4-frame TUM-layout dataset at 160x120 written by the port's
    exporter, with the arrays it was written from."""
    from staticfusion_tpu_torch.apps import make_synthetic_dataset
    from staticfusion_tpu_torch.config import CameraConfig, SFConfig
    from staticfusion_tpu_torch.io import synthetic

    out = tmp_path_factory.mktemp("tum")
    make_synthetic_dataset.main([str(out), "--frames", "4",
                                 "--res-factor", "4"])
    cfg = SFConfig(camera=CameraConfig(width=160, height=120))
    frames, poses = synthetic.make_sequence(cfg, 4,
                                            make_synthetic_dataset.TWIST)
    return out, frames, poses


def test_tum_sequence_reads_what_was_written(dataset):
    out, frames, poses = dataset
    seq = tum.TumSequence(str(out), res_factor=1)
    assert len(seq) == 4
    for (rgb, dmm, ts), (rgb_w, dmm_w, _), i in zip(seq, frames, range(4)):
        assert ts == pytest.approx(1000.0 + i / 30.0)
        stored = np.clip(rgb_w * 255.0, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(rgb, stored.astype(np.float32) / 255.0)
        depth = np.clip(dmm_w * 5.0, 0, 65535).astype(np.uint16)
        np.testing.assert_array_equal(dmm, depth.astype(np.float32) * 0.2)
    # groundtruth.txt holds 6 decimals.
    np.testing.assert_allclose(seq.gt_poses, poses, atol=1e-5)
    np.testing.assert_allclose(seq.initial_gt_pose(), poses[0], atol=1e-5)
    half = tum.load_frame(seq.entries[1], res_factor=2)
    full = tum.load_frame(seq.entries[1], res_factor=1)
    np.testing.assert_array_equal(half[0], full[0][::2, ::2])
    np.testing.assert_array_equal(half[1], full[1][::2, ::2])


def test_native_frame_loader_matches_load_frame(dataset):
    out, _, _ = dataset
    entries = tum.load_assoc(str(out))
    loader = native.NativeFrameLoader([e.rgb_path for e in entries],
                                      [e.depth_path for e in entries],
                                      res_factor=2, depth_to_mm=0.2)
    try:
        for i, e in enumerate(entries):
            rgb, dmm = loader.get(i, 60, 80)
            want_rgb, want_dmm = tum.load_frame(e, res_factor=2)
            np.testing.assert_allclose(rgb, want_rgb, atol=1e-7)
            np.testing.assert_array_equal(dmm, want_dmm)
        with pytest.raises(ValueError, match="not 30x40"):
            loader.get(0, 30, 40)
    finally:
        loader.close()


def _rawlog_frames(n=3, rows=48, cols=64):
    rng = np.random.default_rng(3)
    frames, ts = [], []
    for i in range(n):
        rgb = rng.random((rows, cols, 3)).astype(np.float32)
        depth = (1.0 + 0.002 * i + 0.3 * rng.random((rows, cols))).astype(
            np.float32)
        depth[0, 0] = 4.9           # beyond max_distance -> dropped
        depth[1, 1] = 1.2345678     # mm truncation
        frames.append((rgb, depth))
        ts.append(1341840000.0 + i / 30.0)
    return frames, ts


def _write_gt(path, ts):
    with open(path, "w") as f:
        f.write("# ground truth\n# trajectory\n# t x y z qx qy qz qw\n")
        for i, t in enumerate(ts):
            f.write(f"{t:.4f} {0.1 * i:.4f} 0.0 0.0 0 0 0.0998 0.995\n")


def test_rawlog_stream_matches_jax_writer_and_reader(sfio, tmp_path):
    """The port's writer emits the JAX writer's object stream (images
    aside); the port's reader and the JAX reader parse the same scans and
    ground truth; the images decode to the pixels that were stored."""
    frames, ts = _rawlog_frames()
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    ppath = str(tmp_path / "p" / "seq.rawlog")
    jpath = str(tmp_path / "j" / "seq.rawlog")
    rawlog.write_rawlog(ppath, frames, ts)
    jrawlog.write_rawlog(jpath, frames, ts)
    assert (gzip.decompress(pathlib.Path(ppath).read_bytes())
            == gzip.decompress(pathlib.Path(jpath).read_bytes()))
    for d in ("p", "j"):
        _write_gt(tmp_path / d / "groundtruth.txt", ts)
    got = rawlog.RawlogSequence(ppath, res_factor=1)
    want = jrawlog.RawlogSequence(jpath, res_factor=1)
    assert len(got) == len(want) == len(frames)
    for a, b in zip(got.scans, want.scans):
        assert (a.timestamp, a.intensity_file, a.sensor_label,
                a.max_range) == (b.timestamp, b.intensity_file,
                                 b.sensor_label, b.max_range)
        np.testing.assert_array_equal(a.range_image, b.range_image)
    np.testing.assert_array_equal(got.gt_times, want.gt_times)
    np.testing.assert_allclose(got.gt_poses, want.gt_poses, rtol=1e-6)
    np.testing.assert_allclose(got.initial_gt_pose(), want.initial_gt_pose(),
                               rtol=1e-6)
    np.testing.assert_allclose(got.gt_pose_for(ts[2]),
                               want.gt_pose_for(ts[2]), rtol=1e-6)
    # Datasets.cpp semantics: 180-degree read, BGR-as-RGB, whole mm, 4.5 m.
    for (rgb, dmm, t), (rgb_w, d_w), t_w in zip(got, frames, ts):
        assert t == pytest.approx(t_w, abs=1e-4)
        stored = np.round(np.clip(rgb_w, 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(
            rgb, stored[::-1, ::-1].astype(np.float32) / 255.0)
        np.testing.assert_array_equal(
            dmm, np.where(d_w < 4.5, np.trunc(d_w * 1000.0),
                          0.0)[::-1, ::-1].astype(np.float32))
    rgb2, dmm2, _ = next(iter(rawlog.RawlogSequence(ppath, res_factor=2)))
    assert rgb2.shape == (24, 32, 3) and dmm2.shape == (24, 32)


def _golden():
    spec = importlib.util.spec_from_file_location(
        "_rawlog_golden_vectors", REPO / "tests" / "test_rawlog_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _golden_blob(case):
    g = _golden()
    obs = g.golden_observation(g.DEPTHS)
    if case == "single":
        return obs
    if case == "trailing":
        trailing = (np.float32(1.5).tobytes()
                    + np.uint32(7).tobytes())
        return (g.golden_observation(g.DEPTHS, trailing=trailing)
                + g.golden_observation([[9.0]], fname=b"img_1.png"))
    if case == "foreign":
        foreign = (g.header("CObservationOdometry", 1)
                   + np.array([0.5, -1.0, 0.25], "<f8").tobytes() + g.END)
        return foreign + obs + foreign
    return gzip.compress(obs + g.golden_observation([[2.0]],
                                                    fname=b"img_1.png"))


def _parse_all(module, blob):
    if blob[:2] == b"\x1f\x8b":
        blob = gzip.decompress(blob)
    r = module._Reader(io.BytesIO(blob))
    scans = []
    while (s := module.read_scan(r)) is not None:
        scans.append(s)
    return scans


@pytest.mark.parametrize("case", ["single", "trailing", "foreign", "gzip"])
def test_golden_records_parse_as_in_jax(case):
    blob = _golden_blob(case)
    got, want = _parse_all(rawlog, blob), _parse_all(jrawlog, blob)
    assert len(got) == len(want) >= 1
    for a, b in zip(got, want):
        assert (a.timestamp, a.intensity_file, a.sensor_label,
                a.max_range) == (b.timestamp, b.intensity_file,
                                 b.sensor_label, b.max_range)
        np.testing.assert_array_equal(a.range_image, b.range_image)
    assert got[0].timestamp == pytest.approx(1755734400.0, abs=1e-6)


def test_ply_writer(sfio, tmp_path):
    """Vertex count and header through save_ply/load_ply_count, and the
    records: position, color to 8 bits (rounded), flipped normal,
    radius."""
    from staticfusion_tpu_torch.fusion.surfels import empty_map
    from staticfusion_tpu_torch.io.ply import load_ply_count, save_ply

    rng = np.random.default_rng(5)
    n = 256
    t = lambda a: torch.as_tensor(a.astype(np.float32))
    smap = empty_map(n)._replace(
        pos=t(rng.normal(size=(n, 3))), conf=t(rng.random(n)),
        color=t(rng.random((n, 3))), normal=t(rng.normal(size=(n, 3))),
        radius=t(rng.random(n)), valid=torch.as_tensor(rng.random(n) < 0.7))
    path = str(tmp_path / "map.ply")
    keep = smap.valid.numpy() & (smap.conf.numpy() > 0.25)
    assert save_ply(path, smap, 0.25) == load_ply_count(path) == keep.sum()
    raw = open(path, "rb").read()
    head, body = raw.split(b"end_header\n")
    assert head.decode().splitlines() == [
        "ply", "format binary_little_endian 1.0",
        f"element vertex {keep.sum()}", "property float x",
        "property float y", "property float z", "property uchar red",
        "property uchar green", "property uchar blue", "property float nx",
        "property float ny", "property float nz", "property float radius"]
    rec = np.frombuffer(body, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3),
                                     ("normal", "<f4", 3), ("radius", "<f4")])
    np.testing.assert_array_equal(rec["xyz"], smap.pos.numpy()[keep])
    np.testing.assert_array_equal(
        rec["rgb"], np.clip(smap.color.numpy()[keep] * np.float32(255)
                            + np.float32(0.5), 0, 255).astype(np.uint8))
    np.testing.assert_array_equal(rec["normal"], -smap.normal.numpy()[keep])
    np.testing.assert_array_equal(rec["radius"], smap.radius.numpy()[keep])


def test_metrics_logger_rows_match_jax(tmp_path):
    from staticfusion_tpu.utils.metrics import MetricsLogger as JLogger
    from staticfusion_tpu_torch.utils.metrics import MetricsLogger, StageTimer

    logs = []
    for cls, name in ((MetricsLogger, "p.jsonl"), (JLogger, "j.jsonl")):
        log = cls(str(tmp_path / name))
        log.log(frame=0, surfels=100, dense=True, fps=10.0)
        log.log(ate_rmse=0.01)
        log.log(frame=1, surfels=120, dense=False, fps=20.0)
        log.close()
        rows = [json.loads(line) for line in open(tmp_path / name)]
        assert all(isinstance(r.pop("t_wall"), float) for r in rows)
        logs.append((rows, log.summary()))
    assert logs[0] == logs[1]
    assert logs[0][1]["fps"]["mean"] == 15.0
    timer = StageTimer()
    for _ in range(2):
        with timer.time("stage"):
            pass
    assert list(timer.means()) == ["stage"] and timer.means()["stage"] >= 0


_BUILD_AND_DECODE = r"""
import pathlib, sys, time
sys.path.insert(0, sys.argv[1])
from staticfusion_tpu_torch.kernels import _build
_build.BUILD_DIR = pathlib.Path(sys.argv[2])
from staticfusion_tpu_torch.io import native
existed = native.library_path().exists()
# Start the build only when the other process is ready too.
ready = pathlib.Path(sys.argv[4])
(ready / sys.argv[5]).touch()
deadline = time.time() + 60
while len(list(ready.iterdir())) < 2 and time.time() < deadline:
    time.sleep(0.01)
img = native.decode_png(sys.argv[3])
print(existed, int(img.astype("int64").sum()), img.shape)
"""


def test_concurrent_builds_install_one_library(tmp_path):
    """Two processes build the native library into the same empty
    directory at once with the real g++; both load it and decode the same
    PNG, and the directory ends with one libsfio_<hash>.so and no
    temporary file."""
    img = _images()["rgb8"]
    png.write_png(str(tmp_path / "a.png"), img)
    build, ready = tmp_path / "build", tmp_path / "ready"
    ready.mkdir()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_AND_DECODE, str(REPO), str(build),
         str(tmp_path / "a.png"), str(ready), f"p{i}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split(maxsplit=1) == [
            "False", f"{int(img.astype(np.int64).sum())} {img.shape}\n"]
    files = sorted(p.name for p in build.iterdir())
    assert len(files) == 1, files
    assert files[0].startswith("libsfio_") and files[0].endswith(".so")


def test_first_call_builds_and_a_failed_build_raises(tmp_path, monkeypatch):
    """Importing builds nothing: the library appears at the first call.  A
    compiler that fails raises with its output and leaves no file."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    stub = tmp_path / "cxx"
    stub.write_text("#!/bin/sh\necho 'error: zlib.h: no such file'\nexit 1\n")
    stub.chmod(0o755)
    monkeypatch.setenv("CXX", str(stub))
    with pytest.raises(RuntimeError, match="zlib.h: no such file"):
        native.load()
    assert list((tmp_path / "build").iterdir()) == []
    monkeypatch.delenv("CXX")
    png.write_png(str(tmp_path / "a.png"), _images()["u16"])
    assert not native.library_path().exists()
    np.testing.assert_array_equal(native.decode_png(str(tmp_path / "a.png")),
                                  _images()["u16"])
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        native.library_path().name]


_IMPORT_ALL = r"""
import importlib, pathlib, sys
root = pathlib.Path(sys.argv[1]) / "staticfusion_tpu_torch"
sys.path.insert(0, sys.argv[1])
from staticfusion_tpu_torch.kernels import _build
_build.BUILD_DIR = pathlib.Path(sys.argv[2])
for p in sorted(root.rglob("*.py")):
    m = ".".join(p.relative_to(root.parent).with_suffix("").parts)
    importlib.import_module(m.removesuffix(".__init__"))
print("imported")
"""


def test_importing_the_port_builds_nothing(tmp_path):
    build, cache = tmp_path / "build", tmp_path / "cache"
    env = dict(os.environ, XDG_CACHE_HOME=str(cache), HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL, str(REPO),
                           str(build)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and "imported" in proc.stdout, proc.stderr
    assert not build.exists() and not cache.exists()
