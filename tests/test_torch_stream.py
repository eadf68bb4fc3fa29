"""The port's live stream bridge (io/stream.py) and camera app
(apps/run_camera.py) on the CPU.

Both packages' writers emit the same SFRD bytes for the same frames, and
each package's reader parses the other's stream to the same arrays.  The
rest are the port's twins of tests/test_stream.py: exact replay, the 3 m
range gate and the mirror, format errors, drop-to-latest over a paced
socket stream, and the run_camera loop over a paced stream through the
port's SlamSystem (`device="cpu"`, 80x60, capacity 1<<13, 7 frames).
Every socket read has a timeout and every producer thread is joined with
one, so a stall fails a test instead of hanging its worker.
"""

import io
import socket
import threading
import time

import numpy as np
import pytest
import torch

from staticfusion_tpu.io import stream as jstream
from staticfusion_tpu_torch.apps import run_camera
from staticfusion_tpu_torch.config import (CameraConfig, FusionConfig,
                                           SFConfig)
from staticfusion_tpu_torch.io import stream, synthetic
from staticfusion_tpu_torch.io.trajectory import (ate_rmse,
                                                  read_tum_trajectory)
from staticfusion_tpu_torch.pipeline.system import SlamSystem

# The suite runs in parallel worker processes: a small intra-op pool per
# worker keeps them from oversubscribing the host's cores.
torch.set_num_threads(2)

CONFIG = SFConfig(camera=CameraConfig(width=80, height=60),
                  fusion=FusionConfig(capacity=1 << 13))
TIMEOUT = 30.0


def _make_frames(n=8):
    frames, _ = synthetic.make_sequence(CONFIG, n, run_camera.TWIST)
    return frames


def _record(module, frames, ts0=1000.0, dt=1 / 30.0) -> bytes:
    buf = io.BytesIO()
    module.write_stream_header(buf, CONFIG.cols, CONFIG.rows)
    for i, (rgb, depth_mm, _) in enumerate(frames):
        module.write_frame(buf, rgb, depth_mm, ts0 + i * dt)
    module.write_stream_end(buf)
    return buf.getvalue()


def test_writers_emit_the_jax_bytes():
    frames = _make_frames(3)
    blob = _record(stream, frames)
    assert blob == _record(jstream, frames)
    u8 = [(np.round(rgb * 255).astype(np.uint8), d, m)
          for rgb, d, m in frames]
    assert _record(stream, u8) == _record(jstream, u8) == blob
    frame_bytes = 4 + 8 + CONFIG.rows * CONFIG.cols * 5
    assert len(blob) == 16 + 3 * frame_bytes + 4


@pytest.mark.parametrize("writer,reader", [(jstream, stream),
                                           (stream, jstream)],
                         ids=["jax_to_port", "port_to_jax"])
def test_readers_parse_the_other_packages_stream(writer, reader):
    frames = _make_frames(3)
    blob = _record(writer, frames)
    a = reader.StreamReader(io.BytesIO(blob))
    b = writer.StreamReader(io.BytesIO(blob))
    assert (a.version, a.width, a.height) == (1, CONFIG.cols, CONFIG.rows)
    for _ in frames:
        fa, fb = a.next_frame(), b.next_frame()
        assert fa[0] == fb[0]
        for x, y in zip(fa[1:], fb[1:]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert a.next_frame() is None and b.next_frame() is None


def test_roundtrip_replay_is_exact():
    frames = _make_frames(4)
    src = stream.StreamSource(io.BytesIO(_record(stream, frames)),
                              latest_only=False, max_distance_m=100.0)
    for i, (rgb, depth_mm, _) in enumerate(frames):
        g_rgb, g_depth, ts = src.get()
        # u8 quantization on the wire.
        want = np.round(np.clip(rgb, 0, 1) * 255) / 255.0
        np.testing.assert_allclose(g_rgb, want, atol=1e-6)
        np.testing.assert_array_equal(g_depth, depth_mm.astype(np.uint16))
        assert ts == pytest.approx(1000.0 + i / 30.0)
    assert src.get() is None
    assert src.received == 4 and len(src.latencies) == 4


def test_camera_range_gate_and_mirror():
    rgb = np.zeros((60, 80, 3), np.float32)
    rgb[:, :40] = 1.0
    depth = np.full((60, 80), 2500.0, np.float32)
    depth[0, 0] = 3500.0   # beyond the 3 m sensor gate
    depth[1, 0] = 3000.0   # at it: gated too (strictly below passes)
    buf = io.BytesIO()
    stream.write_stream_header(buf, 80, 60)
    stream.write_frame(buf, rgb, depth, 0.0)
    stream.write_stream_end(buf)
    src = stream.StreamSource(io.BytesIO(buf.getvalue()), latest_only=False,
                              mirror=True)
    g_rgb, g_depth, _ = src.get()
    assert g_depth[0, -1] == 0.0 and g_depth[1, -1] == 0.0
    assert g_depth[0, 0] == 2500.0
    assert g_rgb[0, 0, 0] == 0.0 and g_rgb[0, -1, 0] == 1.0  # mirrored


def test_format_errors():
    with pytest.raises(stream.StreamFormatError, match="not an SFRD"):
        stream.StreamReader(io.BytesIO(b"JUNKxxxxxxxxxxxx"))
    bad_version = b"SFRD" + np.array([2, 80, 60], "<u4").tobytes()
    with pytest.raises(stream.StreamFormatError, match="version 2"):
        stream.StreamReader(io.BytesIO(bad_version))
    blob = _record(stream, _make_frames(1))
    r = stream.StreamReader(io.BytesIO(blob[:-500]))   # truncated payload
    with pytest.raises(stream.StreamFormatError, match="truncated"):
        while r.next_frame() is not None:
            pass
    r = stream.StreamReader(io.BytesIO(blob[:16] + b"XXXX"))
    with pytest.raises(stream.StreamFormatError, match="bad frame magic"):
        r.next_frame()


def _paced_socket_stream(frames, period):
    """(reader file, producer thread): a thread writes `frames` onto one end
    of a socket pair, `period` seconds apart, stamped with time.time()."""
    a, b = socket.socketpair()
    b.settimeout(TIMEOUT)
    fa, fb = a.makefile("wb"), b.makefile("rb")

    def produce():
        try:
            stream.write_stream_header(fa, CONFIG.cols, CONFIG.rows)
            fa.flush()
            for rgb, depth_mm, _ in frames:
                stream.write_frame(fa, rgb, depth_mm, time.time())
                fa.flush()
                time.sleep(period)
            stream.write_stream_end(fa)
            fa.flush()
        finally:
            fa.close()
            a.close()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    return fb, t


def test_drop_to_latest_live_semantics():
    """A slow consumer sees the NEWEST frame, not a backlog."""
    frames = _make_frames(6)
    fb, t = _paced_socket_stream(frames, 0.02)
    src = stream.StreamSource(fb, latest_only=True, max_distance_m=100.0)
    got = []
    deadline = time.time() + TIMEOUT
    while time.time() < deadline:
        item = src.get()
        if item is None:
            break
        got.append(item)
        # The consumer is ~7x slower than the producer, so drops show even
        # when a loaded host slows the producer thread.
        time.sleep(0.15)
    t.join(TIMEOUT)
    assert not t.is_alive()
    assert src.received == 6
    assert src.dropped >= 2                 # stale frames were skipped
    assert len(got) == src.received - src.dropped
    assert len(src.latencies) == len(got)
    assert all(0 <= lat < 5.0 for lat in src.latencies)


def test_run_camera_loop_from_paced_stream():
    """The run_camera loop + the port's SlamSystem on the CPU consuming a
    paced socket stream in replay mode, with per-frame latency."""
    frames = _make_frames(7)
    fb, t = _paced_socket_stream(frames, 0.01)
    src = stream.StreamSource(fb, latest_only=False, max_distance_m=100.0)
    slam = SlamSystem(CONFIG, device="cpu")
    latencies = run_camera.run_loop(slam, src, max_frames=None,
                                    log_every=100)
    t.join(TIMEOUT)
    assert not t.is_alive()
    assert len(slam.poses) == len(frames) - 1  # frame 0 seeds the bootstrap
    assert len(latencies) == len(frames)
    assert all(lat >= 0 for lat in latencies)
    slam._materialize_poses()
    p_last = slam.poses[-1]
    assert np.isfinite(p_last).all()
    assert 0 < np.linalg.norm(p_last[:3, 3]) < 0.2


@pytest.fixture
def small_config(monkeypatch):
    """run_camera.main builds SFConfig(): make that the 80x60 config."""
    monkeypatch.setattr(run_camera, "SFConfig", lambda: CONFIG)


def test_run_camera_main_synthetic(small_config, tmp_path, capsys):
    out = tmp_path / "live.txt"
    run_camera.main(["--device", "cpu", "--source", "synthetic",
                     "--frames", "8", "--out", str(out)])
    assert f"wrote 7 poses to {out}" in capsys.readouterr().out
    t, poses = read_tum_trajectory(str(out))
    _, gt = synthetic.make_sequence(CONFIG, 8, run_camera.TWIST)
    assert len(t) == 7
    assert ate_rmse(t, poses, np.arange(8) / 30.0, gt) < 0.02


def test_run_camera_main_replays_a_recorded_file(small_config, tmp_path,
                                                 capsys):
    rec = tmp_path / "rec.sfrd"
    rec.write_bytes(_record(stream, _make_frames(5)))
    run_camera.main(["--device", "cpu", "--source", str(rec), "--replay",
                     "--frames", "0", "--out", str(tmp_path / "t.txt")])
    printed = capsys.readouterr().out
    assert "wrote 4 poses" in printed
    assert "stream: 5 received, 0 dropped" in printed


def test_run_camera_defaults_to_the_card(small_config, tmp_path):
    argv = ["--source", "synthetic", "--frames", "2", "--out",
            str(tmp_path / "t.txt")]
    if torch.cuda.is_available():
        run_camera.main(argv)
        assert (tmp_path / "t.txt").exists()
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            run_camera.main(argv)
        assert not (tmp_path / "t.txt").exists()
