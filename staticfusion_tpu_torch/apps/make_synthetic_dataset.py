"""Export a synthetic RGB-D sequence as a TUM-format dataset on disk
(rgb/*.png 8-bit, depth/*.png 16-bit at 5000/m, rgbd_assoc.txt,
groundtruth.txt), so the dataset apps run without TUM data.  The port's
counterpart of scripts/make_synthetic_dataset.py, with the same flags:

  python -m staticfusion_tpu_torch.apps.make_synthetic_dataset DIR --frames 20
  python -m staticfusion_tpu_torch.apps.run_tum DIR

With --dynamic, a moving sphere crosses the scene (segmentation demo).
"""

import argparse
import os

import numpy as np

from staticfusion_tpu_torch.config import CameraConfig, SFConfig
from staticfusion_tpu_torch.io import synthetic
from staticfusion_tpu_torch.io.png import write_png

TWIST = np.array([0.004, -0.002, 0.006, 0.0015, -0.001, 0.002], np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--res-factor", type=int, default=1,
                    help="1 writes sensor-native 640x480 (apps downsample)")
    ap.add_argument("--dynamic", action="store_true")
    ap.add_argument("--depth-noise", type=float, default=0.0)
    args = ap.parse_args(argv)

    rf = args.res_factor
    config = SFConfig(camera=CameraConfig(width=640 // rf, height=480 // rf))
    sphere = synthetic.default_world()[1] if args.dynamic else None
    frames, poses = synthetic.make_sequence(
        config, args.frames, TWIST, sphere=sphere,
        depth_noise=args.depth_noise)
    write_dataset(args.out_dir, frames, poses)
    print(f"wrote {len(frames)} frames to {args.out_dir} "
          f"({config.cols}x{config.rows})")


def encode_frame(rgb: np.ndarray, depth_mm: np.ndarray):
    """The arrays a frame's PNGs hold: 8-bit RGB, and 16-bit depth at 5000
    units per meter (TUM convention)."""
    return (np.clip(rgb * 255.0, 0, 255).astype(np.uint8),
            np.clip(depth_mm * 5.0, 0, 65535).astype(np.uint16))


def write_dataset(out_dir: str, frames, poses) -> None:
    """Write (rgb, depth_mm, _) frames and their (4, 4) poses in the TUM
    layout, at 30 Hz from t = 1000 s."""
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    assoc, gt = [], []
    for i, (rgb, depth_mm, _) in enumerate(frames):
        t = 1000.0 + i / 30.0
        rgb_p = f"rgb/{t:.6f}.png"
        dep_p = f"depth/{t:.6f}.png"
        rgb8, depth16 = encode_frame(rgb, depth_mm)
        write_png(os.path.join(out_dir, rgb_p), rgb8)
        write_png(os.path.join(out_dir, dep_p), depth16)
        # Loader convention (FrontEnd.cpp:196-210): color first, then depth.
        assoc.append(f"{t:.6f} {rgb_p} {t:.6f} {dep_p}")
        q = quat_from_R(poses[i][:3, :3])
        tx, ty, tz = poses[i][:3, 3]
        gt.append(f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
                  f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")

    with open(os.path.join(out_dir, "rgbd_assoc.txt"), "w") as f:
        f.write("\n".join(assoc) + "\n")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("# ground truth trajectory\n# timestamp tx ty tz qx qy qz qw\n")
        f.write("\n".join(gt) + "\n")


def quat_from_R(R: np.ndarray) -> np.ndarray:
    """(qx, qy, qz, qw) from a rotation matrix (TUM order)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q


if __name__ == "__main__":
    main()
