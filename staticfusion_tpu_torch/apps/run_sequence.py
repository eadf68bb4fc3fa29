"""Run the port on a PNG sequence with an association file, or on an MRPT
rawlog (the reference's StaticFusion-imagesequenceassoc.cpp, headless).
The port's copy of apps/run_sequence.py, with the same flags and
`--device` (the card by default; `--device cpu` runs the plain versions):

  python -m staticfusion_tpu_torch.apps.run_sequence DATASET_DIR
      [--assoc rgbd_assoc.txt] [--depth-scale 1000] [--out traj.txt]
      [--ply map.ply] [--metrics metrics.jsonl] [--max-frames N]
      [--checkpoint state.npz] [--resume state.npz] [--loop-closure]
      [--html map.html] [--viz DIR] [--live PORT] [--live-every 5]
      [--device cuda]

--html writes the final map and the trajectories as one WebGL page,
--viz one panel mosaic PNG per processed frame, and --live serves the
panels, the fused-map renders and the metrics at http://127.0.0.1:PORT/
while the run goes (0 picks a free port); `main` returns that viewer,
still serving the last frame, and the caller closes it.
"""

import argparse
import contextlib
import dataclasses
import os
import time

import numpy as np

from staticfusion_tpu_torch.config import (CameraConfig, FusionConfig,
                                           LoopClosureConfig, SFConfig,
                                           solver_preset_ctor,
                                           solver_preset_datasets)
from staticfusion_tpu_torch.io import rawlog, tum
from staticfusion_tpu_torch.io.ply import save_ply
from staticfusion_tpu_torch.pipeline.system import SlamSystem
from staticfusion_tpu_torch.utils.checkpoint import (load_archive, load_state,
                                                     save_state)
from staticfusion_tpu_torch.utils.metrics import MetricsLogger
from staticfusion_tpu_torch.viz.live import LiveViewer
from staticfusion_tpu_torch.viz.offline import save_frame_panels
from staticfusion_tpu_torch.viz.render import (colorize, render_view,
                                               view_to_host)
from staticfusion_tpu_torch.viz.webviewer import save_html


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset_dir")
    ap.add_argument("--assoc", default="rgbd_assoc.txt")
    ap.add_argument("--depth-scale", type=float, default=1000.0,
                    help="depth units per meter (TUM PNGs: 5000)")
    ap.add_argument("--res-factor", type=int, default=2)
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--ply", default=None)
    ap.add_argument("--html", default=None,
                    help="self-contained WebGL viewer of the final map")
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--viz", default=None,
                    help="directory for per-frame viz panels")
    ap.add_argument("--gt", default=None, help="groundtruth.txt for ATE")
    ap.add_argument("--checkpoint", default=None,
                    help="write the final SlamState (npz) here")
    ap.add_argument("--resume", default=None,
                    help="resume from a checkpoint written by --checkpoint "
                         "(config must match; trajectory covers only the "
                         "resumed frames)")
    ap.add_argument("--profile", default=None,
                    help="directory for a torch.profiler trace of the run "
                         "(trace.json, Chrome trace format)")
    ap.add_argument("--loop-closure", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="keyframe loop detection + pose-graph correction")
    ap.add_argument("--conf-threshold", type=float, default=None,
                    help="surfel confidence cut for --ply (default: config "
                         "value)")
    ap.add_argument("--index-factor", type=int, default=None,
                    help="index-map super-resolution factor (default: the "
                         "config default, 4; 1 = fast preset)")
    ap.add_argument("--post-factor", type=int, default=None,
                    help="texel factor of the post-merge clean/splat passes "
                         "at index-factor > 1 (default: config default 2)")
    ap.add_argument("--live", type=int, default=None, metavar="PORT",
                    help="serve a live view (RGB/depth/weights/clusters "
                         "panels, fused-map renders and metrics) at "
                         "http://127.0.0.1:PORT while running; 0 picks a "
                         "free port (the reference shows these panels in "
                         "its Pangolin GUI, Utils/GUI.h:87-99)")
    ap.add_argument("--live-every", type=int, default=5,
                    help="refresh the --live view every N frames")
    ap.add_argument("--solver-preset", default="default",
                    choices=["default", "datasets", "ctor"],
                    help="solver parameter set: 'default' = repo defaults; "
                         "'datasets' = the reference datasets main "
                         "(StaticFusion-datasets.cpp:79-94); 'ctor' = the "
                         "reference ctor defaults (FrontEnd.cpp:65-76)")
    ap.add_argument("--lambda-reg", type=float, default=None,
                    help="override the solver's cluster-coupling "
                         "regularizer (reference: 0.35)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    return ap


def make_config(args) -> SFConfig:
    """Sensor-native 640x480 divided by --res-factor (the reference's
    `res_factor` constant; 2 -> QVGA, 1 -> VGA), with the fusion and
    solver flags applied."""
    fkw = {}
    if args.index_factor is not None:
        fkw["index_factor"] = args.index_factor
    if args.post_factor is not None:
        fkw["post_factor"] = args.post_factor
    solver = {"default": None, "datasets": solver_preset_datasets,
              "ctor": solver_preset_ctor}[args.solver_preset]
    skw = {} if solver is None else {"solver": solver()}
    config = SFConfig(camera=CameraConfig(width=640 // args.res_factor,
                                          height=480 // args.res_factor),
                      fusion=FusionConfig(**fkw),
                      loop=LoopClosureConfig(enabled=args.loop_closure),
                      **skw)
    if args.lambda_reg is not None:
        config = config.replace(solver=dataclasses.replace(
            config.solver, lambda_reg=args.lambda_reg))
    return config


def main(argv=None):
    args = parser().parse_args(argv)

    is_rawlog = args.dataset_dir.endswith(".rawlog")
    if is_rawlog:
        seq = rawlog.RawlogSequence(args.dataset_dir,
                                    res_factor=args.res_factor)
    else:
        seq = tum.TumSequence(args.dataset_dir, args.assoc,
                              res_factor=args.res_factor,
                              depth_scale=args.depth_scale,
                              gt_file=args.gt or "groundtruth.txt")
    config = make_config(args)
    slam = SlamSystem(config, device=args.device,
                      initial_pose=seq.initial_gt_pose())
    if is_rawlog:
        # Exported poses land in the raw TUM GT frame (Datasets.cpp:257).
        slam.pose_postmultiply = rawlog.ROTATE_BY_Z
    if args.resume:
        slam.state = load_state(args.resume, config, device=slam.device)
        slam.archive = load_archive(args.resume, device=slam.device)
        print(f"resumed from {args.resume} "
              f"(tick={int(slam.state.tick)})")
    logger = MetricsLogger(args.metrics, echo=args.metrics is None)
    profile_ctx = (_profiler(args.profile, slam.device) if args.profile
                   else contextlib.nullcontext())

    viewer = None
    if args.live is not None:
        viewer = LiveViewer(args.live,
                            conf=config.fusion.confidence_threshold,
                            depth=config.fusion.depth_max)
        print(f"live view: http://127.0.0.1:{viewer.port}/", flush=True)
    try:
        with profile_ctx:
            _run_frames(args, seq, slam, logger, viewer)
    except BaseException:
        if viewer is not None:
            viewer.close()
        raise

    slam.write_trajectory(args.out)
    print(f"wrote {len(slam.poses)} poses to {args.out}")
    if config.loop.enabled:
        print(f"closed {len(slam.loop_closures)} loops"
              + (f": {slam.loop_closures}" if slam.loop_closures else ""))
    if seq.gt_times is not None:
        ate = slam.ate(seq.gt_times, seq.gt_poses)
        rpe = slam.rpe(seq.gt_times, seq.gt_poses)
        print(f"ATE RMSE vs groundtruth: {ate:.4f} m")
        print(f"RPE RMSE vs groundtruth (1 frame): {rpe:.4f} m")
        logger.log(ate_rmse=ate, rpe_rmse=rpe)
    thr = (config.fusion.confidence_threshold
           if args.conf_threshold is None else args.conf_threshold)
    if args.ply:
        n = save_ply(args.ply, slam.full_map(), thr)
        print(f"wrote {n} surfels to {args.ply}")
    if args.html:
        save_html(args.html, slam.full_map(), thr,
                  trajectory=np.asarray(slam.poses),
                  gt_trajectory=seq.gt_poses if seq.gt_times is not None
                  else None)
        print(f"wrote web viewer to {args.html}")
    if args.checkpoint:
        save_state(args.checkpoint, slam.state, config,
                   archive=slam.archive)
        print(f"wrote checkpoint to {args.checkpoint}")
    logger.close()
    return viewer


@contextlib.contextmanager
def _profiler(out_dir: str, device):
    """A torch.profiler session over the run, written to
    out_dir/trace.json."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    print(f"wrote a torch.profiler trace to {out_dir}/trace.json")


def _run_frames(args, seq, slam, logger, viewer):
    for i, (rgb, depth_mm, ts) in enumerate(seq):
        if args.max_frames and i >= args.max_frames:
            break
        if viewer is not None:
            # Pause control read back into the loop (the reference polls
            # its GUI pause checkbox every frame, FrontEnd.cpp:1285).
            while viewer.params()["pause"]:
                time.sleep(0.1)
        out = slam.process(rgb, depth_mm, ts)
        if out is None:
            continue
        fps = 1.0 / max(slam.frame_seconds[-1], 1e-9)
        logger.log(frame=i, surfels=int(out.surfel_count),
                   dense=bool(out.dense), fps=fps)
        if viewer is not None and i % max(args.live_every, 1) == 0:
            # Model + ModelImg panels (Utils/GUI.h:87-99), rendered with
            # the browser's live confidence/depth settings.
            p = viewer.params()
            view = view_to_host(render_view(slam.state.smap, out.curr_pose,
                                            p["conf"], slam.config))
            cut = view.depth <= p["depth"]
            model = colorize(view, "phong", slam.config)
            model_img = colorize(view, "rgb", slam.config)
            model[~cut] = 0
            model_img[~cut] = 0
            viewer.update(rgb, depth_mm, out,
                          model=model, model_img=model_img, frame=i,
                          surfels=int(out.surfel_count),
                          fps=round(fps, 2),
                          conf=p["conf"], depth_cutoff=p["depth"],
                          loop_closures=len(slam.loop_closures))
        if args.viz:
            os.makedirs(args.viz, exist_ok=True)
            save_frame_panels(os.path.join(args.viz, f"frame_{i:05d}.png"),
                              rgb, depth_mm, out)


if __name__ == "__main__":
    main()
