"""Unified CLI: run NR-SLAM on a dataset.

Replaces the reference's three binaries (apps/endomapper.cc, apps/hamlyn.cc,
apps/simulation.cc) with one entry point; the ``--dataset`` flag selects the
loader. Flags mirror the reference's absl flags (--dataset_path,
--settings_path, --starting_frame, --end_frame, apps/endomapper.cc:31-34).

Examples:
  python apps/run_slam.py --dataset synthetic --end_frame 100
  python apps/run_slam.py --dataset synthetic --height 480 --width 640 \
      --max_points 768 --max_new_keypoints 256 --end_frame 120
  python apps/run_slam.py --dataset simulation --dataset_path /data/sim \
      --settings_path data/simulation/settings.yaml
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None) -> dict:
    """Run the sequence, print the summary JSON line and return it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=["synthetic", "simulation", "hamlyn",
                                          "endomapper"], default="synthetic")
    ap.add_argument("--dataset_path", default="")
    ap.add_argument("--settings_path", default="")
    ap.add_argument("--starting_frame", type=int, default=0)
    ap.add_argument("--end_frame", type=int, default=100)
    ap.add_argument("--half_resolution", action="store_true",
                    help="process at half resolution (the reference does this "
                         "for endomapper/simulation, apps/endomapper.cc:66-67)")
    ap.add_argument("--deform_amp", type=float, default=0.02,
                    help="synthetic scene deformation amplitude")
    ap.add_argument("--height", type=int, default=240,
                    help="synthetic frame height in pixels")
    ap.add_argument("--width", type=int, default=320,
                    help="synthetic frame width in pixels")
    ap.add_argument("--save_ply", default="")
    ap.add_argument("--save_viz", default="",
                    help="directory for overlay dumps every 10 frames "
                         "(feature/graph/flow-trail PNGs + final 3D trails "
                         "PLY; the ImageVisualizer/MapVisualizer save_path "
                         "behavior, image_visualizer.cc:45-50)")
    ap.add_argument("--save_rmse", default="")
    ap.add_argument("--checkpoint_dir", default="")
    ap.add_argument("--max_points", type=int, default=0,
                    help="override landmark slot capacity (0 = Config default)")
    ap.add_argument("--max_new_keypoints", type=int, default=0,
                    help="override the per-keyframe new-keypoint budget "
                         "(0 = Config default)")
    ap.add_argument("--auto_reinit", action="store_true",
                    help="re-initialize a fresh map after tracking collapse "
                         "instead of stopping (the reference exit(0)s, "
                         "tracking.cc:97-99; recovery policy per SURVEY.md "
                         "§5)")
    ap.add_argument("--init_check_every", type=int, default=4,
                    help="batch-materialize the initializer success flags "
                         "every N frames (1 = reference-exact handoff; "
                         "N > 1 trades up to N-1 frames at the "
                         "init->tracking handoff for zero per-frame "
                         "device->host syncs during initialization)")
    ap.add_argument("--lost_check_every", type=int, default=5,
                    help="surface the LOST check to host every N frames. "
                         "Semantics are reference-exact at any N: the "
                         "collapse latches ON DEVICE at the frame it "
                         "happens (tracking.cc:97-99) and later frames "
                         "freeze to no-ops; N only delays when the host "
                         "*reports* it (each check is a device->host sync)")
    args = ap.parse_args(argv)

    import jax

    from nrslam.utils import compile_cache
    compile_cache.enable()

    from nrslam.eval import metrics
    from nrslam.slam import system as system_mod
    from nrslam.slam.state import Config
    from nrslam.utils.profiler import TimeProfiler

    profiler = TimeProfiler()
    gt_poses = {}  # frame index -> ground-truth Tcw (synthetic only)
    overrides = {k: v for k, v in (
        ("max_points", args.max_points),
        ("max_new_keypoints", args.max_new_keypoints)) if v}

    if args.dataset == "synthetic":
        from nrslam.datasets import synthetic
        scene = synthetic.SceneConfig(height=args.height, width=args.width,
                                      deform_amp=args.deform_amp)
        seq = synthetic.SyntheticSequence(scene, n_frames=args.end_frame)
        cam = synthetic.camera(scene)
        config = Config(rad_per_pixel=1.0 / scene.fx)._replace(**overrides)
        slam = system_mod.System(
            cam, config, lost_check_every=args.lost_check_every,
            init_check_every=args.init_check_every,
            auto_reinitialize=args.auto_reinit)

        def frames():
            for i in range(args.starting_frame, args.end_frame):
                gray, depth, Tcw_gt = seq.get_frame(i)
                gt_poses[i] = Tcw_gt
                yield i, gray, depth, None
    else:
        from nrslam.config import Settings
        settings = Settings(args.settings_path)
        cam = settings.calibration
        config = settings.slam_config(**overrides)
        slam = system_mod.System(cam, config, masker=settings.masker,
                                  lost_check_every=args.lost_check_every,
                                  init_check_every=args.init_check_every,
                                  auto_reinitialize=args.auto_reinit)

        if args.dataset == "simulation":
            from nrslam.datasets.loaders import Simulation
            ds = Simulation(args.dataset_path)

            def frames():
                for i in range(args.starting_frame, min(args.end_frame, len(ds))):
                    img = ds.get_image(i)
                    depth = ds.get_depth_image(i)
                    if args.half_resolution:
                        img = img[::2, ::2]
                        depth = depth[::2, ::2]
                    yield i, img, depth, None
        elif args.dataset == "hamlyn":
            from nrslam.datasets.loaders import Hamlyn
            ds = Hamlyn(args.dataset_path)

            # Stereo evaluation path (system.cc:134-160): track the left
            # stream; right frames + Stereo.bf feed the stereo-GT depth
            # evaluator when present in the cache.
            def frames():
                for i in range(args.starting_frame, min(args.end_frame, len(ds))):
                    right = ds.get_right_image(i)
                    if args.half_resolution:
                        yield (i, ds.get_image(i)[::2, ::2], None,
                               None if right is None else right[::2, ::2])
                    else:
                        yield i, ds.get_image(i), None, right
        else:
            from nrslam.datasets.loaders import Endomapper
            ds = Endomapper(args.dataset_path)

            def frames():
                for i in range(args.starting_frame, min(args.end_frame, len(ds))):
                    img = ds.get_image(i)
                    if args.half_resolution:
                        img = img[::2, ::2]
                    yield i, img, None, None

    import time

    stereo_bf = 0.0 if args.dataset == "synthetic" else settings.bf
    stereo_rmses = []
    est_poses, est_gt_poses = [], []
    n_tracked = 0
    n_frames = 0
    steady_t0 = None
    steady_n = 0
    t_loop0 = time.perf_counter()
    for i, img, depth, right in frames():
        with profiler.section("frame"):
            if depth is not None:
                out = slam.track_image_with_depth(img, depth)
            elif right is not None and stereo_bf > 0:
                out = slam.track_image_with_stereo(img, right, bf=stereo_bf)
                if "stereo_rmse" in out:
                    stereo_rmses.append(out["stereo_rmse"])
            else:
                out = slam.track_image(img)
        n_frames += 1
        if out["status"] == system_mod.TRACKING:
            n_tracked += 1
            if i in gt_poses:
                est_poses.append(slam.state.Tcw)
                est_gt_poses.append(gt_poses[i])
        # Steady-state window: opens after the first tracked frames so
        # one-off compile costs don't pollute the throughput number.
        if steady_t0 is None and n_tracked >= 12:
            if slam.state is not None:
                jax.block_until_ready(slam.state.positions)
            steady_t0 = time.perf_counter()
            steady_first = len(profiler.samples("frame"))
        elif steady_t0 is not None:
            steady_n += 1
        if i % 10 == 0:
            # Print only host-known fields: materializing n_tracked_3d here
            # would re-introduce the per-frame device sync.
            print(f"frame {i}: status={out['status']} "
                  f"kf={out.get('keyframe')}", file=sys.stderr)
            if args.save_viz and slam.state is not None:
                from nrslam.viz import dumps as viz_dumps
                vd = Path(args.save_viz)
                vd.mkdir(parents=True, exist_ok=True)
                gray = np.asarray(slam._preprocess(img))
                st = slam.state
                viz_dumps.save_png(
                    vd / f"features_{i:05d}.png",
                    viz_dumps.draw_frame(gray, st.keypoints, st.status,
                                         st.slot_used))
                viz_dumps.save_png(
                    vd / f"graph_{i:05d}.png",
                    viz_dumps.draw_graph(gray, st.keypoints, st.status,
                                         st.slot_used, st.graph))
                viz_dumps.save_png(
                    vd / f"flow_{i:05d}.png",
                    viz_dumps.draw_optical_flow(gray, st))
        if out["status"] == system_mod.LOST:
            print("tracking lost", file=sys.stderr)
            break

    # Drain queued device work so wall-clock fps is honest (track_image
    # dispatches asynchronously; only every --lost_check_every frames does
    # the loop block on the device).
    if slam.state is not None:
        jax.block_until_ready(slam.state.positions)
    loop_s = time.perf_counter() - t_loop0

    stats = profiler.statistics().get("frame", {})
    # Per-frame host time of track_image over the steady window. A frame's
    # device work is waited for only on frames that check LOST, so these are
    # frame latencies with --lost_check_every 1.
    steady_ms = (np.asarray(profiler.samples("frame")[steady_first:]) * 1e3
                 if steady_t0 is not None else np.zeros(0))
    summary = {
        "frames_tracked": n_tracked,
        "status": slam.status,
        "mean_frame_ms": stats.get("mean_ms"),
        "fps": round(n_frames / loop_s, 2) if n_frames else None,
        "steady_fps": (round(steady_n / (time.perf_counter() - steady_t0), 2)
                       if steady_t0 is not None and steady_n else None),
        "steady_median_frame_ms": (float(np.median(steady_ms))
                                   if steady_ms.size else None),
        "steady_p99_frame_ms": (float(np.percentile(steady_ms, 99))
                                if steady_ms.size else None),
        "median_rmse": (float(np.median(slam.evaluator.rmse_history))
                        if slam.evaluator.rmse_history else None),
        "ate": (metrics.ate_rmse(est_poses, est_gt_poses, with_scale=True)
                if len(est_poses) >= 3 else None),
        "median_stereo_rmse": (float(np.median(stereo_rmses))
                               if stereo_rmses else None),
    }
    print(json.dumps(summary))

    if args.save_ply and slam.state is not None:
        from nrslam.viz.dumps import export_ply
        export_ply(args.save_ply, slam.state)
    if args.save_viz and slam.state is not None:
        from nrslam.viz.dumps import export_flow_trails_ply
        export_flow_trails_ply(
            str(Path(args.save_viz) / "flow_trails.ply"), slam.state)
    if args.save_rmse:
        if slam.evaluator.rmse_history or not stereo_rmses:
            slam.evaluator.save(args.save_rmse)
        else:
            # Stereo runs: the per-frame stereo-GT RMSE file
            # (frame_evaluator.cc's results convention).
            with open(args.save_rmse, "w") as f:
                for r in stereo_rmses:
                    f.write(f"{r}\n")
    if args.checkpoint_dir and slam.state is not None:
        from nrslam.utils import checkpoint
        checkpoint.save(args.checkpoint_dir, slam.state)
    return summary


if __name__ == "__main__":
    main()
