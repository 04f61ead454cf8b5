"""On-card smoke test: the SLAM frame path on one GPU, end to end.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py

Every phase runs in this one process: a JAX process reserves most of the
card's memory when it starts, so a second one could not use the card.

(a) Device: JAX's default backend must be a GPU; the device and the card's
    name and power limit are printed. Nothing falls back to the CPU.
(b) Main path: ``apps/run_slam.py``'s ``main`` on the synthetic pinhole
    sequence at 640x480, P=768 landmark slots, 256 new keypoints per
    keyframe (the reference's half-resolution Endomapper scale), from frame
    0 through initialization, tracking, keyframes and mapping, gated like
    ``tests/test_e2e.py``. A profiler trace of steady frames of the same
    configuration gives each solver driver's device time and kernel count
    per frame.
(c) Endomapper-like path: KB8 fisheye with a Masker (BorderFilter and
    BrightFilter) at the same size, through the fixture of
    ``tests/test_e2e_fisheye.py``, with the same gates.
(d) Parity: each solver driver, one KLT ``track`` call and one fused
    ``frame_step`` run at real widths on the GPU and on the CPU float32
    path of this process, and agree within the tolerances stated below.

Any failed phase raises, so the script exits non-zero. The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import shutil
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
# The e2e fixtures and problem generators of the test suite, imported as the
# tests import each other (a top-level ``tests`` package may be installed).
sys.path.insert(1, str(ROOT / "tests"))

from nrslam.utils import compile_cache, device as device_mod  # noqa: E402

# Full-size configuration: 640x480, P=768, 256 new keypoints per keyframe.
HEIGHT, WIDTH, MAX_POINTS, NEW_KP = 480, 640, 768, 256

# End-to-end gates of the deforming CPU runs (tests/test_e2e.py:95,109 and
# tests/test_e2e_fisheye.py:60), at least this many evaluated frames.
GATE_MEDIAN_RMSE = 0.20
GATE_ATE = 0.07
GATE_MIN_TRACKED = 10

# Solver drivers, by the named scope each runs under.
DRIVER_SCOPES = ("pose_only_lm", "pose_deformation_lm",
                 "deformable_triangulation", "keyframe_ba")


def log(*args):
    print(*args, flush=True)


def check_device() -> dict:
    """Phase (a): the default device must be a GPU."""
    device = device_mod.require_gpu()
    log("jax.devices():", jax.devices())
    log("device_kind:", device["kind"])
    log("nvidia-smi name, power.limit:", device_mod.nvidia_smi_name_power())
    return device


def _check_gates(name, status, n_tracked, median_rmse, ate):
    log(f"{name}: status={status} frames_tracked={n_tracked} "
        f"median_depth_rmse={median_rmse} ate={ate}")
    if not (status == "TRACKING" and n_tracked >= GATE_MIN_TRACKED
            and median_rmse is not None and median_rmse < GATE_MEDIAN_RMSE
            and ate is not None and ate < GATE_ATE):
        raise AssertionError(
            f"{name} failed its gates: TRACKING, >= {GATE_MIN_TRACKED} "
            f"tracked frames, median depth RMSE < {GATE_MEDIAN_RMSE}, "
            f"ATE < {GATE_ATE}")


def main_path(height=HEIGHT, width=WIDTH, max_points=MAX_POINTS,
              new_kp=NEW_KP, n_frames=120):
    """Phase (b): the CLI's main path, gated like the CPU e2e tests."""
    from apps import run_slam

    summary = run_slam.main([
        "--dataset", "synthetic", "--height", str(height), "--width",
        str(width), "--max_points", str(max_points), "--max_new_keypoints",
        str(new_kp), "--end_frame", str(n_frames), "--deform_amp", "0.02",
        "--lost_check_every", "1"])
    _check_gates("main path", summary["status"], summary["frames_tracked"],
                 summary["median_rmse"], summary["ate"])
    peak = jax.devices()[0].memory_stats()
    log(f"main path steady-state frame time (host clock, each frame waited "
        f"for): median {summary['steady_median_frame_ms']} ms, "
        f"p99 {summary['steady_p99_frame_ms']} ms; peak_bytes_in_use "
        f"{peak.get('peak_bytes_in_use') if peak else 'not reported'}; "
        f"card: {_card()}")
    return summary


def _card():
    if jax.default_backend() == "gpu":
        return device_mod.nvidia_smi_name_power()
    return f"not a GPU ({jax.default_backend()})"


def driver_trace(height=HEIGHT, width=WIDTH, max_points=MAX_POINTS,
                 new_kp=NEW_KP, n_warm=30, n_traced=10):
    """Device time and kernel launches per frame of each solver driver.

    Drives ``System`` as the CLI does at phase (b)'s configuration, so the
    frame programs are the ones phase (b) compiled, and traces
    ``n_traced`` steady-state frames. XLA launches most kernels from CUDA
    graphs (command buffers), whose trace events name the kernel but not its
    JAX scope, so each kernel is attributed through the optimized HLO of the
    two frame-program specializations: kernel name -> fusion instruction ->
    ``op_name`` metadata, which carries the ``jax.named_scope`` path."""
    from nrslam.datasets import synthetic
    from nrslam.slam import system as system_mod
    from nrslam.slam.state import Config

    scene = synthetic.SceneConfig(height=height, width=width, deform_amp=0.02)
    seq = synthetic.SyntheticSequence(scene, n_frames=n_warm + n_traced)
    config = Config(rad_per_pixel=1.0 / scene.fx, max_points=max_points,
                    max_new_keypoints=new_kp)
    slam = system_mod.System(synthetic.camera(scene), config,
                             lost_check_every=1, init_check_every=4)
    for i in range(n_warm):
        slam.track_image(seq.get_image(i))
    if slam.status != system_mod.TRACKING:
        raise AssertionError(f"not tracking after {n_warm} frames")
    gray = slam._preprocess(seq.get_image(n_warm))
    maps = {kf: kernel_scopes(system_mod._fused_frame_impl.lower(
        slam.state, gray, slam._mask(gray), slam.cam.params, slam.cam.kind,
        config, kf).compile().as_text()) for kf in (False, True)}

    trace_dir = ROOT / ".jax_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    n_kf = 0
    with jax.profiler.trace(str(trace_dir)):
        for i in range(n_warm, n_warm + n_traced):
            n_kf += bool(slam.track_image(seq.get_image(i))["keyframe"])
        jax.block_until_ready(slam.state.positions)
    per_scope, window = reduce_trace(trace_dir, maps)
    shutil.rmtree(trace_dir, ignore_errors=True)

    n = n_traced
    log(f"trace: {n} frames ({n_kf} keyframes), card: {_card()}")
    log(f"trace: device busy {window['busy_ns'] / n / 1e6:.3f} ms per frame, "
        f"idle share {1 - window['busy_ns'] / window['span_ns']:.3f} of the "
        f"{window['span_ns'] / n / 1e6:.3f} ms per frame window; "
        f"{window['kernels'] / n:.1f} kernels and {window['copies'] / n:.1f} "
        "copies/memsets per frame")
    for scope, (ns, count) in sorted(per_scope.items()):
        log(f"trace {scope}: {ns / n / 1e6:.4f} ms device time and "
            f"{count / n:.1f} kernels per frame")
    for (scope, key), (ns, count) in window["top"]:
        log(f"trace top kernel {scope}/{key}: {ns / n / 1e6:.4f} ms and "
            f"{count / n:.1f} launches per frame")
    return per_scope


def kernel_scopes(hlo_text) -> dict:
    """{kernel name: driver scope or "other"} for one optimized HLO module.

    A kernel is named after its fusion instruction ('.' and '-' become
    '_'); the instruction's ``op_name`` metadata, or failing that the first
    scoped instruction of the computation it calls, names the driver."""
    comp_scope, instrs, comp = {}, [], None
    for line in hlo_text.splitlines():
        m = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+) = (.*)$", line)
        if m is None:
            header = re.match(r"\s*(?:ENTRY\s+)?%?([\w.\-]+) .*\{\s*$", line)
            if header:
                comp = header.group(1)
            continue
        name, rest = m.groups()
        op = re.search(r'op_name="([^"]*)"', rest)
        scope = next((s for s in DRIVER_SCOPES if op and s in op.group(1)),
                     None)
        if scope and comp:
            comp_scope.setdefault(comp, scope)
        calls = re.search(r"calls=%?([\w.\-]+)", rest)
        instrs.append((name, scope, calls.group(1) if calls else None))
    return {re.sub(r"[.\-]", "_", name): scope or comp_scope.get(callee)
            or "other" for name, scope, callee in instrs}


def reduce_trace(trace_dir, maps) -> tuple:
    """Per-scope [device ns, kernel count] and the window's totals (with
    the kernels that took the most device time) over the device planes of
    the newest trace under ``trace_dir``.

    ``maps`` holds :func:`kernel_scopes` of the non-keyframe (False) and
    keyframe (True) programs; each program id in the trace is matched to the
    map whose kernel names only it has. Copies and memsets count apart."""
    from jax.profiler import ProfileData

    path = max(Path(trace_dir).rglob("*.xplane.pb"),
               key=lambda p: p.stat().st_mtime)
    events = []
    for plane in ProfileData.from_file(str(path)).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = {k: str(v) for k, v in ev.stats}
                op = stats.get("hlo_op", "command_buffer")
                key = ev.name if op == "command_buffer" else op
                events.append((stats.get("program_id"),
                               re.sub(r"[.\-]", "_", key), ev.start_ns,
                               ev.end_ns, ev.name))
    only = {kf: set(maps[kf]) - set(maps[not kf]) for kf in maps}
    names_by_pid = {}
    for pid, key, *_ in events:
        names_by_pid.setdefault(pid, set()).add(key)
    is_kf = {pid: len(names & only[True]) > len(names & only[False])
             for pid, names in names_by_pid.items()}

    per_scope, per_kernel = {}, {}
    window = {"kernels": 0, "copies": 0}
    for pid, key, start, end, name in events:
        if name.startswith(("Memcpy", "Memset")):
            window["copies"] += 1
            continue
        window["kernels"] += 1
        scope = maps[is_kf[pid]].get(key, "other")
        for acc in (per_scope.setdefault(scope, [0, 0]),
                    per_kernel.setdefault((scope, key), [0, 0])):
            acc[0] += end - start
            acc[1] += 1
    window["top"] = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    busy, last_end = 0, None
    for _, _, start, end, _ in sorted(events, key=lambda e: e[2]):
        if last_end is None or start >= last_end:
            busy += end - start
            last_end = end
        elif end > last_end:
            busy += end - last_end
            last_end = end
    window["busy_ns"] = busy
    window["span_ns"] = (max(e[3] for e in events)
                         - min(e[2] for e in events))
    return per_scope, window


def endomapper_path(height=HEIGHT, width=WIDTH, max_points=MAX_POINTS,
                    new_kp=NEW_KP, n_frames=45):
    """Phase (c): KB8 fisheye + Masker through the fisheye e2e fixture."""
    from nrslam.eval import metrics
    from nrslam.ops import masking
    from test_e2e_fisheye import run_fisheye

    masker = masking.Masker([("BorderFilter", 6, 8), ("BrightFilter", 220)])
    sys_, rmses, (est, gt) = run_fisheye(
        deform_amp=0.03, n_frames=n_frames, masker=masker, height=height,
        width=width, max_points=max_points, max_new_keypoints=new_kp)
    ate = (metrics.ate_rmse(est, gt, with_scale=True) if len(est) >= 3
           else None)
    _check_gates("endomapper-like path", sys_.status, len(rmses),
                 float(np.median(rmses)) if rmses else None, ate)


# --- (d) parity -------------------------------------------------------------
#
# Both sides trace under jax.default_matmul_precision("highest"), as the
# frame programs do, so neither runs f32 products in TF32. Both round the
# selector products' operands to bf16 (solver.core.selmm): the GPU runs a
# bf16 x bf16 -> f32 dot, the CPU an f32 dot of the same rounded values, so
# every product is identical and only the summation order differs. The
# tolerances bound what summation order does to an iterative solver: f32
# rounding (~6e-8 relative) enters every Gauss-Newton step, LM
# accept/reject decisions and PCG truncation amplify it, and threshold gates
# (chi2 inlier tests, KLT status) can flip for a point within rounding of
# its threshold. Each limit sits about 10x or more above the difference
# measured on an H100 80GB HBM3 (in brackets). Where the same checks were
# run GPU-TF32 against GPU-highest (in braces), only the KLT limit separates
# TF32 from summation order: for the solvers the two are the same size, so
# their limits guard against larger errors (a wrong kernel, a lost term).
TOL_POSE_ONLY = 1e-6           # pose, scene units  [8.5e-8]  {8.4e-8}
TOL_JOINT_POSE = 1e-4          # [7.7e-6]  {5.9e-6}
TOL_JOINT_FLOW_MEDIAN = 1e-4   # [5.9e-6]  {5.0e-6}
TOL_FLAG_FLIPS = 0.01          # share of points whose boolean gate flips [0]
TOL_TRIANG_MEDIAN = 2e-5       # landmark position  [1.7e-6]  {0}
TOL_BA = 1e-3                  # max landmark/translation  [1.4e-4]  {9.9e-5}
TOL_KLT_MEDIAN_PX = 1e-5       # tracked point, pixels  [0]  {1.2e-4}
TOL_FRAME_POSE = 1e-5          # fused frame step, translation  [2.3e-7]
TOL_FRAME_POS_MEDIAN = 1e-5    # fused frame step, landmarks  [7.3e-7]


def _run_on(dev, fn, *args):
    """jit ``fn`` for ``dev`` and run it there under full f32 precision;
    returns host arrays. Every array ``fn`` uses comes in through ``args``
    (cameras included), so each side holds its own copies."""
    args = jax.device_put(args, dev)
    with jax.default_device(dev), jax.default_matmul_precision("highest"):
        out = jax.jit(fn)(*args)
        return jax.device_get(out)


def _both(fn, *args):
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    return _run_on(gpu, fn, *args), _run_on(cpu, fn, *args)


def _quat_dist(q1, q2):
    return float(min(np.abs(q1 - q2).max(), np.abs(q1 + q2).max()))


def parity(height=HEIGHT, width=WIDTH, max_points=MAX_POINTS, new_kp=NEW_KP,
           n_kf=5, n_cand=128, n_tframes=20):
    """Phase (d): GPU vs the CPU float32 path at real widths."""
    import bench
    from nrslam.datasets import synthetic
    from nrslam.geometry import se3
    from nrslam.ops import klt, shi_tomasi
    from nrslam.slam import system as system_mod
    from nrslam.solver import bundle_adjustment as ba
    from nrslam.solver import deformable_triangulation as dt
    from nrslam.solver import pose_deformation as pd
    from nrslam.solver import pose_only
    from test_bundle_adjustment import CAM as BA_CAM
    from test_bundle_adjustment import make_window
    from test_deformable_triangulation import CAM as DT_CAM
    from test_deformable_triangulation import make_inputs
    from test_pose_deformation import CAM as PD_CAM
    from test_pose_deformation import knn_table, make_scene

    failed = []

    def expect(name, value, limit):
        log(f"parity {name}: {value:.3e} (limit {limit:.0e})")
        if not value <= limit:
            failed.append(f"{name}: {value} > {limit}")

    log(f"parity selector products: GPU {jax.devices()[0].device_kind} "
        "bf16 x bf16 -> f32 dot; CPU f32 dot of bf16-rounded operands")
    P = max_points

    # Pose-only LM at P landmarks, 8 gross outliers.
    X, _, _, obs = make_scene(n=P, seed=0, deform_amp=0.02)
    obs = obs.at[:8].add(40.0)
    valid = jnp.ones(P, bool)
    g, c = _both(lambda cam, X, obs, valid: pose_only.camera_pose_optimization(
        cam, se3.identity(), X, obs, valid), PD_CAM, X, obs, valid)
    expect("pose-only LM translation", float(np.abs(g.t - c.t).max()),
            TOL_POSE_ONLY)
    expect("pose-only LM rotation", _quat_dist(g.q, c.q), TOL_POSE_ONLY)

    # Joint pose + deformation LM: K=10 neighbours, compacted to E = 6P.
    T_seed = se3.SE3(jnp.asarray(c.q), jnp.asarray(c.t))
    pairs = pd.pairs_from_neighbors(*knn_table(X, k=10))
    log(f"parity joint LM: P={P}, E={pd.compact_pairs(pairs, P).i.shape[0]}")
    g, c = _both(
        lambda cam, T, X, obs, valid, pairs: pd.pose_deformation_optimization(
            cam, T, X, obs, valid, pairs, scale=1.0),
        PD_CAM, T_seed, X, obs, valid, pairs)
    expect("joint LM translation", float(np.abs(g.Tcw.t - c.Tcw.t).max()),
            TOL_JOINT_POSE)
    expect("joint LM rotation", _quat_dist(g.Tcw.q, c.Tcw.q),
            TOL_JOINT_POSE)
    expect("joint LM median flow",
            float(np.median(np.linalg.norm(g.flows - c.flows, axis=-1))),
            TOL_JOINT_FLOW_MEDIAN)
    expect("joint LM inlier flips",
            float(np.mean(g.reproj_inlier != c.reproj_inlier)),
            TOL_FLAG_FLIPS)

    # Deformable triangulation: C candidates over a T-frame buffer.
    inputs, Tcw, _ = make_inputs(n_cand=n_cand, n_frames=n_tframes, nb=11,
                                 deform_amp=0.02)
    (Xg, okg), (Xc, okc) = _both(
        lambda cam, inputs, Tcw: dt.deformable_triangulate(
            cam, inputs, Tcw, 0.002), DT_CAM, inputs, Tcw)
    both_ok = okg & okc
    expect("triangulation median position",
            float(np.median(np.linalg.norm(Xg - Xc, axis=-1)[both_ok]))
            if both_ok.any() else float("inf"), TOL_TRIANG_MEDIAN)
    expect("triangulation acceptance flips", float(np.mean(okg != okc)),
            TOL_FLAG_FLIPS)

    # Keyframe BA: K keyframes, P landmarks, E = 6P compacted pair edges,
    # a quarter of the observations masked.
    poses_true, L_true, _, problem = make_window(K=n_kf, P=P)
    nbr = knn_table(L_true[0], k=10)
    pairs = pd.compact_pairs(pd.pairs_from_neighbors(*nbr), P)
    obs_valid = jax.random.uniform(jax.random.PRNGKey(7), (n_kf, P)) > 0.25
    problem = problem._replace(pairs=pairs, obs_valid=obs_valid)
    log(f"parity BA: K={n_kf}, P={P}, E={pairs.i.shape[0]}")
    key = jax.random.PRNGKey(42)
    poses0 = se3.SE3(poses_true.q, poses_true.t + 0.01 * jax.random.normal(
        key, poses_true.t.shape))
    L0 = L_true + 0.03 * jax.random.normal(jax.random.fold_in(key, 1),
                                           L_true.shape)
    (pg, Lg), (pc, Lc) = _both(
        lambda cam, poses0, L0, problem: ba.local_deformable_ba(
            cam, poses0, L0, problem, cg_iters=16),
        BA_CAM, poses0, L0, problem)
    expect("BA landmarks (max)", float(np.abs(Lg - Lc).max()), TOL_BA)
    expect("BA translations (max)", float(np.abs(pg.t - pc.t).max()), TOL_BA)

    # One KLT track call: P corners of frame 0 tracked into frame 1.
    scene = synthetic.SceneConfig(height=height, width=width, deform_amp=0.02)
    gray0, _, _ = synthetic.render_frame(0, scene)
    gray1, _, _ = synthetic.render_frame(1, scene)
    kcfg = klt.KLTConfig()

    def track(gray0, gray1):
        pyr0 = klt.build_pyramid(gray0, kcfg)
        pyr1 = klt.build_pyramid(gray1, kcfg)
        pts, ok, _ = shi_tomasi.detect(gray0, P)
        refs = klt.set_reference(pyr0, pts, ok, kcfg)
        status = jnp.where(ok, klt.TRACKED, klt.BAD)
        return klt.track(pyr1, refs, pts, status, kcfg, min_ssim=0.7)

    (ptg, stg), (ptc, stc) = _both(track, gray0, gray1)
    tracked = (stg == klt.TRACKED) & (stc == klt.TRACKED)
    log(f"parity KLT: {int(tracked.sum())} of {P} points tracked on both")
    expect("KLT status flips", float(np.mean(stg != stc)), TOL_FLAG_FLIPS)
    expect("KLT median point (px)",
            float(np.median(np.linalg.norm(ptg - ptc, axis=-1)[tracked])),
            TOL_KLT_MEDIAN_PX)

    # One fused frame_step from the bench's hand-built steady state.
    state, _, mask, cam, config, raw = bench.build_bench_problem(
        max_points=P, height=height, width=width, max_new_kp=new_kp)
    (sg, rg), (sc, rc) = _both(
        lambda cam, state, gray, mask: system_mod.frame_step(
            state, gray, mask, cam, config, False), cam, state, raw[0], mask)
    expect("frame_step translation", float(np.abs(sg.Tcw.t - sc.Tcw.t).max()),
            TOL_FRAME_POSE)
    expect("frame_step status flips", float(np.mean(sg.status != sc.status)),
            TOL_FLAG_FLIPS)
    with3d = sg.has_3d & sc.has_3d
    expect("frame_step median position",
            float(np.median(np.linalg.norm(
                sg.positions - sc.positions, axis=-1)[with3d])),
            TOL_FRAME_POS_MEDIAN)
    log(f"parity frame_step: n_tracked_3d GPU {int(rg.n_tracked_3d)} "
        f"CPU {int(rc.n_tracked_3d)}")
    if failed:
        raise AssertionError("parity failed: " + "; ".join(failed))


def main():
    compile_cache.enable()
    t0 = time.perf_counter()
    device = check_device()
    for phase in (main_path, driver_trace, endomapper_path, parity):
        t = time.perf_counter()
        phase()
        log(f"phase {phase.__name__} done in {time.perf_counter() - t:.1f} s")
    log(f"all phases done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
