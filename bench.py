"""Benchmark: steady-state SLAM frames/sec/chip on the synthetic sequence.

Runs on a GPU only: it fails when JAX finds none. An earlier line names the
device (platform, kind, count) and the card's name and power limit; the last
line is ONE JSON object: {"metric", "value", "unit", "vs_baseline", ...}.

The HEADLINE number is measured at the REFERENCE-SCALE operating point —
640x480 frames (the reference's half-res Endomapper scale,
/root/reference/apps/endomapper.cc:66-67), P=768 landmark slots, 256 new
keypoints per keyframe — so the recorded artifact certifies the >= 30 fps
claim at the scale the reference actually runs, not at a smaller problem.
A secondary series at the small point (320x240, P=384) is included under
"secondary". Both points run in this one process, one after the other, so
only one process ever holds the card.

The north-star metric (BASELINE.md) is end-to-end deformable-SLAM
throughput; the baseline target is 30 fps (the reference C++ system is
qualitatively "real time on an i7", README.md:43, and BASELINE.json sets
>= 30 fps as the bar). vs_baseline = fps / 30.

The measured loop is the steady-state per-frame work: KLT data association
over the full point set, pose-only LM, joint pose+deformation LM-PCG, point
reuse, temporal snapshot, and the mapping step (triangulation or keyframe BA
at the reference's 1-in-5 cadence) — i.e. everything System.track_image does
after initialization, on prerendered device-resident frames.
"""

from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp


def build_bench_problem(max_points=None, height=None, width=None,
                        max_new_kp=None):
    """Problem sizes override via env: BENCH_POINTS / BENCH_H / BENCH_W.
    Defaults = the reference-scale operating point."""
    max_points = max_points or int(os.environ.get("BENCH_POINTS", 768))
    height = height or int(os.environ.get("BENCH_H", 480))
    width = width or int(os.environ.get("BENCH_W", 640))
    max_new_kp = max_new_kp or int(os.environ.get("BENCH_NEW_KP", 256))
    from nrslam.datasets import synthetic
    from nrslam.geometry import cameras as cam_mod
    from nrslam.ops import klt
    from nrslam.slam import graph as graph_mod
    from nrslam.slam import state as state_mod
    from nrslam.slam.state import Config

    scene = synthetic.SceneConfig(height=height, width=width,
                                  deform_amp=0.02)
    cam = synthetic.camera(scene)
    config = Config(max_points=max_points, max_new_keypoints=max_new_kp,
                    rad_per_pixel=1.0 / scene.fx)

    gray0, _, _ = synthetic.render_frame(0, scene)
    pyr0 = klt.build_pyramid(gray0, config.klt_config)

    state = state_mod.empty_state(config, gray0.shape)
    key = jax.random.PRNGKey(0)
    uv = jnp.stack([
        25 + (width - 50) * jax.random.uniform(key, (max_points,)),
        25 + (height - 50) * jax.random.uniform(jax.random.fold_in(key, 1),
                                                (max_points,)),
    ], -1)
    rays = cam_mod.unproject(cam, uv)
    positions = rays * 3.0
    valid = jnp.ones(max_points, bool)
    refs = klt.set_reference(pyr0, uv, valid, config.klt_config)
    state = state._replace(
        slot_used=valid,
        track_id=jnp.arange(max_points, dtype=jnp.int32),
        has_3d=valid,
        positions=positions,
        keypoints=uv,
        status=jnp.zeros(max_points, jnp.int32),
        refs=refs,
        graph=graph_mod.initialize(state.graph, positions, valid, 3.0),
    )
    state = state_mod.insert_temporal_snapshot(state)
    state = state_mod.insert_keyframe(state)

    frames = []
    for i in range(1, 7):
        g, _, _ = synthetic.render_frame(i, scene)
        frames.append(klt.build_pyramid(g, config.klt_config))
    mask = jnp.ones(gray0.shape, bool)
    raw_frames = [p[0][0] for p in frames]
    return state, frames, mask, cam, config, raw_frames


def measure(**sizes):
    from nrslam.slam import system as system_mod

    state, _, mask, cam, config, raw_frames = build_bench_problem(**sizes)

    def frame_step(state, raw, make_kf):
        # The measured step starts from the raw grayscale frame: pyramid +
        # gradients + tracking + mapping (everything System.track_image does
        # after initialization), fused into one jitted program (two
        # specializations: keyframe / not).
        return system_mod.frame_step(state, raw, mask, cam, config, make_kf)

    # Warm-up / compile both specializations.
    s = state
    s, _ = frame_step(s, raw_frames[0], False)
    s, _ = frame_step(s, raw_frames[1], True)
    # Second warm-up pass with post-step state dtypes (stable signature).
    s, _ = frame_step(s, raw_frames[2], False)
    s, _ = frame_step(s, raw_frames[3], True)
    jax.block_until_ready(s.positions)

    # Timed steady-state loop at the reference's 1-in-5 keyframe cadence.
    n_frames = 50
    t0 = time.perf_counter()
    for i in range(n_frames):
        make_kf = (i % 5) == 4
        s, _ = frame_step(s, raw_frames[i % len(raw_frames)], make_kf)
    jax.block_until_ready(s.positions)
    return n_frames / (time.perf_counter() - t0)


def main():
    from nrslam.utils import compile_cache, device

    compile_cache.enable()
    print(json.dumps({"device": device.require_gpu(),
                      "nvidia_smi": device.nvidia_smi_name_power()}))

    # Headline: reference-scale point (env knobs override it).
    P = int(os.environ.get("BENCH_POINTS", 768))
    H = int(os.environ.get("BENCH_H", 480))
    W = int(os.environ.get("BENCH_W", 640))
    NK = int(os.environ.get("BENCH_NEW_KP", 256))
    fps = measure(max_points=P, height=H, width=W, max_new_kp=NK)
    record = {
        "metric": "slam_frames_per_sec_per_chip",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / 30.0, 3),
        "operating_point": {"max_points": P, "hw": [H, W], "new_kp": NK},
    }
    # Secondary series: the small point (only when the headline point was not
    # overridden via env), measured in this process after the headline.
    if not any(k in os.environ for k in
               ("BENCH_POINTS", "BENCH_H", "BENCH_W", "BENCH_NEW_KP")):
        small = {"max_points": 384, "height": 240, "width": 320,
                 "max_new_kp": 128}
        small_fps = measure(**small)
        record["secondary"] = {
            "small_point_fps": round(small_fps, 3),
            "operating_point": {"max_points": 384, "hw": [240, 320],
                                "new_kp": 128},
        }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
