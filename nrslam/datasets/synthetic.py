"""Procedural deformable scene generator with exact ground truth.

The reference repo ships no image data (its datasets/ loaders expect external
Hamlyn/Endomapper downloads), so integration tests and benchmarks here run on
a synthetic deformable sequence in the spirit of the reference's simulated
colonoscopy (apps/simulation.cc): a textured, smoothly deforming height-field
surface viewed by a moving pinhole camera, rendered by per-pixel ray /
surface intersection. Every frame comes with exact GT depth and camera pose,
which is precisely what System.track_image_with_depth consumes
(system.cc:162-187).

Rendering is jitted: for each pixel, the camera ray ``p(s) = c + s*d`` is
intersected with the surface ``z_w = f(x_w, y_w, t)`` by a fixed-point
iteration on s (converges fast for gentle slopes), then shaded by a smooth
procedural texture. This keeps the whole data pipeline on device.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from nrslam.geometry import cameras, se3


class SceneConfig(NamedTuple):
    height: int = 240
    width: int = 320
    fx: float = 250.0
    fy: float = 250.0
    base_depth: float = 3.0      # mean surface distance
    relief: float = 0.25         # static height-field amplitude
    deform_amp: float = 0.0      # non-rigid deformation amplitude
    deform_freq: float = 0.35    # temporal frequency (rad/frame)
    texture_scale: float = 3.0
    motion_translation: float = 0.012  # per-frame camera translation
    motion_rotation: float = 0.003     # per-frame camera rotation (rad)
    camera_kind: str = cameras.PINHOLE  # or cameras.KB8 (fisheye)
    # Kannala-Brandt distortion (endomapper-style fisheye) when kind is KB8.
    kb_coeffs: tuple = (-0.01, 0.02, -0.01, 0.002)


def camera(config: SceneConfig) -> cameras.Camera:
    cx = (config.width - 1) / 2.0
    cy = (config.height - 1) / 2.0
    if config.camera_kind == cameras.KB8:
        k0, k1, k2, k3 = config.kb_coeffs
        return cameras.kannala_brandt8(config.fx, config.fy, cx, cy,
                                       k0, k1, k2, k3)
    return cameras.pinhole(config.fx, config.fy, cx, cy)


def surface_height(x, y, t, config: SceneConfig):
    """World-frame surface depth z = f(x, y, t) with smooth deformation."""
    static = (config.base_depth
              + config.relief * (jnp.sin(1.3 * x) * jnp.cos(1.1 * y)
                                 + 0.5 * jnp.sin(2.9 * x + 1.7 * y)))
    phase = config.deform_freq * t
    deform = config.deform_amp * (
        jnp.sin(1.9 * x + phase) * jnp.cos(1.4 * y + 0.7 * phase)
        + 0.6 * jnp.sin(0.9 * y + 1.3 * phase))
    return static + deform


def texture(x, y, config: SceneConfig):
    """Smooth high-contrast procedural texture in [0, 255]."""
    s = config.texture_scale
    v = (jnp.sin(s * 3.1 * x) * jnp.cos(s * 2.7 * y)
         + 0.7 * jnp.sin(s * 7.3 * x + s * 5.1 * y)
         + 0.5 * jnp.cos(s * 11.7 * x - s * 8.3 * y)
         + 0.35 * jnp.sin(s * 17.9 * x + s * 13.1 * y)
         + 0.25 * jnp.cos(s * 29.0 * x + s * 23.0 * y))
    return 128.0 + 45.0 * v


def camera_pose(frame_idx, config: SceneConfig) -> se3.SE3:
    """Smooth sweeping trajectory (Tcw)."""
    t = jnp.asarray(frame_idx, jnp.float32)
    tw = jnp.stack([
        config.motion_rotation * jnp.sin(0.1 * t) * t,
        config.motion_rotation * 0.6 * t,
        config.motion_rotation * 0.3 * jnp.sin(0.05 * t) * t,
        config.motion_translation * t,
        config.motion_translation * 0.4 * jnp.sin(0.2 * t) * t,
        config.motion_translation * 0.25 * t,
    ])
    return se3.exp(tw)


@partial(jax.jit, static_argnames=("config",))
def render_frame(frame_idx, config: SceneConfig):
    """Render (gray [H, W], depth [H, W], Tcw) for a frame index.

    Depth is the camera-frame z of the surface point behind each pixel —
    the same convention as the simulation dataset's linearized depth
    (simulation.cc:117-137).
    """
    return render_frame_at(camera_pose(frame_idx, config), frame_idx, config)


@partial(jax.jit, static_argnames=("config",))
def render_frame_at(Tcw: se3.SE3, frame_time, config: SceneConfig):
    """Render from an explicit camera pose (same scene clock ``frame_time``).

    Enables stereo rendering: the right view is the left pose composed with
    a baseline offset (see datasets/hamlyn_export.py)."""
    H, W = config.height, config.width
    cam = camera(config)
    frame_idx = frame_time
    Twc = se3.inverse(Tcw)

    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing="ij")
    uv = jnp.stack([xs, ys], axis=-1).reshape(-1, 2)
    rays_cam = cameras.unproject(cam, uv)                  # z=1 rays
    rays_world = se3.quat_rotate(Twc.q[None], rays_cam)
    origin = Twc.t

    t_f = jnp.asarray(frame_idx, jnp.float32)

    def step(s, _):
        p = origin[None] + s[:, None] * rays_world
        f = surface_height(p[:, 0], p[:, 1], t_f, config)
        # update s so that p_z matches the surface: s * dz = f - oz
        s_new = (f - origin[2]) / rays_world[:, 2]
        return s_new, None

    s0 = jnp.full((H * W,), config.base_depth, jnp.float32)
    s, _ = jax.lax.scan(step, s0, None, length=8)

    p = origin[None] + s[:, None] * rays_world
    gray = texture(p[:, 0], p[:, 1], config).reshape(H, W)
    depth = (s * rays_cam[:, 2]).reshape(H, W)  # camera-frame z (rays_cam z=1)
    return jnp.clip(gray, 0.0, 255.0), depth, Tcw


class SyntheticSequence:
    """Dataset-style wrapper: get_image / get_depth_image / get_camera_pose
    (mirrors modules/datasets/simulation.h:34-38)."""

    def __init__(self, config: SceneConfig = SceneConfig(), n_frames: int = 100):
        self.config = config
        self.n_frames = n_frames

    def __len__(self):
        return self.n_frames

    def get_frame(self, idx):
        gray, depth, Tcw = render_frame(idx, self.config)
        return gray, depth, Tcw

    def get_image(self, idx):
        return self.get_frame(idx)[0]

    def get_depth_image(self, idx):
        return self.get_frame(idx)[1]

    def get_camera_pose(self, idx):
        return self.get_frame(idx)[2]
