"""Export a synthetic sequence to the reference's Simulation disk layout.

Writes the exact directory convention modules/datasets/simulation.cc reads:

- ``rgb/image_%04d.png``        (simulation.cc:117 naming, color PNGs)
- ``depth/aov_image_%04d.exr``  nonlinear depth buffer, linearized on read
  with the near/far clips 0.01/4.0 (simulation.cc:117-137). This OpenCV
  build ships without EXR codecs, so the exporter falls back to
  ``depth/aov_image_%04d.png`` — 16-bit PNGs holding metric depth scaled by
  the far clip (``uint16 = depth / FAR * 65535``, ~6e-5 units of depth
  resolution). The :class:`nrslam.datasets.loaders.Simulation` loader
  reads either form.
- ``trajectory.csv``            rows ``tX;tY;tZ;qX;qY;qZ;qW;time`` of Twc
  (the loader inverts to Tcw, simulation.cc:77-106)
- ``settings.yaml``             OpenCV-FileStorage-dialect settings with the
  reference's key schema (data/simulation/settings.yaml)
- ``filters.txt``               masking filter list (masker.cc:99-136)

This is the bridge between the on-device synthetic renderer and the full
disk-dataset path (Settings -> Masker -> Simulation loader -> evaluator):
integration tests drive ``apps/run_slam.py --dataset simulation`` over an
exported directory, the closest achievable stand-in for the real simulated
colonoscopy data in a zero-egress environment.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from nrslam.datasets import synthetic
from nrslam.geometry import se3

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def _write_color_png(path: Path, gray: np.ndarray) -> None:
    rgb = np.repeat(gray.astype(np.uint8)[..., None], 3, axis=-1)
    if _HAS_CV2:
        cv2.imwrite(str(path), rgb[..., ::-1])
        return
    from PIL import Image
    Image.fromarray(rgb).save(path)


def _write_depth(depth_dir: Path, idx: int, depth: np.ndarray) -> str:
    """EXR nonlinear buffer when the codec exists, else the 16-bit PNG
    metric fallback. Returns the filename written."""
    near = 0.01   # simulation.h:50
    far = 4.0     # simulation.h:51
    if _HAS_CV2:
        # Invert the linearization of simulation.cc:117-137: raw such that
        # depth == 1 / (z * (1 - raw) + w).
        x = 1.0 - far / near
        y = far / near
        z = x / far
        w = y / far
        raw = (1.0 - ((1.0 / np.maximum(depth, 1e-6)) - w) / z)
        name = f"aov_image_{idx:04d}.exr"
        try:
            if cv2.imwrite(str(depth_dir / name), raw.astype(np.float32)):
                return name
        except cv2.error:
            pass
    # PNG16 metric fallback (documented in the module docstring).
    name = f"aov_image_{idx:04d}.png"
    q = np.clip(depth / far, 0.0, 1.0)
    arr = np.round(q * 65535.0).astype(np.uint16)
    from PIL import Image
    # fromarray (not frombytes on raw bytes): PIL picks the 16-bit mode and
    # handles host byte order, so the encoding is endian-safe.
    Image.fromarray(arr).save(depth_dir / name)
    return name


def export_simulation_dataset(out_dir, scene: synthetic.SceneConfig,
                              n_frames: int = 40,
                              filters=("BorderFilter 4 4",),
                              evaluation_save_path: str = "") -> Path:
    """Render ``n_frames`` of the synthetic scene into a Simulation-layout
    directory. Returns the dataset root."""
    root = Path(out_dir)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(parents=True, exist_ok=True)

    rows = []
    for i in range(n_frames):
        gray, depth, Tcw = synthetic.render_frame(i, scene)
        gray = np.asarray(gray)
        depth = np.asarray(depth)
        _write_color_png(root / "rgb" / f"image_{i:04d}.png", gray)
        _write_depth(root / "depth", i, depth)
        Twc = se3.inverse(Tcw)
        q = np.asarray(Twc.q)  # [qw, qx, qy, qz]
        t = np.asarray(Twc.t)
        rows.append(f"{t[0]};{t[1]};{t[2]};{q[1]};{q[2]};{q[3]};{q[0]};{i}")

    with open(root / "trajectory.csv", "w") as f:
        f.write("tX;tY;tZ;rX;rY;rZ;rW;time\n")
        f.write("\n".join(rows) + "\n")

    fx = float(scene.fx)
    fy = float(scene.fy)
    cx = (scene.width - 1) / 2.0
    cy = (scene.height - 1) / 2.0
    lines = [
        "%YAML:1.0",
        "",
        'Camera.model: "PinHole"',
        f"Camera.fx: {fx}",
        f"Camera.fy: {fy}",
        f"Camera.cx: {cx}",
        f"Camera.cy: {cy}",
        "",
        f"Camera.radiansPerPixel: {1.0 / fx}",
        "",
        'Masking.filterFile: "./filters.txt"',
        "",
        "System.autoplay: 1",
        f'Evaluation.save_path: "{evaluation_save_path}"',
        'MapVisualizer.save_path: ""',
        'ImageVisualizer.save_path: ""',
    ]
    if scene.camera_kind == "kb8":
        k = scene.kb_coeffs
        lines[2] = 'Camera.model: "KannalaBrandt8"'
        lines.insert(7, f"Camera.k3: {k[3]}")
        lines.insert(7, f"Camera.k2: {k[2]}")
        lines.insert(7, f"Camera.k1: {k[1]}")
        lines.insert(7, f"Camera.k0: {k[0]}")
    (root / "settings.yaml").write_text("\n".join(lines) + "\n")
    (root / "filters.txt").write_text("\n".join(filters) + "\n")
    return root
