"""Export the synthetic scene as a Hamlyn-layout stereo dataset.

The reference's Hamlyn pipeline (modules/datasets/hamlyn.cc:100-249) splits
stereo videos into cached PNG directories, rectifying with the hardcoded
per-sequence calibration; the SLAM app then tracks the left stream and
evaluates against stereo ground truth (system.cc:134-160). Real Hamlyn
videos are unreachable in a zero-egress image, so this exporter renders the
synthetic deforming scene from a rectified stereo rig into the exact cache
layout the loader reads:

    <root>/images/%06d.png          left (rectified) frames
    <root>/images_right/%06d.png    right frames, baseline along +x
    <root>/settings.yaml            PinHole calibration + Stereo.bf
    <root>/filters.txt              masker spec
    <root>/names.txt                also readable as an Endomapper cache

The rig is ideal-rectified by construction (identical pinhole intrinsics,
pure x-baseline), which is exactly what hamlyn.cc's stereoRectify output
guarantees; tests/test_e2e_hamlyn_stereo.py additionally drives the real
rectification maps (datasets/rectification.py) over exported pairs.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from nrslam.datasets import synthetic
from nrslam.geometry import se3


def _save_gray_png(path: Path, gray: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(np.clip(np.asarray(gray), 0, 255).astype(np.uint8)
                    ).save(path)


def export_hamlyn_stereo_dataset(out_dir, scene: synthetic.SceneConfig,
                                 n_frames: int = 36,
                                 baseline: float = 0.12,
                                 filters=("BorderFilter 4 4",)) -> Path:
    """Render ``n_frames`` stereo pairs into a Hamlyn cache layout.

    Returns the dataset root. ``Stereo.bf`` = fx * baseline (the rectified
    projection convention, hamlyn.cc:195-199 / P2[0,3] = -fx*b)."""
    root = Path(out_dir)
    left_dir = root / "images"
    right_dir = root / "images_right"
    left_dir.mkdir(parents=True, exist_ok=True)
    right_dir.mkdir(parents=True, exist_ok=True)

    # Right camera: the left pose composed with a pure x-baseline offset
    # (a world point at camera-frame x maps to x - b in the right camera).
    T_rl = se3.SE3(jnp.array([1.0, 0.0, 0.0, 0.0]),
                   jnp.array([-baseline, 0.0, 0.0]))

    names = []
    for i in range(n_frames):
        Tcw_l = synthetic.camera_pose(i, scene)
        gray_l, _, _ = synthetic.render_frame_at(Tcw_l, i, scene)
        gray_r, _, _ = synthetic.render_frame_at(se3.compose(T_rl, Tcw_l),
                                                 i, scene)
        name = f"{i:06d}.png"
        _save_gray_png(left_dir / name, gray_l)
        _save_gray_png(right_dir / name, gray_r)
        names.append(f"images/{name}")

    fx = float(scene.fx)
    lines = [
        "%YAML:1.0",
        "",
        'Camera.model: "PinHole"',
        f"Camera.fx: {fx}",
        f"Camera.fy: {float(scene.fy)}",
        f"Camera.cx: {(scene.width - 1) / 2.0}",
        f"Camera.cy: {(scene.height - 1) / 2.0}",
        "",
        f"Camera.radiansPerPixel: {1.0 / fx}",
        f"Stereo.bf: {fx * baseline}",
        "",
        'Masking.filterFile: "./filters.txt"',
        "",
        "System.autoplay: 1",
        'Evaluation.save_path: ""',
        'MapVisualizer.save_path: ""',
        'ImageVisualizer.save_path: ""',
    ]
    (root / "settings.yaml").write_text("\n".join(lines) + "\n")
    (root / "filters.txt").write_text("\n".join(filters) + "\n")
    # names.txt makes the same cache readable through the Endomapper loader
    # (endomapper.cc's split-once convention).
    (root / "names.txt").write_text("\n".join(names) + "\n")
    return root
