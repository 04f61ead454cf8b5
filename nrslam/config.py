"""Settings: YAML configuration matching the reference's key schema.

Re-design of /root/reference/modules/SLAM/settings.{h,cc}: reads the same
``settings.yaml`` files shipped per sequence (data/<seq>/settings.yaml) —
camera model + intrinsics, radians-per-pixel, masking filter file, stereo
baseline, evaluation/save paths — and additionally exposes every constant the
reference hardcodes at construction sites (SURVEY.md §5 config gap) through
``nrslam.slam.state.Config``.

The reference files are OpenCV FileStorage YAML ("%YAML:1.0" + typed
matrices); this parser handles that dialect without requiring cv2.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional

from nrslam.geometry import cameras
from nrslam.ops import masking
from nrslam.slam.state import Config


def _parse_opencv_yaml(text: str) -> dict:
    """Minimal parser for the flat key: value entries of OpenCV YAML files
    (ignores the !!opencv-matrix blocks, which only feed the reference's GUI
    camera views)."""
    out = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].rstrip()
        m = re.match(r"^([A-Za-z0-9_.]+):\s*(.+)$", line)
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip()
        if val.startswith("!!"):
            continue
        if val.startswith('"') and val.endswith('"'):
            out[key] = val[1:-1]
            continue
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


class Settings:
    """Parsed settings (Settings::Settings, settings.cc:82-174)."""

    def __init__(self, settings_path: str):
        self.path = Path(settings_path)
        raw = _parse_opencv_yaml(self.path.read_text())
        self.raw = raw

        model = raw.get("Camera.model", "PinHole")
        fx, fy = raw["Camera.fx"], raw["Camera.fy"]
        cx, cy = raw["Camera.cx"], raw["Camera.cy"]
        if model == "PinHole":
            self.calibration = cameras.pinhole(fx, fy, cx, cy)
        elif model in ("KannalaBrandt8", "KannalaBrandt"):
            self.calibration = cameras.kannala_brandt8(
                fx, fy, cx, cy, raw["Camera.k0"], raw["Camera.k1"],
                raw["Camera.k2"], raw["Camera.k3"])
        else:
            raise ValueError(f"unknown camera model {model}")

        self.rad_per_pixel = float(raw.get("Camera.radiansPerPixel", 0.002))
        self.bf = float(raw.get("Stereo.bf", 0.0))
        self.autoplay = bool(raw.get("System.autoplay", 1))
        self.evaluation_path = raw.get("Evaluation.save_path", "")
        self.image_visualizer_path = raw.get("ImageVisualizer.save_path", "")
        self.map_visualizer_path = raw.get("MapVisualizer.save_path", "")

        self.masker = self._load_masker(raw.get("Masking.filterFile"))

    def _load_masker(self, filter_file: Optional[str]):
        """Masker::LoadFromText (masker.cc:99-136)."""
        if not filter_file:
            return None
        path = Path(filter_file)
        if not path.is_absolute():
            path = self.path.parent / path.name
        if not path.exists():
            return None
        specs = []
        for line in path.read_text().splitlines():
            parts = line.split()
            if not parts:
                continue
            name = parts[0]
            if name == "BorderFilter" and len(parts) >= 3:
                specs.append((name, int(parts[1]), int(parts[2])))
            elif name == "BrightFilter":
                thr = float(parts[1]) if len(parts) > 1 else 220.0
                specs.append((name, thr))
            elif name == "PredefinedFilter" and len(parts) > 1:
                from nrslam.datasets.loaders import _imread_gray
                mask_img = _imread_gray(str(self.path.parent / parts[1]))
                import jax.numpy as jnp
                specs.append((name, jnp.asarray(mask_img)))
        return masking.Masker(specs) if specs else None

    def slam_config(self, **overrides) -> Config:
        base = Config(rad_per_pixel=self.rad_per_pixel)
        return base._replace(**overrides) if overrides else base
