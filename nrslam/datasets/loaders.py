"""Dataset loaders: Simulation, Hamlyn, Endomapper.

Host-side re-design of /root/reference/modules/datasets/ (pathlib + imageio /
OpenCV instead of boost::filesystem + cv::VideoCapture). Frames feed the
device pipeline as float32 grayscale; decode stays on host (SURVEY.md §2.3
host<->device boundary).

Each loader mirrors the reference's directory conventions:
- Simulation (simulation.cc): ``rgb/image_%04d.png``, ``depth/aov_image_%04d.exr``
  (nonlinear depth linearized with near/far clips 0.01/4.0, :117-137),
  ``trajectory.csv`` with rows ``tX;tY;tZ;rX;rY;rZ;rW;time`` inverted to Tcw.
- Hamlyn (hamlyn.cc): mono or stereo video split into cached PNGs; the
  per-sequence stereo rectification maps of the reference require its
  hardcoded calibrations — here rectified PNG caches are read directly.
- Endomapper (endomapper.cc): video split into cached PNGs via ``names.txt``.

cv2 (OpenCV) is used when present for video decode / EXR; loaders degrade to
PNG-directory reading without it.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import Optional

import numpy as np

from nrslam.geometry import se3

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def _imread_gray(path: str) -> np.ndarray:
    if _HAS_CV2:
        img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img.astype(np.float32)
    from PIL import Image  # pillow fallback
    return np.asarray(Image.open(path).convert("L"), np.float32)


def _imread_color(path: str) -> np.ndarray:
    if _HAS_CV2:
        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img[..., ::-1].astype(np.float32)  # BGR -> RGB
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"), np.float32)


class Simulation:
    """Simulated colonoscopy with GT depth + poses (datasets/simulation.cc)."""

    NEAR_CLIP = 0.01   # simulation.h:50
    FAR_CLIP = 4.0     # simulation.h:51

    def __init__(self, dataset_path: str):
        self.root = Path(dataset_path)
        self.rgb_names = sorted((self.root / "rgb").glob("image_*.png"))
        self.depth_names = sorted((self.root / "depth").glob("aov_image_*.exr"))
        # PNG16 metric-depth fallback written by simulation_export when the
        # OpenCV build ships no EXR codec: uint16 = depth / FAR_CLIP * 65535.
        self.depth_png_names = sorted(
            (self.root / "depth").glob("aov_image_*.png"))
        self.poses = self._load_trajectory(self.root / "trajectory.csv")

    @staticmethod
    def _load_trajectory(path: Path):
        poses = []
        if not path.exists():
            return poses
        with open(path) as f:
            reader = csv.reader(f, delimiter=";")
            next(reader, None)  # header
            for row in reader:
                if len(row) < 7:
                    continue
                vx, vy, vz, qx, qy, qz, qw = map(float, row[:7])
                Twc = se3.SE3(
                    q=np.array([qw, qx, qy, qz], np.float32),
                    t=np.array([vx, vy, vz], np.float32))
                poses.append(se3.inverse(Twc))  # stored inverted (Tcw)
        return poses

    def __len__(self):
        return len(self.rgb_names)

    def get_image(self, idx: int) -> np.ndarray:
        return _imread_color(self.rgb_names[idx])

    def get_depth_image(self, idx: int) -> np.ndarray:
        """EXR nonlinear depth buffer -> metric depth (simulation.cc:117-137);
        falls back to the PNG16 metric encoding of simulation_export."""
        if not self.depth_names:
            if self.depth_png_names:
                from PIL import Image
                arr = np.asarray(Image.open(self.depth_png_names[idx]),
                                 np.float32)
                return arr / 65535.0 * self.FAR_CLIP
            raise FileNotFoundError(
                f"no depth images under {self.root / 'depth'}")
        if not _HAS_CV2:
            raise RuntimeError("EXR depth decode requires OpenCV")
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        raw = cv2.imread(str(self.depth_names[idx]),
                         cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        if raw.ndim == 3:
            raw = raw[..., 2]
        x = 1.0 - self.FAR_CLIP / self.NEAR_CLIP
        y = self.FAR_CLIP / self.NEAR_CLIP
        z = x / self.FAR_CLIP
        w = y / self.FAR_CLIP
        return (1.0 / (z * (1.0 - raw) + w)).astype(np.float32)

    def get_camera_pose(self, idx: int):
        return self.poses[idx]


class FrameDirectory:
    """Generic cached-PNG directory reader (shared Hamlyn/Endomapper core)."""

    def __init__(self, images_dir: Path, pattern: str = "*.png"):
        self.names = sorted(Path(images_dir).glob(pattern))

    def __len__(self):
        return len(self.names)

    def get_image(self, idx: int) -> np.ndarray:
        return _imread_gray(self.names[idx])


class Hamlyn:
    """Hamlyn sequences (datasets/hamlyn.cc): expects the reference's cache
    layout — ``images/`` (left, rectified) and optionally ``images_right/``.
    Video splitting + rectification caches are produced by ``prepare`` when a
    video file + calibration are supplied."""

    def __init__(self, dataset_path: str):
        self.root = Path(dataset_path)
        left = self.root / "images"
        if not left.exists():
            left = self.root  # flat directory of pngs
        self.left = FrameDirectory(left)
        right_dir = self.root / "images_right"
        self.right = FrameDirectory(right_dir) if right_dir.exists() else None

    def __len__(self):
        return len(self.left)

    def get_image(self, idx: int) -> np.ndarray:
        return self.left.get_image(idx)

    def get_right_image(self, idx: int) -> Optional[np.ndarray]:
        return None if self.right is None else self.right.get_image(idx)

    @staticmethod
    def prepare(video_path: str, out_dir: str) -> int:
        """Split a video into cached PNGs (hamlyn.cc:100-149 behavior)."""
        if not _HAS_CV2:
            raise RuntimeError("video split requires OpenCV")
        cap = cv2.VideoCapture(video_path)
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        n = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            cv2.imwrite(str(out / f"{n:06d}.png"), frame)
            n += 1
        cap.release()
        return n


class Endomapper:
    """Endomapper colonoscopy video (datasets/endomapper.cc): splits the
    video to a PNG cache once (tracked by names.txt), then indexed reads."""

    def __init__(self, dataset_path: str, video_name: Optional[str] = None):
        self.root = Path(dataset_path)
        names_file = self.root / "names.txt"
        if not names_file.exists() and video_name is not None:
            n = Hamlyn.prepare(str(self.root / video_name),
                               str(self.root / "images"))
            with open(names_file, "w") as f:
                for i in range(n):
                    f.write(f"images/{i:06d}.png\n")
        if names_file.exists():
            with open(names_file) as f:
                self.names = [self.root / line.strip() for line in f
                              if line.strip()]
        else:
            self.names = sorted((self.root / "images").glob("*.png"))

    def __len__(self):
        return len(self.names)

    def get_image(self, idx: int) -> np.ndarray:
        return _imread_color(self.names[idx])
