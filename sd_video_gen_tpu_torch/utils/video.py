"""Video/frame I/O helpers on the host (``sd_video_gen_tpu/utils/video.py``;
the port keeps its own copy, and the same frames give the same files).

Reference: utils/sd_utils.py imgs_to_video (191-199) and the frame-saving /
red-border conventions of prediction/predict.py:201-229 (the border helper
itself lives in predict/predict.py next to its CLI). ``cv2`` is imported
inside the functions that write or decode video.
"""

from __future__ import annotations

import base64
import os

import numpy as np


def imgs_to_video(imgs, video_name: str = "video.mp4", fps: int = 15) -> str:
    """Write a list/array of HxWx3 uint8 BGR frames to an mp4/avi file."""
    import cv2
    imgs = [np.asarray(im) for im in imgs]
    if not imgs:
        raise ValueError("imgs_to_video: empty frame list")
    h, w = imgs[0].shape[:2]
    fourcc = cv2.VideoWriter_fourcc(*("mp4v" if video_name.endswith(".mp4")
                                      else "DIVX"))
    vw = cv2.VideoWriter(video_name, fourcc, fps, (w, h))
    if not vw.isOpened():
        # without this check a missing encoder makes every write a silent
        # no-op and the caller reports success over a 0-byte file
        raise RuntimeError(
            f"VideoWriter could not open {video_name} (codec missing?)")
    for im in imgs:
        vw.write(im)
    vw.release()
    return video_name


def video_to_imgs(path: str, max_frames: int | None = None) -> np.ndarray:
    """Decode up to ``max_frames`` frames (all when None) of a video file:
    (T, H, W, 3) uint8 BGR."""
    import cv2
    if not os.path.exists(path):
        # cv2.VideoCapture returns ok=False for a missing file, which is
        # indistinguishable from an empty video: raise the real cause
        raise FileNotFoundError(path)
    cap = cv2.VideoCapture(path)
    frames = []
    # `max_frames is not None`: 0 asks for no frame, not for all of them
    while max_frames is None or len(frames) < max_frames:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return (np.stack(frames) if frames
            else np.zeros((0, 0, 0, 3), np.uint8))


def display_video(file_path: str, width: int = 512) -> str:
    """HTML snippet embedding an mp4 (notebook helper; reference
    utils/sd_utils.py:201-214). Returns the HTML string; in IPython do
    ``IPython.display.HTML(display_video(...))``."""
    with open(file_path, "rb") as f:
        data = base64.b64encode(f.read()).decode()
    return (f'<video width={width} controls>'
            f'<source src="data:video/mp4;base64,{data}" type="video/mp4">'
            f'</video>')
