"""OpenCV fallback video reader (the decord/torchvision-equivalent backend).

The port's copy of quickvideo_tpu/video/cv2_reader.py (the port imports nothing of the JAX
package); tests/test_torch_copies.py pins it to the original.

The reference degrades to decord -> torchvision when deepcodec is disabled
or fails (reference lvu/models/qwen25_lvu.py:215-265,344-348). This module
is that degradation path for the TPU build: a sequential single-reader
backend over cv2.VideoCapture (OpenCV's FFmpeg binding — present in the
runtime image, unlike decord/torchvision/PyAV), registered behind the
native quickdecode engine in video/reader.py. `DEEPCODEC_DISABLED=1` or a
quickdecode failure falls through here instead of raising; it is also the
decode benchmark's comparison arm (benchmarks/decode_bench.py).

Interface parity with quickdecode.VideoReader: len / get_fps / source_h/w /
settable height/width/interpolation / get_batch(indices) -> TCHW uint8 RGB
in REQUEST order / close. No interval parallelism, no YUV420 output, no
interleaved streaming — sequential decode is exactly what the reference's
fallbacks do.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_INTERP = {
    # names match the quickdecode/PIL vocabulary used by the reader registry
    "LANCZOS": "INTER_LANCZOS4",
    "BICUBIC": "INTER_CUBIC",
    "BILINEAR": "INTER_LINEAR",
    "NEAREST": "INTER_NEAREST",
    "AREA": "INTER_AREA",
}


def is_available() -> bool:
    try:
        import cv2  # noqa: F401

        return True
    except Exception:  # noqa: BLE001 — import probe
        return False


class Cv2VideoReader:
    """Sequential-decode reader over cv2.VideoCapture."""

    def __init__(self, path: str, num_threads: int = 0):
        import cv2

        self._cv2 = cv2
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"cv2.VideoCapture failed to open {path}")
        self._path = path
        # cv2's FFmpeg layer threads internally; num_threads kept for
        # interface parity (the fallback is sequential by design)
        self._num_threads = num_threads
        self._n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self._fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or 30.0
        self._src_w = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self._src_h = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self._height = None
        self._width = None
        self._interp = "LANCZOS"
        self._pos = 0  # next frame ordinal the capture will decode

    def __len__(self):
        return self._n

    def get_fps(self) -> float:
        return self._fps

    def get_avg_fps(self) -> float:  # decord-compat alias
        return self._fps

    @property
    def source_width(self):
        return self._src_w

    @property
    def source_height(self):
        return self._src_h

    @property
    def height(self):
        return self._height or self._src_h

    @height.setter
    def height(self, v):
        self._height = int(v)

    @property
    def width(self):
        return self._width or self._src_w

    @width.setter
    def width(self, v):
        self._width = int(v)

    @property
    def interpolation(self):
        return self._interp

    @interpolation.setter
    def interpolation(self, v: str):
        if v.upper() not in _INTERP:
            raise ValueError(f"unknown interpolation {v!r}; have "
                             f"{sorted(_INTERP)}")
        self._interp = v.upper()

    def _read_at(self, idx: int) -> np.ndarray:
        cv2 = self._cv2
        if idx < self._pos:
            # backward jump: seek (cv2 seeks to the nearest keyframe and
            # decodes forward internally)
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
            self._pos = idx
        seq_ok = True
        while self._pos < idx:
            # grab() decodes but skips retrieve/color-convert — the cheap
            # way to advance over unsampled frames
            if not self._cap.grab():
                seq_ok = False
                break
            self._pos += 1
        ok, frame = (self._cap.read() if seq_ok else (False, None))
        if not ok:
            # cv2's sequential demux path drops the stream's final frame
            # (no decoder flush at EOF); the seek path retrieves it — retry
            # through an explicit position set before giving up
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
            ok, frame = self._cap.read()
            if not ok:
                self._pos = idx  # unknown capture state; force next seek
                raise IOError(
                    f"decode failed at frame {idx} of {self._path}"
                )
        self._pos = idx + 1
        return frame  # BGR HWC uint8

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        """Decode `indices` (any order) -> (T, C, H, W) uint8 RGB, resized to
        (self.height, self.width), rows in REQUEST order."""
        cv2 = self._cv2
        idx = [int(i) for i in indices]
        order = sorted(range(len(idx)), key=lambda j: idx[j])
        h, w = self.height, self.width
        interp = getattr(cv2, _INTERP[self._interp])
        out = np.empty((len(idx), 3, h, w), np.uint8)
        last = None
        frame = None
        for j in order:
            if idx[j] != last:
                frame = self._read_at(idx[j])
                if frame.shape[0] != h or frame.shape[1] != w:
                    frame = cv2.resize(frame, (w, h), interpolation=interp)
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                last = idx[j]
            out[j] = frame.transpose(2, 0, 1)
        return out

    def close(self):
        if self._cap is not None:
            self._cap.release()
            self._cap = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
