"""Seeded video frames behind the port's streaming-reader surface.

A frozen copy of chip_smoke.py::SeededReader, given a frame count and a
frame rate from the traffic file. A video is named by a path of the form
`seeded://<seed>/<video>`; frame `i` of it is a slice of one pool of
random bytes drawn from the run's seed, at an offset that a 64-bit mix of
(seed, video, i) gives. So two videos share no frame, every frame is known
before it is read (the reference reads the same bytes), and drawing a
frame costs one copy, not a random draw: the reader runs in the program's
decode thread, beside the host loop that launches the kernels.

Frames come out at the size the plan asks for (a decoder that resizes
inside, as the port's native reader does), packed yuv420 or RGB uint8.
Each block is drawn when the decode thread asks for it, as a streaming
decoder delivers it.
"""

from __future__ import annotations

import contextlib
import re

import numpy as np

POOL_BYTES = 1 << 26
_MASK = (1 << 64) - 1


def hash64(*words: int) -> int:
    """splitmix64 over the words: a 64-bit hash of small integers."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (int(w) & _MASK)) & _MASK
        h = (h + 0x9E3779B97F4A7C15) & _MASK
        z = h
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        h = z ^ (z >> 31)
    return h


class FramePool:
    """The bytes every frame of a run is cut from, drawn from `seed`."""

    def __init__(self, seed: int, nbytes: int = POOL_BYTES):
        rng = np.random.default_rng(hash64(seed, 0xF4A3))
        self.seed = int(seed)
        self.data = np.frombuffer(rng.bytes(nbytes), np.uint8)

    def frame(self, video: int, index: int, size: int) -> np.ndarray:
        off = hash64(self.seed, video, index) % (len(self.data) - size + 1)
        return self.data[off : off + size]

    def frames(self, video: int, indices, shape) -> np.ndarray:
        size = int(np.prod(shape))
        return np.stack([self.frame(video, i, size).reshape(shape)
                         for i in indices])


def video_path(seed: int, video: int) -> str:
    return f"seeded://{int(seed)}/{int(video)}"


def parse_path(path: str):
    m = re.fullmatch(r"seeded://(-?\d+)/(\d+)", path)
    if m is None:
        raise IOError(f"not a seeded video path: {path!r}")
    return int(m.group(1)), int(m.group(2))


def frame_shape(height: int, width: int, output_format: str) -> tuple:
    if output_format.upper() == "YUV420":
        return (height * width * 3 // 2,)
    return (3, height, width)


class SeededReader:
    """The native interleaved reader's surface (video/quickdecode.py) over
    a FramePool: `frames` source frames of `source_hw` at `fps`."""

    pool: FramePool = None
    frames = 0
    fps = 2.0
    source_hw = (0, 0)

    def __init__(self, path, num_threads=8, num_intervals=64):
        self.seed, self.video = parse_path(path)
        if self.pool is None or self.pool.seed != self.seed:
            raise IOError(f"no frame pool for seed {self.seed}")
        self.source_height, self.source_width = self.source_hw
        self.height = self.width = self.interpolation = None
        self.output_format = "RGB"
        self.frame_iter = 1
        self._todo = []

    def __len__(self):
        return self.frames

    def get_fps(self):
        return self.fps

    def _shape(self):
        return frame_shape(self.height or self.source_height,
                           self.width or self.source_width,
                           self.output_format)

    def process(self, indices):
        self._todo = [int(i) for i in indices]

    def __next__(self):
        block, self._todo = (self._todo[: self.frame_iter],
                             self._todo[self.frame_iter :])
        if not block:
            raise StopIteration
        return self.pool.frames(self.video, block, self._shape())

    def close(self):
        pass


@contextlib.contextmanager
def seeded_videos(pool: FramePool, frames: int, fps: float, source_hw):
    """Inside the block the port's streaming reader is a SeededReader over
    `pool` (as chip_smoke.py::seeded_videos replaces it)."""
    from quickvideo_tpu_torch.video import quickdecode as qd

    saved = (qd.InterleavedVideoReader, SeededReader.pool,
             SeededReader.frames, SeededReader.fps, SeededReader.source_hw)
    qd.InterleavedVideoReader = SeededReader
    SeededReader.pool, SeededReader.frames = pool, int(frames)
    SeededReader.fps, SeededReader.source_hw = float(fps), tuple(source_hw)
    try:
        yield
    finally:
        (qd.InterleavedVideoReader, SeededReader.pool, SeededReader.frames,
         SeededReader.fps, SeededReader.source_hw) = saved
