"""The one traffic generator: it reads a mix's data file and yields requests.

A mix file (qvbench/traffic/<name>.json) states:

  loop, clients        "closed", 1: each request is sent when the one
                       before it has finished
  video                frames, fps, height, width of each request's video;
                       every request reads a new seeded video
  question_tokens      [lo, hi]: question lengths in tokens (one byte each)
  max_new_tokens       greedy tokens a request asks for
  lvu                  the LVUConfig fields the mix runs under (group size,
                       pruning, cache capacity, stream settings)
  check_requests       how many finished requests the reference checks

The seed draws the order of the question lengths (every length of the
range once per cycle, so every seed offers the same set of sizes) and the
questions' letters; the videos come from qvbench/frames.py.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List

import numpy as np

from qvbench import families
from qvbench import frames as qframes

LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz    ", np.uint8)


@dataclass(frozen=True)
class Request:
    index: int
    path: str
    question: str
    max_new_tokens: int


@dataclass(frozen=True)
class Mix:
    name: str
    raw: dict

    @property
    def video(self) -> dict:
        return self.raw["video"]

    @property
    def lvu(self) -> dict:
        return dict(self.raw["lvu"])

    @property
    def max_new_tokens(self) -> int:
        return int(self.raw["max_new_tokens"])

    @property
    def check_requests(self) -> int:
        return int(self.raw["check_requests"])

    # a mix's shapes in a model's tokens: the spec's family works them out
    # (qvbench/families/)

    def group_frames(self, spec) -> List[int]:
        """Frames of each group."""
        return families.of_spec(spec).group_frames(spec, self)

    def group_tokens(self, spec) -> List[int]:
        """Video tokens of each group."""
        return families.of_spec(spec).group_tokens(spec, self)

    def patches_per_group(self, spec):
        """Patches each group's vision tower runs, where every group has
        the same count; else None."""
        return families.of_spec(spec).patches_per_group(spec, self)

    def group_rows(self, spec, question: str) -> List[int]:
        """Rows each group step runs: group 0 also carries the prefix."""
        rows = self.group_tokens(spec)
        rows[0] += families.of_spec(spec).prefix_len(spec)
        return rows

    def suffix_len(self, spec, question: str) -> int:
        return families.of_spec(spec).suffix_len(spec, question)

    def keep(self, rows: int) -> int:
        """Rows a group step keeps in every layer (top_p of them, all where
        that is not fewer)."""
        top_p = self.lvu.get("top_p")
        if top_p is None:
            return rows
        k = int(rows * float(top_p))
        return k if 0 < k < rows else rows

    def requests(self, seed: int) -> Iterator[Request]:
        rng = np.random.default_rng(qframes.hash64(seed, 0x7AFF))
        lo, hi = (int(x) for x in self.raw["question_tokens"])
        lengths: List[int] = []
        i = 0
        while True:
            if not lengths:
                lengths = list(rng.permutation(np.arange(lo, hi + 1)))
            n = int(lengths.pop())
            letters = LETTERS[rng.integers(0, len(LETTERS), n)]
            letters[0] = letters[-1] = ord("q")
            yield Request(i, qframes.video_path(seed, i + 1),
                          letters.tobytes().decode(), self.max_new_tokens)
            i += 1

    def warmup_request(self, seed: int) -> Request:
        """The set-up's request: the mix's shape, a video of its own."""
        q = "q" * int(self.raw["question_tokens"][1])
        return Request(-1, qframes.video_path(seed, 0), q,
                       self.max_new_tokens)


def load_mix(root: Path, name: str) -> Mix:
    raw = json.loads((root / "traffic" / f"{name}.json").read_text())
    if raw.get("loop") != "closed" or raw.get("clients") != 1:
        raise ValueError(f"mix {name!r}: this generator runs one client in "
                         "a closed loop")
    return Mix(name, raw)
