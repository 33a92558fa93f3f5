"""Public API facade: the `LVU` class.

Counterpart of quickvideo_tpu/api.py for the slice: `LVU(config)` builds
the parameters on the device, the engine, and binds the registered engine's
run/chat drivers. A bare preset name (qwen25-vl-3b / -7b / -72b, tiny) gives
deterministic random weights at the preset's shapes, made on the device from
`config.seed`; a local directory is a safetensors checkpoint, read leaf by
leaf onto the device (models/qwen25_vl/load.py); any other name with a "/"
is refused. `config.param_dtype="int8"` quantizes the weights (random ones
as they are drawn, loaded or passed-in float ones in place).

Beside `generate` and `chat`: `loglikelihood` / `loglikelihood_multi`
(teacher-forced scoring of continuations, several against one prefill) and
`start_chat` / `resume_chat` (multi-turn sessions over one video that keep
the KV cache, and their .npz files, chat.py).

The device is CUDA unless `device` says otherwise: without a card `LVU`
raises instead of running on the CPU. `device="cpu"` runs the kernels'
plain versions.

A mesh (`config.mesh` of more than one device; quickvideo_tpu/api.py:
93-111) runs one process per rank, each building the same LVU: the process
group comes from parallel.mesh.init_multihost (called here from the
environment unless the caller started it, with the backend the device
implies: NCCL on CUDA, gloo on the CPU), `lvu.mesh` is this rank's
Mesh, the device is cuda:{local rank} unless `device` names one, and the
parameters are this rank's part: under pipeline parallelism its stage's
layers (the vision tower and embedding on the first stage, the norm and
lm_head on the last), and of those its tensor-parallel slices. They are
cut from `params`, read from a checkpoint directory tensor by tensor
(load_params with the rank's stage and tp slice), or drawn from the seed
in one device's order with the rest dropped as it is drawn
(quickvideo_tpu/api.py:100-107 likewise never replicates the weights
under pp). Every rank runs every request; each returns the same answer.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import torch

from quickvideo_tpu_torch.config import LVUConfig
from quickvideo_tpu_torch.models.qwen25_vl.config import get_config
from quickvideo_tpu_torch.tokenization import load_tokenizer
from quickvideo_tpu_torch.models import (
    ensure_builtin_engines,
    lvu_chat_model_map,
    lvu_init_model_map,
    lvu_run_model_map,
)
from quickvideo_tpu_torch.models.qwen25_vl.convert import init_params
from quickvideo_tpu_torch.ops.quantization import quantize_model_params
from quickvideo_tpu_torch.parallel.sharding import mesh_params, stage_of
from quickvideo_tpu_torch.prefill.engine import LVUEngine, check_slice

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class LVU:
    def __init__(
        self,
        config: LVUConfig,
        params: Optional[dict] = None,
        device=None,
    ):
        name = config.model_name_or_path or "qwen25-vl-7b"
        self.model_config = get_config(name)
        check_slice(config, self.model_config)
        ensure_builtin_engines()
        self.config = config
        self.mesh = None
        if config.mesh.num_devices > 1:
            from quickvideo_tpu_torch.parallel.mesh import (
                init_multihost,
                make_mesh,
            )

            init_multihost(device=device)
            self.mesh = make_mesh(config.mesh, device)
            device = self.mesh.device
            if device.type == "cuda":
                torch.cuda.set_device(device)
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "LVU runs on a CUDA device and none is available; pass "
                "device='cpu' to run the kernels' plain versions on the CPU"
            )
        if self.device.type == "cuda" and self.device.index is None:
            # pinned to the current card, so threads that serve it (whose
            # current device torch keeps apart) select the same one
            self.device = torch.device("cuda", torch.cuda.current_device())
        int8 = config.param_dtype == "int8"
        dtype = DTYPES[config.dtype]
        tp_rank = ((0, 1) if self.mesh is None
                   else (self.mesh.index("tp"), self.mesh.tp))
        if params is not None:
            params = quantize_model_params(params) if int8 else params
            self.params = mesh_params(params, self.mesh)
        elif os.path.isdir(config.model_name_or_path or ""):
            from quickvideo_tpu_torch.models.qwen25_vl.load import load_params

            self.params = load_params(
                config.model_name_or_path, self.model_config, dtype,
                self.device, tp_rank, int8, stage_of(self.mesh),
            )
            if int8:
                self.params = quantize_model_params(self.params)
        elif "/" in name:
            raise ValueError(
                f"model_name_or_path {name!r} is not a local directory. Pass "
                "a checkpoint path, or a preset name (qwen25-vl-3b/7b/72b) "
                "for deterministic random weights."
            )
        else:
            logging.getLogger(__name__).warning(
                "No checkpoint at %r: initializing deterministic RANDOM "
                "weights (%s preset shapes) on %s. Generations are "
                "meaningless; this mode exists for benchmarking only.",
                name, self.model_config.name, self.device,
            )
            self.params = init_params(
                self.model_config, config.seed, dtype, self.device,
                param_dtype=config.param_dtype, mesh=self.mesh,
            )
        self.tokenizer = load_tokenizer(
            config.model_name_or_path or "", self.model_config
        )
        self.engine = LVUEngine(
            self.params, self.model_config, config, dtype, self.device,
            mesh=self.mesh,
        )
        self.params = self.engine.params  # with the engine's weight prep
        self.last_result = None
        self.init_lvu()

    def init_lvu(self):
        model_type = self.config.model_type
        if model_type not in lvu_init_model_map:
            raise ValueError(
                f"model_type {model_type!r} not registered; have "
                f"{sorted(lvu_init_model_map)}"
            )
        lvu_init_model_map[model_type](self, self.config)
        self._run = lvu_run_model_map[model_type]
        self._chat = lvu_chat_model_map.get(model_type)

    def generate(self, question: str, video_path: str,
                 **generation_kwargs) -> List[str]:
        return self._run(self, question, video_path, **generation_kwargs)

    def chat(self, messages, **generation_kwargs) -> List[str]:
        if self._chat is None:
            raise ValueError(
                f"model_type {self.config.model_type!r} has no chat driver"
            )
        return self._chat(self, messages, **generation_kwargs)

    @staticmethod
    def _context_messages(context: str, video_path: Optional[str]):
        content = []
        if video_path is not None:
            content.append({"type": "video", "video": video_path})
        content.append({"type": "text", "text": context})
        return [{"role": "user", "content": content}]

    def loglikelihood(self, context: str, video_path: Optional[str],
                      continuation) -> tuple:
        """Teacher-forced (total_logprob, is_greedy) of `continuation`
        (text or token ids) after the chat-formatted context, the lmms-eval
        `loglikelihood` contract; the video prefill runs grouped and pruned
        as generate's does."""
        from quickvideo_tpu_torch.engines.qwen25 import score_chat

        return score_chat(self, self._context_messages(context, video_path),
                          continuation)

    def loglikelihood_multi(self, context: str, video_path: Optional[str],
                            continuations) -> list:
        """Several continuations against one prefill of (video, context):
        a list of (total_logprob, is_greedy)."""
        from quickvideo_tpu_torch.engines.qwen25 import score_chat_multi

        return score_chat_multi(
            self, self._context_messages(context, video_path), continuations
        )

    def start_chat(self, video_path: str, reserve_turns: int = 8,
                   **video_kwargs):
        """A multi-turn session over one video (chat.ChatSession): the
        pruned video KV cache stays on the device and each follow-up `ask`
        appends only its own tokens."""
        from quickvideo_tpu_torch.chat import ChatSession

        return ChatSession(self, video_path, reserve_turns=reserve_turns,
                           **video_kwargs)

    def resume_chat(self, path: str):
        """A session saved by `ChatSession.save` (by this package or the
        JAX one), under a config whose KV-relevant fields match."""
        from quickvideo_tpu_torch.chat import ChatSession

        return ChatSession.load(self, path)
