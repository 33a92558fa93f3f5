"""HTTP serving front end of the PyTorch port: request scheduling,
same-video micro-batching, resident chat sessions with disk spill, an
OpenAI-compatible adapter (server.py)."""

from quickvideo_tpu_torch.serving.server import (
    LVUServer,
    RequestError,
    ServerConfig,
    main,
    make_http_server,
    openai_to_reference_messages,
)

__all__ = [
    "LVUServer",
    "RequestError",
    "ServerConfig",
    "main",
    "make_http_server",
    "openai_to_reference_messages",
]
