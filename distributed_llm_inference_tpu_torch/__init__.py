"""PyTorch/CUDA port of the distributed LLM inference framework.

Mirrors the directory and file names of ``distributed_llm_inference_tpu`` (the
JAX reference, which stays in the repository) so each module's counterpart is
easy to find. The port imports ``torch`` only: nothing of JAX, Flax or the JAX
package. Entry points take an explicit ``device`` that defaults to ``"cuda"``
and raise when that device is missing; nothing carries on on the CPU because
it found no GPU. Tests pass ``device="cpu"``.
"""

from .config import (
    CacheConfig,
    EngineConfig,
    LatentConfig,
    ModelConfig,
    RopeScaling,
    ServingConfig,
)
from .utils.device import resolve_device

__version__ = "0.1.0"

__all__ = [
    "CacheConfig",
    "EngineConfig",
    "LatentConfig",
    "ModelConfig",
    "RopeScaling",
    "ServingConfig",
    "resolve_device",
    "__version__",
]
