"""cold_compress_tpu_torch: the KV-cache-compression generation engine in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``cold_compress_tpu`` (JAX/Pallas), which stays in the repository
as the reference. Importing this package imports neither JAX nor the JAX
package, and builds no kernel: kernels are compiled with ``nvcc`` at their
first launch (``ops/_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise (``resolve_device``).
"""

from .device import resolve_device
from .models.config import MODEL_CONFIGS, ModelConfig, RopeScaling

__all__ = ["MODEL_CONFIGS", "ModelConfig", "RopeScaling", "resolve_device"]
