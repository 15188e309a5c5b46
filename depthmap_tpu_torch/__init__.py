"""depthmap_tpu_torch — the PyTorch + CUDA port of depthmap_tpu.

The JAX package (``depthmap_tpu``) stays the reference; this package mirrors
its layout (``ops/``, ``models/``, ``pipeline/``) so each module's
counterpart is easy to find.  Plain tensor code is PyTorch; the two Pallas
TPU kernels of the JAX package are hand-written CUDA C++ for Hopper
(``csrc/``), built with nvcc at first use into ``_build/``.

Nothing here imports jax, flax or depthmap_tpu: the few JAX-free pieces the
port needs (options, the model registry, the MiDaS resize rule, the custom
depthmap ingest) are restated, and tests hold them equal to the originals.
"""

__version__ = "0.1.0"

from depthmap_tpu_torch.options import GenerationOptions  # noqa: F401,E402
from depthmap_tpu_torch.registry import (MODELS, ModelSpec,  # noqa: F401,E402
                                         resolve_model_type)
