"""complex_materials_renderer_tpu_torch — the volumetric path tracer of
``complex_materials_renderer_tpu`` ported to PyTorch and CUDA.

The JAX package beside it stays the reference. This package imports
``torch`` and never ``jax``; its path-tracing kernel is hand-written CUDA
for Hopper (``csrc/``), built with ``nvcc`` at first use. Entry points run
on the CUDA card unless the caller asks for the CPU (``device="cpu"``,
``--device cpu``), where each kernel's plain PyTorch version runs.
"""

__version__ = "0.1.0"

from .config import RenderOptions

__all__ = ["RenderOptions", "__version__"]
