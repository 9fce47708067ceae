"""Scene I/O: Wavefront .obj/.mtl geometry and the companion media .json
(counterpart of complex_materials_renderer_tpu/scene)."""

from .media import load_media_json, pack_media_buffer
from .medium import MediaTable
from .scene import Scene, load_scene

__all__ = ["MediaTable", "Scene", "load_scene", "load_media_json", "pack_media_buffer"]
