"""Rendering over several devices and processes: the frame's rows split
over a 'tile' axis and the samples over a 'sample' axis (sharding.py),
and one process per host joined by ``torch.distributed`` (multihost.py).

Counterpart of complex_materials_renderer_tpu/parallel/.
"""

from .sharding import RenderMesh, make_render_mesh, render_beauty_sharded

__all__ = ["RenderMesh", "make_render_mesh", "render_beauty_sharded"]
