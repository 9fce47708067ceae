"""Authoring and checking tools: media-JSON authoring (mat_parser), the
scene generators (make_showcase, make_scenes), the .hdr comparison
(compare) and the golden-image corpus (goldens). The port's counterparts
of complex_materials_renderer_tpu/tools/, with the same functions and
command lines; the numpy-only ones are the port's own copies."""
