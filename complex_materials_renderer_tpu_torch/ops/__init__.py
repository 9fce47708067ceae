"""Per-lane ops shared by the kernels' plain versions and the render loop."""
