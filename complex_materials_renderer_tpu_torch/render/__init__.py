"""Rendering: scene tables and the megakernel beauty-pass loop."""
