"""Image I/O: Radiance .hdr output and reading."""

from .hdr import read_hdr, write_hdr

__all__ = ["read_hdr", "write_hdr"]
