"""Radiance RGBE (.hdr) writer/reader.

Replaces stb_image_write's stbi_write_hdr (reference main.cpp:36-37,
386-390: 4-channel rgba32f readback written as <out>.hdr; the alpha channel
is dropped by the format). Output uses the adaptive-RLE scanline encoding
(the same family stb emits); the reader handles RLE and flat scanlines and
exists for round-trip tests and golden-image tooling.
"""

from __future__ import annotations

import numpy as np

from .. import native

_HEADER = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"


def float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) float32 -> (H, W, 4) uint8 shared-exponent encoding."""
    rgb = np.maximum(np.asarray(rgb, np.float32), 0.0)
    maxc = rgb.max(axis=-1)
    valid = maxc >= 1e-32
    mantissa, exponent = np.frexp(maxc)
    # scale maps the max channel to mantissa * 256.
    scale = np.where(valid, mantissa * 256.0 / np.where(valid, maxc, 1.0), 0.0)
    rgbe = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, exponent + 128, 0).astype(np.uint8)
    return rgbe


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    rgbe = np.asarray(rgbe, np.uint8)
    exponent = rgbe[..., 3].astype(np.int32)
    scale = np.where(exponent > 0, np.ldexp(1.0, exponent - 136), 0.0).astype(
        np.float32
    )
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _rle_encode_channel(data: np.ndarray) -> bytes:
    """Adaptive RLE for one channel of one scanline (new-style .hdr RLE):
    runs of >= 3 identical bytes become (count+128, value); other spans are
    literal blocks (count, bytes), both capped at 127/128."""
    out = bytearray()
    n = data.shape[0]
    # Run boundaries.
    if n == 0:
        return bytes(out)
    change = np.nonzero(np.diff(data))[0] + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [n]))
    lit_start = None

    def flush_literals(upto):
        nonlocal lit_start
        if lit_start is None:
            return
        i = lit_start
        while i < upto:
            count = min(128, upto - i)
            out.append(count)
            out.extend(data[i : i + count].tobytes())
            i += count
        lit_start = None

    for s, e in zip(starts, ends):
        run = e - s
        if run >= 3:
            flush_literals(s)
            i = s
            while i < e:
                count = min(127, e - i)
                out.append(128 + count)
                out.append(int(data[i]))
                i += count
        else:
            if lit_start is None:
                lit_start = s
    flush_literals(n)
    return bytes(out)


def write_hdr(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3) float32 radiance to ``path`` as Radiance RGBE.

    Written by the host library's C++ writer (native.py), as the JAX
    package writes with its own; under ``CMR_NO_NATIVE`` by the Python
    adaptive-RLE encoder below. Both give the bytes of the JAX package's
    writers (complex_materials_renderer_tpu/io/hdr.py).
    """
    image = np.asarray(image, np.float32)
    if image.ndim != 3 or image.shape[-1] not in (3, 4):
        raise ValueError(f"expected (H, W, 3[4]) image, got {image.shape}")
    image = image[..., :3]

    if not native.disabled():
        native.write_hdr(path, image)
        return

    height, width = image.shape[:2]
    rgbe = float_to_rgbe(image)

    with open(path, "wb") as f:
        f.write(_HEADER)
        f.write(f"-Y {height} +X {width}\n".encode())
        if width < 8 or width > 32767:
            f.write(rgbe.tobytes())
            return
        for y in range(height):
            # New-style RLE scanline marker: 0x02 0x02 hi lo.
            f.write(bytes((2, 2, (width >> 8) & 0xFF, width & 0xFF)))
            row = rgbe[y]
            for c in range(4):
                f.write(_rle_encode_channel(np.ascontiguousarray(row[:, c])))


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr into (H, W, 3) float32 (RLE or flat)."""
    with open(path, "rb") as f:
        raw = f.read()
    # Header ends at the first blank line; next line is the resolution.
    pos = 0
    lines = []
    while True:
        nl = raw.index(b"\n", pos)
        line = raw[pos:nl]
        pos = nl + 1
        if line == b"":
            break
        lines.append(line)
    nl = raw.index(b"\n", pos)
    res = raw[pos:nl].decode()
    pos = nl + 1
    parts = res.split()
    if parts[0] != "-Y" or parts[2] != "+X":
        raise ValueError(f"unsupported orientation: {res}")
    height, width = int(parts[1]), int(parts[3])

    data = np.frombuffer(raw, np.uint8, offset=pos)
    rgbe = np.zeros((height, width, 4), np.uint8)
    cursor = 0
    for y in range(height):
        if (
            width >= 8
            and width <= 32767
            and data[cursor] == 2
            and data[cursor + 1] == 2
            and (int(data[cursor + 2]) << 8 | int(data[cursor + 3])) == width
        ):
            cursor += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(data[cursor])
                    cursor += 1
                    if count > 128:
                        run = count - 128
                        rgbe[y, x : x + run, c] = data[cursor]
                        cursor += 1
                        x += run
                    else:
                        rgbe[y, x : x + count, c] = data[cursor : cursor + count]
                        cursor += count
                        x += count
        else:
            row = data[cursor : cursor + width * 4].reshape(width, 4)
            rgbe[y] = row
            cursor += width * 4
    return rgbe_to_float(rgbe)
