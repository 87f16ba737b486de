"""Canvas: float32 image buffer with PPM encode/decode and Bayer dithering.

Counterpart of ``raytracer_tpu/canvas.py``: the bytes it writes are
identical. The encode path reproduces the reference's quantization
(canvas.rs:57-84): clamp to [0,1], multiply by 255 and round
half-away-from-zero to u8, written as ASCII (P3) with maxval 255. Decoding
normalizes samples by the header maxval (canvas.rs:86-107). The ASCII
codec runs through the native library (:mod:`raytracer_tpu_torch.native`)
when it builds, else through the numpy code here, its plain version.

Dithering reproduces src/effects/dithering.rs:12-37 + canvas.rs:37-55:
recursive Bayer matrix construction indexed ``bayer[x % N][y % N]`` with x
the pixel column, black/white threshold mode or additive color mode.
"""

from __future__ import annotations

import io

import numpy as np

__all__ = ["Canvas", "bayer_matrix", "quantize_u8", "to_ppm_bytes",
           "to_p6_bytes", "from_ppm_bytes"]


def bayer_matrix(n: int) -> np.ndarray:
    """Normalized n×n Bayer matrix, n a power of two >= 2."""
    if n < 2 or (n & (n - 1)) != 0:
        raise ValueError("N must be a power of 2 and >= 2")
    m = np.array([[0.0, 2.0], [3.0, 1.0]], dtype=np.float32)
    size = 2
    while size < n:
        m4 = m[:size, :size] * 4.0
        top = np.concatenate([m4, m4 + 2.0], axis=1)
        bottom = np.concatenate([m4 + 3.0, m4 + 1.0], axis=1)
        m = np.concatenate([top, bottom], axis=0)
        size *= 2
    return (m / float(n * n)).astype(np.float32)


def quantize_u8(pixels: np.ndarray) -> np.ndarray:
    """f32 [...,3] -> u8 with the reference's clamp + round-half-up."""
    clamped = np.clip(pixels.astype(np.float32), 0.0, 1.0)
    return np.floor(clamped * 255.0 + 0.5).astype(np.uint8)


def to_ppm_bytes(pixels: np.ndarray) -> bytes:
    """ASCII P3 PPM, maxval 255. ``pixels`` is [h, w, 3] float32, or u8
    already quantized (``render(..., quantize=True)``)."""
    from raytracer_tpu_torch import native

    h, w = pixels.shape[:2]
    q = pixels if pixels.dtype == np.uint8 else quantize_u8(pixels)
    q = q.reshape(-1)
    header = f"P3\n{w} {h}\n255\n".encode()
    body = native.ppm_encode_body(q)
    if body is not None:
        out = header + body
        return out if out.endswith(b"\n") else out + b"\n"
    text = "\n".join(
        " ".join(chunk) for chunk in _chunked(q.astype(str), 15)
    )
    return header + text.encode() + b"\n"


def to_p6_bytes(pixels: np.ndarray) -> bytes:
    """Binary P6 PPM, maxval 255."""
    h, w = pixels.shape[:2]
    q = pixels if pixels.dtype == np.uint8 else quantize_u8(pixels)
    return f"P6\n{w} {h}\n255\n".encode() + np.ascontiguousarray(q).tobytes()


def _chunked(arr, size):
    for i in range(0, len(arr), size):
        yield arr[i : i + size]


def from_ppm_bytes(data: bytes) -> np.ndarray:
    """Parse P3/P6 PPM -> float32 [h, w, 3] normalized by maxval."""
    if data[:2] == b"P6":
        return _parse_p6(data)
    if data[:2] != b"P3":
        raise ValueError("Not a P3/P6 PPM file")
    # the native integer scanner skips whitespace and '#' comments, not
    # the 'P3' magic
    from raytracer_tpu_torch import native

    head = native.ppm_decode_samples(data[2:], 3)
    if head is not None and len(head) == 3:
        w, h, maxval = (int(x) for x in head)
        vals = native.ppm_decode_samples(data[2:], 3 + w * h * 3)
        samples = vals[3:].astype(np.float32)
        if samples.size != w * h * 3:
            raise ValueError("Truncated PPM body")
        return (samples / float(maxval)).reshape(h, w, 3)
    tokens = _ppm_tokens(data)
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    samples = np.array(tokens[4 : 4 + w * h * 3], dtype=np.float32)
    if samples.size != w * h * 3:
        raise ValueError("Truncated PPM body")
    return (samples / float(maxval)).reshape(h, w, 3)


def _ppm_tokens(data: bytes):
    # strip comments
    lines = []
    for line in data.split(b"\n"):
        hash_pos = line.find(b"#")
        lines.append(line if hash_pos < 0 else line[:hash_pos])
    return b"\n".join(lines).split()


def _parse_p6(data: bytes) -> np.ndarray:
    # Header: P6 <w> <h> <maxval> then single whitespace byte, then binary.
    pos = 2
    fields = []
    while len(fields) < 3:
        # skip whitespace and comments
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    pos += 1  # single whitespace after maxval
    w, h, maxval = fields
    dtype = np.uint8 if maxval < 256 else ">u2"
    raw = np.frombuffer(data, dtype=dtype, count=w * h * 3, offset=pos)
    return (raw.astype(np.float32) / float(maxval)).reshape(h, w, 3)


class Canvas:
    """Image buffer: float32 [height, width, 3]."""

    def __init__(self, width: int, height: int, pixels: np.ndarray | None = None):
        if pixels is None:
            pixels = np.zeros((height, width, 3), dtype=np.float32)
        pixels = np.asarray(pixels)
        if pixels.dtype == np.uint8:
            # a quantized render: exact on the way back out (k/255 -> k)
            pixels = pixels.astype(np.float32) / 255.0
        self.pixels = np.asarray(pixels, dtype=np.float32)
        if self.pixels.shape != (height, width, 3):
            raise ValueError(
                f"pixels {self.pixels.shape} != ({height}, {width}, 3)")

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    def write_pixel(self, x: int, y: int, color) -> None:
        self.pixels[y, x] = color

    def pixel_at(self, x: int, y: int):
        return self.pixels[y, x]

    def apply_dithering(self, n: int, colored: bool = False) -> None:
        bayer = bayer_matrix(n)
        h, w = self.height, self.width
        xs = np.arange(w) % n
        ys = np.arange(h) % n
        # reference indexes bayer[x % N][y % N] with x = column (canvas.rs:41)
        d = bayer[xs[None, :].repeat(h, 0), ys[:, None].repeat(w, 1)]
        if colored:
            self.pixels = self.pixels + d[..., None]
        else:
            below = (self.pixels < d[..., None]).any(axis=-1)
            self.pixels = np.where(
                below[..., None], np.zeros_like(self.pixels),
                np.ones_like(self.pixels),
            )

    def to_ppm(self, writer) -> None:
        data = to_ppm_bytes(self.pixels)
        if hasattr(writer, "buffer"):
            writer.buffer.write(data)
        elif isinstance(writer, io.TextIOBase):
            writer.write(data.decode())
        else:
            writer.write(data)

    @classmethod
    def from_ppm(cls, reader) -> "Canvas":
        data = reader.read() if hasattr(reader, "read") else bytes(reader)
        if isinstance(data, str):
            data = data.encode()
        pixels = from_ppm_bytes(data)
        return cls(pixels.shape[1], pixels.shape[0], pixels)
