"""Image files without an imaging library: GIF89a and PNG in NumPy and the
standard library (``zlib``, ``struct``).

The JAX package writes its GIFs with imageio and its loss curve with
matplotlib; neither is on the hosts the port runs on, so the port writes
both formats itself.

- **GIF.** A looping GIF89a (the NETSCAPE2.0 block with loop count 0, as
  imageio's ``loop=0``), one global palette for every frame: the fixed
  6 x 7 x 6 colour cube (252 colours; red and blue in steps of 51, green in
  steps of 42.5), each channel rounded to its nearest level, no dithering
  (``quantize``). The LZW stream uses 9-bit codes only: a clear code before
  every 254 literals keeps the decoder's table below 512 entries, so the
  stream is packed in NumPy with no loop over pixels. The files are larger
  than a compressing encoder's.
- **PNG.** 8-bit RGB, no interlace, filter type 0 on every row, one zlib
  stream. ``read_png`` reads those files and refuses others, saying why.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

LEVELS = (6, 7, 6)                     # red, green, blue levels of the cube
_CLEAR, _END, _CHUNK = 256, 257, 254   # LZW clear and end codes; literals
                                       # between clear codes (9-bit codes)
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
DELAY_CS = 10                          # a GIF frame's hundredths of a second


def palette() -> np.ndarray:
    """The GIF palette, (256, 3) uint8: the colour cube, then black."""
    r, g, b = (np.round(np.arange(n) * 255.0 / (n - 1)) for n in LEVELS)
    cube = np.stack(np.meshgrid(r, g, b, indexing="ij"), -1).reshape(-1, 3)
    out = np.zeros((256, 3), np.uint8)
    out[:len(cube)] = cube
    return out


def quantize(img) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) palette indices, each channel rounded to
    its nearest level of the cube."""
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] < 3 or img.dtype != np.uint8:
        raise ValueError(f"frames are (H, W, 3) uint8, got {img.shape} "
                         f"{img.dtype}")
    q = [np.floor(img[..., c].astype(np.float64) * (n - 1) / 255.0 + 0.5)
         .astype(np.int64) for c, n in enumerate(LEVELS)]
    return ((q[0] * LEVELS[1] + q[1]) * LEVELS[2] + q[2]).astype(np.uint8)


def _sub_blocks(data: bytes) -> bytes:
    """Data split into GIF sub-blocks (a length byte and up to 255 bytes),
    then the zero-length terminator."""
    n = len(data)
    nb = max((n + 254) // 255, 1)
    body = np.zeros((nb, 256), np.uint8)
    body[:, 0] = 255
    flat = body[:, 1:].reshape(-1)
    flat[:n] = np.frombuffer(data, np.uint8)
    body[:, 1:] = flat.reshape(nb, 255)
    body[-1, 0] = n - 255 * (nb - 1)
    return body.reshape(-1)[:n + nb].tobytes() + b"\x00"


def _lzw(indices: np.ndarray) -> bytes:
    """The 8-bit indices as an LZW stream of 9-bit codes: a clear code,
    254 literals, a clear code, ..., the end code; packed LSB first."""
    idx = indices.reshape(-1).astype(np.int64)
    groups = max((len(idx) + _CHUNK - 1) // _CHUNK, 1)
    codes = np.full((groups, _CHUNK + 1), -1, np.int64)
    codes[:, 0] = _CLEAR
    lit = codes[:, 1:].reshape(-1)
    lit[:len(idx)] = idx
    codes[:, 1:] = lit.reshape(groups, _CHUNK)
    codes = np.append(codes[codes >= 0], _END)
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def write_gif(path, frames):
    """Write frames ((H, W, 3) uint8, all one size) as a GIF89a that
    loops forever (loop count 0), DELAY_CS hundredths of a second a
    frame."""
    frames = list(frames)
    if not frames:
        raise ValueError("a GIF needs at least one frame")
    h, w = np.asarray(frames[0]).shape[:2]
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0),
           palette().tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for frame in frames:
        if np.asarray(frame).shape[:2] != (h, w):
            raise ValueError("every frame of a GIF has the first's size")
        out += [b"\x21\xf9\x04\x00", struct.pack("<H", DELAY_CS),
                b"\x00\x00\x2c", struct.pack("<HHHHB", 0, 0, w, h, 0),
                b"\x08", _sub_blocks(_lzw(quantize(frame)))]
    out.append(b"\x3b")
    Path(path).write_bytes(b"".join(out))


def gif_info(path) -> dict:
    """Walk a GIF's blocks: {"size": (W, H), "frames": images, "loop":
    the NETSCAPE2.0 loop count or None}."""
    data = Path(path).read_bytes()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path} is not a GIF")
    w, h, packed = struct.unpack_from("<HHB", data, 6)
    pos = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)

    def skip_sub_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    frames, loop = 0, None
    while True:
        tag = data[pos]
        if tag == 0x3B:
            break
        if tag == 0x21:
            label = data[pos + 1]
            if label == 0xFF and data[pos + 3:pos + 14] == b"NETSCAPE2.0":
                loop = struct.unpack_from("<H", data, pos + 16)[0]
            pos = skip_sub_blocks(pos + 2)
        elif tag == 0x2C:
            local = data[pos + 9]
            pos += 10 + (3 << ((local & 7) + 1) if local & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)
            frames += 1
        else:
            raise ValueError(f"{path}: unknown GIF block 0x{tag:02x} at "
                             f"byte {pos}")
    return {"size": (w, h), "frames": frames, "loop": loop}


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path, img):
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"a PNG here is (H, W, 3) uint8, got {img.shape} "
                         f"{img.dtype}")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1)
    Path(path).write_bytes(
        _PNG_SIGNATURE
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _png_chunk(b"IEND", b""))


def read_png(path) -> np.ndarray:
    """Read a PNG that ``write_png`` wrote, as (H, W, 3) uint8. 8-bit RGB
    or RGBA (the alpha dropped) without interlace and with filter type 0 on
    every row; other PNGs raise ValueError: undoing the other filters is a
    loop over each row's pixels, which the port does not carry."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG")
    pos, header, idat = 8, None, []
    while pos < len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += n + 12
    w, h, depth, ctype, _, _, interlace = header
    channels = {2: 3, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace}; the port reads 8-bit RGB or RGBA PNGs without "
            "interlace, as its own writer makes them")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * channels)
    if raw[:, 0].any():
        raise ValueError(
            f"{path}: rows filtered with types "
            f"{sorted(set(raw[:, 0].tolist()) - {0})}; the port reads "
            "unfiltered rows (filter type 0) only, as its own writer makes")
    return raw[:, 1:].reshape(h, w, channels)[..., :3].copy()


def draw_curve(values) -> np.ndarray:
    """A line plot of ``values`` against their index as a 900 x 1200 RGB
    uint8 image (the JAX package's matplotlib figure: 4 x 3 in at 300 dpi):
    the curve in its colour (#c11221, 6 px wide) inside a black box, and no
    text. The box spans the index range and the finite values' range
    padded by 5 %; non-finite values break the line."""
    W, H = 1200, 900
    color, width = (193, 18, 33), 6
    img = np.full((H, W, 3), 255, np.uint8)
    left, right, top, bottom = 170, W - 40, 40, H - 130
    for x0, x1, y0, y1 in ((left, right, top, top + 3),
                           (left, right, bottom - 3, bottom),
                           (left, left + 3, top, bottom),
                           (right - 3, right, top, bottom)):
        img[y0:y1, x0:x1] = 0
    v = np.asarray(values, np.float64).reshape(-1)
    ok = np.isfinite(v)
    if not ok.any():
        return img
    lo, hi = v[ok].min(), v[ok].max()
    pad = 0.05 * (hi - lo) if hi > lo else max(abs(hi), 1.0) * 0.05
    lo, hi = lo - pad, hi + pad
    n = len(v)
    xs = left + 8 + (right - left - 16) * (
        np.arange(n) / (n - 1) if n > 1 else np.full(n, 0.5))
    ys = bottom - (bottom - top) * (np.where(ok, v, lo) - lo) / (hi - lo)
    # points along each segment with both ends finite, a pixel apart
    seg = np.flatnonzero(ok[:-1] & ok[1:])
    steps = np.ceil(np.hypot(xs[seg + 1] - xs[seg], ys[seg + 1] - ys[seg])
                    ).astype(np.int64) + 1
    k = np.repeat(np.arange(len(seg)), steps)
    t = (np.arange(len(k)) - np.repeat(np.cumsum(steps) - steps, steps)) \
        / np.repeat(np.maximum(steps - 1, 1), steps)
    px = np.concatenate([xs[seg[k]] + t * (xs[seg[k] + 1] - xs[seg[k]]),
                         xs[ok]])
    py = np.concatenate([ys[seg[k]] + t * (ys[seg[k] + 1] - ys[seg[k]]),
                         ys[ok]])
    r = width / 2
    off = np.arange(-int(r), int(r) + 1)
    dx, dy = np.meshgrid(off, off)
    disk = dx * dx + dy * dy <= r * r
    cx = (np.round(px)[:, None] + dx[disk][None]).astype(np.int64).reshape(-1)
    cy = (np.round(py)[:, None] + dy[disk][None]).astype(np.int64).reshape(-1)
    inb = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
    img[cy[inb], cx[inb]] = color
    return img
