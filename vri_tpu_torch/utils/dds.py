# Copy of vri_tpu/utils/dds.py for the port; only the imports differ.
"""Minimal self-contained DDS reader: BC1/BC2/BC3 + uncompressed RGB(A).

TPU analog of the reference's DDS ingest (Source/Material.cpp:109-139):
there the blocks stay GPU-native (dds::readFile -> VkFormat, Vulkan
samples BC textures in hardware).  The TPU samples from a unified float
texture table (ops/texture.py) instead, so compressed blocks are decoded
ONCE at ingest — vectorized with numpy over all blocks at once, no
per-texel Python.

Supported: DXT1/BC1 (with 1-bit punch-through alpha), DXT3/BC2,
DXT5/BC3, DX10-header variants (DXGI BC1/BC2/BC3/RGBA8/BGRA8), and
mask-based uncompressed 24/32-bit RGB(A).  Only the top mip is read
(the mip pyramid is rebuilt on device by ops/texture.build_mip_atlas).
"""

from __future__ import annotations

import struct

import numpy as np

_DDPF_ALPHAPIXELS = 0x1
_DDPF_FOURCC = 0x4
_DDPF_RGB = 0x40

_DXGI_BC1 = (70, 71, 72)
_DXGI_BC2 = (73, 74, 75)
_DXGI_BC3 = (76, 77, 78)
_DXGI_RGBA8 = (27, 28, 29, 30)
_DXGI_BGRA8 = (87, 88, 90, 91)


class DdsError(ValueError):
    pass


def _expand565(c: np.ndarray) -> np.ndarray:
    """(N,) uint16 RGB565 -> (N, 3) uint8 (with low-bit replication)."""
    r = ((c >> 11) & 0x1F).astype(np.uint16)
    g = ((c >> 5) & 0x3F).astype(np.uint16)
    b = (c & 0x1F).astype(np.uint16)
    return np.stack([(r << 3) | (r >> 2),
                     (g << 2) | (g >> 4),
                     (b << 3) | (b >> 2)], axis=1).astype(np.uint8)


def _bc1_palette(c0: np.ndarray, c1: np.ndarray):
    """Per-block 4-entry color palette -> ((N,4,3) uint8, (N,4) alpha)."""
    p0 = _expand565(c0).astype(np.int32)
    p1 = _expand565(c1).astype(np.int32)
    four = (c0 > c1)[:, None]            # 4-color (opaque) mode
    e2 = np.where(four, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    e3 = np.where(four, (p0 + 2 * p1) // 3, 0)
    pal = np.stack([p0, p1, e2, e3], axis=1).astype(np.uint8)   # (N,4,3)
    alpha = np.full((len(c0), 4), 255, np.uint8)
    alpha[:, 3] = np.where(four[:, 0], 255, 0)  # 3-color mode: idx3 = clear
    return pal, alpha


def _bc1_indices(words: np.ndarray) -> np.ndarray:
    """(N,) uint32 packed 2-bit selectors -> (N, 16) int (texel order)."""
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    return ((words[:, None] >> shifts) & 0x3).astype(np.int64)


def _decode_bc1(data: np.ndarray, punch_alpha: bool = True):
    """(N, 8) uint8 BC1 blocks -> ((N, 16, 3) rgb, (N, 16) alpha)."""
    c0 = data[:, 0].astype(np.uint16) | (data[:, 1].astype(np.uint16) << 8)
    c1 = data[:, 2].astype(np.uint16) | (data[:, 3].astype(np.uint16) << 8)
    words = (data[:, 4].astype(np.uint32)
             | (data[:, 5].astype(np.uint32) << 8)
             | (data[:, 6].astype(np.uint32) << 16)
             | (data[:, 7].astype(np.uint32) << 24))
    pal, pal_a = _bc1_palette(c0, c1)
    idx = _bc1_indices(words)                       # (N, 16)
    rows = np.arange(len(data))[:, None]
    rgb = pal[rows, idx]                            # (N, 16, 3)
    alpha = (pal_a[rows, idx] if punch_alpha
             else np.full(idx.shape, 255, np.uint8))
    return rgb, alpha


def _decode_bc3_alpha(data: np.ndarray) -> np.ndarray:
    """(N, 8) uint8 BC3/BC4 alpha blocks -> (N, 16) uint8."""
    a0 = data[:, 0].astype(np.int32)
    a1 = data[:, 1].astype(np.int32)
    # 48-bit selector field, 3 bits per texel
    bits = np.zeros(len(data), np.uint64)
    for i in range(6):
        bits |= data[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
    shifts = (3 * np.arange(16, dtype=np.uint64))[None, :]
    idx = ((bits[:, None] >> shifts) & np.uint64(0x7)).astype(np.int64)
    eight = (a0 > a1)[:, None]
    pal = np.zeros((len(data), 8), np.int32)
    pal[:, 0] = a0
    pal[:, 1] = a1
    for i in range(1, 7):       # interpolated entries 2..7
        pal[:, 1 + i] = np.where(
            eight[:, 0], ((7 - i) * a0 + i * a1) // 7,
            ((5 - i) * a0 + i * a1) // 5 if i <= 4 else 0)
    # 6-interp mode overrides entries 6, 7 with 0 / 255
    pal[:, 6] = np.where(eight[:, 0], pal[:, 6], 0)
    pal[:, 7] = np.where(eight[:, 0], pal[:, 7], 255)
    rows = np.arange(len(data))[:, None]
    return pal[rows, idx].astype(np.uint8)


def _blocks_to_image(rgb: np.ndarray, alpha: np.ndarray,
                     height: int, width: int) -> np.ndarray:
    """Reassemble per-block texels (N,16,*) into an (H, W, 4) image."""
    bw = (width + 3) // 4
    bh = (height + 3) // 4
    rgba = np.concatenate([rgb, alpha[..., None]], axis=-1)  # (N, 16, 4)
    img = rgba.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4) \
        .reshape(bh * 4, bw * 4, 4)
    return img[:height, :width]


def read_dds(path: str) -> np.ndarray:
    """Read a .dds file -> (H, W, 4) uint8 RGBA (top mip only)."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 128 or raw[:4] != b"DDS ":
        raise DdsError(f"not a DDS file: {path}")
    (size, _flags, height, width, _pitch, _depth, _mips) = \
        struct.unpack_from("<7I", raw, 4)
    if size != 124:
        raise DdsError(f"bad DDS header size {size}")
    (pf_size, pf_flags, fourcc, bitcount, rmask, gmask, bmask, amask) = \
        struct.unpack_from("<2I4s5I", raw, 76)
    if pf_size != 32:
        raise DdsError(f"bad DDS pixel-format size {pf_size}")
    off = 128
    codec = None
    if pf_flags & _DDPF_FOURCC:
        if fourcc == b"DX10":
            (dxgi, _dim, _misc, _asize, _misc2) = \
                struct.unpack_from("<5I", raw, 128)
            off = 148
            if dxgi in _DXGI_BC1:
                codec = "bc1"
            elif dxgi in _DXGI_BC2:
                codec = "bc2"
            elif dxgi in _DXGI_BC3:
                codec = "bc3"
            elif dxgi in _DXGI_RGBA8:
                codec, rmask, gmask, bmask, amask, bitcount = \
                    "raw", 0xFF, 0xFF00, 0xFF0000, 0xFF000000, 32
            elif dxgi in _DXGI_BGRA8:
                codec, rmask, gmask, bmask, amask, bitcount = \
                    "raw", 0xFF0000, 0xFF00, 0xFF, 0xFF000000, 32
            else:
                raise DdsError(f"unsupported DXGI format {dxgi}")
        elif fourcc == b"DXT1":
            codec = "bc1"
        elif fourcc in (b"DXT2", b"DXT3"):
            codec = "bc2"
        elif fourcc in (b"DXT4", b"DXT5"):
            codec = "bc3"
        else:
            raise DdsError(f"unsupported fourCC {fourcc!r}")
    elif pf_flags & _DDPF_RGB:
        codec = "raw"
        if not pf_flags & _DDPF_ALPHAPIXELS:
            amask = 0
    else:
        raise DdsError(f"unsupported DDS pixel format flags {pf_flags:#x}")

    bw, bh = (width + 3) // 4, (height + 3) // 4
    n_blocks = bw * bh
    if codec == "bc1":
        need = n_blocks * 8
        blocks = np.frombuffer(raw, np.uint8, need, off).reshape(-1, 8)
        rgb, alpha = _decode_bc1(blocks)
        return _blocks_to_image(rgb, alpha, height, width)
    if codec == "bc2":
        need = n_blocks * 16
        blocks = np.frombuffer(raw, np.uint8, need, off).reshape(-1, 16)
        rgb, _ = _decode_bc1(blocks[:, 8:], punch_alpha=False)
        # explicit 4-bit alpha, little-endian nibbles in texel order
        nib = blocks[:, :8]
        lo = (nib & 0xF).astype(np.uint16)
        hi = (nib >> 4).astype(np.uint16)
        a4 = np.stack([lo, hi], axis=2).reshape(-1, 16)
        alpha = ((a4 * 255) // 15).astype(np.uint8)
        return _blocks_to_image(rgb, alpha, height, width)
    if codec == "bc3":
        need = n_blocks * 16
        blocks = np.frombuffer(raw, np.uint8, need, off).reshape(-1, 16)
        rgb, _ = _decode_bc1(blocks[:, 8:], punch_alpha=False)
        alpha = _decode_bc3_alpha(blocks[:, :8])
        return _blocks_to_image(rgb, alpha, height, width)

    # uncompressed, mask-based
    if bitcount not in (24, 32):
        raise DdsError(f"unsupported uncompressed bit count {bitcount}")
    bpp = bitcount // 8
    need = height * width * bpp
    data = np.frombuffer(raw, np.uint8, need, off) \
        .reshape(height, width, bpp).astype(np.uint32)
    pixels = np.zeros((height, width), np.uint32)
    for i in range(bpp):
        pixels |= data[..., i] << np.uint32(8 * i)

    def channel(mask: int, default: int) -> np.ndarray:
        if mask == 0:
            return np.full((height, width), default, np.uint8)
        shift = (mask & -mask).bit_length() - 1
        width_bits = int(mask >> shift).bit_length()
        v = (pixels & np.uint32(mask)) >> np.uint32(shift)
        if width_bits < 8:          # replicate to 8 bits
            v = (v * 255) // ((1 << width_bits) - 1)
        return v.astype(np.uint8)

    return np.stack([channel(rmask, 0), channel(gmask, 0),
                     channel(bmask, 0), channel(amask, 255)], axis=-1)
