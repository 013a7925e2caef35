"""Minimal OpenEXR 2.0 scanline codec in pure Python/numpy.

TPU-native replacement for the EXR paths of Mitsuba's Bitmap class
(src/libcore/bitmap.cpp, which links the OpenEXR library).  Supports
single-part scanline images, FLOAT/HALF channels, NONE/ZIPS/ZIP
compression — enough for film output (-primal/-dx/-dy/-final.exr),
texture/envmap input, and round-tripping reference images.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
PT_UINT, PT_HALF, PT_FLOAT = 0, 1, 2
C_NONE, C_RLE, C_ZIPS, C_ZIP, C_PIZ = 0, 1, 2, 3, 4
_LINES_PER_BLOCK = {C_NONE: 1, C_ZIPS: 1, C_ZIP: 16}
_PT_DTYPE = {PT_HALF: np.float16, PT_FLOAT: np.float32, PT_UINT: np.uint32}
_PT_SIZE = {PT_HALF: 2, PT_FLOAT: 4, PT_UINT: 4}


def _predictor_encode(buf: bytes) -> bytes:
    a = np.frombuffer(buf, np.uint8)
    n = len(a)
    half = (n + 1) // 2
    t = np.empty(n, np.uint8)
    t[:half] = a[0::2]
    t[half:] = a[1::2]
    d = t.astype(np.int16)
    d[1:] = d[1:] - d[:-1] + (128 + 256)
    return d.astype(np.uint8).tobytes()


def _predictor_decode(buf: bytes) -> bytes:
    d = np.frombuffer(buf, np.uint8).astype(np.int64)
    d[1:] -= (128 + 256)
    t = np.cumsum(d).astype(np.uint8)
    n = len(t)
    half = (n + 1) // 2
    a = np.empty(n, np.uint8)
    a[0::2] = t[:half]
    a[1::2] = t[half:]
    return a.tobytes()


def _write_attr(f, name: str, typ: str, data: bytes):
    f.write(name.encode() + b"\0" + typ.encode() + b"\0")
    f.write(struct.pack("<i", len(data)))
    f.write(data)


def write(path, img, channels=("R", "G", "B"), half: bool = True,
          compression: int = C_ZIP):
    """Write [H, W, C] (or [H, W]) float array as single-part scanline EXR."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    assert c == len(channels), (img.shape, channels)
    pt = PT_HALF if half else PT_FLOAT
    dtype = _PT_DTYPE[pt]
    # channels must be stored in alphabetical order within each scanline
    order = np.argsort(np.array(channels, dtype=object)).tolist()

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", MAGIC, 2))
        chl = b""
        for i in order:
            chl += channels[i].encode() + b"\0"
            chl += struct.pack("<i", pt) + b"\0\0\0\0" + struct.pack("<ii", 1, 1)
        chl += b"\0"
        _write_attr(f, "channels", "chlist", chl)
        _write_attr(f, "compression", "compression", struct.pack("<B", compression))
        box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
        _write_attr(f, "dataWindow", "box2i", box)
        _write_attr(f, "displayWindow", "box2i", box)
        _write_attr(f, "lineOrder", "lineOrder", struct.pack("<B", 0))
        _write_attr(f, "pixelAspectRatio", "float", struct.pack("<f", 1.0))
        _write_attr(f, "screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
        _write_attr(f, "screenWindowWidth", "float", struct.pack("<f", 1.0))
        f.write(b"\0")

        lpb = _LINES_PER_BLOCK[compression]
        nblocks = (h + lpb - 1) // lpb
        offset_table_pos = f.tell()
        f.write(b"\0" * (8 * nblocks))
        offsets = []
        data16 = img.astype(dtype)
        for b in range(nblocks):
            y0 = b * lpb
            y1 = min(y0 + lpb, h)
            raw = b"".join(
                data16[y, :, i].tobytes()
                for y in range(y0, y1) for i in order)
            if compression in (C_ZIPS, C_ZIP):
                comp = zlib.compress(_predictor_encode(raw))
                if len(comp) >= len(raw):
                    comp = raw
            else:
                comp = raw
            offsets.append(f.tell())
            f.write(struct.pack("<ii", y0, len(comp)))
            f.write(comp)
        f.seek(offset_table_pos)
        f.write(struct.pack("<%dQ" % nblocks, *offsets))


def _read_attrs(f):
    attrs = {}
    while True:
        name = b""
        while True:
            ch = f.read(1)
            if ch == b"\0":
                break
            name += ch
        if name == b"":
            break
        typ = b""
        while True:
            ch = f.read(1)
            if ch == b"\0":
                break
            typ += ch
        size = struct.unpack("<i", f.read(4))[0]
        attrs[name.decode()] = (typ.decode(), f.read(size))
    return attrs


def _parse_chlist(data: bytes):
    chans = []
    pos = 0
    while data[pos] != 0:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode()
        pos = end + 1
        pt, = struct.unpack_from("<i", data, pos)
        xs, ys = struct.unpack_from("<ii", data, pos + 8)
        pos += 16
        chans.append((name, pt, xs, ys))
    return chans


def read(path):
    """Read a single-part scanline EXR. Returns (dict name->[H,W] f32, header)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        assert magic == MAGIC, f"not an EXR file: {path}"
        if version & 0x200:
            raise NotImplementedError("multi-part EXR not supported")
        if version & 0x800:
            raise NotImplementedError("deep EXR not supported")
        attrs = _read_attrs(f)
        chans = _parse_chlist(attrs["channels"][1])
        comp = attrs["compression"][1][0]
        if comp == C_RLE:
            raise NotImplementedError("RLE EXR compression not supported")
        if comp not in _LINES_PER_BLOCK:
            raise NotImplementedError(
                f"EXR compression {comp} not supported (use none/zip/zips)")
        x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
        w, h = x1 - x0 + 1, y1 - y0 + 1
        lpb = _LINES_PER_BLOCK[comp]
        nblocks = (h + lpb - 1) // lpb
        f.read(8 * nblocks)  # offset table (we read sequentially)

        out = {name: np.empty((h, w), np.float32) for name, _, _, _ in chans}
        bytes_per_line = sum(_PT_SIZE[pt] * w for _, pt, _, _ in chans)
        for _ in range(nblocks):
            y, size = struct.unpack("<ii", f.read(8))
            payload = f.read(size)
            ny = min(lpb, y1 - (y0 + (y - y0)) + 1, h - (y - y0))
            expect = bytes_per_line * ny
            if comp in (C_ZIPS, C_ZIP) and size != expect:
                payload = _predictor_decode(zlib.decompress(payload))
            pos = 0
            for line in range(ny):
                for name, pt, _, _ in chans:
                    nb = _PT_SIZE[pt] * w
                    arr = np.frombuffer(payload[pos:pos + nb], _PT_DTYPE[pt])
                    out[name][y - y0 + line] = arr.astype(np.float32)
                    pos += nb
        return out, attrs


def read_rgb(path):
    """Read as [H, W, 3] f32 (Y-only images are broadcast)."""
    chans, _ = read(path)
    if all(k in chans for k in "RGB"):
        return np.stack([chans["R"], chans["G"], chans["B"]], axis=-1)
    if "Y" in chans:
        return np.repeat(chans["Y"][..., None], 3, axis=-1)
    first = next(iter(chans.values()))
    return np.repeat(first[..., None], 3, axis=-1)
