"""16-bit grayscale depth video as an uncompressed AVI (stdlib + numpy).

Restated from ``depthmap_tpu/io/avi.py`` (held byte-equal by
tests/test_torch_port_video.py): a RIFF container with one rawvideo
stream whose FOURCC is ``Y16 `` (ffmpeg's ``gray16le``), frames stored
top-down, and an ``idx1`` index.  ``write_gray16_avi`` writes it;
``read_gray16_avi`` reads it back, or any rawvideo Y16 AVI, and returns
None for anything else.

Layout written:

    RIFF('AVI '
      LIST('hdrl'
        avih(MainAVIHeader)
        LIST('strl' strh(AVISTREAMHEADER vids/Y16 ) strf(BITMAPINFOHEADER)))
      LIST('movi' 00db(frame bytes) ...)
      idx1(index entries))
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10
_Y16 = b"Y16 "


def _fps_to_rate(fps: float) -> Tuple[int, int]:
    """(scale, rate) with fps = rate / scale, exact for common rates."""
    from fractions import Fraction
    fr = Fraction(fps).limit_denominator(65535)
    return fr.denominator, fr.numerator


def write_gray16_avi(frames: List[np.ndarray], fps: float,
                     out_path: str) -> None:
    """frames: list of (H, W) uint16 arrays, identical shapes."""
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape
    frame_bytes = w * h * 2
    n = len(frames)
    scale, rate = _fps_to_rate(fps)

    avih = struct.pack(
        "<14I",
        int(round(1e6 * scale / rate)),       # dwMicroSecPerFrame
        frame_bytes * max(1, int(round(fps))),  # dwMaxBytesPerSec
        0,                                    # dwPaddingGranularity
        _AVIF_HASINDEX,                       # dwFlags
        n, 0, 1,                              # frames, initial, streams
        frame_bytes,                          # dwSuggestedBufferSize
        w, h, 0, 0, 0, 0)                     # width, height, reserved[4]

    strh = struct.pack(
        "<4s4sI2H8I4h",
        b"vids", _Y16,
        0, 0, 0, 0,                           # flags, prio, lang, initial
        scale, rate, 0, n,                    # scale, rate, start, length
        frame_bytes, 0xFFFFFFFF, 0,           # bufsize, quality(-1), sampsz
        0, 0, w, h)                           # rcFrame

    strf = struct.pack(
        "<I2i2H2I2i2I",
        40, w, h,                             # biSize, biWidth, biHeight
        1, 16,                                # biPlanes, biBitCount
        struct.unpack("<I", _Y16)[0],         # biCompression = 'Y16 '
        frame_bytes,                          # biSizeImage
        0, 0, 0, 0)                           # ppm x/y, clrUsed, clrImp

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(kind: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", kind + payload)

    strl = lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf))
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + strl)

    movi_payload = bytearray(b"movi")
    idx = bytearray()
    for f in frames:
        if f.shape != (h, w):
            raise ValueError("frame shape mismatch")
        # dwChunkOffset: position of the chunk FOURCC relative to the
        # 'movi' FOURCC (the common convention; ffmpeg auto-detects base)
        idx += struct.pack("<4s3I", b"00db", _AVIIF_KEYFRAME,
                           len(movi_payload), frame_bytes)
        data = np.ascontiguousarray(f, dtype="<u2").tobytes()
        movi_payload += b"00db" + struct.pack("<I", frame_bytes) + data

    body = hdrl + chunk(b"LIST", bytes(movi_payload)) \
        + chunk(b"idx1", bytes(idx))
    with open(out_path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI " + body)


def read_gray16_avi(path: str):
    """Parse an AVI written by :func:`write_gray16_avi` (or any rawvideo
    Y16 AVI).  Returns (fps, [(H, W) uint16 frames]) or None when the file
    is not a Y16-rawvideo AVI."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return None
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        return None

    def walk(buf: bytes, pos: int, end: int):
        """Yield (fourcc, payload_start, payload_len) for chunks in buf.
        Stops at any chunk whose declared payload runs past the buffer
        (truncated/corrupt file) rather than yielding garbage offsets."""
        end = min(end, len(buf))
        while pos + 8 <= end:
            fourcc = buf[pos:pos + 4]
            (size,) = struct.unpack("<I", buf[pos + 4:pos + 8])
            if pos + 8 + size > end:
                return
            yield fourcc, pos + 8, size
            pos += 8 + size + (size % 2)

    w = h = None
    scale = rate = None
    is_y16 = False
    frames: List[np.ndarray] = []

    def parse_list(pos: int, end: int):
        nonlocal w, h, scale, rate, is_y16
        for fourcc, p, size in walk(data, pos, end):
            if fourcc == b"LIST":
                kind = data[p:p + 4]
                if kind in (b"hdrl", b"strl"):
                    parse_list(p + 4, p + size)
                elif kind == b"movi":
                    for cf, cp, cs in walk(data, p + 4, p + size):
                        if cf[2:4] in (b"db", b"dc") and cs:
                            frames.append((cp, cs))
            elif fourcc == b"strh" and size >= 32:
                fcc_type, handler = data[p:p + 4], data[p + 4:p + 8]
                if fcc_type == b"vids":
                    scale, rate = struct.unpack("<2I", data[p + 20:p + 28])
                    if handler == _Y16:
                        is_y16 = True
            elif fourcc == b"strf" and size >= 20:
                bw, bh = struct.unpack("<2i", data[p + 4:p + 12])
                bits, = struct.unpack("<H", data[p + 14:p + 16])
                comp = data[p + 16:p + 20]
                if comp == _Y16 and bits == 16:
                    is_y16 = True
                    w, h = bw, abs(bh)

    try:
        parse_list(12, len(data))
    except (struct.error, ValueError):   # corrupt header fields
        return None
    if not is_y16 or not w or not h or not frames:
        return None
    fps = (rate / scale) if (rate and scale) else 24.0
    out = []
    for pos, size in frames:
        if size != w * h * 2 or pos + size > len(data):
            return None
        arr = np.frombuffer(data, dtype="<u2", count=w * h, offset=pos)
        out.append(arr.reshape(h, w).astype(np.uint16))
    return fps, out
