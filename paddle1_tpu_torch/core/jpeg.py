"""Baseline JPEG codec in pure numpy (the port's copy of
``paddle1_tpu/core/jpeg.py``, host code, unchanged in its arithmetic).

Backs ``paddle.vision.ops.decode_jpeg`` (reference vision/ops.py
decode_jpeg over nvjpeg / operators/decode_jpeg_op.cu). The image has
no JPEG library (no PIL/cv2/torchvision), so the decoder is
implemented from the ITU-T.81 baseline process: marker parse → huffman
entropy decode → dequant → zigzag → 8x8 IDCT (exact DCT-III basis
matmul) → chroma upsample → YCbCr→RGB.
Sequential baseline DCT only (SOF0), the overwhelmingly common form
and the one the reference's nvjpeg path targets; progressive JPEGs
raise a teaching error. A matching encoder exists for tests and for
``encode_jpeg`` parity.
"""

from __future__ import annotations

import struct

import numpy as np

from .errors import InvalidArgumentError, UnimplementedError

__all__ = ["decode_jpeg_bytes", "encode_jpeg_bytes"]

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def _dct_basis():
    k = np.arange(8)
    n = np.arange(8)
    M = np.cos((2 * n[None, :] + 1) * k[:, None] * np.pi / 16)
    M[0] *= 1 / np.sqrt(2)
    return M * 0.5  # orthonormal scale


_M = _dct_basis()


def _idct2(blocks):
    """[N, 8, 8] coefficient blocks → spatial (DCT-III both axes)."""
    return np.einsum("ky,nkl,lx->nyx", _M, blocks, _M)


def _fdct2(blocks):
    """Forward: B = M A Mᵀ (the einsum transposes of _idct2)."""
    return np.einsum("ky,nyx,lx->nkl", _M, blocks, _M)


class _BitReader:
    """MSB-first bit reader over the entropy-coded segment with JPEG
    0xFF00 byte unstuffing and restart-marker awareness."""

    def __init__(self, data, pos):
        self.data = data
        self.pos = pos
        self.bits = 0
        self.nbits = 0

    def _next_byte(self):
        d = self.data
        while True:
            b = int(d[self.pos])  # python int: uint8 overflows EXTEND
            self.pos += 1
            if b == 0xFF:
                if int(d[self.pos]) == 0x00:
                    self.pos += 1
                    return 0xFF
                # a marker: signal end of segment to the caller
                self.pos -= 1
                raise _MarkerHit()
            return b

    def read_bit(self):
        if self.nbits == 0:
            self.bits = self._next_byte()
            self.nbits = 8
        self.nbits -= 1
        return (self.bits >> self.nbits) & 1

    def receive(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def align(self):
        self.nbits = 0


class _MarkerHit(Exception):
    pass


def _extend(v, t):
    """T.81 EXTEND: map the t-bit magnitude to its signed value."""
    return v if v >= (1 << (t - 1)) else v - (1 << t) + 1


class _Huff:
    """Canonical JPEG huffman table → (code-length run) decoder."""

    def __init__(self, counts, symbols):
        self.lookup = {}
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                self.lookup[(length, code)] = symbols[k]
                k += 1
                code += 1
            code <<= 1

    def decode(self, br):
        code = 0
        for length in range(1, 17):
            code = (code << 1) | br.read_bit()
            sym = self.lookup.get((length, code))
            if sym is not None:
                return int(sym)  # numpy uint8 would overflow EXTEND
        raise InvalidArgumentError("corrupt JPEG: bad huffman code")


def decode_jpeg_bytes(data: bytes) -> np.ndarray:
    """Decode baseline JPEG bytes → [H, W, C] uint8 (C = 1 or 3)."""
    d = np.frombuffer(data, np.uint8)
    if d.size < 4 or d[0] != 0xFF or d[1] != 0xD8:
        raise InvalidArgumentError("not a JPEG (missing SOI)")
    pos = 2
    qt = {}
    huff_dc, huff_ac = {}, {}
    frame = None
    restart_interval = 0
    while pos < d.size:
        if d[pos] != 0xFF:
            pos += 1
            continue
        marker = d[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:  # EOI
            break
        seg_len = struct.unpack(">H", d[pos:pos + 2].tobytes())[0]
        seg = d[pos + 2:pos + seg_len]
        if marker == 0xDB:  # DQT
            i = 0
            while i < seg.size:
                pq, tq = seg[i] >> 4, seg[i] & 0xF
                i += 1
                if pq:
                    tbl = d[pos + 2 + i:pos + 2 + i + 128].view(">u2")
                    i += 128
                else:
                    tbl = seg[i:i + 64]
                    i += 64
                qt[tq] = np.asarray(tbl, np.float64)
        elif marker in (0xC0, 0xC1):  # SOF0/1 baseline
            precision = seg[0]
            h = struct.unpack(">H", seg[1:3].tobytes())[0]
            w = struct.unpack(">H", seg[3:5].tobytes())[0]
            nc = int(seg[5])
            comps = []
            for c in range(nc):
                cid = int(seg[6 + 3 * c])
                hv = int(seg[7 + 3 * c])
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 0xF,
                              "q": int(seg[8 + 3 * c])})
            frame = {"h": h, "w": w, "comps": comps,
                     "precision": precision}
        elif marker in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA,
                        0xCB, 0xCD, 0xCE, 0xCF):
            raise UnimplementedError(
                "decode_jpeg: only baseline sequential DCT (SOF0/1) is "
                "implemented; this file uses a progressive/extended "
                "process")
        elif marker == 0xC4:  # DHT
            i = 0
            while i < seg.size:
                tc, th = seg[i] >> 4, seg[i] & 0xF
                counts = seg[i + 1:i + 17]
                n = int(counts.sum())
                symbols = seg[i + 17:i + 17 + n]
                tbl = _Huff(list(counts), list(symbols))
                (huff_dc if tc == 0 else huff_ac)[th] = tbl
                i += 17 + n
        elif marker == 0xDD:  # DRI
            restart_interval = struct.unpack(
                ">H", seg[:2].tobytes())[0]
        elif marker == 0xDA:  # SOS — entropy data follows
            ns = int(seg[0])
            scan = []
            for c in range(ns):
                cid = int(seg[1 + 2 * c])
                tt = int(seg[2 + 2 * c])
                comp = next(cc for cc in frame["comps"]
                            if cc["id"] == cid)
                scan.append({"comp": comp, "dc": tt >> 4,
                             "ac": tt & 0xF})
            data_start = pos + seg_len
            return _decode_scan(d, data_start, frame, scan, qt,
                                huff_dc, huff_ac, restart_interval)
        pos += seg_len
    raise InvalidArgumentError("corrupt JPEG: no scan data")


def _decode_scan(d, pos, frame, scan, qt, huff_dc, huff_ac,
                 restart_interval):
    h, w = frame["h"], frame["w"]
    hmax = max(c["h"] for c in frame["comps"])
    vmax = max(c["v"] for c in frame["comps"])
    mcus_x = -(-w // (8 * hmax))
    mcus_y = -(-h // (8 * vmax))
    planes = {}
    for sc in scan:
        c = sc["comp"]
        planes[c["id"]] = np.zeros(
            (mcus_y * c["v"] * 8, mcus_x * c["h"] * 8), np.float64)
    br = _BitReader(d, pos)
    pred = {sc["comp"]["id"]: 0 for sc in scan}
    mcu_count = 0
    for my in range(mcus_y):
        for mx in range(mcus_x):
            if restart_interval and mcu_count and \
                    mcu_count % restart_interval == 0:
                br.align()
                # skip the RSTn marker
                while d[br.pos] != 0xFF:
                    br.pos += 1
                br.pos += 2
                pred = {k: 0 for k in pred}
            for sc in scan:
                c = sc["comp"]
                for by in range(c["v"]):
                    for bx in range(c["h"]):
                        blk = _decode_block(
                            br, huff_dc[sc["dc"]], huff_ac[sc["ac"]],
                            pred, c["id"], qt[c["q"]])
                        y0 = (my * c["v"] + by) * 8
                        x0 = (mx * c["h"] + bx) * 8
                        planes[c["id"]][y0:y0 + 8, x0:x0 + 8] = blk
            mcu_count += 1
    # upsample + color transform
    out = []
    for sc in scan:
        c = sc["comp"]
        p = planes[c["id"]]
        ry, rx = vmax // c["v"], hmax // c["h"]
        if ry > 1 or rx > 1:
            p = np.repeat(np.repeat(p, ry, axis=0), rx, axis=1)
        out.append(p[:h, :w])
    if len(out) == 1:
        y = np.clip(out[0] + 128, 0, 255)
        return y[..., None].astype(np.uint8)
    y, cb, cr = out[0] + 128, out[1], out[2]
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.clip(np.stack([r, g, b], axis=-1), 0,
                   255).astype(np.uint8)


def _decode_block(br, hdc, hac, pred, cid, qtbl):
    coef = np.zeros(64, np.float64)
    try:
        t = hdc.decode(br)
        diff = _extend(br.receive(t), t) if t else 0
        pred[cid] += diff
        coef[0] = pred[cid]
        k = 1
        while k < 64:
            rs = hac.decode(br)
            r, s = rs >> 4, rs & 0xF
            if s == 0:
                if r == 15:
                    k += 16
                    continue
                break  # EOB
            k += r
            if k > 63:
                break
            coef[k] = _extend(br.receive(s), s)
            k += 1
    except _MarkerHit:
        pass
    dq = coef * qtbl
    block = np.zeros(64, np.float64)
    block[_ZIGZAG] = dq
    return _idct2(block.reshape(1, 8, 8))[0]


# -- encoder (tests + encode parity) ----------------------------------------

_STD_LUM_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
    92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100,
    103, 99], np.float64)

# K.3.3 default luminance huffman specs
_DC_COUNTS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_SYMS = list(range(12))
_AC_COUNTS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_AC_SYMS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
    0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
    0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
    0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
    0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
    0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA]


def _huff_codes(counts, symbols):
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (length, code)
            k += 1
            code += 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def write(self, length, code):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((code >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0x00)  # byte stuffing
                self.acc = 0
                self.n = 0

    def flush(self):
        while self.n:
            self.write(1, 1)  # pad with 1s per T.81


def _category(v):
    a = abs(int(v))
    t = 0
    while a:
        a >>= 1
        t += 1
    return t


def encode_jpeg_bytes(img: np.ndarray, quality: int = 75) -> bytes:
    """Encode [H, W, 1|3] uint8 → baseline JPEG (4:4:4, shared
    luminance tables — a simple, spec-valid encoder for tests and
    encode parity)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    scale = (5000 / quality if quality < 50 else 200 - 2 * quality) \
        / 100.0
    q = np.clip(np.round(_STD_LUM_Q * scale), 1, 255)
    if C == 3:
        r, g, b = (img[..., i].astype(np.float64) for i in range(3))
        y = 0.299 * r + 0.587 * g + 0.114 * b - 128
        cb = -0.168736 * r - 0.331264 * g + 0.5 * b
        cr = 0.5 * r - 0.418688 * g - 0.081312 * b
        planes = [y, cb, cr]
    else:
        planes = [img[..., 0].astype(np.float64) - 128]
    dcc = _huff_codes(_DC_COUNTS, _DC_SYMS)
    acc_ = _huff_codes(_AC_COUNTS, _AC_SYMS)
    bw = _BitWriter()
    # pad planes to 8
    ph = -(-H // 8) * 8
    pw = -(-W // 8) * 8
    padded = []
    for p in planes:
        pp = np.zeros((ph, pw))
        pp[:H, :W] = p
        pp[H:, :W] = p[-1:, :]
        pp[:, W:] = pp[:, W - 1:W]
        padded.append(pp)
    pred = [0] * len(planes)
    for by in range(ph // 8):
        for bx in range(pw // 8):
            for ci, p in enumerate(padded):
                blk = p[by * 8:(by + 1) * 8, bx * 8:(bx + 1) * 8]
                coef = _fdct2(blk[None])[0].reshape(64)
                # zigzag-ordered quantization (q is stored zigzag in
                # DQT, matching the decoder's direct multiply)
                zz = np.round(coef[_ZIGZAG] / q).astype(np.int64)
                diff = int(zz[0]) - pred[ci]
                pred[ci] = int(zz[0])
                t = _category(diff)
                bw.write(dcc[t][0], dcc[t][1])
                if t:
                    mag = diff if diff >= 0 else diff + (1 << t) - 1
                    bw.write(t, mag & ((1 << t) - 1))
                run = 0
                last_nz = 0
                for k in range(1, 64):
                    if zz[k]:
                        last_nz = k
                for k in range(1, last_nz + 1):
                    v = int(zz[k])
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        bw.write(acc_[0xF0][0], acc_[0xF0][1])
                        run -= 16
                    s = _category(v)
                    sym = (run << 4) | s
                    bw.write(acc_[sym][0], acc_[sym][1])
                    mag = v if v >= 0 else v + (1 << s) - 1
                    bw.write(s, mag & ((1 << s) - 1))
                    run = 0
                if last_nz < 63:
                    bw.write(acc_[0x00][0], acc_[0x00][1])  # EOB
    bw.flush()

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(
            ">H", len(payload) + 2) + payload
    out = bytearray(b"\xff\xd8")
    out += seg(0xDB, bytes([0]) + bytes(q.astype(np.uint8)))
    nc = len(planes)
    sof = bytes([8]) + struct.pack(">HH", H, W) + bytes([nc])
    for c in range(nc):
        sof += bytes([c + 1, 0x11, 0])
    out += seg(0xC0, sof)
    out += seg(0xC4, bytes([0x00] + _DC_COUNTS) + bytes(_DC_SYMS))
    out += seg(0xC4, bytes([0x10] + _AC_COUNTS) + bytes(_AC_SYMS))
    sos = bytes([nc])
    for c in range(nc):
        sos += bytes([c + 1, 0x00])
    sos += bytes([0, 63, 0])
    out += seg(0xDA, sos)
    out += bw.out
    out += b"\xff\xd9"
    return bytes(out)
