"""Image codec of the port: the reference's wire format, plus the device-side
stitch and deprocess (counterpart of ``deconv_api_tpu/serving/codec.py``).

Host side: data-URL -> BGR uint8 decode, resize to the model's input size
with cv2's bilinear, Keras caffe or 'tf'-mode preprocessing, and JPEG ->
base64 -> percent-quoted data URL under the reference's ``data:image/webp``
prefix.

The host codec uses cv2 where it imports, else Pillow for decode and
encode, else its own numpy code: a PNG decoder (zlib + unfiltering), a
bilinear resize that reproduces cv2's INTER_LINEAR fixed-point arithmetic
bit for bit on uint8, and a baseline JPEG encoder.  ``backend()`` names the
one in use.  The resize never goes through Pillow, whose bilinear differs
from cv2's.

Device side: ``stitch_grid`` zeroes the tiles that did not fire, stitches
the top 4 into a 2x2 grid and deprocesses the whole grid to uint8 (the
reference's order); ``deprocess_tiles`` deprocesses each projection alone
(the ``/v1/deconv`` presentation).
"""

from __future__ import annotations

import base64
import functools
import struct
import zlib

import numpy as np
import torch

# Keras caffe-mode ImageNet means, BGR order
CAFFE_MEANS_BGR = np.array([103.939, 116.779, 123.68], dtype=np.float32)
EPSILON = 1e-7  # K.epsilon() in the reference's deprocess
_JPEG_QUALITY = 95  # cv2.imencode's default, which the reference uses


class CodecError(ValueError):
    """Malformed image payload (bad base64 / undecodable image)."""


@functools.cache
def backend() -> str:
    """'cv2', 'pil' or 'numpy': the first host codec that imports."""
    try:
        import cv2  # noqa: F401

        return "cv2"
    except ImportError:
        pass
    try:
        import PIL.Image  # noqa: F401

        return "pil"
    except ImportError:
        return "numpy"


# --- host codec ---------------------------------------------------------------


def decode_data_url(uri: str) -> np.ndarray:
    """data-URI (or bare base64) -> BGR uint8 HWC array."""
    payload = uri.split(",", 1)[1] if "," in uri else uri
    try:
        raw = base64.b64decode(payload, validate=False)
    except ValueError as e:
        raise CodecError(f"invalid base64 image payload: {e}") from e
    if not raw:
        raise CodecError("empty image payload after base64 decode")
    kind = backend()
    if kind == "cv2":
        import cv2

        try:
            img = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
        except cv2.error as e:
            raise CodecError(f"could not decode image bytes: {e}") from e
        if img is None:
            raise CodecError("could not decode image bytes")
        return img
    if kind == "pil":
        import io

        from PIL import Image, UnidentifiedImageError

        try:
            pil = Image.open(io.BytesIO(raw)).convert("RGB")
        except (UnidentifiedImageError, OSError) as e:
            raise CodecError(f"could not decode image bytes: {e}") from e
        return np.asarray(pil)[:, :, ::-1]
    return decode_png(raw)


def resize224(img: np.ndarray, size: tuple[int, int] = (224, 224)) -> np.ndarray:
    """Bilinear resize to ``size`` (width, height), as ``cv2.resize``."""
    if backend() == "cv2":
        import cv2

        return cv2.resize(img, size)
    return resize_linear(img, size)


def preprocess_vgg(img_bgr: np.ndarray) -> np.ndarray:
    """Keras caffe preprocessing as the reference invokes it on a BGR
    image: a channel flip plus BGR-ordered mean subtraction."""
    x = img_bgr.astype(np.float32)[..., ::-1]
    return x - CAFFE_MEANS_BGR


def preprocess_tf(img_bgr: np.ndarray) -> np.ndarray:
    """Keras 'tf'-mode preprocessing (InceptionV3, the MobileNets) on a
    BGR image: flip to RGB and scale to [-1, 1]."""
    x = img_bgr.astype(np.float32)[..., ::-1]
    return x / 127.5 - 1.0


def unpreprocess_vgg(x: np.ndarray) -> np.ndarray:
    """Inverse of ``preprocess_vgg``: back to BGR uint8 (a dreamed image
    lives in model-input space, not projection space)."""
    y = x.astype(np.float32) + CAFFE_MEANS_BGR
    return np.clip(y[..., ::-1], 0, 255).astype(np.uint8)


def unpreprocess_tf(x: np.ndarray) -> np.ndarray:
    """Inverse of ``preprocess_tf``: back to BGR uint8."""
    y = (x.astype(np.float32) + 1.0) * 127.5
    return np.clip(y[..., ::-1], 0, 255).astype(np.uint8)


def encode_data_url(img_uint8: np.ndarray) -> str:
    """uint8 BGR image -> JPEG bytes, base64, percent-quoted, under the
    reference's ``data:image/webp`` prefix."""
    kind = backend()
    if kind == "cv2":
        import cv2

        ok, buf = cv2.imencode(".jpg", img_uint8)
        if not ok:
            raise CodecError("JPEG encode failed")
        raw = buf.tobytes()
    elif kind == "pil":
        import io

        from PIL import Image

        bio = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(img_uint8[:, :, ::-1])).save(
            bio, format="JPEG", quality=_JPEG_QUALITY
        )
        raw = bio.getvalue()
    else:
        raw = encode_jpeg(img_uint8)
    # the base64 alphabet is quote-safe except '+' and '=' ('/' is safe)
    quoted = base64.b64encode(raw).replace(b"+", b"%2B").replace(b"=", b"%3D")
    return "data:image/webp;base64,{}".format(quoted.decode("ascii"))


def jpeg_size(raw: bytes) -> tuple[int, int]:
    """(height, width) from a JPEG's frame header, without decoding."""
    i = 2
    while i + 9 < len(raw):
        if raw[i] != 0xFF:
            raise CodecError("malformed JPEG marker stream")
        marker = raw[i + 1]
        if marker in (0xC0, 0xC1, 0xC2):
            h, w = struct.unpack(">HH", raw[i + 5 : i + 9])
            return h, w
        i += 2 + struct.unpack(">H", raw[i + 2 : i + 4])[0]
    raise CodecError("no JPEG frame header")


# --- numpy PNG decoder ----------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def decode_png(raw: bytes) -> np.ndarray:
    """8-bit, non-interlaced PNG -> BGR uint8 (alpha dropped)."""
    if not raw.startswith(_PNG_SIG):
        raise CodecError("could not decode image bytes: no cv2 or Pillow, and not a PNG")
    pos, idat, palette, hdr = 8, [], None, None
    while pos + 8 <= len(raw):
        length, ctype = struct.unpack(">I4s", raw[pos : pos + 8])
        data = raw[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif ctype == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(data)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise CodecError("PNG without IHDR")
    width, height, depth, color, _, _, interlace = hdr
    if depth != 8 or interlace or color not in _PNG_CHANNELS:
        raise CodecError(f"unsupported PNG (depth {depth}, color {color}, interlace {interlace})")
    bpp = _PNG_CHANNELS[color]
    try:
        data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise CodecError(f"corrupt PNG data: {e}") from e
    stride = width * bpp
    if data.size != height * (stride + 1):
        raise CodecError("PNG data size does not match its header")
    rows = data.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(height):
        ftype, line = rows[r, 0], rows[r, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per channel, mod 256
            cur = np.cumsum(line.reshape(width, bpp), axis=0, dtype=np.uint8).ravel()
        elif ftype == 2:
            cur = line + prior
        elif ftype in (3, 4):
            cur = _unfilter_sequential(ftype, line, prior, bpp)
        else:
            raise CodecError(f"bad PNG filter type {ftype}")
        out[r], prior = cur, cur
    img = out.reshape(height, width, bpp)
    if color == 3:
        if palette is None:
            raise CodecError("palette PNG without PLTE")
        img = palette[img[:, :, 0]]
    elif color in (0, 4):
        img = np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, 2::-1])


def _unfilter_sequential(ftype, line, prior, bpp):
    """PNG Average (3) and Paeth (4) filters, pixel by pixel."""
    cur = line.astype(np.int32)
    up = prior.astype(np.int32)
    for x in range(0, cur.size, bpp):
        a = cur[x - bpp : x] if x else np.zeros(bpp, np.int32)
        b = up[x : x + bpp]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = up[x - bpp : x] if x else np.zeros(bpp, np.int32)
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        cur[x : x + bpp] = (cur[x : x + bpp] + pred) & 0xFF
    return cur.astype(np.uint8)


# --- numpy bilinear resize, cv2-exact on uint8 ------------------------------------

_COEF_SCALE = 2048  # INTER_RESIZE_COEF_SCALE: 11 fractional bits


def _linear_taps(dsize: int, ssize: int):
    """cv2's source index and float32 fraction for each output position."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(np.float32)).astype(np.float32)


def _fixed(frac: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    one = np.float32(_COEF_SCALE)
    return (
        np.rint((np.float32(1) - frac) * one).astype(np.int64),
        np.rint(frac * one).astype(np.int64),
    )


def resize_linear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 HWC bilinear resize to ``size`` (width, height), reproducing
    ``cv2.resize(img, size)``: 11-bit fixed-point coefficients, a
    horizontal pass into int32, and the vertical pass as cv2's SIMD path
    computes it (operands shifted right by 4, 16x16 high products, then a
    rounding shift by 2)."""
    dw, dh = size
    sh, sw = img.shape[:2]
    src = img.reshape(sh, sw, -1).astype(np.int64)
    sx, fx = _linear_taps(dw, sw)
    fx[sx < 0], sx[sx < 0] = 0, 0
    edge = sx >= sw - 1
    fx[edge], sx[edge] = 0, sw - 1
    a0, a1 = _fixed(fx)
    rows = src[:, sx, :] * a0[None, :, None] + src[:, np.minimum(sx + 1, sw - 1), :] * a1[None, :, None]
    rows[:, edge, :] = src[:, sx[edge], :] * _COEF_SCALE
    sy, fy = _linear_taps(dh, sh)
    b0, b1 = _fixed(fy)
    s0 = rows[np.clip(sy, 0, sh - 1)] >> 4
    s1 = rows[np.clip(sy + 1, 0, sh - 1)] >> 4
    hi = ((s0 * b0[:, None, None]) >> 16) + ((s1 * b1[:, None, None]) >> 16)
    out = np.clip((hi + 2) >> 2, 0, 255).astype(np.uint8)
    return out.reshape((dh, dw) + img.shape[2:])


# --- numpy baseline JPEG encoder --------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
# ITU-T T.81 Annex K tables: quantisation (natural order) and Huffman specs
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282"
    "090a161718191a25262728292a3435363738393a434445464748494a535455565758595a63"
    "6465666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6"
    "a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6"
    "e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d1"
    "0a162434e125f11718191a262728292a35363738393a434445464748494a535455565758595a"
    "636465666768696a737475767778797a82838485868788898a92939495969798999aa2a3a4"
    "a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5"
    "e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _huffman_codes(spec) -> dict[int, tuple[int, int]]:
    """symbol -> (code, length) from a (counts per length, symbols) spec."""
    counts, symbols = spec
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _dct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    m = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return m


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _category(v: int) -> tuple[int, int]:
    """JPEG magnitude category and its extra bits for coefficient v."""
    n = abs(v).bit_length()
    return n, (v if v >= 0 else v + (1 << n) - 1)


def encode_jpeg(img_bgr: np.ndarray) -> bytes:
    """uint8 BGR (H, W, 3) -> baseline JPEG, 4:4:4, standard Huffman
    tables, the IJG quality scaling at cv2's default quality."""
    h, w = img_bgr.shape[:2]
    bgr = img_bgr.astype(np.float64)
    b, g, r = bgr[..., 0], bgr[..., 1], bgr[..., 2]
    planes = (
        0.299 * r + 0.587 * g + 0.114 * b,
        -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
        0.5 * r - 0.418688 * g - 0.081312 * b + 128,
    )
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    qt = [_quant_table(_Q_LUMA, _JPEG_QUALITY), _quant_table(_Q_CHROMA, _JPEG_QUALITY)]
    dct = _dct_matrix()
    coefs = []  # per component: (n_blocks, 64) quantised, zigzag order
    for comp, plane in enumerate(planes):
        p = np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge") - 128
        blocks = p.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
        d = dct @ blocks @ dct.T
        q = np.rint(d.reshape(-1, 64) / qt[min(comp, 1)]).astype(np.int64)
        coefs.append(q[:, _ZIGZAG])
    dc_codes = [_huffman_codes(_DC_LUMA), _huffman_codes(_DC_CHROMA)]
    ac_codes = [_huffman_codes(_AC_LUMA), _huffman_codes(_AC_CHROMA)]
    vals, lens = [], []  # (bits, nbits) of every code + extra-bits pair
    pred = [0, 0, 0]
    for blk in range(coefs[0].shape[0]):
        for comp in range(3):
            zz = coefs[comp][blk]
            t = min(comp, 1)
            n, extra = _category(int(zz[0]) - pred[comp])
            pred[comp] = int(zz[0])
            code, ln = dc_codes[t][n]
            vals.append((code << n) | extra)
            lens.append(ln + n)
            run = 0
            nz = np.flatnonzero(zz[1:]) + 1
            last = 0
            for k in nz:
                run = k - last - 1
                while run > 15:
                    code, ln = ac_codes[t][0xF0]
                    vals.append(code)
                    lens.append(ln)
                    run -= 16
                n, extra = _category(int(zz[k]))
                code, ln = ac_codes[t][(run << 4) | n]
                vals.append((code << n) | extra)
                lens.append(ln + n)
                last = k
            if last != 63:
                code, ln = ac_codes[t][0x00]
                vals.append(code)
                lens.append(ln)
    scan = _pack_bits(np.array(vals, np.int64), np.array(lens, np.int64))

    def segment(marker: int, payload: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    out = [b"\xff\xd8", segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in (0, 1):
        out.append(segment(0xDB, bytes([t]) + bytes(qt[t][_ZIGZAG].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1])
    out.append(segment(0xC0, sof))
    for cls, t, spec in ((0, 0, _DC_LUMA), (1, 0, _AC_LUMA), (0, 1, _DC_CHROMA), (1, 1, _AC_CHROMA)):
        out.append(segment(0xC4, bytes([(cls << 4) | t]) + bytes(spec[0]) + bytes(spec[1])))
    out.append(segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out.append(scan)
    out.append(b"\xff\xd9")
    return b"".join(out)


def _pack_bits(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate (value, nbits) fields MSB first, pad the last byte with
    1-bits, and stuff a 0x00 after every 0xFF byte."""
    total = int(lens.sum())
    ends = np.cumsum(lens)
    field = np.repeat(np.arange(lens.size), lens)
    shift = ends[field] - 1 - np.arange(total)  # bit's place in its field
    bits = (vals[field] >> shift) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    stuffed = np.repeat(data, np.where(data == 0xFF, 2, 1))
    stuffed[ff + np.arange(ff.size) + 1] = 0  # the copy after each 0xFF
    return stuffed.tobytes()


# --- device postprocess -----------------------------------------------------------


def deprocess(x: torch.Tensor) -> torch.Tensor:
    """Projection -> displayable uint8 (the reference's deprocess): centre,
    scale to 0.1 population std, shift by 0.5, clip, truncate to uint8."""
    x = x.float()
    x = x - x.mean()
    x = x / (x.std(correction=0) + EPSILON)
    x = x * 0.1 + 0.5
    x = torch.clamp(x, 0.0, 1.0) * 255.0
    return torch.clamp(x, 0.0, 255.0).to(torch.uint8)


def deprocess_tiles(images: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W, C) projections -> uint8, each (b, k) tile normalised
    alone with ``deprocess``'s arithmetic."""
    x = images.float()
    dims = tuple(range(2, x.dim()))
    x = x - x.mean(dim=dims, keepdim=True)
    x = x / (x.std(dim=dims, correction=0, keepdim=True) + EPSILON)
    x = x * 0.1 + 0.5
    x = torch.clamp(x, 0.0, 1.0) * 255.0
    return torch.clamp(x, 0.0, 255.0).to(torch.uint8)


def stitch_grid(images: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W, C) projections + (B, K) validity -> (B, 2H, 2W, C) uint8:
    zero the tiles that did not fire, stitch the first 4 as 2x2, deprocess
    each grid as a whole."""
    b, k = images.shape[:2]
    if k < 4:
        pad = images.new_zeros((b, 4 - k, *images.shape[2:]))
        images = torch.cat([images, pad], dim=1)
        valid = torch.cat([valid, valid.new_zeros((b, 4 - k))], dim=1)
    tiles = images[:, :4] * valid[:, :4, None, None, None].to(images.dtype)
    top = torch.cat([tiles[:, 0], tiles[:, 1]], dim=2)
    bottom = torch.cat([tiles[:, 2], tiles[:, 3]], dim=2)
    grid = torch.cat([top, bottom], dim=1)
    return torch.stack([deprocess(g) for g in grid])
