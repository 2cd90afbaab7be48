"""Pure-Python FLAC codec, decoder and a minimal encoder (a copy of
spider_tpu/datasets/flac.py, which is numpy and Python only).

AudioCaps ships .flac members, and no audio decode library is assumed
(torchaudio, soundfile, pyav, ffmpeg), so the format is implemented from the
FLAC bitstream specification:

  decoder: STREAMINFO parsing; frames with UTF-8 coded numbers, all block
  size / sample rate / sample size codes; CONSTANT, VERBATIM, FIXED(0-4)
  and LPC(1-32) subframes; Rice/Rice2 partitioned residuals incl. escape
  partitions; wasted bits; independent, left/side, right/side and mid/side
  stereo decorrelation; CRC-8 header check.

  encoder (test fixtures and shard tooling): fixed-blocksize streams with
  VERBATIM / FIXED-order-2 / LPC subframes and single-partition Rice
  residuals, a strict subset of the spec, readable by any compliant
  decoder, that exercises every decoder path without libFLAC.

Throughput note: this is the correctness and portability path. Bulk
training ingestion pre-decodes into ``<ext>.npy`` shard members, which
``backends._decode_member`` reads with no decode cost.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

BLOCK_SIZE_CODES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                    13: 8192, 14: 16384, 15: 32768}
SAMPLE_RATE_CODES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
                     6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
                     11: 96000}
SAMPLE_SIZE_CODES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


class BitReader:
    """MSB-first bit reader over a bytes buffer."""

    def __init__(self, data: bytes, pos_bits: int = 0):
        self.data = data
        self.pos = pos_bits  # absolute bit position

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        start_byte, start_bit = divmod(self.pos, 8)
        end_byte = (self.pos + n + 7) // 8
        chunk = int.from_bytes(self.data[start_byte:end_byte], "big")
        total_bits = (end_byte - start_byte) * 8
        val = (chunk >> (total_bits - start_bit - n)) & ((1 << n) - 1)
        self.pos += n
        return val

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >> (n - 1) else v

    def read_unary(self) -> int:
        """Count zero bits up to the first 1 bit."""
        count = 0
        data, pos = self.data, self.pos
        byte_idx, bit_idx = divmod(pos, 8)
        while True:
            b = data[byte_idx] & (0xFF >> bit_idx)
            if b:
                leading = 7 - b.bit_length() + 1  # index of first set bit
                count += leading - bit_idx
                self.pos = byte_idx * 8 + leading + 1
                return count
            count += 8 - bit_idx
            byte_idx += 1
            bit_idx = 0

    def align(self) -> None:
        self.pos = (self.pos + 7) // 8 * 8


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


def _read_utf8_number(br: BitReader) -> int:
    first = br.read(8)
    if first < 0x80:
        return first
    n_extra = 0
    mask = 0x40
    while first & mask:
        n_extra += 1
        mask >>= 1
    val = first & (mask - 1)
    for _ in range(n_extra):
        val = (val << 6) | (br.read(8) & 0x3F)
    return val


def _decode_residual(br: BitReader, block_size: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError(f"reserved residual method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    part_order = br.read(4)
    n_parts = 1 << part_order
    part_len = block_size >> part_order
    out: List[int] = []
    for p in range(n_parts):
        n = part_len - (order if p == 0 else 0)
        param = br.read(param_bits)
        if param == escape:
            raw_bits = br.read(5)
            if raw_bits == 0:
                out.extend([0] * n)
            else:
                out.extend(br.read_signed(raw_bits) for _ in range(n))
        else:
            for _ in range(n):
                q = br.read_unary()
                v = (q << param) | br.read(param) if param else q
                out.append((v >> 1) ^ -(v & 1))  # zigzag -> signed
    return np.asarray(out, np.int64)


def _decode_subframe(br: BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("bad subframe padding bit")
    sf_type = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted
    if sf_type == 0:  # CONSTANT
        samples = np.full(block_size, br.read_signed(bps), np.int64)
    elif sf_type == 1:  # VERBATIM
        samples = np.asarray([br.read_signed(bps) for _ in range(block_size)],
                             np.int64)
    elif 8 <= sf_type <= 12:  # FIXED
        order = sf_type - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        resid = _decode_residual(br, block_size, order)
        samples = np.empty(block_size, np.int64)
        samples[:order] = warm
        coefs = FIXED_COEFFS[order]
        x = samples
        for i in range(order, block_size):
            acc = resid[i - order]
            for j, c in enumerate(coefs):
                acc += c * x[i - 1 - j]
            x[i] = acc
    elif sf_type >= 32:  # LPC
        order = sf_type - 31
        warm = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise ValueError("invalid qlp precision")
        shift = br.read_signed(5)
        coefs = [br.read_signed(precision) for _ in range(order)]
        resid = _decode_residual(br, block_size, order)
        samples = np.empty(block_size, np.int64)
        samples[:order] = warm
        x = samples
        for i in range(order, block_size):
            acc = 0
            for j in range(order):
                acc += coefs[j] * x[i - 1 - j]
            x[i] = resid[i - order] + (acc >> shift)
    else:
        raise ValueError(f"reserved subframe type {sf_type}")
    if wasted:
        samples = samples << wasted
    return samples


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """FLAC bytes -> (float32 waveform [n] mono or [n, channels], rate)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    sample_rate = channels = bps = 0
    total = 0
    # metadata blocks
    while True:
        header = data[pos]
        btype = header & 0x7F
        length = int.from_bytes(data[pos + 1: pos + 4], "big")
        body = data[pos + 4: pos + 4 + length]
        if btype == 0:  # STREAMINFO
            br = BitReader(body)
            br.read(16)  # min block
            br.read(16)  # max block
            br.read(24)
            br.read(24)
            sample_rate = br.read(20)
            channels = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
        pos += 4 + length
        if header & 0x80:
            break
    if not sample_rate:
        raise ValueError("no STREAMINFO")

    out: List[np.ndarray] = []
    n_decoded = 0
    while pos < len(data) and (not total or n_decoded < total):
        br = BitReader(data, pos * 8)
        sync = br.read(14)
        if sync != 0x3FFE:
            break  # trailing garbage / padding
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        chan_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        _read_utf8_number(br)
        if bs_code == 6:
            block_size = br.read(8) + 1
        elif bs_code == 7:
            block_size = br.read(16) + 1
        else:
            block_size = BLOCK_SIZE_CODES[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        header_end = (br.pos + 7) // 8
        if _crc8(data[pos:header_end]) != data[header_end]:
            raise ValueError("frame header CRC mismatch")
        br.pos = (header_end + 1) * 8

        frame_bps = SAMPLE_SIZE_CODES.get(ss_code, bps)
        if chan_code < 8:
            n_chan = chan_code + 1
            chans = [_decode_subframe(br, block_size, frame_bps)
                     for _ in range(n_chan)]
        else:
            # stereo decorrelation: the SIDE channel carries one extra bit
            extra = [0, 1] if chan_code in (8, 10) else [1, 0]
            a = _decode_subframe(br, block_size, frame_bps + extra[0])
            b = _decode_subframe(br, block_size, frame_bps + extra[1])
            if chan_code == 8:      # left/side
                chans = [a, a - b]
            elif chan_code == 9:    # right/side
                chans = [a + b, b]
            else:                   # mid/side
                mid, side = a, b
                left = ((mid << 1) | (side & 1)) + side >> 1
                right = ((mid << 1) | (side & 1)) - side >> 1
                chans = [left, right]
        br.align()
        br.read(16)  # frame CRC-16 (trusted; header CRC already checked)
        pos = br.pos // 8
        out.append(np.stack(chans, axis=-1))
        n_decoded += block_size

    if not out:
        raise ValueError("no FLAC frames decoded")
    pcm = np.concatenate(out, axis=0)
    if total:
        pcm = pcm[:total]
    wave = pcm.astype(np.float32) / float(1 << (bps - 1))
    if wave.shape[-1] == 1:
        wave = wave[..., 0]
    return wave, sample_rate


# ---------------------------------------------------------------------------
# Minimal encoder (fixtures / pre-decode tooling)
# ---------------------------------------------------------------------------

class BitWriter:
    def __init__(self) -> None:
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, val: int, n: int) -> None:
        self.acc = (self.acc << n) | (val & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, val: int, n: int) -> None:
        self.write(val & ((1 << n) - 1), n)

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _rice_encode(bw: BitWriter, resid: np.ndarray, param: int) -> None:
    for e in resid:
        e = int(e)
        v = (e << 1) ^ (e >> 63) if e < 0 else e << 1  # zigzag
        v = (abs(e) << 1) - (1 if e < 0 else 0)
        bw.write_unary(v >> param)
        if param:
            bw.write(v & ((1 << param) - 1), param)


def _best_rice_param(resid: np.ndarray) -> int:
    mean = float(np.mean(np.abs(resid))) if len(resid) else 0.0
    param = 0
    while (1 << param) < mean + 1 and param < 14:
        param += 1
    return param


def encode_flac(wave: np.ndarray, sample_rate: int = 16000,
                block_size: int = 4096, bps: int = 16,
                subframe: str = "fixed2") -> bytes:
    """float32 [-1,1] (mono [n] or [n,ch]) -> FLAC bytes.

    subframe: 'verbatim' | 'fixed2' | 'lpc2' — which decoder path the
    stream exercises (all produce spec-conformant files)."""
    wave = np.asarray(wave)
    if wave.ndim == 1:
        wave = wave[:, None]
    n, channels = wave.shape
    pcm = np.clip(np.round(wave * (1 << (bps - 1))),
                  -(1 << (bps - 1)), (1 << (bps - 1)) - 1).astype(np.int64)

    out = bytearray(b"fLaC")
    si = BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(bps - 1, 5)
    si.write(n, 36)
    for _ in range(16):
        si.write(0, 8)  # md5 unset (spec-legal: 0 = unknown)
    body = si.bytes()
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    for frame_no, start in enumerate(range(0, n, block_size)):
        blk = pcm[start: start + block_size]
        bs = len(blk)
        hdr = BitWriter()
        hdr.write(0x3FFE, 14)
        hdr.write(0, 1)
        hdr.write(0, 1)  # fixed blocksize
        hdr.write(7, 4)          # 16-bit block size at end of header
        hdr.write(13, 4)         # 16-bit sample rate in Hz
        hdr.write(channels - 1, 4)
        hdr.write({8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bps], 3)
        hdr.write(0, 1)
        # UTF-8 frame number (fixed blocksize -> frame index)
        fn = frame_no
        if fn < 0x80:
            hdr.write(fn, 8)
        else:
            hdr.write(0xC0 | (fn >> 6), 8)
            hdr.write(0x80 | (fn & 0x3F), 8)
        hdr.write(bs - 1, 16)
        hdr.write(sample_rate, 16)
        hbytes = hdr.bytes()
        hbytes += bytes([_crc8(hbytes)])

        bw = BitWriter()
        for c in range(channels):
            x = blk[:, c]
            bw.write(0, 1)
            if subframe == "verbatim" or bs <= 4:
                bw.write(1, 6)
                bw.write(0, 1)  # no wasted bits
                for s in x:
                    bw.write_signed(int(s), bps)
                continue
            if subframe == "fixed2":
                order = 2
                bw.write(8 + order, 6)
                bw.write(0, 1)
                for s in x[:order]:
                    bw.write_signed(int(s), bps)
                resid = x[order:] - 2 * x[order - 1:-1] + x[:-(order)]
            elif subframe == "lpc2":
                order = 2
                bw.write(32 + order - 1, 6)
                bw.write(0, 1)
                for s in x[:order]:
                    bw.write_signed(int(s), bps)
                # a simple stable predictor: x[i] ~ 2x[i-1] - x[i-2],
                # quantized with precision 12, shift 3 -> coefs 16, -8
                precision, shift, coefs = 12, 3, [16, -8]
                bw.write(precision - 1, 4)
                bw.write_signed(shift, 5)
                for cf in coefs:
                    bw.write_signed(cf, precision)
                pred = (coefs[0] * x[1:-1] + coefs[1] * x[:-2]) >> shift
                resid = x[2:] - pred
            else:
                raise ValueError(subframe)
            bw.write(0, 2)  # rice method 0
            bw.write(0, 4)  # partition order 0
            param = _best_rice_param(resid)
            bw.write(min(param, 14), 4)
            _rice_encode(bw, resid, min(param, 14))
        bw.align()
        fbytes = hbytes + bw.bytes()
        fbytes += struct.pack(">H", _crc16(fbytes))
        out += fbytes
    return bytes(out)


def sniff_audio(data: bytes) -> Optional[str]:
    if data[:4] == b"fLaC":
        return "flac"
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return "wav"
    return None
