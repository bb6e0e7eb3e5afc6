"""Raw bit-level I/O: RBSP writer/reader, emulation prevention, NAL framing.

Reference behavior being matched: src/bitstream.c (u/ue/se writers,
emulation-prevention three-byte insertion at src/bitstream.c:135-158) and
src/nal.c:30 (start codes + 2-byte NAL header).  The design here is a plain
Python byte-accumulator instead of the reference's chunked allocator: chunk
management was a malloc-pressure optimization for a C pipeline; we
accumulate into bytearrays and let the host runtime manage memory.

The reader half (BitReader) exists to support the conformance-oracle
decoder (tests decode our own bitstreams; SURVEY.md §4 implication (b)).
"""

from __future__ import annotations

import functools


@functools.lru_cache(maxsize=1)
def _native_ep():
    """The native emulation-prevention routine; raises when the native
    library cannot be built or loaded."""
    import ctypes

    import numpy as np

    from kvazaar_jax.bitstream.native import get_lib
    lib = get_lib()
    lib.ktpu_emulation_prevention.restype = ctypes.c_int64
    lib.ktpu_emulation_prevention.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64]

    def run(rbsp: bytes) -> bytes:
        cap = len(rbsp) * 3 // 2 + 16
        out = np.empty(cap, np.uint8)
        n = lib.ktpu_emulation_prevention(rbsp, len(rbsp),
                                          out.ctypes.data, cap)
        if n < 0:
            raise RuntimeError("EP buffer overflow")
        return out[:n].tobytes()

    return run


class BitWriter:
    """MSB-first bit accumulator producing raw RBSP payload (no emulation
    prevention here — that is applied when wrapping into a NAL unit)."""

    def __init__(self):
        self._bytes = bytearray()
        self._cur = 0
        self._nbits = 0

    def u(self, value: int, nbits: int) -> None:
        """Write fixed-length unsigned, MSB first."""
        if nbits < 0 or (nbits < 64 and value >> nbits):
            raise ValueError(f"value {value} does not fit in {nbits} bits")
        for i in range(nbits - 1, -1, -1):
            self.bit((value >> i) & 1)

    def bit(self, b: int) -> None:
        self._cur = (self._cur << 1) | (b & 1)
        self._nbits += 1
        if self._nbits == 8:
            self._bytes.append(self._cur)
            self._cur = 0
            self._nbits = 0

    def ue(self, value: int) -> None:
        """Exp-Golomb unsigned (H.265 9.2)."""
        if value < 0:
            raise ValueError("ue(v) needs non-negative value")
        v = value + 1
        nbits = v.bit_length()
        self.u(0, nbits - 1)
        self.u(v, nbits)

    def se(self, value: int) -> None:
        """Exp-Golomb signed: 0,1,-1,2,-2,... (H.265 9.2.2)."""
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    @property
    def bit_position(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    @property
    def byte_aligned(self) -> bool:
        return self._nbits == 0

    def align_zero(self) -> None:
        while self._nbits:
            self.bit(0)

    def align_one(self) -> None:
        while self._nbits:
            self.bit(1)

    def rbsp_trailing_bits(self) -> None:
        """rbsp_stop_one_bit + zero alignment (H.265 7.3.2.11)."""
        self.bit(1)
        self.align_zero()

    def get_bytes(self) -> bytes:
        if self._nbits:
            raise ValueError("bitstream not byte-aligned")
        return bytes(self._bytes)


def emulation_prevention(rbsp: bytes) -> bytes:
    """Insert 0x03 after any 0x0000 pair followed by a byte <= 3
    (H.265 7.4.2; reference behavior: src/bitstream.c:135-158).
    Payloads over 512 bytes (the slice data, the hot path) take the
    native routine."""
    if len(rbsp) > 512:
        return _native_ep()(rbsp)
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def strip_emulation_prevention(ebsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    i = 0
    n = len(ebsp)
    while i < n:
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 < n and ebsp[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def nal_unit(rbsp: bytes, nal_type: int, temporal_id: int = 0,
             long_start_code: bool = True) -> bytes:
    """Wrap an RBSP into an Annex-B NAL unit (start code + 2-byte header +
    emulation-prevented payload).  Reference: src/nal.c:30."""
    header = bytes([(nal_type << 1) & 0x7E, temporal_id + 1])
    start = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    return start + emulation_prevention(header + rbsp)


def split_annexb(stream: bytes):
    """Yield (nal_type, temporal_id, rbsp) for each NAL in an Annex-B
    stream (conformance-oracle input)."""
    i = 0
    n = len(stream)
    starts = []
    while i + 2 < n:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        end = (starts[k + 1] - 3) if k + 1 < len(starts) else n
        # A 0x00 right before the next "00 00 01" belongs to that NAL's
        # 4-byte start code, not to this payload.
        if k + 1 < len(starts) and end > s and stream[end - 1] == 0:
            end -= 1
        nal = strip_emulation_prevention(stream[s:end])
        nal_type = (nal[0] >> 1) & 0x3F
        tid = (nal[1] & 7) - 1
        yield nal_type, tid, nal[2:]


class BitReader:
    """MSB-first bit reader over an RBSP byte string."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0  # bit position

    def bit(self) -> int:
        byte = self._data[self._pos >> 3]
        b = (byte >> (7 - (self._pos & 7))) & 1
        self._pos += 1
        return b

    def u(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.bit()
        return v

    def ue(self) -> int:
        zeros = 0
        while self.bit() == 0:
            zeros += 1
            if zeros > 63:
                raise ValueError("bad ue(v)")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    @property
    def bit_position(self) -> int:
        return self._pos

    def byte_align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    def more_data(self) -> bool:
        return self._pos < len(self._data) * 8
