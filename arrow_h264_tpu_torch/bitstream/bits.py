"""Raw-bit and Exp-Golomb primitives (ITU-T H.264 7.2, 9.1).

Reference parity: JM-lineage `vlc.c` (SURVEY.md §2 — reference mount was
empty, so parity is against the spec clauses directly).

The reader operates on RBSP bytes (emulation-prevention already removed,
see bitstream/nal.py).  The writer produces RBSP bytes; EPB insertion also
lives in bitstream/nal.py.
"""

from __future__ import annotations


class BitReader:
    """MSB-first bit reader over an RBSP byte buffer."""

    __slots__ = ("data", "nbits", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.nbits = 8 * len(data)
        self.pos = 0  # bit position

    def u(self, n: int) -> int:
        """Read n bits as an unsigned integer (spec u(n))."""
        if n == 0:
            return 0
        if self.pos + n > self.nbits:
            raise EOFError(f"bitstream overrun: need {n} bits at {self.pos}/{self.nbits}")
        v = 0
        pos = self.pos
        data = self.data
        for _ in range(n):
            byte = data[pos >> 3]
            v = (v << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return v

    def f(self, n: int) -> int:
        return self.u(n)

    def u1(self) -> int:
        """Fast path for a single bit."""
        if self.pos >= self.nbits:
            raise EOFError("bitstream overrun")
        b = (self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def ue(self) -> int:
        """Unsigned Exp-Golomb, spec 9.1."""
        lz = 0
        while self.u1() == 0:
            lz += 1
            if lz > 32:
                raise ValueError("invalid exp-golomb code (>32 leading zeros)")
        if lz == 0:
            return 0
        return (1 << lz) - 1 + self.u(lz)

    def se(self) -> int:
        """Signed Exp-Golomb, spec 9.1.1: k -> (-1)^(k+1) * ceil(k/2)."""
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def te(self, max_val: int) -> int:
        """Truncated Exp-Golomb, spec 9.1: 1-bit inverted when range is [0,1]."""
        if max_val == 1:
            return 1 - self.u1()
        return self.ue()

    def byte_aligned(self) -> bool:
        return (self.pos & 7) == 0

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def bits_left(self) -> int:
        return self.nbits - self.pos

    def more_rbsp_data(self) -> bool:
        """Spec 7.2: true iff there is data before rbsp_stop_one_bit."""
        if self.pos >= self.nbits:
            return False
        # Find last byte that is non-zero: the stop bit is the lowest set bit
        # of the last non-zero byte.
        data = self.data
        last = len(data) - 1
        while last >= 0 and data[last] == 0:
            last -= 1
        if last < 0:
            return False
        byte = data[last]
        # position (bit index) of the rbsp_stop_one_bit
        low = 0
        while not (byte >> low) & 1:
            low += 1
        stop_pos = last * 8 + (7 - low)
        return self.pos < stop_pos


class BitWriter:
    """MSB-first bit writer producing RBSP bytes."""

    __slots__ = ("_bytes", "_cur", "_nbits")

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._cur = 0
        self._nbits = 0

    def u(self, value: int, n: int) -> None:
        if n == 0:
            return
        if value < 0 or value >= (1 << n):
            raise ValueError(f"value {value} does not fit in {n} bits")
        cur, nbits = self._cur, self._nbits
        for i in range(n - 1, -1, -1):
            cur = (cur << 1) | ((value >> i) & 1)
            nbits += 1
            if nbits == 8:
                self._bytes.append(cur)
                cur, nbits = 0, 0
        self._cur, self._nbits = cur, nbits

    def put_bit(self, b: int) -> None:
        self.u(b, 1)

    def ue(self, value: int) -> None:
        if value < 0:
            raise ValueError("ue(v) requires non-negative value")
        code = value + 1
        nb = code.bit_length()
        self.u(0, nb - 1)
        self.u(code, nb)

    def se(self, value: int) -> None:
        # inverse of se decode: v>0 -> 2v-1 ; v<=0 -> -2v
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def te(self, value: int, max_val: int) -> None:
        if max_val == 1:
            self.u(1 - value, 1)
        else:
            self.ue(value)

    @property
    def bitpos(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    def byte_aligned(self) -> bool:
        return self._nbits == 0

    def rbsp_trailing_bits(self) -> None:
        """Spec 7.3.2.11: stop bit then zero-pad to byte boundary."""
        self.put_bit(1)
        while self._nbits:
            self.put_bit(0)

    def get_bytes(self) -> bytes:
        if self._nbits:
            raise ValueError("writer not byte aligned; call rbsp_trailing_bits()")
        return bytes(self._bytes)


class TracingBitReader(BitReader):
    """BitReader that records every syntax-element read: (kind, bit
    position, bit length, decoded value) — the JM TRACE analog at the
    entropy-decode-sequence level (SURVEY.md §5).  Two decoder runs can
    be diffed to the FIRST diverging read; composite codes (ue/se/te)
    log once, with their inner fixed reads muted.  CABAC engines running
    on this reader mute the raw-bit log and append their own
    ("cab", pos, ctx, bin) records instead (entropy/cabac.py).
    """

    __slots__ = ("log", "mute")

    def __init__(self, data: bytes, log: list):
        super().__init__(data)
        self.log = log
        self.mute = False

    def u(self, n: int) -> int:
        p = self.pos
        v = super().u(n)
        if not self.mute:
            self.log.append(("u", p, n, v))
        return v

    def u1(self) -> int:
        p = self.pos
        v = super().u1()
        if not self.mute:
            self.log.append(("u", p, 1, v))
        return v

    def _composite(self, kind, fn):
        p = self.pos
        m, self.mute = self.mute, True
        try:
            v = fn()
        finally:
            self.mute = m
        if not m:
            self.log.append((kind, p, self.pos - p, v))
        return v

    def ue(self) -> int:
        return self._composite("ue", super().ue)

    def se(self) -> int:
        return self._composite("se", super().se)

    def te(self, max_val: int) -> int:
        return self._composite("te", lambda: super(TracingBitReader,
                                                   self).te(max_val))
