"""MSB-first bit-level I/O for the bzip2 container.

Parity: reference include/BitOutputStream.hpp:30-135 (writeBits/writeUnary/
writeInteger/padding plus the writeFileBytes/getLeftBuffer cross-block carry
contract) and include/BitInputStream.hpp:30-85.

Redesign: instead of the reference's bool-per-bit buffers (16 bytes of bools
per input byte, include/OutputStream.hpp:70), bitstreams here are *packed*
uint8 arrays paired with a bit length. Variable-length code packing is a
vectorized offset/shift/xor-scatter (`pack_bits`), and the ordered stitch of
per-block bitstreams is a vectorized byte-shift concatenation
(`concat_bitstreams`) rather than a bit-at-a-time host loop.
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    """Scalar MSB-first bit accumulator (oracle/control-path use)."""

    def __init__(self) -> None:
        self._out = bytearray()
        self._acc = 0  # pending bits, MSB-aligned conceptually at LSB side
        self._nbits = 0

    def write_bits(self, nbits: int, value: int) -> None:
        if nbits == 0:
            return
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._out.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_bit(self, bit: int) -> None:
        self.write_bits(1, bit)

    def write_unary(self, value: int) -> None:
        """value as `value` one-bits then a zero-bit (selector coding)."""
        self.write_bits(value + 1, ((1 << value) - 1) << 1)

    @property
    def bit_length(self) -> int:
        return len(self._out) * 8 + self._nbits

    def pad_to_byte(self) -> None:
        if self._nbits:
            self.write_bits(8 - self._nbits, 0)

    def getvalue(self) -> bytes:
        """Padded byte string (pads a copy; writer stays usable)."""
        if self._nbits == 0:
            return bytes(self._out)
        return bytes(self._out) + bytes([(self._acc << (8 - self._nbits)) & 0xFF])


class BitReader:
    """Scalar MSB-first bit reader over a byte buffer."""

    def __init__(self, data: bytes | np.ndarray) -> None:
        self._data = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
        self._pos = 0  # bit position

    @property
    def bit_position(self) -> int:
        return self._pos

    @property
    def bits_remaining(self) -> int:
        return self._data.size * 8 - self._pos

    def read_bits(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        if self._pos + nbits > self._data.size * 8:
            raise EOFError("bit stream exhausted")
        result = 0
        pos = self._pos
        need = nbits
        while need > 0:
            byte = int(self._data[pos >> 3])
            avail = 8 - (pos & 7)
            take = min(avail, need)
            chunk = (byte >> (avail - take)) & ((1 << take) - 1)
            result = (result << take) | chunk
            pos += take
            need -= take
        self._pos = pos
        return result

    def read_bit(self) -> int:
        return self.read_bits(1)

    def read_unary(self) -> int:
        count = 0
        while self.read_bits(1):
            count += 1
        return count

    def align_to_byte(self) -> None:
        self._pos = (self._pos + 7) & ~7


# --- Vectorized packing ---------------------------------------------------


def pack_bits(values: np.ndarray, lengths: np.ndarray) -> tuple[np.ndarray, int]:
    """Pack variable-length MSB-first codes into a byte array.

    values/lengths are 1-D arrays; lengths must be <= 57 bits each (bzip2
    codes are <= 48). Returns (packed uint8 array, total bit length). Codes
    land at the prefix-summed bit offsets; each code is aligned into a 64-bit
    window anchored at its starting byte and xor-scattered a byte at a time —
    disjoint bit ranges make xor/add equivalent and order-free. This is the
    associative replacement for the reference's serial bool-buffer writes.
    """
    values = np.asarray(values, dtype=np.uint64)
    lengths = np.asarray(lengths, dtype=np.int64)
    if values.size == 0:
        return np.zeros(0, dtype=np.uint8), 0
    ends = np.cumsum(lengths)
    total_bits = int(ends[-1])
    offsets = ends - lengths
    nbytes = (total_bits + 7) >> 3
    out = np.zeros(nbytes + 8, dtype=np.uint8)
    bit_in_byte = (offsets & 7).astype(np.uint64)
    shift = np.uint64(64) - lengths.astype(np.uint64) - bit_in_byte
    window = values << shift  # MSB-aligned within the 8-byte window
    byte0 = (offsets >> 3).astype(np.int64)
    for j in range(8):
        part = ((window >> np.uint64(8 * (7 - j))) & np.uint64(0xFF)).astype(np.uint8)
        np.bitwise_xor.at(out, byte0 + j, part)
    return out[:nbytes], total_bits


def concat_bitstreams(parts: list[tuple[np.ndarray, int]]) -> tuple[np.ndarray, int]:
    """Concatenate (packed_bytes, bit_length) streams with bit alignment.

    Semantics of the reference's writeFileBytes + getLeftBuffer carry loop
    (include/BitOutputStream.hpp:47-99, include/OutputStream.hpp:225-239),
    but each part is shifted as a whole-array byte operation.
    """
    total_bits = sum(p[1] for p in parts)
    out = np.zeros((total_bits + 7) >> 3, dtype=np.uint8)
    pos = 0
    for data, nbits in parts:
        if nbits == 0:
            continue
        data = np.asarray(data, dtype=np.uint8)
        nb = (nbits + 7) >> 3
        data = data[:nb]
        s = pos & 7
        byte0 = pos >> 3
        if s == 0:
            shifted = data
            out_len = nb
        else:
            ext = np.concatenate([np.zeros(1, dtype=np.uint8), data])
            hi = ext[:-1] << np.uint8(8 - s)
            lo = ext[1:] >> np.uint8(s)
            shifted = np.concatenate([hi | lo, ext[-1:] << np.uint8(8 - s)])
            out_len = shifted.size
        end_bit = pos + nbits
        end_byte = (end_bit + 7) >> 3
        usable = min(out_len, end_byte - byte0)
        # Mask tail bits beyond nbits in the final byte of this part.
        seg = shifted[:usable].copy()
        tail_bits = end_bit & 7
        if tail_bits and byte0 + usable == end_byte:
            seg[-1] &= np.uint8((0xFF << (8 - tail_bits)) & 0xFF)
        out[byte0 : byte0 + usable] ^= seg
        pos = end_bit
    return out, total_bits
