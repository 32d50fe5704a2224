"""The plain reference: a bzip2 stream checker in NumPy.

It decodes a .bz2 stream as bzip2 1.0.8 defines it, independently of the
program under test: the stream header, every block (its header, Huffman
symbol data, run-length and move-to-front decoding, inverse BWT, inverse
RLE1, block CRC-32) and the end marker with the stream CRC, and compares
the decoded bytes with the bytes the benchmark made. It imports NumPy and
the standard library only.

Blocks are found by their 48-bit markers, and each must decode to its
end-of-block symbol exactly where the next marker (or the end marker)
begins, so the stream is covered bit for bit with no gap. The blocks are
then independent, and ``check_stream`` decodes them on several processes
(``BlockPool``: this module run as a worker, fed over pipes).
"""

from __future__ import annotations

import os
import pickle
import selectors
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np

BLOCK_MAGIC = 0x314159265359
END_MAGIC = 0x177245385090
GROUP = 50
MAX_CODE = 20
MAX_SELECTORS = 18002
MASK = 0xFFFFFFFF


class StreamError(ValueError):
    """The stream is not a bzip2 stream of the expected bytes."""


# --------------------------------------------------------------------------
# CRC-32 as bzip2 computes it (polynomial 0x04C11DB7, MSB first, initial
# and final value all ones)


def _byte_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint64) << 24
    for _ in range(8):
        t = np.where(t & 0x80000000, (t << 1) ^ 0x04C11DB7, t << 1) & MASK
    return t.astype(np.uint32)


TABLE = _byte_table()
LANE = 256  # bytes a lane of the vectorised CRC


def _shift_cols(cols: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The GF(2) matrix given by its 32 columns (cols[i] is the image of bit
    i) applied to every value of x (uint32)."""
    out = np.zeros_like(x)
    for i in range(32):
        out ^= np.where((x >> np.uint32(i)) & 1, cols[i], np.uint32(0))
    return out


def _one_zero_byte(x: np.ndarray) -> np.ndarray:
    return ((x << np.uint32(8)) & np.uint32(MASK)) ^ TABLE[x >> np.uint32(24)]


class _Shifts:
    """Columns of the register's advance past 2^k zero bytes, k = 0, 1, ..."""

    def __init__(self):
        basis = (np.uint32(1) << np.arange(32, dtype=np.uint32)).astype(np.uint32)
        self.cols = [_one_zero_byte(basis)]

    def cols_for(self, k: int) -> np.ndarray:
        while len(self.cols) <= k:
            c = self.cols[-1]
            self.cols.append(_shift_cols(c, c))
        return self.cols[k]

    def advance(self, x: np.ndarray, n_bytes: int) -> np.ndarray:
        k = 0
        while n_bytes:
            if n_bytes & 1:
                x = _shift_cols(self.cols_for(k), x)
            n_bytes >>= 1
            k += 1
        return x


_SHIFTS = _Shifts()


def crc32(data: bytes | np.ndarray) -> int:
    """bzip2's CRC-32 of ``data``. Lanes of LANE bytes run the byte table
    side by side from a zero register (leading zero bytes leave a zero
    register as it is, so the data is padded in front), and the lanes'
    registers are folded pairwise, each left one advanced past its right
    neighbour's bytes."""
    buf = np.frombuffer(bytes(data), np.uint8) if not isinstance(data, np.ndarray) else data
    n = buf.size
    if n == 0:
        return 0
    lanes = 1 << max(0, int(np.ceil(np.log2(-(-n // LANE)))))
    padded = np.zeros(lanes * LANE, np.uint8)
    padded[lanes * LANE - n :] = buf
    cols = padded.reshape(lanes, LANE).T.astype(np.uint32)
    reg = np.zeros(lanes, np.uint32)
    for row in cols:
        reg = ((reg << np.uint32(8)) & np.uint32(MASK)) ^ TABLE[(reg >> np.uint32(24)) ^ row]
    span = LANE
    while reg.size > 1:
        k = span.bit_length() - 1  # span is a power of two
        reg = _shift_cols(_SHIFTS.cols_for(k), reg[0::2]) ^ reg[1::2]
        span *= 2
    init = _SHIFTS.advance(np.array([MASK], np.uint32), n)
    return int((init[0] ^ reg[0]) ^ np.uint32(MASK))


def stream_crc(block_crcs) -> int:
    c = 0
    for b in block_crcs:
        c = (((c << 1) | (c >> 31)) & MASK) ^ int(b)
    return c


# --------------------------------------------------------------------------
# markers


def find_magic(stream: bytes, magic: int) -> list[int]:
    """Every bit offset at which the 48-bit ``magic`` starts."""
    arr = np.frombuffer(stream, np.uint8)
    nxt = np.append(arr[1:], np.uint8(0))
    pattern = magic.to_bytes(6, "big")
    found = []
    for s in range(8):
        shifted = arr if s == 0 else ((arr << np.uint8(s)) | (nxt >> np.uint8(8 - s))).astype(np.uint8)
        hay = shifted.tobytes()
        i = hay.find(pattern)
        while i >= 0:
            found.append(8 * i + s)
            i = hay.find(pattern, i + 1)
    return sorted(found)


class _Bits:
    """MSB-first reads from a stream's bytes at absolute bit offsets."""

    def __init__(self, stream: bytes, start: int, end: int):
        self.base = (start >> 3) << 3
        chunk = stream[start >> 3 : (end + 7) // 8 + 8]
        self.bits = np.unpackbits(np.frombuffer(chunk, np.uint8))
        self.end = end - self.base
        self.pos = start - self.base

    def read(self, n: int) -> int:
        if self.pos + n > self.end:
            raise StreamError("block header runs past the block")
        v = 0
        for b in self.bits[self.pos : self.pos + n].tolist():
            v = (v << 1) | b
        self.pos += n
        return v


# --------------------------------------------------------------------------
# one block


def _code_tables(lengths: list[int], eob: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """Step and symbol of every ``width``-bit window for one canonical
    Huffman table (codes by length, then symbol): the step is the code's
    length, negated for the end-of-block symbol, and 0 where the window
    starts no code."""
    order = sorted(range(len(lengths)), key=lambda s: (lengths[s], s))
    code = 0
    prev = lengths[order[0]]
    spans, syms, steps = [], [], []
    for s in order:
        ln = lengths[s]
        code <<= ln - prev
        prev = ln
        if code >= (1 << ln):
            raise StreamError("over-subscribed Huffman code")
        spans.append(1 << (width - ln))
        syms.append(s)
        steps.append(-ln if s == eob else ln)
        code += 1
    size = 1 << width
    sym = np.zeros(size, np.int16)
    step = np.zeros(size, np.int8)
    spans_a = np.array(spans, np.int64)
    cover = int(spans_a.sum())
    sym[:cover] = np.repeat(np.array(syms, np.int16), spans_a)
    step[:cover] = np.repeat(np.array(steps, np.int8), spans_a)
    return step, sym


def _windows(stream: bytes, start: int, n: int, width: int) -> np.ndarray:
    """The ``width`` bits at each absolute bit offset start .. start + n - 1
    (zeros past the stream's end), as uint32."""
    b0 = start >> 3
    seg = np.frombuffer(stream[b0 : b0 + (n + 7) // 8 + 8], np.uint8)
    seg = np.concatenate([seg, np.zeros(8, np.uint8)]).astype(np.uint32)
    w = (seg[:-3] << 24) | (seg[1:-2] << 16) | (seg[2:-1] << 8) | seg[3:]
    # Row j, column r: the window at bit 8j + r.
    win = (w[:, None] << np.arange(8, dtype=np.uint32)[None, :]) >> np.uint32(32 - width)
    off = start - 8 * b0
    return win.reshape(-1)[off : off + n]


def _inverse_rle1(t: np.ndarray) -> np.ndarray:
    """bzip2's first run-length stage undone: after four equal bytes the
    next byte counts further copies, and counting starts again after it."""
    n = t.size
    if n == 0:
        return t
    change = np.empty(n, bool)
    change[0] = True
    np.not_equal(t[1:], t[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    ends = np.append(starts[1:], n)
    long = (ends - starts) >= 4
    pieces = []
    pos = 0
    for s, e in zip(starts[long].tolist(), ends[long].tolist()):
        s = max(s, pos)
        while e - s >= 4:
            if s + 4 >= n:
                raise StreamError("a run of four lacks its count byte")
            pieces.append(t[pos : s + 4])
            pieces.append(np.full(int(t[s + 4]), t[s], np.uint8))
            pos = s = s + 5
    pieces.append(t[pos:])
    return np.concatenate(pieces)


def decode_block(stream: bytes, start: int, end: int, capacity: int) -> tuple[bytes, int]:
    """The bytes of the block whose marker starts at bit ``start`` and whose
    symbol data must end at bit ``end``, and its stored CRC. Raises
    StreamError where the block is malformed or its CRC does not hold."""
    r = _Bits(stream, start, end)
    if r.read(48) != BLOCK_MAGIC:
        raise StreamError("no block marker")
    stored = r.read(32)
    if r.read(1):
        raise StreamError("randomised block")
    orig_ptr = r.read(24)
    ranges = r.read(16)
    used = []
    for i in range(16):
        if ranges & (0x8000 >> i):
            word = r.read(16)
            used.extend(16 * i + j for j in range(16) if word & (0x8000 >> j))
    if not used:
        raise StreamError("empty symbol map")
    alpha = len(used) + 2
    n_groups = r.read(3)
    n_sel = r.read(15)
    if not 2 <= n_groups <= 6 or not 1 <= n_sel <= MAX_SELECTORS:
        raise StreamError("bad table or selector count")
    # Selectors: unary codes, each ended by a 0 bit, then move-to-front.
    zeros = np.flatnonzero(r.bits[r.pos : min(r.end, r.pos + 7 * n_sel)] == 0)[:n_sel]
    if zeros.size < n_sel:
        raise StreamError("selectors run past the block")
    unary = np.diff(np.concatenate([[-1], zeros])) - 1
    if int(unary.max()) >= n_groups:
        raise StreamError("selector out of range")
    r.pos += int(zeros[-1]) + 1
    mtf = list(range(n_groups))
    sel = []
    for j in unary.tolist():
        v = mtf.pop(j)
        mtf.insert(0, v)
        sel.append(v)
    # Code lengths, delta coded.
    bits = r.bits[r.pos : min(r.end, r.pos + n_groups * 258 * 42)].tolist()
    p = 0
    tables = []
    try:
        for _ in range(n_groups):
            cur = (bits[p] << 4) | (bits[p + 1] << 3) | (bits[p + 2] << 2) | (bits[p + 3] << 1) | bits[p + 4]
            p += 5
            lens = []
            for _ in range(alpha):
                while True:
                    if not 1 <= cur <= MAX_CODE:
                        raise StreamError("code length out of range")
                    if not bits[p]:
                        p += 1
                        break
                    cur += -1 if bits[p + 1] else 1
                    p += 2
                lens.append(cur)
            tables.append(lens)
    except IndexError:
        raise StreamError("code tables run past the block") from None
    data = r.base + r.pos + p
    n = end - data
    if n <= 0:
        raise StreamError("no symbol data")
    syms = _huffman(stream, data, n, sel, tables, alpha - 1)
    last = _mtf_rle2(syms, used, capacity)
    if not 0 <= orig_ptr < last.size:
        raise StreamError("origin pointer out of range")
    order = np.argsort(last, kind="stable").astype(np.int32)
    walk = np.empty(last.size, np.int32)
    walk[0] = order[orig_ptr]
    filled, jump = 1, order
    while filled < last.size:
        take = min(filled, last.size - filled)
        walk[filled : filled + take] = jump[walk[:take]]
        filled += take
        if filled < last.size:
            jump = jump[jump]
    raw = _inverse_rle1(last[walk])
    if crc32(raw) != stored:
        raise StreamError("block CRC mismatch")
    return raw.tobytes(), stored


def _huffman(stream: bytes, data: int, n: int, sel: list[int], lengths: list[list[int]], eob: int) -> np.ndarray:
    """The block's symbols before its end-of-block symbol, which must end
    exactly n bits after bit ``data``: each group of 50 codes with its
    selector's table, code after code, each code's length looked up from
    the window of bits where it starts."""
    width = max(max(t) for t in lengths)
    tables = [_code_tables(t, eob, width) for t in lengths]
    win = _windows(stream, data, n, width)
    wv = memoryview(win)
    steps = [memoryview(step) for step, _ in tables]
    at = []
    put = at.append
    p = 0
    done = False
    for t in sel:
        st = steps[t]
        for _ in range(GROUP):
            if p >= n:
                raise StreamError("symbol data runs into the next marker")
            s = st[wv[p]]
            if s <= 0:
                if s == 0 or p - s != n:
                    raise StreamError("invalid code, or an end-of-block symbol before the next marker")
                done = True
                break
            put(p)
            p += s
        if done:
            break
    if not done:
        raise StreamError("selectors run out before the end-of-block symbol")
    at_a = np.array(at, np.int64)
    t_of = np.repeat(np.array(sel, np.int64), GROUP)[: at_a.size]
    syms = np.stack([sym for _, sym in tables]).reshape(-1)
    return syms[(t_of << width) + win[at_a]].astype(np.int64)


def _mtf_rle2(syms: np.ndarray, used: list[int], capacity: int) -> np.ndarray:
    """Runs (RUNA = 0, RUNB = 1, bijective base 2) of the list's front and
    move-to-front indices (symbol - 1) to the BWT's last column."""
    if syms.size == 0:
        return np.zeros(0, np.uint8)
    is_run = syms < 2
    tok_start = np.ones(syms.size, bool)
    tok_start[1:] = ~(is_run[1:] & is_run[:-1])
    tok = np.cumsum(tok_start) - 1
    first = np.flatnonzero(tok_start)
    k = np.arange(syms.size) - first[tok]
    if is_run.any() and int(k[is_run].max()) > 40:
        raise StreamError("run too long")
    weight = np.where(is_run, (syms + 1) << np.minimum(k, 40), 0)
    counts = np.add.reduceat(weight, first)
    tok_run = is_run[first]
    counts[~tok_run] = 1
    if int(counts.sum()) > capacity:
        raise StreamError("block larger than the stream's block size")
    lst = bytearray(used)
    out = bytearray()
    pop, ins, app = lst.pop, lst.insert, out.append
    for j in (syms[first[~tok_run]] - 1).tolist():
        v = pop(j)
        ins(0, v)
        app(v)
    # A run repeats the list's front: the last explicit byte before it, or
    # the first used byte before any.
    front = np.frombuffer(bytes([used[0]]) + bytes(out), np.uint8)
    return np.repeat(front[np.cumsum(~tok_run)], counts)


# --------------------------------------------------------------------------
# whole streams


def _decode_job(job) -> tuple[bytes, int]:
    return decode_block(*job)


def block_jobs(stream: bytes) -> tuple[list[tuple], int]:
    """(stream slice, start, end, capacity) of each block, and the end
    marker's bit; StreamError where the markers do not cover the stream in
    order."""
    if len(stream) < 14 or stream[:3] != b"BZh" or not 0x31 <= stream[3] <= 0x39:
        raise StreamError("no bzip2 stream header")
    capacity = (stream[3] - 0x30) * 100000
    blocks = find_magic(stream, BLOCK_MAGIC)
    ends = find_magic(stream, END_MAGIC)
    if len(ends) != 1:
        raise StreamError(f"{len(ends)} end markers")
    end = ends[0]
    if (blocks and blocks[0] != 32) or (not blocks and end != 32) or (blocks and blocks[-1] > end):
        raise StreamError("markers out of place")
    if len(stream) != (end + 80 + 7) // 8:
        raise StreamError("bytes past the stream's end")
    pad = end + 80
    if pad % 8 and stream[-1] & ((1 << (8 - pad % 8)) - 1):
        raise StreamError("nonzero padding")
    bounds = blocks + [end]
    jobs = []
    for s, e in zip(bounds[:-1], bounds[1:]):
        lo = s >> 3
        jobs.append((stream[lo : (e + 7) // 8 + 8], s - 8 * lo, e - 8 * lo, capacity))
    return jobs, end


def check_stream(stream: bytes, expected: bytes, pool: BlockPool | None = None) -> str | None:
    """None where ``stream`` is one bzip2 stream of exactly ``expected``;
    otherwise what is wrong."""
    try:
        jobs, end = block_jobs(stream)
        results = pool.map(jobs) if pool else [_decode_job(j) for j in jobs]
        r = _Bits(stream, end + 48, end + 80)
        if r.read(32) != stream_crc(crc for _, crc in results):
            raise StreamError("stream CRC mismatch")
    except StreamError as e:
        return str(e)
    got = b"".join(raw for raw, _ in results)
    if got != expected:
        if len(got) != len(expected):
            return f"decodes to {len(got)} bytes, not {len(expected)}"
        first = int(np.flatnonzero(np.frombuffer(got, np.uint8) != np.frombuffer(expected, np.uint8))[0])
        return f"decoded bytes differ from byte {first}"
    return None


def _send(pipe, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    pipe.write(struct.pack("<Q", len(data)))
    pipe.write(data)
    pipe.flush()


def _recv(pipe):
    head = pipe.read(8)
    if len(head) < 8:
        raise EOFError("worker closed its pipe")
    (n,) = struct.unpack("<Q", head)
    return pickle.loads(pipe.read(n))  # only bytes our own workers wrote


class BlockPool:
    """Worker processes that decode blocks for check_stream: each a fresh
    interpreter running this module, given jobs and giving results as
    pickles over its standard input and output. Nothing is shared but the
    pipes, and closing the pool waits for every worker to end."""

    def __init__(self, workers: int | None = None):
        n = workers or min(8, os.cpu_count() or 1)
        root = Path(__file__).resolve().parents[2]
        self.procs = [subprocess.Popen([sys.executable, "-m", "portbench.reference.bzip2_ref"], cwd=root,
                                       stdin=subprocess.PIPE, stdout=subprocess.PIPE) for _ in range(n)]

    def map(self, jobs: list) -> list:
        """decode_block(*job) of every job, in order, on the workers; the
        first StreamError in order is raised."""
        results = [None] * len(jobs)
        todo = list(enumerate(jobs))[::-1]
        idle = list(self.procs)
        busy = {}
        with selectors.DefaultSelector() as sel:
            while todo or busy:
                while idle and todo:
                    proc = idle.pop()
                    i, job = todo.pop()
                    _send(proc.stdin, job)
                    busy[proc] = i
                    sel.register(proc.stdout, selectors.EVENT_READ, proc)
                for key, _ in sel.select():
                    proc = key.data
                    sel.unregister(proc.stdout)
                    results[busy.pop(proc)] = _recv(proc.stdout)
                    idle.append(proc)
        for ok, value in results:
            if not ok:
                raise StreamError(value)
        return [value for _, value in results]

    def close(self) -> None:
        for proc in self.procs:
            proc.stdin.close()
        for proc in self.procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stdout.close()

    def __enter__(self) -> BlockPool:
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _serve() -> None:
    """A BlockPool worker: decode each job read from standard input until
    it closes, answering (True, (bytes, crc)) or (False, what is wrong)."""
    inp, out = sys.stdin.buffer, sys.stdout.buffer
    while True:
        try:
            job = _recv(inp)
        except EOFError:
            return
        try:
            _send(out, (True, decode_block(*job)))
        except StreamError as e:
            _send(out, (False, str(e)))


if __name__ == "__main__":
    _serve()
