"""Streaming compression: bounded memory for arbitrarily large inputs.

Port of bz2tpu/runtime/stream.py. The only cross-batch state of a bzip2
stream is the combined CRC, the sub-byte bit remainder and the raw bytes
not yet encoded; this module carries exactly that state across device
batches, which is also the checkpoint/resume story: a stream can be
suspended and resumed at any batch boundary by saving those values plus
the input offset. The checkpoint blob is bz2tpu's (same JSON, same keys,
``"v": 1``), so a stream checkpointed by either package resumes in the
other.

Each round splits the pending bytes on the host (runtime/compressor.
split_blocks), holds back the trailing block, and sends the rest through
compress's own loop, compressor.encode_parts, in batches of ``parallel``
blocks; each piece of the stream it yields goes to the stitcher: a batch,
or on compress's per-block path a block (through the block mesh where a
process group's ranks divide the batch), as in bz2tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from bz2tpu_torch.format import constants as C
from bz2tpu_torch.format.crc32 import stream_crc_fold
from bz2tpu_torch.runtime import compressor
from bz2tpu_torch.utils.device import resolve_device


class BitStitcher:
    """Incremental bit-aligned concatenation into a byte sink.

    Semantics of the reference's writeFileBytes + getLeftBuffer carry loop
    (include/BitOutputStream.hpp:47-99) as whole-array byte shifts: full
    bytes flush to the sink as they complete; <8 trailing bits carry.
    Appended buffers must be zero-padded past their bit length (BitWriter
    and the device packer both guarantee this).
    """

    def __init__(self, sink) -> None:
        self._sink = sink
        self._carry = 0  # top `carry_bits` bits of the next byte, at LSB
        self._carry_bits = 0
        self.bits_written = 0

    def append(self, data: np.ndarray, nbits: int) -> None:
        if nbits == 0:
            return
        data = np.asarray(data, dtype=np.uint8)[: (nbits + 7) >> 3]
        s = self._carry_bits
        if s == 0:
            shifted = data
        else:
            ext = np.concatenate([np.zeros(1, np.uint8), data])
            shifted = np.concatenate(
                [
                    (ext[:-1] << np.uint8(8 - s)) | (ext[1:] >> np.uint8(s)),
                    (ext[-1:] << np.uint8(8 - s)) & np.uint8(0xFF),
                ]
            )
            shifted = shifted.copy()
            shifted[0] |= np.uint8(self._carry << (8 - s))
        total = s + nbits
        full = total >> 3
        rem = total & 7
        if rem:
            byte = int(shifted[full]) if full < shifted.size else 0
            self._carry = byte >> (8 - rem)
        else:
            self._carry = 0
        self._carry_bits = rem
        self._sink.write(shifted[:full].tobytes())
        self.bits_written += nbits

    def finish(self) -> None:
        """Zero-pad to a byte boundary and flush (reference padding,
        include/BitOutputStream.hpp:129-135)."""
        if self._carry_bits:
            self._sink.write(bytes([(self._carry << (8 - self._carry_bits)) & 0xFF]))
            self.bits_written += 8 - self._carry_bits
            self._carry = 0
            self._carry_bits = 0


class StreamCompressor:
    """Push-style resumable compressor: the checkpoint/resume API.

    The complete cross-batch state of a bzip2 stream at a block boundary is
    (stream CRC, sub-byte stitcher carry, unencoded raw tail).
    ``checkpoint()`` serializes it; ``StreamCompressor(sink, state=...)``
    resumes: feed the remaining input from ``input_offset`` and the
    resulting stream is byte-identical to an uninterrupted run (block
    splitting is deterministic in the byte stream, so chunking/kill points
    never change the output).

    ``device`` defaults to CUDA and raises where there is none; pass
    ``device="cpu"`` for the plain torch path. The device is not part of
    the checkpoint: a stream may resume on another device.

    Typical kill-safe loop::

        sc = StreamCompressor(out, level=9, state=saved)   # state=None: fresh
        for chunk in input_from(sc.input_offset):
            sc.write(chunk)
            save(sc.checkpoint())      # after flushing `out` durably
        sc.close()
    """

    _STATE_VERSION = 1

    def __init__(
        self,
        sink,
        level: int = C.DEFAULT_LEVEL,
        parallel: int | None = None,
        chunk_blocks: int | None = None,
        metrics=None,
        state: bytes | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        from contextlib import nullcontext

        compressor._check_level(level)
        self._device = resolve_device(device)
        self._sink = sink
        self._metrics = metrics
        self._stage = metrics.stage if metrics is not None else (lambda name: nullcontext())
        self._batch = parallel or compressor.DEFAULT_BATCH
        self._chunk_blocks = chunk_blocks or self._batch
        self._stitcher = BitStitcher(sink)
        self._closed = False
        if state is None:
            self.level = level
            self._s_crc = 0
            self.n_blocks = 0
            self._n_batches = 0
            self._pending = b""  # raw bytes accepted but not yet encoded
            self.input_offset = 0  # total raw bytes accepted via write()
            self._stitcher.append(*compressor._stream_header(self.level))
        else:
            self._restore(state)
        self._capacity = C.BLOCK_SIZE_BASE * self.level
        self._threshold = self._capacity * self._chunk_blocks

    # -- checkpoint serialization ----------------------------------------

    def checkpoint(self) -> bytes:
        """Serialize the resume state (call after flushing the sink).

        ``sink_bytes`` records how many bytes this stream has emitted; on
        resume the caller must position/truncate the sink there. The blob
        carries the not-yet-encoded raw tail, so its size is bounded by
        the chunk threshold (~capacity x chunk_blocks bytes right before
        an encode round, a few bytes right after one).
        """
        import base64
        import json

        st = {
            "v": self._STATE_VERSION,
            "level": self.level,
            "s_crc": self._s_crc,
            "n_blocks": self.n_blocks,
            "n_batches": self._n_batches,
            "input_offset": self.input_offset,
            "pending": base64.b64encode(self._pending).decode(),
            "carry": self._stitcher._carry,
            "carry_bits": self._stitcher._carry_bits,
            "bits_written": self._stitcher.bits_written,
            "sink_bytes": (self._stitcher.bits_written - self._stitcher._carry_bits) // 8,
        }
        return json.dumps(st).encode()

    def _restore(self, state: bytes) -> None:
        import base64
        import json

        st = json.loads(state.decode())
        if st.get("v") != self._STATE_VERSION:
            raise ValueError(f"unsupported checkpoint version {st.get('v')}")
        self.level = st["level"]
        self._s_crc = st["s_crc"]
        self.n_blocks = st["n_blocks"]
        self._n_batches = st["n_batches"]
        self.input_offset = st["input_offset"]
        self._pending = base64.b64decode(st["pending"])
        self._stitcher._carry = st["carry"]
        self._stitcher._carry_bits = st["carry_bits"]
        self._stitcher.bits_written = st["bits_written"]

    @staticmethod
    def state_sink_bytes(state: bytes) -> int:
        """Bytes the sink must hold to resume from `state` (truncate to it)."""
        import json

        return json.loads(state.decode())["sink_bytes"]

    # -- streaming ---------------------------------------------------------

    def write(self, data: bytes) -> None:
        if self._closed:
            raise ValueError("write() after close()")
        self._pending += bytes(data)
        self.input_offset += len(data)
        while len(self._pending) >= self._threshold:
            if self._encode(final=False) == 0:
                # Highly compressible input: the pending bytes RLE1-encode
                # into less than one full block; wait for more input.
                break

    def close(self) -> None:
        if self._closed:
            return
        self._encode(final=True)
        self._stitcher.append(*compressor._trailer(self._s_crc))
        self._stitcher.finish()
        self._closed = True
        if self._metrics is not None:
            self._metrics.blocks += self.n_blocks
            self._metrics.batches += self._n_batches
            self._metrics.level = self.level

    def _encode(self, final: bool) -> int:
        """Encode available full blocks; returns raw bytes consumed."""
        data = np.frombuffer(self._pending, dtype=np.uint8)
        with self._stage("rle1_split"):
            blocks = compressor.split_blocks(data, self.level)
        if not final and blocks:
            # Hold back the trailing (possibly partial) block's raw bytes:
            # more input may extend it.
            blocks = blocks[:-1]
        raw_consumed = sum(b.raw_length for b in blocks)
        self._pending = self._pending[raw_consumed:] if not final else b""
        if not blocks:
            return 0
        parts = compressor.encode_parts(compressor.batched(blocks, self._batch), self._batch, self._device)
        while True:
            with self._stage("device_encode"):
                part = next(parts, None)
            if part is None:
                break
            with self._stage("stitch"):
                self._stitcher.append(*part)
        for blk in blocks:
            self._s_crc = stream_crc_fold(self._s_crc, blk.crc)
            self.n_blocks += 1
        self._n_batches += (len(blocks) + self._batch - 1) // self._batch
        return raw_consumed


def compress_stream(
    reader,
    sink,
    level: int = C.DEFAULT_LEVEL,
    parallel: int | None = None,
    chunk_blocks: int | None = None,
    metrics=None,
    device: str | torch.device | None = None,
) -> None:
    """Compress `reader` (binary file-like) into `sink` with bounded memory.

    Reads ~chunk_blocks blocks of raw input at a time, encodes full blocks
    on the device, and carries the partial trailing block's raw bytes into
    the next chunk (see StreamCompressor for the resumable push API).
    """
    sc = StreamCompressor(
        sink, level=level, parallel=parallel, chunk_blocks=chunk_blocks, metrics=metrics,
        device=device,
    )
    read_size = sc._threshold
    while True:
        piece = reader.read(read_size)
        if not piece:
            break
        sc.write(piece)
    sc.close()


def compress_file(
    in_path: str,
    out_path: str,
    level: int = C.DEFAULT_LEVEL,
    parallel: int | None = None,
    metrics=None,
    device: str | torch.device | None = None,
) -> None:
    """Stream-compress a file; the output appears atomically (unique temp +
    rename), so a failure mid-run never leaves a truncated .bz2 behind and
    concurrent compressions to the same path cannot clobber each other."""
    from bz2tpu_torch.utils.atomic import atomic_output

    with open(in_path, "rb") as fin, atomic_output(out_path) as fout:
        compress_stream(fin, fout, level=level, parallel=parallel, metrics=metrics, device=device)
