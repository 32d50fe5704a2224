"""Collective stream assembly: the whole .bz2 stream from every rank's
blocks.

Port of bz2tpu/parallel/stitch.py onto torch.distributed. Every rank:

  1. packs its blocks into one bit-contiguous segment
     (ops/emit.concat_block_words: a prefix sum and two index_add_);
  2. learns every rank's bit total, CRC fold and live count from one small
     all-gather; its segment starts at bit 32 + the exclusive prefix of the
     totals (32: the stream header);
  3. folds the stream CRC: a run of k blocks maps the running CRC s to
     rotl_k(s) XOR F, F the run's own fold from 0, so the ranks' (F, k)
     pairs combine in rank order (format/crc32.stream_crc);
  4. shifts its segment right by its offset & 31, and all-gathers the
     shifted segments, each zero-padded to the longest, as 32-bit words
     (int32 bit patterns). JAX merges stream-sized buffers with a psum
     instead, which moves the whole stream from every shard; this moves
     S x (longest segment) words;
  5. places every segment at word offset >> 5 by addition (boundary words
     hold disjoint bits, so add is or), then the header word and the
     trailer (end marker, stream CRC) the same way: with one rank the
     trailer shares the last segment word.

Every rank returns the same finished stream. Words are int64 masked to 32
bits, as in ops/emit.py, and the CRC arithmetic runs on host ints.
"""

from __future__ import annotations

import torch

from bz2tpu_torch.format import constants as C
from bz2tpu_torch.format.crc32 import stream_crc
from bz2tpu_torch.ops.emit import concat_block_words, words_to_bytes
from bz2tpu_torch.parallel.mesh import BlockMesh, all_gather_padded, gather_ints
from bz2tpu_torch.utils.profiling import StageClock, lap

_HEADER_BITS = 32  # "BZh" + level digit
_TRAILER_BITS = 48 + 32  # end marker + stream CRC
_M32 = 0xFFFFFFFF


def _rotl(s: int, k: int) -> int:
    """Rotate a 32-bit value left by k (any k >= 0)."""
    k %= 32
    return ((s << k) | (s >> (32 - k))) & _M32 if k else s


def _shift_segment(words: torch.Tensor, shift: int) -> torch.Tensor:
    """Shift a word segment right by ``shift`` bits (0..31), one word longer
    on output (the spill word)."""
    out = torch.zeros(words.numel() + 1, dtype=torch.int64, device=words.device)
    out[:-1] += words >> shift
    if shift:
        out[1:] += (words << (32 - shift)) & _M32
    return out


def as_int32(words: torch.Tensor) -> torch.Tensor:
    """32-bit words held in int64 -> the same bit patterns as int32."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def stitch_stream_shard(words, bits, crcs, n_blocks_local: int, level: int, *, mesh: BlockMesh,
                        timings: dict | None = None):
    """This rank's rows -> the complete stream, the same on every rank.

    words (b, W) int64 complete per-block streams (zero past their bits),
    bits (b,) bit counts (0 for padding rows), crcs (b,) block CRCs, all on
    ``mesh.device``; ``n_blocks_local`` the rank's live rows (the first
    ones); ``level`` the header's digit. Returns (stream_bytes, total_bits),
    total_bits counting header, blocks and trailer. With ``timings``, the
    seconds of each step accumulate under "concat", "exchange" (the small
    all-gather), "segments" (shift and all-gather), "place" and "bytes"
    (see utils/profiling.StageClock).
    """
    dev = mesh.device
    clock = None if timings is None else StageClock(timings, dev)

    cat, local_bits = concat_block_words(words, bits)
    local_bits = int(local_bits)
    n_words = (local_bits + 31) >> 5
    fold = stream_crc(crcs[:n_blocks_local].tolist())
    lap(clock, "concat")
    # One small all-gather: every rank's bits, fold, live count and
    # shifted-segment length (its words plus the spill word).
    every = gather_ints([local_bits, fold, n_blocks_local, n_words + 1], mesh)
    totals = [e[0] for e in every]
    offsets = [_HEADER_BITS + sum(totals[:j]) for j in range(mesh.size)]
    tail_off = _HEADER_BITS + sum(totals)
    total_bits = tail_off + _TRAILER_BITS
    crc = 0
    for _, f, k, _ in every:
        crc = _rotl(crc, k) ^ f
    lap(clock, "exchange")

    seg = _shift_segment(cat[:n_words], offsets[mesh.rank] & 31)
    segs, _ = all_gather_padded(as_int32(seg), mesh, shapes=[[e[3]] for e in every])
    lap(clock, "segments")
    out = torch.zeros((total_bits + 31) // 32 + 3, dtype=torch.int64, device=dev)
    for off, s, e in zip(offsets, segs, every):
        w0 = off >> 5
        out[w0 : w0 + e[3]] += s[: e[3]].to(torch.int64) & _M32
    out[0] += (int.from_bytes(C.STREAM_MAGIC, "big") << 8) | (ord("0") + level)
    # The trailer: the 48-bit end marker, then the stream CRC, MSB first.
    trailer = (C.STREAM_END_MARKER << 48 | crc << 16).to_bytes(12, "big")
    tail = torch.tensor([int.from_bytes(trailer[i : i + 4], "big") for i in (0, 4, 8)],
                        dtype=torch.int64, device=dev)
    w0 = tail_off >> 5
    out[w0 : w0 + 4] += _shift_segment(tail, tail_off & 31)
    lap(clock, "place")
    stream = words_to_bytes(out, total_bits)
    lap(clock, "bytes")
    return stream, total_bits


def stitch_stream_sharded(words, bits, crcs, n_live: int, level: int, *, mesh: BlockMesh):
    """The JAX signature over the global batch: every rank passes the same
    (B, W) words, (B,) bits (0 for padding rows) and (B,) crcs, rows >=
    ``n_live`` being padding; each rank stitches with its own rows.

    Returns (stream_bytes, total_bits) on every rank.
    """
    rows = mesh.rows(len(words))
    per = rows.stop - rows.start
    live = max(0, min(per, int(n_live) - rows.start))
    dev = mesh.device
    return stitch_stream_shard(
        torch.as_tensor(words)[rows].to(dev, torch.int64),
        torch.as_tensor(bits)[rows].to(dev, torch.int64),
        torch.as_tensor(crcs)[rows].to(dev, torch.int64),
        live, level, mesh=mesh,
    )
