"""Bitstream emission: a batch of blocks -> one packed, concatenated word
stream (torch).

Port of bz2tpu/ops/emit.py (block_header_parts, _block_elements,
pack_blocks_concat). Each block is a sequence of (value, bit-length)
elements, header slots first, then the Huffman code of every symbol; the
bit offset of an element is a prefix sum, and each element lands in its
32-bit word (and spills into the next) by two index_add_ passes: bit
ranges are disjoint, so add equals or.

Words are carried as int64 masked to 32 bits (torch has no CPU shift or
scatter-add for uint32) and become big-endian uint32 only at the byte
boundary on the host.
"""

from __future__ import annotations

import torch

from bz2tpu.format import constants as C
from bz2tpu_torch.ops.huffman import ALPHA, NTAB

_I64 = torch.int64
_M32 = 0xFFFFFFFF


def packed_words(capacity: int) -> int:
    """Word count covering the worst-case symbol data of one block."""
    return ((capacity + 1) * C.HUFFMAN_ENCODE_MAX_LENGTH + 20 + 31) // 32 + 2


def header_words(maxsel: int) -> int:
    """Word count covering the worst-case header of one block."""
    bits = (
        48 + 32 + 1 + 24 + 16 + 16 * 16 + 3 + 15
        + 6 * maxsel
        + 6 * (5 + ALPHA * (2 * C.HUFFMAN_ENCODE_MAX_LENGTH + 3))
    )
    return bits // 32 + 2


def block_header_parts(crcs, orig_ptrs, used, n_groups, n_selectors, selector_mtf, lengths, *, maxsel: int):
    """Every block header of a batch as (values, bit-lengths) (B, E) int64.

    Fixed slots, as bz2tpu.ops.emit.block_header_parts: marker(24+24)
    crc(16+16) randomised(1) origPtr(24) ranges(16) 16 x row(16|0)
    nGroups(3) nSelectors(15) maxsel x unary(rank+1|0) 6 x [init(5|0),
    258 x (moves <= 20 bits, moves + stop)]. A 0-bit slot carries value 0.
    """
    B = crcs.shape[0]
    dev = crcs.device
    crc = crcs.to(_I64) & _M32
    fixed_vals = torch.stack(
        [
            torch.full_like(crc, 0x314159),
            torch.full_like(crc, 0x265359),
            (crc >> 16) & 0xFFFF,
            crc & 0xFFFF,
            torch.zeros_like(crc),
            orig_ptrs.to(_I64),
        ],
        1,
    )
    fixed_lens = torch.tensor([24, 24, 16, 16, 1, 24], dtype=_I64, device=dev).expand(B, 6)

    used_m = used.view(B, 16, 16)
    range_used = used_m.any(2)
    pow16 = 1 << (15 - torch.arange(16, dtype=_I64, device=dev))
    ranges_val = torch.where(range_used, pow16, 0).sum(1, keepdim=True)
    row_vals = torch.where(used_m, pow16, 0).sum(2)
    row_lens = torch.where(range_used, 16, 0)

    counts_vals = torch.stack([n_groups.to(_I64), n_selectors.to(_I64)], 1)
    counts_lens = torch.tensor([3, 15], dtype=_I64, device=dev).expand(B, 2)

    sel_rank = selector_mtf.to(_I64)
    sel_valid = torch.arange(maxsel, device=dev)[None, :] < n_selectors[:, None]
    sel_lens = torch.where(sel_valid, sel_rank + 1, 0)
    sel_vals = torch.where(sel_valid, (1 << (sel_rank + 1)) - 2, 0)

    L = lengths.to(_I64)  # (B, 6, 258)
    t_valid = torch.arange(NTAB, device=dev)[None, :, None] < n_groups[:, None, None]
    alpha = used.sum(1) + 2
    v_valid = torch.arange(ALPHA, device=dev)[None, None, :] < alpha[:, None, None]
    mask = t_valid & v_valid
    prev = torch.cat([L[:, :, :1], L[:, :, :-1]], 2)
    delta = torch.where(mask, L - prev, 0)
    moves = delta.abs()
    pat = torch.where(delta > 0, 2, 3)
    half = C.HUFFMAN_ENCODE_MAX_LENGTH // 2 + 2  # slot-A move cap (<= 32 bits)
    ka = moves.clamp(max=half)
    kb = moves - ka
    # k repetitions of the 2-bit pattern p have value p * (4^k - 1) / 3.
    val_a = pat * (((1 << (2 * ka)) - 1) // 3)
    len_a = torch.where(mask, 2 * ka, 0)
    val_b = (pat * (((1 << (2 * kb)) - 1) // 3)) << 1  # trailing 0 = stop bit
    len_b = torch.where(mask, 2 * kb + 1, 0)
    moves_vals = torch.stack([val_a, val_b], 3).view(B, NTAB, 2 * ALPHA)
    moves_lens = torch.stack([len_a, len_b], 3).view(B, NTAB, 2 * ALPHA)
    init_vals = torch.where(t_valid, L[:, :, :1], 0)
    init_lens = torch.where(t_valid, 5, 0).expand(B, NTAB, 1)
    tab_vals = torch.cat([init_vals, moves_vals], 2).view(B, -1)
    tab_lens = torch.cat([init_lens, moves_lens], 2).reshape(B, -1)

    vals = torch.cat([fixed_vals, ranges_val, row_vals, counts_vals, sel_vals, tab_vals], 1)
    lens = torch.cat([fixed_lens, torch.full_like(ranges_val, 16), row_lens, counts_lens, sel_lens, tab_lens], 1)
    return vals, lens


def block_elements(symbols, selectors, lengths, codes, hdr_vals, hdr_lens, *, maxsel: int):
    """Each block's full (values, bit-lengths, valid) element sequence:
    header slots, then the code of every symbol under its group's table
    (one gather of (code << 5) | length)."""
    B, S = symbols.shape
    dev = symbols.device
    gid = (torch.arange(S, device=dev) // C.HUFFMAN_GROUP_SIZE).clamp(max=maxsel - 1)
    sel = selectors.to(_I64).gather(1, gid.expand(B, S))
    valid = symbols >= 0
    sym = symbols.to(_I64).clamp(0, ALPHA - 1)
    comb = ((codes.to(_I64) << 5) | lengths.to(_I64)).view(B, NTAB * ALPHA)
    cv = comb.gather(1, sel * ALPHA + sym)
    vals = torch.cat([hdr_vals, torch.where(valid, cv >> 5, 0)], 1)
    lens = torch.cat([hdr_lens, torch.where(valid, cv & 31, 0)], 1)
    ok = torch.cat([torch.ones_like(hdr_vals, dtype=torch.bool), valid], 1)
    return vals, lens, ok


def pack_blocks_concat(symbols, selectors, lengths, codes, crcs, orig_ptrs, used,
                       n_groups, n_selectors, selector_mtf, *, maxsel: int):
    """Pack a batch's blocks into ONE concatenated word stream.

    Arguments are the (B, ...) batch forms of bz2tpu.ops.emit.pack_block's
    (no padding rows: every block is live). Returns (words (B*Wb + 1,)
    int64 holding 32-bit MSB-first words, total_bits 0-dim int64,
    block_bits (B,) int64), Wb = packed_words(S - 2) + header_words(maxsel).
    """
    B, S = symbols.shape
    w_out = B * (packed_words(S - 2) + header_words(maxsel)) + 1
    hdr_vals, hdr_lens = block_header_parts(
        crcs, orig_ptrs, used, n_groups, n_selectors, selector_mtf, lengths, maxsel=maxsel
    )
    vals, lens, ok = block_elements(
        symbols, selectors, lengths, codes, hdr_vals, hdr_lens, maxsel=maxsel
    )
    ends = torch.cumsum(lens, 1)
    block_bits = ends[:, -1]
    bases = torch.cumsum(block_bits, 0) - block_bits
    total_bits = block_bits.sum()
    offsets = bases[:, None] + ends - lens  # global bit offsets

    bitpos = offsets & 31
    spills = lens + bitpos > 32
    spill = (lens + bitpos - 32).clamp(0, 31)
    fit = (32 - bitpos - lens).clamp(0, 31)
    hi = torch.where(spills, vals >> spill, (vals << fit) & _M32)
    lo = torch.where(spills, (vals << (32 - spill).clamp(0, 31)) & _M32, 0)
    w0 = offsets >> 5
    out = torch.zeros(w_out + 1, dtype=_I64, device=symbols.device)  # + trash
    out.index_add_(0, torch.where(ok, w0, w_out).view(-1), hi.view(-1))
    out.index_add_(0, torch.where(ok, w0 + 1, w_out).view(-1), lo.view(-1))
    return out[:w_out], total_bits, block_bits
