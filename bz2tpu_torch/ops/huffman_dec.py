"""Canonical-Huffman decode of a batch of bzip2 blocks (torch).

Port of bz2tpu/ops/huffman_dec.py (the jump-map decode), batched over the
blocks of a bucket:

  1. for every bit position p of a block's symbol data and each table,
     the length of a code starting at p, from a shared (U, 2^20) int8
     length LUT indexed by the top 20 bits of the 23-bit window;
  2. jump_t(p) = p + len_t(p) composed into the 50-symbol jump_t^50(p) by
     pointer doubling (50 = 32 + 16 + 2), all tables of all blocks in one
     flat int32 map;
  3. the serial chain of group starts through the selectors, the kernel
     ``dec_chain`` (ops/dec_cuda.py; a lax.fori_loop in the JAX form);
  4. a 50-step pass re-decodes every group's symbols at its known start.

Validation is exact: the bit after EOB must be the block's end bit from
the marker scan. Only the default int32 absolute-jump composition of the
JAX form is ported (not its BZ2TPU_DEC_I16 variant).
"""

from __future__ import annotations

import numpy as np
import torch

from bz2tpu.format import constants as C
from bz2tpu_torch.ops.dec_cuda import group_starts

KMAX = C.HUFFMAN_DECODE_MAX_ACCEPTED_LENGTH  # 20: longer codes are invalid
LUT_BITS = 20  # the code length is a function of the top 20 window bits
_MASK23 = (1 << 23) - 1


def build_len_luts(thr: torch.Tensor) -> torch.Tensor:
    """(U, 21) int32 thresholds -> (U, 2^20) int8 code-length LUTs.

    The length at window value v23 is #(thr[k] <= v23); every threshold
    is a multiple of 8, so it is a function of v23 >> 3: a scatter of the
    21 boundaries and a cumsum, both in int8 (counts reach 21 at most).
    """
    u = thr.shape[0]
    thr3 = (thr >> 3).clamp(0, 1 << LUT_BITS).long()
    hist = torch.zeros(u, (1 << LUT_BITS) + 1, dtype=torch.int8, device=thr.device)
    hist.scatter_add_(1, thr3, torch.ones_like(thr3, dtype=torch.int8))
    return torch.cumsum(hist[:, :-1], 1, dtype=torch.int8)


def decode_tables_arrays(
    tables: list,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack oracle (limit, base, perm, min_len) tuples into arrays (NumPy,
    as bz2tpu.ops.huffman_dec.decode_tables_arrays).

    Bit counts below min_len get limit -1, counts beyond a table's max
    length limit 2^23. ``thr`` holds the 23-bit left-justified acceptance
    thresholds min((limit + 1) << (23 - k), 2^23), made nondecreasing in k.
    """
    n = len(tables)
    limit = np.full((6, KMAX + 1), -1, dtype=np.int64)
    base = np.zeros((6, KMAX + 1), dtype=np.int64)
    perm = np.zeros((6, C.HUFFMAN_MAX_ALPHABET), dtype=np.int32)
    for t, (lim, bas, prm, min_l) in enumerate(tables):
        for k in range(min_l, KMAX + 1):
            v = lim[k] if k < lim.size else np.iinfo(np.int64).max
            limit[t, k] = min(int(v), 1 << 23)
            if k < bas.size:
                base[t, k] = int(bas[k])
        perm[t, : prm.size] = prm
    ks = np.arange(KMAX + 1)
    thr = np.minimum((limit + 1) << (23 - ks)[None, :], 1 << 23)
    thr = np.maximum.accumulate(thr, axis=1)
    return (
        limit[:n].astype(np.int32),
        base[:n].astype(np.int32),
        perm[:n],
        thr[:n].astype(np.int32),
    )


def window_words(stream: torch.Tensor) -> torch.Tensor:
    """(NB,) uint8 stream -> (NB,) int64 big-endian 32-bit word starting at
    each byte; bytes past the end repeat the last one (the JAX form's
    clipped gather)."""
    s = stream.to(torch.int64)
    ext = torch.cat([s, s[-1:].expand(3)])
    return (ext[:-3] << 24) | (ext[1:-2] << 16) | (ext[2:-1] << 8) | ext[3:]


def window23(words: torch.Tensor, bitpos: torch.Tensor) -> torch.Tensor:
    """23-bit big-endian window value (int64) at each absolute bit position."""
    w32 = words[(bitpos >> 3).clamp(0, words.shape[0] - 1)]
    return (w32 >> (9 - (bitpos & 7))) & _MASK23


def jump50_maps(
    words: torch.Tensor,
    start_bit: torch.Tensor,
    lut: torch.Tensor,
    lut_idx: torch.Tensor,
    n_bits_cap: int,
) -> torch.Tensor:
    """Steps 1-2: (B, T, n_bits_cap) int32 50-symbol jump maps, relative
    to each block's start bit and clipped to n_bits_cap - 1."""
    B, T = lut_idx.shape
    nbc = n_bits_cap
    if B * T * nbc >= 2**31:
        raise ValueError(f"{B} x {T} x {nbc} jump entries exceed int32 indices")
    dev = words.device
    p_rel = torch.arange(nbc, dtype=torch.int64, device=dev)
    v20 = window23(words, start_bit.to(torch.int64)[:, None] + p_rel) >> 3  # (B, nbc)
    seg = (torch.arange(B * T, dtype=torch.int64, device=dev) * nbc).view(B, T)
    flat_lut = lut.view(-1)
    j = torch.empty(B, T, nbc, dtype=torch.int32, device=dev)
    for t in range(T):
        lens = flat_lut[(lut_idx[:, t : t + 1].long() << LUT_BITS) + v20].to(torch.int64)
        # No acceptable length (malformed stream): advance one bit.
        lens = torch.where(lens > KMAX, 1, lens.clamp(min=1))
        j[:, t] = ((p_rel + lens).clamp(max=nbc - 1) + seg[:, t : t + 1]).to(torch.int32)
        del lens
    del v20
    # Pointer doubling in one flat map; each step frees what it no longer needs.
    j = j.view(-1)
    j2 = j[j]
    del j
    j16 = j2
    for _ in range(3):  # j4, j8, j16
        j16 = j16[j16]
    j16_2 = j16[j2]  # 18 symbols forward
    del j2
    j32 = j16[j16]
    del j16
    j50 = j32[j16_2]  # 32 + 16 + 2 = 50 symbols forward
    del j32, j16_2
    return j50.view(B, T, nbc) - seg.to(torch.int32)[:, :, None]


def decode_symbol_data(
    words: torch.Tensor,
    start_bit: torch.Tensor,
    end_bit: torch.Tensor,
    selectors: torch.Tensor,
    n_groups: torch.Tensor,
    base: torch.Tensor,
    perm: torch.Tensor,
    eob: torch.Tensor,
    lut: torch.Tensor,
    lut_idx: torch.Tensor,
    *,
    n_bits_cap: int,
) -> dict[str, torch.Tensor]:
    """Decode the Huffman symbol data of a batch of B blocks.

    words: (NB,) int64 from window_words of the whole stream (bit
    offsets are absolute); start_bit/end_bit: (B,) symbol-data bit ranges
    (end = the next marker from the native scan); selectors: (B, G) int32
    table per 50-symbol group (0 padded); n_groups: (B,) int32 true group
    counts; base (B, T, 21) / perm (B, T, 258) int32 canonical tables
    (decode_tables_arrays); eob: (B,) int32 (alpha_size - 1); lut: (U,
    2^20) int8 (build_len_luts) with lut_idx (B, T) its row per table.

    Returns dict with symbols (B, G*50) int32 (-1 past n_sym), n_sym (B,)
    int32 and ok (B,) bool (EOB lands exactly at end_bit).
    """
    B, G = selectors.shape
    T = base.shape[1]
    dev = words.device
    group = C.HUFFMAN_GROUP_SIZE
    alpha = C.HUFFMAN_MAX_ALPHABET
    start_bit = start_bit.to(torch.int64)
    tbl = selectors.clamp(0, T - 1).to(torch.int32).contiguous()

    jump50 = jump50_maps(words, start_bit, lut, lut_idx, n_bits_cap)
    starts = group_starts(jump50, tbl, n_groups.to(torch.int32).contiguous())
    del jump50

    # --- 4. every group's 50 symbols at its known start ---------------------
    bt = torch.arange(B, device=dev)[:, None] * T + tbl.long()  # (B, G) table row
    lut_g = lut_idx.long().gather(1, tbl.long()) << LUT_BITS
    flat_lut, flat_base, flat_perm = lut.view(-1), base.reshape(-1), perm.reshape(-1)
    offs = start_bit[:, None] + starts.long()
    syms, lens = [], []
    for _ in range(group):
        v = window23(words, offs)
        ln = flat_lut[lut_g + (v >> 3)].to(torch.int64)
        matched = ln <= KMAX
        ln = torch.where(matched, ln.clamp(min=1), 1)
        pidx = (v >> (23 - ln)) - flat_base[bt * (KMAX + 1) + ln]
        bad = ~matched | (pidx < 0) | (pidx >= alpha)
        sym = flat_perm[bt * alpha + pidx.clamp(0, alpha - 1)]
        syms.append(torch.where(bad, -2, sym))
        lens.append(ln)
        offs = offs + ln
    flat_syms = torch.stack(syms, 2).view(B, G * group)
    flat_lens = torch.stack(lens, 2).view(B, G * group)

    # --- EOB trim + exact validation ----------------------------------------
    sym_valid = (torch.arange(G, device=dev)[None, :] < n_groups[:, None]).repeat_interleave(group, 1)
    is_eob = (flat_syms == eob[:, None]) & sym_valid
    n_sym = (torch.argmax(is_eob.to(torch.uint8), 1) + 1).to(torch.int32)
    keep = torch.arange(G * group, device=dev)[None, :] < n_sym[:, None]
    bits_used = torch.where(keep & sym_valid, flat_lens, 0).sum(1)
    end_ok = (start_bit + bits_used) == end_bit
    no_bad = ~(keep & (flat_syms == -2)).any(1)
    fits = (end_bit - start_bit) <= n_bits_cap
    ok = is_eob.any(1) & end_ok & no_bad & fits
    return {"symbols": torch.where(keep, flat_syms, -1), "n_sym": n_sym, "ok": ok}
