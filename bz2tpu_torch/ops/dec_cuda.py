"""The Huffman decode's two device loops as CUDA kernels, each beside its
plain torch loop: dec_chain (csrc/dec_chain.cu) and dec_symbols
(csrc/dec_symbols.cu). Both are port-only kernels: each replaces a
lax.fori_loop of the JAX form, not a pl.pallas_call.

dec_chain, step 3 of the jump-map decode (ops/huffman_dec.py): group g of
block b starts where 50 symbols of table tbl[b, g] from the start of group
g - 1 end, cur <- jump50[b, tbl[b, g], cur]. The JAX form runs it as a
device lax.fori_loop (bz2tpu/ops/huffman_dec.py:231-239); in eager torch a
loop of up to 18,002 steps of dependent gathers per bucket is bound by the
host's launch pace, so the port walks it in one kernel, which reads each
step's jump from a window of the map that it fetched into shared memory
some groups ahead, where each table's recent group widths put the group
(see csrc/dec_chain.cu).

dec_symbols, step 4: every group's 50 symbols decoded at its known start
(the 50-step lax.fori_loop at bz2tpu/ops/huffman_dec.py:247-267, some 30
torch launches a step in eager torch), one thread a group, the code lengths
from first-level tables in shared memory (``first_level_tables``: each
bucket of 2^(20 - FIRST_BITS) LUT entries reduced to its length, or 0 where
they differ) and the stream from a register bit buffer.

A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from bz2tpu_torch import _build
from bz2tpu_torch.format import constants as C

# Kernel launches by wrapper (reset to 0 to count one run).
LAUNCHES = {"dec_chain": 0, "dec_symbols": 0}
KMAX = C.HUFFMAN_DECODE_MAX_ACCEPTED_LENGTH  # 20: longer codes are invalid
LUT_BITS = 20  # the code length is a function of the top 20 window bits
FIRST_BITS = 10  # first-level index bits of dec_symbols (csrc/dec_symbols.cu)
_MASK23 = (1 << 23) - 1
SMEM_LIMIT = 232_448  # bytes of shared memory a CTA can have on the H100


def group_starts_ref(jump50: torch.Tensor, tbl: torch.Tensor, n_groups: torch.Tensor) -> torch.Tensor:
    """Plain version: the chain as a loop over the G groups of the batch.
    Entries at and past a block's n_groups repeat its final position."""
    B, T, nbc = jump50.shape
    G = tbl.shape[1]
    flat = jump50.reshape(-1)
    row = torch.arange(B, dtype=torch.int64, device=jump50.device) * T
    tbl = tbl.to(torch.int64)
    cur = torch.zeros(B, dtype=torch.int64, device=jump50.device)
    starts = []
    for g in range(G):
        starts.append(cur)
        nxt = flat[(row + tbl[:, g]) * nbc + cur.clamp(0, nbc - 1)].to(torch.int64)
        cur = torch.where(g < n_groups, nxt, cur)
    if not starts:
        return torch.zeros(B, 0, dtype=torch.int32, device=jump50.device)
    return torch.stack(starts, 1).to(torch.int32)


def group_starts(jump50: torch.Tensor, tbl: torch.Tensor, n_groups: torch.Tensor, *, with_misses: bool = False):
    """Start bit (relative) of every Huffman group of a batch of blocks.

    jump50: (B, T, nbc) int32 50-symbol jump maps; tbl: (B, G) int32
    table per group, in [0, T); n_groups: (B,) int32, at most G. Returns
    (B, G) int32, and with ``with_misses`` also the (B,) int32 count of
    steps that read the map from device memory, not a window (on the CPU
    every step does).
    """
    if jump50.dtype != torch.int32 or jump50.dim() != 3 or not jump50.is_contiguous():
        raise ValueError(f"jump50 must be a contiguous (B, T, nbc) int32 tensor, got {jump50.dtype} {tuple(jump50.shape)}")
    B, T, nbc = jump50.shape
    if tbl.dtype != torch.int32 or tbl.dim() != 2 or tbl.shape[0] != B or not tbl.is_contiguous() or tbl.device != jump50.device:
        raise ValueError(f"tbl must be a contiguous ({B}, G) int32 tensor on {jump50.device}")
    if n_groups.dtype != torch.int32 or n_groups.shape != (B,) or n_groups.device != jump50.device:
        raise ValueError(f"n_groups must be a ({B},) int32 tensor on {jump50.device}")
    if jump50.device.type == "cpu":
        starts = group_starts_ref(jump50, tbl, n_groups)
        return (starts, n_groups.clamp(0, tbl.shape[1])) if with_misses else starts
    if jump50.device.type != "cuda":
        raise ValueError(f"unsupported device {jump50.device}")
    if jump50.data_ptr() % 16:
        raise ValueError("jump50 must start on a 16-byte boundary (the windows are bulk copies)")
    lib = _build.lib()
    G = tbl.shape[1]
    if lib.bz2t_dec_chain_smem(G) > SMEM_LIMIT:
        raise ValueError(f"{G} groups exceed the shared memory of a CTA")
    starts = torch.empty(B, G, dtype=torch.int32, device=jump50.device)
    misses = torch.empty(B, dtype=torch.int32, device=jump50.device)
    stream = torch.cuda.current_stream(jump50.device).cuda_stream
    err = lib.bz2t_dec_chain(
        jump50.data_ptr(), tbl.data_ptr(), n_groups.contiguous().data_ptr(),
        B, T, nbc, G, starts.data_ptr(), misses.data_ptr(), stream,
    )
    _build.check(err, "dec_chain")
    LAUNCHES["dec_chain"] += 1
    return (starts, misses) if with_misses else starts


def window23(words: torch.Tensor, bitpos: torch.Tensor) -> torch.Tensor:
    """23-bit big-endian window value (int64) at each absolute bit position."""
    w32 = words[(bitpos >> 3).clamp(0, words.shape[0] - 1)]
    return (w32 >> (9 - (bitpos & 7))) & _MASK23


def first_level_tables_ref(lut: torch.Tensor, bits: int = FIRST_BITS) -> torch.Tensor:
    """Plain version: each LUT row's 2^bits buckets of 2^(20 - bits)
    consecutive entries, each reduced to the length a decode step takes
    from its entries (above 20: 21, no code; below 1: 1) where they all
    agree on it, and to 0 where they do not."""
    x = lut.view(lut.shape[0], 1 << bits, -1).to(torch.int16)
    step = torch.where(x > KMAX, KMAX + 1, x.clamp(min=1))
    lo, hi = step.amin(2), step.amax(2)
    return torch.where(lo == hi, lo, 0).to(torch.uint8)


def _check_lut(lut: torch.Tensor, dev: torch.device) -> None:
    if lut.dtype != torch.int8 or lut.dim() != 2 or lut.shape[1] != 1 << LUT_BITS or lut.shape[0] == 0 \
            or not lut.is_contiguous() or lut.device != dev:
        raise ValueError(f"lut must be a contiguous (U, 2^{LUT_BITS}) int8 tensor on {dev}")


def first_level_tables(lut: torch.Tensor) -> torch.Tensor:
    """(U, 2^20) int8 code-length LUTs -> (U, 2^FIRST_BITS) uint8
    first-level tables, as first_level_tables_ref: the first pass of
    dec_symbols on the card (decode_groups runs it itself)."""
    _check_lut(lut, lut.device)
    if lut.device.type == "cpu":
        return first_level_tables_ref(lut)
    if lut.device.type != "cuda":
        raise ValueError(f"unsupported device {lut.device}")
    return _first_level_kernel(_build.lib(), lut)


def _first_level_kernel(lib, lut: torch.Tensor) -> torch.Tensor:
    if lut.data_ptr() % 16:
        raise ValueError("lut must start on a 16-byte boundary (the first pass reads 16 bytes at once)")
    first = torch.empty(lut.shape[0], lib.bz2t_lut_first_entries(), dtype=torch.uint8, device=lut.device)
    stream = torch.cuda.current_stream(lut.device).cuda_stream
    _build.check(lib.bz2t_lut_first_level(lut.data_ptr(), lut.shape[0], first.data_ptr(), stream),
                 "lut_first_level")
    return first


def decode_groups_ref(words, offs, tbl, lut, lut_idx, base, perm) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the 50-step loop over all groups of the batch at once."""
    B, G = tbl.shape
    T = base.shape[1]
    group = C.HUFFMAN_GROUP_SIZE
    alpha = C.HUFFMAN_MAX_ALPHABET
    bt = torch.arange(B, device=words.device)[:, None] * T + tbl.long()  # (B, G) table row
    lut_g = lut_idx.long().gather(1, tbl.long()) << LUT_BITS
    flat_lut, flat_base, flat_perm = lut.view(-1), base.reshape(-1), perm.reshape(-1)
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
    flat_syms = torch.stack(syms, 2).view(B, G * group).to(torch.int32)
    flat_lens = torch.stack(lens, 2).view(B, G * group).to(torch.int32)
    return flat_syms, flat_lens


def decode_groups(words, offs, tbl, lut, lut_idx, base, perm) -> tuple[torch.Tensor, torch.Tensor]:
    """The 50 symbols of every Huffman group of a batch, each group decoded
    from its known start bit.

    words: (NB,) int64 window words of a byte stream (huffman_dec.window_words,
    as runtime/device_decode.stream_words pads it: the kernel reads the
    stream's bytes from them four at a time); offs: (B, G) int64
    absolute start bit of each group; tbl: (B, G) int32 table per group, in
    [0, T); lut: (U, 2^20) int8 code-length LUTs; lut_idx: (B, T) int32 LUT
    row per table, in [0, U); base: (B, T, 21) and perm: (B, T, 258) int32
    canonical tables, T at most 6. Returns (symbols, lengths), each (B,
    G * 50) int32: -2 for a window that holds no valid code, and length 1
    where no length is acceptable.
    """
    dev = words.device
    if words.dtype != torch.int64 or words.dim() != 1 or words.numel() == 0 or not words.is_contiguous():
        raise ValueError(f"words must be a contiguous non-empty (NB,) int64 tensor, got {words.dtype} {tuple(words.shape)}")
    if offs.dtype != torch.int64 or offs.dim() != 2 or not offs.is_contiguous() or offs.device != dev:
        raise ValueError(f"offs must be a contiguous (B, G) int64 tensor on {dev}")
    B, G = offs.shape
    if tbl.dtype != torch.int32 or tbl.shape != (B, G) or not tbl.is_contiguous() or tbl.device != dev:
        raise ValueError(f"tbl must be a contiguous ({B}, {G}) int32 tensor on {dev}")
    _check_lut(lut, dev)
    if base.dtype != torch.int32 or base.dim() != 3 or base.shape[0] != B or base.shape[2] != KMAX + 1 \
            or not base.is_contiguous() or base.device != dev:
        raise ValueError(f"base must be a contiguous ({B}, T, {KMAX + 1}) int32 tensor on {dev}")
    T = base.shape[1]
    if not 1 <= T <= C.HUFFMAN_MAX_TABLES:
        raise ValueError(f"{T} tables a block; bzip2 has 1 to {C.HUFFMAN_MAX_TABLES}")
    if perm.dtype != torch.int32 or perm.shape != (B, T, C.HUFFMAN_MAX_ALPHABET) or not perm.is_contiguous() \
            or perm.device != dev:
        raise ValueError(f"perm must be a contiguous ({B}, {T}, {C.HUFFMAN_MAX_ALPHABET}) int32 tensor on {dev}")
    if lut_idx.dtype != torch.int32 or lut_idx.shape != (B, T) or not lut_idx.is_contiguous() or lut_idx.device != dev:
        raise ValueError(f"lut_idx must be a contiguous ({B}, {T}) int32 tensor on {dev}")
    if dev.type == "cpu":
        return decode_groups_ref(words, offs, tbl, lut, lut_idx, base, perm)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if B > 65_535:
        raise ValueError(f"{B} blocks exceed the kernel's grid")
    lib = _build.lib()
    first = _first_level_kernel(lib, lut)
    n = G * C.HUFFMAN_GROUP_SIZE
    syms = torch.empty(B, n, dtype=torch.int32, device=dev)
    lens = torch.empty(B, n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.bz2t_dec_symbols(
        words.data_ptr(), words.numel(), offs.data_ptr(), tbl.data_ptr(), lut.data_ptr(), lut.shape[0],
        first.data_ptr(), lut_idx.data_ptr(), base.data_ptr(), perm.data_ptr(), B, T, G, syms.data_ptr(),
        lens.data_ptr(), stream,
    )
    _build.check(err, "dec_symbols")
    LAUNCHES["dec_symbols"] += 1
    return syms, lens
