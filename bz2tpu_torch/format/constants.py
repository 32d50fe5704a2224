"""bzip2 bitstream format constants.

Parity note: the reference centralizes format constants in
include/Config.hpp:27-47 but deliberately downscales the block size
(BLOCKSIZE_DEFAULT = 10000, Config.hpp:30) so "level 1-9" means 10-90 kB
blocks. This framework targets the *standard* bzip2 format: level N means
N * 100_000 byte blocks, so our output interoperates with stock bzip2 in both
directions (the reference's decoder rejects real 100k-scale blocks,
include/BlockDecompressor.hpp:213-215).
"""

# --- Stream container markers (Config.hpp:33-37 equivalents) ---
STREAM_MAGIC = b"BZh"  # followed by ASCII '1'..'9' level digit
BLOCK_HEADER_MARKER = 0x314159265359  # 48 bits, "pi"
STREAM_END_MARKER = 0x177245385090  # 48 bits, "sqrt(pi)"

# --- Block sizing (standard bzip2, NOT the reference's 10k downscale) ---
BLOCK_SIZE_BASE = 100_000
MIN_LEVEL = 1
MAX_LEVEL = 9
DEFAULT_LEVEL = 9
# Stock bzip2's block-fill threshold (bzlib: nblockMAX = 100000*bs - 19):
# RLE1 pieces flush while the block output is below this, so the crossing
# piece can overshoot by up to 4 bytes (true stored maximum: capacity + 4).
# Verified against libbz2's own block spans (tests/test_native.py).
BLOCK_CAPACITY_SLACK = 19


def block_capacity(level: int) -> int:
    """Stock's block-fill threshold (nblockMAX); blocks may store up to
    4 bytes more (the crossing RLE1 piece, see BLOCK_CAPACITY_SLACK)."""
    if not MIN_LEVEL <= level <= MAX_LEVEL:
        raise ValueError(f"block size level must be 1..9, got {level}")
    return BLOCK_SIZE_BASE * level - BLOCK_CAPACITY_SLACK


# --- Huffman coding limits (Config.hpp:39-46 equivalents, at standard scale) ---
HUFFMAN_MIN_TABLES = 2
HUFFMAN_MAX_TABLES = 6
HUFFMAN_GROUP_SIZE = 50
# Standard scale: 2 + 900000/50 (the reference scales this down to 1801,
# Config.hpp:41, which is why it can't decode stock bzip2 streams).
HUFFMAN_MAX_SELECTORS = 2 + (BLOCK_SIZE_BASE * MAX_LEVEL) // HUFFMAN_GROUP_SIZE
HUFFMAN_MAX_ALPHABET = 258  # 256 byte values + RUNA/RUNB share space with EOB
HUFFMAN_ENCODE_MAX_LENGTH = 17  # stock bzip2 encoder cap (1.0.x)
HUFFMAN_DECODE_MAX_LENGTH = 23  # decoder table size; lengths 1..20 accepted
HUFFMAN_DECODE_MAX_ACCEPTED_LENGTH = 20

# CAP on group->table assignment refinement passes. Stock bzip2 runs 4
# fixed (BZ_N_ITERS); we iterate TO CONVERGENCE — the pass is monotone
# non-increasing in total model cost (argmin reassignment can only lower
# cost under fixed lengths; the per-table length refit is optimal for the
# new partition), and once the selector assignment repeats, rfreq and
# hence the lengths are a fixed point. Typical blocks converge well
# under the old fixed count of 8, so the exit makes the stage FASTER,
# while hard blocks keep buying bytes past 8 (measured: 8 -> 12 passes =
# -175 bytes on the bench corpus; the round-4 sweep's level-6 row sat
# +0.00006 above stock — VERDICT r4 item 5). Each pass is one
# (maxsel,258)x(258,6) MXU matmul + argmin + 6 table rebuilds.
HUFFMAN_REFINE_ITERS = 32

# --- RLE2 run symbols ---
RUNA = 0
RUNB = 1

# --- RLE1 (first stage) ---
RLE1_MIN_RUN = 4  # runs of 4..255 become 4 literals + count byte
RLE1_MAX_RUN = 255 + RLE1_MIN_RUN  # a single count byte covers up to 255 extra


# Symbol-count thresholds for 3, 4, 5, 6 Huffman tables (below the first:
# 2 tables). Stock bzip2 / reference selectTableCount, kernel.cpp:2808-2818.
# The JAX form (bz2tpu.ops.huffman.table_count) derives from this tuple too.
TABLE_COUNT_THRESHOLDS = (200, 600, 1200, 2400)


def table_count_for_symbols(n_symbols: int) -> int:
    """Number of Huffman tables for a block with n_symbols MTF/RLE2 symbols."""
    return HUFFMAN_MIN_TABLES + sum(n_symbols >= t for t in TABLE_COUNT_THRESHOLDS)

# --- legacy block randomisation (bzip2 0.9.0) ---
# The 512-entry XOR schedule for "randomised" blocks. Format-defined
# constants (bzip2's randtable.c), extracted from the installed
# libbz2.so.1.0.4 on this image and verified against it: a crafted
# randomised stream derandomised with this table decodes identically under
# stock bzip2 (tests/test_randomised.py). Modern encoders (ours included,
# like the reference: OutputStream.hpp:211) never SET the bit; stock bzip2
# still decodes such streams, so the decoders here do too — one direction
# beyond the reference, which rejects them
# (include/BlockDecompressor.hpp:274-277).
RAND_NUMS = (
    619, 720, 127, 481, 931, 816, 813, 233, 566, 247, 985, 724,
    205, 454, 863, 491, 741, 242, 949, 214, 733, 859, 335, 708,
    621, 574, 73, 654, 730, 472, 419, 436, 278, 496, 867, 210,
    399, 680, 480, 51, 878, 465, 811, 169, 869, 675, 611, 697,
    867, 561, 862, 687, 507, 283, 482, 129, 807, 591, 733, 623,
    150, 238, 59, 379, 684, 877, 625, 169, 643, 105, 170, 607,
    520, 932, 727, 476, 693, 425, 174, 647, 73, 122, 335, 530,
    442, 853, 695, 249, 445, 515, 909, 545, 703, 919, 874, 474,
    882, 500, 594, 612, 641, 801, 220, 162, 819, 984, 589, 513,
    495, 799, 161, 604, 958, 533, 221, 400, 386, 867, 600, 782,
    382, 596, 414, 171, 516, 375, 682, 485, 911, 276, 98, 553,
    163, 354, 666, 933, 424, 341, 533, 870, 227, 730, 475, 186,
    263, 647, 537, 686, 600, 224, 469, 68, 770, 919, 190, 373,
    294, 822, 808, 206, 184, 943, 795, 384, 383, 461, 404, 758,
    839, 887, 715, 67, 618, 276, 204, 918, 873, 777, 604, 560,
    951, 160, 578, 722, 79, 804, 96, 409, 713, 940, 652, 934,
    970, 447, 318, 353, 859, 672, 112, 785, 645, 863, 803, 350,
    139, 93, 354, 99, 820, 908, 609, 772, 154, 274, 580, 184,
    79, 626, 630, 742, 653, 282, 762, 623, 680, 81, 927, 626,
    789, 125, 411, 521, 938, 300, 821, 78, 343, 175, 128, 250,
    170, 774, 972, 275, 999, 639, 495, 78, 352, 126, 857, 956,
    358, 619, 580, 124, 737, 594, 701, 612, 669, 112, 134, 694,
    363, 992, 809, 743, 168, 974, 944, 375, 748, 52, 600, 747,
    642, 182, 862, 81, 344, 805, 988, 739, 511, 655, 814, 334,
    249, 515, 897, 955, 664, 981, 649, 113, 974, 459, 893, 228,
    433, 837, 553, 268, 926, 240, 102, 654, 459, 51, 686, 754,
    806, 760, 493, 403, 415, 394, 687, 700, 946, 670, 656, 610,
    738, 392, 760, 799, 887, 653, 978, 321, 576, 617, 626, 502,
    894, 679, 243, 440, 680, 879, 194, 572, 640, 724, 926, 56,
    204, 700, 707, 151, 457, 449, 797, 195, 791, 558, 945, 679,
    297, 59, 87, 824, 713, 663, 412, 693, 342, 606, 134, 108,
    571, 364, 631, 212, 174, 643, 304, 329, 343, 97, 430, 751,
    497, 314, 983, 374, 822, 928, 140, 206, 73, 263, 980, 736,
    876, 478, 430, 305, 170, 514, 364, 692, 829, 82, 855, 953,
    676, 246, 369, 970, 294, 750, 807, 827, 150, 790, 288, 923,
    804, 378, 215, 828, 592, 281, 565, 555, 710, 82, 896, 831,
    547, 261, 524, 462, 293, 465, 502, 56, 661, 821, 976, 991,
    658, 869, 905, 758, 745, 193, 768, 550, 608, 933, 378, 286,
    215, 979, 792, 961, 61, 688, 793, 644, 986, 403, 106, 366,
    905, 644, 372, 567, 466, 434, 645, 210, 389, 550, 919, 135,
    780, 773, 635, 389, 707, 100, 626, 958, 165, 504, 920, 176,
    193, 713, 857, 265, 203, 50, 668, 108, 645, 990, 626, 197,
    510, 357, 358, 850, 858, 364, 936, 638,
)
