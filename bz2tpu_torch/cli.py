"""bz2tpu_torch command line: compress a file on the card, or decode and
check one with the shared host decoder.

    python -m bz2tpu_torch FILE [--size N] [-o OUT]      compress
    python -m bz2tpu_torch FILE.bz2 --dec [-o OUT]       decompress
    python -m bz2tpu_torch FILE.bz2 --check              CRC check

The thin counterpart of bz2tpu/cli.py's default backend.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m bz2tpu_torch",
        description="bzip2 codec on PyTorch + CUDA (compression on the GPU)",
    )
    p.add_argument("file", help="input file")
    p.add_argument("--dec", action="store_true", help="decompress")
    p.add_argument("--check", action="store_true", help="integrity check only (decode + CRC)")
    p.add_argument("--size", type=int, default=9, metavar="1-9", help="block size level (N*100k bytes)")
    p.add_argument("-o", "--output", help="output path (default: input+.bz2 / strip .bz2)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if not 1 <= args.size <= 9:
        print("error: --size must be 1..9", file=sys.stderr)
        return 2
    if not os.path.exists(args.file):
        print(f"error: no such file: {args.file}", file=sys.stderr)
        return 2
    with open(args.file, "rb") as f:
        data = f.read()
    try:
        if args.dec or args.check:
            from bz2tpu.runtime.decompressor import decompress

            result = decompress(data)
            if args.check:
                print("Integrity check passed!")
                return 0
            out_path = args.output or (
                args.file[:-4] if args.file.endswith(".bz2") else args.file + ".out"
            )
        else:
            from bz2tpu_torch.runtime.compressor import compress

            result = compress(data, level=args.size)
            out_path = args.output or args.file + ".bz2"
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"error: {e}", file=sys.stderr)
        return 1
    with open(out_path, "wb") as f:
        f.write(result)
    return 0
