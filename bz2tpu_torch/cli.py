"""bz2tpu_torch command line: compress a file on the card, or decode and
check one.

    python -m bz2tpu_torch FILE [--size N] [-o OUT]      compress
    python -m bz2tpu_torch FILE.bz2 --dec [-o OUT]       decompress
    python -m bz2tpu_torch FILE.bz2 --check              CRC check

``--backend gpu`` (the default, the counterpart of bz2tpu's ``tpu``)
compresses on the card after a host intake and decodes on the host;
``--backend device`` runs everything on the card: compress_device_intake
and decompress_device. A thin counterpart of bz2tpu/cli.py.
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
    p.add_argument(
        "--backend", choices=["gpu", "device"], default="gpu",
        help="gpu: host RLE1 intake, compress on the card, decode on the host; "
        "device: everything on the card (compress: RLE1/split/CRC intake too; "
        "decompress: Huffman + MTF + inverse BWT)",
    )
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
            if args.backend == "device":
                from bz2tpu_torch.runtime import device_decode

                result = device_decode.decompress_device(data)
            else:
                from bz2tpu.runtime.decompressor import decompress

                result = decompress(data)
            if args.check:
                print("Integrity check passed!")
                return 0
            out_path = args.output or (
                args.file[:-4] if args.file.endswith(".bz2") else args.file + ".out"
            )
        else:
            from bz2tpu_torch.runtime import compressor

            if args.backend == "device":
                result = compressor.compress_device_intake(data, level=args.size)
            else:
                result = compressor.compress(data, level=args.size)
            out_path = args.output or args.file + ".bz2"
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"error: {e}", file=sys.stderr)
        return 1
    with open(out_path, "wb") as f:
        f.write(result)
    return 0
