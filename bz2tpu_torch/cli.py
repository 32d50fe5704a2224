"""bz2tpu_torch command-line tool: the counterpart of bz2tpu/cli.py.

    python -m bz2tpu_torch FILE... [--size N] [-o OUT]   compress
    python -m bz2tpu_torch FILE.bz2 --dec [-o OUT]       decompress
    python -m bz2tpu_torch FILE.bz2 --check              CRC check
    python -m bz2tpu_torch damaged.bz2 --recover         salvage blocks
    cat f | python -m bz2tpu_torch - > f.bz2             stdin -> stdout

(``bz2tpu-torch`` is the same tool as a console script.) As in bz2tpu:
input files are kept unless --rm is given; several files process in one
call and the exit status is the worst of theirs; a file compresses
through ``compress_file`` (StreamCompressor, bounded memory) and
decompresses through ``decompress_file`` (mmap + a sliding window of
threads); --metrics prints a JSON metrics line, --banner the cards,
--trace a torch.profiler trace.

``--backend gpu`` (the default, the counterpart of bz2tpu's ``tpu``)
compresses on the card after a host intake and decodes on the host;
``--backend device`` runs everything on the card (compress_device_intake,
decompress_device); ``--backend oracle`` is the NumPy codec. ``--device``
names the card or the CPU explicitly: ``cuda`` (the default) fails where
there is no card, and nothing falls back to the CPU. The host decode,
--recover and the oracle take no device.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bz2tpu-torch",
        description="bzip2 codec on PyTorch + CUDA (compression on the GPU)",
        epilog=(
            "examples: bz2tpu-torch FILE | bz2tpu-torch FILE.bz2 --dec | "
            "bz2tpu-torch FILE.bz2 --check | bz2tpu-torch damaged.bz2 --recover | "
            "cat f | bz2tpu-torch - > f.bz2. "
            "bz2tpu's --prime and --export-aot fill XLA caches and have no "
            "counterpart here: the CUDA kernels build once with nvcc at first "
            "use (bz2tpu_torch/_build.py) and are reused from build/bz2tpu_torch/."
        ),
    )
    from bz2tpu_torch import __version__

    p.add_argument("--version", action="version", version=f"bz2tpu_torch {__version__}")
    p.add_argument(
        "files", nargs="*", metavar="file",
        help="input file(s); '-' for stdin->stdout. Like stock bzip2, "
        "several files process in one invocation, sharing one process and "
        "its built kernels",
    )
    p.add_argument("--dec", action="store_true", help="decompress")
    p.add_argument("--check", action="store_true", help="integrity check only (decode + CRC verify)")
    p.add_argument(
        "--recover", action="store_true",
        help="salvage intact blocks from a damaged .bz2 (bzip2recover analog)",
    )
    p.add_argument("--keep", action="store_true", default=True, help="keep input file (default)")
    p.add_argument("--rm", action="store_true", help="delete input file on success")
    p.add_argument("--size", type=int, default=9, metavar="1-9", help="block size level (N*100k bytes)")
    p.add_argument(
        "--parallel", type=int, default=0, metavar="N",
        help="blocks per device batch (0 = auto)",
    )
    p.add_argument(
        "--backend", choices=["gpu", "oracle", "device"], default="gpu",
        help="gpu: host RLE1 intake, compress on the card, decode on the host; "
        "oracle: pure NumPy; device: everything on the card (compress: "
        "RLE1/split/CRC intake too; decompress: Huffman + MTF + inverse BWT)",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the gpu and device backends run: cuda (default; fails "
        "without a card) or cpu (the plain torch path)",
    )
    p.add_argument("-o", "--output", help="output path (default: input+.bz2 / strip .bz2)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--metrics", action="store_true", help="print JSON metrics to stderr")
    p.add_argument("--banner", action="store_true", help="print device info to stderr")
    p.add_argument("--trace", metavar="DIR", help="write a torch.profiler trace to DIR")
    return p


def _read_input(args, use_stdio: bool) -> bytes:
    if use_stdio:
        return sys.stdin.buffer.read()
    with open(args.file, "rb") as f:
        return f.read()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if not 1 <= args.size <= 9:
        print("error: --size must be 1..9", file=sys.stderr)
        return 2
    if not args.files:
        print("error: no input files (or '-' for stdin)", file=sys.stderr)
        return 2
    if len(args.files) > 1:
        if args.output:
            print("error: -o/--output requires a single input file", file=sys.stderr)
            return 2
        if "-" in args.files:
            print("error: '-' (stdio) cannot be mixed with file inputs", file=sys.stderr)
            return 2
        # Stock-bzip2 multi-file semantics: process each in turn; exit
        # status is the worst individual status.
        worst = 0
        for f in args.files:
            args.file = f
            worst = max(worst, _run_one(args))
        return worst
    args.file = args.files[0]
    return _run_one(args)


def _write_result(result: bytes, out_path: str, use_stdio: bool) -> None:
    if use_stdio:
        sys.stdout.buffer.write(result)
    else:
        with open(out_path, "wb") as f:
            f.write(result)


def _run_one(args) -> int:
    from bz2tpu_torch.utils.metrics import Clock, RunMetrics

    if args.banner and args.backend != "oracle":
        from bz2tpu_torch.utils.device import print_device_banner

        print_device_banner()

    use_stdio = args.file == "-"
    if not use_stdio and not os.path.exists(args.file):
        print(f"error: no such file: {args.file}", file=sys.stderr)
        return 2

    from bz2tpu_torch.utils.profiling import device_trace

    device = args.device
    parallel = args.parallel or None
    metrics = RunMetrics(level=args.size)
    clock = Clock()
    try:
        with device_trace(args.trace):
            if args.recover:
                from bz2tpu_torch.runtime.decompressor import recover

                metrics.op = "recover"
                data = _read_input(args, use_stdio)
                result, ok, total = recover(data)
                print(f"recovered {ok}/{total} blocks", file=sys.stderr)
                metrics.input_bytes, metrics.output_bytes = len(data), len(result)
                out_path = args.output or (
                    args.file[:-4] if args.file.endswith(".bz2") else args.file + ".out"
                )
                _write_result(result, out_path, use_stdio)
                if ok == 0:
                    return 1
            elif args.dec or args.check:
                metrics.op = "check" if args.check else "decompress"
                out_path = args.output or (
                    args.file[:-4] if args.file.endswith(".bz2") else args.file + ".out"
                )
                if not use_stdio and not args.check and args.backend == "gpu":
                    # Bounded-memory file-to-file decode (mmap + sliding window).
                    from bz2tpu_torch.runtime.decompressor import decompress_file

                    decompress_file(args.file, out_path)
                    metrics.input_bytes = os.path.getsize(args.file)
                    metrics.output_bytes = os.path.getsize(out_path)
                else:
                    data = _read_input(args, use_stdio)
                    if args.backend == "oracle":
                        from bz2tpu_torch.oracle import decompress

                        result = decompress(data)
                    elif args.backend == "device":
                        from bz2tpu_torch.runtime.device_decode import decompress_device

                        result = decompress_device(data, device=device)
                    else:
                        from bz2tpu_torch.runtime.decompressor import decompress

                        result = decompress(data)
                    metrics.input_bytes, metrics.output_bytes = len(data), len(result)
                    if args.check:
                        metrics.seconds = clock.elapsed()
                        if args.metrics:
                            print(metrics.to_json(), file=sys.stderr)
                        print("Integrity check passed!")
                        return 0
                    _write_result(result, out_path, use_stdio)
            else:
                metrics.op = "compress"
                out_path = args.output or (args.file + ".bz2")
                if args.backend == "gpu" and not use_stdio:
                    from bz2tpu_torch.runtime.stream import compress_file

                    compress_file(
                        args.file, out_path, level=args.size, parallel=parallel,
                        metrics=metrics, device=device,
                    )
                    metrics.input_bytes = os.path.getsize(args.file)
                    metrics.output_bytes = os.path.getsize(out_path)
                else:
                    data = _read_input(args, use_stdio)
                    if args.backend == "device":
                        # Fully-device pipeline: RLE1 + split + CRC + encode on the card.
                        from bz2tpu_torch.runtime.compressor import compress_device_intake

                        result = compress_device_intake(
                            data, level=args.size, parallel=parallel, device=device
                        )
                    elif args.backend == "oracle":
                        from bz2tpu_torch.oracle import compress

                        result = compress(data, level=args.size)
                    else:
                        from bz2tpu_torch.runtime.compressor import compress

                        result = compress(data, level=args.size, parallel=parallel, device=device)
                    metrics.input_bytes, metrics.output_bytes = len(data), len(result)
                    _write_result(result, out_path, use_stdio)
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"error: {e}", file=sys.stderr)
        return 1
    metrics.seconds = clock.elapsed()

    if args.metrics:
        print(metrics.to_json(), file=sys.stderr)
    if args.verbose:
        print(
            f"{metrics.input_bytes} -> {metrics.output_bytes} bytes "
            f"({metrics.ratio:.3f}) in {metrics.seconds:.3f}s "
            f"({metrics.mb_per_s:.1f} MB/s)",
            file=sys.stderr,
        )
    if args.rm and not use_stdio:
        os.remove(args.file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
