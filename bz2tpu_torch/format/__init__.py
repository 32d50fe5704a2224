"""Bitstream format layer: constants, CRC32, bit-level readers/writers.

The port's own copy of bz2tpu/format (pure NumPy, no JAX, no torch): the
ground truth for the bzip2 container that the oracle, the host drivers and
the device pipeline of bz2tpu_torch emit and consume. tests/
test_torch_selfcontained.py holds each copy equal to its original.
"""
