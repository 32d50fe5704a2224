"""The port's copy of the NumPy oracle pieces it calls: the stream decoder
(decoder.py, the host decoder's fallback and the header parsers of the
device decode) and the RLE1 splitter (encoder.py, split_blocks's fallback).
"""
