"""The port's copy of bz2tpu's scalar oracle codec: a bit-exact bzip2
encoder and decoder in NumPy. The decoder is the host decoder's fallback
and gives the device decode its header parsers; the encoder's RLE1
splitter is split_blocks's fallback, and ``compress`` is the command
line's ``--backend oracle``.
"""

from bz2tpu_torch.oracle.encoder import compress  # noqa: F401
from bz2tpu_torch.oracle.decoder import decompress  # noqa: F401
