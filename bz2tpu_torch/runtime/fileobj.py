"""File-object API: ``bz2tpu_torch.open()`` / ``BZ2File`` (stdlib ``bz2``
parity). Port of bz2tpu/runtime/fileobj.py.

The library surface mirrors the stdlib so existing
``bz2.open``/``bz2.BZ2File`` call sites can switch imports and get the
GPU pipeline:

  * write modes stream through the push-style ``StreamCompressor``
    (bounded memory; blocks leave for the device in batches); ``device``
    defaults to CUDA and raises where there is none;
  * read modes stream through ``StreamDecompressor`` (bounded memory,
    native C block decode), read concatenated multi-member files
    transparently, and support ``seek()`` (rewind + skip, like stdlib);
  * append mode starts a fresh bzip2 stream after the existing bytes —
    a standard multi-member file that stock bzip2 and stdlib decode.

Error/trailing-data semantics were pinned against CPython's bz2 on the
same inputs (see tests/test_fileobj.py; tests/test_torch_fileobj.py
holds this copy to bz2tpu's): corruption raises OSError
(Bz2FormatError subclasses it), an empty file or a truncated member
raises EOFError, non-magic trailing bytes and members that ERROR after
the first complete member are silently ignored, and a truncated magic
raises EOFError.
"""

from __future__ import annotations

import io
import os

from bz2tpu_torch.format import constants as C
from bz2tpu_torch.utils.device import resolve_device

_READ_CHUNK = 1 << 20
_EOF_MSG = "Compressed file ended before the end-of-stream marker was reached"


class BZ2File(io.BufferedIOBase):
    """Stdlib-``bz2.BZ2File``-compatible file object over the GPU codec.

    Args:
      filename: path, or an object with read()/write() (then closefp=False).
      mode: "r"/"rb" read, "w"/"wb" write, "x"/"xb" exclusive create,
        "a"/"ab" append (a new stream member).
      level: block-size level 1..9 (write modes; stdlib calls this
        ``compresslevel``, accepted as an alias).
      parallel: blocks per device batch (write modes).
      device: where write modes encode: None means CUDA, which raises
        where there is none; "cpu" runs the plain torch path. Read modes
        decode on the host and ignore it.
    """

    def __init__(self, filename, mode: str = "r", *, level: int = C.DEFAULT_LEVEL,
                 compresslevel: int | None = None, parallel: int | None = None,
                 device=None):
        if compresslevel is not None:
            level = compresslevel
        mode = mode.replace("b", "") or "r"
        if mode not in ("r", "w", "x", "a"):
            raise ValueError(f"invalid mode: {mode!r}")
        self._writing = mode != "r"
        if self._writing:
            resolve_device(device)  # before the file is opened
        self._closefp = False
        if hasattr(filename, "read") or hasattr(filename, "write"):
            self._fp = filename
        else:
            self._fp = open(os.fspath(filename), mode + "b")
            self._closefp = True
        self._pos = 0
        if self._writing:
            from bz2tpu_torch.runtime.stream import StreamCompressor

            self._sc = StreamCompressor(self._fp, level=level, parallel=parallel, device=device)
        else:
            from bz2tpu_torch.runtime.decompressor import StreamDecompressor

            self._make_dec = StreamDecompressor
            self._reset_read_state()

    def _reset_read_state(self) -> None:
        self._dec = self._make_dec()
        self._outbuf = bytearray()
        self._raw_eof = False
        self._fed = False  # current member has received bytes
        self._members_done = False  # >= 1 member decoded to its end marker

    # -- io plumbing -------------------------------------------------------

    def readable(self) -> bool:
        return not self._writing

    def writable(self) -> bool:
        return self._writing

    def seekable(self) -> bool:
        return not self._writing and self._fp.seekable()

    def tell(self) -> int:
        return self._pos

    def close(self) -> None:
        if self.closed:
            return
        try:
            if self._writing:
                self._sc.close()
        finally:
            fp, self._fp = self._fp, None
            if self._closefp:
                fp.close()
            super().close()

    def _check_read(self) -> None:
        if self._writing:
            raise io.UnsupportedOperation("file not open for reading")
        if self.closed:
            raise ValueError("I/O operation on closed file")

    # -- write path ---------------------------------------------------------

    def write(self, data) -> int:
        if not self._writing:
            raise io.UnsupportedOperation("file not open for writing")
        if self.closed:
            raise ValueError("I/O operation on closed file")
        b = bytes(memoryview(data))  # TypeError on str/int, like stdlib
        self._sc.write(b)
        self._pos += len(b)
        return len(b)

    def flush(self) -> None:
        if self._fp is not None and hasattr(self._fp, "flush"):
            self._fp.flush()

    # -- read path ----------------------------------------------------------

    def _fill(self) -> bool:
        """Decode more output into the buffer; False at end of data.

        Stdlib-BZ2File contract (pinned against CPython, see module
        docstring and tests): members concatenate; after >= 1 complete
        member, non-magic trailing bytes AND members that error
        mid-decode are ignored; truncated magic or a member cut short
        raises EOFError; an empty file raises EOFError; errors in the
        FIRST member propagate (OSError via Bz2FormatError).
        """
        while True:
            if self._dec.eof:
                self._members_done = True
                tail = self._dec.unused_data
                while len(tail) < 4 and not self._raw_eof:
                    more = self._fp.read(_READ_CHUNK)
                    if not more:
                        self._raw_eof = True
                        break
                    tail += more
                if not tail:
                    return False
                k = min(len(tail), 3)
                magic_prefix = tail[:k] == b"BZh"[:k] and (
                    len(tail) < 4 or ord("1") <= tail[3] <= ord("9")
                )
                if not magic_prefix:
                    return False  # non-magic trailing data ignored
                if len(tail) < 4:
                    raise EOFError(_EOF_MSG)
                self._dec = self._make_dec()
                self._fed = True
                try:
                    got = self._dec.decompress(tail)
                except OSError:
                    return False  # later member errored: trailing ignored
                if got:
                    self._outbuf += got
                    return True
                continue
            chunk = self._fp.read(_READ_CHUNK)
            if not chunk:
                self._raw_eof = True
                # Empty file, or a member cut short: stdlib raises.
                raise EOFError(_EOF_MSG)
            self._fed = True
            try:
                got = self._dec.decompress(chunk)
            except OSError:
                if self._members_done:
                    return False  # later member errored: trailing ignored
                raise
            if got:
                self._outbuf += got
                return True

    def read(self, size: int = -1) -> bytes:
        self._check_read()
        if size is None or size < 0:
            while self._fill():
                pass
            out = bytes(self._outbuf)
            self._outbuf.clear()
        else:
            while len(self._outbuf) < size and self._fill():
                pass
            out = bytes(self._outbuf[:size])
            del self._outbuf[:size]
        self._pos += len(out)
        return out

    def read1(self, size: int = -1) -> bytes:
        self._check_read()
        if size == 0:
            return b""
        if not self._outbuf:
            self._fill()
        take = len(self._outbuf) if size is None or size < 0 else size
        out = bytes(self._outbuf[:take])
        del self._outbuf[:take]
        self._pos += len(out)
        return out

    def peek(self, n: int = 0) -> bytes:
        self._check_read()
        if not self._outbuf:
            self._fill()
        return bytes(self._outbuf)

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        """Reposition (read mode): rewind + re-decode and skip, exactly
        the stdlib strategy — O(target) work, constant memory."""
        self._check_read()
        if not self.seekable():
            raise io.UnsupportedOperation("underlying file is not seekable")
        if whence == io.SEEK_SET:
            target = offset
        elif whence == io.SEEK_CUR:
            target = self._pos + offset
        elif whence == io.SEEK_END:
            while self._fill():  # learn the total size
                pass
            target = self._pos + len(self._outbuf) + offset
        else:
            raise ValueError(f"invalid whence: {whence}")
        target = max(0, target)
        if target < self._pos:
            self._fp.seek(0)
            self._reset_read_state()
            self._pos = 0
        while self._pos < target:
            if not self.read(min(_READ_CHUNK, target - self._pos)):
                break
        return self._pos


def bz2_open(filename, mode: str = "rb", *, level: int = C.DEFAULT_LEVEL,
             compresslevel: int | None = None, parallel: int | None = None,
             encoding=None, errors=None, newline=None, device=None):
    """``bz2.open`` parity: binary or text mode over :class:`BZ2File`."""
    if "t" in mode:
        if "b" in mode:
            raise ValueError(f"Invalid mode: {mode!r}")
        binary = BZ2File(filename, mode.replace("t", ""), level=level,
                         compresslevel=compresslevel, parallel=parallel, device=device)
        return io.TextIOWrapper(binary, encoding, errors, newline)
    if encoding or errors or newline:
        raise ValueError("Argument 'encoding', 'errors', or 'newline' "
                         "not supported in binary mode")
    return BZ2File(filename, mode, level=level,
                   compresslevel=compresslevel, parallel=parallel, device=device)
