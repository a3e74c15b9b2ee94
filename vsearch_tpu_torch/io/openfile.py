"""Output-file opening with reference-exact failure text.

reference: utils/open_file.cpp open_output_file + fatal_output_open_failed
(open_file.cpp:127-133) — "unable to open output file for writing (<name>)";
"-" maps to standard output (open_file.cpp:99-121 stream duplication).

Checked close: a deferred write error (full disk, quota, broken pipe) is
surfaced as the reference's fatal at close time instead of exiting 0 with
a silently truncated file (CheckedCloseOutputHandle,
open_file.cpp:150-163; stdout variant vsearch.cc:843-852).  Mirroring the
reference's unchecked fwrite returns, mid-run write failures are recorded
and swallowed (the run narrates to completion), then fatal at close.
"""

from __future__ import annotations

import sys
from contextlib import ExitStack
from typing import IO, Optional

CLOSE_FATAL = ("Unable to write to output file "
               "(disk full, quota exceeded, or broken pipe?)")
STDOUT_FATAL = ("Unable to write to standard output "
                "(disk full, quota exceeded, or broken pipe?)")


class CheckedOutput:
    """Buffered output wrapper whose close() surfaces deferred write
    errors with the reference's fatal text (open_file.cpp:150-163)."""

    def __init__(self, fh: IO[bytes]) -> None:
        self._fh = fh
        self._error = False

    def write(self, b) -> int:
        if self._error:
            return len(b)
        try:
            return self._fh.write(b)
        except OSError:
            self._error = True
            return len(b)

    def flush(self) -> None:
        if self._error:
            return
        try:
            self._fh.flush()
        except OSError:
            self._error = True

    def close(self) -> None:
        err = self._error
        if not self._fh.closed:
            if not err:
                try:
                    self._fh.flush()
                except OSError:
                    err = True
            try:
                self._fh.close()
            except OSError:
                err = True
        if err:
            raise ValueError(CLOSE_FATAL)

    @property
    def closed(self) -> bool:
        return self._fh.closed

    def __enter__(self) -> "CheckedOutput":
        return self

    def __exit__(self, *exc) -> None:
        # on an in-flight exception, close quietly (the reference's fatal
        # already exits before its destructors run)
        if exc and exc[0] is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            return
        self.close()

    def __getattr__(self, attr):
        return getattr(self._fh, attr)


def check_stdout() -> None:
    """End-of-run stdout check (vsearch.cc:843-852)."""
    try:
        sys.stdout.buffer.flush()
    except OSError:
        raise ValueError(STDOUT_FATAL)


def open_output(path: str, name: str = "writing") -> IO[bytes]:
    """``name`` is the CLI option ("--output") baked into the fatal text,
    exactly as the reference's OutputOption does."""
    if path == "-":
        return sys.stdout.buffer
    # several ranks: the replicated drivers other than rank 0 write to the
    # null device
    from ..parallel.distributed import output_path
    path = output_path(path)
    try:
        return CheckedOutput(open(path, "wb"))
    except OSError:
        raise ValueError("unable to open output file for %s (%s)"
                         % (name, path))


def open_output_ctx(path: str, name: str = "writing"):
    """Context manager: closes the handle on exit unless it is stdout."""
    import contextlib
    handle = open_output(path, name)
    if handle is sys.stdout.buffer:
        return contextlib.nullcontext(handle)
    return contextlib.closing(handle)


def open_output_opt(stack: ExitStack, path: Optional[str],
                    name: str = "writing") -> Optional[IO[bytes]]:
    """None passthrough + ExitStack-managed close (stdout is not closed)."""
    if path is None:
        return None
    handle = open_output(path, name)
    if handle is sys.stdout.buffer:
        return handle
    return stack.enter_context(handle)
