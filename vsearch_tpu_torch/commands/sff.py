"""sff_convert command: Roche 454 SFF binary -> FASTQ.

reference: src/commands/sff_convert.cpp — big-endian header/read records,
soft-masked clip regions (lowercase outside [clip_start, clip_end)), optional
hard clipping with --sff_clip, index block skipped wherever it appears.
"""

from __future__ import annotations

import struct
import sys
from typing import BinaryIO

from ..params import Parameters
from ..io import fastx as fastx_io
from ..io.openfile import open_output


def _read_exact(handle: BinaryIO, n: int, what: str) -> bytes:
    data = handle.read(n)
    if len(data) < n:
        raise ValueError("Invalid SFF file. Unable to read %s. "
                         "File may be truncated." % what)
    return data


def _round_up_8(n: int) -> int:
    return (n + 7) & ~7


def sff_convert(params: Parameters) -> None:
    if params.opt_fastqout is None:
        raise ValueError("No output file specified with --fastqout")

    warnings = []

    def warn_unless(ok: bool, message: str) -> None:
        if ok:
            return
        print("WARNING: %s" % message, file=sys.stderr)
        if params.fp_log is not None:
            params.fp_log.write(b"WARNING: %s\n" % message.encode())

    with open(params.opt_sff_convert, "rb") as sff, \
            open_output(params.opt_fastqout, "--fastqout") as out:
        header = _read_exact(sff, 32, "header")
        (magic, version, index_offset, index_length, number_of_reads,
         header_length, key_length, flows_per_read,
         flowgram_format) = struct.unpack(">IIQIIHHHB", header[:31])
        filepos = 32
        if magic != 0x2E736666:
            raise ValueError("Invalid SFF file. Incorrect magic number. "
                             "Must be 0x2e736666 (.sff).")
        if version != 1:
            raise ValueError("Invalid SFF file. Incorrect version. "
                             "Must be 1.")
        if flowgram_format != 1:
            raise ValueError("Invalid SFF file. Incorrect flowgram format "
                             "code. Must be 1.")
        if header_length != _round_up_8(32 + flows_per_read + key_length):
            raise ValueError("Invalid SFF file. Incorrect header length.")
        if key_length != 4:
            raise ValueError("Invalid SFF file. Incorrect key length. "
                             "Must be 4.")
        if index_length != 0 and index_length < 8:
            raise ValueError("Invalid SFF file. Incorrect index size. "
                             "Must be at least 8.")

        _read_exact(sff, flows_per_read, "flow characters")
        filepos += flows_per_read
        key_sequence = _read_exact(sff, key_length, "key sequence")
        filepos += key_length
        padding = header_length - 32 - flows_per_read - key_length
        _read_exact(sff, padding, "read padding")
        filepos += padding

        def header_stats(outstream) -> None:
            outstream.write(b"Number of reads: %d\n" % number_of_reads)
            outstream.write(b"Flows per read:  %d\n" % flows_per_read)
            # C %s stops at the first NUL (sff_convert.cpp:476 prints the
            # std::string's .data() as a C string)
            outstream.write(b"Key sequence:    %s\n"
                            % key_sequence.split(b"\0")[0])

        if not params.opt_quiet:
            header_stats(sys.stderr.buffer)
            sys.stderr.buffer.flush()
        if params.fp_log is not None:
            header_stats(params.fp_log)

        index_is_done = index_offset == 0 or index_length == 0
        index_is_odd = False
        index_kind = b""
        index_padding = (8 - (index_length & 7)) & 7

        total_length = 0
        len_min = 2**32 - 1
        len_max = 0

        qminout = params.opt_fastq_qminout
        qmaxout = params.opt_fastq_qmaxout
        offset = params.opt_fastq_asciiout

        for read_no in range(number_of_reads):
            if not index_is_done and filepos == index_offset:
                index_kind = _read_exact(sff, 8, "index header")
                filepos += 8
                index_size = index_length - 8 + index_padding
                _read_exact(sff, index_size, "entire index")
                filepos += index_size
                index_is_done = True
                index_is_odd = True

            rh = _read_exact(sff, 16, "read header")
            filepos += 16
            (read_header_length, name_length, number_of_bases,
             clip_qual_left, clip_qual_right, clip_adapter_left,
             clip_adapter_right) = struct.unpack(">HHIHHHH", rh)
            if read_header_length != _round_up_8(16 + name_length):
                raise ValueError(
                    "Invalid SFF file. Incorrect read header length.")
            for label, clip in (("clip_qual_left", clip_qual_left),
                                ("clip_adapter_left", clip_adapter_left),
                                ("clip_qual_right", clip_qual_right),
                                ("clip_adapter_right", clip_adapter_right)):
                if clip > number_of_bases:
                    raise ValueError("Invalid SFF file. Incorrect %s value."
                                     % label)

            read_name = _read_exact(sff, name_length, "read name")
            filepos += name_length
            pad = read_header_length - name_length - 16
            _read_exact(sff, pad, "read header padding")
            filepos += pad

            _read_exact(sff, 2 * flows_per_read, "flowgram values")
            filepos += 2 * flows_per_read
            _read_exact(sff, number_of_bases, "flow indices")
            filepos += number_of_bases
            bases = bytearray(_read_exact(sff, number_of_bases,
                                          "read length"))
            filepos += number_of_bases
            quality = bytearray(_read_exact(sff, number_of_bases,
                                            "quality scores"))
            filepos += number_of_bases

            for i, q in enumerate(quality):
                quality[i] = min(max(q, qminout), qmaxout) + offset

            data_len = 2 * flows_per_read + 3 * number_of_bases
            data_pad = _round_up_8(data_len) - data_len
            _read_exact(sff, data_pad, "read data padding")
            filepos += data_pad

            clip_start = max(1, clip_qual_left, clip_adapter_left) - 1
            clip_end = min(
                clip_qual_right if clip_qual_right else number_of_bases,
                clip_adapter_right if clip_adapter_right
                else number_of_bases)

            for i in range(number_of_bases):
                if i < clip_start or i >= clip_end:
                    bases[i:i + 1] = bases[i:i + 1].lower()
                else:
                    bases[i:i + 1] = bases[i:i + 1].upper()

            if params.opt_sff_clip:
                if clip_start > clip_end:
                    raise ValueError(
                        "Invalid SFF file. Clipping region is empty "
                        "(clip start beyond clip end).")
            else:
                clip_start = 0
                clip_end = number_of_bases

            length = clip_end - clip_start
            fastx_io.fastq_print_general(
                out, params, bytes(bases[clip_start:clip_end]), read_name,
                bytes(quality[clip_start:clip_end]), 1, read_no + 1)
            total_length += length
            len_min = min(len_min, length)
            len_max = max(len_max, length)

        if not index_is_done and filepos == index_offset:
            index_kind = _read_exact(sff, 8, "index header")
            filepos += 8
            _read_exact(sff, index_length - 8, "entire index")
            filepos += index_length - 8
            index_is_done = True
            if index_padding > 0:
                got = len(sff.read(index_padding))
                if 0 < got < index_padding:
                    print("WARNING: Additional data at end of SFF file "
                          "ignored", file=sys.stderr)

        warn_unless(index_is_done, "SFF index missing")
        warn_unless(not index_is_odd, "Index at unusual position in file")
        tail = sff.read(1)
        warn_unless(len(tail) == 0,
                    "Additional data at end of SFF file ignored")

        def report(outstream) -> None:
            if index_length != 0:
                outstream.write(b"Index type:      %s\n" % index_kind)
            outstream.write(b"\nSFF file read successfully.\n")
            if number_of_reads == 0:
                return
            outstream.write(
                b"Sequence length: minimum %d, average %.1f, maximum %d\n"
                % (len_min, total_length / number_of_reads, len_max))

        if not params.opt_quiet:
            report(sys.stderr.buffer)
            sys.stderr.buffer.flush()
        if params.fp_log is not None:
            report(params.fp_log)
