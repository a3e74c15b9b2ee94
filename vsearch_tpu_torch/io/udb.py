"""UDB binary database format: reader and writer.

reference: src/core/udb.cpp (udb_read :196-578, udb_detect_isudb :120-168)
and src/commands/makeudb_usearch.cpp (writer layout :105-273).  The format is
little-endian uint32 sections:

  [50-word header] [4^w kmer counts] ["3BDU"] [kmer postings]
  [8-word header2] [header offsets] [headers \\0-terminated]
  [sequence lengths] [sequence bytes]
"""

from __future__ import annotations

import os
import sys
from typing import Tuple

import numpy as np

from ..params import Parameters

MAGIC_HEAD = 0x55444246   # "FBDU"
MAGIC_TAIL = 0x55444266   # "fBDU"
MAGIC_3BDU = 0x55444233
MAGIC_4BDU = 0x55444234
MAGIC_DB3 = 0x005E0DB3
MAGIC_DB4 = 0x005E0DB4


def detect_isudb(filename: str) -> bool:
    """reference: udb.cpp udb_detect_isudb (:120-168): unopenable input is
    fatal ("Unable to open input file for reading"); non-regular files
    (pipes, process substitutions) are never UDB."""
    if filename == "-":
        return False
    import stat as stat_mod
    try:
        mode = os.stat(filename)
        if not stat_mod.S_ISREG(mode.st_mode):
            return False
        with open(filename, "rb") as handle:
            magic = handle.read(4)
    except OSError:
        raise ValueError("Unable to open input file for reading (%s)"
                         % filename)
    return len(magic) == 4 and \
        int.from_bytes(magic, "little") == MAGIC_HEAD


def read_udb(filename: str, params: Parameters, db, index,
             parse_abundances: bool) -> None:
    """Fill ``db`` (Database) and ``index`` (KmerIndex) from a UDB file.

    reference: udb.cpp udb_read (:196-578).
    """
    filesize = os.path.getsize(filename)
    with open(filename, "rb") as handle:
        raw = handle.read()
    if len(raw) != filesize:
        raise ValueError("Unable to read from UDB file or invalid UDB file")

    def words(offset, n):
        return np.frombuffer(raw, dtype="<u4", count=n, offset=offset)

    if filesize < 4 * 50:
        raise ValueError("Unable to read from UDB file or invalid UDB file")
    head = words(0, 50)
    pos = 4 * 50
    if (head[0] != MAGIC_HEAD or head[2] != 32 or head[4] < 3
            or head[4] > 15 or head[13] == 0 or head[17] != 0x0000746E
            or head[49] != MAGIC_TAIL):
        raise ValueError("Invalid UDB file")
    wordlength = int(head[4])
    seqcount = int(head[13])
    dbaccel = int(head[6])
    if seqcount > filesize // 4:
        raise ValueError("Invalid UDB file")
    if wordlength != params.opt_wordlength:
        print("\nWARNING: Wordlength adjusted to %u as indicated in UDB file"
              % wordlength, file=sys.stderr)

    hashsize = 1 << (2 * wordlength)
    kmercount = words(pos, hashsize).astype(np.int64)
    pos += 4 * hashsize
    indexsize = int(kmercount.sum())
    if indexsize > filesize // 4:
        raise ValueError("Invalid UDB file")
    if int(words(pos, 1)[0]) != MAGIC_3BDU:
        raise ValueError("Invalid UDB file")
    pos += 4
    kmerindex = words(pos, indexsize)
    pos += 4 * indexsize
    if indexsize and int(kmerindex.max(initial=0)) >= seqcount:
        raise ValueError("Invalid UDB file")

    head2 = words(pos, 8)
    pos += 4 * 8
    if (head2[0] != MAGIC_4BDU or head2[1] != MAGIC_DB3
            or head2[2] != seqcount or head2[7] != MAGIC_DB4):
        raise ValueError("Invalid UDB file")
    nucleotides = (int(head2[4]) << 32) | int(head2[3])
    headerchars = (int(head2[6]) << 32) | int(head2[5])

    hidx = words(pos, seqcount).astype(np.int64)
    pos += 4 * seqcount
    bounds = np.append(hidx, headerchars)
    if seqcount:
        if hidx[0] >= headerchars or (np.diff(bounds) <= 0).any():
            raise ValueError("Invalid UDB file")
    headers_blob = raw[pos:pos + headerchars]
    pos += headerchars
    seqlens = words(pos, seqcount).astype(np.int64)
    pos += 4 * seqcount
    if int(seqlens.sum()) != nucleotides:
        raise ValueError("Invalid UDB file")
    seq_blob = raw[pos:pos + nucleotides]
    pos += nucleotides
    if pos != filesize:
        raise ValueError("Incorrect UDB file size")

    from ..io import attributes
    seq_offsets = np.concatenate(([0], np.cumsum(seqlens)))
    for i in range(seqcount):
        header = headers_blob[bounds[i]:bounds[i + 1] - 1]
        seq = seq_blob[seq_offsets[i]:seq_offsets[i + 1]]
        if parse_abundances:
            size = attributes.header_get_size(header)
            abundance = size if size > 0 else 1
        else:
            abundance = 1
        db.add(header, seq, None, abundance)

    # publish the postings straight into the KmerIndex CSR
    index.wordlength = wordlength
    index.hashsize = hashsize
    index.dbaccel = dbaccel
    index.mapping = list(range(seqcount))
    index.lengths = [int(x) for x in seqlens]
    index._kmer_lists = []
    index._csr_indptr = np.concatenate(
        ([0], np.cumsum(kmercount))).astype(np.int64)
    index._csr_postings = kmerindex.astype(np.int32)
    index._csr_dirty = False

    def stats(out, tail="\n"):
        if seqcount > 0:
            out.write("%d nt in %d seqs, min %d, max %d, avg %.0f%s" % (
                nucleotides, seqcount, int(seqlens.min()),
                int(seqlens.max()), nucleotides / seqcount, tail))
        else:
            out.write("%d nt in %d seqs%s" % (nucleotides, seqcount, tail))

    if not params.opt_quiet:
        stats(sys.stderr)
    if params.fp_log is not None:
        import io as _io
        buf = _io.StringIO()
        stats(buf, tail="\n\n")
        params.fp_log.write(buf.getvalue().encode())


def write_udb(filename: str, params: Parameters, db, index) -> None:
    """reference: makeudb_usearch.cpp (:105-273)."""
    index._build_csr()
    seqcount = db.seqcount
    hashsize = index.hashsize
    kmercount = np.diff(index._csr_indptr).astype("<u4")
    postings = index._csr_postings.astype("<u4")
    ntcount = sum(db.getsequencelen(i) for i in range(seqcount))
    headerchars = sum(db.getheaderlen(i) + 1 for i in range(seqcount))

    head = np.zeros(50, dtype="<u4")
    head[0] = MAGIC_HEAD
    head[2] = 32
    head[4] = params.opt_wordlength
    head[5] = 1                        # dbstep
    head[6] = 100                      # dbaccelpct
    head[11] = 0                       # slots
    head[13] = seqcount
    head[17] = 0x0000746E              # alphabet "nt"
    head[49] = MAGIC_TAIL

    from ..parallel.distributed import output_path
    with open(output_path(filename), "wb") as out:
        out.write(head.tobytes())
        out.write(kmercount.tobytes())
        out.write(np.asarray([MAGIC_3BDU], dtype="<u4").tobytes())
        out.write(postings.tobytes())
        head2 = np.zeros(8, dtype="<u4")
        head2[0] = MAGIC_4BDU
        head2[1] = MAGIC_DB3
        head2[2] = seqcount
        head2[3] = ntcount & 0xFFFFFFFF
        head2[4] = ntcount >> 32
        head2[5] = headerchars & 0xFFFFFFFF
        head2[6] = headerchars >> 32
        head2[7] = MAGIC_DB4
        out.write(head2.tobytes())
        offsets = np.zeros(seqcount, dtype="<u4")
        cursor = 0
        for i in range(seqcount):
            offsets[i] = cursor
            cursor += db.getheaderlen(i) + 1
        out.write(offsets.tobytes())
        for i in range(seqcount):
            out.write(db.getheader(i) + b"\0")
        lengths = np.asarray([db.getsequencelen(i) for i in range(seqcount)],
                             dtype="<u4")
        out.write(lengths.tobytes())
        for i in range(seqcount):
            out.write(db.getsequence(i))
