"""Rutherford-Boeing file I/O of the port: a copy of the JAX package's
``io/rutherford_boeing.py``.

Reference analog: the RBio package (``RBio/Include/RBio.h:102-110`` —
``RBread``/``RBwrite``/``RBkind``). Implemented from the published RB format
specification (Duff, Grimes, Lewis): a 4-line header (title/key; card counts;
matrix type + dimensions; Fortran formats) followed by column pointers, row
indices and values. This reader handles the assembled real/pattern types
(``[rp][sua]a``); values are parsed token-wise (standard RB files are
whitespace-separable within their fixed-width fields; exotic packed formats
like D-exponents are normalized first).
"""

from __future__ import annotations

import numpy as np

from ..sparse import CSC, from_triplets

__all__ = ["read_rb", "write_rb"]


def read_rb(path_or_file) -> CSC:
    if hasattr(path_or_file, "read"):
        f = path_or_file
        close = False
    else:
        f = open(path_or_file)
        close = True
    try:
        f.readline()  # title + key
        counts = f.readline().split()
        ptrcrd, indcrd = int(counts[1]), int(counts[2])
        valcrd = int(counts[3]) if len(counts) > 3 else 0
        line3 = f.readline().split()
        mxtype = line3[0].lower()
        nrow, ncol, nnz = int(line3[1]), int(line3[2]), int(line3[3])
        fmt_line = f.readline()  # Fortran formats, e.g. (16I5) (3D22.16)
        assert mxtype[2] == "a", f"unsupported (elemental) type {mxtype}"
        assert mxtype[0] in "rpic", f"unsupported value type {mxtype}"

        import re
        fmts = re.findall(r"\(([^)]*)\)", fmt_line)

        def fmt_width(spec: str) -> int | None:
            # "16I5" -> 5; "3D22.16" -> 22; "1P,3E25.16" variants too
            m = re.search(r"\d*\s*[IiDdEeFfGg]\s*(\d+)", spec)
            return int(m.group(1)) if m else None

        widths = [fmt_width(s) for s in fmts]

        def read_tokens(ncards, count, conv, width=None):
            # Fortran fixed-width cards PACK when values fill the field
            # (e.g. 16I5 with 5-digit pointers) — slice by width when known,
            # fall back to whitespace splitting
            toks = []
            for _ in range(ncards):
                line = f.readline().rstrip("\n").replace("D", "E") \
                    .replace("d", "e")
                if width:
                    toks.extend(line[i:i + width].strip()
                                for i in range(0, len(line), width))
                else:
                    toks.extend(line.split())
            toks = [t for t in toks if t]
            assert len(toks) >= count, "short RB file"
            return np.array([conv(t) for t in toks[:count]])

        w_ptr = widths[0] if len(widths) > 0 else None
        w_ind = widths[1] if len(widths) > 1 else None
        w_val = widths[2] if len(widths) > 2 else None
        indptr = read_tokens(ptrcrd, ncol + 1, int, w_ptr) - 1
        indices = read_tokens(indcrd, nnz, int, w_ind) - 1
        if mxtype[0] == "p" or valcrd == 0:
            data = np.ones(nnz)
        elif mxtype[0] == "c":
            # complex: 2*nnz reals, (re, im) interleaved
            raw = read_tokens(valcrd, 2 * nnz, float, w_val)
            data = raw[0::2] + 1j * raw[1::2]
        else:
            data = read_tokens(valcrd, nnz, float, w_val)
        cols = np.repeat(np.arange(ncol, dtype=np.int64),
                         np.diff(indptr.astype(np.int64)))
        sym = mxtype[1]
        if sym in "sh":  # symmetric/hermitian: lower stored -> upper convention
            if sym == "h":
                # conjugate the entries that move to the upper triangle
                data = np.where(indices > cols, np.conj(data), data)
            return from_triplets(nrow, ncol, np.minimum(indices, cols),
                                 np.maximum(indices, cols), data, sym=1)
        if sym == "z":   # skew-symmetric: expand
            off = indices != cols
            r2 = np.concatenate([indices, cols[off]])
            c2 = np.concatenate([cols, indices[off]])
            x2 = np.concatenate([data, -data[off]])
            return from_triplets(nrow, ncol, r2, c2, x2)
        return from_triplets(nrow, ncol, indices, cols, data)
    finally:
        if close:
            f.close()


def write_rb(path_or_file, A: CSC, title: str = "suitesparse_tpu",
             key: str = "sstpu") -> None:
    if hasattr(path_or_file, "write"):
        f = path_or_file
        close = False
    else:
        f = open(path_or_file, "w")
        close = True
    try:
        M = A
        sym = "u"
        if A.sym == 1:
            # our upper storage -> RB lower storage via transpose
            M = CSC(A.ncol, A.nrow, A.indptr, A.indices, A.data, 0)
            sym = "s"
        per_line_i = 8
        per_line_v = 4

        def cards(vals, per):
            return (len(vals) + per - 1) // per if len(vals) else 0

        ptr = (M.indptr + 1).tolist()
        ind = (M.indices + 1).tolist()
        vals = M.data.tolist()
        ptrcrd = cards(ptr, per_line_i)
        indcrd = cards(ind, per_line_i)
        valcrd = cards(vals, per_line_v)
        f.write(f"{title:<72.72}{key:<8.8}\n")
        f.write(f"{ptrcrd + indcrd + valcrd:14d}{ptrcrd:14d}{indcrd:14d}"
                f"{valcrd:14d}\n")
        f.write(f"r{sym}a           {M.nrow:14d}{M.ncol:14d}{M.nnz:14d}"
                f"{0:14d}\n")
        f.write(f"({per_line_i}I10)          ({per_line_i}I10)          "
                f"({per_line_v}E24.16)\n")

        def emit(vals, per, fmt):
            for i in range(0, len(vals), per):
                f.write("".join(fmt.format(v) for v in vals[i:i + per]) + "\n")

        emit(ptr, per_line_i, "{:10d}")
        emit(ind, per_line_i, "{:10d}")
        emit(vals, per_line_v, "{:24.16E}")
    finally:
        if close:
            f.close()
