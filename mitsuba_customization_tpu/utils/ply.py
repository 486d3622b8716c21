"""PLY mesh loader (ascii + binary_little_endian).

Counterpart of mitsuba3 src/shapes/ply.cpp (SURVEY.md §2.4).
Returns the same contract as utils.obj.read_obj: (vertices, faces,
normals-or-None, uvs-or-None).
"""

from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path):
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) or ('list', ...)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            toks = line.decode("ascii", "replace").split()
            if not toks or toks[0] == "comment":
                continue
            if toks[0] == "format":
                fmt = toks[1]
            elif toks[0] == "element":
                cur = (toks[1], int(toks[2]), [])
                elements.append(cur)
            elif toks[0] == "property":
                if toks[1] == "list":
                    cur[2].append(("list", _PLY_TYPES[toks[2]], _PLY_TYPES[toks[3]], toks[4]))
                else:
                    cur[2].append((toks[-1], _PLY_TYPES[toks[1]]))
            elif toks[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: unsupported PLY format '{fmt}'")

        data = {}
        for name, count, props in elements:
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(f.readline().split())
                data[name] = (props, rows)
            else:
                if any(p[0] == "list" for p in props):
                    # row-by-row (face lists)
                    rows = []
                    for _ in range(count):
                        row = []
                        for p in props:
                            if p[0] == "list":
                                n = np.frombuffer(
                                    f.read(np.dtype(p[1]).itemsize), "<" + p[1]
                                )[0]
                                row.append(
                                    np.frombuffer(
                                        f.read(int(n) * np.dtype(p[2]).itemsize),
                                        "<" + p[2],
                                    )
                                )
                            else:
                                row.append(
                                    np.frombuffer(
                                        f.read(np.dtype(p[1]).itemsize),
                                        "<" + p[1],
                                    )[0]
                                )
                        rows.append(row)
                    data[name] = (props, rows)
                else:
                    dt = np.dtype([("f" + str(i), "<" + p[1]) for i, p in enumerate(props)])
                    arr = np.frombuffer(f.read(count * dt.itemsize), dt)
                    data[name] = (props, arr)

    # vertices
    vprops, vdata = data["vertex"]
    names = [p[0] for p in vprops]

    def col(n):
        i = names.index(n)
        if isinstance(vdata, np.ndarray):
            return vdata["f" + str(i)].astype(np.float32)
        return np.asarray([float(r[i]) for r in vdata], np.float32)

    v = np.stack([col("x"), col("y"), col("z")], -1)
    n = (
        np.stack([col("nx"), col("ny"), col("nz")], -1)
        if "nx" in names
        else None
    )
    uv = None
    for ux, uy in (("u", "v"), ("s", "t")):
        if ux in names:
            uv = np.stack([col(ux), col(uy)], -1)
            break

    # faces
    faces = []
    fkey = "face" if "face" in data else None
    if fkey:
        fprops, fdata = data[fkey]
        for row in fdata:
            if isinstance(row, list):
                idx = np.asarray(row[0], np.int64)
            else:
                idx = np.asarray([int(x) for x in row[1:]], np.int64)
            for i in range(1, len(idx) - 1):
                faces.append((idx[0], idx[i], idx[i + 1]))
    f_arr = np.asarray(faces, np.int32) if faces else np.zeros((0, 3), np.int32)
    return v, f_arr, n, uv
