"""PLY mesh loading (ASCII + binary little-endian) -> numpy triangle soup.

Replaces the reference's ``read_ply`` (``TEST_Dungeonrun/read_ply.cpp:13-152``)
with a property-driven, vectorized parser:

- The reference hardcodes four vertex layouts selected by a ``mode`` int
  (XYZ / XYZ+conf+intensity / XYZ+3 extras / skip, read_ply.cpp:52-65); here
  the header's ``property`` lines drive the layout, so all four modes — and
  any other float layout — parse without a mode switch.
- Quads split into two triangles (A,B,C) + (A,C,D) exactly like
  read_ply.cpp:70-125; plain triangles are stored rewound as (p3,p1,p2)
  matching read_ply.cpp:138-148 (winding is irrelevant to Möller–Trumbore
  without backface culling, but we keep byte-for-byte geometry parity so
  triangle indices line up with the reference).
- Binary little-endian is actually supported (the reference's detection is
  dead code — trailing-space compare bug at read_ply.cpp:28).
- Per-triangle AABBs are computed vectorized in numpy, the analogue of the
  ``kd_leaf_sort`` records emitted per face (read_ply.cpp:128-136).

The headerless ``tester.ply`` fixture (first two lines = vertex/face counts)
gets its own reader, `read_tester`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

_PLY_DTYPES = {
    "char": np.int8, "int8": np.int8,
    "uchar": np.uint8, "uint8": np.uint8,
    "short": np.int16, "int16": np.int16,
    "ushort": np.uint16, "uint16": np.uint16,
    "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32,
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
}


@dataclasses.dataclass
class MeshData:
    """Triangle soup + its per-triangle AABBs.

    ``tri_vertices[t]`` is the 3x3 (vertex, xyz) block in the reference's
    storage order; ``aabb_min``/``aabb_max`` mirror kd_leaf_sort's
    x0..z1 (read_ply.cpp:128-136).
    """

    vertices: np.ndarray        # (V, 3) float32 — raw vertex positions
    tri_vertices: np.ndarray    # (T, 3, 3) float32
    aabb_min: np.ndarray        # (T, 3) float32
    aabb_max: np.ndarray        # (T, 3) float32

    @property
    def num_triangles(self) -> int:
        return int(self.tri_vertices.shape[0])


def _triangulate(face_counts: np.ndarray, face_indices: list[np.ndarray],
                 vertices: np.ndarray) -> np.ndarray:
    """Variable-arity faces -> (T, 3) vertex-index triples in reference order:
    tris rewound to (p3, p1, p2), quads split (A,B,C) + (A,C,D)."""
    tris = []
    for counts, idx in zip(face_counts, face_indices):
        if counts == 3:
            p1, p2, p3 = idx
            tris.append((p3, p1, p2))
        elif counts == 4:
            a, b, c, d = idx
            tris.append((a, b, c))
            tris.append((a, c, d))
        else:
            # Fan-triangulate n-gons (reference silently skips them; this is
            # a documented extension).
            for k in range(1, counts - 1):
                tris.append((idx[0], idx[k], idx[k + 1]))
    return np.asarray(tris, np.int64)


def _mesh_from_indexed(vertices: np.ndarray, tri_idx: np.ndarray) -> MeshData:
    tv = vertices[tri_idx]  # (T, 3, 3)
    return MeshData(
        vertices=np.ascontiguousarray(vertices, np.float32),
        tri_vertices=np.ascontiguousarray(tv, np.float32),
        aabb_min=tv.min(axis=1).astype(np.float32),
        aabb_max=tv.max(axis=1).astype(np.float32),
    )


def _parse_header(f) -> tuple[str, list[tuple[str, int, list]], int]:
    """Returns (format, [(element_name, count, [props])], header_len_bytes).

    props: ("scalar", name, dtype) or ("list", name, count_dtype, item_dtype).
    """
    data = f.read(64 * 1024)
    if not data.startswith(b"ply"):
        raise ValueError("not a PLY file")
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError("PLY header too large or truncated")
    header_len = end + len(b"end_header\n")
    fmt = "ascii"
    elements: list[tuple[str, int, list]] = []
    for raw in data[:end].decode("ascii", "replace").splitlines():
        parts = raw.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[4],
                                        _PLY_DTYPES[parts[2]],
                                        _PLY_DTYPES[parts[3]]))
            else:
                elements[-1][2].append(("scalar", parts[2],
                                        _PLY_DTYPES[parts[1]]))
    return fmt, elements, header_len


def _read_ascii(body: bytes, elements) -> dict[str, np.ndarray | tuple]:
    tokens = body.split()
    pos = 0
    out: dict = {}
    for name, count, props in elements:
        if any(p[0] == "list" for p in props):
            counts = np.empty(count, np.int64)
            indices: list[np.ndarray] = []
            for i in range(count):
                c = int(tokens[pos]); pos += 1
                counts[i] = c
                indices.append(np.array(tokens[pos:pos + c], np.int64))
                pos += c
            out[name] = (counts, indices)
        else:
            width = len(props)
            flat = np.array(tokens[pos:pos + count * width], np.float64)
            pos += count * width
            cols = {p[1]: flat.reshape(count, width)[:, j]
                    for j, p in enumerate(props)}
            out[name] = cols
    return out


def _read_binary_le(body: bytes, elements) -> dict:
    out: dict = {}
    offset = 0
    for name, count, props in elements:
        if any(p[0] == "list" for p in props):
            if len(props) != 1:
                raise NotImplementedError("mixed list/scalar face element")
            _, _, cdt, idt = props[0]
            counts = np.empty(count, np.int64)
            indices: list[np.ndarray] = []
            csz, isz = np.dtype(cdt).itemsize, np.dtype(idt).itemsize
            for i in range(count):
                c = int(np.frombuffer(body, cdt, 1, offset)[0])
                offset += csz
                counts[i] = c
                indices.append(
                    np.frombuffer(body, idt, c, offset).astype(np.int64))
                offset += c * isz
            out[name] = (counts, indices)
        else:
            dt = np.dtype([(p[1], np.dtype(p[2]).newbyteorder("<"))
                           for p in props])
            rec = np.frombuffer(body, dt, count, offset)
            offset += dt.itemsize * count
            out[name] = {p[1]: rec[p[1]].astype(np.float64) for p in props}
    return out


def read_ply(path: str | os.PathLike) -> MeshData:
    """Load a PLY mesh (ASCII or binary little-endian) as a triangle soup."""
    with open(path, "rb") as f:
        fmt, elements, header_len = _parse_header(f)
        f.seek(header_len)
        body = f.read()
    if fmt == "ascii":
        # Some exporters (the reference's rabbit_70k.ply among them) declare
        # no `property` lines at all; the reference handles that with its
        # hardcoded mode switch (read_ply.cpp:52-65). We infer the vertex
        # width from the first body line instead: first three columns are
        # x/y/z, the rest are ignored extras (confidence/intensity/normals).
        for ei, (name, count, props) in enumerate(elements):
            if name == "vertex" and not props:
                first_line = body.lstrip().split(b"\n", 1)[0]
                width = len(first_line.split())
                names = ["x", "y", "z"] + [f"extra{i}"
                                           for i in range(width - 3)]
                elements[ei] = (name, count,
                                [("scalar", n, np.float32) for n in names])
            elif name == "face" and not props:
                elements[ei] = (name, count,
                                [("list", "vertex_indices",
                                  np.uint8, np.int32)])
        parsed = _read_ascii(body, elements)
    elif fmt == "binary_little_endian":
        parsed = _read_binary_le(body, elements)
    else:
        raise NotImplementedError(f"PLY format {fmt!r}")

    vcols = parsed["vertex"]
    vertices = np.stack(
        [vcols["x"], vcols["y"], vcols["z"]], axis=-1).astype(np.float32)
    counts, indices = parsed["face"]
    tri_idx = _triangulate(counts, indices, vertices)
    return _mesh_from_indexed(vertices, tri_idx)


def read_tester(path: str | os.PathLike) -> MeshData:
    """Reader for the headerless fixture format (``tester.ply``): line 1 =
    vertex count, line 2 = face count, then ``x y z nx ny nz`` vertex lines
    and ``n i j k ...`` face lines (reference mode 2, read_ply.cpp:59-61)."""
    with open(path, "r") as f:
        tokens = f.read().split()
    nv, nf = int(tokens[0]), int(tokens[1])
    pos = 2
    flat = np.array(tokens[pos:pos + nv * 6], np.float64).reshape(nv, 6)
    pos += nv * 6
    vertices = flat[:, :3].astype(np.float32)
    counts = np.empty(nf, np.int64)
    indices = []
    for i in range(nf):
        c = int(tokens[pos]); pos += 1
        counts[i] = c
        indices.append(np.array(tokens[pos:pos + c], np.int64))
        pos += c
    tri_idx = _triangulate(counts, indices, vertices)
    return _mesh_from_indexed(vertices, tri_idx)


def load_mesh(path: str | os.PathLike) -> MeshData:
    """Dispatch on content: real PLY header vs the headerless tester dump."""
    with open(path, "rb") as f:
        magic = f.read(3)
    if magic == b"ply":
        return read_ply(path)
    return read_tester(path)


def write_ply(path: str | os.PathLike, vertices: np.ndarray, faces,
              binary: bool = False, extra: np.ndarray | None = None,
              declare_properties: bool = True) -> None:
    """Write an indexed mesh as PLY (ASCII or binary little-endian).

    ``faces``: (F, k) int array or a list of index sequences (mixed
    arities allowed). ``extra``: optional (V, m) float columns written
    after x/y/z (``extra0..``), the way scanners append confidence or
    normals. ``declare_properties=False`` writes an ASCII header with
    bare ``element`` lines, as some exporters do (read_ply infers the
    vertex width from the first body line)."""
    v = np.asarray(vertices, np.float32)
    cols = v if extra is None else np.concatenate(
        [v, np.asarray(extra, np.float32)], axis=1)
    names = ["x", "y", "z"] + [f"extra{i}" for i in range(cols.shape[1] - 3)]
    faces = [np.asarray(f, np.int64) for f in faces]
    fmt = "binary_little_endian" if binary else "ascii"
    head = ["ply", f"format {fmt} 1.0", f"element vertex {len(v)}"]
    if declare_properties or binary:
        head += [f"property float {n}" for n in names]
    head.append(f"element face {len(faces)}")
    if declare_properties or binary:
        head.append("property list uchar int vertex_indices")
    head.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode("ascii"))
        if binary:
            f.write(cols.astype("<f4").tobytes())
            for face in faces:
                f.write(np.uint8(len(face)).tobytes())
                f.write(face.astype("<i4").tobytes())
        else:
            body = [" ".join(f"{x:.9g}" for x in row) for row in cols]
            body += [" ".join(map(str, [len(face), *face]))
                     for face in faces]
            f.write(("\n".join(body) + "\n").encode("ascii"))
