"""PCD point-cloud file reader/writer (host side, numpy).

A copy of `pointcloudprocessor_tpu/io/pcd.py` (importing that package's
`io` imports jax through `io/odometry.py`); only ``read_cloud`` /
``write_cloud`` differ, taking and returning the port's torch clouds.

Replaces the reference's use of `pcl::io::loadPCDFile` / `PCDWriter::writeASCII`
(`PointCloudProcessor/src/PointCloudProcessor.cpp:112,135,217,542,920`).
Supports ASCII, binary, and binary_compressed (PCL LZF) DATA sections and
the field layouts the reference reads/writes:

* ``x y z intensity``  — input maps and culled keyframe clouds,
* ``x y z rgb``        — colorized output (PCL bit-packed float rgb),
* ``x y z rgb segmentMask`` — mask-annotated output, matching the custom
  ``PointXYZRGBMask`` registration (`include/FrameData.hpp:78-87`:
  float x,y,z, packed float rgb, uint16 segmentMask).

ASCII parse/format and LZF (de)compression route through the native codec
(`native/pcd_codec.cpp`, OpenMP-parallel — the role PCL's C++ IO plays in
the reference) when its shared library is buildable, with a transparent
numpy fallback otherwise.
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass
from typing import Optional

import numpy as np

_PCD_TO_NP = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
}
_NP_TO_PCD = {np.dtype(v): k for k, v in _PCD_TO_NP.items()}


@dataclass
class PCDData:
    """Decoded PCD contents: named field columns."""

    fields: dict  # name -> (N,) numpy array

    @property
    def points(self) -> np.ndarray:
        return np.stack([self.fields["x"], self.fields["y"], self.fields["z"]], axis=-1)

    @property
    def intensity(self) -> Optional[np.ndarray]:
        return self.fields.get("intensity")

    @property
    def rgb(self) -> Optional[np.ndarray]:
        """Unpack PCL float-packed rgb into (N, 3) float arrays [0, 255]."""
        if "rgb" not in self.fields:
            return None
        packed = self.fields["rgb"]
        if packed.dtype.kind == "f":
            packed = packed.view(np.uint32) if packed.dtype == np.float32 else packed.astype(np.float32).view(np.uint32)
        packed = packed.astype(np.uint32)
        r = (packed >> 16) & 0xFF
        g = (packed >> 8) & 0xFF
        b = packed & 0xFF
        return np.stack([r, g, b], axis=-1).astype(np.float32)

    @property
    def mask_label(self) -> Optional[np.ndarray]:
        m = self.fields.get("segmentMask")
        return None if m is None else m.astype(np.int32)


def _parse_header(lines):
    hdr = {}
    for ln in lines:
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        key, _, rest = ln.partition(" ")
        hdr[key.upper()] = rest.split()
        if key.upper() == "DATA":
            break
    return hdr


def read(path: str) -> PCDData:
    with open(path, "rb") as f:
        raw = f.read()

    # Header is ASCII up to and including the DATA line.
    data_pos = raw.find(b"DATA")
    if data_pos < 0:
        raise ValueError(f"{path}: not a PCD file (no DATA line)")
    nl = raw.find(b"\n", data_pos)
    header_text = raw[: nl + 1].decode("ascii", errors="replace")
    hdr = _parse_header(header_text.splitlines())

    names = hdr["FIELDS"]
    sizes = [int(s) for s in hdr["SIZE"]]
    types = hdr["TYPE"]
    counts = [int(c) for c in hdr.get("COUNT", ["1"] * len(names))]
    n_points = int(hdr["POINTS"][0])
    mode = hdr["DATA"][0].lower()

    if any(c != 1 for c in counts):
        raise NotImplementedError(f"{path}: COUNT>1 fields not supported")

    dtype = np.dtype(
        {"names": names, "formats": [_PCD_TO_NP[(t, s)] for t, s in zip(types, sizes)]}
    )

    if mode == "ascii":
        from . import native

        table = native.parse_ascii_table(raw[nl + 1 :], len(names), n_points)
        if table is None:
            body = raw[nl + 1 :].decode("ascii", errors="replace")
            table = np.loadtxt(_io.StringIO(body), dtype=np.float64, ndmin=2)
            if table.size == 0:
                table = table.reshape(0, len(names))
        cols = {}
        for i, (name, t, s) in enumerate(zip(names, types, sizes)):
            col = table[:, i]
            np_t = _PCD_TO_NP[(t, s)]
            cols[name] = col.astype(np_t)
        return PCDData(cols)
    elif mode == "binary":
        body = raw[nl + 1 : nl + 1 + dtype.itemsize * n_points]
        rec = np.frombuffer(body, dtype=dtype, count=n_points)
        return PCDData({name: np.ascontiguousarray(rec[name]) for name in names})
    elif mode == "binary_compressed":
        # PCL layout: u32 compressed size, u32 uncompressed size, LZF data;
        # the uncompressed payload is FIELD-MAJOR (all x, then all y, ...).
        from . import native

        comp_size, uncomp_size = np.frombuffer(raw, np.uint32, 2, offset=nl + 1)
        payload = raw[nl + 9 : nl + 9 + int(comp_size)]
        blob = native.lzf_decompress(payload, int(uncomp_size))
        if blob is None:
            raise NotImplementedError(
                f"{path}: DATA binary_compressed requires the native codec "
                "(native/libpcdcodec.so failed to build)"
            )
        cols = {}
        off = 0
        for name, t, s in zip(names, types, sizes):
            np_t = np.dtype(_PCD_TO_NP[(t, s)])
            nbytes = np_t.itemsize * n_points
            cols[name] = np.frombuffer(blob, np_t, n_points, offset=off).copy()
            off += nbytes
        return PCDData(cols)
    else:
        raise NotImplementedError(
            f"{path}: DATA {mode} not supported (ascii/binary/binary_compressed)"
        )


def pack_rgb(rgb: np.ndarray) -> np.ndarray:
    """(N,3) float [0,255] -> PCL bit-packed float32 rgb column."""
    r = np.clip(rgb[:, 0], 0, 255).astype(np.uint32)
    g = np.clip(rgb[:, 1], 0, 255).astype(np.uint32)
    b = np.clip(rgb[:, 2], 0, 255).astype(np.uint32)
    packed = (r << 16) | (g << 8) | b
    return packed.view(np.float32)


def write(
    path: str,
    points: np.ndarray,
    intensity: Optional[np.ndarray] = None,
    rgb: Optional[np.ndarray] = None,
    mask_label: Optional[np.ndarray] = None,
    binary: bool = False,
    compressed: bool = False,
) -> None:
    """Write a PCD file with the field layout implied by the provided columns.

    The reference writes ASCII everywhere (e.g.
    `PointCloudProcessor.cpp:217,542,920`); ``binary=True`` is the fast
    path, ``compressed=True`` writes PCL binary_compressed (LZF, needs the
    native codec — silently downgrades to binary without it).
    """
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    names = ["x", "y", "z"]
    formats = [np.float32] * 3
    cols = [points[:, 0], points[:, 1], points[:, 2]]
    if intensity is not None:
        names.append("intensity")
        formats.append(np.float32)
        cols.append(np.asarray(intensity, np.float32))
    if rgb is not None:
        # Packed as an integer column (PCL reads both the packed-float and
        # uint32 encodings): printing the packed float32 with %.8g would
        # corrupt the low bits — the blue channel — in ASCII mode.
        names.append("rgb")
        formats.append(np.uint32)
        cols.append(pack_rgb(np.asarray(rgb)).view(np.uint32))
    if mask_label is not None:
        names.append("segmentMask")
        formats.append(np.uint16)
        cols.append(np.asarray(mask_label, np.uint16))

    from . import native

    compressed_blob = None
    if compressed:
        # PCL binary_compressed: field-major payload, LZF.
        field_major = b"".join(np.ascontiguousarray(c).tobytes() for c in cols)
        packed = native.lzf_compress(field_major)
        if packed is not None:
            compressed_blob = (
                np.asarray([len(packed), len(field_major)], np.uint32).tobytes() + packed
            )

    mode = (
        "binary_compressed" if compressed_blob is not None
        else ("binary" if (binary or compressed) else "ascii")
    )
    sizes = " ".join(str(np.dtype(f).itemsize) for f in formats)
    types = " ".join(_NP_TO_PCD[np.dtype(f)][0] for f in formats)
    ones = " ".join(["1"] * len(names))
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(names)}\n"
        f"SIZE {sizes}\n"
        f"TYPE {types}\n"
        f"COUNT {ones}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {mode}\n"
    )
    rec = np.empty(n, dtype=np.dtype({"names": names, "formats": formats}))
    for name, col in zip(names, cols):
        rec[name] = col

    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if mode == "binary_compressed":
            f.write(compressed_blob)
        elif mode == "binary":
            f.write(rec.tobytes())
        else:
            table_cols, is_int = [], []
            for c, fo in zip(cols, formats):
                if np.dtype(fo).kind == "f":
                    table_cols.append(c.astype(np.float64))
                    is_int.append(0)
                else:
                    table_cols.append(c.astype(np.float64))
                    is_int.append(1)
            table = np.stack(table_cols, axis=-1)
            body = native.format_ascii_table(table, is_int)
            if body is None:
                out = _io.StringIO()
                fmt_parts = ["%.8g" if not ii else "%d" for ii in is_int]
                np.savetxt(out, table, fmt=fmt_parts)
                body = out.getvalue().encode("ascii")
            f.write(body)


def read_cloud(path: str, device, capacity: Optional[int] = None):
    """Read a PCD file into a :class:`core.cloud.PointCloud` (padded) on
    ``device``."""
    from ..core import cloud as cl

    data = read(path)
    return cl.make(
        data.points,
        device,
        intensity=data.intensity,
        rgb=data.rgb,
        mask_label=data.mask_label,
        capacity=capacity,
    )


def write_cloud(path: str, pc, binary: bool = False, include=("intensity",)) -> None:
    """Write a (possibly padded) PointCloud, compacting invalid rows."""
    from ..core import cloud as cl

    c = cl.compact(pc)

    def host(a):
        return None if a is None else a.cpu().numpy()

    write(
        path,
        host(c.points),
        intensity=host(c.intensity) if "intensity" in include else None,
        rgb=None if "rgb" not in include else host(c.rgb),
        mask_label=None if "mask_label" not in include else host(c.mask_label),
        binary=binary,
    )
