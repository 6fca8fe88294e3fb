"""Binary PLY export and import of trained Gaussians (port of
``gsplat_tpu/io/ply.py``, byte for byte the same file).

Binary little-endian, per-vertex float properties
``x y z nx ny nz f_dc_0..2 f_rest_* opacity scale_0..2 rot_0..3``, normals
written as zeros, quaternions normalized before saving; a Mip-Splatting
model adds ``filter_3D`` last, as its published PLY does (the raw opacity
and scales stay as they are).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["save_ply", "load_ply"]


def save_ply(
    path: str | Path,
    xyz: np.ndarray,
    rgb: np.ndarray,
    opacity: np.ndarray,
    scale: np.ndarray,
    quaternion: np.ndarray,
    sh: np.ndarray | None = None,
    filter_3d: np.ndarray | None = None,
) -> None:
    """Write Gaussians to a binary little-endian PLY.

    Args:
      xyz: (N, 3) float. rgb: (N, 3) SH-DC coefficients. opacity: (N,) logits.
      scale: (N, 3) log-scales. quaternion: (N, 4) (w, x, y, z), normalized on
        write. sh: optional (N, K) higher-band coefficients (row-flattened).
      filter_3d: optional (N,) Mip-Splatting 3D filter, the ``filter_3D``
        property.
    """
    xyz = np.asarray(xyz, dtype=np.float32)
    rgb = np.asarray(rgb, dtype=np.float32)
    opacity = np.asarray(opacity, dtype=np.float32).reshape(-1)
    scale = np.asarray(scale, dtype=np.float32)
    quat = np.asarray(quaternion, dtype=np.float32)
    n = xyz.shape[0]
    num_sh = 0
    if sh is not None:
        sh = np.asarray(sh, dtype=np.float32).reshape(n, -1)
        num_sh = sh.shape[1]

    norms = np.linalg.norm(quat, axis=1, keepdims=True)
    quat = quat / np.where(norms > 0, norms, 1.0)

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    props = ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
    props += [f"f_rest_{i}" for i in range(num_sh)]
    props += ["opacity", "scale_0", "scale_1", "scale_2",
              "rot_0", "rot_1", "rot_2", "rot_3"]
    if filter_3d is not None:
        props.append("filter_3D")
    header += [f"property float {p}" for p in props]
    header.append("end_header")

    cols = [xyz, np.zeros((n, 3), dtype=np.float32), rgb]
    if num_sh:
        cols.append(sh)
    cols += [opacity[:, None], scale, quat]
    if filter_3d is not None:
        cols.append(np.asarray(filter_3d, dtype=np.float32).reshape(n, 1))
    data = np.concatenate(cols, axis=1).astype("<f4")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())


def load_ply(path: str | Path):
    """Read a PLY written by :func:`save_ply`.

    Returns dict with xyz, rgb, opacity, scale, quaternion, sh (or None)
    and filter_3d (or None).
    """
    with open(path, "rb") as f:
        props: list[str] = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                props.append(line.split()[-1])
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(4 * n * len(props)), dtype="<f4").reshape(
            n, len(props)
        )
    col = {p: i for i, p in enumerate(props)}
    num_sh = sum(1 for p in props if p.startswith("f_rest_"))
    sh = None
    if num_sh:
        sh = data[:, [col[f"f_rest_{i}"] for i in range(num_sh)]]
    return {
        "xyz": data[:, [col["x"], col["y"], col["z"]]],
        "rgb": data[:, [col["f_dc_0"], col["f_dc_1"], col["f_dc_2"]]],
        "opacity": data[:, col["opacity"]],
        "scale": data[:, [col["scale_0"], col["scale_1"], col["scale_2"]]],
        "quaternion": data[:, [col[f"rot_{i}"] for i in range(4)]],
        "sh": sh,
        "filter_3d": data[:, col["filter_3D"]] if "filter_3D" in col else None,
    }
