"""VTK legacy-ASCII output (PyTorch twin of `saddle_point_petsc_tpu.utils.vtk`).

Writes the same text as the JAX package: POLYDATA with one quad POLYGON
per element, points in row-major node order, and the solution as
POINT_DATA (vector U and scalars Ux, Uy). Tensors are copied to the host
first; one process writes the file. A distributed field (`write_vtk_dist`)
is gathered to rank 0, cropped to the true grid and written there alone,
as the JAX package gathers with `process_allgather` for a single writer.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def write_vtk(path, coords, u=None, title="saddle_point_petsc_tpu output"):
    """Write a legacy VTK POLYDATA file.

    coords: (ny, nx, 2) node coordinates; u: optional (2, ny, nx) or
    (ny, nx, 2) solution field written as POINT_DATA (Ux, Uy, 0).
    """
    coords = _host(coords)
    u = _host(u)
    ny, nx = coords.shape[:2]
    if u is not None and u.ndim == 3 and u.shape == (2, ny, nx):
        u = np.transpose(u, (1, 2, 0))  # dof-major field -> node-major
    npoints = ny * nx
    ney, nex = ny - 1, nx - 1
    lines = [
        "# vtk DataFile Version 2.0",
        title,
        "ASCII",
        "DATASET POLYDATA",
        f"POINTS {npoints} double",
    ]
    for x, y in coords.reshape(-1, 2).tolist():
        lines.append(f"{x:.6e} {y:.6e} {0.0:.6e}")
    ncells = ney * nex
    lines.append(f"POLYGONS {ncells} {ncells * 5}")
    for ej in range(ney):
        for ei in range(nex):
            n0 = ej * nx + ei
            n1 = (ej + 1) * nx + ei
            n2 = (ej + 1) * nx + ei + 1
            n3 = ej * nx + ei + 1
            lines.append(f"4 {n0} {n3} {n2} {n1}")
    if u is not None:
        u = u.reshape(ny, nx, 2)
        lines.append(f"POINT_DATA {npoints}")
        lines.append("VECTORS U double")
        for ux, uy in u.reshape(-1, 2).tolist():
            lines.append(f"{ux:.9e} {uy:.9e} {0.0:.9e}")
        for c, name in enumerate(("Ux", "Uy")):
            lines.append(f"SCALARS {name} double 1")
            lines.append("LOOKUP_TABLE default")
            for v in u[..., c].reshape(-1).tolist():
                lines.append(f"{v:.9e}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def write_vtk_dist(path, coords, u, mesh, title="saddle_point_petsc_tpu output"):
    """write_vtk of a distributed field: u is this rank's (2, my, mx) patch
    of a grid padded to divide `mesh`; the patches are gathered to rank 0,
    cropped to coords' (ny, nx) and written by rank 0 alone. Collective:
    every rank calls it; returns the path on rank 0, None elsewhere."""
    from saddle_point_petsc_tpu_torch.parallel.mesh import gather_field

    u = gather_field(u, mesh)
    if mesh.rank != 0:
        return None
    ny, nx = coords.shape[:2]
    return write_vtk(path, coords, u[:, :ny, :nx], title)


def read_vtk_points(path):
    """Minimal reader for round-trip tests: returns (points, polygons, u)."""
    with open(path) as f:
        toks = f.read().split("\n")
    i = 0
    pts = polys = u = None
    while i < len(toks):
        line = toks[i]
        if line.startswith("POINTS"):
            n = int(line.split()[1])
            pts = np.array([[float(v) for v in toks[i + 1 + k].split()] for k in range(n)])
            i += n
        elif line.startswith("POLYGONS"):
            n = int(line.split()[1])
            polys = np.array(
                [[int(v) for v in toks[i + 1 + k].split()[1:]] for k in range(n)]
            )
            i += n
        elif line.startswith("VECTORS"):
            n = pts.shape[0]
            u = np.array([[float(v) for v in toks[i + 1 + k].split()] for k in range(n)])
            i += n
        i += 1
    return pts, polys, u
