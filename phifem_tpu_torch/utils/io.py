"""Mesh / field I/O: XDMF + HDF5 and VTU writers, npz checkpoints.

Counterpart of :mod:`phifem_tpu.utils.io` (a copy: the port imports nothing
of the JAX package): the same files, byte for byte, for the same data.  The
writers run on the host; a tensor on the card goes to the host once per
field.  ``h5py`` is imported inside :func:`write_xdmf` only, which writes a
VTU in its place where h5py is missing.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..grid import Grid
from ..spaces import Function, Space, interpolate

__all__ = [
    "write_vtu",
    "write_vtu_umesh",
    "write_xdmf",
    "save_checkpoint",
    "load_checkpoint",
    "write_vti",
    "save_tags",
    "save_levelset",
]


def _host(a) -> np.ndarray:
    """``a`` (tensor on any device, array or sequence) as a host array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _p1_point_data(fn: Function) -> np.ndarray:
    """Field values at grid vertices (the P1 view for visualization; higher
    degrees and non-Lagrange fields are interpolated down)."""
    g = fn.space.grid
    if fn.space.element.family == "Lagrange" and fn.space.degree == 1:
        return _host(fn.data)
    p1 = Space.lagrange(g, 1, fn.space.value_shape)
    return _host(interpolate(fn, p1).data)


def _vtu_header(coords3: np.ndarray, conn: np.ndarray, vtk_type: int) -> list:
    ncells, nloc = conn.shape
    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">',
        "<UnstructuredGrid>",
        f'<Piece NumberOfPoints="{len(coords3)}" NumberOfCells="{ncells}">',
        "<Points>",
        '<DataArray type="Float64" NumberOfComponents="3" format="ascii">',
        " ".join(f"{v:.17g}" for v in coords3.reshape(-1)),
        "</DataArray>",
        "</Points>",
        "<Cells>",
        '<DataArray type="Int64" Name="connectivity" format="ascii">',
        " ".join(map(str, conn.reshape(-1))),
        "</DataArray>",
        '<DataArray type="Int64" Name="offsets" format="ascii">',
        " ".join(map(str, (np.arange(1, ncells + 1) * nloc))),
        "</DataArray>",
        '<DataArray type="UInt8" Name="types" format="ascii">',
        " ".join([str(vtk_type)] * ncells),
        "</DataArray>",
        "</Cells>",
    ]
    return lines


def _vtu_data(tag: str, arrays: Dict[str, np.ndarray], vector_ok: bool) -> list:
    lines = [f"<{tag}>"]
    for name, vals in arrays.items():
        ncomp = 1 if (not vector_ok or vals.ndim == 1) else int(np.prod(vals.shape[1:]))
        lines.append(f'<DataArray type="Float64" Name="{name}" NumberOfComponents="{ncomp}" format="ascii">')
        lines.append(" ".join(f"{float(v):.17g}" for v in vals.reshape(-1)))
        lines.append("</DataArray>")
    lines.append(f"</{tag}>")
    return lines


def _write_lines(path, lines: list) -> None:
    lines += ["</Piece>", "</UnstructuredGrid>", "</VTKFile>"]
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))


def write_vtu(
    path: Union[str, os.PathLike],
    grid: Grid,
    point_data: Optional[Dict[str, Function]] = None,
    cell_data: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Write an ASCII VTU (ParaView) file with optional vertex fields
    (Functions, downsampled to P1) and per-cell arrays (e.g. tags)."""
    coords = _host(grid.vertex_coords)
    conn = _host(grid.cell_vertices)
    vtk_type = 5 if grid.is_simplex else 8  # VTK_TRIANGLE / VTK_PIXEL: (00, 10, 01, 11)
    lines = _vtu_header(np.column_stack([coords, np.zeros(len(coords))]), conn, vtk_type)
    lines += _vtu_data("PointData", {k: _p1_point_data(fn) for k, fn in (point_data or {}).items()}, True)
    lines += _vtu_data("CellData", {k: _host(a) for k, a in (cell_data or {}).items()}, False)
    _write_lines(path, lines)


def write_vtu_umesh(
    path: Union[str, os.PathLike],
    mesh,
    point_data: Optional[Dict[str, np.ndarray]] = None,
    cell_data: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """ASCII VTU for an imported mesh (:class:`~phifem_tpu_torch.umesh.UMesh`
    triangles / quads or :class:`~phifem_tpu_torch.umesh3.UMesh3` tets), the
    unstructured twin of :func:`write_vtu`.  ``point_data`` values are
    per-vertex arrays or ``UFunction``s (whose leading ``num_vertices``
    coefficients are the vertex values of a Lagrange space)."""
    verts = np.asarray(mesh.verts, np.float64)
    conn = np.asarray(mesh.cells)
    dim = verts.shape[1]
    vtk_type = {(2, 3): 5, (2, 4): 9, (3, 4): 10}[(dim, conn.shape[1])]
    lines = _vtu_header(np.column_stack([verts] + [np.zeros(len(verts))] * (3 - dim)), conn, vtk_type)
    pdata = {k: _host(getattr(v, "data", v))[: mesh.num_vertices] for k, v in (point_data or {}).items()}
    lines += _vtu_data("PointData", pdata, True)
    lines += _vtu_data("CellData", {k: _host(a) for k, a in (cell_data or {}).items()}, False)
    _write_lines(path, lines)


def write_xdmf(
    path: Union[str, os.PathLike],
    grid: Grid,
    point_data: Optional[Dict[str, Function]] = None,
    cell_data: Optional[Dict[str, np.ndarray]] = None,
) -> str:
    """Write XDMF + HDF5 (the on-disk format family of dolfinx's
    ``XDMFFile``) and return the XDMF's path.  Without h5py, write a VTU
    next to it (``.vtu`` in place of the suffix) and return that path."""
    try:
        import h5py
    except ImportError:
        vtu = os.path.splitext(str(path))[0] + ".vtu"
        write_vtu(vtu, grid, point_data, cell_data)
        return vtu

    path = str(path)
    h5path = os.path.splitext(path)[0] + ".h5"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    coords = _host(grid.vertex_coords)
    conn = _host(grid.cell_vertices).astype(np.int64)
    topo_type = "Triangle" if grid.is_simplex else "Quadrilateral"
    if not grid.is_simplex:
        conn = conn[:, [0, 1, 3, 2]]  # XDMF quadrilaterals are counter-clockwise
    pdata = {k: _p1_point_data(fn) for k, fn in (point_data or {}).items()}
    cdata = {k: _host(a) for k, a in (cell_data or {}).items()}

    with h5py.File(h5path, "w") as h5:
        h5["/Mesh/geometry"] = coords
        h5["/Mesh/topology"] = conn
        for name, vals in pdata.items():
            h5[f"/Function/{name}"] = vals
        for name, arr in cdata.items():
            h5[f"/CellData/{name}"] = arr

    h5name = os.path.basename(h5path)
    attrs = []
    for name, vals in pdata.items():
        ncomp = 1 if vals.ndim == 1 else int(np.prod(vals.shape[1:]))
        atype = "Scalar" if ncomp == 1 else "Vector"
        attrs.append(
            f'<Attribute Name="{name}" AttributeType="{atype}" Center="Node">'
            f'<DataItem Dimensions="{len(coords)} {ncomp}" Format="HDF">'
            f"{h5name}:/Function/{name}</DataItem></Attribute>"
        )
    for name, arr in cdata.items():
        attrs.append(
            f'<Attribute Name="{name}" AttributeType="Scalar" Center="Cell">'
            f'<DataItem Dimensions="{len(arr)}" Format="HDF">'
            f"{h5name}:/CellData/{name}</DataItem></Attribute>"
        )
    xml = f"""<?xml version="1.0"?>
<Xdmf Version="3.0">
  <Domain>
    <Grid Name="mesh" GridType="Uniform">
      <Topology TopologyType="{topo_type}" NumberOfElements="{len(conn)}">
        <DataItem Dimensions="{len(conn)} {conn.shape[1]}" Format="HDF">{h5name}:/Mesh/topology</DataItem>
      </Topology>
      <Geometry GeometryType="XY">
        <DataItem Dimensions="{len(coords)} 2" Format="HDF">{h5name}:/Mesh/geometry</DataItem>
      </Geometry>
      {"".join(attrs)}
    </Grid>
  </Domain>
</Xdmf>
"""
    with open(path, "w") as f:
        f.write(xml)
    return path


def save_checkpoint(path, **arrays) -> None:
    """npz snapshot of solver state (solution, tags, iterate); tensors go to
    the host."""
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    np.savez_compressed(path, **{k: _host(v) for k, v in arrays.items()})


def load_checkpoint(path) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def write_vti(
    path: Union[str, os.PathLike],
    grid3,
    point_data: Optional[Dict[str, np.ndarray]] = None,
    cell_data: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """VTK ImageData (.vti) writer for :class:`phifem_tpu_torch.grid3.Grid3`,
    the natural format of the structured 3D vertex lattice (ascii).
    ``point_data``: name -> (D, R, C) or flat vertex arrays; ``cell_data``:
    name -> (nz, ny, nx) or flat cell arrays."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    D, R, C = grid3.lattice_shape
    (x0, y0, z0), _ = grid3.bbox
    hx, hy, hz = grid3.spacing
    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="ImageData" version="0.1" byte_order="LittleEndian">',
        f'  <ImageData WholeExtent="0 {C - 1} 0 {R - 1} 0 {D - 1}" '
        f'Origin="{x0} {y0} {z0}" Spacing="{hx} {hy} {hz}">',
        f'    <Piece Extent="0 {C - 1} 0 {R - 1} 0 {D - 1}">',
    ]

    def _section(tag, data, shape):
        if not data:
            lines.append(f"      <{tag}/>")
            return
        lines.append(f"      <{tag}>")
        for name, arr in data.items():
            a = _host(arr).astype(np.float64).reshape(shape + (-1,))
            vals = a.reshape(-1, a.shape[-1])
            lines.append(
                f'        <DataArray type="Float64" Name="{name}" '
                f'NumberOfComponents="{a.shape[-1]}" format="ascii">'
            )
            lines.append("          " + " ".join(f"{v:.10g}" for v in vals.reshape(-1)))
            lines.append("        </DataArray>")
        lines.append(f"      </{tag}>")

    # VTK ImageData ravels x fastest, matching the (D, R, C) lattice order
    _section("PointData", point_data or {}, (D, R, C))
    _section("CellData", cell_data or {}, (grid3.nz, grid3.ny, grid3.nx))
    lines += ["    </Piece>", "  </ImageData>", "</VTKFile>", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def save_tags(path, mesh, tags) -> None:
    """Dump entity tags for visual debugging: cell tags become per-cell VTU
    data on a structured :class:`~phifem_tpu_torch.grid.Grid` or an imported
    ``UMesh`` / ``UMesh3``."""
    values = _host(tags if isinstance(tags, torch.Tensor) else getattr(tags, "values", tags))
    if isinstance(mesh, Grid):
        write_vtu(path, mesh, cell_data={"tags": values})
    else:
        write_vtu_umesh(path, mesh, cell_data={"tags": values})


def save_levelset(path, mesh, levelset) -> None:
    """Dump a callable (or discrete) level set as a vertex field.  A callable
    is evaluated on a tensor of the vertex coordinates, on the mesh's
    device."""
    if isinstance(mesh, Grid):
        pts = mesh.vertex_coords
    else:
        pts = torch.as_tensor(np.asarray(mesh.verts), dtype=mesh.dtype, device=mesh.device)
    if callable(levelset):
        vals = torch.as_tensor(levelset(pts))
    else:
        vals = torch.as_tensor(getattr(levelset, "data", levelset))[: len(pts)]
    if isinstance(mesh, Grid):
        write_vtu(path, mesh, point_data={"phi": Function(Space.lagrange(mesh, 1), vals)})
    else:
        write_vtu_umesh(path, mesh, point_data={"phi": vals})
