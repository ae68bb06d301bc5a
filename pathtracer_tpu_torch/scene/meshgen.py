"""Procedural meshes for Mitsuba primitive shapes.

Equivalents of the reference's genmesh-based generators
(``common/importer/mitsuba.rs:20-79``): unit rectangle/cube and a 10x10 UV
sphere, as numpy arrays.
"""

from __future__ import annotations

import numpy as np


def gen_rectangle():
    """[-1,1]^2 quad at z=0, normal +z, two CCW triangles."""
    pos = np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    return pos, idx, nrm, None


def gen_cube():
    """[-1,1]^3 cube, 24 vertices with outward per-face normals."""
    faces = [
        # (normal, u axis, v axis)
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
        ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),
        ((1, 0, 0), (0, 0, -1), (0, 1, 0)),
        ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),
        ((0, 1, 0), (1, 0, 0), (0, 0, -1)),
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
    ]
    pos, nrm, idx = [], [], []
    for fi, (n, u, v) in enumerate(faces):
        n, u, v = np.array(n, np.float32), np.array(u, np.float32), np.array(v, np.float32)
        base = 4 * fi
        for du, dv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            pos.append(n + du * u + dv * v)
            nrm.append(n)
        idx.append([base, base + 1, base + 2])
        idx.append([base, base + 2, base + 3])
    return (np.asarray(pos, np.float32), np.asarray(idx, np.int32),
            np.asarray(nrm, np.float32), None)


def gen_sphere(center, radius, n_u: int = 10, n_v: int = 10):
    """UV sphere with n_u segments x n_v rings (ref gen_sphere 10x10)."""
    center = np.asarray(center, np.float32)
    vs, ns = [], []
    for i in range(n_v + 1):
        theta = np.pi * i / n_v
        for j in range(n_u):
            phi = 2 * np.pi * j / n_u
            d = np.array([np.sin(theta) * np.cos(phi),
                          np.sin(theta) * np.sin(phi),
                          np.cos(theta)], np.float32)
            vs.append(center + radius * d)
            ns.append(d)
    idx = []
    for i in range(n_v):
        for j in range(n_u):
            a = i * n_u + j
            b = i * n_u + (j + 1) % n_u
            c = (i + 1) * n_u + j
            d = (i + 1) * n_u + (j + 1) % n_u
            if i > 0:
                idx.append([a, c, b])
            if i < n_v - 1:
                idx.append([b, c, d])
    return (np.asarray(vs, np.float32), np.asarray(idx, np.int32),
            np.asarray(ns, np.float32), None)


def load_obj(path: str):
    """Tiny OBJ loader: v / vn / vt / f triangles (ref mitsuba.rs:81-151)."""
    vs, vns, vts, faces = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vs.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                vns.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                vts.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                corners = []
                for tok in parts[1:]:
                    sub = tok.split("/")
                    corners.append(int(sub[0]) - 1)
                for k in range(1, len(corners) - 1):
                    faces.append([corners[0], corners[k], corners[k + 1]])
    pos = np.asarray(vs, np.float32)
    idx = np.asarray(faces, np.int32)
    nrm = np.asarray(vns, np.float32) if vns and len(vns) == len(vs) else None
    uv = np.asarray(vts, np.float32) if vts and len(vts) == len(vs) else None
    return pos, idx, nrm, uv


def transform_mesh(pos, nrm, matrix):
    """World pre-transform (ref shape.rs:592-623: positions by the full
    projective matrix, normals by the same linear part — matching the
    reference's direct normal transform, not the inverse transpose)."""
    m = np.asarray(matrix, np.float64)
    ph = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], -1)
    pw = ph @ m.T
    pos_w = (pw[:, :3] / pw[:, 3:4]).astype(np.float32)
    nrm_w = None
    if nrm is not None:
        nrm_w = (nrm @ m[:3, :3].T).astype(np.float32)
    return pos_w, nrm_w
