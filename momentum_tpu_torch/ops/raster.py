"""K4a / K4b: the plane z-buffer rasterizer — `raster_planes_kernel` and
`raster_planes_binned_kernel` (csrc/raster.cu).

Replaces the TPU kernels momentum_tpu/ops/raster_pallas.py::_kernel (:196)
and ::_kernel_binned (:220). Every edge function and the depth of a
triangle are affine in screen space, w(x, y) = a·x + b·y + c, so a face is a
row of 12 plane coefficients (`face_planes`) and any screen-linear attribute
a row of (a, b, c) per channel (`attr_planes_from_vertex`,
`attr_planes_from_face_const`). A pixel keeps the face with the least depth
among those whose three edge functions are ≥ 0 and whose depth is > 0, the
lowest face id among equal depths; its barycentrics and attributes are the
winner's planes evaluated at the pixel centre.

With more faces than `bin_capacity` (or `cull=True`), `bin_faces` bins the
faces into (th × 128)-pixel tiles by bbox overlap, ids ascending, and K4b
scans each tile's ≤ K faces; a tile with more than K overlapping faces
scans all faces instead. Without binning, K4a scans all faces for every
tile. Planes, attribute tables and the binning are plain torch (XLA outside
the kernel in JAX); only the per-pixel scan is the kernel.

`rasterize_planes` takes `rasterize_planes_plain` for CPU tensors and
launches K4a or K4b for CUDA tensors (or raises). The plain version bins the
same way and evaluates each tile's (K, th·128) face-by-pixel block with
broadcast torch ops (`_eval_chunk` :166), chunks of tiles at a time so its
working set stays near 100 MB at 1280×960. The kernel evaluates each plane
as (a·x + b·y) + c with every product and sum rounded, the plain version's
order, so on the card the two give identical face maps.

One rule differs from the JAX binned kernel: a face whose depth overflows
to +inf never wins a pixel (JAX's overflow scan drops it too, its binned
scan keeps it). It takes coefficients near 1e38, which no finite scene gives.
"""

from __future__ import annotations

import ctypes

import torch

from momentum_tpu_torch.ops import build

__all__ = ["face_planes", "attr_planes_from_vertex", "attr_planes_from_face_const",
           "bin_faces", "rasterize_planes", "rasterize_planes_plain", "launches",
           "NOFACE"]

_LANES = 128
NOFACE = 1 << 30  # the face id of an empty bin slot
_LIM = 1e7  # faces with a screen coordinate this large are dropped (ROADMAP F2)
_TILE_BLOCK_ELEMS = 1 << 22  # tiles × faces × pixels per block of the plain scan
_KERNEL_TH = (4, 8)  # tile heights csrc/raster.cu is built for

# times each kernel was launched in this process (reset them to measure a run)
launches = {"raster_planes_kernel": 0, "raster_planes_binned_kernel": 0}


def face_planes(verts_screen: torch.Tensor, faces: torch.Tensor,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """(12, F) rows [a0 b0 c0 a1 b1 c1 a2 b2 c2 az bz cz]: the barycentric
    edge functions w_k = a_k·x + b_k·y + c_k and the depth plane.

    A degenerate face, one with a non-finite area or a screen coordinate
    ≥ 1e7 in magnitude, or one masked out by `valid`, is killed: every row
    is 0 but c0 = −1, so w0 < 0 at every pixel. Every row is guarded, not
    only c0: with grazing projections the coordinates can be huge or inf,
    and (by − cy)·inv would give inf·0 = NaN in the killed rows."""
    tri = verts_screen[faces.long()]  # (F, 3, 3)
    ax, ay, az = tri[:, 0, 0], tri[:, 0, 1], tri[:, 0, 2]
    bx, by, bz = tri[:, 1, 0], tri[:, 1, 1], tri[:, 1, 2]
    cx, cy, cz = tri[:, 2, 0], tri[:, 2, 1], tri[:, 2, 2]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    ok = torch.isfinite(area) & (torch.abs(area) > 1e-12)
    for c in (ax, ay, bx, by, cx, cy):
        ok = ok & (torch.abs(c) < _LIM)
    if valid is not None:
        ok = ok & valid
    inv = torch.where(ok, 1.0 / torch.where(ok, area, 1.0), 0.0)

    def g(v, fallback=0.0):
        return torch.where(ok, torch.where(torch.isfinite(v), v, 0.0), fallback)

    a0 = g((by - cy) * inv)
    b0 = g((cx - bx) * inv)
    c0 = g((bx * cy - by * cx) * inv, -1.0)
    a1 = g((cy - ay) * inv)
    b1 = g((ax - cx) * inv)
    c1 = g((cx * ay - cy * ax) * inv)
    a2 = -a0 - a1
    b2 = -b0 - b1
    c2 = 1.0 - c0 - c1
    pz_a = g(a0 * az + a1 * bz + a2 * cz)
    pz_b = g(b0 * az + b1 * bz + b2 * cz)
    pz_c = g(c0 * az + c1 * bz + c2 * cz)
    return torch.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2,
                        pz_a, pz_b, pz_c]).to(torch.float32)


def attr_planes_from_vertex(planes: torch.Tensor, faces: torch.Tensor,
                            vertex_attr: torch.Tensor) -> torch.Tensor:
    """(F, 3, C) plane rows (a, b, c) per channel of a per-vertex attribute
    interpolated with the screen-space barycentrics."""
    va = vertex_attr[faces.long()]  # (F, 3, C)
    p = planes.reshape(4, 3, -1)  # [w0|w1|w2|z][a|b|c][F]
    return torch.einsum("kcf,fkq->fcq", p[:3], va)


def attr_planes_from_face_const(num_faces: int, face_attr: torch.Tensor) -> torch.Tensor:
    """(F, 3, C) plane rows of a per-face constant: a = b = 0, c = attr."""
    zeros = torch.zeros((num_faces, 2, face_attr.shape[1]), dtype=face_attr.dtype,
                        device=face_attr.device)
    return torch.cat([zeros, face_attr[:, None, :]], dim=1)


def _grid(width: int, height: int, th: int):
    """(gi, gj): tile rows and columns of (th × 128)-pixel tiles."""
    return -(-height // th), -(-width // _LANES)


def _tables(verts_screen, faces, vertex_attrs, face_attrs, valid, pad):
    """(planes (Fp, 12), attribute table (Fp, 3, C) or None, C): rows padded
    to a multiple of `pad`, padded faces killed (c0 = −1)."""
    f_count = faces.shape[0]
    planes12 = face_planes(verts_screen, faces, valid=valid)
    fp = f_count + (-f_count) % pad
    planes = torch.zeros((fp, 12), dtype=torch.float32, device=verts_screen.device)
    planes[:f_count] = planes12.T
    planes[f_count:, 2] = -1.0
    tabs = []
    if vertex_attrs is not None:
        tabs.append(attr_planes_from_vertex(planes12, faces, vertex_attrs.to(torch.float32)))
    if face_attrs is not None:
        tabs.append(attr_planes_from_face_const(f_count, face_attrs.to(torch.float32)))
    if not tabs:
        return planes, None, 0
    tab = torch.cat(tabs, dim=2)
    n_attr = tab.shape[2]
    padded = torch.zeros((fp, 3, n_attr), dtype=torch.float32, device=tab.device)
    padded[:f_count] = tab
    return planes, padded, n_attr


def bin_faces(verts_screen: torch.Tensor, faces: torch.Tensor, fp: int, width: int,
              height: int, th: int, capacity: int):
    """Bin faces into (th × 128)-pixel tiles by their bbox (± 1 pixel).

    Returns (tile_fids (T, K) int32, overflow (T,) int32), T = gi·gj tiles in
    row-major order, K = min(capacity, fp): each tile's overlapping face ids
    ascending, then NOFACE in the empty slots; overflow = 1 where more than K
    faces overlap the tile. Faces ≥ `faces.shape[0]` (padding) and faces with
    a bbox coordinate ≥ 1e7 in magnitude are never binned (ROADMAP F2)."""
    gi, gj = _grid(width, height, th)
    f_count = faces.shape[0]
    dev = verts_screen.device
    k = min(capacity, fp)
    xy = torch.zeros((fp, 3, 2), dtype=verts_screen.dtype, device=dev)
    xy[:f_count] = verts_screen[faces.long()][..., :2]
    xmin = xy[..., 0].amin(dim=1) - 1.0
    xmax = xy[..., 0].amax(dim=1) + 1.0
    ymin = xy[..., 1].amin(dim=1) - 1.0
    ymax = xy[..., 1].amax(dim=1) + 1.0
    # a grazing projection's non-finite or absurd bbox would cover every tile
    # and flood the bins; its planes are killed anyway
    finite = ((torch.abs(xmin) < _LIM) & (torch.abs(xmax) < _LIM)
              & (torch.abs(ymin) < _LIM) & (torch.abs(ymax) < _LIM))
    live = (torch.arange(fp, device=dev) < f_count) & finite

    def tile_index(v, size):  # garbage where not finite: those faces are not live
        return torch.floor(torch.where(finite, v, 0.0) / size).to(torch.int32)

    ti0, ti1 = tile_index(ymin, th), tile_index(ymax, th)
    tj0, tj1 = tile_index(xmin, _LANES), tile_index(xmax, _LANES)
    ii = torch.arange(gi, dtype=torch.int32, device=dev)[:, None]
    jj = torch.arange(gj, dtype=torch.int32, device=dev)[:, None]
    hit_i = (ii >= ti0) & (ii <= ti1)  # (gi, fp)
    hit_j = (jj >= tj0) & (jj <= tj1)  # (gj, fp)
    hit = (hit_i[:, None, :] & hit_j[None, :, :] & live).reshape(gi * gj, fp)
    overflow = (hit.sum(dim=1) > k).to(torch.int32)
    # descending score fp − id = ascending id; misses score 0 and sort last
    ids = torch.arange(fp, dtype=torch.int32, device=dev)
    score = torch.where(hit, fp - ids, 0).to(torch.int32)
    top = torch.topk(score, k, dim=1).values
    tile_fids = torch.where(top > 0, fp - top, NOFACE).to(torch.int32)
    return tile_fids.contiguous(), overflow


def _pixel_xy(tiles: torch.Tensor, gj: int, th: int):
    """Pixel-centre coordinates (len(tiles), 1, th·128) of the given tiles,
    pixel n of a tile at row n // 128 and column n % 128."""
    n = torch.arange(th * _LANES, device=tiles.device)
    col = (tiles % gj)[:, None] * _LANES + n % _LANES
    row = (tiles // gj)[:, None] * th + n // _LANES
    return (col.to(torch.float32) + 0.5)[:, None], (row.to(torch.float32) + 0.5)[:, None]


def _plane(p: torch.Tensor, k: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(a·x + b·y) + c of plane rows p[..., k:k+3], every operation rounded."""
    return p[..., k:k + 1] * x + p[..., k + 1:k + 2] * y + p[..., k + 2:k + 3]


def _eval_block(pl: torch.Tensor, ids: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Planes (t, K, 12) with face ids (t, K) against pixels (t, 1, N): the
    least depth of each pixel among the faces that cover it, and the lowest
    id at that depth (NOFACE, inf where none does)."""
    w0, w1, w2, z = (_plane(pl, k, x, y) for k in (0, 3, 6, 9))
    ok = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0) & (z > 0.0)
    zsel = torch.where(ok, z, torch.inf)
    zmin = zsel.amin(dim=1)  # (t, N)
    hit = ok & (zsel == zmin[:, None]) & (zmin < torch.inf)[:, None]
    fmin = torch.where(hit, ids[..., None], NOFACE).amin(dim=1)
    return zmin, fmin


def _raster_plain(planes, tab, n_attr, tile_fids, overflow, width, height, th,
                  chunk, want_bary):
    """The kernels' semantics in plain torch (tile_fids None: no binning)."""
    dev = planes.device
    fp = planes.shape[0]
    gi, gj = _grid(width, height, th)
    n_tiles, npx = gi * gj, th * _LANES
    zbest = torch.full((n_tiles, npx), torch.inf, device=dev)
    fbest = torch.full((n_tiles, npx), NOFACE, dtype=torch.int32, device=dev)
    tiles = torch.arange(n_tiles, device=dev)
    if tile_fids is not None:
        k = tile_fids.shape[1]
        step = max(1, _TILE_BLOCK_ELEMS // (k * npx))
        kill = torch.zeros(12, device=dev)
        kill[2] = -1.0
        for t0 in range(0, n_tiles, step):
            fids = tile_fids[t0:t0 + step]
            ok = fids != NOFACE
            # empty slots gather row 0, then become killed planes (ROADMAP F3)
            pl = torch.where(ok[..., None], planes[torch.where(ok, fids, 0).long()], kill)
            x, y = _pixel_xy(tiles[t0:t0 + step], gj, th)
            zbest[t0:t0 + step], fbest[t0:t0 + step] = _eval_block(pl, fids, x, y)
        full = tiles[overflow.bool()]
    else:
        full = tiles
    # a full scan over all faces, `chunk` at a time, with a strict < across
    # chunks: earlier chunks (lower ids) keep depth ties
    chunk = min(chunk, fp)
    step = max(1, _TILE_BLOCK_ELEMS // (chunk * npx))
    for t0 in range(0, full.shape[0], step):
        sel = full[t0:t0 + step]
        x, y = _pixel_xy(sel, gj, th)
        depth = torch.full((sel.shape[0], npx), torch.inf, device=dev)
        fid = torch.full((sel.shape[0], npx), NOFACE, dtype=torch.int32, device=dev)
        for c0 in range(0, fp, chunk):
            ids = torch.arange(c0, min(c0 + chunk, fp), dtype=torch.int32, device=dev)
            pl = planes[c0:c0 + chunk].expand(sel.shape[0], -1, -1)
            czmin, cfmin = _eval_block(pl, ids.expand(sel.shape[0], -1), x, y)
            better = czmin < depth
            depth = torch.where(better, czmin, depth)
            fid = torch.where(better, cfmin, fid)
        zbest[sel], fbest[sel] = depth, fid

    def untile(a):  # (T, N) tile-flat → (H, W) image
        a = a.reshape(gi, gj, th, _LANES).transpose(1, 2)
        return a.reshape(gi * th, gj * _LANES)[:height, :width]

    face = untile(fbest)
    empty = face == NOFACE
    out = dict(depth=torch.where(empty, torch.inf, untile(zbest)),
               face=torch.where(empty, -1, face).to(torch.int32))
    safe = torch.where(empty, 0, face).long()
    x = torch.arange(width, device=dev).to(torch.float32)[None, :, None] + 0.5
    y = torch.arange(height, device=dev).to(torch.float32)[:, None, None] + 0.5
    if want_bary:
        p = planes[safe]  # (H, W, 12)
        b = torch.cat([_plane(p, k, x, y) for k in (0, 3, 6)], dim=-1)
        out["bary"] = torch.where(empty[..., None], 0.0, b)
    if n_attr:
        t = tab[safe]  # (H, W, 3, C)
        a = t[..., 0, :] * x + t[..., 1, :] * y + t[..., 2, :]
        out["attrs"] = torch.where(empty[..., None], 0.0, a)
    return out


def _lib():
    lib = build.load("raster")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.raster_planes_launch.argtypes = [p, i, p, i, i, p, p, p, p, i, i, i, p]
    lib.raster_planes_launch.restype = i
    lib.raster_planes_binned_launch.argtypes = [p, i, p, i, p, p, i, i, p, p, p, p,
                                                i, i, i, p]
    lib.raster_planes_binned_launch.restype = i
    return lib


def _raster_kernel(planes, tab, n_attr, tile_fids, overflow, width, height, th,
                   want_bary):
    """Launch K4b (tile_fids given) or K4a on the current stream."""
    dev = planes.device
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    face = torch.empty((height, width), dtype=torch.int32, device=dev)
    out = dict(depth=depth, face=face)
    if want_bary:
        out["bary"] = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    if n_attr:
        out["attrs"] = torch.empty((height, width, n_attr), dtype=torch.float32, device=dev)
    if height * width == 0:
        return out

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    outs = (depth.data_ptr(), face.data_ptr(), ptr(out.get("bary")), ptr(out.get("attrs")))
    common = (ptr(tab), n_attr, int(want_bary)) + outs + (width, height, th)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if tile_fids is None:
            name = "raster_planes_kernel"
            rc = lib.raster_planes_launch(planes.data_ptr(), planes.shape[0], *common, stream)
        else:
            name = "raster_planes_binned_kernel"
            rc = lib.raster_planes_binned_launch(
                planes.data_ptr(), planes.shape[0], tile_fids.data_ptr(), tile_fids.shape[1],
                overflow.data_ptr(), *common, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches[name] += 1
    return out


def _check_cuda_inputs(verts_screen, faces, vertex_attrs, face_attrs, valid, th):
    dev = verts_screen.device
    if verts_screen.dtype != torch.float32 or not verts_screen.is_contiguous():
        raise ValueError("the raster kernels take contiguous float32 screen vertices")
    if verts_screen.ndim != 2 or verts_screen.shape[1] != 3:
        raise ValueError(f"expected (V, 3) screen vertices, got {tuple(verts_screen.shape)}")
    if faces.device != dev or faces.dtype not in (torch.int32, torch.int64):
        raise ValueError("faces must be int32 or int64 on the vertices' device")
    for name, a in (("vertex_attrs", vertex_attrs), ("face_attrs", face_attrs)):
        if a is not None and (a.device != dev or a.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 on the vertices' device")
    if valid is not None and valid.device != dev:
        raise ValueError("valid must lie on the vertices' device")
    if any(t is not None and t.requires_grad for t in (verts_screen, vertex_attrs, face_attrs)):
        raise RuntimeError("the raster kernels have no backward: call them on tensors "
                           "that do not require grad (the face selection is constant)")
    if th not in _KERNEL_TH:
        raise ValueError(f"the raster kernels are built for th in {_KERNEL_TH}, got {th}")


def _rasterize(kernel, verts_screen, faces, width, height, vertex_attrs, face_attrs,
               valid, want_bary, th, cull, chunk, bin_capacity):
    if cull is None:
        cull = faces.shape[0] > bin_capacity
    if th is None:
        th = 8 if cull else 4
    if kernel:
        _check_cuda_inputs(verts_screen, faces, vertex_attrs, face_attrs, valid, th)
    planes, tab, n_attr = _tables(verts_screen, faces, vertex_attrs, face_attrs, valid,
                                  chunk if cull else _LANES)
    tile_fids = overflow = None
    if cull:
        tile_fids, overflow = bin_faces(verts_screen, faces, planes.shape[0], width,
                                        height, th, bin_capacity)
    if kernel:
        return _raster_kernel(planes, tab, n_attr, tile_fids, overflow, width, height,
                              th, want_bary)
    return _raster_plain(planes, tab, n_attr, tile_fids, overflow, width, height, th,
                         chunk, want_bary)


def rasterize_planes_plain(verts_screen, faces, width: int, height: int,
                           vertex_attrs=None, face_attrs=None, valid=None,
                           want_bary: bool = True, th: int | None = None,
                           cull: bool | None = None, chunk: int = 128,
                           bin_capacity: int = 128) -> dict:
    """`rasterize_planes` in plain torch, on any device."""
    return _rasterize(False, verts_screen, faces, width, height, vertex_attrs, face_attrs,
                      valid, want_bary, th, cull, chunk, bin_capacity)


def rasterize_planes(verts_screen, faces, width: int, height: int,
                     vertex_attrs=None, face_attrs=None, valid=None,
                     want_bary: bool = True, th: int | None = None,
                     cull: bool | None = None, chunk: int = 128,
                     bin_capacity: int = 128) -> dict:
    """Plane rasterization with fused attribute interpolation.

    verts_screen (V, 3): pixel x, y and depth z (only z > 0 is drawn);
    faces (F, 3); vertex_attrs (V, Ca), interpolated with the screen-space
    barycentrics; face_attrs (F, Cb), per-face constants; valid (F,) bool.
    cull bins faces into tiles (default: when F > bin_capacity), th is the
    tile height (default 8 binned, 4 not). Returns dict(depth (H, W) inf
    where empty, face (H, W) int32 −1 where empty, bary (H, W, 3) if
    want_bary, attrs (H, W, Ca+Cb) if any), 0 where empty.

    A CPU tensor takes `rasterize_planes_plain`. A CUDA tensor launches K4b
    (binned) or K4a, or raises: contiguous float32 vertices and float32
    attributes on one device (the kernels read tables built from them, so
    the attributes may be strided), no requires_grad, th 4 or 8."""
    return _rasterize(verts_screen.is_cuda, verts_screen, faces, width, height,
                      vertex_attrs, face_attrs, valid, want_bary, th, cull, chunk,
                      bin_capacity)
