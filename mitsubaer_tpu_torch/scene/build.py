"""Host-side scene construction (port of mitsubaer_tpu/scene/build.py).

Accumulates shapes, BSDFs, textures, media and emitters in numpy and
freezes them into tensors at `build()`: triangle meshes (with texture
coordinates; rectangles, disks, cylinders, height fields and instances
are meshes) and analytic spheres, either of them an area emitter; every
BSDF kind and texture kind; homogeneous, heterogeneous and refractive
media (every phase kind, an orientation field, analytic or B-spline RIF
and SDF, the spline samples prefiltered here); point, spot, directional,
collimated, constant and environment-map emitters; every sensor kind. A
scene of _BVH_MIN_TRIS triangles or more gets a BVH (scene/bvh.py); the
area emitters get their triangles' cdf table, the environment map its
importance-sampling tables.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional

import numpy as np
import torch

from ..core import spline
from . import bvh as bvh_m
from . import types as T

# triangle count from which build() attaches a BVH
_BVH_MIN_TRIS = 512


@dataclass
class _BSDF:
    kind: int = T.BSDF_DIFFUSE
    reflectance: tuple = (0.5, 0.5, 0.5)
    specular_r: tuple = (1.0, 1.0, 1.0)
    specular_t: tuple = (1.0, 1.0, 1.0)
    eta: float = 1.5046
    cond_eta: tuple = (0.0, 0.0, 0.0)
    cond_k: tuple = (1.0, 1.0, 1.0)
    alpha: float = 0.1
    exponent: float = 30.0
    alpha_v: float = 0.1
    opacity: float = 1.0
    texture: int = -1
    twosided: bool = False
    child0: int = -1
    child1: int = -1
    mix_w: float = 0.5
    normal_tex: int = -1


@dataclass
class _Emitter:
    kind: int = T.EM_AREA
    radiance: tuple = (1.0, 1.0, 1.0)
    position: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (0.0, 0.0, 1.0)
    shape_id: int = -1
    cutoff_deg: float = 20.0
    beam_width_deg: float = 15.0
    envmap: Optional[np.ndarray] = None   # (He, We, 3) lat-long radiance
    to_world: Optional[np.ndarray] = None
    scale: float = 1.0


@dataclass
class _Texture:
    kind: int = T.TEX_CHECKERBOARD
    color0: tuple = (0.4, 0.4, 0.4)
    color1: tuple = (0.2, 0.2, 0.2)
    uv_scale: tuple = (1.0, 1.0)
    uv_offset: tuple = (0.0, 0.0)
    line_width: float = 0.01
    bitmap: Optional[np.ndarray] = None  # (Hb, Wb, 3)


@dataclass
class _Medium:
    kind: int = T.MED_HOMOGENEOUS
    sigma_a: tuple = (0.0, 0.0, 0.0)
    sigma_s: tuple = (0.0, 0.0, 0.0)
    sampling_weight: float = -1.0
    strategy: int = T.STRAT_BALANCE
    manual_density: float = 1.0
    phase_kind: int = T.PH_ISOTROPIC
    g: float = 0.0
    g2: float = 0.0
    phase_mix: float = 1.0
    kappa: float = 4.0
    fiber_axis: tuple = (0.0, 0.0, 1.0)
    scale: float = 1.0
    density: Optional[np.ndarray] = None   # (nz, ny, nx)
    density_aabb: Optional[tuple] = None
    # accepted as the JAX builder does; no JAX function reads the grid
    albedo_grid: Optional[np.ndarray] = None   # (nz, ny, nx, 3)
    orientation: Optional[np.ndarray] = None   # (nz, ny, nx, 3) local axes
    # refractive: RIF and SDF (models/eikonal.py RIF_* / SDF_*), analytic
    # from their params or B-spline grids of (nz, ny, nx) samples
    rif_kind: int = 0
    rif_params: tuple = (1.0,)
    rif: Optional[np.ndarray] = None
    rif_aabb: Optional[tuple] = None
    sdf_kind: int = 0
    sdf_params: tuple = ()
    sdf: Optional[np.ndarray] = None
    sdf_aabb: Optional[tuple] = None


def _t(a, dtype):
    return torch.as_tensor(np.asarray(a, dtype))


def _pad8(params) -> tuple:
    return tuple(params) + (0.0,) * (8 - len(params))


class SceneBuilder:
    def __init__(self):
        self._verts = []
        self._faces = []
        self._face_shape = []
        self._spheres = []      # (center, radius, shape_id)
        self._shapes = []
        self._bsdfs: list[_BSDF] = []
        self._emitters: list[_Emitter] = []
        self._textures: list[_Texture] = []
        self._mesh_uvs = []     # per mesh (V, 2) uv, or None
        self._media: list[_Medium] = []
        self._sensor = None
        self.config = T.RenderConfig()
        self.camera_medium = -1

    def add_bsdf(self, kind=T.BSDF_DIFFUSE, **kw) -> int:
        self._bsdfs.append(_BSDF(kind=kind, **kw))
        return len(self._bsdfs) - 1

    def add_texture(self, kind=T.TEX_CHECKERBOARD, **kw) -> int:
        """A texture row; returns its id for a BSDF's texture or
        normal_tex."""
        self._textures.append(_Texture(kind=kind, **kw))
        return len(self._textures) - 1

    def add_medium(self, **kw) -> int:
        self._media.append(_Medium(**kw))
        return len(self._media) - 1

    def add_emitter(self, kind, **kw) -> int:
        """A point, spot (cutoff_deg, beam_width_deg), directional,
        collimated, constant or environment-map (envmap, to_world, scale)
        emitter; area emitters come with their shape
        (`emitter_radiance`)."""
        self._emitters.append(_Emitter(kind=kind, **kw))
        return len(self._emitters) - 1

    def _add_shape(self, bsdf, interior, exterior, emitter_radiance) -> int:
        shape_id = len(self._shapes)
        emitter = -1
        if emitter_radiance is not None:
            emitter = len(self._emitters)
            self._emitters.append(_Emitter(
                kind=T.EM_AREA, radiance=tuple(np.asarray(emitter_radiance,
                                                          np.float64)),
                shape_id=shape_id))
        self._shapes.append(dict(bsdf=bsdf, emitter=emitter,
                                 interior=interior, exterior=exterior))
        return shape_id

    def add_mesh(self, verts, faces, bsdf=-1, emitter_radiance=None,
                 interior=-1, exterior=-1, to_world=None, uv=None) -> int:
        """A triangle mesh; `uv` (V, 2) its texture coordinates (else each
        face's barycentric chart), `emitter_radiance` makes it an area
        emitter."""
        verts = np.asarray(verts, np.float32)
        if to_world is not None:
            m = np.asarray(to_world, np.float32)
            verts = verts @ m[:3, :3].T + m[:3, 3]
        shape_id = self._add_shape(bsdf, interior, exterior,
                                   emitter_radiance)
        self._verts.append(verts)
        self._faces.append(np.asarray(faces, np.int32))
        self._face_shape.append(shape_id)
        self._mesh_uvs.append(None if uv is None
                              else np.asarray(uv, np.float32))
        return shape_id

    def add_sphere(self, center, radius, bsdf=-1, emitter_radiance=None,
                   interior=-1, exterior=-1) -> int:
        shape_id = self._add_shape(bsdf, interior, exterior,
                                   emitter_radiance)
        self._spheres.append((np.asarray(center, np.float32), float(radius),
                              shape_id))
        return shape_id

    def add_rectangle(self, to_world, **kw) -> int:
        """Unit rectangle [-1,1]^2 in the XY plane (shapes/rectangle.cpp)."""
        v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                     np.float32)
        f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        return self.add_mesh(v, f, to_world=to_world, **kw)

    def add_disk(self, to_world, segments: int = 64, **kw) -> int:
        """Unit disk in the XY plane (shapes/disk.cpp), a fan of
        `segments` triangles."""
        ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
        rim = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)
        v = np.concatenate([[[0.0, 0.0, 0.0]], rim]).astype(np.float32)
        ring = np.arange(1, segments + 1, dtype=np.int32)
        f = np.stack([np.zeros(segments, np.int32), ring,
                      np.roll(ring, -1)], -1)
        return self.add_mesh(v, f, to_world=to_world, **kw)

    def add_cylinder(self, p0, p1, radius, segments: int = 64, **kw) -> int:
        """Open cylinder between p0 and p1 (shapes/cylinder.cpp)."""
        p0 = np.asarray(p0, np.float32)
        p1 = np.asarray(p1, np.float32)
        axis = p1 - p0
        w = axis / max(np.linalg.norm(axis), 1e-9)
        a = np.array([1.0, 0, 0]) if abs(w[0]) < 0.9 else np.array([0, 1.0, 0])
        u = np.cross(w, a)
        u /= np.linalg.norm(u)
        vv = np.cross(w, u)
        ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
        ring = (np.cos(ang)[:, None] * u + np.sin(ang)[:, None] * vv) * radius
        verts = np.concatenate([p0 + ring, p1 + ring]).astype(np.float32)
        f = []
        for i in range(segments):
            j = (i + 1) % segments
            f += [[i, j, segments + j], [i, segments + j, segments + i]]
        return self.add_mesh(verts, np.asarray(f, np.int32), **kw)

    def add_heightfield(self, heights, to_world=None, uv_tile=(1.0, 1.0),
                        **kw) -> int:
        """A grid over [-1,1]^2 in XY displaced to z = heights (Hh, Wh)
        (shapes/heightfield.cpp, tessellated), with uv over the grid."""
        h = np.asarray(heights, np.float32)
        Hh, Wh = h.shape
        X, Y = np.meshgrid(np.linspace(-1.0, 1.0, Wh, dtype=np.float32),
                           np.linspace(-1.0, 1.0, Hh, dtype=np.float32))
        verts = np.stack([X, Y, h], axis=-1).reshape(-1, 3)
        i = (np.arange(Hh - 1)[:, None] * Wh
             + np.arange(Wh - 1)[None, :]).reshape(-1)
        faces = np.concatenate([np.stack([i, i + 1, i + Wh + 1], axis=-1),
                                np.stack([i, i + Wh + 1, i + Wh], axis=-1)]
                               ).astype(np.int32)
        uv = np.stack([(X + 1) * 0.5 * uv_tile[0], (Y + 1) * 0.5 * uv_tile[1]],
                      axis=-1).reshape(-1, 2)
        return self.add_mesh(verts, faces, to_world=to_world, uv=uv, **kw)

    def add_instances(self, verts, faces, to_worlds, **kw) -> list:
        """One mesh under each of `to_worlds` (shapes/instance.cpp),
        flattened into the scene's triangles; returns the shape ids."""
        return [self.add_mesh(verts, faces, to_world=m, **kw)
                for m in to_worlds]

    def add_cube(self, to_world, **kw) -> int:
        """Unit cube [-1,1]^3 (shapes/cube.cpp), outward normals."""
        v = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                      [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                     np.float32)
        f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                      [0, 1, 5], [0, 5, 4], [3, 6, 2], [3, 7, 6],
                      [0, 4, 7], [0, 7, 3], [1, 2, 6], [1, 6, 5]], np.int32)
        return self.add_mesh(v, f, to_world=to_world, **kw)

    def set_perspective_sensor(self, to_world, fov_deg, fov_axis="x",
                               near=1e-2, far=1e4, width=None, height=None,
                               kind=T.SENSOR_PERSPECTIVE, aperture=0.0,
                               focus=1.0):
        self._sensor = dict(to_world=np.asarray(to_world, np.float32),
                            fov_deg=float(fov_deg), fov_axis=fov_axis,
                            near=near, far=far, kind=kind,
                            aperture=float(aperture), focus=float(focus))
        if width:
            self.config = replace(self.config, width=width)
        if height:
            self.config = replace(self.config, height=height)

    def set_sensor(self, kind, to_world, **kw):
        """A sensor of any kind (thinlens, orthographic, spherical, ...;
        src/sensors/*.cpp) with the perspective sensor's settings."""
        self.set_perspective_sensor(to_world, kw.pop("fov_deg", 45.0),
                                    kind=kind, **kw)

    def build(self) -> T.Scene:
        if self._verts:
            tri = np.concatenate([v[f] for v, f in zip(self._verts,
                                                        self._faces)])
            tri_shape = np.concatenate([
                np.full(len(f), s, np.int32)
                for f, s in zip(self._faces, self._face_shape)])
            tri_uvs = []
            for f, uv in zip(self._faces, self._mesh_uvs):
                if uv is None:
                    # each face's barycentric chart
                    base = np.zeros((len(f), 3, 2), np.float32)
                    base[:, 1, 0] = 1.0
                    base[:, 2, 1] = 1.0
                    tri_uvs.append(base)
                else:
                    tri_uvs.append(uv[f])
            tri_uvs = np.concatenate(tri_uvs)
        else:
            tri = np.zeros((1, 3, 3), np.float32)
            tri_shape = np.full((1,), -1, np.int32)
            tri_uvs = np.zeros((1, 3, 2), np.float32)
        v0 = tri[:, 0]
        e1 = tri[:, 1] - tri[:, 0]
        e2 = tri[:, 2] - tri[:, 0]
        ngu = np.cross(e1, e2)
        areas2 = np.linalg.norm(ngu, axis=-1)
        ng = ngu / np.maximum(areas2, 1e-20)[:, None]
        if self._spheres:
            sc = np.stack([s[0] for s in self._spheres])
            sr = [s[1] for s in self._spheres]
            ss = [s[2] for s in self._spheres]
        else:
            sc, sr, ss = np.zeros((1, 3), np.float32), [0.0], [-1]
        geo = T.Geometry(
            v0=_t(v0, np.float32), e1=_t(e1, np.float32),
            e2=_t(e2, np.float32), ng=_t(ng, np.float32),
            shape_id=_t(tri_shape, np.int32),
            uv0=_t(tri_uvs[:, 0], np.float32),
            uve1=_t(tri_uvs[:, 1] - tri_uvs[:, 0], np.float32),
            uve2=_t(tri_uvs[:, 2] - tri_uvs[:, 0], np.float32),
            sph_center=_t(sc, np.float32),
            sph_radius=_t(sr, np.float32), sph_shape_id=_t(ss, np.int32),
            bvh=(bvh_m.build_bvh(v0, e1, e2)
                 if v0.shape[0] >= _BVH_MIN_TRIS else T.empty_bvh()))
        shapes = T.Shapes(**{
            k: _t([s[k] for s in self._shapes] or [-1], np.int32)
            for k in ("bsdf", "emitter", "interior", "exterior")})
        # the table holds one default diffuse entry when the scene names
        # no BSDF, as the JAX builder's does
        if not self._bsdfs:
            self._bsdfs.append(_BSDF())
        bs = self._bsdfs
        dtypes = {"kind": np.int32, "texture": np.int32, "twosided": bool,
                  "child0": np.int32, "child1": np.int32,
                  "normal_tex": np.int32}
        bsdfs = T.BSDFs(**{
            f.name: _t([getattr(b, f.name) for b in bs],
                       dtypes.get(f.name, np.float32))
            for f in fields(T.BSDFs)})
        wrappers = (T.BSDF_MIXTURE, T.BSDF_TWOSIDED)
        for b in bs:
            if b.kind in wrappers:
                for c in [b.child0] + ([b.child1] if b.kind == T.BSDF_MIXTURE
                                       else []):
                    if not (0 <= c < len(bs)) or bs[c].kind in wrappers:
                        raise ValueError(
                            "a mixture's or two-sided BSDF's children must "
                            "be base BSDFs of the table (one wrapper level)")
        pts = [tri.reshape(-1, 3)]
        for c, r, _ in self._spheres:
            pts += [c[None, :] - r, c[None, :] + r]
        allp = np.concatenate(pts)
        self.config = replace(
            self.config,
            bsdf_kinds=tuple(sorted({b.kind for b in bs} | (
                {T.BSDF_NULL} if any(s["bsdf"] < 0 for s in self._shapes)
                else set()))),
            has_textures=any(b.texture >= 0 for b in bs),
            has_normal_tex=any(b.normal_tex >= 0 for b in bs),
            medium_strategies=any(
                m.strategy != T.STRAT_BALANCE for m in self._media),
            phase_kinds=tuple(sorted({m.phase_kind for m in self._media}))
            or (T.PH_ISOTROPIC,),
            phase_orient=any(m.orientation is not None for m in self._media),
            sensor_kind=int((self._sensor or {}).get(
                "kind", T.SENSOR_PERSPECTIVE)))
        return T.Scene(
            geo=geo, shapes=shapes, bsdfs=bsdfs,
            emitters=self._build_emitters(tri_shape, areas2),
            sensor=self._build_sensor(), media=self._build_media(),
            textures=self._build_textures(),
            aabb_min=_t(allp.min(axis=0), np.float32),
            aabb_max=_t(allp.max(axis=0), np.float32),
            camera_medium=_t(self.camera_medium, np.int32))

    def _build_emitters(self, tri_shape, areas2) -> T.Emitters:
        if not self._emitters:
            self._emitters.append(_Emitter(kind=T.EM_POINT,
                                           radiance=(0, 0, 0)))
        em = self._emitters
        ne = len(em)
        tri_index, tri_cdf, tri_emitter = [], [], []
        tri_offset = np.zeros(ne, np.int32)
        tri_count = np.zeros(ne, np.int32)
        area = np.zeros(ne, np.float32)
        for ei, e in enumerate(em):
            tri_offset[ei] = len(tri_index)
            if e.kind == T.EM_AREA and e.shape_id >= 0:
                ids = np.nonzero(tri_shape == e.shape_id)[0]
                a = 0.5 * areas2[ids]
                total = a.sum()
                area[ei] = total
                cdf = np.cumsum(a) / max(total, 1e-20)
                tri_index.extend(ids.tolist())
                tri_cdf.extend(cdf.tolist())
                tri_emitter.extend([ei] * len(ids))
                tri_count[ei] = len(ids)
        if not tri_index:
            tri_index, tri_cdf, tri_emitter = [0], [1.0], [-1]
        return T.Emitters(
            kind=_t([e.kind for e in em], np.int32),
            radiance=_t([e.radiance for e in em], np.float32),
            position=_t([e.position for e in em], np.float32),
            direction=_t([np.asarray(e.direction)
                          / max(np.linalg.norm(e.direction), 1e-20)
                          for e in em], np.float32),
            shape_id=_t([e.shape_id for e in em], np.int32),
            area=_t(area, np.float32),
            cutoff_cos=_t([np.cos(np.deg2rad(e.cutoff_deg)) for e in em],
                          np.float32),
            beam_falloff_cos=_t([np.cos(np.deg2rad(e.beam_width_deg))
                                 for e in em], np.float32),
            tri_index=_t(tri_index, np.int32),
            tri_cdf=_t(tri_cdf, np.float32),
            tri_emitter=_t(tri_emitter, np.int32),
            tri_offset=_t(tri_offset, np.int32),
            tri_count=_t(tri_count, np.int32), **self._envmap_tables())

    def _envmap_tables(self) -> dict:
        """The lat-long map's importance-sampling cdfs (envmap.cpp): rows
        by sin-weighted luminance, then a column within the row."""
        env = next((e for e in self._emitters if e.kind == T.EM_ENVMAP
                    and e.envmap is not None), None)
        if env is None:
            return dict(env_map=torch.ones((1, 1, 3)),
                        env_cdf_rows=torch.ones((1,)),
                        env_cdf_cond=torch.ones((1, 1)),
                        env_to_world=torch.eye(3),
                        env_scale=torch.tensor(1.0))
        img = np.asarray(env.envmap, np.float32)
        He = img.shape[0]
        lum = img @ np.array([0.2126, 0.7152, 0.0722], np.float32)
        theta = (np.arange(He) + 0.5) / He * np.pi
        w = lum * np.sin(theta)[:, None] + 1e-12
        row_w = w.sum(axis=1)
        rot = (np.eye(3) if env.to_world is None
               else np.asarray(env.to_world, np.float32)[:3, :3])
        return dict(
            env_map=_t(img, np.float32),
            env_cdf_rows=_t(np.cumsum(row_w) / row_w.sum(), np.float32),
            env_cdf_cond=_t(np.cumsum(w, axis=1)
                            / w.sum(axis=1, keepdims=True), np.float32),
            env_to_world=_t(rot, np.float32),
            env_scale=_t(env.scale, np.float32))

    def _build_textures(self) -> T.Textures:
        if not self._textures:
            return T.empty_textures()
        bitmaps = [t.bitmap for t in self._textures if t.bitmap is not None]
        if len(bitmaps) > 1:
            # the table holds one shared image
            raise ValueError(
                f"scene uses {len(bitmaps)} bitmap textures but the texture "
                "table holds a single shared image; atlas them into one "
                "bitmap or use procedural textures")
        tx = self._textures
        return T.Textures(
            kind=_t([t.kind for t in tx], np.int32),
            color0=_t([t.color0 for t in tx], np.float32),
            color1=_t([t.color1 for t in tx], np.float32),
            uv_scale=_t([t.uv_scale for t in tx], np.float32),
            uv_offset=_t([t.uv_offset for t in tx], np.float32),
            line_width=_t([t.line_width for t in tx], np.float32),
            use_bitmap=_t([t.bitmap is not None for t in tx], bool),
            bitmap=_t(bitmaps[0] if bitmaps else np.ones((1, 1, 3)),
                      np.float32))

    def _build_sensor(self) -> T.Sensor:
        s = dict(self._sensor or dict(
            to_world=np.eye(4, dtype=np.float32), fov_deg=45.0,
            fov_axis="x", near=1e-2, far=1e4))
        s.setdefault("kind", T.SENSOR_PERSPECTIVE)
        s.setdefault("aperture", 0.0)
        s.setdefault("focus", 1.0)
        aspect = self.config.width / self.config.height
        tan_half = np.tan(np.deg2rad(s["fov_deg"]) / 2)
        if s["fov_axis"] == "y":
            tan_x, tan_y = tan_half * aspect, tan_half
        else:
            tan_x, tan_y = tan_half, tan_half / aspect
        return T.Sensor(
            kind=_t(s["kind"], np.int32),
            to_world=_t(s["to_world"], np.float32),
            tan_x=_t(tan_x, np.float32), tan_y=_t(tan_y, np.float32),
            near=_t(s["near"], np.float32), far=_t(s["far"], np.float32),
            aperture=_t(s["aperture"], np.float32),
            focus=_t(s["focus"], np.float32),
            kc=_t((0.0, 0.0), np.float32))

    def _build_media(self) -> T.Media:
        media = self._media or [_Medium(sampling_weight=1.0, kappa=1.0)]
        sigma_a = np.array([m.sigma_a for m in media], np.float32)
        sigma_s = np.array([m.sigma_s for m in media], np.float32)
        sigma_t = sigma_a + sigma_s
        # default sampling weight: the largest channel albedo, at least 0.5
        # (homogeneous.cpp:168-184)
        sw = np.array([m.sampling_weight for m in media], np.float32)
        for i in np.nonzero(sw < 0)[0]:
            with np.errstate(divide="ignore", invalid="ignore"):
                alb = np.where(sigma_t[i] > 0, sigma_s[i] / sigma_t[i], 0.0)
            w = alb.max() if np.any(sigma_t[i] > 0) else 0.0
            sw[i] = max(w, 0.5) if w > 0 else 0.0
        density = T.GridData(torch.zeros((1, 1, 1)), torch.zeros(3),
                             torch.ones(3))
        orient = T.GridData(torch.zeros((1, 1, 1, 3)), torch.zeros(3),
                            torch.ones(3))
        majorant = 0.0
        rif_kind, rif_params, sdf_kind, sdf_params = 0, (1.0,), 0, ()
        # the spline grids; (1, 1, 1) ones over the unit box where absent
        grids = {k: (np.ones((1, 1, 1), np.float32), (0.0,) * 3, (1.0,) * 3)
                 for k in ("rif", "sdf")}
        for m in media:
            if m.kind == T.MED_HETEROGENEOUS and m.density is not None:
                lo, hi = m.density_aabb
                density = T.GridData(_t(m.density, np.float32),
                                     _t(lo, np.float32), _t(hi, np.float32))
                if m.orientation is not None:
                    orient = T.GridData(_t(m.orientation, np.float32),
                                        _t(lo, np.float32),
                                        _t(hi, np.float32))
                majorant = float(np.max(m.density) * m.scale)
            if m.kind == T.MED_REFRACTIVE:
                rif_kind, rif_params = m.rif_kind, m.rif_params
                sdf_kind, sdf_params = m.sdf_kind, m.sdf_params
                for k in grids:
                    if getattr(m, k) is not None:
                        lo, hi = getattr(m, k + "_aabb")
                        grids[k] = (spline.prefilter(getattr(m, k)), lo, hi)
        (rif_coeff, rif_min, rif_max), (sdf_coeff, sdf_min, sdf_max) = (
            grids["rif"], grids["sdf"])
        return T.Media(
            kind=_t([m.kind for m in media], np.int32),
            sigma_a=_t(sigma_a, np.float32), sigma_s=_t(sigma_s, np.float32),
            sampling_weight=_t(sw, np.float32),
            strategy=_t([m.strategy for m in media], np.int32),
            manual_density=_t([m.manual_density for m in media], np.float32),
            phase=T.PhaseTable(
                kind=_t([m.phase_kind for m in media], np.int32),
                g=_t([m.g for m in media], np.float32),
                g2=_t([m.g2 for m in media], np.float32),
                mix=_t([m.phase_mix for m in media], np.float32),
                kappa=_t([m.kappa for m in media], np.float32),
                axis=_t([np.asarray(m.fiber_axis)
                         / max(np.linalg.norm(m.fiber_axis), 1e-9)
                         for m in media], np.float32)),
            scale=_t([m.scale for m in media], np.float32),
            density=density, orient=orient,
            majorant=_t(majorant, np.float32),
            rif_kind=_t(rif_kind, np.int32),
            rif_params=_t(_pad8(rif_params), np.float32),
            rif_coeff=_t(rif_coeff, np.float32),
            rif_min=_t(rif_min, np.float32), rif_max=_t(rif_max, np.float32),
            sdf_kind=_t(sdf_kind, np.int32),
            sdf_params=_t(_pad8(sdf_params), np.float32),
            sdf_coeff=_t(sdf_coeff, np.float32),
            sdf_min=_t(sdf_min, np.float32), sdf_max=_t(sdf_max, np.float32))
