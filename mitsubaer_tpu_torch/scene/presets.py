"""Built-in scenes (port of mitsubaer_tpu/scene/presets.py): the Cornell
box, the bounded scattering volume and the refractive sphere."""
from __future__ import annotations

from dataclasses import replace

import numpy as np

from ..core import transform as tf
from . import types as T
from .build import SceneBuilder

# the canonical Cornell box quads (scenes/cbox/meshes/*.obj)
_FLOOR = [[552.8, 0, 0], [0, 0, 0], [0, 0, 559.2], [549.6, 0, 559.2]]
_CEIL = [[556, 548.8, 0], [556, 548.8, 559.2], [0, 548.8, 559.2],
         [0, 548.8, 0]]
_CEIL_PATCH = [[213, 548.8, 227], [213, 548.8, 332], [343, 548.8, 332],
               [343, 548.8, 227]]
_BACK = [[549.6, 0, 559.2], [0, 0, 559.2], [0, 548.8, 559.2],
         [556, 548.8, 559.2]]
_RED = [[552.8, 0, 0], [549.6, 0, 559.2], [556, 548.8, 559.2],
        [556, 548.8, 0]]
_GREEN = [[0, 0, 559.2], [0, 0, 0], [0, 548.8, 0], [0, 548.8, 559.2]]
_LIGHT = [[343, 548.3, 227], [343, 548.3, 332], [213, 548.3, 332],
          [213, 548.3, 227]]
_SHORT_BOX = [[130, 165, 65], [82, 165, 225], [240, 165, 272],
              [290, 165, 114]]
_TALL_BOX_TOP = [[423, 330, 247], [265, 330, 296], [314, 330, 456],
                 [472, 330, 406]]

# the cbox.xml spectra as RGB (the JAX package's CIE conversion)
CBOX_WHITE = (0.8855787, 0.69885176, 0.6660254)
CBOX_RED = (0.56633127, 0.04451994, 0.04414747)
CBOX_GREEN = (0.10548224, 0.37820008, 0.07626601)
CBOX_LIGHT_RAD = (20.64301, 10.8936205, 2.765043)


def _quad(pts):
    return (np.asarray(pts, np.float32),
            np.array([[0, 1, 2], [0, 2, 3]], np.int32))


def _box(top4, base_y=0.0):
    """A prism from a top quad down to base_y (the cbox's two boxes)."""
    top = np.asarray(top4, np.float32)
    bot = top.copy()
    bot[:, 1] = base_y
    f = [[0, 1, 2], [0, 2, 3]]
    for i in range(4):
        j = (i + 1) % 4
        f += [[i, j, 4 + j], [i, 4 + j, 4 + i]]
    return np.concatenate([top, bot]), np.asarray(f, np.int32)


def cornell_box(res: int = 256, spp: int = 64, max_depth: int = 40,
                integrator: str = "path", sampler: str = "independent",
                filter: str = "gaussian", boxes: bool = True,
                medium: dict | None = None, **cfg_kw):
    """The cbox scene (scenes/cbox/cbox.xml): diffuse walls, an area light
    under the ceiling, the short and tall boxes; `medium=dict(sigma_s=...,
    sigma_a=..., g=...)` fills the box with a homogeneous medium (BASELINE
    config 2). Returns (scene, config)."""
    b = SceneBuilder()
    white = b.add_bsdf(T.BSDF_DIFFUSE, reflectance=CBOX_WHITE)
    red = b.add_bsdf(T.BSDF_DIFFUSE, reflectance=CBOX_RED)
    green = b.add_bsdf(T.BSDF_DIFFUSE, reflectance=CBOX_GREEN)
    light_b = b.add_bsdf(T.BSDF_DIFFUSE, reflectance=(0.78, 0.78, 0.78))
    med = -1
    if medium is not None:
        g = float(medium.get("g", 0.0))
        med = b.add_medium(
            kind=T.MED_HOMOGENEOUS,
            sigma_a=tuple(medium.get("sigma_a", (0.05, 0.05, 0.05))),
            sigma_s=tuple(medium.get("sigma_s", (0.5, 0.5, 0.5))),
            phase_kind=T.PH_HG if g != 0.0 else T.PH_ISOTROPIC, g=g)
        b.camera_medium = med
    # with a medium every surface sees it as its exterior
    for pts, mat in [(_FLOOR, white), (_CEIL, white), (_CEIL_PATCH, white),
                     (_BACK, white), (_RED, red), (_GREEN, green)]:
        b.add_mesh(*_quad(pts), bsdf=mat, exterior=med)
    b.add_mesh(*_quad(_LIGHT), bsdf=light_b, emitter_radiance=CBOX_LIGHT_RAD,
               exterior=med)
    if boxes:
        b.add_mesh(*_box(_SHORT_BOX), bsdf=white, exterior=med)
        b.add_mesh(*_box(_TALL_BOX_TOP), bsdf=white, exterior=med)
    b.set_perspective_sensor(
        to_world=tf.look_at([278, 273, -800], [278, 273, -799], [0, 1, 0]),
        fov_deg=39.3077, fov_axis="x", near=10.0, far=2800.0)
    b.config = replace(b.config, width=res, height=res, spp=spp,
                       max_depth=max_depth, integrator=integrator,
                       sampler=sampler, filter=filter, **cfg_kw)
    return b.build(), b.config


def volumetric_box(res: int = 256, spp: int = 16, max_depth: int = 12,
                   sigma_s=(0.5, 3.5, 7.5), sigma_a=(0.05, 0.05, 0.05),
                   g: float = 0.7, heterogeneous: bool = False,
                   density_res: int = 64, integrator: str = "volpath",
                   emitter_kind: str = "collimated", **cfg_kw):
    """The bounded-scattering-volume scene
    (scenes/volumetric/BoundedScatteringVolume_directionalsource.xml):
    a [-1,1]^3 null-bounded box of HG medium, a collimated beam, a camera
    at (-3,0,0) looking +x. `heterogeneous=True` fills the box with a
    smooth density blob on a density_res^3 grid. Returns (scene, config)."""
    b = SceneBuilder()
    if heterogeneous:
        zs = np.linspace(-1, 1, density_res)
        Z, Y, X = np.meshgrid(zs, zs, zs, indexing="ij")
        density = np.exp(-2.0 * (X * X + Y * Y + Z * Z)).astype(np.float32)
        med = b.add_medium(
            kind=T.MED_HETEROGENEOUS, sigma_a=tuple(sigma_a),
            sigma_s=tuple(sigma_s), phase_kind=T.PH_HG, g=g, density=density,
            density_aabb=((-1, -1, -1), (1, 1, 1)))
    else:
        med = b.add_medium(kind=T.MED_HOMOGENEOUS, sigma_a=tuple(sigma_a),
                           sigma_s=tuple(sigma_s), phase_kind=T.PH_HG, g=g)
    b.add_cube(to_world=np.eye(4, dtype=np.float32), bsdf=-1, interior=med)

    if emitter_kind == "collimated":
        origin = np.array([-1.1, -1.1, -1.1])
        d = np.array([1.1, 1.1, 1.1]) - origin
        b.add_emitter(T.EM_COLLIMATED, radiance=(1e2, 1e2, 1e2),
                      position=tuple(origin),
                      direction=tuple(d / np.linalg.norm(d)))
    elif emitter_kind == "point":
        b.add_emitter(T.EM_POINT, radiance=(1e2, 1e2, 1e2),
                      position=(-1.5, 0.8, 0.0))
    b.set_perspective_sensor(to_world=tf.look_at([-3, 0, 0], [-2, 0, 0],
                                                 [0, 1, 0]),
                             fov_deg=95.8402, fov_axis="x")
    b.config = replace(b.config, width=res, height=res, spp=spp,
                       max_depth=max_depth, integrator=integrator,
                       has_beam=(emitter_kind == "collimated"), **cfg_kw)
    return b.build(), b.config


def refractive_sphere(res: int = 64, spp: int = 16, max_depth: int = 8,
                      rif_kind: int = 0, rif_params=(1.0,),
                      sigma_s=(0.4, 0.4, 0.4), sigma_a=(0.02, 0.02, 0.02),
                      g: float = 0.0, er_stepsize: float = 0.01,
                      backdrop: bool = True, emitter: str = "point", **cfg_kw):
    """The eikonal test scene: a unit sphere of refractive scattering medium
    at the origin (the reference's hackForSphere setup,
    heterogeneousrefractive.cpp:714-720), a point light up-right, a grey
    diffuse backdrop behind and the camera on -z. rif_kind is a
    models/eikonal.py RIF_* (0 const, 1 linear, 2 radial). Returns
    (scene, config) with the legacy single-solve BVP (bvp_restarts=0), as
    the JAX preset sets it; the bench config replaces it in the config.
    emitter="area_behind" lights it instead with a 6 x 6 area quad at
    z = 3, behind the backdrop."""
    from ..models import eikonal as ek

    b = SceneBuilder()
    med = b.add_medium(
        kind=T.MED_REFRACTIVE, sigma_a=tuple(sigma_a), sigma_s=tuple(sigma_s),
        phase_kind=T.PH_HG if g else T.PH_ISOTROPIC, g=g,
        rif_kind=rif_kind, rif_params=tuple(rif_params),
        sdf_kind=ek.SDF_SPHERE, sdf_params=(0.0, 0.0, 0.0, 1.0))
    b.add_sphere([0, 0, 0], 1.0, bsdf=-1, interior=med)
    if backdrop:
        grey = b.add_bsdf(T.BSDF_DIFFUSE, reflectance=(0.5, 0.5, 0.5))
        v = np.array([[-4, -4, 2.5], [4, -4, 2.5], [4, 4, 2.5], [-4, 4, 2.5]],
                     np.float32)
        f = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
        b.add_mesh(v, f, bsdf=grey)
    if emitter == "point":
        b.add_emitter(T.EM_POINT, radiance=(40.0, 40.0, 40.0),
                      position=(2.0, 2.0, -2.0))
    elif emitter == "area_behind":
        lb = b.add_bsdf(T.BSDF_DIFFUSE, reflectance=(0.0, 0.0, 0.0))
        v = np.array([[-3, -3, 3.0], [3, -3, 3.0], [3, 3, 3.0],
                      [-3, 3, 3.0]], np.float32)
        f = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
        b.add_mesh(v, f, bsdf=lb, emitter_radiance=(4.0, 4.0, 4.0))
    b.set_perspective_sensor(
        to_world=tf.look_at([0, 0, -3.5], [0, 0, 0], [0, 1, 0]), fov_deg=45.0)
    b.config = replace(b.config, width=res, height=res, spp=spp,
                       max_depth=max_depth, integrator="volpath_er",
                       er_stepsize=er_stepsize, er_maxsteps=1024,
                       bvp_restarts=0, **cfg_kw)
    return b.build(), b.config
