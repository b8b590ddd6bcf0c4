"""Built-in scenes (port of mitsubaer_tpu/scene/presets.py::volumetric_box
and refractive_sphere)."""
from __future__ import annotations

from dataclasses import replace

import numpy as np

from .. import not_ported
from ..core import transform as tf
from . import types as T
from .build import SceneBuilder


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
    the JAX preset sets it; the bench config replaces it in the config."""
    if emitter != "point":
        raise not_ported(f"refractive_sphere(emitter={emitter!r})", 9)
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
    b.add_emitter(T.EM_POINT, radiance=(40.0, 40.0, 40.0),
                  position=(2.0, 2.0, -2.0))
    b.set_perspective_sensor(
        to_world=tf.look_at([0, 0, -3.5], [0, 0, 0], [0, 1, 0]), fov_deg=45.0)
    b.config = replace(b.config, width=res, height=res, spp=spp,
                       max_depth=max_depth, integrator="volpath_er",
                       er_stepsize=er_stepsize, er_maxsteps=1024,
                       bvp_restarts=0, **cfg_kw)
    return b.build(), b.config
