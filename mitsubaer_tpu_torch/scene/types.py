"""Scene description as frozen dataclasses of tensors (port of
mitsubaer_tpu/scene/types.py).

Only the fields that change the results of the ported slices are kept; the
JAX package's TPU tuning knobs (`er_host_stepped`, `brick_map`, and the
`wf_*` fields but the two that set the wavefront engine's pass schedule)
have no counterpart, nor does `Media.albedo`, which no JAX function reads.
`scene_from_numpy` and `config_from_dict` take the JAX package's
`Scene` / `RenderConfig` flattened to nested dicts of numpy arrays (same
field names), so both packages can render the very same scene.

No `from __future__ import annotations` here: `scene_from_numpy` reads the
field types to find nested dataclasses.
"""
import dataclasses
from dataclasses import dataclass, fields

import numpy as np
import torch

# BSDF kinds (models/bsdf.py)
BSDF_DIFFUSE = 0
BSDF_DIELECTRIC = 1
BSDF_CONDUCTOR = 2
BSDF_NULL = 3
BSDF_PLASTIC = 4
BSDF_ROUGHCONDUCTOR = 5
BSDF_THINDIELECTRIC = 6
BSDF_ROUGHDIELECTRIC = 7
BSDF_PHONG = 8
BSDF_MIRROR = 9
BSDF_HDIELECTRIC = 10       # eta from the RIF at the hit (eta_override)
BSDF_ROUGHPLASTIC = 11
BSDF_WARD = 12
BSDF_DIFFTRANS = 13
BSDF_HROUGHDIELECTRIC = 14  # rough dielectric with the RIF's eta
BSDF_MIXTURE = 15           # w child0 + (1 - w) child1
BSDF_TWOSIDED = 16          # child0 shaded on both faces
BSDF_HK = 17                # Hanrahan-Krueger slab: specular_r = sigma_s,
#   specular_t = sigma_a, alpha = thickness, mix_w = HG g
BSDF_ROUGHDIFFUSE = 18      # Oren-Nayar
BSDF_COATING = 19           # smooth dielectric coat over child0
BSDF_ROUGHCOATING = 20      # GGX-rough coat over child0

# Texture kinds (models/texture.py)
TEX_NONE = -1
TEX_CHECKERBOARD = 0
TEX_GRIDTEXTURE = 1
TEX_BITMAP = 2
TEX_WIREFRAME = 3
TEX_SCALE = 4          # color0 * the shared bitmap
TEX_NORMALMAP = 5      # tangent-space normal from RGB
TEX_BUMPMAP = 6        # height field; strength = color0[0]
TEX_NOISE = 7          # Perlin fBm between color0 and color1

# Emitter kinds
EM_AREA = 0
EM_POINT = 1
EM_DIRECTIONAL = 2
EM_COLLIMATED = 3
EM_CONSTANT = 4
EM_SPOT = 5
EM_ENVMAP = 6

# Medium kinds
MED_HOMOGENEOUS = 0
MED_HETEROGENEOUS = 1
MED_REFRACTIVE = 2

# Homogeneous distance-sampling strategies (homogeneous.cpp:143 EBalance,
# ESingle, EManual, EMaximum)
STRAT_BALANCE = 0
STRAT_SINGLE = 1
STRAT_MANUAL = 2
STRAT_MAXIMUM = 3

# Phase kinds
PH_ISOTROPIC = 0
PH_HG = 1
PH_RAYLEIGH = 2
PH_VMF = 3         # von Mises-Fisher lobe (vmf.cpp)
PH_MIXTURE = 4     # two-lobe HG mixture (mixturephase.cpp)
PH_KKAY = 5        # Kajiya-Kay fiber phase (kkay.cpp)
PH_MICROFLAKE = 6  # vMF-distributed flakes about a fiber axis

# Sensor kinds (models/sensor.py)
SENSOR_PERSPECTIVE = 0
SENSOR_THINLENS = 1
SENSOR_ORTHOGRAPHIC = 2
SENSOR_SPHERICAL = 3
SENSOR_RADIANCEMETER = 4
SENSOR_TELECENTRIC = 5        # orthographic footprint + thin lens
SENSOR_PERSPECTIVE_RDIST = 6  # radial distortion
SENSOR_FLUENCEMETER = 7
SENSOR_IRRADIANCEMETER = 8


@dataclass(frozen=True)
class _Tensors:
    """Frozen dataclass whose fields are tensors or nested _Tensors."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in fields(self)})


@dataclass(frozen=True)
class Bvh(_Tensors):
    """Flattened BVH (scene/bvh.py); no nodes where the scene has fewer
    triangles than the builder's threshold (brute-force intersection)."""

    nodes: torch.Tensor    # (N, 8) f32: min3, max3, the skip link and
    #   leaf's first packed triangle + 1 (0 = interior) as int32 bits
    counts: torch.Tensor   # (N,) int32 leaf triangle count (0 = interior)
    tris: torch.Tensor     # (T, 12) f32 packed [v0, e1, e2, pad3]
    tri_id: torch.Tensor   # (T,) int32 packed index -> triangle id


def empty_bvh() -> Bvh:
    return Bvh(nodes=torch.zeros((0, 8)),
               counts=torch.zeros((0,), dtype=torch.int32),
               tris=torch.zeros((0, 12)),
               tri_id=torch.zeros((0,), dtype=torch.int32))


@dataclass(frozen=True)
class Geometry(_Tensors):
    """All triangles in one buffer plus analytic spheres."""

    v0: torch.Tensor            # (T, 3)
    e1: torch.Tensor            # (T, 3) v1 - v0
    e2: torch.Tensor            # (T, 3) v2 - v0
    ng: torch.Tensor            # (T, 3) unit geometric normal
    shape_id: torch.Tensor      # (T,) int32
    uv0: torch.Tensor           # (T, 2) texture coordinates at v0
    uve1: torch.Tensor          # (T, 2) uv1 - uv0
    uve2: torch.Tensor          # (T, 2) uv2 - uv0
    sph_center: torch.Tensor    # (S, 3)
    sph_radius: torch.Tensor    # (S,)
    sph_shape_id: torch.Tensor  # (S,) int32
    bvh: Bvh = dataclasses.field(default_factory=empty_bvh)


@dataclass(frozen=True)
class Shapes(_Tensors):
    bsdf: torch.Tensor      # (NS,) int32, -1 = none (pure medium boundary)
    emitter: torch.Tensor   # (NS,) int32, -1 = none
    interior: torch.Tensor  # (NS,) int32 medium id, -1 = vacuum
    exterior: torch.Tensor  # (NS,) int32


@dataclass(frozen=True)
class BSDFs(_Tensors):
    """Tagged-union BSDF parameter table."""

    kind: torch.Tensor          # (NB,) int32
    reflectance: torch.Tensor   # (NB, 3) diffuse albedo / plastic diffuse
    specular_r: torch.Tensor    # (NB, 3)
    specular_t: torch.Tensor    # (NB, 3)
    eta: torch.Tensor           # (NB,) relative IOR int/ext
    cond_eta: torch.Tensor      # (NB, 3) conductor eta
    cond_k: torch.Tensor        # (NB, 3) conductor k
    alpha: torch.Tensor         # (NB,) GGX roughness (Ward: alpha_u)
    exponent: torch.Tensor      # (NB,) Phong exponent
    alpha_v: torch.Tensor       # (NB,) Ward alpha_v
    opacity: torch.Tensor       # (NB,) mask opacity (1 = opaque)
    texture: torch.Tensor       # (NB,) int32 texture scaling reflectance
    twosided: torch.Tensor      # (NB,) bool
    child0: torch.Tensor        # (NB,) int32 wrapper child A (-1 unused)
    child1: torch.Tensor        # (NB,) int32 mixture child B
    mix_w: torch.Tensor         # (NB,) mixture weight of child A
    normal_tex: torch.Tensor    # (NB,) int32 normal or bump map (-1 none)


@dataclass(frozen=True)
class Textures(_Tensors):
    """Texture table; one bitmap shared by the scene."""

    kind: torch.Tensor        # (NT,) int32 TEX_*
    color0: torch.Tensor      # (NT, 3)
    color1: torch.Tensor      # (NT, 3)
    uv_scale: torch.Tensor    # (NT, 2)
    uv_offset: torch.Tensor   # (NT, 2)
    line_width: torch.Tensor  # (NT,)
    use_bitmap: torch.Tensor  # (NT,) bool
    bitmap: torch.Tensor      # (Hb, Wb, 3), (1, 1, 3) when unused


def empty_textures() -> Textures:
    return Textures(
        kind=torch.full((1,), TEX_NONE, dtype=torch.int32),
        color0=torch.ones((1, 3)), color1=torch.zeros((1, 3)),
        uv_scale=torch.ones((1, 2)), uv_offset=torch.zeros((1, 2)),
        line_width=torch.full((1,), 0.01),
        use_bitmap=torch.zeros((1,), dtype=torch.bool),
        bitmap=torch.ones((1, 1, 3)))


@dataclass(frozen=True)
class Emitters(_Tensors):
    kind: torch.Tensor       # (NE,) int32
    radiance: torch.Tensor   # (NE, 3) area radiance / point and spot
    #   intensity / directional irradiance / collimated power
    position: torch.Tensor   # (NE, 3)
    direction: torch.Tensor  # (NE, 3) unit
    shape_id: torch.Tensor   # (NE,) int32 shape of an area emitter, else -1
    area: torch.Tensor       # (NE,) surface area of area emitters
    cutoff_cos: torch.Tensor        # (NE,) spot cutoff cosine
    beam_falloff_cos: torch.Tensor  # (NE,)
    # the shared lat-long environment map (envmap.cpp), (1, 1, 3) when the
    # scene has none, and its importance-sampling tables
    env_map: torch.Tensor       # (He, We, 3)
    env_cdf_rows: torch.Tensor  # (He,) marginal cdf over rows (sin-weighted)
    env_cdf_cond: torch.Tensor  # (He, We) conditional cdf of each row
    env_to_world: torch.Tensor  # (3, 3) rotation
    env_scale: torch.Tensor     # () radiance scale
    # the area emitters' triangles, one segment an emitter
    tri_index: torch.Tensor   # (M,) int32 triangle id
    tri_cdf: torch.Tensor     # (M,) area cdf within the emitter's segment
    tri_emitter: torch.Tensor  # (M,) int32
    tri_offset: torch.Tensor  # (NE,) int32 segment start
    tri_count: torch.Tensor   # (NE,) int32


@dataclass(frozen=True)
class Sensor(_Tensors):
    kind: torch.Tensor       # () int32
    to_world: torch.Tensor   # (4, 4) camera-to-world
    tan_x: torch.Tensor      # () tan(fov_x / 2), the orthographic
    tan_y: torch.Tensor      #   half-extent
    near: torch.Tensor
    far: torch.Tensor
    aperture: torch.Tensor   # () thin-lens aperture radius
    focus: torch.Tensor      # () focus distance
    kc: torch.Tensor         # (2,) radial distortion coefficients


@dataclass(frozen=True)
class PhaseTable(_Tensors):
    kind: torch.Tensor   # (NM,) int32
    g: torch.Tensor      # (NM,) HG asymmetry (mixture: first lobe)
    g2: torch.Tensor     # (NM,) mixture second-lobe asymmetry
    mix: torch.Tensor    # (NM,) mixture weight of the first lobe
    kappa: torch.Tensor  # (NM,) vMF / microflake concentration
    axis: torch.Tensor   # (NM, 3) unit fiber axis (Kajiya-Kay, microflake)


@dataclass(frozen=True)
class GridData(_Tensors):
    data: torch.Tensor      # (nz, ny, nx), or (nz, ny, nx, 3)
    aabb_min: torch.Tensor  # (3,)
    aabb_max: torch.Tensor  # (3,)


@dataclass(frozen=True)
class Media(_Tensors):
    """Medium table: at most one heterogeneous density grid and one
    refractive-index field per scene; heterogeneous
    sigma_t = scale * density(p) * (sigma_a + sigma_s)."""

    kind: torch.Tensor      # (NM,) int32
    sigma_a: torch.Tensor   # (NM, 3)
    sigma_s: torch.Tensor   # (NM, 3)
    sampling_weight: torch.Tensor  # (NM,) mediumSamplingWeight
    strategy: torch.Tensor  # (NM,) int32 STRAT_* (homogeneous sampling)
    manual_density: torch.Tensor  # (NM,) EManual strategy density
    phase: PhaseTable
    scale: torch.Tensor     # (NM,)
    density: GridData
    orient: GridData        # per-voxel fiber / flake axes (nz, ny, nx, 3)
    #   over the density grid's box; (1, 1, 1, 3) zeros when absent
    majorant: torch.Tensor  # () max density * scale
    rif_kind: torch.Tensor    # () int32, models/eikonal.py RIF_*
    rif_params: torch.Tensor  # (8,) analytic RIF parameters
    rif_coeff: torch.Tensor   # (nz, ny, nx) B-spline coefficients of the
    #   RIF; (1, 1, 1) ones where the RIF is analytic
    rif_min: torch.Tensor     # (3,) the spline grid's box
    rif_max: torch.Tensor     # (3,)
    sdf_kind: torch.Tensor    # () int32, models/eikonal.py SDF_*
    sdf_params: torch.Tensor  # (8,) analytic SDF parameters
    sdf_coeff: torch.Tensor   # (nz, ny, nx) B-spline coefficients of the SDF
    sdf_min: torch.Tensor
    sdf_max: torch.Tensor


@dataclass(frozen=True)
class Scene(_Tensors):
    geo: Geometry
    shapes: Shapes
    bsdfs: BSDFs
    emitters: Emitters
    sensor: Sensor
    media: Media
    textures: Textures
    aabb_min: torch.Tensor
    aabb_max: torch.Tensor
    camera_medium: torch.Tensor  # () int32, -1 = vacuum


@dataclass(frozen=True)
class RenderConfig:
    """Static render settings (the fields of the JAX RenderConfig that the
    ported slice reads)."""

    width: int = 256
    height: int = 256
    max_depth: int = 12
    rr_depth: int = 5
    integrator: str = "path"
    filter: str = "gaussian"    # box | tent | gaussian | mitchell |
    #   catmullrom | lanczos
    sampler: str = "independent"  # core/rng.py MODES; names that are not
    #   sampler modes mean the independent one, as in the JAX package. Only
    #   the loop and wavefront roads read it (others draw independently)
    spp: int = 16
    # the film's decomposition (film.cpp:56-80): steadystate, transient
    # (frames by optical path length) or bounce (frames by depth)
    decomposition: str = "steadystate"
    min_bound: float = 0.0
    max_bound: float = 0.0
    bin_width: float = 1.0
    # CW-ToF (pathlengthsampler.cpp): none, sine, square, hamiltonian, mseq
    # or depthselective, with its wavelength, phase (degrees), code length
    # and neighbours
    modulation: str = "none"
    lambda_: float = 1.0
    phase: float = 0.0
    P: int = 32
    neighbors: int = 3
    engine: str = "auto"
    # eikonal march and curved-NEE solver (heterogeneousrefractive.cpp:208)
    er_stepsize: float = 1e-3
    er_maxsteps: int = 4096
    bvp_tol2: float = 1e-6
    rr_weight: float = 1e-2
    bvp_restarts: int = 8
    er_bvp_hscale: float = 1.0
    er_f64: bool = False
    hide_emitters: bool = False
    medium_strategies: bool = False   # some medium samples distances
    #   with a strategy other than balance; the builder sets it
    has_beam: bool = False      # the beam NEE of the loop and wavefront
    #   engines; volumetric_box sets it for its collimated beam, the scene
    #   builder leaves it False (as in the JAX package)
    # wavefront engine pass schedule: transition passes (each followed by
    # tracking) per super-iteration, and kernel C's trip cap per call. They
    # decide which sampler dimensions each lane draws, so they change
    # results. (The JAX package's wf_track_iters is only an on/off flag
    # when kernel C tracks; the port derives it from the scene's media.)
    wf_mini_passes: int = 1
    wf_mega_trips: int = 6
    bsdf_kinds: tuple = ()      # the BSDF kinds of the scene (the builder
    #   sets it); only their lobes run (() = all, models/bsdf.py _on)
    has_textures: bool = False  # some BSDF carries a texture
    has_normal_tex: bool = False  # some BSDF carries a normal or bump map
    field: str = "shNormal"     # the "field" integrator's output
    phase_kinds: tuple = ()     # the phase kinds of the scene (the builder
    #   sets it); only their lobes run (() = all, models/phase.py _on)
    phase_orient: bool = False  # a medium carries an orientation field:
    #   Kajiya-Kay and microflake turn about its per-voxel axes
    sensor_kind: int = -1       # the sensor kind (the builder sets it);
    #   only its camera model runs (-1 = all, models/sensor.py)

    @property
    def n_frames(self) -> int:
        if (self.decomposition in ("transient", "bounce")
                and self.modulation == "none"):
            return max(int(np.ceil((self.max_bound - self.min_bound)
                                   / self.bin_width)), 1)
        return 1


# fields a JAX tree may leave out (None there): the JAX Geometry's bvh
# below its threshold, a BSDFs table built without normal maps
_ABSENT = {
    (Geometry, "bvh"): lambda kw: empty_bvh(),
    (BSDFs, "normal_tex"): lambda kw: torch.full_like(kw["kind"], -1),
}



def _from_numpy(cls, tree, device):
    kw = {}
    for f in fields(cls):
        if f.name not in tree:
            kw[f.name] = _ABSENT[(cls, f.name)](kw).to(device)
            continue
        v = tree[f.name]
        if isinstance(f.type, type) and issubclass(f.type, _Tensors):
            kw[f.name] = _from_numpy(f.type, v, device)
        else:
            kw[f.name] = torch.as_tensor(np.array(v), device=device)
    return cls(**kw)


def scene_from_numpy(tree: dict, device="cpu") -> Scene:
    """A Scene from nested dicts of numpy arrays named as the JAX Scene's
    fields; fields the port does not keep (the TPU layouts, the albedo
    grid) are ignored."""
    return _from_numpy(Scene, tree, device)


def config_from_dict(d: dict) -> RenderConfig:
    """A RenderConfig from a dict of the JAX RenderConfig's fields; fields
    the port does not keep (TPU tuning knobs) are ignored."""
    return RenderConfig(**{f.name: d[f.name] for f in fields(RenderConfig)
                           if f.name in d})
