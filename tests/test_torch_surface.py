"""The surface slice of the port against the JAX package: the math, warp
and transform helpers, intersect with texture coordinates (the cbox and
spheres), the BVH (build arrays equal, traversal equal to JAX's and to
brute force), the port's cornell_box against the JAX one carried by
scene_from_numpy, direct sampling of area, spot and directional emitters
lane by lane, the carried non-diffuse scenes that used to render wrong
(F3: the port treated every kind but diffuse as the null surface), the
area-lit refractive sphere on the eikonal road, and what stays unported
raising on every road.

Tolerances are stated at each test; measured worst cases: the cbox
intersection equal to JAX's (t, primitives, texture coordinates), BVH
t, u, v within 7e-6 of JAX's, emitter samples within 1e-5 relative but
a direction component at 1.5e-4 of its own (small) size, the F3 images
~1e-7 of their largest pixel."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import math as jmath
from mitsubaer_tpu.core import transform as jtf
from mitsubaer_tpu.core import warp as jwarp
from mitsubaer_tpu.integrators import render as jrender
from mitsubaer_tpu.models import eikonal as jek
from mitsubaer_tpu.models import emitter as jemitter
from mitsubaer_tpu.scene import build as jbuild
from mitsubaer_tpu.scene import bvh as jbvh
from mitsubaer_tpu.scene import intersect as jisect
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu.scene import types as JT
from mitsubaer_tpu_torch.core import math as tmath
from mitsubaer_tpu_torch.core import transform as ttf
from mitsubaer_tpu_torch.core import warp as twarp
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.models import emitter as temitter
from mitsubaer_tpu_torch.scene import bvh as tbvh
from mitsubaer_tpu_torch.scene import intersect as tisect
from mitsubaer_tpu_torch.scene import presets as tpresets
from mitsubaer_tpu_torch.scene import types as T
from mitsubaer_tpu_torch.utils import stats as tstats

torch.set_num_threads(1)

N = 4096
CBOX_MEDIUM = dict(sigma_s=(1e-3,) * 3, sigma_a=(1e-4,) * 3, g=0.7)


def _tree(x):
    if hasattr(x, "_asdict"):
        return {k: _tree(v) for k, v in x._asdict().items() if v is not None}
    return np.asarray(x)


def _fields(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _fields(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _u(n, k, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, k)).astype(
        np.float32)


def _close(got, want, atol=1e-6, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# helpers (rtol 1e-5, atol 1e-6)
# ---------------------------------------------------------------------------
def test_math_helpers_match():
    wi, n = _dirs(N, 1), _dirs(N, 2)
    eta = np.random.default_rng(3).uniform(1.1, 2.0, N).astype(np.float32)
    ci = np.random.default_rng(4).uniform(-1, 1, N).astype(np.float32)
    tw, tn, te, tc = (torch.from_numpy(a) for a in (wi, n, eta, ci))
    _close(tmath.reflect_local(tw), jmath.reflect_local(wi))
    _close(tmath.reflect(tw, tn), jmath.reflect(wi, n))
    (a, ta), (b, tb) = tmath.refract(tw, tn, te.unsqueeze(-1)), \
        jmath.refract(wi, n, eta[:, None])
    # near total internal reflection the sqrt amplifies ulps (measured
    # 1.5e-4 on 1 of 4,096 lanes)
    _close(a, b, atol=1e-3)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(tb))
    for got, want in zip(tmath.fresnel_dielectric(tc, te),
                         jmath.fresnel_dielectric(ci, eta)):
        _close(got, want)
    k_eta = np.abs(_dirs(N, 5)) + 0.1
    k_k = np.abs(_dirs(N, 6)) * 3
    # at |cos| near 0 the differences of near-equal terms amplify ulps
    # (measured 1.5e-4 on 1 of 12,288 values)
    _close(tmath.fresnel_conductor(tc, torch.from_numpy(k_eta),
                                   torch.from_numpy(k_k)),
           jmath.fresnel_conductor(ci, k_eta, k_k), atol=1e-3)
    th = np.arccos(ci)
    ph = np.random.default_rng(7).uniform(0, 2 * np.pi, N).astype(np.float32)
    _close(tmath.spherical_direction(torch.from_numpy(th),
                                     torch.from_numpy(ph)),
           jmath.spherical_direction(th, ph))
    for got, want in zip(tmath.spherical_coordinates(tw),
                         jmath.spherical_coordinates(wi)):
        _close(got, want, atol=1e-5)
    _close(tmath.tan_theta(tw), jmath.tan_theta(wi), rtol=1e-4)
    _close(tmath.sgn(tc), jmath.sgn(ci), atol=0)


@pytest.mark.parametrize("name", ["square_to_uniform_hemisphere",
                                  "square_to_uniform_disk",
                                  "square_to_uniform_disk_concentric",
                                  "square_to_uniform_triangle",
                                  "square_to_uniform_cone"])
def test_warps_match(name):
    u = _u(N, 2, 8)
    if name == "square_to_uniform_cone":
        c = np.float32(0.8)
        _close(twarp.square_to_uniform_cone(c, torch.from_numpy(u)),
               jwarp.square_to_uniform_cone(c, u))
        assert abs(twarp.square_to_uniform_cone_pdf(c)
                   - float(jwarp.square_to_uniform_cone_pdf(c))) < 1e-6
        return
    _close(getattr(twarp, name)(torch.from_numpy(u)),
           getattr(jwarp, name)(u))
    assert twarp.square_to_uniform_hemisphere_pdf() == \
        jwarp.square_to_uniform_hemisphere_pdf()


def test_transforms_match():
    for f, args in [("translate", ([1, -2, 3],)), ("scale", ([2, 3, 0.5],)),
                    ("scale", (1.5,)), ("rotate", ([1, 2, 3], 37.0)),
                    ("identity", ())]:
        np.testing.assert_array_equal(getattr(ttf, f)(*args),
                                      getattr(jtf, f)(*args))
    m = jtf.compose(jtf.translate([1, 2, 3]), jtf.rotate([0, 1, 1], 30),
                    jtf.scale([1, 2, 3]))
    np.testing.assert_array_equal(
        ttf.compose(ttf.translate([1, 2, 3]), ttf.rotate([0, 1, 1], 30),
                    ttf.scale([1, 2, 3])), m)
    p = np.random.default_rng(9).normal(size=(N, 3)).astype(np.float32)
    tm, tp = torch.from_numpy(m), torch.from_numpy(p)
    _close(ttf.apply_point(tm, tp), jtf.apply_point(m, p), atol=1e-5)
    _close(ttf.apply_vector(tm, tp), jtf.apply_vector(m, p), atol=1e-5)
    _close(ttf.apply_normal(tm, tp), jtf.apply_normal(m, p), atol=1e-5)


# ---------------------------------------------------------------------------
# scenes and intersection
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("medium", [None, CBOX_MEDIUM],
                         ids=["plain", "medium"])
def test_cornell_box_equals_jax_build(medium):
    """Every field of the port's cornell_box equals the carried JAX one
    bit for bit, the triangle cdf table included, and so does the
    config."""
    js, jc = jpresets.cornell_box(res=16, spp=4, medium=medium)
    ts, tc = tpresets.cornell_box(res=16, spp=4, medium=medium)
    carried = T.scene_from_numpy(_tree(js))
    for (name, a), (_, b) in zip(_fields(carried), _fields(ts)):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    assert T.config_from_dict(jc._asdict()) == tc
    assert tc.bsdf_kinds == (JT.BSDF_DIFFUSE,)
    assert ts.emitters.tri_count.tolist() == [2]


@pytest.fixture(scope="module")
def cbox():
    js, jc = jpresets.cornell_box(res=16, spp=4)
    return js, T.scene_from_numpy(_tree(js))


def test_intersect_with_uv_matches_on_cbox(cbox):
    """Rays from inside the box: t (rtol 1e-5), primitive, shape, normal,
    barycentric and texture coordinates (atol 1e-5)."""
    js, ts = cbox
    r = np.random.default_rng(11)
    o = r.uniform([50, 50, 50], [500, 500, 500], (N, 3)).astype(np.float32)
    d = _dirs(N, 12)
    jh = jisect.intersect(js.geo, jnp.asarray(o), jnp.asarray(d), 1e-3,
                          jisect.INF, need_uv=True)
    th = tisect.intersect(ts.geo, torch.from_numpy(o), torch.from_numpy(d),
                          1e-3, tisect.INF, need_uv=True)
    v = np.asarray(jh.valid)
    np.testing.assert_array_equal(th.valid.numpy(), v)
    assert v.mean() > 0.8              # the box is open toward the camera
    np.testing.assert_array_equal(th.prim.numpy()[v], np.asarray(jh.prim)[v])
    np.testing.assert_array_equal(th.shape_id.numpy(),
                                  np.asarray(jh.shape_id))
    _close(th.t, jh.t)
    for f in ("ng", "uv", "tex_uv"):
        _close(getattr(th, f).numpy()[v], np.asarray(getattr(jh, f))[v],
               atol=1e-5)


def test_intersect_spheres_with_uv_match():
    """Nine spheres (more than the JAX package unrolls) and a quad: the
    sphere branch's lat-long texture coordinates."""
    b = jbuild.SceneBuilder()
    for i in range(9):
        b.add_sphere([(i % 3) * 2.0 - 2, (i // 3) * 2.0 - 2, 4.0],
                     0.6 + 0.05 * i, bsdf=0)
    b.add_mesh(np.array([[-5, -5, 6], [5, -5, 6], [5, 5, 6]], np.float32),
               np.array([[0, 1, 2]], np.int32), bsdf=0)
    b.set_perspective_sensor(np.eye(4, dtype=np.float32), 45.0)
    js = b.build()
    ts = T.scene_from_numpy(_tree(js))
    r = np.random.default_rng(13)
    o = np.zeros((N, 3), np.float32)
    tgt = np.stack([r.uniform(-3, 3, N), r.uniform(-3, 3, N),
                    np.full(N, 4.0)], -1)
    d = (tgt / np.linalg.norm(tgt, axis=-1, keepdims=True)).astype(
        np.float32)
    jh = jisect.intersect(js.geo, jnp.asarray(o), jnp.asarray(d), 1e-4,
                          jisect.INF, need_uv=True)
    th = tisect.intersect(ts.geo, torch.from_numpy(o), torch.from_numpy(d),
                          1e-4, tisect.INF, need_uv=True)
    v = np.asarray(jh.valid)
    np.testing.assert_array_equal(th.valid.numpy(), v)
    np.testing.assert_array_equal(th.prim.numpy()[v], np.asarray(jh.prim)[v])
    assert (th.prim.numpy()[v] >= (1 << 30)).mean() > 0.3
    _close(th.t, jh.t)
    _close(th.tex_uv.numpy()[v], np.asarray(jh.tex_uv)[v], atol=1e-5)


def _soup(T_=2000, seed=0):
    r = np.random.default_rng(seed)
    c = r.uniform(-1, 1, (T_, 3)).astype(np.float32)
    return (c + r.normal(0, 0.02, (T_, 3)).astype(np.float32),
            r.normal(0, 0.06, (T_, 3)).astype(np.float32),
            r.normal(0, 0.06, (T_, 3)).astype(np.float32))


def _soup_rays(n=2048, seed=1):
    r = np.random.default_rng(seed)
    o = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = r.normal(0, 1, (n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("T_,seed", [(2000, 0), (777, 2), (5, 3)])
def test_build_bvh_arrays_equal_jax(T_, seed):
    v0, e1, e2 = _soup(T_, seed)
    jb, tb = jbvh.build_bvh(v0, e1, e2), tbvh.build_bvh(v0, e1, e2)
    for f in ("nodes", "counts", "tris", "tri_id"):
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8))


def test_intersect_bvh_matches_jax_and_brute_force():
    """tests/test_bvh.py's 2,000-triangle soup: the port's traversal gives
    JAX's hits and triangle ids, with t, u and v within 1e-5 (measured:
    ulp-level differences on ~100 of the 2,048 rays, up to 7e-6 on a
    barycentric: JAX forms the Moller-Trumbore dot products in its own
    reduction order), and the
    brute-force sweep's closest hit in [t_min, t_max] (equal ids, t within
    1e-6 relative)."""
    v0, e1, e2 = _soup()
    o, d = _soup_rays()
    n = o.shape[0]
    t_min = np.full((n,), 1e-4, np.float32)
    t_max = np.full((n,), 1e9, np.float32)
    jb = jbvh.build_bvh(v0, e1, e2)
    jt, jp, ju, jv = (np.asarray(a) for a in jax.jit(
        lambda o, d: jbvh.intersect_bvh(jb, o, d, t_min, t_max))(o, d))
    tb = tbvh.build_bvh(v0, e1, e2)
    with tstats.tracing():
        tt, tp, tu, tv = (a.numpy() for a in tbvh.intersect_bvh(
            tb, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(t_min), torch.from_numpy(t_max)))
    walk = [s for s in tstats.spans() if s.name == "bvh.walk"][-1]
    hit = jt < 1e30
    assert hit.mean() > 0.05 and walk.counts["trips"] > 10
    np.testing.assert_array_equal(tt < 1e30, hit)
    np.testing.assert_array_equal(tp[hit], jp[hit])
    for a, b in ((tt, jt), (tu, ju), (tv, jv)):
        _close(a[hit], b[hit], rtol=1e-5, atol=1e-5)
    # brute force over the same triangles, closest in range
    geo = T.Geometry(
        v0=torch.from_numpy(v0), e1=torch.from_numpy(e1),
        e2=torch.from_numpy(e2), ng=torch.zeros((len(v0), 3)),
        shape_id=torch.zeros(len(v0), dtype=torch.int32),
        uv0=torch.zeros((len(v0), 2)), uve1=torch.zeros((len(v0), 2)),
        uve2=torch.zeros((len(v0), 2)), sph_center=torch.zeros((1, 3)),
        sph_radius=torch.zeros(1), sph_shape_id=torch.full((1,), -1,
                                                           dtype=torch.int32))
    bt, bp, _, _, bok = tisect._triangles(
        geo, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(t_min), torch.from_numpy(t_max))
    bok = bok.numpy()
    sel = hit & bok            # brute force masks hits behind t_min
    assert sel.sum() >= 0.95 * hit.sum()
    ids = np.asarray(jb.tri_id)[tp[sel]]
    np.testing.assert_array_equal(ids, bp.numpy()[sel])
    _close(tt[sel], bt.numpy()[sel], rtol=1e-6, atol=0)


def test_scene_bvh_dispatch():
    """A mesh of 512 triangles or more gets a BVH (the JAX builder's
    threshold) and intersect walks it; fewer keep brute force. Carried
    scenes take the JAX tree's BVH arrays."""
    from mitsubaer_tpu_torch.scene import build as tbuild
    for n_tri, has in [(511, False), (512, True)]:
        v0, e1, e2 = _soup(n_tri, 4)
        verts = np.stack([v0, v0 + e1, v0 + e2], 1).reshape(-1, 3)
        faces = np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3)
        jb_, tb_ = jbuild.SceneBuilder(), tbuild.SceneBuilder()
        for b in (jb_, tb_):
            b.add_mesh(verts, faces, bsdf=0)
            b.set_perspective_sensor(np.eye(4, dtype=np.float32), 45.0)
        js, ts = jb_.build(), tb_.build()
        assert (ts.geo.bvh.nodes.shape[0] > 0) == has
        carried = T.scene_from_numpy(_tree(js))
        for (name, a), (_, b) in zip(_fields(carried.geo), _fields(ts.geo)):
            assert torch.equal(a, b), name
        o, d = _soup_rays(512, 5)
        jh = jisect.intersect(js.geo, jnp.asarray(o), jnp.asarray(d), 1e-4,
                              jisect.INF)
        th = tisect.intersect(ts.geo, torch.from_numpy(o),
                              torch.from_numpy(d), 1e-4, tisect.INF)
        np.testing.assert_array_equal(th.valid.numpy(), np.asarray(jh.valid))
        np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
        _close(th.t, jh.t)


# ---------------------------------------------------------------------------
# emitters
# ---------------------------------------------------------------------------
def _emitter_scene():
    """Two area emitters (a 3-triangle mesh and a quad), a point, a spot,
    a directional and a constant emitter."""
    b = jbuild.SceneBuilder()
    b.add_bsdf(JT.BSDF_DIFFUSE)
    b.add_mesh(np.array([[-1, 2, -1], [1, 2, -1], [1, 2.5, 1], [-1, 2, 1]],
                        np.float32),
               np.array([[0, 1, 2], [0, 2, 3], [1, 2, 3]], np.int32),
               bsdf=0, emitter_radiance=(3.0, 2.0, 1.0))
    b.add_emitter(JT.EM_POINT, radiance=(5, 5, 5), position=(0, 3, 0))
    b.add_mesh(np.array([[-3, -1, 3], [3, -1, 3], [3, 4, 3], [-3, 4, 3]],
                        np.float32), np.array([[0, 2, 1], [0, 3, 2]],
                                              np.int32),
               bsdf=0, emitter_radiance=(1.0, 1.0, 4.0))
    b.add_emitter(JT.EM_SPOT, radiance=(9, 9, 9), position=(0, 3, -1),
                  direction=(0, -1, 0.2), cutoff_deg=40.0,
                  beam_width_deg=25.0)
    b.add_emitter(JT.EM_DIRECTIONAL, radiance=(2, 2, 2),
                  direction=(0.3, -1, 0.1))
    b.add_emitter(JT.EM_CONSTANT, radiance=(0.2, 0.2, 0.2))
    b.set_perspective_sensor(np.eye(4, dtype=np.float32), 45.0)
    return b.build()


def test_sample_direct_matches_jax():
    """Every field, lane by lane (atol 1e-5 relative to each field's
    scale); the area emitters' triangle picks equal."""
    js = _emitter_scene()
    ts = T.scene_from_numpy(_tree(js))
    r = np.random.default_rng(14)
    ref = r.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    u2, u1 = _u(N, 2, 15), _u(N, 1, 16)[:, 0]
    want = jax.jit(jemitter.sample_direct)(js, ref, u2, u1)
    got = temitter.sample_direct(ts, torch.from_numpy(ref),
                                 torch.from_numpy(u2), torch.from_numpy(u1))
    for f in ("d", "dist", "pdf", "value", "p", "n"):
        w = np.asarray(getattr(want, f))
        s = max(float(np.abs(w).max()), 1.0)
        _close(getattr(got, f), w, rtol=1e-5, atol=1e-6 * s)
    np.testing.assert_array_equal(got.emitter.numpy(),
                                  np.asarray(want.emitter))
    np.testing.assert_array_equal(got.delta.numpy(), np.asarray(want.delta))
    kind = np.asarray(js.emitters.kind)[np.asarray(want.emitter)]
    for k in (JT.EM_AREA, JT.EM_SPOT, JT.EM_DIRECTIONAL):
        assert (kind == k).mean() > 0.1


def test_area_pick_follows_the_segment_cdf():
    """The triangle pick at each segment's cdf edges and the u_tri clamp:
    first slot with cdf >= u in the segment, else its last slot."""
    js = _emitter_scene()
    ts = T.scene_from_numpy(_tree(js))
    em = ts.emitters
    cdf = em.tri_cdf.numpy()
    us = np.concatenate([cdf, np.nextafter(cdf, 0), np.nextafter(cdf, 2),
                         [0.0, 0.9999994, 1.0]]).astype(np.float32)
    for e in (0, 2):
        e_idx = torch.full((len(us),), e)
        _, n_got, _ = temitter._sample_area_position(
            ts, e_idx, torch.full((len(us), 2), 0.3), torch.from_numpy(us))
        _, n_want, _ = jemitter._sample_area_position(
            js, jnp.full((len(us),), e), jnp.full((len(us), 2), 0.3),
            jnp.asarray(us))
        np.testing.assert_array_equal(n_got.numpy(), np.asarray(n_want))


# ---------------------------------------------------------------------------
# F3: carried non-diffuse surfaces
# ---------------------------------------------------------------------------
def _floor_scene(kind):
    """A JAX SceneBuilder scene: one floor quad at y = -1 over [-4, 4]^2, a
    point light of 50 at (0, 2, 0), the camera at (0, 1, -4) looking at
    (0, -1, 0), fov 60; 8^2, spp 16, depth 3, volpath (the gaussian loop
    road)."""
    b = jbuild.SceneBuilder()
    if kind == "textured":
        tex = b.add_texture(JT.TEX_CHECKERBOARD, color0=(0.9, 0.2, 0.2),
                            color1=(0.1, 0.8, 0.1), uv_scale=(4.0, 4.0))
        m = b.add_bsdf(JT.BSDF_DIFFUSE, reflectance=(0.8,) * 3, texture=tex)
    elif kind in (JT.BSDF_DIFFUSE, JT.BSDF_PLASTIC):
        m = b.add_bsdf(kind, reflectance=(0.8,) * 3)
    else:
        m = b.add_bsdf(kind)
    v = np.array([[-4, -1, -4], [4, -1, -4], [4, -1, 4], [-4, -1, 4]],
                 np.float32)
    b.add_mesh(v, np.array([[0, 2, 1], [0, 3, 2]], np.int32), bsdf=m)
    b.add_emitter(JT.EM_POINT, radiance=(50.0,) * 3, position=(0, 2, 0))
    b.set_perspective_sensor(jtf.look_at([0, 1, -4], [0, -1, 0], [0, 1, 0]),
                             fov_deg=60)
    b.config = b.config._replace(width=8, height=8, spp=16, max_depth=3,
                                 integrator="volpath")
    return b.build(), b.config


# the means of the issue that reported F3 (diffuse and plastic)
F3_MEANS = {JT.BSDF_DIFFUSE: 0.545461, JT.BSDF_PLASTIC: 0.472936}


@pytest.mark.parametrize("kind", [JT.BSDF_DIFFUSE, JT.BSDF_PLASTIC,
                                  JT.BSDF_CONDUCTOR, JT.BSDF_DIELECTRIC,
                                  "textured"])
def test_carried_non_diffuse_surfaces_render_as_jax(kind):
    """The carried scene renders JAX's image pixel by pixel within 1e-5
    relative (of the image's largest pixel); the plastic floor rendered
    0.0 before the BSDFs were ported."""
    js, jc = _floor_scene(kind)
    want = np.asarray(jrender.render(js, jc, seed=1))
    got = trender.render(T.scene_from_numpy(_tree(js)),
                         T.config_from_dict(jc._asdict()), seed=1,
                         device="cpu").numpy()
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    if kind in F3_MEANS:
        assert abs(float(got.mean()) / F3_MEANS[kind] - 1) < 1e-5
    if kind in (JT.BSDF_PLASTIC, "textured"):
        assert got.mean() > 0.01


@pytest.fixture
def _acoustic_stub():
    """JAX's acoustic Bessel functions as zeros while the test runs (see
    tests/test_torch_er_grad.py::_acoustic_stub): the sphere's RIF is
    linear, which selects that branch away, and without it the JAX bounce
    compiles in a fraction of the time."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jek, "bessel_jm", lambda m, x: jnp.zeros_like(x))
    yield
    mp.undo()


def test_area_lit_sphere_matches_jax(_acoustic_stub):
    """refractive_sphere(emitter="area_behind") at 16^2, spp 2, depth 3,
    single-solve BVP (the preset's), the bench's h and BVP scale, against
    JAX's host-stepped render: the curved NEE from the medium's scatter
    vertices reaches the area light (kernels D and E on the card). 95% of
    the lit pixels within 1e-3 relative and the mean within 1%
    (tests/test_torch_volpath_er.py's rule; measured: every lit pixel)."""
    kw = dict(res=16, spp=2, max_depth=3, rif_kind=1,
              rif_params=(1.3, 0.15, 0.0, 0.0), er_stepsize=1e-2,
              filter="box", emitter="area_behind")
    cfg_kw = dict(er_maxsteps=64, er_bvp_hscale=4.0)
    js, jc = jpresets.refractive_sphere(**kw)
    want = np.asarray(jrender.render(
        js, jc._replace(er_host_stepped=True, **cfg_kw), seed=0))
    ts, tc = tpresets.refractive_sphere(**kw)
    got = trender.render(ts, dataclasses.replace(tc, **cfg_kw), seed=0,
                         device="cpu").numpy()
    assert np.isfinite(got).all() and got.mean() > 0
    assert abs(got.mean() / want.mean() - 1) <= 0.01
    lit = want.mean(-1) > 0
    assert lit.mean() > 0.3
    close = np.isclose(got, want, rtol=1e-3, atol=0).all(-1)
    assert close[lit].mean() >= 0.95


# ---------------------------------------------------------------------------
# the rest of ROADMAP Queue 1 step 9, ported since: the environment map and
# the other sensor kinds on every road
# ---------------------------------------------------------------------------
def _with_envmap(scene):
    """The scene's first emitter turned into a sky map, with its tables."""
    from mitsubaer_tpu_torch.scene import build as tbuild
    b = tbuild.SceneBuilder()
    b.add_emitter(JT.EM_ENVMAP, envmap=temitter.make_sky_envmap(
        (0.3, 0.5, 0.8), res=8), scale=0.2)
    b.set_perspective_sensor(np.eye(4, dtype=np.float32), 45.0)
    env = b.build().emitters
    em = scene.emitters
    kind = em.kind.clone()
    kind[0] = JT.EM_ENVMAP
    return dataclasses.replace(scene, emitters=dataclasses.replace(
        em, kind=kind, **{f: getattr(env, f) for f in (
            "env_map", "env_cdf_rows", "env_cdf_cond", "env_to_world",
            "env_scale")}))


def _with_sensor(scene, kind):
    return dataclasses.replace(scene, sensor=dataclasses.replace(
        scene.sensor, kind=torch.tensor(kind, dtype=torch.int32)))


def _small_cbox(**kw):
    return tpresets.cornell_box(res=4, spp=1, max_depth=2, **kw)


ROADS = {
    "path": lambda: _small_cbox(),
    "direct": lambda: _small_cbox(integrator="direct"),
    "loop": lambda: _small_cbox(integrator="volpath", medium=CBOX_MEDIUM),
    "wavefront": lambda: _small_cbox(filter="box"),
    "eikonal": lambda: _small_sphere(),
}


def _small_sphere():
    scene, cfg = tpresets.refractive_sphere(
        res=8, spp=1, max_depth=3, rif_kind=1, rif_params=(1.3, 0.15),
        er_stepsize=0.05, emitter="area_behind", filter="box")
    return scene, dataclasses.replace(cfg, er_maxsteps=32)


@pytest.mark.parametrize("road", list(ROADS))
@pytest.mark.parametrize("what", ["envmap", "sensor"])
def test_step9_rest_raises(road, what):
    """An environment-map emitter and a sensor kind but perspective (the
    irradiance meter, named by the config's sensor_kind), which used to
    raise not_ported(..., 9), render on every road, and differently from
    the scene unchanged (tests/test_torch_envmap.py and
    tests/test_torch_sensor.py hold them against JAX). The closed cbox
    lit by the sky alone is black: no ray leaves it."""
    scene, cfg = ROADS[road]()
    img = trender.render(scene, cfg, seed=0, device="cpu")
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    if what == "envmap":
        new, new_cfg = _with_envmap(scene), cfg
    else:
        new = _with_sensor(scene, JT.SENSOR_IRRADIANCEMETER)
        new_cfg = dataclasses.replace(cfg,
                                      sensor_kind=JT.SENSOR_IRRADIANCEMETER)
    out = trender.render(new, new_cfg, seed=0, device="cpu")
    assert bool(torch.isfinite(out).all())
    if what == "sensor" or road == "eikonal":
        assert float(out.mean()) > 0
    assert not torch.allclose(out, img)


@pytest.mark.parametrize("name", ["ao", "field"])
def test_ao_and_field_raise(name):
    """"ao" and "field", which used to raise, render on the loop road
    (tests/test_torch_misc.py holds them against JAX): AO in [0, 1], the
    shading normal's color in [0, 1]."""
    scene, cfg = _small_cbox(integrator=name)
    img = trender.render(scene, cfg, device="cpu")
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    assert float(img.max()) <= 1.0 + 1e-6
