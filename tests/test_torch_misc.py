"""The port's misc integrators, the builder's rest and the light image's
other emitters against the JAX package's on the CPU: ao_li and every
field_li output lane by lane (within 1e-5), "ao" and "field" through
render() against JAX's images, render_multichannel and render_adaptive
against JAX's; the rectangle, disk, cylinder, height field and instances
equal to the JAX builder's arrays and tests/test_shapes_misc.py's three
checks; every branch of sample_emitter_ray (area, point, spot, collimated,
directional, constant, environment map) against JAX's lane by lane, and
the eikonal light image of an area, a spot and a directional emitter."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import rng as jrng
from mitsubaer_tpu.core import transform as jtf
from mitsubaer_tpu.integrators import misc as jmisc
from mitsubaer_tpu.integrators import ptracer as jpt
from mitsubaer_tpu.integrators import render as jrender
from mitsubaer_tpu.models import emitter as jemitter
from mitsubaer_tpu.scene import build as jbuild
from mitsubaer_tpu.scene import presets as jpresets
from mitsubaer_tpu_torch.core import rng as trng
from mitsubaer_tpu_torch.integrators import misc as tmisc
from mitsubaer_tpu_torch.integrators import ptracer as tpt
from mitsubaer_tpu_torch.integrators import render as trender
from mitsubaer_tpu_torch.integrators import volpath_er as ter
from mitsubaer_tpu_torch.models import emitter as temitter
from mitsubaer_tpu_torch.models import sensor as tsensor
from mitsubaer_tpu_torch.scene import build as tbuild
from mitsubaer_tpu_torch.scene import presets as tpresets
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)

N = 4096


def _cbox(P, **kw):
    return P.cornell_box(res=8, spp=2, max_depth=3, **kw)


def _rays(ts, n=N):
    r = np.random.default_rng(0)
    px = r.uniform(0, 8, n).astype(np.float32)
    py = r.uniform(0, 8, n).astype(np.float32)
    rays = tsensor.sample_rays(ts.sensor, torch.from_numpy(px),
                               torch.from_numpy(py), 8, 8)
    return rays.o, rays.d


def _samplers(n=N):
    lane = np.arange(n, dtype=np.uint32)
    return (jrng.make_sampler(jnp.uint32(3), jnp.asarray(lane), jnp.uint32(0)),
            trng.make_sampler(3, torch.from_numpy(lane.astype(np.int64)), 0))


@pytest.mark.parametrize("field", ["ao"] + list(tmisc.FIELDS))
def test_misc_li_matches_jax(field):
    """ao_li and field_li on 4,096 camera rays into the cbox."""
    (js, jc), (ts, tc) = _cbox(jpresets), _cbox(tpresets)
    o, d = _rays(ts)
    js_smp, ts_smp = _samplers()
    if field == "ao":
        want, _ = jmisc.ao_li(js, jc, jnp.asarray(o.numpy()),
                              jnp.asarray(d.numpy()), js_smp)
        got, smp = tmisc.ao_li(ts, tc, o, d, ts_smp)
        assert int(smp.dim[0]) == 8
    else:
        want, _ = jmisc.field_li(js, jc, jnp.asarray(o.numpy()),
                                 jnp.asarray(d.numpy()), js_smp, field=field)
        got, _ = tmisc.field_li(ts, tc, o, d, ts_smp, field=field)
    np.testing.assert_allclose(got.steady.numpy(), np.asarray(want.steady),
                               rtol=1e-5, atol=1e-5)


def test_unknown_field_raises_as_jax():
    (_, tc), (ts, _) = _cbox(jpresets), _cbox(tpresets)
    o, d = _rays(ts, 4)
    with pytest.raises(ValueError, match="unknown field"):
        tmisc.field_li(ts, tc, o, d, _samplers(4)[1], field="albedo")


def _sphere_on_floor(P, B, **kw):
    """A sphere on a rectangle, lit by a point: the JAX ao render of the
    cbox compiles for ~200 s on the CPU, this one in seconds."""
    b = B.SceneBuilder()
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] *= 3.0
    b.add_rectangle(to_world=m, bsdf=b.add_bsdf())
    b.add_sphere([0, 0, 0.6], 0.6, bsdf=0)
    b.add_emitter(T.EM_POINT, radiance=(5.0,) * 3, position=(1, -1, 3))
    b.set_perspective_sensor(
        to_world=jtf.look_at([0, -3, 2.5], [0, 0, 0.3], [0, 0, 1]),
        fov_deg=45)
    cfg = dict(width=8, height=8, spp=2, max_depth=3, **kw)
    b.config = (b.config._replace(**cfg) if B is jbuild
                else dataclasses.replace(b.config, **cfg))
    return b.build(), b.config


@pytest.mark.parametrize("integrator,field", [("ao", "shNormal"),
                                              ("field", "distance")])
def test_ao_and_field_render_as_jax(integrator, field):
    """render() through the loop road's camera prologue (gaussian film),
    a sphere on a rectangle."""
    (js, jc), (ts, tc) = (_sphere_on_floor(P, B, integrator=integrator,
                                           field=field)
                          for P, B in ((jpresets, jbuild),
                                       (tpresets, tbuild)))
    want = np.asarray(jrender.render(js, jc, seed=2))
    got = trender.render(ts, tc, seed=2, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_multichannel_and_adaptive_match_jax():
    """tests/test_shapes_misc.py's check, against JAX's channels and its
    adaptive mean (the box-filtered cbox without boxes, 12x12 spp 4)."""
    (js, jc), (ts, tc) = (P.cornell_box(res=12, spp=4, max_depth=3,
                                        boxes=False, filter="box")
                          for P in (jpresets, tpresets))
    want = np.asarray(jmisc.render_multichannel(
        js, jc, fields=["shNormal", "distance"]))
    got = tmisc.render_multichannel(ts, tc, fields=["shNormal", "distance"],
                                    device="cpu").numpy()
    assert got.shape == (12, 12, 9) and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.95
    np.testing.assert_allclose(got[..., 3:], want[..., 3:], rtol=1e-5,
                               atol=1e-4)
    want = np.asarray(jmisc.render_adaptive(js, jc, base_spp=4,
                                            max_sample_factor=2))
    got = tmisc.render_adaptive(ts, tc, base_spp=4, max_sample_factor=2,
                                device="cpu").numpy()
    assert got.shape == (12, 12, 3) and np.isfinite(got).all()
    assert got.mean() > 0
    close = np.isclose(got, want, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.95


def _emitter_xform():
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = 2.0
    m[1, 1] = -1.0   # face downward
    return m


def _shapes(B):
    b = B.SceneBuilder()
    ys, xs = np.meshgrid(np.linspace(0, 2 * np.pi, 9),
                         np.linspace(0, 2 * np.pi, 7), indexing="ij")
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] *= 2.0
    m[2, 3] = -0.5
    b.add_heightfield(0.15 * np.sin(xs) * np.cos(ys), to_world=m,
                      bsdf=b.add_bsdf(), uv_tile=(2.0, 3.0))
    b.add_rectangle(to_world=_emitter_xform(), bsdf=-1,
                    emitter_radiance=(8.0, 8.0, 8.0))
    b.add_disk(jtf.translate([0.5, 0.2, 1.0]), segments=12)
    b.add_cylinder([0, 0, 0], [0.3, 0.4, 1.0], 0.25, segments=10)
    b.add_instances(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
                    np.array([[0, 1, 2]], np.int32),
                    [jtf.translate([i * 0.1, 0, 0]) for i in range(3)])
    return b.build()


def test_builder_shapes_equal_jax():
    js, ts = _shapes(jbuild), _shapes(tbuild)
    for f in ("v0", "e1", "e2", "ng", "shape_id", "uv0", "uve1", "uve2"):
        np.testing.assert_array_equal(getattr(ts.geo, f).numpy(),
                                      np.asarray(getattr(js.geo, f)), f)
    for f in ("tri_index", "tri_cdf", "area", "kind"):
        np.testing.assert_array_equal(getattr(ts.emitters, f).numpy(),
                                      np.asarray(getattr(js.emitters, f)))


def test_heightfield_renders():
    b = tbuild.SceneBuilder()
    ys, xs = np.meshgrid(np.linspace(0, 2 * np.pi, 17),
                         np.linspace(0, 2 * np.pi, 17), indexing="ij")
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] *= 2.0
    m[2, 3] = -0.5
    b.add_heightfield(0.15 * np.sin(xs) * np.cos(ys), to_world=m,
                      bsdf=b.add_bsdf())
    b.add_rectangle(to_world=_emitter_xform(), bsdf=-1,
                    emitter_radiance=(8.0, 8.0, 8.0))
    b.set_perspective_sensor(
        to_world=jtf.look_at([0, -3, 2], [0, 0, 0], [0, 0, 1]), fov_deg=45)
    b.config = dataclasses.replace(b.config, width=12, height=12, spp=8,
                                   max_depth=3, filter="box")
    img = trender.render(b.build(), b.config, device="cpu").numpy()
    assert np.isfinite(img).all() and img.mean() > 0


def test_instances_render_and_cross_bvh_threshold():
    b = tbuild.SceneBuilder()
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                 np.float32) * 0.3
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    mats = []
    for i in range(300):   # 600 triangles: above the BVH threshold
        m = np.eye(4, dtype=np.float32)
        m[0, 3] = (i % 20) * 0.2 - 2.0
        m[1, 3] = (i // 20) * 0.2 - 1.5
        mats.append(m)
    ids = b.add_instances(v, f, mats, bsdf=b.add_bsdf())
    assert len(ids) == 300
    b.add_rectangle(to_world=_emitter_xform(), bsdf=-1,
                    emitter_radiance=(8.0, 8.0, 8.0))
    b.set_perspective_sensor(
        to_world=jtf.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]), fov_deg=50)
    b.config = dataclasses.replace(b.config, width=12, height=12, spp=4,
                                   max_depth=2, filter="box")
    scene = b.build()
    assert scene.geo.bvh.nodes.shape[0] > 0
    img = trender.render(scene, b.config, device="cpu").numpy()
    assert np.isfinite(img).all() and img.mean() > 0


def _all_emitters(B):
    """One emitter of each kind around a sphere, an area quad among them,
    the sky map turned z-up to y-up."""
    b = B.SceneBuilder()
    med = b.add_medium(kind=T.MED_HOMOGENEOUS, sigma_s=(0.1,) * 3)
    b.add_mesh(np.array([[-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1]],
                        np.float32), np.array([[0, 2, 1], [0, 3, 2]],
                                              np.int32),
               emitter_radiance=(3.0, 2.0, 1.0), exterior=med)
    b.add_emitter(T.EM_POINT, radiance=(4.0,) * 3, position=(2, 2, -2))
    b.add_emitter(T.EM_SPOT, radiance=(5.0,) * 3, position=(0, 3, 0),
                  direction=(0, -1, 0.2), cutoff_deg=25.0,
                  beam_width_deg=15.0)
    b.add_emitter(T.EM_COLLIMATED, radiance=(1.0,) * 3, position=(-2, 0, 0),
                  direction=(1, 0, 0))
    b.add_emitter(T.EM_DIRECTIONAL, radiance=(2.0,) * 3,
                  direction=(0.3, -1, 0.2))
    b.add_emitter(T.EM_CONSTANT, radiance=(0.2,) * 3)
    sky = (jemitter if B is jbuild else temitter).make_sky_envmap(
        (0.4, 0.3, 0.7), res=8)
    b.add_emitter(T.EM_ENVMAP, envmap=sky, scale=0.1, to_world=np.array(
        [[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32))
    b.add_sphere([0, 0, 0], 1.0)
    b.camera_medium = med
    b.set_perspective_sensor(jtf.look_at([0, 0, -3.5], [0, 0, 0], [0, 1, 0]),
                             45.0)
    return b.build()


def test_every_emission_branch_matches_jax():
    """sample_emitter_ray against JAX's _sample_emitter_ray on the same
    sampler, lane by lane: the emitter, the three draws, origin, direction
    and weight within 1e-5 (the envmap's texel-edge lanes: >= 99.5% of the
    lanes), the emission medium (the area quad's exterior, else the
    camera's)."""
    js, ts = _all_emitters(jbuild), _all_emitters(tbuild)
    lane = np.arange(N, dtype=np.uint32)
    smp_j = jrng.make_sampler(jnp.uint32(9), jnp.asarray(lane), jnp.uint32(2))
    o, d, w, med, _, _, smp_j, e_j, k_j = jpt._sample_emitter_ray(js, smp_j)
    smp_t = trng.make_sampler(9, torch.from_numpy(lane.astype(np.int64)), 2)
    o_t, d_t, w_t, med_t, smp_t, e_t, k_t = tpt.sample_emitter_ray(ts, smp_t)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    assert set(k_t.tolist()) == set(range(7))
    np.testing.assert_array_equal(smp_t.dim.numpy(), np.asarray(smp_j.dim))
    np.testing.assert_array_equal(med_t.numpy(), np.asarray(med))
    for got, want in [(o_t, o), (d_t, d), (w_t, w)]:
        ok = np.isclose(got.numpy(), np.asarray(want), rtol=1e-5,
                        atol=1e-5).all(-1)
        assert ok[k_t.numpy() != T.EM_ENVMAP].all()
        assert ok.mean() >= 0.995


@pytest.mark.parametrize("kind", ["area", "spot", "directional"])
def test_light_image_renders_each_emitter(kind):
    """The eikonal light image of the refractive sphere lit by the area
    quad behind it (refractive_sphere(emitter="area_behind") without the
    backdrop, which would shade it), a spot or a directional emitter:
    particles reach the film."""
    scene, cfg = tpresets.refractive_sphere(
        res=16, spp=1, max_depth=3, rif_kind=2, rif_params=(1.33, 0.5, 0.5),
        er_stepsize=0.05, filter="box", backdrop=kind != "area",
        emitter="area_behind" if kind == "area" else "point")
    if kind != "area":
        b = tbuild.SceneBuilder()
        if kind == "spot":
            b.add_emitter(T.EM_SPOT, radiance=(200.0,) * 3,
                          position=(0, 3, 0), direction=(0, -1, 0),
                          cutoff_deg=30.0)
        else:
            b.add_emitter(T.EM_DIRECTIONAL, radiance=(20.0,) * 3,
                          direction=(0.2, -1, 0.1))
        scene = dataclasses.replace(scene, emitters=b.build().emitters)
    cfg = dataclasses.replace(cfg, er_maxsteps=128, bvp_restarts=2)
    img = ter.render_er_light_image(scene, cfg, seed=0, n_passes=2,
                                    device="cpu")
    assert bool(torch.isfinite(img).all()) and float(img.sum()) > 0
