"""The port's XML scene loader (scene/xml.py) against the JAX package's, on
inline scenes written to a temporary directory: the main path with a .vol
density grid, a cbox-like scene with OBJ walls, spectra, the lds sampler, a
gaussian filter and bounce frames, the refractive sphere in a
heterogeneousrefractive medium with an hdielectric boundary, and scenes of
an environment map, the sky, a spot light and a bitmap normal map. Both
loaders must give equal RenderConfig fields and equal scene arrays (float
arrays within 1e-6 absolute: the loaders compose the same float32
transforms in numpy)."""
import numpy as np
import pytest

from mitsubaer_tpu.scene import xml as jxml
from mitsubaer_tpu.utils import io as jio
from mitsubaer_tpu_torch.scene import types as T
from mitsubaer_tpu_torch.scene import xml as txml
from test_torch_scene import _fields, _tree

SENSOR = """
  <sensor type="perspective">
    <float name="fov" value="{fov}"/>
    <transform name="toWorld">
      <lookat origin="{origin}" target="{target}" up="0, 1, 0"/>
    </transform>
    <sampler type="{sampler}"><integer name="sampleCount" value="$spp"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="16"/><integer name="height" value="16"/>
      {film}
    </film>
  </sensor>"""


def main_path_xml(vol, filt="gaussian"):
    """The main path (presets.volumetric_box) as XML: a heterogeneous box
    of `vol`'s density under a collimated beam, a null-bounded cube with
    `interior`, the perspective sensor; the filter through $filter."""
    return f"""<scene version="0.5.0">
  <integrator type="volpath"><integer name="maxDepth" value="$depth"/></integrator>
  <medium type="heterogeneous" id="box">
    <volume name="density" type="gridvolume">
      <string name="filename" value="{vol}"/>
    </volume>
    <rgb name="sigmaS" value="0.5, 3.5, 7.5"/>
    <rgb name="sigmaA" value="0.05"/>
    <phase type="hg"><float name="g" value="0.7"/></phase>
  </medium>
  <shape type="cube">
    <transform name="toWorld"><scale value="0.5"/></transform>
    <bsdf type="null"/>
    <ref name="interior" id="box"/>
  </shape>
  <emitter type="collimated">
    <transform name="toWorld">
      <lookat origin="0, 0, -2" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <rgb name="power" value="10"/>
  </emitter>""" + SENSOR.format(
        fov=40, origin="1.5, 0.8, -2.5", target="0, 0, 0",
        sampler="independent",
        film=f'<rfilter type="{filt}"/>') + "\n</scene>"


def _write_obj(path, verts, faces):
    with open(path, "w") as f:
        for v in verts:
            f.write("v %g %g %g\n" % tuple(v))
        for t in faces:
            f.write("f %d/1/1 %d/2/2 %d/3/3 %d\n" % tuple(i + 1 for i in t))


def cbox_xml(d):
    """A cbox-like scene: quad walls from OBJ files (polygon faces, v/vt/vn
    indices), spectra given as wavelength:value pairs, the lds sampler, a
    gaussian filter, bounce frames, an area light on a rectangle, a
    twosided and a mixture BSDF and a sphere."""
    quad = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], float)
    _write_obj(d / "wall.obj", quad, [[0, 1, 2, 3]])
    return """<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="-1"/></integrator>
  <bsdf type="twosided" id="red">
    <bsdf type="diffuse">
      <spectrum name="reflectance" value="400:0.04, 500:0.05, 600:0.6, 700:0.65"/>
    </bsdf>
  </bsdf>
  <bsdf type="diffuse" id="green">
    <spectrum name="reflectance" value="400:0.09, 500:0.5, 600:0.1, 700:0.05"/>
  </bsdf>
  <bsdf type="blendbsdf" id="mix">
    <float name="weight" value="0.3"/>
    <bsdf type="roughconductor"><float name="alpha" value="0.2"/></bsdf>
    <bsdf type="plastic"><string name="intIOR" value="water"/></bsdf>
  </bsdf>
  <shape type="obj">
    <string name="filename" value="wall.obj"/>
    <transform name="toWorld"><rotate y="1" angle="90"/><translate x="-1"/></transform>
    <ref id="red"/>
  </shape>
  <shape type="obj">
    <string name="filename" value="wall.obj"/>
    <transform name="toWorld"><rotate y="1" angle="-90"/><translate x="1"/></transform>
    <ref id="green"/>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld">
      <scale x="0.3" y="0.3"/><rotate x="1" angle="90"/><translate y="0.99"/>
    </transform>
    <emitter type="area"><spectrum name="radiance" value="400:0, 500:8, 600:15.6, 700:18.4"/></emitter>
  </shape>
  <shape type="sphere">
    <point name="center" x="0.2" y="-0.6" z="0.1"/>
    <float name="radius" value="0.35"/>
    <ref id="mix"/>
  </shape>""" + SENSOR.format(
        fov=39.3, origin="0, 0, 3.9", target="0, 0, 0", sampler="ldsampler",
        film="""<string name="decomposition" value="bounce"/>
      <float name="minBound" value="0"/><float name="maxBound" value="6"/>
      <float name="binWidth" value="1"/>
      <rfilter type="gaussian"/>""") + "\n</scene>"


def refractive_xml(d):
    """The refractive sphere: a heterogeneousrefractive medium whose RIF is
    a spline grid from a .vol file, bounded by an hdielectric sphere, lit
    by a point light; transient frames and the box filter."""
    g = np.random.default_rng(3).uniform(1.3, 1.4, (6, 5, 4)).astype(
        np.float32)
    jio.write_vol(d / "rif.vol", g, (-1, -1, -1), (1, 1, 1))
    return """<scene version="0.5.0">
  <integrator type="volpath"><integer name="maxDepth" value="6"/></integrator>
  <medium type="heterogeneousrefractive" id="glass">
    <volume name="rif" type="splinevolume">
      <string name="filename" value="rif.vol"/>
    </volume>
    <float name="sigmaT" value="0.4"/><float name="albedo" value="0.8"/>
    <phase type="isotropic"/>
  </medium>
  <shape type="sphere">
    <float name="radius" value="1"/>
    <bsdf type="hdielectric"><float name="intIOR" value="1.33"/></bsdf>
    <ref name="interior" id="glass"/>
  </shape>
  <emitter type="point">
    <transform name="toWorld"><translate x="0" y="2" z="-2"/></transform>
    <spectrum name="intensity" value="20"/>
  </emitter>""" + SENSOR.format(
        fov=35, origin="0, 0, -4", target="0, 0, 0", sampler="independent",
        film="""<string name="decomposition" value="transient"/>
      <float name="minBound" value="2"/><float name="maxBound" value="14"/>
      <float name="binWidth" value="0.5"/>
      <rfilter type="box"/>""") + "\n</scene>"


def lights_xml(d, env):
    """An environment map (from an EXR) or the sky, a spot light, a floor
    with a bitmap normal map (from a PNG) over a diffuse BSDF, and a
    coated conductor."""
    rng = np.random.default_rng(5)
    jio.write_exr(str(d / "env.exr"),
                  rng.uniform(0, 2, (8, 16, 3)).astype(np.float32))
    jio.write_png(str(d / "normal.png"),
                  rng.uniform(0, 1, (8, 8, 3)).astype(np.float32))
    env_tag = ("""<emitter type="envmap">
    <string name="filename" value="env.exr"/><float name="scale" value="1.5"/>
    <transform name="toWorld"><rotate y="1" angle="30"/></transform>
  </emitter>""" if env == "envmap" else """<emitter type="sky">
    <vector name="sunDirection" x="0.4" y="0.3" z="0.7"/>
    <float name="turbidity" value="4"/>
  </emitter>""")
    return f"""<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="5"/></integrator>
  {env_tag}
  <emitter type="spot">
    <transform name="toWorld"><lookat origin="0, 3, 0" target="0, 0, 0" up="0, 0, 1"/></transform>
    <rgb name="intensity" value="30, 25, 20"/>
    <float name="cutoffAngle" value="25"/>
  </emitter>
  <shape type="rectangle">
    <transform name="toWorld"><scale value="3"/><rotate x="1" angle="-90"/></transform>
    <bsdf type="normalmap">
      <texture type="bitmap"><string name="filename" value="normal.png"/></texture>
      <bsdf type="diffuse"><rgb name="reflectance" value="0.6, 0.5, 0.4"/></bsdf>
    </bsdf>
  </shape>
  <shape type="sphere">
    <point name="center" x="0" y="0.5" z="0"/><float name="radius" value="0.5"/>
    <bsdf type="coating">
      <float name="intIOR" value="1.6"/><rgb name="sigmaA" value="0.1, 0.2, 0.3"/>
      <bsdf type="conductor"><rgb name="eta" value="0.2, 0.9, 1.1"/><rgb name="k" value="3.9, 2.4, 2.2"/></bsdf>
    </bsdf>
  </shape>""" + SENSOR.format(
        fov=50, origin="0, 1.5, -4", target="0, 0.5, 0", sampler="independent",
        film="") + "\n</scene>"


def _assert_same(jpair, tpair):
    (js, jc), (ts, tc) = jpair, tpair
    assert T.config_from_dict(jc._asdict()) == tc
    carried = T.scene_from_numpy(_tree(js))
    for (name, a), (name_t, b) in zip(_fields(carried), _fields(ts)):
        assert name == name_t
        assert a.shape == b.shape, name
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(b.numpy(), a.numpy(), err_msg=name)


def _load_both(path, defines=None):
    return (jxml.load_scene(str(path), defines),
            txml.load_scene(str(path), defines))


SCENES = {
    "main_path": lambda d: main_path_xml(d / "density.vol", "$filter"),
    "cbox": cbox_xml,
    "refractive": refractive_xml,
    "envmap": lambda d: lights_xml(d, "envmap"),
    "sky": lambda d: lights_xml(d, "sky"),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_load_scene_equals_jax(name, tmp_path):
    grid = np.random.default_rng(1).uniform(0, 1, (8, 7, 6)).astype(
        np.float32)
    jio.write_vol(tmp_path / "density.vol", grid, (-0.5, -0.5, -0.5),
                  (0.5, 0.5, 0.5))
    path = tmp_path / f"{name}.xml"
    path.write_text(SCENES[name](tmp_path))
    defines = dict(spp=4, depth=5, filter="gaussian")
    jpair, tpair = _load_both(path, defines)
    _assert_same(jpair, tpair)
    if name == "main_path":
        assert tpair[1].has_beam
        assert tuple(tpair[0].media.density.data.shape) == (8, 7, 6)
    if name == "cbox":
        assert tpair[1].n_frames == 6 and tpair[1].sampler == "lds"


def test_missing_define_raises_as_jax(tmp_path):
    path = tmp_path / "s.xml"
    path.write_text(main_path_xml(tmp_path / "density.vol"))
    with pytest.raises(ValueError) as jerr:
        jxml.load_scene(str(path), dict(depth=3))
    with pytest.raises(ValueError) as terr:
        txml.load_scene(str(path), dict(depth=3))
    assert str(terr.value) == str(jerr.value)
    assert "$spp" in str(terr.value)


def sppm_xml():
    """A diffuse floor and sphere under a rectangular area light, rendered
    by the stochastic progressive photon mapper."""
    return """<scene version="0.5.0">
  <integrator type="sppm"><integer name="maxDepth" value="$depth"/></integrator>
  <shape type="rectangle">
    <transform name="toWorld"><scale value="3"/><rotate x="1" angle="-90"/></transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.6, 0.5, 0.4"/></bsdf>
  </shape>
  <shape type="sphere">
    <point name="center" x="0" y="0.5" z="0"/><float name="radius" value="0.5"/>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.3, 0.6, 0.3"/></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld"><scale value="0.5"/><rotate x="1" angle="90"/><translate y="2"/></transform>
    <emitter type="area"><rgb name="radiance" value="20, 20, 20"/></emitter>
  </shape>""" + SENSOR.format(
        fov=50, origin="0, 1.5, -4", target="0, 0.5, 0", sampler="independent",
        film='<rfilter type="box"/>') + "\n</scene>"


def test_sppm_scene_renders_as_jax(tmp_path, monkeypatch):
    """<integrator type="sppm"/> through each package's loader and render():
    the port's image by phase 8's rule of chip_smoke.py (the median pixel
    ratio over the lit pixels and the means within 2%) against JAX's, and
    within 1e-4 relative plus 1e-6 of the largest value on at least 98% of
    pixels. JAX's photon pass runs op by op with its gather jitted on its
    own (its jitted pass compiles for ~25 s)."""
    import jax
    from mitsubaer_tpu.integrators import photonmap as jpm
    from mitsubaer_tpu.integrators import render as jrender
    from mitsubaer_tpu_torch.integrators import render as trender

    monkeypatch.setattr(jpm, "_pm_pass", jpm._pm_pass.__wrapped__)
    monkeypatch.setattr(jpm, "gather_radiance", jax.jit(
        jpm.gather_radiance, static_argnames=("n_emitted",)))
    path = tmp_path / "sppm.xml"
    path.write_text(sppm_xml())
    (js, jc), (ts, tc) = _load_both(path, dict(spp=4, depth=4))
    _assert_same((js, jc), (ts, tc))
    assert tc.integrator == "sppm"
    want = np.asarray(jrender.render(js, jc, seed=1))
    got = trender.render(ts, tc, seed=1, device="cpu").numpy()
    assert got.shape == want.shape == (16, 16, 3)
    lum_g, lum_w = got.mean(-1), want.mean(-1)
    lit = lum_w > 0
    assert lit.mean() > 0.5
    assert abs(np.median(lum_g[lit] / lum_w[lit]) - 1) <= 0.02
    assert abs(got.mean() / want.mean() - 1) <= 0.02
    ok = np.isclose(got, want, rtol=1e-4, atol=1e-6 * want.max()).all(-1)
    assert ok.mean() >= 0.98, ok.mean()
