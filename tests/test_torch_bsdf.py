"""The port's BSDFs against the JAX package's: every one of the 21 kinds'
eval, pdf and sample (and the null surface, index -1) at 4,096 seeded
lanes with the same wi, wo, u2 and u1, a texture's refl_scale and an
h-dielectric eta_override on every lane, the mixture, two-sided and
coating wrappers resolved over their children; and the static `active`
filter, whose result must equal the full evaluation bit for bit.

Tolerance: a lane agrees where |port - JAX| <= 1e-4 |JAX| + 1e-6 s on
every component (s: the quantity's 99th-percentile magnitude over all
lanes). At most 2% of a kind's lanes may disagree (a lane near a branch
edge that the packages' ulps send the other way); measured here: 2 of
4,096 lanes in all (a Ward and a rough-coating sample direction, the
ulps of atan2 and log amplified), none in eval, pdf, delta, eta or the
null passthrough."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.models import bsdf as jbsdf
from mitsubaer_tpu.scene import build as jbuild
from mitsubaer_tpu.scene import types as JT
from mitsubaer_tpu_torch.models import bsdf as tbsdf
from mitsubaer_tpu_torch.scene import types as T

torch.set_num_threads(1)

N = 4096
RTOL, ATOL_SCALE, MAX_BAD = 1e-4, 1e-6, 0.02


def _table():
    """A JAX table with every kind (and a masked plastic); returns the JAX
    BSDFs, the port's (carried) and the children of each wrapper row."""
    b = jbuild.SceneBuilder()
    add = b.add_bsdf
    d = add(JT.BSDF_DIFFUSE, reflectance=(0.7, 0.5, 0.3))
    add(JT.BSDF_DIELECTRIC, eta=1.5)
    add(JT.BSDF_CONDUCTOR, cond_eta=(0.2, 0.9, 1.1), cond_k=(3.9, 2.4, 2.2))
    add(JT.BSDF_NULL)
    add(JT.BSDF_PLASTIC, reflectance=(0.6, 0.4, 0.2), eta=1.49)
    rc = add(JT.BSDF_ROUGHCONDUCTOR, alpha=0.3, cond_eta=(0.2, 0.9, 1.1),
             cond_k=(3.9, 2.4, 2.2))
    add(JT.BSDF_THINDIELECTRIC, eta=1.33)
    add(JT.BSDF_ROUGHDIELECTRIC, alpha=0.25, eta=1.5)
    add(JT.BSDF_PHONG, reflectance=(0.4, 0.4, 0.4),
        specular_r=(0.3, 0.3, 0.3), exponent=20.0)
    add(JT.BSDF_MIRROR, specular_r=(0.9, 0.8, 0.7))
    add(JT.BSDF_HDIELECTRIC, eta=1.4)
    add(JT.BSDF_ROUGHPLASTIC, reflectance=(0.5, 0.3, 0.6), alpha=0.2)
    add(JT.BSDF_WARD, reflectance=(0.3, 0.3, 0.3), specular_r=(0.4, 0.4, 0.4),
        alpha=0.2, alpha_v=0.35)
    add(JT.BSDF_DIFFTRANS, reflectance=(0.6, 0.6, 0.6))
    add(JT.BSDF_HROUGHDIELECTRIC, alpha=0.3, eta=1.4)
    add(JT.BSDF_MIXTURE, child0=d, child1=rc, mix_w=0.35)
    add(JT.BSDF_TWOSIDED, child0=d)
    add(JT.BSDF_HK, specular_r=(0.8, 0.5, 0.3), specular_t=(0.1, 0.2, 0.3),
        alpha=0.6, mix_w=0.4)
    add(JT.BSDF_ROUGHDIFFUSE, reflectance=(0.7, 0.6, 0.5), alpha=0.5)
    add(JT.BSDF_COATING, child0=d, eta=1.5, specular_t=(0.1, 0.1, 0.1))
    add(JT.BSDF_ROUGHCOATING, child0=d, eta=1.5, alpha=0.2,
        specular_t=(0.05, 0.05, 0.05))
    add(JT.BSDF_PLASTIC, reflectance=(0.6, 0.6, 0.6), opacity=0.6)
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    b.add_mesh(v, np.array([[0, 1, 2]], np.int32), bsdf=0)
    b.set_perspective_sensor(np.eye(4, dtype=np.float32), 45.0)
    jbs = b.build().bsdfs
    tbs = T._from_numpy(T.BSDFs, {k: np.asarray(v) for k, v in
                                  jbs._asdict().items() if v is not None},
                        "cpu")
    children = {JT.BSDF_MIXTURE: (JT.BSDF_DIFFUSE, JT.BSDF_ROUGHCONDUCTOR),
                JT.BSDF_TWOSIDED: (JT.BSDF_DIFFUSE,),
                JT.BSDF_COATING: (JT.BSDF_DIFFUSE,),
                JT.BSDF_ROUGHCOATING: (JT.BSDF_DIFFUSE,)}
    return jbs, tbs, children


def _inputs(nb):
    r = np.random.default_rng(0)

    def dirs():
        d = r.normal(size=(N, 3))
        return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
            np.float32)

    return dict(
        idx=(np.arange(N) % (nb + 1) - 1).astype(np.int32),   # -1: null
        wi=dirs(), wo=dirs(),
        u2=r.uniform(0, 1, (N, 2)).astype(np.float32),
        u1=r.uniform(0, 1, N).astype(np.float32),
        eta_override=r.uniform(1.1, 1.6, N).astype(np.float32),
        refl_scale=r.uniform(0.5, 1.0, (N, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def case():
    """Inputs, the JAX results (each function compiled once) and the
    port's, all kinds active."""
    jbs, tbs, children = _table()
    x = _inputs(int(jbs.kind.shape[0]))
    kw = dict(eta_override=jnp.asarray(x["eta_override"]),
              refl_scale=jnp.asarray(x["refl_scale"]))
    idx = jnp.asarray(x["idx"])
    want = dict(
        eval=jax.jit(lambda b, i, a, c: jbsdf.eval(b, i, a, c, **kw))(
            jbs, idx, x["wi"], x["wo"]),
        pdf=jax.jit(lambda b, i, a, c: jbsdf.pdf(b, i, a, c, **kw))(
            jbs, idx, x["wi"], x["wo"]),
        sample=jax.jit(lambda b, i, a, u, v: jbsdf.sample(b, i, a, u, v,
                                                          **kw))(
            jbs, idx, x["wi"], x["u2"], x["u1"]))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    t["idx"] = t["idx"].to(torch.int64)
    got = _port(tbs, t, None)
    kinds = np.where(x["idx"] >= 0,
                     np.asarray(jbs.kind)[np.clip(x["idx"], 0, None)], -1)
    return dict(tbs=tbs, t=t, want=want, got=got, kinds=kinds,
                children=children)


def _port(tbs, t, active):
    kw = dict(eta_override=t["eta_override"], refl_scale=t["refl_scale"],
              active=active)
    return dict(
        eval=tbsdf.eval(tbs, t["idx"], t["wi"], t["wo"], **kw),
        pdf=tbsdf.pdf(tbs, t["idx"], t["wi"], t["wo"], **kw),
        sample=tbsdf.sample(tbs, t["idx"], t["wi"], t["u2"], t["u1"], **kw))


def _agree(got, want):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype == bool:
        return got == want
    s = max(float(np.percentile(np.abs(want), 99)), 1.0)
    ok = np.abs(got - want) <= RTOL * np.abs(want) + ATOL_SCALE * s
    return ok.all(-1) if ok.ndim > 1 else ok


def _check(case, kind, pairs):
    sel = case["kinds"] == kind
    assert sel.sum() >= 150
    for name, got, want in pairs:
        ok = _agree(got, want)
        bad = (~ok[sel]).mean()
        assert bad <= MAX_BAD, (name, kind, bad)
        assert (~ok).mean() <= 1e-3, name


KINDS = list(range(-1, 21))


@pytest.mark.parametrize("kind", KINDS)
def test_eval_matches_jax(case, kind):
    _check(case, kind, [("eval", case["got"]["eval"].numpy(),
                         case["want"]["eval"])])


@pytest.mark.parametrize("kind", KINDS)
def test_pdf_matches_jax(case, kind):
    _check(case, kind, [("pdf", case["got"]["pdf"].numpy(),
                         case["want"]["pdf"])])


@pytest.mark.parametrize("kind", KINDS)
def test_sample_matches_jax(case, kind):
    g, w = case["got"]["sample"], case["want"]["sample"]
    _check(case, kind, [(f, getattr(g, f).numpy(), getattr(w, f))
                        for f in ("wo", "weight", "pdf", "delta", "eta",
                                  "null_passthrough")])


@pytest.mark.parametrize("kind", list(range(21)))
def test_active_filtering_matches_full(case, kind):
    """Lanes of one kind (and null lanes) with `active` set to that kind,
    its wrapper's children and the null surface: the result equals the
    all-kinds evaluation bit for bit, as JAX's _on promises. One exception
    is the JAX package's own: where a rough coating is in the scene, every
    coating lane's specular microfacet is GGX-sampled, the smooth
    coating's too (bsdf.py:882-888), so the smooth coating is held against
    all kinds but the rough coating."""
    sel = torch.from_numpy((case["kinds"] == kind) | (case["kinds"] == -1))
    t = {k: v[sel] for k, v in case["t"].items()}
    active = (kind, *case["children"].get(kind, ()), JT.BSDF_NULL)
    got = _port(case["tbs"], t, active)
    full = _port(case["tbs"], t, None if kind != JT.BSDF_COATING else tuple(
        k for k in range(21) if k != JT.BSDF_ROUGHCOATING))
    assert torch.equal(got["eval"], full["eval"])
    assert torch.equal(got["pdf"], full["pdf"])
    for f in ("wo", "weight", "pdf", "delta", "eta", "null_passthrough"):
        assert torch.equal(getattr(got["sample"], f),
                           getattr(full["sample"], f)), f
