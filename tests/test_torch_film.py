"""The port's film (models/film.py) against the JAX package's: the six
reconstruction filters at the same offsets, the zero-filled shift, and the
splat of one spp chunk with each filter, on the same seeded values and
jitters (numpy), within rtol 1e-6 and atol 1e-6. The box splat also keeps
the plain sum it was before the other filters were ported, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsubaer_tpu.models import film as jfilm
from mitsubaer_tpu_torch.models import film as tfilm

torch.set_num_threads(1)

FILTERS = ["box", "tent", "gaussian", "mitchell", "catmullrom", "lanczos"]


def _chunk(seed, s=3, h=7, w=9):
    r = np.random.default_rng(seed)
    values = r.exponential(1.0, (s, h, w, 3)).astype(np.float32)
    jitter = r.uniform(0, 1, (s, h, w, 2)).astype(np.float32)
    jitter[0, 0, 0] = (0.0, 0.5)                   # the pixel's edge, centre
    accum = r.uniform(0, 1, (h, w, 4)).astype(np.float32)
    return values, jitter, accum


@pytest.mark.parametrize("name", FILTERS)
def test_filter_eval_matches(name):
    x = np.linspace(-4.0, 4.0, 4001, dtype=np.float32)
    x = np.concatenate([x, np.float32([0.5, -0.5, 1e-5, 1.0, 2.0, 3.0])])
    want = np.asarray(jfilm._filter_eval(name, jnp.asarray(x)))
    got = tfilm._filter_eval(name, torch.from_numpy(x)).numpy()
    assert tfilm.filter_radius(name) == jfilm.filter_radius(name)
    assert (want != 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", FILTERS)
def test_splat_matches(name):
    values, jitter, accum = _chunk(FILTERS.index(name))
    want = np.asarray(jfilm.splat(jnp.asarray(accum), jnp.asarray(values),
                                  jnp.asarray(jitter), name))
    got = tfilm.splat(torch.from_numpy(accum), torch.from_numpy(values),
                      torch.from_numpy(jitter), name).numpy()
    assert got.shape == want.shape == (7, 9, 4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tfilm.develop(torch.from_numpy(got)).numpy(),
                               np.asarray(jfilm.develop(jnp.asarray(want))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dx,dy", [(0, 0), (1, 0), (-2, 1), (3, -3), (0, -1),
                                   (9, 0), (-4, 7)])
def test_shift2d_matches(dx, dy):
    plane = np.random.default_rng(abs(dx * 7 + dy)).normal(
        size=(7, 9, 2)).astype(np.float32)
    want = np.asarray(jfilm._shift2d(jnp.asarray(plane), dx, dy))
    got = tfilm._shift2d(torch.from_numpy(plane), dx, dy).numpy()
    np.testing.assert_array_equal(got, want)


def test_box_splat_is_the_plain_sum():
    """The box filter weighs a sample 1 in its own pixel: the splat adds
    the chunk's sum and its sample count, exactly as before the filtered
    splat (the boxwalk, wavefront and eikonal roads rely on it)."""
    values, jitter, accum = _chunk(11)
    v, j, a = (torch.from_numpy(x) for x in (values, jitter, accum))
    got = tfilm.splat(a, v, j, "box")
    w = torch.where((torch.abs(j[..., 0] - 0.5) <= 0.5)
                    & (torch.abs(j[..., 1] - 0.5) <= 0.5), 1.0, 0.0)
    want = torch.cat([a[..., :3] + (w.unsqueeze(-1) * v).sum(0),
                      (a[..., 3] + w.sum(0)).unsqueeze(-1)], dim=-1)
    assert torch.equal(got, want)
