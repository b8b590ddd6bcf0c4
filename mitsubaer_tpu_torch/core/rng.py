"""Counter-based samplers (port of mitsubaer_tpu/core/rng.py): the
independent, lds, stratified, halton, hammersley and sobol modes, and the
VECTOR mode, which replays an explicit table of uniforms.

Every (seed, lane, sample_index, dimension) tuple hashes to one float, so a
render is order-independent and replayable, and the port reproduces the JAX
package's streams bit for bit (halton and hammersley within an ulp: their
float32 radical-inverse sums may be contracted to FMAs by XLA on the CPU).

uint32 arithmetic runs in int64 tensors masked to 32 bits: PyTorch's CPU
uint32 tensors lack `+`, `>>` and `<`. Products are split into 16-bit halves
so no intermediate leaves int64's range.

A draw hashes (seed, lane, index, dim) by `hash_combine`, whose prefix over
(seed, lane, index) does not change from draw to draw: the Sampler keeps it
as `key`, so a draw costs one combine step and the final hash.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..utils import stats

# the JAX package's sampler modes; VECTOR (replayable: draws come from an
# explicit (N, D) table of uniforms, the reference's ReplayableSampler,
# rsampler.cpp, which the primary-sample-space MLT chains mutate) is no
# config name
INDEPENDENT, LDS, STRATIFIED, HALTON, HAMMERSLEY, SOBOL, VECTOR = range(7)
MODES = {"independent": INDEPENDENT, "lds": LDS, "ldsampler": LDS,
         "stratified": STRATIFIED, "halton": HALTON,
         "hammersley": HAMMERSLEY, "sobol": SOBOL}

M32 = 0xFFFFFFFF
_TWO_NEG_32 = 2.3283064365386963e-10   # 2^-32
_ONE_MINUS_EPS = 0.99999994            # largest float32 below 1


def u32(x, device=None) -> torch.Tensor:
    """A Python int or integer tensor as an int64 tensor holding uint32 bits;
    a Python int sent to a device is the host read "rng.u32"."""
    if device is None or isinstance(x, torch.Tensor):
        return torch.as_tensor(x, dtype=torch.int64, device=device) & M32
    return stats.to_device("rng.u32", x, device, torch.int64) & M32


def mul32(x: torch.Tensor, c) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and c in [0, 2^32), an int or a
    tensor of uint32 bits (each half-product stays below 2^48)."""
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (hi + (x & 0xFFFF) * c) & M32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer (public-domain integer hash)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _combine(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _hash_u32((x + mul32(h, 0x01000193)) & M32)


def hash_combine(*xs) -> torch.Tensor:
    device = next((x.device for x in xs
                   if isinstance(x, torch.Tensor) and x.dim() > 0),
                  xs[0].device if isinstance(xs[0], torch.Tensor)
                  else torch.device("cpu"))
    h = u32(0x9E3779B9, device)
    for x in xs:
        h = _combine(h, x.to(device) if isinstance(x, torch.Tensor)
                     else u32(x, device))
    return h


def _u32_to_float(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_max(x.to(torch.float32) * _TWO_NEG_32, _ONE_MINUS_EPS)


def _reverse_bits(x: torch.Tensor) -> torch.Tensor:
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    return ((x << 16) & M32) | (x >> 16)


def _owen_scramble(x: torch.Tensor, seed) -> torch.Tensor:
    """Laine-Karras style nested uniform scramble on reversed bits."""
    x = (x + seed) & M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ mul32(x, c)
    return x


def _xor_bits(index: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """XOR of cols[..., i] over the set bits i of index: the 32-step
    digit loop of the JAX package as five pairwise XOR steps over an
    (..., 32) masked table."""
    shifts = torch.arange(32, dtype=torch.int64, device=index.device)
    m = ((index.unsqueeze(-1) >> shifts) & 1) * cols
    while m.shape[-1] > 1:
        h = m.shape[-1] // 2
        m = m[..., :h] ^ m[..., h:]
    return m[..., 0]


# the second Sobol' dimension's direction numbers: v = 2^31, v ^= v >> 1
_SOBOL2_V = [1 << 31]
for _ in range(31):
    _SOBOL2_V.append(_SOBOL2_V[-1] ^ (_SOBOL2_V[-1] >> 1))


def _sobol_2nd_dim(index: torch.Tensor) -> torch.Tensor:
    """Second Sobol' dimension via direction-number XOR (32 bits)."""
    return _xor_bits(index, torch.tensor(_SOBOL2_V, dtype=torch.int64,
                                         device=index.device))


# Sobol' direction numbers (sobol.cpp's generated tables replaced by
# primitive polynomials over GF(2) found by brute force, with odd initial
# m-values from a fixed numpy stream): a copy of the JAX package's numpy
# construction, so both tables are equal.
_SOBOL_DIMS = 64


def _primitive_polys(max_count: int):
    """Primitive polynomials over GF(2), ascending degree, as (degree,
    interior coefficient bits a_1..a_{s-1}, MSB = a_1)."""
    def poly_mulmod(a, b, p, s):
        r = 0
        while b:
            if b & 1:
                r ^= a
            b >>= 1
            a <<= 1
            if a >> s:
                a ^= p
        return r

    def is_primitive(p, s):
        order = (1 << s) - 1

        def powx(e):
            r, base = 1, 2
            while e:
                if e & 1:
                    r = poly_mulmod(r, base, p, s)
                base = poly_mulmod(base, base, p, s)
                e >>= 1
            return r

        if powx(order) != 1:
            return False
        n, fac = order, []
        d = 2
        while d * d <= n:
            if n % d == 0:
                fac.append(d)
                while n % d == 0:
                    n //= d
            d += 1
        if n > 1:
            fac.append(n)
        return all(powx(order // q) != 1 for q in fac)

    out = []
    s = 1
    while len(out) < max_count:
        for interior in range(1 << max(s - 1, 0)):
            p = (1 << s) | 1
            for i in range(s - 1):
                if (interior >> i) & 1:
                    p |= 1 << (i + 1)
            if is_primitive(p, s):
                out.append((s, interior))
                if len(out) >= max_count:
                    break
        s += 1
    return out


def _build_sobol_table(ndims: int) -> np.ndarray:
    rng = np.random.RandomState(0x5EB01)
    table = np.zeros((ndims, 32), np.uint32)
    table[0] = np.uint32(1) << (31 - np.arange(32))  # dim 0: van der Corput
    for j, (s, interior) in enumerate(_primitive_polys(ndims - 1), start=1):
        a = [(interior >> i) & 1 for i in range(s - 1)]
        m = [0] * 33
        for i in range(1, s + 1):
            m[i] = 2 * rng.randint(0, 1 << (i - 1)) + 1 if i > 1 else 1
        for k in range(s + 1, 33):
            acc = m[k - s] ^ (m[k - s] << s)
            for i in range(1, s):
                if a[i - 1]:
                    acc ^= m[k - i] << i
            m[k] = acc
        for k in range(1, 33):
            table[j, k - 1] = np.uint32((m[k] << (32 - k)) & 0xFFFFFFFF)
    return table


_SOBOL_TABLE = _build_sobol_table(_SOBOL_DIMS)   # (64, 32) uint32
_device_tables: dict = {}


def _on(device, name: str, build) -> torch.Tensor:
    """A constant table on `device`, made once."""
    key = (name, str(device))
    if key not in _device_tables:
        _device_tables[key] = build().to(device)
    return _device_tables[key]


def sobol_sample(index, dim, scramble_key):
    """Owen-scrambled Sobol' point: dimension `dim` of sample `index`;
    scramble_key decorrelates (seed, lane, dim) streams."""
    tab = _on(index.device, "sobol", lambda: torch.from_numpy(
        _SOBOL_TABLE.astype(np.int64)))
    x = _xor_bits(index, tab[dim % _SOBOL_DIMS])
    x = _reverse_bits(_owen_scramble(_reverse_bits(x), scramble_key))
    return _u32_to_float(x)


# the first 20 primes, the Halton / Hammersley bases
_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29,
           31, 37, 41, 43, 47, 53, 59, 61, 67, 71]


def radical_inverse(index, base, scramble_key):
    """Radical inverse of `index` in the (per-lane) `base` with Faure-style
    digit scrambling keyed by scramble_key (halton.cpp + faure.cpp): 32
    digits, the float32 sum r + f d in the JAX package's order. The loop
    ends once every later term is below a quarter of an ulp of r on every
    lane: those additions round back to r, so the result is the 32-digit
    one (one host sync a digit)."""
    inv = 1.0 / base.to(torch.float32)
    top = (base - 1).to(torch.float32)
    x = index
    r = torch.zeros(index.shape, dtype=torch.float32, device=index.device)
    f = inv
    for i in range(32):
        d = x % base
        x = x // base
        h = _hash_u32((scramble_key + ((i * 0x9E3779B9) & M32)) & M32)
        d = (d + h % base) % base
        r = r + f * d.to(torch.float32)
        f = f * inv
        quarter_ulp = (torch.nextafter(r, torch.full_like(r, 2.0)) - r) * 0.25
        if stats.host_read("rng.radical_inverse", stats.all_of,
                           f * top < quarter_ulp):
            break
    return torch.clamp_max(r, _ONE_MINUS_EPS)


def _kensler_permute(i, n: int, key):
    """Stateless pseudorandom permutation of [0, n) (cycle-walking hash;
    Kensler, 'Correlated Multi-Jittered Sampling'). The walk is a host
    loop over the lanes still at or above n (one sync a round)."""
    w = n - 1
    for s in (1, 2, 4, 8, 16):
        w |= w >> s
    w &= M32

    def rounds(x):
        x = x ^ key
        x = mul32(x, 0xE170893D)
        x = x ^ (key >> 16)
        x = x ^ ((x & w) >> 4)
        x = x ^ (key >> 8)
        x = mul32(x, 0x0929EB3F)
        x = x ^ (key >> 23)
        x = x ^ ((x & w) >> 1)
        x = mul32(x, 1 | (key >> 27))
        x = mul32(x, 0x6935FA69)
        x = x ^ ((x & w) >> 11)
        x = mul32(x, 0x74DCCA23)
        x = x ^ ((x & w) >> 2)
        x = mul32(x, 0x9E501CC3)
        x = x ^ ((x & w) >> 2)
        x = mul32(x, 0xC860A3DF)
        x = x & w
        return x ^ (x >> 5)

    x = rounds(i)
    while stats.host_read("rng.permute", stats.any_of, x >= n):
        x = torch.where(x >= n, rounds(x), x)
    return ((x + key) & M32) % max(n, 1)


@dataclass(frozen=True)
class Sampler:
    """Stateless stream: `lane` names the pixel or ray, `index` the sample
    within it, `dim` the next dimension to draw; `key` is
    hash_combine(seed, lane, index). All int64 uint32 bits. `mode` and
    `n_samples` (the spp, which shapes the stratified and hammersley
    modes) are static. `table` is the VECTOR mode's (N, D) float32
    uniforms, row i read by the sampler's lane i."""

    lane: torch.Tensor
    index: torch.Tensor
    dim: torch.Tensor
    seed: torch.Tensor
    key: torch.Tensor
    mode: int = INDEPENDENT
    n_samples: int = 16
    table: torch.Tensor | None = None


def mode_of(name: str) -> int:
    """The sampler mode a config's `sampler` names; a name that is no mode
    means the independent sampler, as in the JAX package."""
    return MODES.get(name, INDEPENDENT)


def make_sampler(seed, lane, sample_index, mode: int = INDEPENDENT,
                 n_samples: int = 16, table=None) -> Sampler:
    """A stream in `mode`; `n_samples` (the spp) shapes the stratified and
    hammersley modes, `table` is the VECTOR mode's (N, D) uniforms."""
    lane = u32(lane)
    index = u32(sample_index, lane.device)
    seed = u32(seed, lane.device)
    return Sampler(lane=lane, index=index, dim=torch.zeros_like(lane),
                   seed=seed, key=hash_combine(seed, lane, index),
                   mode=mode, n_samples=n_samples, table=table)


def restart(s: Sampler, where: torch.Tensor, lane: torch.Tensor,
            index: torch.Tensor) -> Sampler:
    """The sampler with the lanes `where` moved to (lane, index) at dim 0."""
    lane, index = u32(lane), u32(index)
    return replace(
        s, lane=torch.where(where, lane, s.lane),
        index=torch.where(where, index, s.index),
        dim=torch.where(where, 0, s.dim),
        key=torch.where(where, hash_combine(s.seed, lane, index), s.key))


def _independent_bits(s: Sampler, dim_offset: int) -> torch.Tensor:
    return _hash_u32(_combine(s.key, (s.dim + dim_offset) & M32))


def _dim_key(s: Sampler, offset: int = 0) -> torch.Tensor:
    """hash_combine(seed, lane, dim + offset): the per-dimension scramble
    key of the low-discrepancy modes."""
    return hash_combine(s.seed, s.lane, (s.dim + offset) & M32)


def _salt(key: torch.Tensor, c: int) -> torch.Tensor:
    """hash_combine(key, c) for a constant c."""
    return _combine(_combine(u32(0x9E3779B9, key.device), key), c)


def _div(x: torch.Tensor, n) -> torch.Tensor:
    """x / n in float32 as a true division (torch on CUDA multiplies by the
    rounded reciprocal of a Python scalar divisor)."""
    return x / torch.tensor(float(n), dtype=torch.float32, device=x.device)


def _radical(s: Sampler, offset: int = 0) -> torch.Tensor:
    primes = _on(s.dim.device, "primes",
                 lambda: torch.tensor(_PRIMES, dtype=torch.int64))
    base = primes[((s.dim + offset) & M32) % len(_PRIMES)]
    return radical_inverse(s.index, base, _dim_key(s, offset))


def _vector_draw(s: Sampler, k: int):
    """Dims [dim, dim + k) of each row of the replay table; past its D
    columns (long paths beyond the mutated prefix) the independent hash at
    that dim (rng.py:337-352)."""
    D = s.table.shape[-1]
    outs = []
    for i in range(k):
        idx = (s.dim + i) & M32
        v_tab = torch.gather(s.table, -1, torch.clamp_max(idx, D - 1)
                             .unsqueeze(-1)).squeeze(-1)
        outs.append(torch.where(idx < D, v_tab,
                                _u32_to_float(_independent_bits(s, i))))
    return outs


def next_1d(s: Sampler):
    if s.mode == VECTOR:
        return _vector_draw(s, 1)[0], replace(s, dim=(s.dim + 1) & M32)
    if s.mode == LDS:
        scramble = _dim_key(s)
        shuffled = _owen_scramble(_reverse_bits(s.index),
                                  _salt(scramble, 0x55))
        value = _u32_to_float(_reverse_bits(
            _owen_scramble(_reverse_bits(shuffled), scramble)))
    elif s.mode == STRATIFIED:
        # stratified.cpp: one permuted stratum per sample + jitter
        n = max(s.n_samples, 1)
        p = _kensler_permute(s.index % n, n, _dim_key(s))
        value = _div(p.to(torch.float32)
                     + _u32_to_float(_independent_bits(s, 0)), n)
    elif s.mode in (HALTON, HAMMERSLEY):
        value = _radical(s)
    elif s.mode == SOBOL:
        value = sobol_sample(s.index, s.dim, _dim_key(s))
    else:
        value = _u32_to_float(_independent_bits(s, 0))
    return value, replace(s, dim=(s.dim + 1) & M32)


def next_2d(s: Sampler):
    if s.mode == VECTOR:
        return (torch.stack(_vector_draw(s, 2), dim=-1),
                replace(s, dim=(s.dim + 2) & M32))
    if s.mode == LDS:
        # Owen-shuffle the index per dimension pair, draw the (0,2)-sequence
        # point and Owen-scramble each axis; idx lives in the bit-reversed
        # domain (the x axis's van der Corput bits)
        pair = _dim_key(s)
        idx = _owen_scramble(_reverse_bits(s.index), _salt(pair, 0xA5))
        y_bits = _sobol_2nd_dim(_reverse_bits(idx))
        x = _reverse_bits(_owen_scramble(_reverse_bits(idx),
                                         _salt(pair, 1)))
        y = _reverse_bits(_owen_scramble(_reverse_bits(y_bits),
                                         _salt(pair, 2)))
        value = torch.stack([_u32_to_float(x), _u32_to_float(y)], dim=-1)
    elif s.mode == STRATIFIED:
        # a res x res grid, res the largest square root <= n_samples
        res = max(int(np.sqrt(max(s.n_samples, 1))), 1)
        p = _kensler_permute(s.index % (res * res), res * res, _dim_key(s))
        jx = _u32_to_float(_independent_bits(s, 0))
        jy = _u32_to_float(_independent_bits(s, 1))
        value = torch.stack([_div((p % res).to(torch.float32) + jx, res),
                             _div((p // res).to(torch.float32) + jy, res)],
                            dim=-1)
    elif s.mode in (HALTON, HAMMERSLEY):
        x = _radical(s)
        if s.mode == HAMMERSLEY:
            # hammersley.cpp: the first pair's x axis is i / N
            n = max(s.n_samples, 1)
            shuffled = _kensler_permute(s.index % n, n,
                                        _salt(_dim_key(s), 7))
            x = torch.where(s.dim == 0, _div(
                shuffled.to(torch.float32)
                + _u32_to_float(_independent_bits(s, 2)), n), x)
        value = torch.stack([x, _radical(s, 1)], dim=-1)
    elif s.mode == SOBOL:
        value = torch.stack([sobol_sample(s.index, s.dim, _dim_key(s)),
                             sobol_sample(s.index, (s.dim + 1) & M32,
                                          _dim_key(s, 1))], dim=-1)
    else:
        value = torch.stack([_u32_to_float(_independent_bits(s, 0)),
                             _u32_to_float(_independent_bits(s, 1))], dim=-1)
    return value, replace(s, dim=(s.dim + 2) & M32)
