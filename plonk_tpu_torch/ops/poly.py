"""Dense polynomial arithmetic over a prime field: port of
`plonk_tpu/ops/poly.py`.

Polynomials are fixed-length int64 coefficient tensors in ascending
degree; trailing zeros are value-neutral (`effective_len` gives the
reference's trimmed length). Every function takes leading batch
dimensions: a polynomial of shape (..., L) against a scalar of shape
(...) (one point or one factor per batch entry), where the JAX package
maps a function over a batch with `vmap`.

Conventions preserved from the reference: Horner evaluation
(src/poly.h:265-272), poly_z = prod (x - p_i) (src/poly.h:274-286),
Lagrange interpolation (src/poly.h:288-321, computed barycentrically:
the interpolating polynomial is unique), long division
(src/poly.h:124-177); division by x^n - 1 and by (x - c) in closed form,
as the prover uses them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

I64 = torch.int64


def pad_to(c: torch.Tensor, length: int) -> torch.Tensor:
    """Zero-pad the last axis to `length` (no-op if already that long)."""
    cur = c.shape[-1]
    if cur == length:
        return c
    if cur > length:
        raise ValueError(f"cannot pad {cur} down to {length}")
    return TF.pad(c, (0, length - cur))


def stack_rows(rows) -> torch.Tensor:
    """Polynomials (..., L), their leading (lane) axes broadcast, stacked
    at the row axis -2: (..., k, L), each lane's k rows beside its lane
    axes."""
    shape = torch.broadcast_shapes(*(r.shape for r in rows))
    return torch.stack([r.expand(shape) for r in rows], dim=-2)


def effective_len(c) -> int:
    """Length after reference-style trailing-zero trimming
    (src/poly.h:22-24), of one polynomial on the host."""
    a = np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c)
    n = len(a)
    while n > 1 and a[n - 1] == 0:
        n -= 1
    return n


def _scalar(s, device) -> torch.Tensor:
    return torch.as_tensor(s, dtype=I64, device=device)


def padd(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    L = max(a.shape[-1], b.shape[-1])
    return F.add(pad_to(a, L), pad_to(b, L))


def psub(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    L = max(a.shape[-1], b.shape[-1])
    return F.sub(pad_to(a, L), pad_to(b, L))


def pneg(F, a: torch.Tensor) -> torch.Tensor:
    return F.neg(a)


def pscale(F, a: torch.Tensor, s) -> torch.Tensor:
    """a times a scalar; a per-batch scalar has the shape a.shape[:-1]
    plus a trailing 1."""
    return F.mul(a, s)


def padd_const(F, a: torch.Tensor, s) -> torch.Tensor:
    """Add a scalar (or one per batch entry, shape (...)) to the constant
    term (src/poly.h:66-69)."""
    s = _scalar(s, a.device)
    out = a.expand(torch.broadcast_shapes(a.shape[:-1], s.shape)
                   + a.shape[-1:]).clone()
    out[..., 0] = F.add(out[..., 0], s)
    return out


def pshift(F, a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by x^k (src/poly.h:199-216)."""
    return TF.pad(a, (k, 0))


def pmul_school(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product, static output length la + lb - 1: row i is
    a_i * b shifted up by i, accumulated with modular adds."""
    la, lb = a.shape[-1], b.shape[-1]
    acc = None
    for i in range(la):
        row = TF.pad(F.mul(a[..., i:i + 1], b), (i, la - 1 - i))
        acc = row if acc is None else F.add(acc, row)
    return acc


def peval(F, c: torch.Tensor, x) -> torch.Tensor:
    """Horner evaluation (src/poly.h:265-272) at x of shape (...) (or a
    Python int), broadcast against c's batch dimensions."""
    x = _scalar(x, c.device)
    n = c.shape[-1]
    y = torch.zeros(torch.broadcast_shapes(c.shape[:-1], x.shape),
                    dtype=I64, device=c.device)
    for i in range(n):
        y = F.add(F.mul(y, x), c[..., n - 1 - i])
    return y


def peval_many(F, c: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Evaluate at each point of a vector xs: shape (len(xs),) +
    c.shape[:-1], as JAX's vmap over the points gives."""
    xs = _scalar(xs, c.device)
    return peval(F, c, xs.reshape(xs.shape + (1,) * (c.dim() - 1)))


def pz(F, points: torch.Tensor) -> torch.Tensor:
    """Vanishing polynomial prod_i (x - points[..., i]) (src/poly.h:274-286),
    static length n + 1."""
    n, batch, dev = points.shape[-1], points.shape[:-1], points.device
    acc = torch.cat([F.ones(batch + (1,), dev), F.zeros(batch + (n,), dev)],
                    dim=-1)
    for i in range(n):
        shifted = TF.pad(acc[..., :-1], (1, 0))
        acc = F.sub(shifted, F.mul(points[..., i:i + 1], acc))
    return acc


def plagrange(F, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Lagrange interpolation through (xs, ys) (src/poly.h:288-321),
    barycentrically: sum_j ys[j] / Z'(xs[j]) * Z(x) / (x - xs[j]). Static
    length n."""
    n = xs.shape[-1]
    z = pz(F, xs)                                    # (..., n + 1)
    diffs = F.sub(xs[..., :, None], xs[..., None, :])          # (..., n, n)
    eye = torch.eye(n, dtype=torch.bool, device=xs.device)
    diffs = torch.where(eye, F.ones((), xs.device), diffs)
    denom = diffs[..., 0]
    for i in range(1, n):
        denom = F.mul(denom, diffs[..., i])
    w = F.mul(ys, F.inv(denom))                      # (..., n)
    # q_j = Z / (x - x_j) by synthetic division for every j at once:
    # b_{n-1} = z_n; b_k = z_{k+1} + x_j * b_{k+1}
    qs = [None] * n
    prev = None
    for k in range(n - 1, -1, -1):
        zk = z[..., k + 1:k + 2]
        qs[k] = zk.expand(xs.shape) if prev is None else F.add(
            zk, F.mul(xs, prev))
        prev = qs[k]
    q = torch.stack(qs, dim=-1)                      # (..., j, k)
    terms = F.mul(w[..., :, None], q)
    acc = terms[..., 0, :]
    for j in range(1, n):
        acc = F.add(acc, terms[..., j, :])
    return acc


def pdivide(F, num: torch.Tensor, den: torch.Tensor):
    """Generic long division (src/poly.h:124-177); den's last coefficient
    must be nonzero. Returns (quot, rem) of static lengths
    (num_len - den_len + 1, max(den_len - 1, 1))."""
    num_len, den_len = num.shape[-1], den.shape[-1]
    if den_len > num_len:
        return F.zeros((1,), num.device), num
    lead_inv = F.inv(den[..., den_len - 1:den_len])
    qlen = num_len - den_len + 1
    rem = num.clone()
    coeffs = []
    for step in range(qlen):
        i = num_len - 1 - step
        lo = i - (den_len - 1)
        coeff = F.mul(rem[..., i:i + 1], lead_inv)
        coeffs.append(coeff)
        rem[..., lo:i + 1] = F.sub(rem[..., lo:i + 1], F.mul(coeff, den))
    quot = torch.cat(coeffs[::-1], dim=-1)
    return quot, rem[..., :max(den_len - 1, 1)]


def scan(op, x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of a commutative, associative `op` along the last
    axis in log2(n) doubling steps (the counterpart of
    jax.lax.associative_scan for field add and mul: field results do not
    depend on the order of combination)."""
    n = x.shape[-1]
    k = 1
    while k < n:
        x = torch.cat([x[..., :k], op(x[..., k:], x[..., :-k])], dim=-1)
        k *= 2
    return x


def _suffix_sums(F, u: torch.Tensor) -> torch.Tensor:
    """Inclusive modular suffix sums along the last axis."""
    return torch.flip(scan(F.add, torch.flip(u, dims=[-1])), dims=[-1])


def divide_by_vanishing(F, t: torch.Tensor, n: int):
    """Exact division by x^n - 1 as strided suffix sums:
    q[i] = sum_{j>=1} t[i + j*n]; rem[i] = t[i] + q[i] for i < n.
    Returns (q, rem) of static lengths (len(t) - n, n)."""
    L = t.shape[-1]
    if L <= n:
        raise ValueError("numerator shorter than divisor")
    m = -(-L // n)
    rows = pad_to(t, m * n).reshape(t.shape[:-1] + (m, n))
    s = _suffix_sums(F, rows.transpose(-1, -2)).transpose(-1, -2)
    s = s.reshape(t.shape[:-1] + (m * n,))
    return s[..., n:L], s[..., :n]


def pow_vector(F, x: torch.Tensor, L: int) -> torch.Tensor:
    """pows[..., i] = x^i for i in [0, L) from the binary decomposition of
    i; x of shape (...) gives shape (..., L)."""
    nbits = max((L - 1).bit_length(), 1)
    idx = torch.arange(L, device=x.device)
    acc = F.ones(x.shape + (L,), x.device)
    cur = x[..., None]
    for j in range(nbits):
        bit = ((idx >> j) & 1) == 1
        acc = torch.where(bit, F.mul(acc, cur), acc)
        if j + 1 < nbits:
            cur = F.mul(cur, cur)
    return acc


def divide_by_linear(F, t: torch.Tensor, c: torch.Tensor):
    """Division by (x - c) for nonzero c (of shape (...), one per batch
    entry), data-parallel: q[i] = (suffix sum of t_j c^j over j > i) *
    c^{-(i+1)}; the remainder is t(c). Returns (q, rem) with q of length
    len(t) - 1."""
    L = t.shape[-1]
    u = F.mul(t, pow_vector(F, c, L))
    suf = _suffix_sums(F, u)                       # suf[i] = sum_{j>=i}
    s_excl = F.sub(suf, u)                         # sum_{j>i}
    ic = F.inv(c)
    icpow = F.mul(pow_vector(F, ic, L), ic[..., None])   # ic^1 .. ic^L
    q = F.mul(s_excl, icpow)[..., :L - 1]
    rem = suf[..., 0]                              # t(c)
    return q, rem
