"""Four-step NTT with the row transforms as modular matrix products.

Port of `plonk_tpu/ops/mxu_ntt.py` and `plonk_tpu/ops/pallas_mxu_ntt.py`.
A size-C row transform is a matrix product Y = X @ W with the DFT matrix
W[j, k] = w^{jk}. In Montgomery form throughout:

    inputs   x~ = x * R mod p                       (R = 2^32)
    matrix   W~[j, k] = w^{jk} * 2^64 mod p, as 7-bit limb planes (L, C, C)
    product  V = X~ @ W~ (exact), Y~ = V * 2^-64 mod p = (X @ W) * R mod p
             (then, optionally, a Montgomery twiddle product)

Four steps (n = n1*n2, i = i1*n2 + i2, k = k1 + n1*k2): transpose, the
products by W1 (size n1, root w^{n2}) with the twiddle w^{i2 k1}
fused, transpose, the products by W2 (size n2, root w^{n1}). The output
position k1*n2 + k2 holds X[k1 + n1 k2] (`mxu_perm`); `mxu_intt` takes
that layout back to natural coefficients, scaled by 1/n.

`_mont_mat_transform` is the modular product in plain PyTorch, and
`mxu_ntt` / `mxu_intt` the transforms built on it. `mont_matmul` is the
same product as K7 (CUDA kernel `csrc/mont_matmul.cu`, on the int8 tensor
cores) on a CUDA tensor, and `mxu2_ntt` / `mxu2_intt` (the JAX package's
`mxu_ntt_pallas` / `mxu_intt_pallas`) the transforms built on it. K7
reads the limb planes K-major (`kmajor_limbs`: 8-bit wgmma takes its B
operand K-major only); the transforms cache that copy per matrix, as they
cache the planes for the plain version.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils import kernels
from .fused_ntt import _split, _twiddle_std

_LB = 7                      # limb bits (values < 128 fit s8)
_K7_LIMBS = 4                # csrc/mont_matmul.cu NL
_K7_TILE = 32                # csrc/mont_matmul.cu BN and BKC
_K7_MAX_C = 4096


def _n_limbs(p: int) -> int:
    return -(-p.bit_length() // _LB)


@functools.lru_cache(maxsize=None)
def mxu_perm(n: int) -> np.ndarray:
    """perm[j] = natural index of the element mxu_ntt leaves at flat
    position j = k1*n2 + k2 (the transposed layout)."""
    n1, n2 = _split(n)
    k1, k2 = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    return (k1 + n1 * k2).reshape(-1)


@functools.lru_cache(maxsize=None)
def _dft_limbs(p: int, w: int, C: int) -> np.ndarray:
    """(L, C, C) int8 limb planes of W~[j, k] = w^{jk} * 2^64 mod p."""
    t = np.array([pow(w, k, p) for k in range(C)], dtype=np.int64)
    mat = np.empty((C, C), dtype=np.int64)
    acc = np.full(C, pow(2, 64, p), dtype=np.int64)   # row j: w^{jk} 2^64
    for j in range(C):
        mat[j] = acc
        acc = acc * t % p            # < 2^62: no int64 overflow
    return np.stack([(mat >> (_LB * a)) & ((1 << _LB) - 1)
                     for a in range(_n_limbs(p))]).astype(np.int8)


@functools.lru_cache(maxsize=64)
def _limbs_on(p: int, w: int, C: int, device) -> torch.Tensor:
    return torch.as_tensor(_dft_limbs(p, w, C), device=device)


def _pad_tile(n: int) -> int:
    return -(-n // _K7_TILE) * _K7_TILE


class KMajorLimbs(NamedTuple):
    """W~'s limb planes (L, C, K) as K7 reads them: `planes` (L, Kp, Cp)
    int8 with planes[l, k, c] = W~_l[c, k], zero-padded to Kp, Cp multiples
    of 32 (K7's column tile and contraction chunk); C and K unpadded."""
    planes: torch.Tensor
    C: int
    K: int


def kmajor_limbs(w_limbs: torch.Tensor) -> KMajorLimbs:
    """(L, C, K) limb planes -> the K-major copy K7 reads (8-bit wgmma
    takes its B operand K-major only)."""
    L, C, K = w_limbs.shape
    out = torch.zeros((L, _pad_tile(K), _pad_tile(C)), dtype=w_limbs.dtype,
                      device=w_limbs.device)
    out[:, :K, :C] = w_limbs.transpose(1, 2)
    return KMajorLimbs(out, C, K)


@functools.lru_cache(maxsize=64)
def _kmajor_on(p: int, w: int, C: int, device) -> KMajorLimbs:
    return kmajor_limbs(_limbs_on(p, w, C, device))


@functools.lru_cache(maxsize=64)
def _tw_on(F, w: int, n1: int, n2: int, inverse: bool,
           device) -> torch.Tensor:
    """Montgomery (n2, n1) twiddle w^{+-i2*k1}, natural k1 order."""
    return F.array(_twiddle_std(F.p, w, n1, n2, inverse), device)


def _mont_mat_transform(F, x_mont: torch.Tensor, limb_mats: torch.Tensor,
                        tw_mont: torch.Tensor | None = None) -> torch.Tensor:
    """Rows of x_mont (R, C) Montgomery words -> Montgomery (X @ W) (R, K),
    W~ given as limb planes (L, C, K), then times tw_mont (T, K) row
    r mod T if given; K7's plain version.

    The L^2 limb products run as float64 matrix products: an entry of
    X_a @ W_b sums C products of 7-bit limbs, at most C * 127^2 < 2^24 for
    C <= 1024, so float64 (53-bit mantissa) holds every partial sum exactly
    in any summation order. The buckets B_k = sum_{a+b=k} X_a @ W_b give
    V = sum_k B_k 2^{7k}, and V * 2^-64 mod p = sum_k B_k c_k mod p with
    c_k = 2^{7k-64} mod p, each term below 2^62."""
    p = F.p
    L, C, K = limb_mats.shape
    mask = (1 << _LB) - 1
    xs = torch.stack([(x_mont >> (_LB * a)) & mask for a in range(L)])
    wcat = limb_mats.permute(1, 0, 2).reshape(C, L * K)     # [c, b*K + k]
    S = torch.matmul(xs.to(torch.float64), wcat.to(torch.float64))
    S = S.to(torch.int64).reshape(L, -1, L, K)              # S[a, r, b, k]
    r = torch.zeros_like(S[0, :, 0])
    for k in range(2 * L - 1):
        bucket = sum(S[a, :, k - a] for a in range(max(0, k - L + 1),
                                                    min(k, L - 1) + 1))
        r = (r + bucket * pow(2, _LB * k - 64, p) % p) % p
    if tw_mont is not None:
        r = F.mul(r, tw_mont.repeat(r.shape[0] // tw_mont.shape[0], 1))
    return r


def mont_matmul(F, x: torch.Tensor, w, tw: torch.Tensor | None = None
                ) -> torch.Tensor:
    """(R, C) Montgomery words @ W~ -> Montgomery (R, K), with an optional
    (T, K) Montgomery twiddle for row r mod T. `w` is W~ in the form the
    path of x's device reads: on a CPU tensor the limb planes (L, C, K),
    and the plain version runs; on a CUDA tensor their `kmajor_limbs` copy,
    and K7 runs on it. Any other pairing raises."""
    if x.device.type == "cpu":
        if not isinstance(w, torch.Tensor):
            raise TypeError("mont_matmul: a CPU tensor takes the (L, C, K) "
                            "limb planes")
        return _mont_mat_transform(F, x, w, tw)
    if not isinstance(w, KMajorLimbs):
        raise TypeError("mont_matmul: a CUDA tensor takes the kmajor_limbs "
                        "copy of the limb planes")
    planes, C, K = w
    args = (x, planes) + (() if tw is None else (tw,))
    if x.device.type != "cuda" or any(t.device != x.device for t in args):
        raise ValueError("mont_matmul: x, the limb planes and tw must be on "
                         "one CUDA device")
    if any(not t.is_contiguous() for t in args) or x.dtype != torch.int64 \
            or planes.dtype != torch.int8 \
            or (tw is not None and tw.dtype != torch.int64):
        raise TypeError("mont_matmul: contiguous int64 words and int8 limb "
                        "planes expected")
    R = x.shape[0]
    L = planes.shape[0]
    if x.dim() != 2 or x.shape[1] != C or L != _n_limbs(F.p) \
            or tuple(planes.shape) != (L, _pad_tile(K), _pad_tile(C)):
        raise ValueError(f"mont_matmul: x {tuple(x.shape)} and K-major "
                         f"planes {tuple(planes.shape)} of (C, K) = "
                         f"({C}, {K}) do not match")
    # K7's s32 buckets reach L * C * 127^2, below 2^31 for L = 4, C <= 4096
    if L != _K7_LIMBS or not 1 <= C <= _K7_MAX_C:
        raise ValueError(f"mont_matmul: K7 takes {_K7_LIMBS} limb planes "
                         f"and 1 <= C <= {_K7_MAX_C} (its s32 buckets stay "
                         f"below 2^31); got L = {L}, C = {C}")
    T = 0 if tw is None else tw.shape[0]
    if tw is not None and (tw.dim() != 2 or tw.shape[1] != K or R % T):
        raise ValueError(f"mont_matmul: tw {tuple(tw.shape)} must be (T, "
                         f"{K}) with T dividing R = {R}")
    out = torch.empty((R, K), dtype=torch.int64, device=x.device)
    if R == 0 or K == 0:
        return out
    Kp, Cp = planes.shape[1:]
    err = kernels.library().mont_matmul_launch(
        x.data_ptr(), planes.data_ptr(),
        None if tw is None else tw.data_ptr(), out.data_ptr(), R, C, K, Kp,
        Cp, T, F.p, F.n_prime,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check_launch(err, "mont_matmul")
    return out


def _plain_product(F, a: torch.Tensor, w: int, C: int,
                   tw: torch.Tensor | None = None) -> torch.Tensor:
    """a @ the DFT matrix of root w (size C) in plain PyTorch."""
    return _mont_mat_transform(F, a, _limbs_on(F.p, w, C, a.device), tw)


def _kernel_product(F, a: torch.Tensor, w: int, C: int,
                    tw: torch.Tensor | None = None) -> torch.Tensor:
    """a @ the DFT matrix of root w (size C) through mont_matmul, with the
    planes its device's path reads, cached per (p, w, C, device)."""
    dev = a.device
    planes = (_limbs_on if dev.type == "cpu" else _kmajor_on)(F.p, w, C, dev)
    return mont_matmul(F, a, planes, tw)


def _forward(F, x: torch.Tensor, w: int, inverse: bool,
             matmul) -> torch.Tensor:
    n = x.shape[-1]
    p = F.p
    batch = tuple(x.shape[:-1])
    nb = int(np.prod(batch)) if batch else 1
    n1, n2 = _split(n)
    wq = pow(w, -1, p) if inverse else w
    dev = x.device
    a = x.reshape(nb, n1, n2).transpose(1, 2).reshape(nb * n2, n1)
    a = matmul(F, a.contiguous(), pow(wq, n2, p), n1,
               _tw_on(F, w, n1, n2, inverse, dev)).reshape(nb, n2, n1)
    a = a.transpose(1, 2).reshape(nb * n1, n2)         # (nb, k1, i2)
    a = matmul(F, a.contiguous(), pow(wq, n1, p), n2)
    return a.reshape(batch + (n,))


def _inverse(F, y: torch.Tensor, w: int, matmul) -> torch.Tensor:
    n = y.shape[-1]
    p = F.p
    batch = tuple(y.shape[:-1])
    nb = int(np.prod(batch)) if batch else 1
    n1, n2 = _split(n)
    w_inv = pow(w, -1, p)
    dev = y.device
    a = matmul(F, y.reshape(nb * n1, n2).contiguous(), pow(w_inv, n1, p),
               n2).reshape(nb, n1, n2)
    a = a.transpose(1, 2)                              # (nb, i2, k1)
    # the inverse twiddle multiplies the intermediate, as its own pass
    a = F.mul(a, _tw_on(F, w, n1, n2, True, dev))
    a = matmul(F, a.reshape(nb * n2, n1).contiguous(), pow(w_inv, n2, p),
               n1).reshape(nb, n2, n1)
    a = a.transpose(1, 2).reshape(batch + (n,))        # natural (i1, i2)
    return F.mul(a, F.const(pow(n, -1, p)))


def mxu_ntt(F, x: torch.Tensor, w: int, inverse: bool = False
            ) -> torch.Tensor:
    """Forward transform, Montgomery in and out, batched over leading dims,
    in the mxu_perm layout; inverse=True uses the inverse root (unscaled).
    Plain PyTorch products (_mont_mat_transform) on any device."""
    return _forward(F, x, w, inverse, _plain_product)


def mxu_intt(F, y: torch.Tensor, w: int) -> torch.Tensor:
    """Inverse of mxu_ntt: mxu_perm-layout input, natural-order
    coefficients out, scaled by 1/n. Plain PyTorch products."""
    return _inverse(F, y, w, _plain_product)


def mxu2_ntt(F, x: torch.Tensor, w: int, inverse: bool = False
             ) -> torch.Tensor:
    """mxu_ntt with each modular product through mont_matmul (K7 on a CUDA
    tensor, two launches per call); the same words as mxu_ntt."""
    return _forward(F, x, w, inverse, _kernel_product)


def mxu2_intt(F, y: torch.Tensor, w: int) -> torch.Tensor:
    """mxu_intt with each modular product through mont_matmul (K7 on a
    CUDA tensor, two launches per call); the same words as mxu_intt."""
    return _inverse(F, y, w, _kernel_product)
