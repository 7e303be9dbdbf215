"""Closed-form trilinear two-surface intersection on an edge's corner cube.

Counterpart of ``tropical/core/trilinear.py``:

- ``corner_points`` expands each edge's box into its 8 cube corners with the
  z-major bit order idx = 4i + 2j + k -> (x_k, y_j, z_i);
- ``intersection_of_two_planes`` intersects two implicit trilinear surfaces
  (given by their 8 corner values p, q) with the diagonal plane x = z of the
  cube: substituting z = x makes each surface quadratic in x and linear in y,
  eliminating y gives a quartic in x (Bernstein -> monomial through T), and y
  is then a ratio of quadratics;
- cubes constant along an axis get the -1 no-intersection sentinel, as does
  every coordinate that comes out non-finite.

``intersection_of_two_planes_plain`` is the plain PyTorch version.  Every
product and sum in it is one rounded operation in a fixed order (``T.T @ A @
T`` is written out, not a matrix product), so the CUDA kernel
``csrc/trilinear_roots.cu`` reproduces it bit for bit.  The wrapper
``intersection_of_two_planes`` takes the plain version for CPU tensors and
the kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tropical_torch.core.roots import poly_roots_01
from tropical_torch.ops import cuda_build, launches

# lower/upper y-face corner ids under idx = 4i + 2j + k
_R = (0, 1, 4, 5)  # y = 0 face, ordered (x,z) = (0,0),(1,0),(0,1),(1,1)
_S = (2, 3, 6, 7)  # y = 1 face
# quadratic Bernstein -> monomial
_T = ((1.0, -2.0, 1.0), (-1.0, 1.0, 0.0), (1.0, 0.0, 0.0))
# corner pairs that are equal on a cube constant along y, z and x
_AXIS_PAIRS = (((0, 1, 4, 5), (2, 3, 6, 7)),
               ((0, 1, 2, 3), (4, 5, 6, 7)),
               ((0, 4, 2, 6), (1, 5, 3, 7)))


def corner_points(edges: torch.Tensor) -> torch.Tensor:
    """[B, 2, 3] edge endpoints -> [B, 8, 3] cube corners (z-major order)."""
    e = edges
    cs = []
    for i in range(2):
        for j in range(2):
            for k in range(2):
                cs.append(torch.stack([e[:, k, 0], e[:, j, 1], e[:, i, 2]],
                                      dim=-1))
    return torch.stack(cs, dim=1)


def trilinear_interpolation(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Interpolate corner values p [B,8] at local coords w [B,3]."""
    out = 0.0
    for i in range(2):
        for j in range(2):
            for k in range(2):
                weight = (w[:, 0] if k else 1 - w[:, 0]) \
                    * (w[:, 1] if j else 1 - w[:, 1]) \
                    * (w[:, 2] if i else 1 - w[:, 2])
                out = out + weight * p[:, 4 * i + 2 * j + k]
    return out


def _diag_quad(v: torch.Tensor, face) -> list:
    """Bernstein quadratic coefficients [v00, v10 + v01, v11] of the x = z
    restriction of one y face of corner values v [B, 8]."""
    a, b, c, d = face
    return [v[:, a], v[:, b] + v[:, c], v[:, d]]


def _quad_y(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Recover y from the x = z quartic root."""
    u = 1 - x
    X = (u * u, x * u, x * u, x * x)

    def dot(face):  # left to right
        s = q[:, face[0]] * X[0]
        for i in range(1, 4):
            s = s + q[:, face[i]] * X[i]
        return s

    AX = dot(_R)
    BX = dot(_S)
    return AX / (AX - BX)


def quartic_coeffs(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Quartic [B, 5] (descending powers) whose roots are the x = z plane
    intersections of the two trilinear surfaces with corner values p, q."""
    qr, ps = _diag_quad(q, _R), _diag_quad(p, _S)
    qs, pr = _diag_quad(q, _S), _diag_quad(p, _R)
    A = [[qr[i] * ps[j] - qs[i] * pr[j] for j in range(3)] for i in range(3)]

    def tsum(terms):  # left to right
        s = terms[0]
        for t in terms[1:]:
            s = s + t
        return s

    # M = T^T A, then B = M T
    M = [[tsum([_T[i][a] * A[i][j] for i in range(3)]) for j in range(3)]
         for a in range(3)]
    B = [[tsum([M[a][j] * _T[j][b] for j in range(3)]) for b in range(3)]
         for a in range(3)]
    return torch.stack([
        B[0][0],
        B[1][0] + B[0][1],
        B[2][0] + B[1][1] + B[0][2],
        B[1][2] + B[2][1],
        B[2][2],
    ], dim=-1)


def intersection_of_two_planes_plain(p: torch.Tensor, q: torch.Tensor
                                     ) -> torch.Tensor:
    """Intersection point [B, 3] (local cube coords in [0,1]^3) of two
    trilinear surfaces with the plane x = z; each coordinate without a valid
    value is -1, and every coordinate of a cube constant along an axis.

    Rows whose point is imprecise (near-singular y denominator, secondary
    quartic roots) are caught downstream by the on-surface check, the
    gradient-descent rescue and the strict filter."""
    x = poly_roots_01(quartic_coeffs(p, q))
    y = _quad_y(q, x)
    out = torch.stack([x, y, x], dim=-1)

    deg = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    for t, u in _AXIS_PAIRS:
        t, u = list(t), list(u)
        deg |= ((p[:, t] == p[:, u]) & (q[:, t] == q[:, u])).all(-1)

    invalid = deg[:, None] | ~torch.isfinite(out)
    return torch.where(invalid, -1.0, out)


def _check(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.ndim != 2 or t.shape[1] != 8:
        raise ValueError(f"{name} must have shape [B, 8], got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (rows are read as "
                         "two float4)")
    if t.shape[0] >= 2 ** 31:
        raise ValueError(f"{name} has too many rows for an int32 count")


@functools.lru_cache(maxsize=None)
def _launcher(lib: ctypes.CDLL):
    """(``lib``'s launch function, the threads it gives each row), its C
    signatures declared once per library."""
    fn, lanes = lib.trilinear_roots_launch, lib.trilinear_roots_lanes
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ctypes.c_int, ptr, ptr]
    fn.restype = ctypes.c_int
    lanes.argtypes = []
    lanes.restype = ctypes.c_int
    return fn, lanes()


def run_kernel(lib: ctypes.CDLL, p: torch.Tensor, q: torch.Tensor
               ) -> torch.Tensor:
    """One solve by the kernel in ``lib`` on checked inputs with at least
    one row; raises if the thread count overflows an int32 or the launch
    returns a CUDA error.  Counts nothing
    (``intersection_of_two_planes_cuda`` does)."""
    fn, lanes = _launcher(lib)
    n = p.shape[0]
    if n * lanes >= 2 ** 31:
        raise ValueError(f"{n} rows at {lanes} threads a row overflow the "
                         "kernel's int32 thread count")
    out = torch.empty((n, 3), dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = fn(p.data_ptr(), q.data_ptr(), n, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"trilinear_roots kernel launch failed: CUDA error {rc}")
    return out


def intersection_of_two_planes_cuda(p: torch.Tensor, q: torch.Tensor
                                    ) -> torch.Tensor:
    """``intersection_of_two_planes_plain`` by the CUDA kernel, on the
    current stream of ``p``'s device.  B = 0 launches nothing."""
    _check(p, "p")
    _check(q, "q")
    if p.device != q.device or p.shape != q.shape:
        raise ValueError(f"p {tuple(p.shape)} on {p.device} and q "
                         f"{tuple(q.shape)} on {q.device} do not match")
    n = p.shape[0]
    if n == 0:
        return torch.empty((0, 3), dtype=torch.float32, device=p.device)
    out = run_kernel(cuda_build.load("trilinear_roots"), p, q)
    launches.record("trilinear_roots", (n,))
    return out


def intersection_of_two_planes(p: torch.Tensor, q: torch.Tensor
                               ) -> torch.Tensor:
    """Intersection with the plane x = z (see
    ``intersection_of_two_planes_plain``) of the surfaces with corner values
    p, q [B, 8] f32.  The plain version runs only when both tensors lie on
    the CPU; anything else goes to the kernel, which raises on what it does
    not take."""
    if p.device.type == "cpu" and q.device.type == "cpu":
        return intersection_of_two_planes_plain(p, q)
    return intersection_of_two_planes_cuda(p, q)
