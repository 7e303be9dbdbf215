"""Last real root in [0, 1] of batched polynomials, plain PyTorch.

Counterpart of ``tropical/core/roots.py``.  The extraction only needs the
*last* real root inside [0, 1] (else the -1 sentinel), so each row's
polynomial is sampled at t_i = i/64, the last sign-change cell is polished
by 40 bisections, and a derivative-extrema probe finds what the samples
miss: the sign-change cells of p' locate up to three interior extrema m;
where p(m) flips sign against the cell's right end, the later root of the
hidden pair is bisected in [m, cell end], and where |p(m)| is below
1e-7 * sum|c| the root is the tangent point m itself.

This is the yardstick of the CUDA kernel ``csrc/trilinear_roots.cu``, which
follows it bit for bit: every product and sum is its own rounded operation
(no fused multiply-add, no library reduction), and each sum runs left to
right as written here.
"""

from __future__ import annotations

import torch

N_SAMPLES = 65
N_BISECT = 40
N_EXTREMA = 3   # a quartic has at most 3 interior extrema
TANGENT_RTOL = 1e-7  # |p(m)| below this (relative to sum|coeffs|) is a touch


def _poly_eval(coeffs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Horner evaluation, one rounded product and one rounded sum a step.
    coeffs [B, K] in descending powers, t [B, N] or [N]."""
    acc = torch.zeros_like(t) + coeffs[:, :1]
    for i in range(1, coeffs.shape[-1]):
        acc = acc * t + coeffs[:, i:i + 1]
    return acc


def _deriv(coeffs: torch.Tensor) -> torch.Tensor:
    """Descending-power coefficients of p'."""
    k = coeffs.shape[-1]
    return torch.stack([coeffs[:, i] * float(k - 1 - i) for i in range(k - 1)],
                       dim=-1)


def _abs_sum(coeffs: torch.Tensor, k: int) -> torch.Tensor:
    """|c_0| + |c_1| + ... + |c_{k-1}|, left to right."""
    a = coeffs[:, :k].abs()
    s = a[:, 0]
    for i in range(1, k):
        s = s + a[:, i]
    return s


def _bisect(coeffs, lo, hi, flo, n: int = N_BISECT):
    """Bisection root of each row's polynomial in [lo, hi]; flo = p(lo)."""
    for _ in range(n):
        mid = 0.5 * (lo + hi)
        fmid = _poly_eval(coeffs, mid[:, None])[:, 0]
        go_left = flo * fmid <= 0
        lo = torch.where(go_left, lo, mid)
        flo = torch.where(go_left, flo, fmid)
        hi = torch.where(go_left, mid, hi)
    return 0.5 * (lo + hi)


def _last_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of each row's last True (N - 2 - 0 = the last cell when none)."""
    n = mask.shape[1]
    return (n - 1) - torch.argmax(mask.flip(1).to(torch.uint8), dim=1)


def _brackets(vals: torch.Tensor, nonconst: torch.Tensor) -> torch.Tensor:
    """Cells whose end samples have a product <= 0, except flat zero-zero
    cells, on rows that are not constant."""
    prod = vals[:, :-1] * vals[:, 1:]
    flat = (vals[:, :-1] == 0) & (vals[:, 1:] == 0)
    return (prod <= 0) & ~flat & nonconst[:, None]


def poly_roots_01(coeffs: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Last real root in [0, 1] of each row's polynomial, else -1.

    Coefficients [B, K] f32 are in descending powers; entries with
    |c| < eps are zeroed first, and rows that are constant after that yield
    -1."""
    coeffs = torch.where(coeffs.abs() < eps, 0.0, coeffs)
    k = coeffs.shape[1]
    ts = torch.arange(N_SAMPLES, dtype=coeffs.dtype,
                      device=coeffs.device) / (N_SAMPLES - 1)  # exact: i/64
    vals = _poly_eval(coeffs, ts)                               # [B, N]

    nonconst = _abs_sum(coeffs, k - 1) > eps
    brackets = _brackets(vals, nonconst)
    has = brackets.any(-1)
    idx = _last_true(brackets)
    flo = vals.gather(1, idx[:, None])[:, 0]
    root = torch.where(has, _bisect(coeffs, ts[idx], ts[idx + 1], flo), -1.0)

    # --- derivative-extrema probe for roots the sample grid can't see -------
    dco = _deriv(coeffs)
    dvals = _poly_eval(dco, ts)
    dbrackets = _brackets(dvals, nonconst)
    tau = TANGENT_RTOL * _abs_sum(coeffs, k)
    cells = torch.arange(N_SAMPLES - 1, device=coeffs.device)
    for _ in range(N_EXTREMA):
        dhas = dbrackets.any(-1)
        didx = _last_true(dbrackets)
        dbrackets = dbrackets & (cells[None, :] != didx[:, None])

        dhi = ts[didx + 1]
        dflo = dvals.gather(1, didx[:, None])[:, 0]
        m = _bisect(dco, ts[didx], dhi, dflo)         # extremum location
        pm = _poly_eval(coeffs, m[:, None])[:, 0]
        pr = vals.gather(1, didx[:, None] + 1)[:, 0]

        cross = dhas & (pm * pr < 0)                  # hidden pair in the cell
        pair_root = _bisect(coeffs, m, dhi, pm)
        tangent = dhas & ~cross & (pm.abs() <= tau)
        cand = torch.where(cross, pair_root, torch.where(tangent, m, -1.0))
        root = torch.maximum(root, cand)              # last-root contract
    return root
