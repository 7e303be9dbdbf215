"""The hash-grid encode forward kernel's index arithmetic, on the CPU.

``csrc/hashgrid_encode.cu:level_rows_of`` computes a level's 8 corner rows
from corner 0 alone:

- dense: one remainder m = base mod E of the base index gx + gy r + gz r^2
  (in 32 bits where the base fits them, else in 64), then corner c's row is
  m + delta_c, less E where that reaches E, with delta_c = b_x + b_y r +
  b_z r^2 (b the corner's bits); where a corner's index would wrap past the
  int64 limit, each corner takes its own remainder of the wrapped index;
- hashed: the six products of the axes' two coordinates with their primes
  in uint32, then one XOR pair a corner.

``one_remainder_rows`` and ``factored_hash_rows`` below write that
arithmetic in numpy, step for step, and are held against the port's
``_level_indices`` (torch, int64) and the JAX package's (under
``jax.enable_x64``, so that its index arithmetic is int64 too), corner by
corner, on coordinates that are negative, at and past the resolution, and
far enough out that the base leaves int32, for the presets and for grids
drawn by hypothesis.  Then the CUDA source itself: built with g++ against
``tests/cuda_emulation.h`` (one thread a lane, a barrier in each shuffle),
its forward at 1, 2, 4 and 8 lanes a (point, level) is held bitwise to
``encode_plain``.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import encode_cases
from tropical.core import hashgrid as jhg
from tropical_torch.core import hashgrid as thg
from tropical_torch.stanford.model import net_for_size

ROOT = Path(__file__).resolve().parents[1]
INT32 = (-2 ** 31, 2 ** 31 - 1)
INT64_MAX = 2 ** 63 - 1
P1, P2 = 2654435761, 805459861


def _bits(c):
    return c & 1, (c >> 1) & 1, (c >> 2) & 1


def one_remainder_rows(spec, l, g):
    """Rows within dense level ``l`` of the 8 corners of the cells whose
    corner 0 is ``g`` [N, 3] (int64): [N, 8], as the kernel computes them."""
    r, e = spec.level_resolution(l), spec.level_entries(l)
    g = g.astype(np.uint64)  # wrapping arithmetic, as the kernel's
    base = (g[:, 0] + g[:, 1] * np.uint64(r)
            + g[:, 2] * np.uint64(r * r)).astype(np.int64)
    delta = np.array([bx + by * r + bz * r * r
                      for bx, by, bz in map(_bits, range(8))], np.int64)
    assert delta.max() < e  # the identity's premise on a dense level
    rows = np.empty((g.shape[0], 8), np.int64)
    safe = base <= INT64_MAX - (r * r + r + 1)
    narrow = safe & (base >= INT32[0]) & (base <= INT32[1])
    # C's truncating %, then the non-negative result
    m32 = np.fmod(base[narrow].astype(np.int32), np.int32(e)).astype(np.int64)
    m64 = np.fmod(base[safe & ~narrow], e)
    for sel, m in ((narrow, m32), (safe & ~narrow, m64)):
        m = np.where(m < 0, m + e, m)
        v = m[:, None] + delta[None, :]
        rows[sel] = np.where(v >= e, v - e, v)
    wrapped = (base[~safe].astype(np.uint64)[:, None]
               + delta.astype(np.uint64)[None, :]).astype(np.int64)
    q = np.fmod(wrapped, e)
    rows[~safe] = np.where(q < 0, q + e, q)
    return rows


def factored_hash_rows(spec, g):
    """Rows within a hashed level of the 8 corners of the cells whose
    corner 0 is ``g`` [N, 3] (int64): [N, 8], as the kernel computes them."""
    u = g.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    hx = u[:, 0].astype(np.uint32)
    hy = (u[:, 1] * np.uint64(P1)).astype(np.uint32)
    hz = (u[:, 2] * np.uint64(P2)).astype(np.uint32)
    pairs = [(hx, hx + np.uint32(1)), (hy, hy + np.uint32(P1)),
             (hz, hz + np.uint32(P2))]
    mask = np.uint32((1 << spec.log2_table) - 1)
    return np.stack([(pairs[0][bx] ^ pairs[1][by] ^ pairs[2][bz]) & mask
                     for bx, by, bz in map(_bits, range(8))],
                    1).astype(np.int64)


def reference_rows(spec, l, g):
    """The port's and the JAX package's ``_level_indices`` of each corner:
    two [N, 8] int64 arrays."""
    port, ref = [], []
    for bx, by, bz in map(_bits, range(8)):
        cg = g + np.array([bx, by, bz], np.int64)
        port.append(thg._level_indices(
            spec, l, [torch.from_numpy(cg[:, d]) for d in range(3)]).numpy())
        with jax.enable_x64(True):
            ref.append(np.asarray(jhg._level_indices(
                _jax_spec(spec), l, jnp.asarray(cg))).astype(np.int64))
    return np.stack(port, 1), np.stack(ref, 1)


def _jax_spec(spec):
    return jhg.HashGridSpec(scale=spec.scale, dim=spec.dim, levels=spec.levels,
                            features=spec.features, log2_table=spec.log2_table,
                            n_min=spec.n_min, n_max=spec.n_max, eps=spec.eps)


def corner_zeros(spec, l, rng, n):
    """Corner-0 coordinates of level ``l`` [n, 3]: in and around the grid,
    at and past the resolution, negative, and far out (bases past int32)."""
    r = spec.level_resolution(l)
    near = rng.integers(-3 * r, 3 * r + 1, (n, 3))
    edges = rng.choice(np.array([-1, 0, r - 2, r - 1, r, r + 1]), (n, 3))
    far = rng.integers(2 ** 31 // (r * r) + 1, 2 ** 40, (n, 3))
    far *= rng.choice(np.array([-1, 1]), (n, 3))
    return np.concatenate([near, edges, far]).astype(np.int64)


def _check_level(spec, l, g):
    port, ref = reference_rows(spec, l, g)
    ours = (factored_hash_rows(spec, g) if spec.level_uses_hash(l)
            else one_remainder_rows(spec, l, g))
    np.testing.assert_array_equal(ours, port)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("size", ["small", "medium", "large"])
def test_corner_rows_match_level_indices(size):
    """Every corner of every level of a preset (sphere-large's finest level
    hashes): the kernel's arithmetic gives the port's and JAX's rows."""
    spec = net_for_size(size, device="cpu").spec.grid
    rng = np.random.default_rng(len(size))
    for l in range(spec.levels):
        g = corner_zeros(spec, l, rng, 2000)
        base = (g[:, 0] + g[:, 1] * spec.level_resolution(l)
                + g[:, 2] * spec.level_resolution(l) ** 2)
        # the draw reaches both remainders' ranges
        assert (np.abs(base) <= INT32[1]).any() and (np.abs(base) > 2 ** 31).any()
        _check_level(spec, l, g)
    assert [spec.level_uses_hash(l) for l in range(spec.levels)] == (
        [False, False, False, size == "large"])


@settings(max_examples=25, deadline=None)
@given(levels=st.integers(1, 8), n_min=st.integers(1, 16),
       span=st.integers(0, 64), log2_table=st.integers(6, 19),
       seed=st.integers(0, 2 ** 16))
def test_corner_rows_match_level_indices_on_drawn_grids(levels, n_min, span,
                                                        log2_table, seed):
    """Grids drawn by hypothesis, dense and hashed levels alike."""
    spec = thg.HashGridSpec(levels=levels, n_min=n_min, n_max=n_min + span,
                            log2_table=log2_table)
    rng = np.random.default_rng(seed)
    for l in range(spec.levels):
        _check_level(spec, l, corner_zeros(spec, l, rng, 200))


def test_wrapping_corners_take_their_own_remainders():
    """``encode_cases.wrap_points``: bases 2^63 - 1 - j, where the indices of
    corners more than j above corner 0 wrap; the arithmetic's third path
    gives the port's and JAX's rows, and the shortcut would not."""
    spec = thg.HashGridSpec(**encode_cases.WRAP_SPEC)
    x = torch.from_numpy(encode_cases.wrap_points())
    pos_grid, _ = thg._level_grid(spec, x, 0)
    g = pos_grid.numpy()
    r, e = spec.level_resolution(0), spec.level_entries(0)
    base = g[:, 0] + g[:, 1] * r + g[:, 2] * r * r
    np.testing.assert_array_equal(base, INT64_MAX - np.arange(len(g)))
    _check_level(spec, 0, g)
    # the shortcut (m + delta_c, less E) disagrees where a corner wraps
    delta = np.array([bx + by * r + bz * r * r
                      for bx, by, bz in map(_bits, range(8))])
    v = np.fmod(base, e)[:, None] + delta[None, :]
    shortcut = np.where(v >= e, v - e, v)
    assert (shortcut != one_remainder_rows(spec, 0, g)).any()


@pytest.mark.parametrize("size", ["small", "medium", "large"])
def test_preset_levels_are_dense_where_the_kernel_assumes(size):
    """The identity needs delta_c < E on every dense level: r^3 <= 2^T makes
    E >= r^3 > r^2 + r + 1 (r >= 2), and E >= 8 > 3 at r = 1."""
    spec = net_for_size(size, device="cpu").spec.grid
    for l in range(spec.levels):
        r, e = spec.level_resolution(l), spec.level_entries(l)
        assert spec.level_uses_hash(l) or r * r + r + 1 < e
        assert spec.level_uses_hash(l) == (r ** 3 > 2 ** spec.log2_table)


# --- the CUDA source, emulated on the CPU ----------------------------------

def _emulated_build(tmp_path, lanes):
    """Build csrc/hashgrid_encode.cu with g++ against the emulation header,
    the forward's lanes fixed; returns the library."""
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("needs g++ to emulate the CUDA source")
    src = (ROOT / "tropical_torch" / "csrc" / "hashgrid_encode.cu").read_text()
    src = emulated_source(src)
    cpp = tmp_path / f"hashgrid_encode_{lanes}.cpp"
    cpp.write_text(src)
    so = tmp_path / f"libhashgrid_encode_{lanes}.so"
    subprocess.run([compiler, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-fPIC", "-shared", "-pthread", f"-I{ROOT / 'tests'}",
                    "-include", "cuda_emulation.h",
                    f"-DHASHGRID_ENCODE_FWD_LANES={lanes}", "-o", str(so),
                    str(cpp)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def emulated_source(src: str) -> str:
    """The .cu source with the package's files it includes (``#include
    "name.cuh"`` or ``"name.cu"``, from ``csrc/``) written in place of the
    first include of each, each launch ``k<<<grid, block, ...>>>(args)``
    made a call of the emulation's launcher, the CUDA headers left to the
    emulation, and the dynamic shared buffer a namespace-scope array."""
    seen = set()

    def inline(m):
        if m.group(1) in seen:
            return ""
        seen.add(m.group(1))
        text = (ROOT / "tropical_torch" / "csrc" / m.group(1)).read_text()
        return re.sub(r'#include "(\w+\.cuh?)"', inline,
                      text.replace("#pragma once", ""))

    src = re.sub(r'#include "(\w+\.cuh?)"', inline, src)
    src = re.sub(r"#include <cuda_runtime.h>|#include <cuda/atomic>", "", src)
    src = src.replace("extern __shared__", "extern")
    src = re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\(\s*", r"EmuLaunch(\2).run(\1, ",
                 src, flags=re.S)
    return src + "\nnamespace { float2 smem[1]; }\n"


def _emulated_forward(lib, spec, table, x):
    """The forward launch of an emulated build on CPU tensors, through the
    plan that ``core/hashgrid._Launcher`` fills."""
    rows = thg._level_rows(spec)
    rows_t = torch.from_numpy(rows)
    plan = thg._Plan(rows_t.data_ptr(), spec.levels, thg._group(spec),
                     spec.n_entries, (1 << spec.log2_table) - 1,
                     thg.private_rows(spec), 0, 0, 0)
    plan.level_rows[:rows.size] = rows.ravel().tolist()
    lib.hashgrid_encode_configure.argtypes = [ctypes.c_void_p]
    assert lib.hashgrid_encode_configure(ctypes.addressof(plan)) == 0
    fwd = lib.hashgrid_encode_fwd_launch
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    fwd.restype = ctypes.c_int
    feat = torch.full((x.shape[0], spec.levels * 2), float("nan"))
    assert fwd(ctypes.addressof(plan), x.data_ptr(), table.data_ptr(),
               x.shape[0], feat.data_ptr(), None) == 0
    return feat


def _emulation_cases():
    rng = np.random.default_rng(5)
    for size, n in (("small", 97), ("medium", 40), ("large", 40)):
        spec = net_for_size(size, device="cpu").spec.grid
        x = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
        x[: n // 4] = np.round(x[: n // 4] * 4) / 4
        yield spec, x
        yield spec, encode_cases.far_points(rng, 24)
    for levels in (1, 5):
        yield (thg.HashGridSpec(levels=levels, n_min=2, n_max=32,
                                log2_table=12),
               rng.uniform(-0.1, 1.1, (33, 3)).astype(np.float32))
    yield thg.HashGridSpec(**encode_cases.WRAP_SPEC), encode_cases.wrap_points()


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_emulated_forward_source_is_bitwise_plain(tmp_path, lanes):
    """The forward kernel's source, run on the CPU by the emulation at a
    fixed lane count: bitwise ``encode_plain`` on the presets (a hashed
    level in large), far points, 1 and 5 levels and the int64-wrap grid."""
    lib = _emulated_build(tmp_path, lanes)
    rng = np.random.default_rng(lanes)
    for spec, x in _emulation_cases():
        table = torch.from_numpy(
            rng.normal(size=(spec.n_entries, 2)).astype(np.float32))
        xt = torch.from_numpy(x)
        got = _emulated_forward(lib, spec, table, xt)
        want = thg.encode_plain(spec, table, xt)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
