"""K6 (the device engine's final filter and faces) on planted inputs, and
its stage calls recorded and replayed, shared by the CPU tests and
``chip_smoke.py``.  Imports neither jax nor the JAX package."""

import numpy as np
import torch

# the stage functions of tropical_torch/extract/device.py, in call order:
# the design's, and the first design's (-DFACES_FIRST)
K6_STAGES = ("final_keep", "face_keys_count", "face_keys_fill",
             "face_regions_runs", "face_regions_dups", "face_fans_count",
             "face_fans_fill")
K6_FIRST_STAGES = ("final_keep", "face_keys_count_first",
                   "face_keys_fill_first", "face_regions_runs",
                   "face_regions_dups", "face_fans_count_first",
                   "face_fans_fill_first")


def record(dv, fn):
    """``fn()`` with the K6 stage functions of ``dv`` (both designs')
    wrapped: its result and [(name, arguments (tensors cloned), keywords)]
    of every call."""
    calls = []
    orig = {n: getattr(dv, n) for n in {*K6_STAGES, *K6_FIRST_STAGES}}

    def wrap(name, f):
        def stage(*args, **kw):
            calls.append((name, [a.clone() if torch.is_tensor(a) else a
                                 for a in args], kw))
            return f(*args, **kw)
        return stage

    for n, f in orig.items():
        setattr(dv, n, wrap(n, f))
    try:
        out = fn()
    finally:
        for n, f in orig.items():
            setattr(dv, n, f)
    return out, calls


def outputs(dv, name, args, kw, kern):
    """A stage call by ``kern`` on clones of its arguments: its tensor
    results, then its tensor arguments after it (the count vector)."""
    a = [x.clone() if torch.is_tensor(x) else x for x in args]
    res = getattr(dv, name)(*a, **{**kw, "kern": kern})
    res = res if isinstance(res, tuple) else (res,)
    return [t for t in (*res, *a) if torch.is_tensor(t)]


def held(dv, calls, kern):
    """Each recorded call by ``kern`` and by the plain version: every
    output bitwise (floats by their bits).  Returns the calls held."""
    for name, args, kw in calls:
        want = outputs(dv, name, args, kw, dv.PLAIN)
        got = outputs(dv, name, args, kw, kern)
        assert len(want) == len(got), name
        for x, y in zip(want, got):
            assert x.shape == y.shape and x.dtype == y.dtype, name
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x.cpu(), y.cpu()), f"{name}: kernel != plain"
    return len(calls)


def final_keep_case(device, scale=1.2, eps=1e-4, seed=0):
    """(V, OUT, E): vertices on the cube's faces (unit coordinate 0 and 1
    exactly) and just outside, last columns at +-eps exactly and inside,
    a NaN output; edges with both ends kept, one, none; a vertex of no
    edge."""
    rng = np.random.default_rng(seed)
    n = 300
    V = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    V[:20, 0] = -scale                       # unit 0: kept
    V[20:40, 1] = scale                      # unit 1: kept
    V[40:50, 2] = scale + 1e-3               # outside
    V[50:55, 0] = -scale - 1e-3
    OUT = rng.normal(size=(n, 33)).astype(np.float32)
    OUT[:, -1] = rng.uniform(-2 * eps, 2 * eps, n).astype(np.float32)
    OUT[60:70, -1] = np.float32(eps)
    OUT[70:80, -1] = -np.float32(eps)
    OUT[80, -1] = np.nan
    E = rng.integers(0, n - 1, (700, 2)).astype(np.int32)  # n - 1: no edge
    t = lambda a: torch.from_numpy(a).to(device)
    return t(V), t(OUT), t(E)


def face_keys_case(dv, marks, device, scale=1.2, eps=1e-4, seed=1):
    """(V, SB, ZB, ends): vertices at cell offsets -1 (below the first
    mark), 0 on the first mark and M - 1 (on the last mark, and past it),
    on interior marks (on-grid-plane axes), elsewhere at random; words
    with up to 6 zero columns among the hidden neurons (and a zero final
    column, which the key leaves out); a third of the vertices unused."""
    rng = np.random.default_rng(seed)
    mk = marks.cpu().numpy().astype(np.float64)
    n = 240
    xu = rng.uniform(0, 1, (n, 3))
    on = rng.random((n, 3)) < 0.3
    xu[on] = rng.choice(mk, on.sum())
    xu[:10, 0] = -0.01                      # offset -1
    xu[10:20, 1] = mk[0]                    # offset 0, on the plane
    xu[20:30, 2] = mk[-1]                   # offset M - 1, on the plane
    xu[30:40, 0] = 1.01                     # offset M - 1, past it
    V = torch.from_numpy((xu * (scale * 2) - scale).astype(np.float32))
    kz = rng.integers(0, 7, n)
    z = np.zeros((n, 33), bool)
    for i in range(n):
        z[i, rng.choice(32, kz[i], replace=False)] = True
    z[::7, 32] = True
    s = rng.random((n, 33)) < 0.5
    bits = lambda b: torch.from_numpy(b.astype(np.int64))
    SB = dv._pack_bits(bits(s) > 0)
    ZB = dv._pack_bits(bits(z) > 0)
    ends = torch.zeros((2, n), dtype=torch.int32)
    ends[0, : 2 * n // 3 + 20] = 1
    ends[1, : 2 * n // 3] = 1
    perm = torch.from_numpy(rng.permutation(n))
    return (V[perm].to(device), SB[perm].to(device), ZB[perm].to(device),
            ends[:, perm].contiguous().to(device))


# planted regions: (members, in (kz, id) order); A, B, A' share a signature
# (first member 0, three members), A' repeats A two regions later; a
# repeated id; 1, 2 and 100 members; two ids on one point and two on one
# ray from the mean (exact score ties)
REGIONS = ([0, 1, 2], [0, 1, 3], [0, 1, 2], [4, 5, 5, 6], [7], [8, 9],
           list(range(10, 110)), [110, 111, 112, 113, 114, 115],
           [116, 117, 118, 116, 119])


def regions_case(device, seed=2):
    """(skey, perm, rvid, Vf): ``REGIONS`` as key-sorted replicas (keys
    ascending by region, ``perm`` a seeded permutation of their order and
    ``rvid`` the ids in that order) and the points they index."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (120, 3)).astype(np.float32)
    ang = np.linspace(0, 2 * np.pi, 100, endpoint=False)
    pts[10:110] = np.stack([0.5 * np.cos(ang), 0.5 * np.sin(ang),
                            np.zeros(100)], 1).astype(np.float32)
    pts[110:116] = [[1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0],
                    [0.25, 0, 0], [1, 0, 0]]    # 115 on 110; 114 on its ray
    pts[116:120] = [[0, 0, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0.5],
                    [0, 0.5, 0.5]]
    keys, ids = [], []
    for r, members in enumerate(REGIONS):
        keys += [1000 * (r + 1)] * len(members)
        ids += members
    n = len(ids)
    perm = rng.permutation(n)
    rvid = np.empty(n, np.int32)
    rvid[perm] = ids
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(np.asarray(keys, np.int64)), t(perm.astype(np.int64)), t(rvid),
            t(pts))


def classes_case(dv, device, n=4500, top=None, seed=4):
    """(V, SB, ZB, ends) of ``n`` vertices, five tiles of face_keys_count
    at the default ``n``, with every zero count from 0 to ``top`` (35 by
    default) among the used ones (a vertex on 0 to 3 grid planes with 0 to
    32 zero neurons) and a fifth unused."""
    rng = np.random.default_rng(seed)
    marks = np.linspace(0, 1, 21)
    xu = rng.uniform(0, 1, (n, 3))
    kz = np.arange(n) % ((dv.KZ_MAX if top is None else top) + 1)
    gz = np.minimum(kz, np.maximum(kz - 32, rng.integers(0, 4, n)))
    for i in range(n):
        on = rng.choice(3, gz[i], replace=False)
        xu[i, on] = rng.choice(marks, gz[i])
    z = np.zeros((n, 33), bool)
    for i in range(n):
        z[i, rng.choice(32, kz[i] - gz[i], replace=False)] = True
    s = rng.random((n, 33)) < 0.5
    bits = lambda b: torch.from_numpy(b.astype(np.int64)) > 0
    ends = torch.zeros((2, n), dtype=torch.int32)
    ends[0] = 1
    ends[1] = torch.from_numpy(rng.random(n) < 0.8)
    V = torch.from_numpy((xu * 2.4 - 1.2).astype(np.float32))
    t = lambda a: a.contiguous().to(device)
    return t(V), t(dv._pack_bits(bits(s))), t(dv._pack_bits(bits(z))), t(ends)


def fans_case(device, n=5000, kept=0.5, seed=5):
    """(rord, rcnt, svid, mean, keep, Vf): ``face_fans_count``'s inputs over
    ``n`` replica slots, five tiles: regions of 1 to 12 members (one past
    ``face_fans_fill``'s shared-memory path, of 8) laid end to end in the
    sorted replicas, ids repeated inside some, the slots a seeded
    permutation of the replica positions (so that the regions fall in
    every tile), a share ``kept`` of the regions of 3 members or more
    kept; the points the ids index."""
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < n:
        sizes.append(min(n - sum(sizes), int(rng.choice(
            [1, 2, 3, 3, 4, 4, 4, 5, 6, 8, 9, 12]))))
    starts = np.cumsum([0] + sizes[:-1])
    nv = n // 3
    svid = rng.integers(0, nv, n).astype(np.int32)
    for s, c in zip(starts, sizes):
        if c >= 4 and rng.random() < 0.2:
            svid[s + c - 1] = svid[s]          # a repeated id
    rcnt = np.zeros(n, np.int32)
    rcnt[starts] = sizes
    rord = rng.permutation(n).astype(np.int64)
    keep = ((rcnt[rord] >= 3) & (rng.random(n) < kept)).astype(np.int32)
    mean = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    Vf = rng.uniform(-1, 1, (nv, 3)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(rord), t(rcnt), t(svid), t(mean), t(keep), t(Vf)


def planted_calls(dv, device, first=False, eps=1e-4, scale=1.2):
    """The planted calls of every K6 stage of the design (``first``: of the
    first design), each stage's inputs from the plain versions' outputs of
    the stage before: [(name, args, kw)].  The chain of ``K6_STAGES`` (or
    ``K6_FIRST_STAGES``) first, in order; then face_keys_count on
    ``classes_case`` (five tiles, every zero count), face_keys_count and
    face_keys_fill on three tiles of zero counts up to 4, face_fans_count and
    face_fans_fill on ``fans_case`` (five tiles, regions past the shared
    path), with one region kept and with none (no fill: the engine reads
    no kept region and stops)."""
    P = dv.PLAIN
    calls = []
    sfx = "_first" if first else ""

    def call(name, *args):
        calls.append((name, [a.clone() if torch.is_tensor(a) else a
                             for a in args], {}))
        return getattr(dv, name)(*args, kern=P)

    def keys_chain(V, SB, ZB, ends, marks, fill=True):
        lut, lut_k = dv._lut(marks), dv._lut_k(marks.cpu().numpy())
        fc = torch.zeros(dv.FC, dtype=torch.int64, device=device)
        out = call("face_keys_count" + sfx, V, SB, ZB, ends, marks, lut,
                   lut_k, eps, scale, fc)
        n_used, n_rep = int(fc[dv.FC_USED]), int(fc[dv.FC_REP])
        if not fill:
            return
        if first:
            kz, rows = out
            vcum = torch.cumsum(ends[1], 0, dtype=torch.int32)
            kzs, order = torch.sort(kz, stable=True)
            call("face_keys_fill_first", V, rows, kzs, order, vcum, fc,
                 n_used, n_rep)
        else:
            call("face_keys_fill", V, *out, fc, n_used, n_rep)

    def fans_chain(rord, rcnt, svid, mean, keep, Vf, nrm=None):
        fc = torch.zeros(dv.FC, dtype=torch.int64, device=device)
        n = keep.shape[0]
        if first:
            kcum = torch.cumsum(keep, 0, dtype=torch.int64)
            ntri, _ = call("face_fans_count_first", rord, rcnt, svid, mean,
                           keep, kcum, fc)
        else:
            kl, mk = call("face_fans_count", rord, rcnt, svid, mean, keep,
                          fc, torch.full((n, 4), -7, dtype=torch.int32,
                                         device=device),
                          torch.full((n, 3), 7.0, device=device))
        n_kept, n_tri = int(fc[dv.FC_KEPT]), int(fc[dv.FC_TRI])
        if n_kept == 0:
            return
        if nrm is None:
            g = torch.Generator().manual_seed(3)
            nrm = torch.nn.functional.normalize(
                torch.randn(n_kept, 3, generator=g), dim=1).to(device)
        if first:
            call("face_fans_fill_first", rord, rcnt, svid, mean, keep, kcum,
                 ntri, torch.cumsum(ntri, 0), nrm, Vf, n_tri)
        else:
            call("face_fans_fill", kl, svid, mk, nrm, Vf, n_kept, n_tri)

    fc = torch.zeros(dv.FC, dtype=torch.int64, device=device)
    V, OUT, E = final_keep_case(device, scale, eps)
    call("final_keep", V, OUT, E, eps, scale, fc)
    marks = torch.from_numpy(np.linspace(0, 1, 21).astype(np.float32)).to(
        device)
    keys_chain(*face_keys_case(dv, marks, device, scale, eps), marks)
    skey, perm, rvid, Vf = regions_case(device)
    sig, rcnt, mean, svid = call("face_regions_runs", skey, perm, rvid, Vf)
    ssig, rord = torch.sort(sig, stable=True)
    keep = call("face_regions_dups", ssig, rord, rcnt, svid)
    g = torch.Generator().manual_seed(3)
    nrm = torch.nn.functional.normalize(
        torch.randn(int(keep.sum()), 3, generator=g), dim=1)
    nrm[0] = torch.tensor([0.0, 0.0, 1.0])
    fans_chain(rord, rcnt, svid, mean, keep, Vf, nrm.to(device))
    keys_chain(*classes_case(dv, device), marks, fill=False)
    keys_chain(*classes_case(dv, device, 3000, 4, seed=6), marks)
    case = fans_case(device)
    fans_chain(*case)
    rord, rcnt, svid, mean, keep, Vf = case
    one = torch.zeros_like(keep)
    one[int(torch.nonzero(keep)[-1, 0])] = 1
    fans_chain(rord, rcnt, svid, mean, one, Vf)
    fans_chain(rord, rcnt, svid, mean, torch.zeros_like(keep), Vf)
    return calls


def _fans(r, v, score, n_regions):
    """Each region's members in descending score (stable: ties in member
    order), the repeated ids dropped: (region [m'], id [m']), and the fan
    triangles (v_t+2, v_t+1, v0) [T, 3] int64."""
    o = torch.sort(-score, stable=True).indices
    o = o[torch.sort(r[o], stable=True).indices]
    r, v = r[o], v[o].long()
    key = r * (int(v.max()) + 1) + v
    seen = torch.sort(key, stable=True)
    dup = torch.zeros_like(key, dtype=torch.bool)
    dup[seen.indices[1:]] = seen.values[1:] == seen.values[:-1]
    r, v = r[~dup], v[~dup]
    d = torch.bincount(r, minlength=n_regions)
    nt = (d - 2).clamp(min=0)
    t = torch.repeat_interleave(torch.arange(n_regions, device=r.device), nt)
    b = (torch.cumsum(d, 0) - d)[t]
    rank = torch.arange(t.numel(), device=r.device) - (torch.cumsum(nt, 0)
                                                       - nt)[t]
    return r, v, torch.stack([v[b + rank + 2], v[b + rank + 1], v[b]], 1)


def _rows(tris):
    """Triangles as a sorted array of rows (winding kept)."""
    a = tris.cpu().numpy()
    return a[np.lexsort(a.T[::-1])]


# K6's means are in fixed point of this step (world units)
STEP = 2.0 ** -22
PFIX = 2.0 ** 22


def fan_inputs(dv, call):
    """The kept regions of a recorded fill call (``face_fans_fill`` or the
    first design's ``face_fans_fill_first``): (each member's region [m],
    its position in the sorted replicas [m], the regions' counts, their
    means and normals, svid, Vf)."""
    name, a = call[0], call[1]
    if name == "face_fans_fill":
        kl, svid, mk, nrm, Vf, n_kept, _ = a
        return (*dv.kept_members(kl, n_kept), mk[:n_kept], nrm, svid, Vf)
    rord, rcnt, svid, mean, keep, _, _, _, nrm, Vf, _ = a
    j = torch.nonzero(keep)[:, 0]
    return (*dv._region_members(rord, rcnt, keep), mean[rord[j]], nrm, svid,
            Vf)


def fan_ties(dv, net, fill, tris, th, steps=2.0):
    """Why K6's fans and the host faces' differ on one complex.  ``fill``:
    the recorded fill call (name, arguments, keywords); ``tris``: K6's
    triangles; ``th``: the host faces' triangles on the same loop output.
    Each kept region's members are scored twice: as K6 scores them
    (``dv._fan_scores``: float32 around the fixed-point mean, the normal at
    that mean) and as the host faces do (``faces.sort_polygon_rows``:
    float64 around the float32 sum of the members over their count, the
    normal at that mean rounded to float32).  Both sort by the angle around
    the normal from the first member, cut where the score wraps: on the
    plane through the mean spanned by the first member's offset and the
    normal.  A member on that plane may go to either end of the order,
    which starts the fan at another vertex of the same polygon.  Returns
    {"fans": kept regions, "differ": fans whose orders of distinct ids
    differ, "rotations": of these, those whose two orders are one cycle,
    "near": of these, those whose members that crossed the cut lie within
    ``steps`` fixed-point steps of it (by the host's scores), "cut_steps":
    the largest such distance, "mean_steps": the largest difference of the
    two means, a coordinate, in steps, "host_rows": whether the host
    scores' fans are the host faces' triangles, "k6_rows": whether K6's
    scores' fans are K6's triangles}."""
    r, pos, c, m32, nrm, svid, Vf = fan_inputs(dv, fill)
    n = c.numel()
    v = svid[pos].long()
    first = (torch.cumsum(c, 0) - c)[r]
    P = Vf[v]
    s32 = dv._fan_scores(P, m32[r], nrm[r], first)
    # the host: the members zero-padded into rows, summed in float32
    rank = torch.arange(r.numel(), device=r.device) - first
    rows = torch.zeros((n, int(c.max()), 3), dtype=P.dtype, device=P.device)
    rows[r, rank] = P
    m64 = rows.sum(1).double() / c.to(torch.float64)[:, None]
    hn = net.normal(m64.to(P.dtype)).double()
    u = P.double() - m64[r]
    d = torch.linalg.cross(u[first], u, dim=-1)
    norm = torch.linalg.vector_norm(u, dim=-1)
    cos = (u[first] * u).sum(-1) / (norm[first] * norm).clamp(min=1e-8)
    dn = (d * hn[r]).sum(-1)
    s64 = cos * ((dn >= 0) * 2.0 - 1.0) + (dn < 0) * 2.0
    r32, v32, t32 = _fans(r, v, s32, n)
    r64, v64, t64 = _fans(r, v, s64, n)
    # each member's distance from its region's cut plane
    cut = dn.abs() / torch.linalg.vector_norm(
        torch.linalg.cross(u[first], hn[r], dim=-1), dim=-1)
    bad = torch.zeros(n, dtype=torch.bool, device=r.device)
    bad[r32[v32 != v64]] = True
    g = torch.nonzero(bad)[:, 0]
    out = {"fans": n, "differ": int(g.numel()), "rotations": 0, "near": 0,
           "cut_steps": 0.0,
           "mean_steps": float((m32[g].double() - m64[g]).abs().max())
           / STEP if g.numel() else 0.0,
           "host_rows": bool(np.array_equal(_rows(t64), _rows(th))),
           "k6_rows": torch.equal(t32, tris)}
    r32, v32, r64, v64, r, v, cut = (x.cpu().numpy() for x in (
        r32, v32, r64, v64, r, v, cut))
    for k in g.tolist():
        a, b = list(v32[r32 == k]), list(v64[r64 == k])
        at = b.index(a[0])
        if b[at:] + b[:at] != a:
            continue
        out["rotations"] += 1
        # the members that went from one end of the order to the other
        moved = set(b[:at] if at <= len(b) - at else b[at:])
        mine = r == k
        far = float(cut[mine][np.isin(v[mine], list(moved))].max()) / STEP
        out["cut_steps"] = max(out["cut_steps"], far)
        out["near"] += far <= steps
    return out


def _row_keys(tris, n):
    """Each triangle's vertices sorted, as one int64 key (n: the vertex
    count)."""
    t = np.sort(np.asarray(tris, np.int64), 1)
    return (t[:, 0] * n + t[:, 1]) * n + t[:, 2]


def _fan_rows(v, score):
    """A region's fan rows (v_0, v_t+1, v_t+2) from its members' ids and
    scores: descending, stable, the repeated ids dropped."""
    ids = []
    for i in v[torch.sort(-score, stable=True).indices].tolist():
        if i not in ids:
            ids.append(i)
    return [(ids[0], ids[t + 1], ids[t + 2]) for t in range(len(ids) - 2)]


# a score this close to the wrap (3 or -1: a member opposite the first
# one) is at the cut: four float32 ulps of 3
WRAP_TOL = 2.0 ** -20


def _explain(dv, net, v, c, bad, ref_vertices, known, nv):
    """Why the regions ``bad`` differ from the other engine's fans: K6's
    score run on that engine's vertices (each region's members' points
    there, their fixed-point mean in K6's arithmetic, the net's normal at
    it) gives its fan ("inputs"), or does once the members at the cut (a
    score within ``WRAP_TOL`` of the wrap, 3 or -1) go to the other end of
    the order ("wrap").  Returns ({reason: count}, [each fan explained by
    neither: its ids and scores])."""
    P = torch.as_tensor(np.asarray(ref_vertices), device=v.device)
    starts = (torch.cumsum(c, 0) - c).tolist()
    members = [v[starts[k]:starts[k] + int(c[k])] for k in bad.tolist()]
    means = torch.stack([
        torch.round(P[m] * PFIX).to(torch.int64).sum(0).to(torch.float32)
        / (m.numel() * PFIX) for m in members])
    why, other = {"inputs": 0, "wrap": 0}, []

    def gives(m, score):
        return bool(np.isin(_row_keys(_fan_rows(m, score), nv), known).all())

    for m, mean, nrm in zip(members, means, net.normal(means)):
        first = torch.zeros(m.numel(), dtype=torch.int64, device=v.device)
        score = dv._fan_scores(P[m], mean[None], nrm[None], first)
        top, low = score >= 3.0 - WRAP_TOL, score <= -1.0 + WRAP_TOL
        if gives(m, score):
            why["inputs"] += 1
        elif ((top.any() and gives(m, torch.where(top, score - 4.0, score)))
              or (low.any() and gives(m, torch.where(low, score + 4.0,
                                                     score)))):
            why["wrap"] += 1
        else:
            other.append({"ids": m.tolist(), "scores": score.tolist()})
    return why, other


def golden_ties(dv, net, fill, tris, ref, ref_vertices, steps=2.0):
    """K6's fans against another engine's triangles on its own vertices
    (``ref`` and ``ref_vertices``, index for index K6's; rows in any order,
    each row's vertices in any order: the JAX package's device faces of
    ``scripts/device_faces_golden.py``).  ``fill``: the recorded fill call;
    ``tris``: K6's triangles.  A fan differs where one of its rows is not
    among ``ref``'s; it is a rotation where the same polygon started at
    another of its vertices has every row among them; it is explained
    where K6's score, run on the other engine's vertices (the fixed-point
    mean of the region's members there, the net's normal at that mean),
    gives the other engine's fan, or does once its members at the cut go
    to the other end (``_explain``): the two differ by their inputs, not
    by the score.  ``near``: the rotations whose members that went from one
    end of the order to the other lie within ``steps`` fixed-point steps of
    K6's cut (the plane through K6's mean spanned by the first member's
    offset and K6's normal, float64), a diagnostic: the other engine's
    vertices lie up to 10 steps from K6's; "cut_steps" the largest such
    distance.  Returns {"fans", "differ", "rotations", "explained",
    "explained_by", "unexplained", "near", "cut_steps", "k6_rows"}."""
    r, pos, c, m32, nrm, svid, Vf = fan_inputs(dv, fill)
    n = c.numel()
    v = svid[pos].long()
    first = (torch.cumsum(c, 0) - c)[r]
    s32 = dv._fan_scores(Vf[v], m32[r], nrm[r], first)
    r32, v32, t32 = _fans(r, v, s32, n)
    u = Vf[v].double() - m32[r].double()
    hn = nrm[r].double()
    cut = ((torch.linalg.cross(u[first], u, dim=-1) * hn).sum(-1).abs()
           / torch.linalg.vector_norm(torch.linalg.cross(u[first], hn, dim=-1),
                                      dim=-1))
    nv = Vf.shape[0]
    known = np.unique(_row_keys(np.asarray(ref), nv))
    t = t32.cpu().numpy()
    missing = ~np.isin(_row_keys(t, nv), known)
    # each triangle's region: the fans' triangles are in region order
    d = torch.bincount(r32, minlength=n).cpu().numpy()
    tri_region = np.repeat(np.arange(n), np.maximum(d - 2, 0))
    bad = np.unique(tri_region[missing])
    out = {"fans": n, "differ": int(bad.size), "rotations": 0,
           "explained": 0, "explained_by": {}, "unexplained": [], "near": 0,
           "cut_steps": 0.0, "k6_rows": torch.equal(t32, tris)}
    if bad.size:
        out["explained_by"], out["unexplained"] = _explain(
            dv, net, v, c, bad, ref_vertices, known, nv)
        out["explained"] = sum(out["explained_by"].values())
    r32, v32, r, v, cut = (x.cpu().numpy() for x in (r32, v32, r, v, cut))
    start = np.concatenate([[0], np.cumsum(d)])
    for k in bad.tolist():
        a = list(v32[start[k]:start[k + 1]])
        m = len(a)
        for at in range(1, m):
            b = a[at:] + a[:at]
            rows = [(b[0], b[i + 1], b[i + 2]) for i in range(m - 2)]
            if np.isin(_row_keys(rows, nv), known).all():
                break
        else:
            continue
        out["rotations"] += 1
        moved = set(a[:at] if at <= m - at else a[at:])
        mine = r == k
        far = float(cut[mine][np.isin(v[mine], list(moved))].max()) / STEP
        out["cut_steps"] = max(out["cut_steps"], far)
        out["near"] += far <= steps
    return out
