"""Bundle-adjustment solves through ``ba_solve``, one after another.

Traffic parameters (``portbench/traffic/<mix>.json``): ``warmup_iters``
(the LM iterations of the one solve before the window, which builds K4 and
K5 and runs every shape of a solve), ``trace_solves`` (the solves of the
window that a traced run profiles, from the second on).

Configuration (``portbench/configs/<config>.json``): ``n_cams`` cameras on
a ring of radius ``path_radius`` facing outwards (position and rotation
jittered by ``jitter_pos`` and ``jitter_rot``), ``n_points`` points and
exactly ``n_obs`` observations. A point is seen by ``L`` consecutive
cameras, ``L`` in [2, ``max_track``] drawn from P(L) ~ (L - 1)^-beta with
beta fitted to the mean track n_obs / n_points, then moved by ones to the
exact total; it lies at a depth in ``depth`` in front of the middle camera
of its track, within ``view_half`` of its optical axis (normalised
coordinates). Observations are its projections (normalised coordinates,
focal ``focal_px``) with N(0, ``noise_px`` / focal) noise. The initial
estimate perturbs every free camera's translation and rotation and every
point (``perturb_t``, ``perturb_rot``, ``perturb_points``); the first
``fixed_cams`` cameras are fixed at their true poses. The solver runs with
``max_iters``, ``pcg_iters``, ``rtol`` and the Huber threshold
``huber_px`` / focal.
"""

from __future__ import annotations

import math
import time

import torch

from portbench.reference import ba as reference

SPANS = ("ba_solve", "fresh_copy", "readback", "pcg_solve", "segsum", "gather")


def _rotations(n, phi, jitter, gen, device):
    """World-to-camera rotations of cameras at ring angles ``phi`` facing
    outwards (x along the ring, y up, z outwards), each turned by a random
    rotation of scale ``jitter``."""
    s, c = torch.sin(phi), torch.cos(phi)
    z = torch.zeros_like(phi)
    base = torch.stack([torch.stack([-s, c, z], -1),
                        torch.stack([z, z, torch.ones_like(z)], -1),
                        torch.stack([c, s, z], -1)], -2)
    w = jitter * torch.randn((n, 3), generator=gen, device=device, dtype=phi.dtype)
    dR, _ = reference.se3_exp(torch.cat([torch.zeros_like(w), w], -1), torch.einsum)
    return dR @ base


def _track_pmf(mean, max_track):
    """P(L) ~ (L - 1)^-beta on [2, max_track], beta bisected so that the
    mean is ``mean``."""
    L = torch.arange(2, max_track + 1, dtype=torch.float64)

    def pmf(beta):
        p = (L - 1) ** -beta
        return p / p.sum()

    lo, hi = 0.0, 20.0
    for _ in range(100):
        mid = (lo + hi) / 2
        if float((pmf(mid) * L).sum()) > mean:
            lo = mid
        else:
            hi = mid
    return pmf((lo + hi) / 2)


def _track_lengths(cfg, gen, device):
    P, O, Lmax = cfg["n_points"], cfg["n_obs"], cfg["max_track"]
    if not 2 * P <= O <= Lmax * P:
        raise ValueError("n_obs must lie in [2, max_track] times n_points")
    pmf = _track_pmf(O / P, Lmax).float().to(device)
    L = 2 + torch.multinomial(pmf, P, replacement=True, generator=gen)
    while True:
        diff = O - int(L.sum())
        if diff == 0:
            return L
        room = L < Lmax if diff > 0 else L > 2
        score = torch.rand(P, generator=gen, device=device).masked_fill_(~room, 2.0)
        n = min(abs(diff), int(room.sum()))
        pick = torch.topk(score, n, largest=False).indices
        L[pick] += 1 if diff > 0 else -1


def make_problem(cfg, seed, device):
    """(truth, initial, observations) of one problem from ``seed``:
    truth and initial are (R, t, X); observations (cam, pt, uv), int32,
    int32, float32, sorted by point."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2**63 - 1))
    C, P = cfg["n_cams"], cfg["n_points"]
    f32 = dict(device=device, dtype=torch.float32)

    def rand(*shape):
        return torch.rand(shape, generator=gen, **f32)

    def randn(*shape):
        return torch.randn(shape, generator=gen, **f32)

    phi = 2 * math.pi * torch.arange(C, **f32) / C
    R = _rotations(C, phi, cfg["jitter_rot"], gen, device)
    radius = cfg["path_radius"] + cfg["jitter_pos"] * randn(C)
    centre = torch.stack([radius * torch.cos(phi), radius * torch.sin(phi),
                          cfg["jitter_pos"] * randn(C)], -1)
    t = -torch.einsum("cij,cj->ci", R, centre)

    L = _track_lengths(cfg, gen, device)
    first = torch.randint(C, (P,), generator=gen, device=device)
    mid = (first + (L - 1) // 2) % C
    d_lo, d_hi = cfg["depth"]
    depth = d_lo + (d_hi - d_lo) * rand(P)
    h = cfg["view_half"]
    p_cam = torch.stack([depth * h * (2 * rand(P) - 1), depth * h * (2 * rand(P) - 1),
                         depth], -1)
    X = torch.einsum("pji,pj->pi", R[mid], p_cam - t[mid])

    pt = torch.repeat_interleave(torch.arange(P, device=device), L)
    start = torch.cumsum(L, 0) - L
    cam = (first[pt] + torch.arange(pt.shape[0], device=device) - start[pt]) % C
    p = torch.einsum("oij,oj->oi", R[cam], X[pt]) + t[cam]
    z_min = float(p[:, 2].min())
    if z_min < 0.5:
        raise RuntimeError(f"an observed point lies {z_min} in front of its camera")
    sigma = cfg["noise_px"] / cfg["focal_px"]
    uv = p[:, :2] / p[:, 2:] + sigma * randn(p.shape[0], 2)

    free = torch.ones(C, dtype=torch.bool, device=device)
    free[:cfg["fixed_cams"]] = False
    dw = cfg["perturb_rot"] * randn(C, 3) * free[:, None]
    dR, _ = reference.se3_exp(torch.cat([torch.zeros_like(dw), dw], -1), torch.einsum)
    R0 = dR @ R
    t0 = t + cfg["perturb_t"] * randn(C, 3) * free[:, None]
    X0 = X + cfg["perturb_points"] * randn(P, 3)
    return (R, t, X), (R0, t0, X0), (cam.int(), pt.int(), uv)


class Driver:
    """One cell of bundle adjustment: set-up, window, check."""

    def __init__(self, cfg, traffic, seed, device, fm):
        from fastmatch_tpu_torch.ba import lm, schur
        from fastmatch_tpu_torch.ba.problem import BAProblem, Observations
        from fastmatch_tpu_torch.core.lie import SE3

        self.cfg, self.traffic, self.device, self.fm = cfg, traffic, device, fm
        self.lm, self.schur = lm, schur
        _, self.init, self.obs = make_problem(cfg, seed, device)
        C, P = cfg["n_cams"], cfg["n_points"]
        R0, t0, X0 = self.init
        cam, pt, uv = self.obs
        fixed = torch.zeros(C, dtype=torch.bool, device=device)
        fixed[:cfg["fixed_cams"]] = True
        self.fixed = fixed
        self.problem = BAProblem(
            poses=SE3(R0, t0), points=X0,
            obs=Observations(cam, pt, uv, torch.ones(cam.shape[0], dtype=torch.bool,
                                                     device=device)),
            cam_mask=torch.ones(C, dtype=torch.bool, device=device),
            pt_mask=torch.ones(P, dtype=torch.bool, device=device), fixed_cams=fixed)
        self.huber = cfg["huber_px"] / cfg["focal_px"]
        self.distinct_points = int((torch.bincount(pt.long(), minlength=P) > 0).sum())
        self.results = []
        self.first = {}     # the first window solve's first LM iteration
        self._ref = None

    def _fresh(self):
        p = self.problem
        return p._replace(poses=type(p.poses)(p.poses.R.clone(), p.poses.t.clone()),
                          points=p.points.clone(),
                          obs=type(p.obs)(*(f.clone() for f in p.obs)))

    def _solve(self, tracer, keep, max_iters=None, first=None):
        """One solve through the window's call; with ``first`` (a dict), the
        port's first LM iteration is kept in it (``_keep_first_step``)."""
        with tracer.span("fresh_copy"):
            problem = self._fresh()
        undo = self._keep_first_step(first) if first is not None else None
        t0 = time.perf_counter()
        try:
            with tracer.span("ba_solve"):
                res = self.fm.ba_solve(problem, device=self.device,
                                       max_iters=max_iters or self.cfg["max_iters"],
                                       pcg_iters=self.cfg["pcg_iters"], lam0=self.cfg["lam0"],
                                       huber_delta_static=self.huber, rtol=self.cfg["rtol"])
            with tracer.span("readback"):
                out = (res.poses.R.cpu(), res.poses.t.cpu(), res.points.cpu(),
                       float(res.cost0), float(res.cost))
            t1 = time.perf_counter()
        finally:
            if undo is not None:
                undo()
        if keep:
            self.results.append(out)
        self.last_iters = res.iters
        return t1 - t0, res.iters

    def _keep_first_step(self, first):
        """Keeps in ``first`` what the port's first call into its Schur PCG
        (``ba.lm.pcg_solve``) was given and gave back: the assembled blocks
        Hcc, Hpp, gc, gp at the start state and the camera step dx_c.
        Copies on the device, with no wait; returns the undo."""
        lm = self.lm
        pcg = lm.pcg_solve

        def pcg_kept(system, *args, **kw):
            dx_c = pcg(system, *args, **kw)
            if not first:
                first.update(Hcc=system.Hcc.clone(), Hpp=system.Hpp.clone(),
                             gc=system.gc.clone(), gp=system.gp.clone(), dx_c=dx_c.clone())
            return dx_c

        lm.pcg_solve = pcg_kept

        def undo():
            lm.pcg_solve = pcg
        return undo

    def _spans_into_program(self, tracer):
        """Spans around the calls into the Schur PCG and into K4 and K5,
        installed for the traced solves only; returns the undo. They hang on
        the names ``ba.lm.pcg_solve``, ``ba.schur.sorted_segment_sum`` and
        ``ba.schur.sorted_gather_rows``: ``_called`` fails the run when a
        traced solve made no call through one of them."""
        lm, schur = self.lm, self.schur
        saved = (lm.pcg_solve, schur.sorted_segment_sum, schur.sorted_gather_rows)
        pcg, segsum, gather = saved
        distinct = self.distinct_points

        def pcg_spanned(*args, **kw):
            with tracer.span("pcg_solve"):
                tracer.record("pcg_solve", kw["iters"])
                return pcg(*args, **kw)

        def segsum_spanned(vals, seg, n, *args, **kw):
            with tracer.span("segsum"):
                tracer.record("segsum", (vals.shape[0], vals.shape[1], n))
                return segsum(vals, seg, n, *args, **kw)

        def gather_spanned(table, seg, *args, **kw):
            with tracer.span("gather"):
                tracer.record("gather", (seg.shape[0], table.shape[1], distinct))
                return gather(table, seg, *args, **kw)

        lm.pcg_solve = pcg_spanned
        schur.sorted_segment_sum = segsum_spanned
        schur.sorted_gather_rows = gather_spanned

        def undo():
            lm.pcg_solve, schur.sorted_segment_sum, schur.sorted_gather_rows = saved
        return undo

    @staticmethod
    def _called(tracer):
        """Raises unless the traced solves called through every name that
        the per-layer spans hang on."""
        missing = [name for name, calls in (("ba.lm.pcg_solve", "pcg_solve"),
                                            ("ba.schur.sorted_segment_sum", "segsum"),
                                            ("ba.schur.sorted_gather_rows", "gather"))
                   if not tracer.calls.get(calls)]
        if missing:
            raise RuntimeError("the traced solves made no call through "
                               f"{', '.join(missing)}: the spans of the Schur PCG, K4 "
                               "and K5 read nothing")

    def warm_up(self, tracer):
        self._solve(tracer, False, max_iters=int(self.traffic["warmup_iters"]))

    def window(self, seconds, tracer):
        durations, iters, traced = [], [], []
        n_traced = int(self.traffic["trace_solves"]) if tracer.enabled else 0
        t0 = time.perf_counter()
        while True:
            k = len(durations)
            undo = None
            if 1 <= k <= n_traced:
                if k == 1:
                    tracer.start()
                undo = self._spans_into_program(tracer)
            try:
                dt, it = self._solve(tracer, True, first=self.first if k == 0 else None)
            finally:
                if undo is not None:
                    undo()
            if tracer.on and k == n_traced:
                tracer.stop()
                self._called(tracer)
            durations.append(dt)
            iters.append(it)
            traced.append(undo is not None)
            t1 = time.perf_counter()
            if t1 - t0 >= seconds and k >= n_traced:
                break
        return dict(seconds=t1 - t0, solves=len(durations), solve_s=durations,
                    lm_iters=iters, traced=traced, attempted=len(durations), failed=0)

    # -- the check ---------------------------------------------------------

    def free(self):
        self.problem = None

    def _reference(self):
        """(problem, start cost, Solve) of the float64 reference solve from
        this problem's start, computed once."""
        if self._ref is None:
            cam, pt, uv = self.obs
            R0, t0, X0 = self.init
            prob = reference.make_problem(R0, t0, X0, cam, pt, uv, self.fixed)
            cost0 = reference.cost(prob.R, prob.t, prob.X, prob, self.huber)
            ref = reference.solve(prob, self.huber, max_iters=self.cfg["max_iters"],
                                  pcg_iters=self.cfg["pcg_iters"], lam0=self.cfg["lam0"],
                                  rtol=self.cfg["rtol"])
            self._ref = (prob, cost0, ref)
        return self._ref

    def readings(self, results, first):
        prob, cost0, ref = self._reference()
        return judge(prob, self.huber, cost0, ref, results, first)

    def program_results(self, tracer):
        """One solve through the window's call: ([result], first step)."""
        self.results, first = [], {}
        self._solve(tracer, True, first=first)
        return self.results, first

    def control_results(self, operands):
        """The reference put in the port's place, its products' operands
        rounded to ``operands``, in float32: ([result], first step)."""
        cam, pt, uv = self.obs
        R0, t0, X0 = self.init
        prob = reference.make_problem(R0, t0, X0, cam, pt, uv, self.fixed, torch.float32)
        s = reference.solve(prob, self.huber, max_iters=self.cfg["max_iters"],
                            pcg_iters=self.cfg["pcg_iters"], lam0=self.cfg["lam0"],
                            rtol=self.cfg["rtol"], operands=operands)
        return [(s.R.cpu(), s.t.cpu(), s.X.cpu(), s.cost0, s.cost)], s.first._asdict()

    def check(self, limits):
        """Every window solve's answer and reported costs, and the first
        solve's first LM iteration, against the float64 reference."""
        r = self.readings(self.results, self.first)
        return [dict(name=k, value=r[k], limit=limits[k]) for k in NUMBERS if k in r] + [
            dict(name="solves_checked", value=len(self.results), limit=1, least=True),
            dict(name="first_step_found", value=int(bool(self.first)), limit=1, least=True)]


# The numbers compared, in the order they are printed.
NUMBERS = ("cost0_gap", "cost_gap", "cost_excess", "rot_gap", "trans_gap", "point_gap",
           "system_gap", "step_gap")


def _rel(a, b, scale=None):
    """|a - b| / |scale| (Frobenius, float64; ``scale`` defaults to b)."""
    a = a.to(b.device, torch.float64)
    b = b.to(torch.float64)
    scale = b if scale is None else scale.to(b.device, torch.float64)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(scale))


def judge(prob, huber, ref_cost0, ref, results, first):
    """The compared numbers of solve results [(R, t, X, cost0, cost)] and
    of one solve's first LM iteration ``first`` (empty: not found):

    - ``cost0_gap``, ``cost_gap``: the largest relative gap of a reported
      start cost and of a reported final cost from the float64 cost at the
      same state; ``cost_excess``: the largest excess of the float64 cost at
      an answer over the reference solve's final cost;
    - ``rot_gap``, ``trans_gap``, ``point_gap``: the largest distance of an
      answer's R, t and X from the reference solve's, over the distance the
      reference moved them from the start (1: an answer that did not move);
    - ``system_gap``: the largest relative gap of the assembled Hcc, Hpp,
      gc and gp at the start from the reference's; ``step_gap``: that of
      the first camera step dx_c, the Schur PCG's answer."""
    gap0, gap, excess = 0.0, 0.0, float("-inf")
    rot = trans = point = 0.0
    dt = prob.R.dtype
    dev = prob.R.device
    for R, t, X, cost0, cost in results:
        at = reference.cost(R.to(dev, dt), t.to(dev, dt), X.to(dev, dt), prob, huber)
        gap0 = max(gap0, abs(cost0 - ref_cost0) / ref_cost0)
        gap = max(gap, abs(cost - at) / at)
        excess = max(excess, at / ref.cost - 1.0)
        rot = max(rot, _rel(R, ref.R, ref.R - prob.R))
        trans = max(trans, _rel(t, ref.t, ref.t - prob.t))
        point = max(point, _rel(X, ref.X, ref.X - prob.X))
    out = dict(cost0_gap=gap0, cost_gap=gap, cost_excess=excess, rot_gap=rot,
               trans_gap=trans, point_gap=point)
    if first:
        out["system_gap"] = max(_rel(first[k], getattr(ref.first, k))
                                for k in ("Hcc", "Hpp", "gc", "gp"))
        out["step_gap"] = _rel(first["dx_c"], ref.first.dx_c)
    return out
