"""Parity level (b) between a JAX-package ``HistGBT`` and the port's, for
any objective (trees ``[depth, half]`` or ``[K, depth, half]``), plain or
missing mode — the rule of ROADMAP "Parity" and of
tests/test_torch_histgbt.py::test_tied_splits_equal_gains_and_training_cuts:

* nodes whose (feat, thr, dir) agree: gains within rtol 1e-4 / atol 1e-5,
  and the leaves under splits that all agree within rtol 1e-5 / atol 1e-5;
* nodes that differ (ties, picked apart by JAX's order-dependent f32 sums
  and the port's exact ones) while every ancestor agrees: gains within
  rtol 1e-5 / atol 1e-6.  Below a differing node the two trees hold
  different rows, and nothing is compared;
* training margins within 1e-5, and held-out rows whose path crosses no
  differing node in either model predict the same within 1e-5.

A tie between two features that split the training rows apart (a near
tie, within the tie rule's tolerance, flipped by last-place differences
of the two packages' f32 gradients) sends the fits on different rows from
that tree on (ROADMAP C).  :func:`assert_level_b` then holds the trees up
to and at that tree — its differing nodes must be ties — and returns
where the fits parted.  :func:`assert_level_b_through` goes on past it:
both packages load the port's trees up to and at the parting tree from
its file (parity level (c)), continue from that common prefix, and the
continued fits are held to level (b) in turn, until they no longer part.
"""

import os
import tempfile

import numpy as np

TIE_RTOL, TIE_ATOL = 1e-5, 1e-6

#: f32 unit roundoff
U32 = 2.0 ** -24
#: the probabilistic summation bound's constant: an f32 sum of m terms
#: in any order is within LAMBDA·√m·u·Σ|x| of the exact sum except with
#: probability below 2·exp(−LAMBDA²/2) ≈ 3e-8 (Higham & Mary, "A new
#: approach to probabilistic rounding error analysis", 2019)
LAMBDA = 6.0
#: two float64 gains are an exact tie within this relative distance
TIE64 = 1e-9


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _class_trees(tree):
    """A tree's per-class dicts (one for a single-output tree)."""
    feat = np.asarray(tree["feat"])
    if feat.ndim == 2:
        return [{k: np.asarray(v) for k, v in tree.items()}]
    return [{k: np.asarray(v)[c] for k, v in tree.items()}
            for c in range(feat.shape[0])]


def _paths(tree, bins, miss_bin):
    """Each row's node at every level, ``[depth, n]``, numpy routing."""
    depth = tree["feat"].shape[0]
    node = np.zeros(bins.shape[1], np.int64)
    rows = np.arange(bins.shape[1])
    out = []
    for lvl in range(depth):
        out.append(node)
        f = tree["feat"][lvl][node]
        b = bins[f, rows].astype(np.int64)
        right = b > tree["thr"][lvl][node]
        if "dir" in tree:
            right = np.where(b == miss_bin, tree["dir"][lvl][node] == 0,
                             right)
        node = 2 * node + right
    return out


def _train_margins_by_tree(model, bins_t):
    """The training margins after each tree, ``[T, ...]``, replayed by the
    port's forest walk (the JAX model's trees too: the routing is
    integer)."""
    import torch

    from dmlc_core_tpu_torch.models.histgbt import HistGBT
    from dmlc_core_tpu_torch.ops.forest import pack_forest, predict_forest

    port = HistGBT(device="cpu", **{k: v for k, v in
                                    model.param.to_dict().items()})
    port.cuts = torch.as_tensor(np.array(model.cuts, np.float32))
    port._missing = model._missing
    margin = port._base_margin(bins_t.shape[1])
    out = []
    for tree in model.trees:
        margin = predict_forest(bins_t, pack_forest(
            [{k: np.asarray(v) for k, v in tree.items()}],
            port.param.max_depth, "cpu", port._miss_bin()), margin)
        out.append(margin.numpy())
    return out


def assert_level_b(jm, tm, Xv, min_same=0.9, X=None, y=None, weight=None,
                   qid=None, fixed=True):
    """Level (b) of ``tm`` (port) against ``jm`` (JAX), both fitted on the
    same rows ``X``; ``Xv`` held-out rows.  Returns ``(differing nodes,
    tree where the fits parted or None)``; where they parted, the margin
    and prediction checks are the caller's.

    The checks are the fixed tolerances of the module docstring and, with
    the labels ``y`` (and the fit's ``weight``, ``qid``), also the float64
    proofs of :func:`assert_level_b_f64` wherever they apply
    (:func:`f64_supported`): a fit must pass both, and the earlier of the
    two partings is returned.  ``fixed=False`` (ROADMAP C5/C6's setups,
    whose exact values lie outside the fixed tolerances) leaves the
    float64 proofs alone."""
    f64 = X is not None and y is not None and f64_supported(tm)
    assert f64 or fixed, "fixed=False needs the float64 proofs"
    parted64 = None
    if f64:
        n_differ, parted64 = assert_level_b_f64(
            jm, tm, X, y, Xv, weight=weight, qid=qid, min_same=min_same)[:2]
        if not fixed:
            return n_differ, parted64
    n_differ, parted = _assert_level_b_fixed(jm, tm, Xv, min_same, X)
    if parted64 is not None:
        parted = parted64 if parted is None else min(parted, parted64)
    return n_differ, parted


def _train_bins(tm, X):
    """Feature-major bins of the training rows ``X`` as the fit made them:
    the host route's numpy binning under ``DMLC_TPU_BIN_BACKEND=cpu``
    (which keeps f32 subnormals, as JAX's host route does; ROADMAP C11),
    else the device route's (``_bins_of``, which flushes them as XLA
    does).  Held-out rows are binned as ``predict`` bins them, on the
    device route."""
    import torch

    from dmlc_core_tpu_torch.models.gbt_split import _host_bin_t

    X = np.ascontiguousarray(X, np.float32)
    if os.environ.get("DMLC_TPU_BIN_BACKEND", "") == "cpu":
        return _host_bin_t(X, tm.cuts.numpy(), missing=tm._missing)
    return tm._bins_of(torch.from_numpy(X)).numpy()


def _assert_level_b_fixed(jm, tm, Xv, min_same, X):
    """The fixed-tolerance checks of :func:`assert_level_b`."""
    assert _same_bits(tm.cuts.numpy(), jm.cuts)
    assert tm._missing == jm._missing
    import torch

    bins_v = tm._bins_of(torch.from_numpy(
        np.ascontiguousarray(Xv, np.float32))).numpy()
    parted = None
    if X is not None:
        bins_tr = torch.from_numpy(_train_bins(tm, X))
        mj = _train_margins_by_tree(jm, bins_tr)
        mt = _train_margins_by_tree(tm, bins_tr)
        for t, (a, b) in enumerate(zip(mj, mt)):
            if np.abs(a - b).max() > 1e-5:
                parted = t
                break
    mb = tm._miss_bin()
    crosses = np.zeros(len(Xv), bool)
    n_differ = ties_at_parted = 0
    assert len(jm.trees) == len(tm.trees)
    for t, (ja, tb) in enumerate(zip(jm.trees, tm.trees)):
        if parted is not None and t > parted:
            break
        assert list(tb) == list(ja)              # key order: the file
        for c, (a, b) in enumerate(zip(_class_trees(ja), _class_trees(tb))):
            depth = a["feat"].shape[0]
            live = (np.arange(a["feat"].shape[1])[None, :]
                    < 2 ** np.arange(depth)[:, None])
            differ = live & ((a["feat"] != b["feat"])
                             | (a["thr"] != b["thr"]))
            if "dir" in a:
                differ |= live & (a["dir"] != b["dir"])
            # nodes with a differing ancestor hold other rows
            under = np.zeros_like(differ)
            for lvl in range(1, depth):
                parent = np.arange(differ.shape[1]) >> 1
                under[lvl] = (under[lvl - 1] | differ[lvl - 1])[parent]
            agree = live & ~differ & ~under
            n_differ += int(differ.sum())
            differ_top = differ & ~under
            if t == parted:
                ties_at_parted += int(differ_top.sum())
            msg = f"tree {t} class {c}"
            np.testing.assert_allclose(b["gain"][agree], a["gain"][agree],
                                       rtol=1e-4, atol=1e-5, err_msg=msg)
            np.testing.assert_allclose(b["gain"][differ_top],
                                       a["gain"][differ_top],
                                       rtol=TIE_RTOL, atol=TIE_ATOL,
                                       err_msg=msg)
            clean = np.ones(2 ** depth, bool)
            for lvl in range(depth):
                span = 2 ** (depth - lvl)
                for i in np.flatnonzero(differ[lvl]):
                    clean[i * span:(i + 1) * span] = False
            np.testing.assert_allclose(b["leaf"][clean], a["leaf"][clean],
                                       rtol=1e-5, atol=1e-5, err_msg=msg)
            for tree in (a, b):
                for lvl, node in enumerate(_paths(tree, bins_v, mb)):
                    crosses |= differ[lvl][node]
    if parted is not None:
        # a parting is explained by a tie at that tree, nothing else
        assert ties_at_parted > 0, f"margins parted at tree {parted} " \
            "with every split agreeing"
        return n_differ, parted
    np.testing.assert_allclose(tm.train_margins(), jm.train_margins(),
                               atol=1e-5)
    same = ~crosses
    assert same.mean() > min_same, same.mean()
    np.testing.assert_allclose(tm.predict(Xv[same], output_margin=True),
                               jm.predict(Xv[same], output_margin=True),
                               atol=1e-5)
    return n_differ, None


def assert_level_b_through(jm, tm, X, y, Xv, min_same=0.9, fixed=True,
                           **fit_kw):
    """Level (b) of the port's fit ``tm`` against JAX's ``jm`` over every
    tree, both fitted on ``X``, ``y`` (``fit_kw`` passed to ``fit``).
    Where they part at tree ``p``, the port's first ``p + 1`` trees are
    saved, loaded into both packages, and both continue on ``X``, ``y``
    to the full tree count; the continued pair is held to level (b) in
    turn (its trees up to ``p`` are one file's).  Returns the stages:
    ``[(jm, tm, parted)]``, the caller's pair first, the last one whose
    ``parted`` is None (margins and held-out rows checked) or the last
    tree (nothing follows).  ``fixed`` as in :func:`assert_level_b`."""
    from dmlc_core_tpu.models import HistGBT as JaxHistGBT
    from dmlc_core_tpu.parallel.mesh import local_mesh
    from dmlc_core_tpu_torch.models.histgbt import HistGBT

    n_trees = len(tm.trees)
    stages = []
    while True:
        parted = assert_level_b(jm, tm, Xv, min_same, X=X, y=y,
                                weight=fit_kw.get("weight"),
                                qid=fit_kw.get("qid"), fixed=fixed)[1]
        if stages:
            assert parted is None or parted > stages[-1][2]
        stages.append((jm, tm, parted))
        if parted is None or parted == n_trees - 1:
            return stages
        state = tm.to_state()
        prefix = HistGBT.from_state(dict(state,
                                         trees=state["trees"][:parted + 1]),
                                    device="cpu")
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "prefix.bin")
            prefix.save_model(path)
            jm = JaxHistGBT.load_model(path, mesh=local_mesh(1))
            tm = HistGBT.load_model(path, device="cpu")
        for m in (jm, tm):
            m.param.n_trees = n_trees - parted - 1
            m.fit(X, y, **fit_kw)
            m.param.n_trees = n_trees


# ---------------------------------------------------------------------------
# parity level (b) proven in float64 (ROADMAP C5, C6)
# ---------------------------------------------------------------------------
#
# Each package's trees are audited against float64 arithmetic on its OWN
# inputs: its margins before the tree (replayed with integer routing and
# the f32 adds both packages make), its objective's f32 g/h (the JAX
# package's own objective for JAX, the port's for the port) times the
# instance weights in f32.  Every sum a tree depends on is then exact in
# float64 (a few thousand f32 values), and each package's f32 result is
# held to it within an error bound derived from how that package sums:
#
# * JAX: a directly built node histogram is an f32 sum of the node's n
#   rows in an order the program picks, then an f32 cumsum over B bins:
#   error ≤ LAMBDA·√n·u·A + B·u·A (A = Σ|g| over the node's rows; the
#   first term probabilistic, see LAMBDA);
# * the port: fixed-point sums, exact, then one f32 rounding a bin and the
#   same cumsum: error ≤ n·2^-(k+1) (quantisation at the tree's scale k)
#   + (B+1)·u·A;
# * both derive a right child as parent − left in f32: its error is the
#   parent's plus the left child's plus B·u·A of its own.
#
# A gain G²/(H+λ) terms' error follows from the sums' errors by interval
# bounds, plus 5u of the terms' magnitude for the f32 evaluation; a leaf
# −G/(H+λ)·η likewise plus 3u of its magnitude.  The audit asserts, per
# node: the stored gain is within its bound of the float64 gain of the
# stored split; a real split is valid (children at or above
# min_child_weight, or within the sum bound of it), is within the bounds
# of the best candidate that is surely valid, and clears gamma within its
# bound; a degenerate node (depth-wise) has no surely valid candidate
# surely above gamma; and every leaf is within its bound of float64.
#
# Where the two packages' splits differ under agreeing ancestors, the
# node must be one of: "tie", the two splits' float64 gains on the port's
# inputs equal within TIE64; "mcw", one package's split has a child whose
# hessian sum lies within the other package's sum bound of
# min_child_weight (C5); "gamma", one side is degenerate and the other's
# gain lies within the bounds of gamma; "near", on each package's inputs
# the other's split is within that package's bounds of its own, the near
# ties of ROADMAP C4 (their inputs differ in the last place).  Margins
# are compared row by row within the sum of both packages' leaf bounds
# and the float64 leaves' difference.


def f64_supported(tm):
    """Whether :func:`assert_level_b` can audit this fit in float64: no
    missing mode and no monotone constraints (their scorers are not
    re-derived here), and no sampling (its masks are given only to
    :func:`assert_level_b_f64` directly); the others keep the fixed
    tolerances."""
    p = tm.param
    return (p.subsample >= 1.0 and p.colsample_bytree >= 1.0
            and not tm._missing
            and not any(int(v) for v in (p.monotone_constraints or ())))


def _score(G, H, lam, alpha):
    t = np.sign(G) * np.maximum(np.abs(G) - alpha, 0.0) if alpha else G
    with np.errstate(divide="ignore", invalid="ignore"):   # λ = 0, H = 0
        return t * t / (H + lam), np.abs(t)


def _score_err(G, H, eg, eh, lam, alpha):
    """Bound on |T(G', H') − T(G, H)| for |G' − G| ≤ eg, |H' − H| ≤ eh
    (T = t(G)²/(H+λ), t the L1 threshold, 1-Lipschitz)."""
    T, t = _score(G, H, lam, alpha)
    den = H + lam
    lo_den = den - eh
    with np.errstate(divide="ignore", invalid="ignore"):
        hi = np.where(lo_den > 0, (t + eg) ** 2 / lo_den, np.inf)
        lo = np.maximum(t - eg, 0.0) ** 2 / (den + eh)
    return np.maximum(hi - T, T - lo), T


def _audit(tree, bins, g, h, p, kind, scales=None, lossguide=False,
           feat_mask=None):
    """Audit one single-output tree of ``kind`` ("jax" | "port") against
    float64 on its inputs ``g``/``h`` (f32 values as float64) over the
    feature-major ``bins``.  Returns the per-node candidate tables (for
    the cross-package rules), each row's leaf, the float64 leaves and
    their bounds."""
    feat, thr, gain, leaf = (np.asarray(tree[k]) for k in
                             ("feat", "thr", "gain", "leaf"))
    depth = feat.shape[0]
    B, lam, alpha = p.n_bins, p.reg_lambda, p.reg_alpha
    gamma, mcw, eta = p.gamma, p.min_child_weight, p.learning_rate
    F, n = bins.shape
    u = U32
    rows = np.arange(n)
    node = np.zeros(n, np.int64)
    eg_prev = eh_prev = None           # per-node sum bounds of the level
    tables = []
    ag, ah = np.abs(g), np.abs(h)
    for lvl in range(depth):
        N = 1 << lvl
        idx = ((node[None, :] * F + np.arange(F)[:, None]) * B
               + bins.astype(np.int64)).ravel()
        Hg = np.bincount(idx, np.tile(g, F), N * F * B).reshape(N, F, B)
        Hh = np.bincount(idx, np.tile(h, F), N * F * B).reshape(N, F, B)
        Ag = np.bincount(node, ag, N)
        Ah = np.bincount(node, ah, N)
        cnt = np.bincount(node, minlength=N).astype(np.float64)

        def built(A, k):
            if kind == "jax":
                return LAMBDA * np.sqrt(cnt) * u * A + B * u * A
            return cnt * 2.0 ** -(k + 1) + (B + 1) * u * A

        eg = built(Ag, scales[0] if scales else 0)
        eh = built(Ah, scales[1] if scales else 0)
        if lvl > 0:
            par = np.arange(N) >> 1
            left = np.arange(N) & ~1
            odd = (np.arange(N) & 1) == 1
            eg = np.where(odd, eg_prev[par] + eg[left] + B * u * Ag, eg)
            eh = np.where(odd, eh_prev[par] + eh[left] + B * u * Ah, eh)
        cg, ch = np.cumsum(Hg, axis=2), np.cumsum(Hh, axis=2)
        GL, HL = cg[..., :-1], ch[..., :-1]
        GT, HT = cg[..., -1:], ch[..., -1:]
        GR, HR = GT - GL, HT - HL
        egn, ehn = eg[:, None, None], eh[:, None, None]
        egr, ehr = 2 * egn + u * np.abs(GR), 2 * ehn + u * np.abs(HR)
        dl, TL = _score_err(GL, HL, egn, ehn, lam, alpha)
        dr, TR = _score_err(GR, HR, egr, ehr, lam, alpha)
        dt, TT = _score_err(GT, HT, egn, ehn, lam, alpha)
        g64 = TL + TR - TT
        bound = dl + dr + dt + 5 * u * (np.abs(TL) + np.abs(TR) + np.abs(TT))
        sure = (HL - ehn >= mcw) & (HR - ehr >= mcw)
        maybe = (HL + ehn >= mcw) & (HR + ehr >= mcw)
        if feat_mask is not None:           # column sampling
            sure &= feat_mask[None, :, None]
            maybe &= feat_mask[None, :, None]
        f, t, gs = feat[lvl][:N], thr[lvl][:N], gain[lvl][:N]
        for i in range(N):
            msg = f"{kind} level {lvl} node {i}"
            sure_g = np.where(sure[i], g64[i], -np.inf)
            j = np.unravel_index(np.argmax(sure_g), sure_g.shape)
            best, best_b = sure_g[j], bound[i][j]
            if t[i] < B - 1:
                fi, ti = f[i], t[i]
                assert maybe[i, fi, ti], f"{msg}: invalid split"
                assert g64[i, fi, ti] + bound[i, fi, ti] + best_b >= best, \
                    f"{msg}: gain {g64[i, fi, ti]} below the best {best}"
                assert 0.5 * (g64[i, fi, ti] + bound[i, fi, ti]) >= gamma, \
                    f"{msg}: split below gamma"
                assert abs(gs[i] - 0.5 * g64[i, fi, ti]) \
                    <= 0.5 * bound[i, fi, ti], \
                    f"{msg}: gain {gs[i]} vs float64 {0.5 * g64[i, fi, ti]}" \
                    f" (bound {0.5 * bound[i, fi, ti]})"
            else:
                assert gs[i] == 0.0, msg
                if not lossguide and np.isfinite(best):
                    assert 0.5 * (best - best_b) <= gamma, \
                        f"{msg}: degenerate, but {best} clears gamma"
        tables.append({"g64": g64, "bound": bound, "sure": sure,
                       "maybe": maybe, "HL": HL, "HR": HR, "eh": np.broadcast_to(ehn, HL.shape),
                       "ehr": ehr})
        eg_prev, eh_prev = eg, eh
        go_right = bins[f[node], rows] > t[node]
        last = (GL, HL, GR, HR, egn, ehn, egr, ehr, f, t)
        node = 2 * node + go_right
    # the leaves: the deepest level's child sums at its splits
    GL, HL, GR, HR, egn, ehn, egr, ehr, f, t = last
    N = f.shape[0]
    ii = np.arange(N)
    tsel = np.minimum(t, B - 2)
    full = t >= B - 1                      # degenerate: all rows left
    gl = np.where(full, GL[ii, f, tsel] + GR[ii, f, tsel], GL[ii, f, tsel])
    hl = np.where(full, HL[ii, f, tsel] + HR[ii, f, tsel], HL[ii, f, tsel])
    tot_g, tot_h = GL[ii, f, tsel] + GR[ii, f, tsel], \
        HL[ii, f, tsel] + HR[ii, f, tsel]
    Gc = np.stack([gl, tot_g - gl], 1).reshape(-1)
    Hc = np.stack([hl, tot_h - hl], 1).reshape(-1)
    egc = np.stack([egn[:, 0, 0], egr[ii, f, tsel]], 1).reshape(-1)
    ehc = np.stack([ehn[:, 0, 0], ehr[ii, f, tsel]], 1).reshape(-1)
    tg = np.sign(Gc) * np.maximum(np.abs(Gc) - alpha, 0.0) if alpha else Gc
    # a slot no training row reaches (under a node that took no split)
    # holds whatever the package's sums leave there: with λ = 0 the port's
    # exact sums give 0/0 = NaN, JAX's f32 residue ±0.0 or a residue leaf
    # (ROADMAP C12).  Only then are the slots rows reach the ones held to
    # float64: with λ > 0 every slot is held (an unreached one to 0).
    reach = (np.bincount(node, minlength=2 * N) > 0) | (lam > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        leaf64 = -tg / (Hc + lam) * eta
        lo_den = Hc + lam - ehc
        hi = np.where(lo_den > 0, (np.abs(tg) + egc) / lo_den, np.inf)
        lo = np.maximum(np.abs(tg) - egc, 0.0) / (Hc + lam + ehc)
        mag = np.abs(tg) / (Hc + lam)
        lbound = eta * np.maximum(hi - mag, mag - lo) + 3 * u * np.abs(leaf64)
        off = np.abs(leaf.astype(np.float64) - leaf64)
    assert np.all(off[reach] <= lbound[reach]), \
        f"{kind} leaves off float64: " \
        f"{off[reach].max()} (bound {lbound[reach].min()})"
    return {"tables": tables, "node": node, "leaf64": leaf64,
            "lbound": lbound, "reach": reach}


def _classify(tj, tp, lvl, i, cj, cp, p):
    """Which rule explains a node where JAX took split ``cj`` and the port
    ``cp`` ((feat, thr); thr B−1 degenerate), from both audits' tables."""
    B, gamma, mcw = p.n_bins, p.gamma, p.min_child_weight
    J, P = tj[lvl], tp[lvl]
    real_j, real_p = cj[1] < B - 1, cp[1] < B - 1
    if real_j and real_p:
        a = (i,) + tuple(cj)
        b = (i,) + tuple(cp)
        gp_j, gp_p = P["g64"][a], P["g64"][b]
        if P["maybe"][a] and abs(gp_j - gp_p) <= TIE64 * max(1.0, abs(gp_p)):
            return "tie"
        # a child at min_child_weight within the other package's bound
        for T, c in ((J, b), (P, a)):
            near = (abs(T["HL"][c] - mcw) <= T["eh"][c]
                    or abs(T["HR"][c] - mcw) <= T["ehr"][c])
            if near and not T["sure"][c]:
                return "mcw"
        if (abs(J["g64"][a] - J["g64"][b]) <= J["bound"][a] + J["bound"][b]
                and abs(gp_j - gp_p) <= P["bound"][a] + P["bound"][b]
                + abs(J["g64"][a] - gp_j) + abs(J["g64"][b] - gp_p)):
            return "near"
        return None
    if real_j != real_p:
        c = (i,) + tuple(cj if real_j else cp)
        for T in (J, P):
            if abs(0.5 * T["g64"][c] - gamma) <= 0.5 * (J["bound"][c]
                                                       + P["bound"][c]):
                return "gamma"
            if not T["sure"][c]:
                return "mcw"
    return None


def _inputs(g, h, w, K):
    """One package's f32 g/h times the weights in f32, per class, as
    float64 arrays of f32 values."""
    g, h = np.asarray(g, np.float32), np.asarray(h, np.float32)
    wf = w[:, None] if K > 1 else w
    g, h = (g * wf).astype(np.float64), (h * wf).astype(np.float64)
    if K > 1:
        return [(g[:, c], h[:, c]) for c in range(K)]
    return [(g, h)]


def _leaf_of(tree, bins):
    """Each row's leaf position in a single-output tree."""
    node = _paths(tree, bins, -1)[-1]
    f = tree["feat"][-1][node]
    return 2 * node + (bins[f, np.arange(bins.shape[1])]
                       > tree["thr"][-1][node])


def assert_level_b_f64(jm, tm, X, y, Xv, weight=None, qid=None,
                       min_same=0.9, masks=None):
    """Level (b) of the port's fit ``tm`` against JAX's ``jm`` by the
    float64 proofs above (both fitted on ``X``, ``y``, ``weight``,
    ``qid``; ``masks(t) -> (row keep [n] f32 | None, feature mask [F] |
    None)``, the sampling draws of tree ``t``, multiply the weights and
    limit the candidates).  Fits without training margins (the chunked
    ``fit_external``) skip the check of the replay against them.
    Returns ``(differing nodes, tree where the fits parted or None,
    [(tree, class, level, node, rule)] of the differing nodes)``;
    a fit parts at the first tree that sends a training row to another
    leaf, and there the margin and held-out checks are the caller's."""
    import jax.numpy as jnp
    import torch

    from dmlc_core_tpu.models.gbt_objectives import OBJECTIVES as JOBJ
    from dmlc_core_tpu_torch.models.gbt_objectives import (
        OBJECTIVES as POBJ, fold_scale_pos_weight)
    from dmlc_core_tpu_torch.models.histgbt import HistGBT
    from dmlc_core_tpu_torch.ops.histogram import hist_scales

    assert _same_bits(tm.cuts.numpy(), jm.cuts)
    assert tm._missing == jm._missing
    assert len(jm.trees) == len(tm.trees)
    p = tm.param
    name, K = p.objective, p.num_class
    X = np.ascontiguousarray(X, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    jobj, pobj = JOBJ[name], POBJ[name]
    pos = None
    if qid is not None:
        lay = HistGBT(device="cpu", **p.to_dict())
        X, y, weight = lay._regroup_ranking(X, y, np.asarray(qid), weight)
        pos = lay._rank_pos
        jobj, pobj = jobj(lay._obj.G), pobj(lay._obj.G)
    w = fold_scale_pos_weight(p, y, weight)
    w = np.ones(len(y), np.float32) if w is None else np.asarray(w, np.float32)
    bins = _train_bins(tm, X)
    bins_v = tm._bins_of(torch.from_numpy(
        np.ascontiguousarray(Xv, np.float32))).numpy()
    lossguide = os.environ.get("DMLC_GROW_POLICY", "depthwise") == "lossguide"
    shape = (len(y), K) if K > 1 else (len(y),)
    mj = np.full(shape, p.base_score, np.float32)
    mp = mj.copy()
    # per row: the bound of |m_J − m_P| accumulated over the trees
    acc = np.zeros(shape)
    acc_v = np.zeros((len(bins_v[0]), K) if K > 1 else len(bins_v[0]))
    crosses = np.zeros(bins_v.shape[1], bool)
    report, parted, n_differ = [], None, 0
    yj, yt = jnp.asarray(y), torch.from_numpy(y)
    for t, (ja, tb) in enumerate(zip(jm.trees, tm.trees)):
        # key order: the file's (JAX's chunked fit_external appends its
        # trees as feat, thr, gain, leaf; every route of the port writes
        # the in-core fit's sorted order)
        assert list(tb) == list(ja) or (
            list(ja) == ["feat", "thr", "gain", "leaf"]
            and list(tb) == sorted(ja))
        keep, fmask = masks(t) if masks is not None else (None, None)
        wt = w if keep is None else w * keep
        in_j = _inputs(*jobj.grad_hess(jnp.asarray(mj), yj), wt, K)
        in_p = _inputs(*(a.numpy() for a in pobj.grad_hess(
            torch.from_numpy(mp), yt)), wt, K)
        moved = False
        for c, (a, b) in enumerate(zip(_class_trees(ja), _class_trees(tb))):
            gj, hj = in_j[c]
            gp, hp = in_p[c]
            sc = hist_scales(torch.from_numpy(gp.astype(np.float32)),
                             torch.from_numpy(hp.astype(np.float32)))
            aj = _audit(a, bins, gj, hj, p, "jax", lossguide=lossguide,
                        feat_mask=fmask)
            ap = _audit(b, bins, gp, hp, p, "port", scales=sc,
                        lossguide=lossguide, feat_mask=fmask)
            depth = a["feat"].shape[0]
            live = (np.arange(a["feat"].shape[1])[None, :]
                    < 2 ** np.arange(depth)[:, None])
            differ = live & ((a["feat"] != b["feat"])
                             | (a["thr"] != b["thr"]))
            under = np.zeros_like(differ)
            for lvl in range(1, depth):
                parent = np.arange(differ.shape[1]) >> 1
                under[lvl] = (under[lvl - 1] | differ[lvl - 1])[parent]
            n_differ += int(differ.sum())
            for lvl, i in zip(*np.nonzero(differ & ~under)):
                rule = _classify(aj["tables"], ap["tables"], lvl, i,
                                 (a["feat"][lvl][i], a["thr"][lvl][i]),
                                 (b["feat"][lvl][i], b["thr"][lvl][i]), p)
                assert rule is not None, \
                    f"tree {t} class {c} level {lvl} node {i}: JAX " \
                    f"({a['feat'][lvl][i]}, {a['thr'][lvl][i]}) vs the " \
                    f"port ({b['feat'][lvl][i]}, {b['thr'][lvl][i]}) " \
                    "is no tie and no boundary"
                report.append((t, c, int(lvl), int(i), rule))
            if np.any(aj["node"] != ap["node"]):
                moved = True
            # a leaf that is no number only where no training row goes
            for tree, au in ((a, aj), (b, ap)):
                bad = ~np.isfinite(np.asarray(tree["leaf"])) & au["reach"]
                assert not bad.any(), \
                    f"tree {t} class {c}: a non-finite leaf at a slot " \
                    f"training rows reach ({np.flatnonzero(bad)})"
            # held-out rows at a slot no training row reaches are not
            # compared (the packages' leaves there are unconstrained)
            crosses |= ~aj["reach"][_leaf_of(a, bins_v)]
            crosses |= ~ap["reach"][_leaf_of(b, bins_v)]
            lj = a["leaf"][aj["node"]]
            lp = b["leaf"][ap["node"]]
            step = (aj["lbound"] + ap["lbound"]
                    + np.abs(aj["leaf64"] - ap["leaf64"]))
            if K > 1:
                mj[:, c] = mj[:, c] + lj
                mp[:, c] = mp[:, c] + lp
                acc[:, c] += step[ap["node"]] + 2 * U32 * np.abs(mp[:, c])
            else:
                mj = mj + lj
                mp = mp + lp
                acc += step[ap["node"]] + 2 * U32 * np.abs(mp)
            for tree in (a, b):
                for lvl, nd in enumerate(_paths(tree, bins_v, -1)):
                    crosses |= differ[lvl][nd]
            inc = step[_leaf_of(b, bins_v)]
            if K > 1:
                acc_v[:, c] += inc
            else:
                acc_v += inc
        if moved:
            parted = t
            break
    if parted is None:
        if pos is not None:             # the rows' places in the layout
            kept = pos >= 0
            mj, mp, acc = mj[pos[kept]], mp[pos[kept]], acc[pos[kept]]
        if tm._train_preds is not None:
            # the replay is each package's own margin arithmetic
            tmj, tmp = np.asarray(jm.train_margins()), tm.train_margins()
            if pos is not None:
                tmj, tmp = tmj[kept], tmp[kept]
            assert _same_bits(mp, tmp)
            np.testing.assert_array_equal(mj, tmj)
        assert np.all(np.abs(mj.astype(np.float64) - mp) <= acc), \
            f"training margins apart by {np.abs(mj - mp).max()}"
        same = ~crosses
        assert same.mean() > min_same, same.mean()
        pj = np.asarray(jm.predict(Xv[same], output_margin=True), np.float64)
        pt = tm.predict(Xv[same], output_margin=True).astype(np.float64)
        bound_v = acc_v[same] + 2 * len(tm.trees) * U32 * np.abs(pt)
        assert np.all(np.abs(pj - pt) <= bound_v), np.abs(pj - pt).max()
    return n_differ, parted, report
