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
    port's descend (the JAX model's trees too: the routing is integer)."""
    import torch

    from dmlc_core_tpu_torch.models.histgbt import HistGBT

    port = HistGBT(device="cpu", **{k: v for k, v in
                                    model.param.to_dict().items()})
    port.cuts = torch.as_tensor(np.array(model.cuts, np.float32))
    port._missing = model._missing
    margin = port._base_margin(bins_t.shape[1])
    out = []
    for tree in model.trees:
        margin = port._apply_stacked(bins_t, port._stacked_trees([
            {k: np.asarray(v) for k, v in tree.items()}]), margin)
        out.append(margin.numpy())
    return out


def assert_level_b(jm, tm, Xv, min_same=0.9, X=None):
    """Level (b) of ``tm`` (port) against ``jm`` (JAX), both fitted on the
    same rows ``X``; ``Xv`` held-out rows.  Returns ``(differing nodes,
    tree where the fits parted or None)``; where they parted, the margin
    and prediction checks are the caller's."""
    assert _same_bits(tm.cuts.numpy(), jm.cuts)
    assert tm._missing == jm._missing
    import torch

    bins_v = tm._bins_of(torch.from_numpy(
        np.ascontiguousarray(Xv, np.float32))).numpy()
    parted = None
    if X is not None:
        bins_tr = tm._bins_of(torch.from_numpy(
            np.ascontiguousarray(X, np.float32)))
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


def assert_level_b_through(jm, tm, X, y, Xv, min_same=0.9, **fit_kw):
    """Level (b) of the port's fit ``tm`` against JAX's ``jm`` over every
    tree, both fitted on ``X``, ``y`` (``fit_kw`` passed to ``fit``).
    Where they part at tree ``p``, the port's first ``p + 1`` trees are
    saved, loaded into both packages, and both continue on ``X``, ``y``
    to the full tree count; the continued pair is held to level (b) in
    turn (its trees up to ``p`` are one file's).  Returns the stages:
    ``[(jm, tm, parted)]``, the caller's pair first, the last one whose
    ``parted`` is None (margins and held-out rows checked) or the last
    tree (nothing follows)."""
    from dmlc_core_tpu.models import HistGBT as JaxHistGBT
    from dmlc_core_tpu.parallel.mesh import local_mesh
    from dmlc_core_tpu_torch.models.histgbt import HistGBT

    n_trees = len(tm.trees)
    stages = []
    while True:
        parted = assert_level_b(jm, tm, Xv, min_same, X=X)[1]
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
