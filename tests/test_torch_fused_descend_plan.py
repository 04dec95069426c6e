"""The plan of the port's fused descend (B3: ``histogram._descend_plan``,
read by ``hist_accum_kernel``'s descend prologue in
``dmlc_core_tpu_torch/ops/csrc/histogram.cu``).

The kernel cannot run on the CPU.  A numpy emulation driven by nothing but
the plan — feature groups, row chunks, steps of ``STEP_QUADS`` quads, the
cluster of a chunk's groups (which rank descends which quad, which blocks
store ``new_node``, whose ids each block reads), the per-node split table
and the digit split — is held bit for bit to ``fused_descend_plain`` and,
on order-exact g/h, to the JAX package's ``_fused_pallas`` (the Pallas
``_fused_kernel`` in interpret mode).  It asserts that every row's
``new_node`` is stored exactly once, that every block of a cluster reads
each quad's ids from the one rank that descended it in the same step, that
each digit sum stays in its 32-bit word and that a block's shared bytes fit
the card.  Cases: n_prev 1, 4, 16 and 32, per-node and per-row tables,
masked rows, node ids past the level (per-row tables), the scales of
``hist_scales`` and 2^12 larger, on an H100 and on cards whose shared
memory makes several groups, clusters of two blocks, odd group counts
(every block descends) or no group at all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.ops import histogram as jh
from dmlc_core_tpu_torch.ops import binlayout as tbl
from dmlc_core_tpu_torch.ops import histogram as th

torch.set_num_threads(2)

B = 64
#: (SMs, shared bytes a block may opt in to, of an SM, reserved a block)
H100 = (132, 232_448, 233_472, 1_024)


def _card(F, n_prev, feats_per_group, ids):
    """A card of 3 SMs whose blocks hold ``feats_per_group`` features'
    cells (0: not one) besides the tables the descend plan reserves (with
    ``ids``, also a cluster's ids)."""
    cells = n_prev * (B + 1) * tbl.CELL_BYTES
    reserve = th._split_bytes(n_prev) + (th.CLUSTER_IDS_BYTES if ids
                                         else 0)
    return (3, feats_per_group * cells + th.TABLE_ENTRY_BYTES * F + reserve
            + 16, 233_472, 0)


def _level(n, F, n_prev, seed, exact, past=False):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (F, n)).astype(np.uint8)
    node = rng.integers(0, 2 * n_prev if past else n_prev, n).astype(np.int32)
    node[rng.random(n) < 0.05] = -1
    feat = rng.integers(0, F, 2 * n_prev).astype(np.int32)
    thr = rng.integers(0, B - 1, 2 * n_prev).astype(np.int32)
    if exact:
        g = rng.choice([-1.0, -0.5, 0.5, 1.0], n).astype(np.float32)
        h = rng.choice([0.5, 1.0], n).astype(np.float32)
    else:
        g = rng.normal(size=n).astype(np.float32)
        h = rng.uniform(0.01, 0.25, n).astype(np.float32)
    return bins, node, feat, thr, g, h


def _descend_rows(bins, node, feat, thr, by_node, n_prev, rows):
    """The kernel's descend_quad on ``rows``: 2·parent + (the parent's
    feature's byte > its threshold), −1 for a parent < 0 or, with
    per-node tables, past the level's ``n_prev``."""
    nd = node[rows].astype(np.int64)
    if by_node:
        nd = np.where(nd < n_prev, nd, -1)
        key = np.maximum(nd, 0)
        f, t = feat[key], thr[key]
    else:
        f, t = feat[rows], thr[rows]
    byte = bins[f, rows].astype(np.int64)
    return np.where(nd >= 0, 2 * nd + (byte > t), -1)


def _emulate(bins, node, feat, thr, g, h, n_prev, kg, kh, by_node, limits):
    """``(left [2, n_prev, F, B] int64, new_node [n], plan)``: the kernel's
    descend and grouped digit scatter under :func:`_descend_plan`."""
    F, n = bins.shape
    plan = th._descend_plan(F, n, n_prev, B, limits)
    G, c = len(plan.groups), plan.cluster
    assert c in (1, 2) and G % c == 0
    assert c == 1 or plan.shared
    reserve = th._split_bytes(n_prev) + (th.CLUSTER_IDS_BYTES if c > 1
                                         else 0)
    assert plan.smem <= limits[1]
    if plan.shared:
        width = int((plan.groups[:, 1] - plan.groups[:, 0]).max())
        assert plan.smem == (th.TABLE_ENTRY_BYTES * width + reserve
                             + tbl.CELL_BYTES * int(plan.groups[:, 2].max()))
    assert plan.rows_per_chunk % 4 == 0
    assert plan.chunks * plan.rows_per_chunk >= n
    # -- the descend: per chunk and step, who descends and stores a quad ---
    new_node = np.full(n, -7, np.int64)
    stores = np.zeros(n, np.int64)
    step = 4 * th.STEP_QUADS
    ids = {}                # (block, step) -> left-child ids it reads
    for chunk in range(plan.chunks):
        r0 = chunk * plan.rows_per_chunk
        r1 = min(n, r0 + plan.rows_per_chunk)
        for s, s0 in enumerate(range(r0, r1, step)):
            q = np.arange(th.STEP_QUADS)
            rows = s0 + 4 * q[:, None] + np.arange(4)       # [quads, 4]
            inside = rows < r1
            for grp in range(G):
                first = grp - grp % c           # the cluster's rank 0
                if c > 1:
                    # rank q // share of this block's cluster descended
                    # quad q into its half of the two-step buffer (parity
                    # s % 2); each rank a contiguous share of the quads
                    share = -(-th.STEP_QUADS // c)
                    assert share <= th.ACCUM_THREADS
                    owner = first + q // share
                    assert (owner // c == grp // c).all()
                    stored = grp < c            # the first cluster stores
                    mine = q // share == grp % c   # this block's own quads
                else:
                    stored, mine = grp == 0, np.ones_like(q, bool)
                if stored:
                    sel = rows[mine][inside[mine]]
                    new_node[sel] = _descend_rows(bins, node, feat, thr,
                                                  by_node, n_prev, sel)
                    stores[sel] += 1
                nn = np.full(rows.shape, -1, np.int64)
                nn[inside] = _descend_rows(bins, node, feat, thr, by_node,
                                           n_prev, rows[inside])
                ids[(grp, chunk, s)] = np.where(
                    (nn >= 0) & (nn % 2 == 0) & (nn >> 1 < n_prev), nn >> 1,
                    -1)
    assert (stores == 1).all()
    # -- the accumulation over the ids each block read --------------------
    q_all = [th._quantize(torch.from_numpy(a), k).numpy()
             for a, k in ((g, kg), (h, kh))]
    lim = 2 ** plan.qbits
    fits = ((q_all[0] >= -lim) & (q_all[0] < lim) & (q_all[1] >= -lim)
            & (q_all[1] < lim))
    out = np.zeros((2, n_prev * F * B), np.uint64)
    for grp, (p0, p1, cells, _) in enumerate(plan.groups):
        for chunk in range(plan.chunks):
            r0 = chunk * plan.rows_per_chunk
            r1 = min(n, r0 + plan.rows_per_chunk)
            rr = np.arange(r0, r1)
            v = np.concatenate([ids[(grp, chunk, s)].reshape(-1)
                                for s in range(len(range(r0, r1, step)))])
            v = v[:len(rr)]
            keep = v >= 0
            rr, v = rr[keep], v[keep]
            fast = fits[rr] if plan.shared else np.zeros(len(rr), bool)
            lo = np.zeros((2, max(cells, 1)), np.int64)
            hi = np.zeros((2, max(cells, 1)), np.int64)
            for p in range(p0, p1):
                off = plan.rows[p, 3]
                b = bins[p, rr].astype(np.int64)
                for k in range(2):
                    q = q_all[k][rr]
                    cell = off + v * (B + 1) + b
                    np.add.at(lo[k], cell[fast],
                              q[fast] & (2 ** plan.shift - 1))
                    np.add.at(hi[k], cell[fast], q[fast] >> plan.shift)
                    idx = (v * F + p) * B + b
                    np.add.at(out[k], idx[~fast], q[~fast].view(np.uint64))
            if not plan.shared:
                continue
            assert len(rr) <= 2 ** (32 - plan.shift)
            assert lo.min() >= 0 and lo.max() < 2 ** 32
            assert hi.min() >= -2 ** 31 and hi.max() < 2 ** 31
            val = (lo + (hi << plan.shift)).view(np.uint64)
            for p in range(p0, p1):
                off = plan.rows[p, 3]
                cc = np.arange(n_prev * (B + 1))
                nd, bin_ = cc // (B + 1), cc % (B + 1)
                ok = bin_ < B
                for k in range(2):
                    np.add.at(out[k], ((nd * F + p) * B + bin_)[ok],
                              val[k, off + cc][ok])
    left = out.view(np.int64).reshape(2, n_prev, F, B)
    return left, new_node.astype(np.int32), plan


def _plain(bins, node, feat, thr, g, h, n_prev, kg, kh, by_node):
    t = torch.from_numpy
    f = t(feat[:n_prev]) if by_node else t(feat)
    tt = t(thr[:n_prev]) if by_node else t(thr)
    seen = []

    def keep(acc):
        seen.append(acc.clone())
        return acc

    left, nn = th.fused_descend_plain(t(bins), t(node), f, tt, t(g), t(h),
                                      n_prev, B, kg, kh, by_node, sync=keep)
    return seen[0].reshape(2, n_prev, -1, B).numpy(), nn.numpy(), left


def _cases(F, n_prev):
    """Cards of every kind the plan takes at this level: the H100 (one
    group up to n_prev 16 at these widths) and small ones (several
    groups, with and without a cluster, and the global path)."""
    out = [H100]
    for per in (1, 2, 3):
        if per < F:
            out.append(_card(F, n_prev, per, True))
            out.append(_card(F, n_prev, per, False))
    out.append(_card(F, n_prev, 0, False))
    return out


@pytest.mark.parametrize("by_node", [True, False])
@pytest.mark.parametrize("n_prev", [1, 4, 16, 32])
def test_emulated_descend_equals_plain(n_prev, by_node):
    # past 2^15 rows a block takes more than one step of 4096 rows
    n, F = 40_000, 6
    bins, node, feat, thr, g, h = _level(n, F, n_prev, seed=n_prev,
                                         exact=False, past=not by_node)
    if not by_node:
        feat, thr = feat[np.maximum(node, 0) % len(feat)], \
            thr[np.maximum(node, 0) % len(thr)]
    kg, kh = th.hist_scales(torch.from_numpy(g), torch.from_numpy(h))
    kinds, steps = set(), set()
    for bump in (0, 12):
        want, want_nn, want_left = _plain(bins, node, feat, thr, g, h,
                                          n_prev, kg + bump, kh, by_node)
        for limits in _cases(F, n_prev):
            got, nn, plan = _emulate(bins, node, feat, thr, g, h, n_prev,
                                     kg + bump, kh, by_node, limits)
            np.testing.assert_array_equal(nn, want_nn)
            np.testing.assert_array_equal(got, want)
            kinds.add((plan.shared, len(plan.groups) > 1, plan.cluster > 1))
            steps.add(-(-plan.rows_per_chunk // (4 * th.STEP_QUADS)))
        # the dequantised sums are the plain version's bytes
        t = torch.from_numpy
        hist = torch.stack([th._dequantize(t(got[0]).reshape(-1), kg + bump),
                            th._dequantize(t(got[1]).reshape(-1), kh)])
        assert hist.numpy().tobytes() == want_left.numpy().tobytes()
    # one group, several without and with a cluster, and the global path
    # (at n_prev 1 the cluster's own ids would hold every feature's cells:
    # one group, no cluster)
    want_kinds = {(True, False, False), (True, True, False),
                  (False, False, False)}
    if n_prev > 1:
        want_kinds.add((True, True, True))
    assert want_kinds <= kinds
    assert max(steps) > 1


@pytest.mark.parametrize("n_prev", [1, 4, 16])
def test_emulated_descend_equals_jax_fused_kernel(n_prev):
    """Order-exact g/h: the emulation, on an H100 and on a card that
    clusters the groups, gives the Pallas kernel's bytes."""
    n, F = 3000, 6
    bins, node, feat, thr, g, h = _level(n, F, n_prev, seed=50 + n_prev,
                                         exact=True)
    feat, thr = feat[:n_prev], thr[:n_prev]
    safe = np.maximum(node, 0)
    hist_j, nn_j = jh._fused_pallas(
        jnp.asarray(bins), jnp.asarray(node), jnp.asarray(feat[safe]),
        jnp.asarray(thr[safe]), jnp.asarray(g), jnp.asarray(h), n_prev, B)
    kg, kh = th.hist_scales(torch.from_numpy(g), torch.from_numpy(h))
    t = torch.from_numpy
    pairs = _card(F, n_prev, 1, True)
    # six one-feature groups in pairs (at n_prev 1 the ids hold them all)
    assert th._descend_plan(F, n, n_prev, B, pairs).cluster == \
        (2 if n_prev > 1 else 1)
    for limits in (H100, pairs):
        for by_node, f_, t_ in ((True, feat, thr),
                                (False, feat[safe], thr[safe])):
            got, nn, plan = _emulate(bins, node, f_, t_, g, h, n_prev, kg,
                                     kh, by_node, limits)
            np.testing.assert_array_equal(nn, np.asarray(nn_j))
            hist = torch.stack([th._dequantize(t(got[0]).reshape(-1), kg),
                                th._dequantize(t(got[1]).reshape(-1), kh)])
            np.testing.assert_array_equal(
                hist.numpy().reshape(2, n_prev, F, B).view(np.uint32),
                np.asarray(hist_j).view(np.uint32))


def test_flagship_plans_on_the_h100():
    """10M × 28 × 256: one group at n_prev 1 and 2, every group's block
    descending at 4 and 8 (2 and 4 groups; with the cluster's ids 3 and 5,
    no pairs), pairs of groups in a cluster at 16 and 32, and the global
    path from 64; every block within the card's shared memory and its
    digit sums in range; groups balanced."""
    n = 10_000_000
    for n_prev, groups, c in ((1, 1, 1), (2, 1, 1), (4, 2, 1), (8, 4, 1),
                              (16, 10, 2), (32, 28, 2), (64, 1, 1),
                              (2048, 1, 1)):
        plan = th._descend_plan(28, n, n_prev, 256, H100)
        assert (len(plan.groups), plan.cluster) == (groups, c)
        assert plan.smem <= H100[1]
        assert plan.shared == (n_prev < 64)
        if plan.shared:
            assert plan.rows_per_chunk <= 2 ** (32 - plan.shift)
        sizes = plan.groups[:, 1] - plan.groups[:, 0]
        assert sizes.max() - sizes.min() <= 1
