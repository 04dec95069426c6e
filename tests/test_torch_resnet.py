"""``ResNet`` / ``ResNetTrainer`` (``models/resnet.py``) and the image
records (``data/image_record.py``) in the port, against the JAX package,
on the CPU.

Tolerances:

* image records: bit-exact — the packed bytes, the unpacked arrays and
  every batch of ``batch_iterator`` over 3 shards, ``nparts`` 1-3,
  ``drop_last`` both ways, with and without a shuffle buffer;
* the forward pass in f32 against flax with the weights carried by
  ``params_from_numpy``: logits and the updated ``batch_stats`` within
  atol 1e-5 + rtol 1e-5 (f32 sums in two orders over a few thousand
  terms); 32×32 and 33×33 inputs pin XLA's ``SAME`` pads on even and odd
  sides, and BN scales and statistics are perturbed so that no branch
  hides behind a zero scale;
* three trainer steps from the same weights on the same batches: in f32,
  losses and accuracies within rtol 1e-5 and every parameter within
  atol 1e-5 of JAX's; in bf16 (the default), losses within rtol 5e-3 and
  the parameter updates within 25% of JAX's in global norm and no
  further from JAX's bf16 updates than 1.5× the distance between JAX's
  own bf16 and f32 runs — bf16 rounds at other places in XLA's and
  PyTorch's CPU convolutions, and that distance is the size of bf16's own
  noise on this model;
* the optimizer and the loss: ``torch.optim.SGD(weight_decay=)`` against
  ``optax.chain(add_decayed_weights, sgd)`` and
  ``F.cross_entropy(label_smoothing=)`` against ``optax.smooth_labels``
  + ``softmax_cross_entropy`` within rtol 1e-6;
* two gloo ranks, each with half of a global batch (BN statistics summed
  over the ranks), against JAX's one-device step on the whole batch, f32:
  losses rtol 1e-5 and parameters atol 2e-5.

``tests/test_resnet_feed.py`` is loaded against the port as well
(``*_port``): ``TestImageRecord``, ``TestResNet`` (its two slow tests
kept slow; the flax ``init``/``apply`` calls of the shapes test stand for
the port's module call).  Left out: ``TestDeviceFeed`` (JAX shardings;
the port's feed is held by ``tests/test_torch_ingest.py``).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from dmlc_core_tpu.data import image_record as jrec  # noqa: E402
from dmlc_core_tpu.io.recordio import RecordIOWriter as JWriter  # noqa: E402
from dmlc_core_tpu.models import resnet as jres  # noqa: E402
from dmlc_core_tpu.parallel.mesh import local_mesh as jlocal_mesh  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.data import image_record as trec  # noqa: E402
from dmlc_core_tpu_torch.models import resnet as tres  # noqa: E402
from dmlc_core_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from _torch_suites import export, load_port, on_cpu  # noqa: E402,F401

torch.set_num_threads(2)

_SUITE = load_port("test_resnet_feed.py", [
    ("        variables = m.init(jax.random.key(0), x, train=False)\n"
     "        logits = m.apply(variables, x, train=False)\n",
     "        logits = m(torch.from_numpy(x), train=False)\n"),
    ("assert logits.dtype == np.float32",
     "assert logits.dtype == torch.float32"),
    ("import jax\n", "import jax\nimport torch\n")])
export(globals(), _SUITE, ["TestImageRecord", "TestResNet"])


@pytest.fixture(autouse=True)
def _port_on_cpu(on_cpu):
    # every test here asks for the CPU; test_trainer_needs_a_gpu undoes it
    yield


# ---------------------------------------------------------------------------
# image records
# ---------------------------------------------------------------------------

def _images(n, shape=(6, 5, 3), seed=0):
    rng = np.random.default_rng(seed)
    return ([rng.integers(0, 256, size=shape, dtype=np.uint8)
             for _ in range(n)],
            rng.integers(0, 1000, size=n).astype(np.float32))


def test_pack_is_bytes_of_jax_and_unpack_equal():
    imgs, labels = _images(7)
    for i, (img, lab) in enumerate(zip(imgs, labels)):
        for flag in (0, 3):
            want = jrec.pack_image_record(img, lab, record_id=2 ** 40 + i,
                                          flag=flag)
            got = trec.pack_image_record(img, lab, record_id=2 ** 40 + i,
                                         flag=flag)
            assert got == want
        rec = trec.pack_image_record(img, lab, record_id=i)
        a, b = trec.unpack_image_record(rec), jrec.unpack_image_record(rec)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
    enc = trec.pack_image_record(imgs[0], 3.0, flag=1)

    def decoder(payload, shape):
        return np.frombuffer(payload, np.uint8).reshape(shape)[::-1]

    np.testing.assert_array_equal(
        trec.unpack_image_record(enc, decoder)[0],
        jrec.unpack_image_record(enc, decoder)[0])
    with pytest.raises(Error):
        trec.unpack_image_record(enc)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("img_shards")
    imgs, labels = _images(3 * 23, shape=(4, 4, 3), seed=5)
    for s in range(3):
        with JWriter(str(root / f"part-{s}.rec")) as w:
            for k in range(23):
                i = s * 23 + k
                w.write_record(jrec.pack_image_record(imgs[i], labels[i],
                                                      record_id=i))
    return str(root / "part-*.rec")


@pytest.mark.parametrize("nparts", [1, 2, 3])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle_buffer", [0, 16])
def test_batch_iterator_equals_jax(shards, nparts, drop_last,
                                   shuffle_buffer):
    for part in range(nparts):
        kw = dict(drop_last=drop_last, shuffle_buffer=shuffle_buffer,
                  seed=11)
        want = list(jrec.batch_iterator(shards, part, nparts, 5, (4, 4, 3),
                                        **kw))
        got = list(trec.batch_iterator(shards, part, nparts, 5, (4, 4, 3),
                                       **kw))
        assert len(got) == len(want) > 0
        for (gi, gl), (wi, wl) in zip(got, want):
            assert gi.dtype == wi.dtype and gl.dtype == wl.dtype
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


# ---------------------------------------------------------------------------
# the model against flax
# ---------------------------------------------------------------------------

def _flax_vars(bottleneck, hw, seed=1, perturb=True):
    m = jres.ResNet(stage_sizes=(1, 1), bottleneck=bottleneck,
                    num_classes=5, num_filters=8, dtype=jnp.float32)
    x0 = np.zeros((1, hw, hw, 3), np.uint8)
    v = jax.tree_util.tree_map(
        np.asarray, m.init(jax.random.key(seed), x0, train=True))
    if perturb:
        rng = np.random.default_rng(seed)
        v = jax.tree_util.tree_map(
            lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
            v)
        v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    return m, v


def _port_trainer(bottleneck, dtype=torch.float32, **kw):
    t = tres.ResNetTrainer(device="cpu", dtype=dtype, variant="resnet-micro",
                           num_classes=5, **kw)
    t.stages, t.bottleneck = (1, 1), bottleneck
    t.model = tres.ResNet((1, 1), bottleneck, 5, 8, dtype)
    return t


@pytest.mark.parametrize("bottleneck", [False, True])
@pytest.mark.parametrize("hw", [32, 33])
@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_flax(bottleneck, hw, train):
    m, v = _flax_vars(bottleneck, hw)
    x = np.random.default_rng(hw).integers(0, 256, size=(4, hw, hw, 3),
                                           dtype=np.uint8)
    t = _port_trainer(bottleneck)
    t.params_from_numpy(v["params"], v["batch_stats"])
    with torch.no_grad():
        got = t.model(torch.from_numpy(x), train=train)
    assert got.dtype == torch.float32 and got.shape == (4, 5)
    if train:
        want, upd = m.apply(v, x, train=True, mutable=["batch_stats"])
        _, stats = t.numpy_params()
        flat_w = jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, upd["batch_stats"]))
        flat_g = jax.tree_util.tree_leaves(stats)
        assert len(flat_w) == len(flat_g)
        for (path, w), g in zip(flat_w, flat_g):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))
    else:
        want = m.apply(v, x, train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_same_pads_are_xlas():
    from jax import lax

    for size in range(1, 40):
        for k, s in ((7, 2), (3, 2), (3, 1), (1, 2), (1, 1)):
            want = lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
            assert tuple(tres.same_pads(size, k, s)) == tuple(want)


@pytest.mark.parametrize("hw", [32, 33])
def test_train_step_flops_counts_each_layer(hw):
    """``tools/bench_resnet_feed.train_step_flops`` on a basic (1, 1)
    model with 8 filters against the sum written out layer by layer:
    2·Cin·Cout·k²·Ho·Wo a convolution, 2·in·out the head, ×3 for the
    step less the stem's input gradient (exact: integer counts)."""
    from dmlc_core_tpu_torch.tools.bench_resnet_feed import train_step_flops

    model = tres.ResNet((1, 1), False, 10, 8, torch.float32,
                        generator=torch.Generator().manual_seed(0))
    s1 = -(-hw // 2)                  # the stem's SAME output side
    s2 = -(-s1 // 2)                  # after the max-pool
    s3 = -(-s2 // 2)                  # stage 2, stride 2
    stem = 2 * 3 * 8 * 49 * s1 * s1
    fwd = (stem
           + 2 * (2 * 8 * 8 * 9 * s2 * s2)                  # stage 1
           + 2 * 8 * 16 * 9 * s3 * s3 + 2 * 16 * 16 * 9 * s3 * s3
           + 2 * 8 * 16 * s3 * s3                           # projection
           + 2 * 16 * 10)                                   # head
    assert train_step_flops(model, (hw, hw, 3), 4) == 4 * (3 * fwd - stem)


def test_running_var_is_biased_and_init_leaves_stats():
    t = _port_trainer(False)
    t.init((8, 8, 3), seed=0)
    for name, buf in t.model.named_buffers():
        want = torch.zeros_like(buf) if name.endswith("mean") else \
            torch.ones_like(buf)
        assert torch.equal(buf, want), name
    bn = tres.BatchNorm(3)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 3, 4, 4)).astype(np.float32))
    bn(x, train=True)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.var, 0.9 + 0.1 * biased, rtol=1e-6,
                               atol=1e-6)
    zero_scale = [n for n, p in t.model.named_parameters()
                  if n.endswith("BatchNorm_1.scale")]
    assert zero_scale and all(
        not dict(t.model.named_parameters())[n].any() for n in zero_scale)


# ---------------------------------------------------------------------------
# the step: optimizer, loss, three steps against JAX's trainer
# ---------------------------------------------------------------------------

def test_sgd_with_decay_is_optax_chain():
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(3)]
    tx = optax.chain(optax.add_decayed_weights(1e-2),
                     optax.sgd(0.1, momentum=0.9))
    pj = jnp.asarray(p0)
    st = tx.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.SGD([pt], lr=0.1, momentum=0.9, weight_decay=1e-2)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj),
                                   rtol=1e-6, atol=1e-7)


def test_smoothed_cross_entropy_is_optax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(9, 6)).astype(np.float32) * 3
    labels = rng.integers(0, 6, size=9)
    want = optax.softmax_cross_entropy(
        jnp.asarray(logits),
        optax.smooth_labels(jax.nn.one_hot(labels, 6), 0.1)).mean()
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          label_smoothing=0.1)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _jax_trainer(dtype, bottleneck, **kw):
    t = jres.ResNetTrainer(variant="resnet-micro", num_classes=5,
                           mesh=jlocal_mesh(1), **kw)
    t.model = jres.ResNet(stage_sizes=(1, 1), bottleneck=bottleneck,
                          num_classes=5, num_filters=8, dtype=dtype)
    t.init((16, 16, 3), seed=0)
    return t


def _batches(n_steps, batch, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, size=(batch, 16, 16, 3), dtype=np.uint8),
             rng.integers(0, 5, size=batch).astype(np.int32))
            for _ in range(n_steps)]


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_jax(jt, batches):
    out = []
    for x, y in batches:
        loss, acc = jt.train_step(jnp.asarray(x), jnp.asarray(y))
        out.append((float(loss), float(acc)))
    return out


def _run_port(pt, batches):
    out = []
    for x, y in batches:
        loss, acc = pt.train_step(torch.from_numpy(x), torch.from_numpy(y))
        out.append((float(loss), float(acc)))
    return out


def _global_rel(a, b, base):
    """||(a − base) − (b − base)|| / ||a − base|| over every leaf."""
    la, lb, l0 = (jax.tree_util.tree_leaves(t) for t in (a, b, base))
    num = sum(float(np.sum((x - y) ** 2)) for x, y in zip(la, lb))
    den = sum(float(np.sum((x - z) ** 2)) for x, z in zip(la, l0))
    return (num / den) ** 0.5


@pytest.mark.parametrize("bottleneck", [False, True])
def test_three_f32_steps_match_jax(bottleneck):
    jt = _jax_trainer(jnp.float32, bottleneck, learning_rate=0.05)
    pt = _port_trainer(bottleneck, learning_rate=0.05)
    pt.params_from_numpy(_tree_np(jt.state["params"]),
                         _tree_np(jt.state["batch_stats"]))
    batches = _batches(3, 8)
    want, got = _run_jax(jt, batches), _run_port(pt, batches)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    params, stats = pt.numpy_params()
    for tree_g, tree_w in ((params, jt.state["params"]),
                           (stats, jt.state["batch_stats"])):
        for g, w in zip(jax.tree_util.tree_leaves(tree_g),
                        jax.tree_util.tree_leaves(_tree_np(tree_w))):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_three_bf16_steps_match_jax():
    jb = _jax_trainer(jnp.bfloat16, False, learning_rate=0.05)
    jf = _jax_trainer(jnp.float32, False, learning_rate=0.05)
    p0 = _tree_np(jb.state["params"])
    pt = tres.ResNetTrainer(device="cpu", variant="resnet-micro",
                            num_classes=5, learning_rate=0.05)
    assert pt.dtype == torch.bfloat16
    pt.stages, pt.bottleneck = (1, 1), False
    pt.model = tres.ResNet((1, 1), False, 5, 8)
    pt.params_from_numpy(p0, _tree_np(jb.state["batch_stats"]))
    batches = _batches(3, 16)
    want = _run_jax(jb, batches)
    _run_jax(jf, batches)
    got = _run_port(pt, batches)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=5e-3)
    assert all(0.0 <= g[1] <= 1.0 for g in got)
    jbp, jfp = _tree_np(jb.state["params"]), _tree_np(jf.state["params"])
    port = pt.numpy_params()[0]
    d_port = _global_rel(jbp, port, p0)
    d_noise = _global_rel(jbp, jfp, p0)
    assert d_port <= 0.25 and d_port <= 1.5 * d_noise, (d_port, d_noise)


def test_trainer_needs_a_gpu(monkeypatch):
    monkeypatch.undo()            # the CPU default of the fixtures
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Error, match="no CUDA GPU"):
        tres.ResNetTrainer()
    with pytest.raises(Error, match="no CUDA GPU"):
        tres.ResNetTrainer(variant="resnet-micro", device="cuda")
    assert tres.ResNetTrainer(device="cpu").device.type == "cpu"


def test_fit_from_records_counts_and_learns(tmp_path):
    path = str(tmp_path / "train.rec")
    rng = np.random.default_rng(3)
    with JWriter(path) as w:
        for i in range(96):
            label = i % 4
            img = np.clip(rng.normal(label * 60 + 30, 10, size=(8, 8, 3)),
                          0, 255).astype(np.uint8)
            w.write_record(jrec.pack_image_record(img, label))
    tr = tres.ResNetTrainer(device="cpu", variant="resnet-micro",
                            num_classes=4, learning_rate=0.05)
    first = tr.fit_from_records(path, batch_size=16, image_shape=(8, 8, 3))
    for _ in range(2):
        stats = tr.fit_from_records(path, batch_size=16,
                                    image_shape=(8, 8, 3))
    assert set(stats) == {"steps", "records", "records_per_sec",
                          "last_loss", "infeed_stall_fraction", "seconds"}
    assert stats["steps"] == 6 and stats["records"] == 96
    assert 0.0 <= stats["infeed_stall_fraction"] <= 1.0
    assert stats["last_loss"] < first["last_loss"]


# ---------------------------------------------------------------------------
# two gloo ranks: global-batch BN and gradient against JAX's one device
# ---------------------------------------------------------------------------

_RANK = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from dmlc_core_tpu_torch.models.resnet import ResNet, ResNetTrainer
from dmlc_core_tpu_torch.parallel import collectives as coll
from dmlc_core_tpu_torch.parallel.mesh import local_mesh
coll.init(backend="gloo")
r, world = coll.rank(), coll.world_size()
d = np.load(sys.argv[1])
def nest(prefix):
    out = {}
    for k in d.files:
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = d[k]
    return out
mesh = local_mesh()
t = ResNetTrainer(mesh=mesh, device="cpu", dtype=torch.float32,
                  variant="resnet-micro", num_classes=5, learning_rate=0.05)
t.model = ResNet((1, 1), False, 5, 8, torch.float32, mesh=mesh)
t.params_from_numpy(nest("params/"), nest("stats/"))
x, y = d["x"], d["y"]
half = x.shape[1] // world
out = {"steps": []}
for s in range(x.shape[0]):
    sl = slice(r * half, (r + 1) * half)
    loss, acc = t.train_step(torch.from_numpy(x[s, sl]),
                             torch.from_numpy(y[s, sl]))
    out["steps"].append([float(loss), float(acc)])
params, stats = t.numpy_params()
flat = {}
def flatten(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            flatten(v, prefix + k + "/")
        else:
            flat[prefix + k] = v
flatten(params, "params/")
flatten(stats, "stats/")
np.savez(f"{sys.argv[2]}/rank{r}.npz", **flat)
out["fit"] = t.fit_from_records(sys.argv[3], batch_size=8,
                                image_shape=(16, 16, 3))
with open(f"{sys.argv[2]}/rank{r}.json", "w") as f:
    json.dump(out, f)
coll.finalize()
"""


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, prefix + k + "/", out)
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_two_ranks_match_jax_one_device_global_batch(tmp_path):
    jt = _jax_trainer(jnp.float32, False, learning_rate=0.05)
    flat = _flatten(_tree_np(jt.state["params"]), "params/", {})
    _flatten(_tree_np(jt.state["batch_stats"]), "stats/", flat)
    batches = _batches(2, 8, seed=4)
    flat["x"] = np.stack([b[0] for b in batches])
    flat["y"] = np.stack([b[1] for b in batches])
    np.savez(tmp_path / "init.npz", **flat)
    rec = str(tmp_path / "img.rec")
    with JWriter(rec) as w:
        for i in range(21):
            w.write_record(jrec.pack_image_record(flat["x"][0, i % 8], i % 5))
    want = _run_jax(jt, batches)
    run_ranks([sys.executable, "-c", _RANK, str(tmp_path / "init.npz"),
               str(tmp_path), rec], 2, 240, tmp_path)
    wparams = _flatten(_tree_np(jt.state["params"]), "params/", {})
    _flatten(_tree_np(jt.state["batch_stats"]), "stats/", wparams)
    outs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for r in range(2):
        np.testing.assert_allclose(outs[r]["steps"], want, rtol=1e-5,
                                   atol=1e-6)
        assert set(got[r].files) == set(wparams)
        for k in wparams:
            np.testing.assert_allclose(got[r][k], wparams[k], rtol=1e-5,
                                       atol=2e-5, err_msg=k)
            np.testing.assert_array_equal(got[r][k], got[0][k])
        # 21 records, 2 ranks × 4 a step: ranks read 11 and 10 records,
        # so both stop after the 2 steps the shorter one can fill
        fit = outs[r]["fit"]
        assert fit["steps"] == 2 and fit["records"] == 16
        assert np.isfinite(fit["last_loss"])
