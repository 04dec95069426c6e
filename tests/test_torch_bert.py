"""The port's BERT (``dmlc_core_tpu_torch/models/bert.py``) against the JAX
package's, on the CPU at the tiny configuration of
``tests/test_bert_ring.py``.

Held: initial weights bit-equal from the same seed; three steps from the
same weights with losses within rtol 2e-3 and every parameter within
1e-3 after (f32 products summed in other orders, and the bf16 residual
stream rounds at the same points but can flip a last bit); model files
byte-equal for the same weights and loading in either package; the
chunked loop equal to per-step calls.  JAX runs on a one-device mesh:
its ``data`` axis alone (``local_mesh(1)``: the ``local_attention`` path
the port mirrors) and the bench's ``create_mesh(MeshSpec(data=1))``,
whose size-1 ``seq`` axis takes ``ring_attention`` instead.
"""

import os

import numpy as np
import pytest
import torch

import jax

from dmlc_core_tpu.models.bert import BERT as JaxBERT
from dmlc_core_tpu.models.bert import BERTParam as JaxBERTParam
from dmlc_core_tpu.models.checkpoint import gather_tree
from dmlc_core_tpu.parallel.mesh import MeshSpec, create_mesh, local_mesh
from dmlc_core_tpu_torch.base.logging import Error
from dmlc_core_tpu_torch.models import BERT, BERTParam
from dmlc_core_tpu_torch.ops import attention as ta
from dmlc_core_tpu_torch.parallel.mesh import Mesh

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

TINY = dict(n_layers=2, d_model=32, n_heads=4, d_ff=64, vocab_size=64,
            max_len=32, learning_rate=0.1)
STEPS = 3
LOSS_RTOL = 2e-3
PARAM_ATOL = 1e-3
MESHES = {"local": lambda: local_mesh(1),
          "create_mesh": lambda: create_mesh(MeshSpec(data=1),
                                             devices=jax.devices()[:1])}


def _batch(B=4, S=32, V=64, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, size=(B, S))
    mask = (rng.uniform(size=(B, S)) < 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    return tokens, tokens.copy(), mask


def _port(**kw):
    return BERT(device="cpu", **{**TINY, **kw})


def _host(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


@pytest.fixture(scope="module", params=sorted(MESHES))
def jax_run(request, tmp_path_factory):
    """One JAX model from seed 0: its initial weights and file, the losses
    of ``STEPS`` steps, the weights, momentum and file after them, and
    the loss of the step after that."""
    d = tmp_path_factory.mktemp(f"jax_{request.param}")
    model = JaxBERT(mesh=MESHES[request.param](), **TINY)
    model.init_params(0)
    run = {"mesh": request.param, "init": gather_tree(model.params),
           "init_file": str(d / "init.bin"), "after_file": str(d / "after.bin")}
    model.save_model(run["init_file"])
    batch = _batch()
    run["losses"] = [model.train_step(*batch) for _ in range(STEPS)]
    run["params"] = gather_tree(model.params)
    run["opt_state"] = gather_tree(model.opt_state)
    model.save_model(run["after_file"])
    run["next_loss"] = model.train_step(*batch)
    return run


def test_param_dict_is_jax_s():
    assert BERTParam().to_dict() == JaxBERTParam().to_dict()
    assert (BERTParam(**TINY).to_dict()
            == JaxBERTParam(**TINY).to_dict())


@pytest.mark.parametrize("seed", [0, 7])
def test_init_params_bit_equal(seed):
    jm = JaxBERT(mesh=local_mesh(1), **TINY)
    jm.init_params(seed)
    want = gather_tree(jm.params)
    model = _port()
    model.init_params(seed)
    got = _host(model.params)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
    assert all(not v.any() for v in _host(model.opt_state).values())


def test_steps_match_jax(jax_run):
    model = _port()
    model.params_from_numpy(jax_run["init"])
    losses = [model.train_step(*_batch()) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    got = _host(model.params)
    for k, want in jax_run["params"].items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    # momentum moves the weights by lr times itself: held at that scale
    got = _host(model.opt_state)
    for k, want in jax_run["opt_state"].items():
        np.testing.assert_allclose(got[k], want, rtol=0,
                                   atol=PARAM_ATOL / TINY["learning_rate"],
                                   err_msg=k)


def test_save_model_bytes_equal_jax_s_before_any_step(jax_run, tmp_path):
    model = _port()
    model.params_from_numpy(jax_run["init"])
    path = str(tmp_path / "port.bin")
    model.save_model(path)
    with open(path, "rb") as f, open(jax_run["init_file"], "rb") as g:
        assert f.read() == g.read()


def test_port_loads_jax_s_file_after_steps(jax_run):
    model = BERT.load_model(jax_run["after_file"], device="cpu")
    assert model.param.to_dict() == BERTParam(**TINY).to_dict()
    for tree, want in ((model.params, jax_run["params"]),
                       (model.opt_state, jax_run["opt_state"])):
        got = _host(tree)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
    loss = model.train_step(*_batch())
    np.testing.assert_allclose(loss, jax_run["next_loss"], rtol=LOSS_RTOL)


def test_jax_loads_the_port_s_file_after_steps(jax_run, tmp_path):
    model = _port()
    model.params_from_numpy(jax_run["params"], jax_run["opt_state"])
    path = str(tmp_path / "port.bin")
    model.save_model(path)
    jm = JaxBERT.load_model(path, mesh=local_mesh(1))
    got = gather_tree(jm.params)
    for k, want in jax_run["params"].items():
        assert got[k].tobytes() == want.tobytes(), k
    loss = model.train_step(*_batch())
    np.testing.assert_allclose(jm.train_step(*_batch()), loss,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, jax_run["next_loss"], rtol=LOSS_RTOL)


def test_round_trip_through_the_port_is_exact(tmp_path):
    model = _port()
    model.init_params(3)
    batch = _batch(seed=1)
    model.train_step(*batch)
    path = str(tmp_path / "m.bin")
    model.save_model(path)
    again = BERT.load_model(path, device="cpu")
    for a, b in ((model.params, again.params),
                 (model.opt_state, again.opt_state)):
        assert list(a) == list(b)
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert model.train_step(*batch) == again.train_step(*batch)


@pytest.mark.parametrize("chunk,warmup", [(2, 1), (3, 0)])
def test_fit_chunked_equals_per_step_calls(chunk, warmup):
    batch = _batch(seed=2)
    a, b = _port(), _port()
    a.init_params(1)
    b.init_params(1)
    n_steps = 2 * chunk
    loss, secs, times = a.fit_chunked(*batch, n_steps=n_steps, chunk=chunk,
                                      warmup_chunks=warmup)
    per_step = [b.train_step(*batch)
                for _ in range(n_steps + chunk * max(warmup, 1))]
    assert loss == per_step[-1]
    assert [n for n, _ in times] == [chunk, 2 * chunk]
    assert secs >= times[-1][1] >= times[0][1] >= 0.0
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.opt_state[k], b.opt_state[k]), k


def test_fit_returns_the_last_loss():
    batch = _batch(seed=3)
    a, b = _port(), _port()
    a.init_params(2)
    b.init_params(2)
    loss, secs = a.fit(*batch, n_steps=2, warmup=1)
    assert loss == [b.train_step(*batch) for _ in range(3)][-1]
    assert secs >= 0.0


def test_cpu_training_launches_no_kernel():
    for fn in (ta.flash_fwd_kernel, ta.flash_bwd_dkv_kernel,
               ta.flash_bwd_dq_kernel):
        fn.launches = 0
    model = _port()
    model.init_params(0)
    model.train_step(*_batch())
    assert (ta.flash_fwd_kernel.launches, ta.flash_bwd_dkv_kernel.launches,
            ta.flash_bwd_dq_kernel.launches) == (0, 0, 0)


class _TwoRanks(Mesh):
    size = 2


@pytest.mark.parametrize("kw,match", [
    ({"ffn_type": "moe"}, "moe"),
    ({"grad_sync": "kvstore"}, "kvstore"),
])
def test_constructor_refuses_what_waits(kw, match):
    with pytest.raises(Error, match=match):
        _port(**kw)


def test_constructor_refuses_a_world_above_one():
    with pytest.raises(Error, match="world of 2"):
        BERT(mesh=_TwoRanks(), device="cpu", **TINY)
    assert BERT(mesh=Mesh(), device="cpu", **TINY).mesh.size == 1


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Error, match="no CUDA GPU"):
        BERT(**TINY)


@pytest.mark.parametrize("bad", ["long", "token", "label", "negative"])
def test_train_step_host_checks(bad):
    model = _port()
    model.init_params(0)
    tokens, labels, mask = _batch()
    if bad == "long":
        tokens = np.zeros((1, TINY["max_len"] + 1), np.int64)
        labels, mask = tokens.copy(), np.ones(tokens.shape, np.float32)
        match = "exceeds max_len"
    elif bad == "token":
        tokens[0, 0] = TINY["vocab_size"]
        match = "token id out of vocab"
    elif bad == "label":
        labels[1, 2] = TINY["vocab_size"] + 5
        match = "label id out of vocab"
    else:
        tokens[0, 1] = -1
        match = "token id out of vocab"
    with pytest.raises(Error, match=match):
        model.train_step(tokens, labels, mask)
    with pytest.raises(Error, match=match):
        model.fit_chunked(tokens, labels, mask, n_steps=1, chunk=1)


def test_params_from_numpy_checks_names_and_shapes():
    model = _port()
    model.init_params(0)
    host = _host(model.params)
    bad = dict(host)
    bad.pop("l1.w2")
    with pytest.raises(Error, match="names"):
        model.params_from_numpy(bad)
    bad = dict(host, **{"l0.wqkv": np.zeros((3, 32, 32), np.float32)})
    with pytest.raises(Error, match="shape"):
        model.params_from_numpy(bad)


def test_file_is_not_another_model_s(tmp_path):
    path = os.path.join(str(tmp_path), "x.bin")
    with open(path, "wb") as f:
        f.write(b"DCTGBT01" + b"\0" * 32)
    with pytest.raises(Error, match="magic"):
        BERT.load_model(path, device="cpu")
