"""BERT masked-LM trainer on a mesh of GPUs (PyTorch port).

The counterpart of ``dmlc_core_tpu/models/bert.py``: the same
``BERTParam`` (fields, defaults and enums), the same initial weights from
the same seed, the same forward and optimizer step, and model files that
load in either package.  One process per GPU; each rank holds its blocks
of the parameters and of the batch, and every collective is an explicit
call on a mesh axis (``parallel/collectives.py``):

* ``data`` — the batch split; the gradient sync either **fused** (a psum
  in the step, then SGD with momentum) or through the port's
  ``KVStore("dist_sync")`` over the ``data`` axis (each rank pushes its
  own gradients and pulls the SGD-updated values).
* ``model`` — Megatron tensor parallelism: attention heads and the FFN's
  hidden dimension split; *f*
  (:func:`~dmlc_core_tpu_torch.parallel.collectives.replicate_fwd_psum_bwd`)
  where the replicated stream enters a split block, *g*
  (:func:`~dmlc_core_tpu_torch.parallel.collectives.psum_fwd_identity_bwd`)
  where it leaves.
* ``seq`` — the tokens split; exact attention by ring rotation
  (:func:`~dmlc_core_tpu_torch.parallel.ring_attention.ring_attention`)
  or two all-to-alls around the flash kernels
  (:func:`~dmlc_core_tpu_torch.parallel.ulysses.ulysses_attention`),
  by ``sp_method``; position embeddings offset by the block's place.
* ``expert`` — the Switch-MoE FFN (``ffn_type="moe"``;
  :func:`~dmlc_core_tpu_torch.parallel.moe.moe_ffn`), experts split over
  the axis, which also splits the batch (data × expert).

On :func:`~dmlc_core_tpu_torch.parallel.mesh.local_mesh` (the ``data``
axis alone) attention is :func:`~dmlc_core_tpu_torch.ops.attention.
local_attention`: the CUDA flash kernels on the card, the dense f32 oracle
on the CPU.  A mesh that names ``seq`` (``create_mesh`` names all five
axes, size one or not) takes the sequence-parallel attention, as JAX's
does.

The parameters are a flat dict under the JAX package's names and shapes
(``"l3.wqkv"`` ``[3, D, H, Dh]``, ``"l3.wo"`` ``[H, Dh, D]``, …), each
rank's block by ``_param_specs`` (JAX's ``PartitionSpec``\\ s): f32
master weights on the device.  The forward follows ``_local_loss``'s cast
points — the embedding sum in f32, the residual stream in bf16, the norms
in f32 with population variance and ``eps=1e-6``, the QKV product in f32
cast to bf16 for attention, the output projection, FFN (tanh GELU), final
norm, logits and ``log_softmax`` in f32.  The step divides the gradients
by the global token count (over the batch axes and ``seq``), psums them
over ``seq``, then (fused) over the batch axes — expert-split weights over
``data`` only, their ``expert`` contributions having come through the
all-to-all's backward — and runs ``m = 0.9·m + g``, ``p −= lr·m``.  The
f32 products run in full f32 (TF32 is never enabled here).

*g* is a psum forward and the identity backward, as Megatron's *g* is
and as the JAX package's own comment describes it.  The JAX package
writes it as ``lax.psum``, whose transpose under its ``shard_map
(check_vma=False)`` is a psum, so there every split branch's gradient is
``model``-size times too large (ROADMAP C14): on a mesh with a ``model``
axis this port trains as JAX's one-device model does, not as JAX's
sharded one.

``train_step`` and ``fit`` take the GLOBAL ``[B, S]`` batch on every rank;
each rank keeps its block.  ``save_model`` gathers the blocks into the
JAX package's file; ``load_model(uri, mesh=)`` splits them again.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from dmlc_core_tpu_torch.base.logging import CHECK, CHECK_EQ
from dmlc_core_tpu_torch.base.parameter import Parameter, field
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.ops.attention import local_attention
from dmlc_core_tpu_torch.parallel.collectives import (
    psum, psum_fwd_identity_bwd, replicate_fwd_psum_bwd)
from dmlc_core_tpu_torch.parallel.mesh import (
    Mesh, gather_block, local_block, local_mesh)
from dmlc_core_tpu_torch.parallel.moe import moe_ffn
from dmlc_core_tpu_torch.parallel.ring_attention import ring_attention
from dmlc_core_tpu_torch.parallel.ulysses import ulysses_attention
from dmlc_core_tpu_torch.utils.device import resolve_device

__all__ = ["BERT", "BERTParam"]

_EXPERT_KEYS = (".we1", ".be1", ".we2", ".be2")


class BERTParam(Parameter):
    """BERT-base defaults (L12 / d768 / h12 / ff3072)."""

    n_layers = field(int, default=12, lower_bound=1)
    d_model = field(int, default=768, lower_bound=8)
    n_heads = field(int, default=12, lower_bound=1)
    d_ff = field(int, default=3072, lower_bound=8)
    vocab_size = field(int, default=30522, lower_bound=16)
    max_len = field(int, default=512, lower_bound=8)
    learning_rate = field(float, default=1e-3, lower_bound=0.0)
    grad_sync = field(str, default="fused", enum=["fused", "kvstore"],
                      description="in-step psum vs KVStore dist_sync")
    sp_method = field(str, default="ring", enum=["ring", "ulysses"],
                      description="sequence-parallel attention: K/V ring "
                                  "rotation vs all-to-all head scatter")
    ffn_type = field(str, default="dense", enum=["dense", "moe"],
                     description="dense FFN vs Switch-style top-1 MoE "
                                 "(experts shard over the 'expert' axis)")
    n_experts = field(int, default=8, lower_bound=2,
                      description="experts per MoE layer")
    capacity_factor = field(float, default=1.25, lower_bound=0.1)
    moe_aux_weight = field(float, default=0.01, lower_bound=0.0,
                           description="load-balance aux loss coefficient")


def _norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
          eps: float = 1e-6) -> torch.Tensor:
    """Layer norm in f32 (population variance), back in ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


class BERT:
    """Masked-LM trainer over a (data, model, seq, expert) mesh
    (``device``: this rank's device, ``cuda`` unless ``"cpu"`` is asked
    for).  Every rank of the mesh builds the model and calls each step."""

    _MODEL_MAGIC = b"DMLCTPU.BERT.v1\n"

    def __init__(self, param: Optional[BERTParam] = None,
                 mesh: Optional[Mesh] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 **kwargs: Any):
        self.param = param or BERTParam()
        if kwargs:
            self.param.init(kwargs)
        p = self.param
        self.mesh = mesh if mesh is not None else local_mesh()
        names = self.mesh.axis_names
        CHECK("data" in names, "mesh needs a 'data' axis")
        # axis presence (not size), as in the JAX package: a named axis of
        # size one still takes its path (its collectives are no-ops)
        self._has_model = "model" in names
        self._has_seq = "seq" in names
        shape = self.mesh.shape
        self._tp = shape.get("model", 1)
        self._sp = shape.get("seq", 1)
        self._ep = shape.get("expert", 1)
        self._has_expert = "expert" in names and self._ep > 1
        self._moe = p.ffn_type == "moe"
        # MoE splits the batch over data×expert; one definition feeds the
        # batch blocks, the step's psum axes and the sync
        self._batch_axes = (("data", "expert") if self._moe
                            and self._has_expert else ("data",))
        if self._moe:
            CHECK(p.grad_sync == "fused",
                  "ffn_type='moe' supports grad_sync='fused' only, not "
                  "'kvstore'")
            if self._has_expert:
                CHECK_EQ(p.n_experts % self._ep, 0, "n_experts % ep != 0")
        CHECK_EQ(p.n_heads % max(self._tp, 1), 0, "n_heads % tp != 0")
        CHECK_EQ(p.d_ff % max(self._tp, 1), 0, "d_ff % tp != 0")
        if p.sp_method == "ulysses" and self._has_seq:
            # the user's numbers, not a shard's head count
            CHECK_EQ((p.n_heads // max(self._tp, 1)) % max(self._sp, 1), 0,
                     f"ulysses needs (n_heads/tp) % sp == 0 "
                     f"(n_heads={p.n_heads}, tp={self._tp}, sp={self._sp})")
        self.device = resolve_device(device)
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.opt_state: Optional[Dict[str, torch.Tensor]] = None
        self._kv = None

    # -- parameters ------------------------------------------------------
    def _param_shapes(self) -> List[Tuple[str, Tuple[int, ...], str]]:
        """``(name, shape, init)`` of every parameter in the JAX package's
        order; ``init`` is ``normal`` (N(0, 0.02²)), ``ones`` or
        ``zeros``."""
        p = self.param
        D, dh, Fd, E = p.d_model, p.d_model // p.n_heads, p.d_ff, p.n_experts
        out = [("embed", (p.vocab_size, D), "normal"),
               ("pos", (p.max_len, D), "normal"),
               ("lm_head", (D, p.vocab_size), "normal"),
               ("ln_f.g", (D,), "ones"), ("ln_f.b", (D,), "zeros")]
        for i in range(p.n_layers):
            out += [(f"l{i}.ln1.g", (D,), "ones"),
                    (f"l{i}.ln1.b", (D,), "zeros"),
                    (f"l{i}.ln2.g", (D,), "ones"),
                    (f"l{i}.ln2.b", (D,), "zeros"),
                    (f"l{i}.wqkv", (3, D, p.n_heads, dh), "normal"),
                    (f"l{i}.wo", (p.n_heads, dh, D), "normal")]
            if self._moe:
                out += [(f"l{i}.wre", (D, E), "normal"),
                        (f"l{i}.we1", (E, D, Fd), "normal"),
                        (f"l{i}.be1", (E, Fd), "zeros"),
                        (f"l{i}.we2", (E, Fd, D), "normal"),
                        (f"l{i}.be2", (E, D), "zeros")]
            else:
                out += [(f"l{i}.w1", (D, Fd), "normal"),
                        (f"l{i}.b1", (Fd,), "zeros"),
                        (f"l{i}.w2", (Fd, D), "normal"),
                        (f"l{i}.b2", (D,), "zeros")]
        return out

    def _param_specs(self) -> Dict[str, tuple]:
        """Each parameter's layout over the mesh (JAX's
        ``_param_specs``): per dimension ``None`` or the axis it splits
        over."""
        mdl = "model" if self._has_model else None
        exp = "expert" if self._has_expert else None
        specs: Dict[str, tuple] = {}
        for name, shape, _ in self._param_shapes():
            key = name.split(".", 1)[-1]
            if key == "wqkv":
                specs[name] = (None, None, mdl, None)
            elif key == "wo":
                specs[name] = (mdl, None, None)
            elif key == "w1":
                specs[name] = (None, mdl)
            elif key in ("b1", "w2"):
                specs[name] = (mdl,) + (None,) * (len(shape) - 1)
            elif key in ("we1", "be1", "we2", "be2"):
                specs[name] = (exp,) + (None,) * (len(shape) - 1)
            else:
                specs[name] = (None,) * len(shape)
        return specs

    def initial_params(self, seed: int = 0) -> Dict[str, np.ndarray]:
        """The JAX package's initial weights from ``seed`` as full numpy
        arrays: the same draws in the same order."""
        rng = np.random.default_rng(seed)
        host = {}
        for name, shape, init in self._param_shapes():
            if init == "normal":
                host[name] = (rng.normal(size=shape) * 0.02).astype(
                    np.float32)
            else:
                host[name] = (np.ones if init == "ones" else np.zeros)(
                    shape, np.float32)
        return host

    def init_params(self, seed: int = 0) -> None:
        """The JAX package's initial weights from ``seed``; momentum
        zero."""
        self.params_from_numpy(self.initial_params(seed))

    def params_from_numpy(self, params: Dict[str, np.ndarray],
                          opt_state: Optional[Dict[str, np.ndarray]] = None
                          ) -> None:
        """Load weights (and momentum, zero when omitted) given as the
        JAX package's FULL numpy arrays under its names and shapes — a JAX
        model's ``gather_tree(model.params)``; this rank keeps its
        blocks.  Under ``grad_sync="kvstore"`` the store is made and
        initialised from them."""
        shapes = {n: s for n, s, _ in self._param_shapes()}
        for what, tree in (("params", params), ("opt_state", opt_state)):
            if tree is None:
                continue
            CHECK_EQ(sorted(tree), sorted(shapes),
                     f"{what}: the parameter names differ from the model's")
            for name, shape in shapes.items():
                CHECK_EQ(tuple(np.shape(tree[name])), shape,
                         f"{what}[{name!r}] shape")
        specs = self._param_specs()

        def load(tree, name):     # a copy: the caller keeps its arrays
            block = local_block(np.asarray(tree[name]), specs[name],
                                self.mesh)
            return torch.as_tensor(np.array(block, np.float32),
                                   device=self.device)

        self.params = {n: load(params, n).requires_grad_(True)
                       for n in shapes}
        self.opt_state = {n: (torch.zeros_like(self.params[n],
                                               requires_grad=False)
                              if opt_state is None else load(opt_state, n))
                          for n in shapes}
        if self.param.grad_sync == "kvstore":
            from dmlc_core_tpu_torch.parallel.kvstore import KVStore

            self._kv = KVStore("dist_sync",
                               learning_rate=self.param.learning_rate,
                               mesh=self._data_mesh(), device=self.device)
            keys = list(self.params)
            self._kv.init(keys, [self.params[k].detach() for k in keys])

    def _data_mesh(self) -> Mesh:
        """The ``data`` axis alone, as the KVStore's mesh."""
        if type(self.mesh) is Mesh:
            return self.mesh
        return Mesh(self.mesh.group("data"))

    def gather_params(self) -> Tuple[Dict[str, np.ndarray],
                                     Dict[str, np.ndarray]]:
        """``(params, opt_state)`` as full host numpy arrays in the JAX
        package's order (collective over the axes the blocks split
        over)."""
        specs = self._param_specs()
        return tuple({k: gather_block(v, specs[k], self.mesh).cpu().numpy()
                      for k, v in tree.items()}
                     for tree in (self.params, self.opt_state))

    # -- checkpointing ---------------------------------------------------
    def save_model(self, uri: str) -> None:
        """Hyperparameters, weights and momentum to a Stream URI: the JAX
        package's ``DMLCTPU.BERT.v1`` file, the blocks gathered.
        Collective: every rank calls it; global rank 0 writes."""
        from dmlc_core_tpu_torch.models.checkpoint import save_payload
        from dmlc_core_tpu_torch.parallel import collectives as coll

        CHECK(self.params is not None, "save_model before init_params")
        params, opt_state = self.gather_params()
        if coll.rank() == 0:
            save_payload(uri, self._MODEL_MAGIC, {
                "param": self.param.to_dict(), "params": params,
                "opt_state": opt_state})
        coll.barrier()

    @classmethod
    def load_model(cls, uri: str, mesh: Optional[Mesh] = None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> "BERT":
        """Inverse of :meth:`save_model` (a file of either package): the
        blocks split onto ``mesh``; training resumes exactly, momentum
        restored."""
        from dmlc_core_tpu_torch.models.checkpoint import load_payload

        payload = load_payload(uri, cls._MODEL_MAGIC)
        model = cls(mesh=mesh, device=device, **payload["param"])
        model.params_from_numpy(payload["params"], payload["opt_state"])
        return model

    # -- forward and step ------------------------------------------------
    def _attention(self, q, k, v):
        if not self._has_seq:
            return local_attention(q, k, v)
        if self.param.sp_method == "ulysses":
            return ulysses_attention(q, k, v, "seq", mesh=self.mesh)
        return ring_attention(q, k, v, "seq", mesh=self.mesh)

    def _local_loss(self, params: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(masked loss sum, token count)`` of this rank's ``[b,
        s_local]`` block: heads and the FFN's hidden units local to the
        ``model`` block, tokens to the ``seq`` block."""
        p = self.param
        mesh = self.mesh
        s_local = tokens.shape[1]
        pos0 = (mesh.axis_index("seq") if self._has_seq else 0) * s_local
        x = (F.embedding(tokens, params["embed"])
             + params["pos"][pos0:pos0 + s_local][None]).to(torch.bfloat16)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

        def enter_model(y):       # Megatron f
            return (replicate_fwd_psum_bwd(y, "model", mesh)
                    if self._has_model else y)

        def join_model(y):        # Megatron g
            return (psum_fwd_identity_bwd(y, "model", mesh)
                    if self._has_model else y)

        tok_axes = self._batch_axes + (("seq",) if self._has_seq else ())
        for i in range(p.n_layers):
            h = _norm(x, params[f"l{i}.ln1.g"], params[f"l{i}.ln1.b"])
            h = enter_model(h)
            qkv = torch.einsum("bsd,cdhk->cbshk", h.float(),
                               params[f"l{i}.wqkv"]).to(torch.bfloat16)
            attn = self._attention(*qkv.unbind(0))
            o = torch.einsum("bshk,hkd->bsd", attn.float(),
                             params[f"l{i}.wo"])
            x = x + join_model(o).to(torch.bfloat16)
            h = _norm(x, params[f"l{i}.ln2.g"], params[f"l{i}.ln2.b"])
            if self._moe:
                # outside the model-parallel region; experts over 'expert'
                b, s_l, Dm = h.shape
                y, (a_sum, p_sum, t_cnt) = moe_ffn(
                    h.float().reshape(b * s_l, Dm), params[f"l{i}.wre"],
                    params[f"l{i}.we1"], params[f"l{i}.be1"],
                    params[f"l{i}.we2"], params[f"l{i}.be2"],
                    axis="expert" if self._has_expert else None,
                    capacity_factor=p.capacity_factor, stats=True,
                    mesh=mesh)
                # the routing statistics' sums over every token axis: the
                # aux of the global batch, on every rank
                a_sum = psum(a_sum, tok_axes, mesh)
                p_sum = psum(p_sum, tok_axes, mesh)
                t_glob = psum(t_cnt, tok_axes, mesh)
                aux_total = aux_total + p.n_experts * torch.sum(
                    (a_sum / t_glob) * (p_sum / t_glob))
                x = x + y.reshape(b, s_l, Dm).to(torch.bfloat16)
            else:
                h = enter_model(h)
                u = F.gelu(h.float() @ params[f"l{i}.w1"]
                           + params[f"l{i}.b1"], approximate="tanh")
                m = join_model(u @ params[f"l{i}.w2"]) + params[f"l{i}.b2"]
                x = x + m.to(torch.bfloat16)
        x = _norm(x, params["ln_f.g"], params["ln_f.b"])
        logp = torch.log_softmax(x.float() @ params["lm_head"], dim=-1)
        tok_lp = logp.gather(-1, labels[..., None])[..., 0]
        loss_sum = -(tok_lp * mask).sum()
        if self._moe:
            # aux_total is global and the same on every rank; weighting it
            # by the local mask sum lets the step's normalisation recover
            # aux_w · aux_total
            loss_sum = loss_sum + (p.moe_aux_weight * aux_total
                                   / p.n_layers * mask.sum())
        return loss_sum, mask.sum()

    def _step(self, tokens: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
        """One optimizer step on this rank's device blocks; the step's
        global mean loss as a 0-d device tensor (no host sync under the
        fused sync)."""
        mesh = self.mesh
        names = list(self.params)
        ps = [self.params[n] for n in names]
        with torch.enable_grad():
            loss_sum, n_tok = self._local_loss(self.params, tokens, labels,
                                               mask)
            grads = torch.autograd.grad(loss_sum, ps)
        seq = ("seq",) if self._has_seq else ()
        with torch.no_grad():
            n_glob = psum(psum(n_tok, self._batch_axes, mesh), seq, mesh)
            loss = psum(psum(loss_sum.detach(), self._batch_axes, mesh),
                        seq, mesh) / n_glob
            # global-mean-per-token gradients; the seq blocks' parts
            # summed (model gradients are complete on every rank through
            # f and g)
            grads = [psum(g / n_glob, seq, mesh) for g in grads]
            if self.param.grad_sync == "kvstore":
                self._kv.push(names, grads)
                for n, v in zip(names, self._kv.pull(names)):
                    self.params[n].copy_(v)
                return loss
            # expert-split weights already hold their expert-axis parts
            # (the all-to-all's backward): a psum over 'expert' would
            # count them twice
            grads = [psum(g, "data" if n.endswith(_EXPERT_KEYS)
                          else self._batch_axes, mesh)
                     for n, g in zip(names, grads)]
            opt = [self.opt_state[n] for n in names]
            torch._foreach_mul_(opt, 0.9)
            torch._foreach_add_(opt, grads)
            torch._foreach_sub_(ps, torch._foreach_mul(
                opt, self.param.learning_rate))
            return loss

    def _device_batch(self, tokens, labels, mask):
        """The host checks of ``train_step`` (an over-long sequence or an
        out-of-vocab id would index past the tables), then this rank's
        block of the global batch on the device."""
        CHECK(np.shape(tokens)[-1] <= self.param.max_len,
              f"sequence length {np.shape(tokens)[-1]} exceeds max_len "
              f"{self.param.max_len}")
        for name, arr in (("token", tokens), ("label", labels)):
            CHECK(0 <= int(np.min(arr))
                  and int(np.max(arr)) < self.param.vocab_size,
                  f"{name} id out of vocab range [0, "
                  f"{self.param.vocab_size})")
        spec = (self._batch_axes, "seq" if self._has_seq else None)
        dev = self.device
        return tuple(
            torch.as_tensor(np.ascontiguousarray(local_block(
                np.asarray(a, dt), spec, self.mesh)), device=dev)
            for a, dt in ((tokens, np.int64), (labels, np.int64),
                          (mask, np.float32)))

    # -- public API ------------------------------------------------------
    def train_step(self, tokens: np.ndarray, labels: np.ndarray,
                   mask: np.ndarray) -> float:
        """One masked-LM step on the global ``[B, S]`` int batches (every
        rank passes them); the global mean loss."""
        CHECK(self.params is not None, "call init_params() first")
        return float(self._step(*self._device_batch(tokens, labels, mask)))

    def fit(self, tokens: np.ndarray, labels: np.ndarray, mask: np.ndarray,
            n_steps: int, warmup: int = 0) -> Tuple[float, float]:
        """Repeat steps on one batch (bench harness).  Returns
        ``(final_loss, seconds for the timed steps)``."""
        for _ in range(warmup):
            self.train_step(tokens, labels, mask)
        t0 = get_time()
        loss = float("nan")
        for _ in range(n_steps):
            loss = self.train_step(tokens, labels, mask)
        return loss, get_time() - t0

    def fit_chunked(self, tokens: np.ndarray, labels: np.ndarray,
                    mask: np.ndarray, n_steps: int, chunk: int = 10,
                    warmup_chunks: int = 1):
        """Run ``n_steps`` steps as chunks of ``chunk``, with no host sync
        inside a chunk (the losses stay on the device until every chunk
        is issued).  Returns ``(final_loss, seconds, chunk_times)``,
        ``chunk_times`` the in-order ``(steps_done, t)`` arrival of each
        chunk's losses.  The timed region is the steady state: warmup
        chunks (at least one) run and are fetched first.  Needs
        ``grad_sync="fused"`` (the kvstore sync is a host round trip a
        step by design)."""
        CHECK(self.params is not None, "call init_params() first")
        CHECK(self.param.grad_sync == "fused",
              "fit_chunked needs grad_sync='fused' (kvstore sync is a "
              "host round-trip per step by design)")
        batch = self._device_batch(tokens, labels, mask)
        CHECK(n_steps % chunk == 0,
              f"n_steps {n_steps} must be a multiple of chunk {chunk} "
              "(chunks run whole; a silent overshoot would corrupt steps/s "
              "math in callers)")

        def run_chunk():
            return torch.stack([self._step(*batch) for _ in range(chunk)])

        for _ in range(max(warmup_chunks, 1)):
            losses = run_chunk()
        losses[-1:].cpu()             # a real fetch: the warmup is done
        t0 = get_time()
        loss_chunks = []
        done = 0
        while done < n_steps:
            loss_chunks.append(run_chunk())
            done += chunk
        chunk_times = []
        fetched = 0
        final_loss = float("nan")
        for losses in loss_chunks:    # in-order arrival timestamps
            arr = losses.cpu().numpy()
            fetched += len(arr)
            chunk_times.append((fetched, get_time() - t0))
            final_loss = float(arr[-1])
        return final_loss, get_time() - t0, chunk_times
