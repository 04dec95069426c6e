"""BERT masked-LM trainer on one GPU (PyTorch port).

The counterpart of ``dmlc_core_tpu/models/bert.py`` for a mesh of one
device and the dense FFN: the same ``BERTParam`` (fields, defaults and
enums), the same initial weights from the same seed, the same forward and
optimizer step, and model files that load in either package.

The parameters are a flat dict under the JAX package's names and shapes
(``"l3.wqkv"`` ``[3, D, H, Dh]``, ``"l3.wo"`` ``[H, Dh, D]``,
``"ln_f.g"``, …): f32 master weights on the device.  The forward follows
``_local_loss``'s cast points — the embedding sum in f32, the residual
stream in bf16, the norms in f32 with population variance and
``eps=1e-6``, the QKV product in f32 cast to bf16 for attention
(:func:`~dmlc_core_tpu_torch.ops.attention.local_attention`: the CUDA
flash kernels on the card, the dense f32 oracle on the CPU), the output
projection, FFN (tanh GELU), final norm, logits and ``log_softmax`` in
f32.  The step is the fused branch of ``_build_step``: the gradient of
the masked loss sum divided by the mask's token count, then
``m = 0.9·m + g`` and ``p −= lr·m``.  The f32 products run in full f32
(PyTorch's default; TF32 is never enabled here).

Waits (ROADMAP A16): data parallel over the port's ``Mesh``, the
``kvstore`` gradient sync (A15), the ``model`` and ``seq`` axes, and the
Switch-MoE FFN.  The constructor refuses each.
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
from dmlc_core_tpu_torch.parallel.mesh import Mesh, local_mesh
from dmlc_core_tpu_torch.utils.device import resolve_device

__all__ = ["BERT", "BERTParam"]


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
    """Masked-LM trainer on one device (``device``: ``cuda`` unless
    ``"cpu"`` is asked for)."""

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
        CHECK(self.mesh.size == 1,
              f"BERT on a world of {self.mesh.size}: data parallel over the "
              "port's Mesh waits (ROADMAP A16)")
        CHECK(p.ffn_type == "dense",
              "ffn_type='moe': the Switch-MoE FFN (parallel/moe.py) is not "
              "ported yet (ROADMAP A16)")
        CHECK(p.grad_sync == "fused",
              "grad_sync='kvstore': the KVStore sync is not ported yet "
              "(ROADMAP A15)")
        self.device = resolve_device(device)
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.opt_state: Optional[Dict[str, torch.Tensor]] = None

    # -- parameters ------------------------------------------------------
    def _param_shapes(self) -> List[Tuple[str, Tuple[int, ...], str]]:
        """``(name, shape, init)`` of every parameter in the JAX package's
        order; ``init`` is ``normal`` (N(0, 0.02²)), ``ones`` or
        ``zeros``."""
        p = self.param
        D, dh = p.d_model, p.d_model // p.n_heads
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
                    (f"l{i}.wo", (p.n_heads, dh, D), "normal"),
                    (f"l{i}.w1", (D, p.d_ff), "normal"),
                    (f"l{i}.b1", (p.d_ff,), "zeros"),
                    (f"l{i}.w2", (p.d_ff, D), "normal"),
                    (f"l{i}.b2", (D,), "zeros")]
        return out

    def init_params(self, seed: int = 0) -> None:
        """The JAX package's initial weights from ``seed``: the same numpy
        draws in the same order; momentum zero."""
        rng = np.random.default_rng(seed)
        host = {}
        for name, shape, init in self._param_shapes():
            if init == "normal":
                host[name] = (rng.normal(size=shape) * 0.02).astype(
                    np.float32)
            else:
                host[name] = (np.ones if init == "ones" else np.zeros)(
                    shape, np.float32)
        self.params_from_numpy(host)

    def params_from_numpy(self, params: Dict[str, np.ndarray],
                          opt_state: Optional[Dict[str, np.ndarray]] = None
                          ) -> None:
        """Load weights (and momentum, zero when omitted) given under the
        JAX package's names and shapes as numpy arrays — a JAX model's
        ``gather_tree(model.params)``."""
        shapes = {n: s for n, s, _ in self._param_shapes()}
        for what, tree in (("params", params), ("opt_state", opt_state)):
            if tree is None:
                continue
            CHECK_EQ(sorted(tree), sorted(shapes),
                     f"{what}: the parameter names differ from the model's")
            for name, shape in shapes.items():
                CHECK_EQ(tuple(np.shape(tree[name])), shape,
                         f"{what}[{name!r}] shape")

        def load(tree, name):     # a copy: the caller keeps its arrays
            return torch.as_tensor(np.array(tree[name], np.float32),
                                   device=self.device)

        self.params = {n: load(params, n).requires_grad_(True)
                       for n in shapes}
        self.opt_state = {n: (torch.zeros_like(self.params[n],
                                               requires_grad=False)
                              if opt_state is None else load(opt_state, n))
                          for n in shapes}

    # -- checkpointing ---------------------------------------------------
    def save_model(self, uri: str) -> None:
        """Hyperparameters, weights and momentum to a Stream URI: the JAX
        package's ``DMLCTPU.BERT.v1`` file."""
        from dmlc_core_tpu_torch.models.checkpoint import (
            gather_tree, save_payload)

        CHECK(self.params is not None, "save_model before init_params")
        save_payload(uri, self._MODEL_MAGIC, {
            "param": self.param.to_dict(),
            "params": gather_tree(self.params),
            "opt_state": gather_tree(self.opt_state),
        })

    @classmethod
    def load_model(cls, uri: str, mesh: Optional[Mesh] = None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> "BERT":
        """Inverse of :meth:`save_model` (a file of either package):
        training resumes exactly, momentum restored."""
        from dmlc_core_tpu_torch.models.checkpoint import load_payload

        payload = load_payload(uri, cls._MODEL_MAGIC)
        model = cls(mesh=mesh, device=device, **payload["param"])
        model.params_from_numpy(payload["params"], payload["opt_state"])
        return model

    # -- forward and step ------------------------------------------------
    def _local_loss(self, params: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(masked loss sum, token count)`` of a ``[B, S]`` batch."""
        p = self.param
        S = tokens.shape[1]
        x = (F.embedding(tokens, params["embed"])
             + params["pos"][:S][None]).to(torch.bfloat16)
        for i in range(p.n_layers):
            h = _norm(x, params[f"l{i}.ln1.g"], params[f"l{i}.ln1.b"])
            qkv = torch.einsum("bsd,cdhk->cbshk", h.float(),
                               params[f"l{i}.wqkv"]).to(torch.bfloat16)
            attn = local_attention(*qkv.unbind(0))
            o = torch.einsum("bshk,hkd->bsd", attn.float(),
                             params[f"l{i}.wo"])
            x = x + o.to(torch.bfloat16)
            h = _norm(x, params[f"l{i}.ln2.g"], params[f"l{i}.ln2.b"])
            u = F.gelu(h.float() @ params[f"l{i}.w1"] + params[f"l{i}.b1"],
                       approximate="tanh")
            m = u @ params[f"l{i}.w2"] + params[f"l{i}.b2"]
            x = x + m.to(torch.bfloat16)
        x = _norm(x, params["ln_f.g"], params["ln_f.b"])
        logp = torch.log_softmax(x.float() @ params["lm_head"], dim=-1)
        tok_lp = logp.gather(-1, labels[..., None])[..., 0]
        return -(tok_lp * mask).sum(), mask.sum()

    def _step(self, tokens: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
        """One fused optimizer step on device tensors; the step's mean loss
        as a 0-d device tensor (no host sync)."""
        names = list(self.params)
        ps = [self.params[n] for n in names]
        with torch.enable_grad():
            loss_sum, n_tok = self._local_loss(self.params, tokens, labels,
                                               mask)
            grads = torch.autograd.grad(loss_sum, ps)
        with torch.no_grad():
            grads = torch._foreach_div(list(grads), n_tok)
            opt = [self.opt_state[n] for n in names]
            torch._foreach_mul_(opt, 0.9)
            torch._foreach_add_(opt, grads)
            torch._foreach_sub_(ps, torch._foreach_mul(
                opt, self.param.learning_rate))
            return loss_sum.detach() / n_tok

    def _device_batch(self, tokens, labels, mask):
        """The host checks of ``train_step`` (an over-long sequence or an
        out-of-vocab id would index past the tables), then the batch on
        the device."""
        CHECK(np.shape(tokens)[-1] <= self.param.max_len,
              f"sequence length {np.shape(tokens)[-1]} exceeds max_len "
              f"{self.param.max_len}")
        for name, arr in (("token", tokens), ("label", labels)):
            CHECK(0 <= int(np.min(arr))
                  and int(np.max(arr)) < self.param.vocab_size,
                  f"{name} id out of vocab range [0, "
                  f"{self.param.vocab_size})")
        dev = self.device
        return (torch.as_tensor(np.asarray(tokens, np.int64), device=dev),
                torch.as_tensor(np.asarray(labels, np.int64), device=dev),
                torch.as_tensor(np.asarray(mask, np.float32), device=dev))

    # -- public API ------------------------------------------------------
    def train_step(self, tokens: np.ndarray, labels: np.ndarray,
                   mask: np.ndarray) -> float:
        """One masked-LM step on ``[B, S]`` int batches; the mean loss."""
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
        chunks (at least one) run and are fetched first."""
        CHECK(self.params is not None, "call init_params() first")
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
