"""Pipeline parallelism (GPipe-style circular schedule) over a ``pipe``
mesh axis (PyTorch port).

The counterpart of ``dmlc_core_tpu/parallel/pipeline.py``:

* every stage holds a CONTIGUOUS slab of layers as stacked ``[L_local,
  ...]`` tensors (a global ``[L, ...]`` array split over ``pipe``);
* ``n_micro + n_stages − 1`` ticks; each tick every stage applies its
  slab to its live microbatch and the activations
  :func:`~dmlc_core_tpu_torch.parallel.collectives.ppermute` one hop down
  the ring;
* bubble ticks compute on zeros and are masked out, so autograd through
  the ticks and the ``ppermute`` Function gives the pipelined backward
  (the reverse hops) with no hand-written schedule;
* ``torch.utils.checkpoint`` on the stage function keeps the saved state
  O(ticks · microbatch), as ``jax.checkpoint`` does.

Every rank runs the same operations (stage 0's injection and the last
stage's outputs are selects on the stage index, as in the JAX package),
so every rank's backward issues the same collectives in the same order.

:func:`pipeline_apply` is the generic combinator; :class:`PipelineLM` the
self-contained consumer, a masked-LM transformer on a (data, pipe) mesh.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

from dmlc_core_tpu_torch.base.logging import CHECK, CHECK_EQ
from dmlc_core_tpu_torch.base.parameter import Parameter, field
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.parallel.collectives import ppermute, psum
from dmlc_core_tpu_torch.parallel.mesh import (
    Mesh, gather_block, local_block, local_mesh)
from dmlc_core_tpu_torch.utils.device import resolve_device

__all__ = ["pipeline_apply", "PipelineLM", "PipelineLMParam"]


class _ReplicatedLossBoundary(torch.autograd.Function):
    """Identity forward; backward divides the cotangent by the axis size.

    After the ring-closing psum every stage computes the SAME downstream
    loss from the replicated pipeline output, so the psum's backward sums
    S identical cotangents — S× the true gradient for everything
    upstream.  This boundary cancels the redundancy; the head's
    gradients are complete on each stage and untouched."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct / ctx.n, None


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_micro: torch.Tensor,
                   axis: str = "pipe", *, mesh) -> torch.Tensor:
    """Run ``x_micro`` ``[M, mb, ...]`` through every stage; returns the
    ``[M, mb, ...]`` outputs of the LAST stage on every rank (psummed over
    the axis to close the ring).  ``stage_fn(stage_params, x) -> y`` is
    this rank's slab of layers.  At tick ``t`` stage ``s`` works on
    microbatch ``t − s`` (zeros in bubble ticks)."""
    S = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    M = x_micro.shape[0]
    dev = x_micro.device
    first = torch.tensor(idx == 0, device=dev)
    last = torch.tensor(idx == S - 1, device=dev)
    perm_fwd = [(i, (i + 1) % S) for i in range(S)]
    buf = torch.zeros_like(x_micro[0])
    outs = [torch.zeros_like(x_micro[0]) for _ in range(M)]
    for t in range(M + S - 1):
        # stage 0 injects microbatch t (zeros once t >= M: a bubble)
        inject = x_micro[min(t, M - 1)] if t < M else torch.zeros_like(buf)
        buf = torch.where(first, inject, buf)
        y = _checkpoint(stage_fn, stage_params, buf, use_reentrant=False)
        # the last stage completed microbatch t - (S - 1)
        done = t - (S - 1)
        if done >= 0:
            outs[done] = torch.where(last, y, outs[done])
        if t + 1 < M + S - 1:
            buf = ppermute(y, axis, perm_fwd, mesh)
    # only the last stage holds real outputs: close the ring (psum of a
    # one-hot mask) and cancel the S-fold cotangent of the replicated
    # downstream loss
    stacked = torch.stack(outs)
    mine = torch.where(last, stacked, torch.zeros_like(stacked))
    return _ReplicatedLossBoundary.apply(psum(mine, axis, mesh), S) \
        if S > 1 else mine


class PipelineLMParam(Parameter):
    """Small-transformer defaults sized for tests/dryruns; scale freely."""

    n_layers = field(int, default=4, lower_bound=1)
    d_model = field(int, default=64, lower_bound=8)
    n_heads = field(int, default=4, lower_bound=1)
    d_ff = field(int, default=128, lower_bound=8)
    vocab_size = field(int, default=256, lower_bound=16)
    max_len = field(int, default=64, lower_bound=8)
    n_micro = field(int, default=4, lower_bound=1,
                    description="microbatches per step (pipeline depth)")
    learning_rate = field(float, default=1e-2, lower_bound=0.0)


def _norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps)


_STACKED = ("wqkv", "wo", "w1", "b1", "w2", "b2")


class PipelineLM:
    """Masked-LM transformer on a (data, pipe) mesh (``device``: ``cuda``
    unless ``"cpu"`` is asked for).

    Layers live as ``[n_layers, ...]`` stacked tensors split over
    ``pipe`` (each stage loops over its slab); embedding and head are
    replicated.  A step: the gradient of the masked loss sum, psummed
    over ``data`` and divided by the global token count; the embedding's
    also psummed over ``pipe`` (only stage 0's injection reaches it);
    then SGD."""

    _MODEL_MAGIC = b"DMLCTPU.PIPELM.v1\n"

    def __init__(self, param: Optional[PipelineLMParam] = None,
                 mesh: Optional[Mesh] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 **kwargs: Any):
        self.param = param or PipelineLMParam()
        if kwargs:
            self.param.init(kwargs)
        self.mesh = mesh if mesh is not None else local_mesh()
        CHECK("data" in self.mesh.axis_names, "mesh needs a 'data' axis")
        self._has_pipe = "pipe" in self.mesh.axis_names
        self._pp = self.mesh.shape.get("pipe", 1)
        CHECK_EQ(self.param.n_layers % max(self._pp, 1), 0,
                 "n_layers % pipe != 0")
        self.device = resolve_device(device)
        self.params: Optional[Dict[str, torch.Tensor]] = None

    # -- parameters -----------------------------------------------------
    def _specs(self) -> Dict[str, tuple]:
        pipe = "pipe" if self._has_pipe else None
        return {"embed": (), "pos": (), "head": (),
                **{k: (pipe,) for k in _STACKED}}

    def _shapes(self) -> Dict[str, tuple]:
        p = self.param
        L, D, Fd = p.n_layers, p.d_model, p.d_ff
        return {"embed": (p.vocab_size, D), "pos": (p.max_len, D),
                "head": (D, p.vocab_size), "wqkv": (L, 3, D, D),
                "wo": (L, D, D), "w1": (L, D, Fd), "b1": (L, Fd),
                "w2": (L, Fd, D), "b2": (L, D)}

    def init_params(self, seed: int = 0) -> None:
        """The JAX package's initial weights from ``seed`` (the same numpy
        draws in the same order)."""
        rng = np.random.default_rng(seed)
        host = {}
        for k, shape in self._shapes().items():
            if k in ("b1", "b2"):
                host[k] = np.zeros(shape, np.float32)
            else:
                host[k] = (rng.normal(size=shape) * 0.05).astype(np.float32)
        self.params_from_numpy(host)

    def params_from_numpy(self, params: Dict[str, np.ndarray]) -> None:
        """Load the JAX package's full numpy weights; this rank keeps its
        stage's slab."""
        shapes = self._shapes()
        CHECK_EQ(sorted(params), sorted(shapes),
                 "params: the parameter names differ from the model's")
        specs = self._specs()
        self.params = {}
        for k, shape in shapes.items():
            CHECK_EQ(tuple(np.shape(params[k])), shape, f"params[{k!r}] shape")
            block = local_block(np.asarray(params[k], np.float32), specs[k],
                                self.mesh)
            self.params[k] = torch.as_tensor(
                np.array(block), device=self.device).requires_grad_(True)

    def gather_params(self) -> Dict[str, np.ndarray]:
        """The full weights as host numpy arrays (collective over
        ``pipe``)."""
        specs = self._specs()
        return {k: gather_block(v, specs[k], self.mesh).cpu().numpy()
                for k, v in self.params.items()}

    # -- stage computation ---------------------------------------------
    def _stage_fn(self, sp: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
        """This stage's slab of layers on activations ``[mb, s, D]``."""
        p = self.param
        dh = p.d_model // p.n_heads
        for li in range(sp["wqkv"].shape[0]):
            h = _norm(x)
            qkv = torch.einsum("bsd,cde->cbse", h, sp["wqkv"][li])
            q, k, v = (y.reshape(*y.shape[:2], p.n_heads, dh)
                       for y in qkv.unbind(0))
            scores = torch.einsum("bshk,bthk->bhst", q, k) / np.sqrt(dh)
            attn = torch.einsum("bhst,bthk->bshk",
                                torch.softmax(scores, -1), v)
            attn = attn.reshape(*attn.shape[:2], p.d_model)
            x = x + torch.einsum("bse,ed->bsd", attn, sp["wo"][li])
            h = _norm(x)
            u = F.gelu(torch.einsum("bsd,df->bsf", h, sp["w1"][li])
                       + sp["b1"][li], approximate="tanh")
            x = x + torch.einsum("bsf,fd->bsd", u, sp["w2"][li]) \
                + sp["b2"][li]
        return x

    def _local_loss(self, ps, tokens, labels, mask):
        p = self.param
        B, S = tokens.shape
        M = p.n_micro
        CHECK_EQ(B % M, 0, "local batch % n_micro != 0")
        x = F.embedding(tokens, ps["embed"]) + ps["pos"][None, :S]
        x_micro = x.reshape(M, B // M, S, p.d_model)
        stage = {k: ps[k] for k in _STACKED}
        if self._has_pipe:
            y = pipeline_apply(self._stage_fn, stage, x_micro, "pipe",
                               mesh=self.mesh)
        else:
            y = torch.stack([self._stage_fn(stage, xm) for xm in x_micro])
        y = _norm(y.reshape(B, S, p.d_model))
        logp = torch.log_softmax(
            torch.einsum("bsd,dv->bsv", y, ps["head"]), -1)
        tok = logp.gather(-1, labels[..., None])[..., 0]
        return -(tok * mask).sum(), mask.sum()

    def _step(self, tokens, labels, mask) -> torch.Tensor:
        names = list(self.params)
        ps = [self.params[n] for n in names]
        with torch.enable_grad():
            ls, n = self._local_loss(self.params, tokens, labels, mask)
            grads = torch.autograd.grad(ls, ps)
        with torch.no_grad():
            mesh = self.mesh
            n_glob = psum(n.detach(), "data", mesh)
            loss = psum(ls.detach(), "data", mesh) / n_glob
            grads = {k: psum(g, "data", mesh) / n_glob
                     for k, g in zip(names, grads)}
            if self._has_pipe:
                # embed/pos flow through stage 0's injection only; the
                # head's gradients are complete on every stage already
                for k in ("embed", "pos"):
                    grads[k] = psum(grads[k], "pipe", mesh)
            lr = self.param.learning_rate
            for k in names:
                self.params[k].sub_(lr * grads[k])
            return loss

    def _device_batch(self, tokens, labels, mask):
        spec = ("data",)
        dev = self.device
        return tuple(torch.as_tensor(local_block(np.asarray(a, dt), spec,
                                                 self.mesh), device=dev)
                     for a, dt in ((tokens, np.int64), (labels, np.int64),
                                   (mask, np.float32)))

    # -- checkpointing ---------------------------------------------------
    def save_model(self, uri: str) -> None:
        """Hyperparameters and the full weights (pipe slabs gathered) to a
        Stream URI: the JAX package's file.  Collective: every rank calls
        it; global rank 0 writes."""
        from dmlc_core_tpu_torch.models.checkpoint import save_payload
        from dmlc_core_tpu_torch.parallel import collectives as coll

        CHECK(self.params is not None, "save_model before init_params")
        full = self.gather_params()
        if coll.rank() == 0:
            save_payload(uri, self._MODEL_MAGIC, {
                "param": self.param.to_dict(), "params": full})
        coll.barrier()

    @classmethod
    def load_model(cls, uri: str, mesh: Optional[Mesh] = None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> "PipelineLM":
        """Inverse of :meth:`save_model` (a file of either package); the
        layer slabs re-split onto ``mesh``."""
        from dmlc_core_tpu_torch.models.checkpoint import load_payload

        payload = load_payload(uri, cls._MODEL_MAGIC)
        model = cls(mesh=mesh, device=device, **payload["param"])
        model.params_from_numpy(payload["params"])
        return model

    # -- public API -----------------------------------------------------
    def train_step(self, tokens: np.ndarray, labels: np.ndarray,
                   mask: np.ndarray) -> float:
        """One SGD step on the global ``[B, S]`` batch (every rank passes
        it; each keeps its ``data`` block); the global mean loss."""
        CHECK(self.params is not None, "call init_params() first")
        return float(self._step(*self._device_batch(tokens, labels, mask)))

    def fit_chunked(self, tokens: np.ndarray, labels: np.ndarray,
                    mask: np.ndarray, n_steps: int, chunk: int = 10,
                    warmup_chunks: int = 1):
        """Run ``n_steps`` SGD steps as chunks of ``chunk`` with no host
        sync inside a chunk; returns ``(final_loss, seconds,
        chunk_times)`` with in-order per-chunk loss-arrival times.  The
        warmup chunks (at least one) run first, outside the timing."""
        CHECK(self.params is not None, "call init_params() first")
        CHECK(n_steps % chunk == 0,
              f"n_steps {n_steps} must be a multiple of chunk {chunk}")
        batch = self._device_batch(tokens, labels, mask)

        def run_chunk():
            return torch.stack([self._step(*batch) for _ in range(chunk)])

        for _ in range(max(warmup_chunks, 1)):
            losses = run_chunk()
        losses[-1:].cpu()
        t0 = get_time()
        loss_chunks = []
        done = 0
        while done < n_steps:
            loss_chunks.append(run_chunk())
            done += chunk
        chunk_times = []
        fetched = 0
        final_loss = float("nan")
        for losses in loss_chunks:
            arr = losses.cpu().numpy()
            fetched += len(arr)
            chunk_times.append((fetched, get_time() - t0))
            final_loss = float(arr[-1])
        return final_loss, get_time() - t0, chunk_times
