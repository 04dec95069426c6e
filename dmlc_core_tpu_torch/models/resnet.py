"""ResNet image trainer fed by the RecordIO infeed pipeline (config 2).

The counterpart of ``dmlc_core_tpu/models/resnet.py``: RecordIO shard →
``data.image_record.batch_iterator`` (host parse, ``ThreadedIter``
prefetch) → :class:`~dmlc_core_tpu_torch.data.device_feed.DeviceFeed`
(pinned copies on a side stream) → a train step on the card.

The JAX model is flax ``nn.Conv`` / ``nn.BatchNorm`` / ``nn.Dense`` under
XLA, with no Pallas kernel on its path, so the port's convolutions are
``F.conv2d`` (cuDNN on the card), as an XLA dot is ``torch.matmul``.  What
the port keeps of flax, value for value:

* **layout** — batches arrive NHWC (uint8 or float), as in JAX; the stem's
  ``permute(0, 3, 1, 2)`` of a contiguous NHWC batch is an NCHW view whose
  memory is already ``channels_last``, the layout cuDNN prefers for bf16,
  so no copy is made.  Conv weights are stored OIHW (flax: HWIO) and the
  head's ``[out, in]`` (flax: ``[in, out]``); :meth:`ResNetTrainer.params_from_numpy`
  transposes flax's arrays on the way in;
* **``SAME`` padding** — XLA pads ``total = max((out − 1)·s + k − in, 0)``
  with ``lo = total // 2``: asymmetric under stride 2 on an even side
  (the 7×7/2 stem pads (2, 3), a 3×3/2 conv (0, 1), the 3×3/2 max-pool
  (0, 1) with −inf).  :func:`same_pads` computes it from the input's size;
  symmetric pads go to the convolution, asymmetric ones to ``F.pad``;
* **batch norm** — flax's: statistics in f32 as ``mean(x²) − mean(x)²``
  (clamped at 0), the running var storing that BIASED variance, momentum
  0.9 (``ra = 0.9·ra + 0.1·batch``), eps 1e-5, no running update at
  init, and the last BN of each block starting with scale 0.  In a
  training step the statistics cover the GLOBAL batch: on a data axis of
  N ranks each BN sums ``(Σx, Σx²)`` over the ranks, and its backward
  the per-channel ``(Σdy, Σdy·x̂)`` (``_BatchNormTrain``: the gradient in
  closed form, saving only the activation itself) — the counterpart of
  XLA's statistics over a ``data``-sharded global batch, i.e.
  SyncBatchNorm, not DDP's per-rank BN;
* **precision** — convolutions and BN outputs in ``dtype`` (bf16 by
  default) with f32 parameters; the stem normalises u8 → f32 / 255, then
  (x − 0.5) / 0.25, then casts; the spatial mean sums in f32 and rounds to
  ``dtype``; the head is an f32 linear layer and the logits are f32;
* **the step** — ``optax.chain(add_decayed_weights(wd), sgd(lr, momentum))``
  is ``torch.optim.SGD(lr, momentum, weight_decay=wd)`` (dampening 0, no
  Nesterov; decay on every parameter, BN's included); smoothed one-hot
  softmax cross-entropy is ``F.cross_entropy(label_smoothing=)``; the loss
  and ``acc`` are means over the global batch.  On N ranks each rank
  backpropagates its local loss sum over the global batch size, and one
  ``all_reduce`` of the gradients (with the loss sum and the hit count in
  the same bucket) gives every rank the global-mean gradient.

Initial weights come from an explicit ``torch.Generator`` with flax's
initialisers (LeCun-normal, truncated at 2σ, for convolutions and the
head; zero bias), so they follow flax's distributions, not its bits;
:meth:`ResNetTrainer.params_from_numpy` carries a JAX model's weights
across.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dmlc_core_tpu_torch.base.logging import CHECK, LOG
from dmlc_core_tpu_torch.base.parameter import Parameter, field
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.data.device_feed import DeviceFeed
from dmlc_core_tpu_torch.data.image_record import batch_iterator
from dmlc_core_tpu_torch.parallel import collectives
from dmlc_core_tpu_torch.parallel.mesh import Mesh, local_mesh
from dmlc_core_tpu_torch.utils.device import resolve_device

__all__ = ["ResNet", "ResNetParam", "ResNetTrainer", "RESNET_STAGES",
           "BasicBlock", "BottleneckBlock", "same_pads"]

# variant → (stage sizes, bottleneck?)
RESNET_STAGES: Dict[str, Tuple[Sequence[int], bool]] = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
    "resnet152": ((3, 8, 36, 3), True),
    # tiny config for tests / CPU smoke
    "resnet-micro": ((1, 1), False),
}

_MOMENTUM = 0.9
_EPS = 1e-5


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one side of ``size`` for a window ``k``
    at stride ``s``: ``(lo, hi)`` with ``lo = total // 2``."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal``: a normal truncated at ±2σ, scaled so its
    variance is ``1 / fan_in``."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, padding="SAME")`` over NCHW tensors;
    the weight is f32 OIHW, cast to the input's dtype for the product."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        _lecun_normal_(self.weight.data, cin * k * k, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = same_pads(x.shape[2], self.k, self.stride)
        pw = same_pads(x.shape[3], self.k, self.stride)
        w = self.weight.to(x.dtype, memory_format=torch.channels_last)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, w, stride=self.stride, padding=(ph[0], pw[0]))
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, w, stride=self.stride)


def _summed(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``t`` summed over the ranks of ``mesh``'s data axis (``t`` itself
    on one rank)."""
    if mesh is not None and mesh.size > 1:
        return collectives.device_allreduce(t.contiguous(), mesh)
    return t


class _BatchNormTrain(torch.autograd.Function):
    """flax's training-mode batch norm with a closed-form backward.

    Forward, as flax computes it: ``x`` in f32, per channel ``mean(x)``
    and ``mean(x²)`` over (N, H, W) — over the global batch when the
    data axis has several ranks —, ``var = max(mean(x²) − mean(x)², 0)``,
    ``y = (x − mean)·(rsqrt(var + eps)·scale) + bias`` rounded to ``x``'s
    dtype.  Backward: the same function's gradient in closed form,
    ``dx = scale·rstd·(dy − mean(dy) − x̂·mean(dy·x̂))`` with the means
    over the global batch, ``dscale = Σ dy·x̂`` and ``dbias = Σ dy`` over
    this rank's rows (the trainer sums parameter gradients over the
    ranks).  Only ``x`` (in its own dtype) and the per-channel statistics
    are saved, where autograd through the f32 formula would keep two f32
    copies of every activation."""

    @staticmethod
    def forward(ctx, x, scale, bias, mesh):
        xf = x.float()
        dims = (0, 2, 3)
        count = xf.numel() // xf.shape[1] * (mesh.size if mesh is not None
                                             else 1)
        s = _summed(torch.stack([xf.sum(dims), (xf * xf).sum(dims)]), mesh)
        mu, mu2 = s[0] / count, s[1] / count
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        rstd = torch.rsqrt(var + _EPS)
        y = ((xf - mu[:, None, None]) * (rstd * scale)[:, None, None]
             + bias[:, None, None]).to(x.dtype)
        ctx.save_for_backward(x, mu, rstd, scale)
        ctx.mesh, ctx.count = mesh, count
        ctx.mark_non_differentiable(mu, var)
        return y, mu, var

    @staticmethod
    def backward(ctx, dy, _dmu, _dvar):
        x, mu, rstd, scale = ctx.saved_tensors
        dims = (0, 2, 3)
        dyf = dy.float()
        xhat = (x.float() - mu[:, None, None]) * rstd[:, None, None]
        local = torch.stack([dyf.sum(dims), (dyf * xhat).sum(dims)])
        dbias, dscale = local[0], local[1]
        g = _summed(local.clone(), ctx.mesh) / ctx.count
        dx = (scale * rstd)[:, None, None] * (
            dyf - g[0][:, None, None] - xhat * g[1][:, None, None])
        return dx.to(x.dtype), dscale, dbias, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    dim of NCHW tensors (see the module docstring); ``mesh`` is the data
    axis its training statistics are summed over."""

    def __init__(self, c: int, zero_scale: bool = False,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(c) if zero_scale
                                  else torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.mesh = mesh

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            y, mu, var = _BatchNormTrain.apply(x, self.scale, self.bias,
                                               self.mesh)
            with torch.no_grad():
                self.mean.copy_(_MOMENTUM * self.mean
                                + (1 - _MOMENTUM) * mu)
                self.var.copy_(_MOMENTUM * self.var + (1 - _MOMENTUM) * var)
            return y
        mul = torch.rsqrt(self.var + _EPS) * self.scale
        y = (x.float() - self.mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


class BasicBlock(nn.Module):
    """Two 3×3 convolutions and a projection where the shape changes
    (flax names: ``Conv_0``, ``BatchNorm_0``, ``Conv_1``, ``BatchNorm_1``,
    ``proj``, ``proj_bn``)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, strides: int = 1,
                 generator: Optional[torch.Generator] = None,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 3, strides, generator)
        self.BatchNorm_0 = BatchNorm(filters, mesh=mesh)
        self.Conv_1 = Conv(filters, filters, 3, 1, generator)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True, mesh=mesh)
        self.proj = self.proj_bn = None
        if strides != 1 or cin != filters:
            self.proj = Conv(cin, filters, 1, strides, generator)
            self.proj_bn = BatchNorm(filters, mesh=mesh)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        if self.proj is not None:
            x = self.proj_bn(self.proj(x), train)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """1×1, 3×3 (strided), 1×1 (×4 wide) and a projection where the shape
    changes (flax names ``Conv_0..2``, ``BatchNorm_0..2``, ``proj``,
    ``proj_bn``)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, strides: int = 1,
                 generator: Optional[torch.Generator] = None,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(cin, filters, 1, 1, generator)
        self.BatchNorm_0 = BatchNorm(filters, mesh=mesh)
        self.Conv_1 = Conv(filters, filters, 3, strides, generator)
        self.BatchNorm_1 = BatchNorm(filters, mesh=mesh)
        self.Conv_2 = Conv(filters, out, 1, 1, generator)
        self.BatchNorm_2 = BatchNorm(out, zero_scale=True, mesh=mesh)
        self.proj = self.proj_bn = None
        if strides != 1 or cin != out:
            self.proj = Conv(cin, out, 1, strides, generator)
            self.proj_bn = BatchNorm(out, mesh=mesh)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        if self.proj is not None:
            x = self.proj_bn(self.proj(x), train)
        return F.relu(x + y)


class ResNet(nn.Module):
    """ResNet over NHWC uint8/float inputs; logits ``[N, num_classes]``
    f32.  Submodules carry flax's names (``stem``, ``stem_bn``,
    ``BasicBlock_i`` / ``BottleneckBlock_i`` numbered across the stages,
    ``head``)."""

    def __init__(self, stage_sizes: Sequence[int], bottleneck: bool = True,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        block_cls = BottleneckBlock if bottleneck else BasicBlock
        self.stem = Conv(in_channels, num_filters, 7, 2, generator)
        self.stem_bn = BatchNorm(num_filters, mesh=mesh)
        self.block_names: List[str] = []
        cin = num_filters
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                self.add_module(name, block_cls(cin, filters, strides,
                                                generator, mesh))
                self.block_names.append(name)
                cin = filters * block_cls.expansion
        self.head = nn.Linear(cin, num_classes)
        _lecun_normal_(self.head.weight.data, cin, generator)
        nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        # on-device normalization: u8 → centered f32 → compute dtype
        x = x.to(torch.float32) / 255.0
        x = (x - 0.5) / 0.25
        x = x.to(self.dtype).permute(0, 3, 1, 2)    # channels_last memory
        x = F.relu(self.stem_bn(self.stem(x), train))
        ph, pw = same_pads(x.shape[2], 3, 2), same_pads(x.shape[3], 3, 2)
        x = F.max_pool2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1]),
                               value=float("-inf")), 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = x.float().mean((2, 3)).to(self.dtype)
        return self.head(x.float())


class ResNetParam(Parameter):
    variant = field(str, default="resnet50", enum=sorted(RESNET_STAGES))
    num_classes = field(int, default=1000, lower_bound=2)
    learning_rate = field(float, default=0.1, lower_bound=0.0)
    momentum = field(float, default=0.9, lower_bound=0.0)
    weight_decay = field(float, default=1e-4, lower_bound=0.0)
    label_smoothing = field(float, default=0.1, lower_bound=0.0, upper_bound=0.5)


class ResNetTrainer:
    """Data-parallel trainer: state replicated on every rank of the
    ``data`` axis, the global batch split over it (one process per card).

    ``dtype`` is the compute dtype of the convolutions and BN outputs
    (JAX's ``ResNet.dtype``; bf16 by default, ``torch.float32`` for an f32
    model)."""

    def __init__(self, param: Optional[ResNetParam] = None,
                 mesh: Optional[Mesh] = None, device: Any = None,
                 dtype: torch.dtype = torch.bfloat16, **kwargs: Any):
        self.param = param or ResNetParam()
        if kwargs:
            self.param.init(kwargs)
        self.mesh = mesh if mesh is not None else local_mesh()
        CHECK("data" in self.mesh.axis_names, "mesh needs a 'data' axis")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.stages, self.bottleneck = RESNET_STAGES[self.param.variant]
        self.model: Optional[ResNet] = None
        self.opt: Optional[torch.optim.SGD] = None
        self.step = 0

    # -- setup ---------------------------------------------------------
    def init(self, image_shape: Tuple[int, int, int], seed: int = 0) -> None:
        """Fresh weights from ``torch.Generator().manual_seed(seed)`` (the
        same on every rank) and a fresh optimizer."""
        gen = torch.Generator().manual_seed(seed)
        self.model = ResNet(self.stages, self.bottleneck,
                            num_classes=self.param.num_classes,
                            dtype=self.dtype, in_channels=image_shape[2],
                            generator=gen, mesh=self.mesh).to(self.device)
        self._new_optimizer()

    def _new_optimizer(self) -> None:
        p = self.param
        self.opt = torch.optim.SGD(self.model.parameters(),
                                   lr=p.learning_rate, momentum=p.momentum,
                                   weight_decay=p.weight_decay)
        self.step = 0

    def params_from_numpy(self, params: Dict[str, Any],
                          batch_stats: Dict[str, Any]) -> None:
        """Load flax's nested ``params`` / ``batch_stats`` (numpy arrays,
        e.g. ``jax.tree.map(np.asarray, variables)``) into the model:
        conv kernels HWIO → OIHW, the head's ``[in, out]`` → ``[out, in]``;
        the optimizer starts fresh, as after JAX's ``init``."""
        if self.model is None:
            leaf = np.asarray(params["stem"]["kernel"])
            self.init((1, 1, leaf.shape[2]))
        named = dict(self.model.named_parameters())
        named.update(self.model.named_buffers())
        seen = set()

        def put(name: str, arr: Any) -> None:
            CHECK(name in named, f"params_from_numpy: no tensor {name!r}")
            t = torch.from_numpy(np.array(arr, np.float32))
            if t.dim() == 4:
                t = t.permute(3, 2, 0, 1)
            elif t.dim() == 2:
                t = t.t()
            CHECK(tuple(t.shape) == tuple(named[name].shape),
                  f"params_from_numpy: {name} has shape {tuple(t.shape)}, "
                  f"the model {tuple(named[name].shape)}")
            with torch.no_grad():
                named[name].copy_(t)
            seen.add(name)

        def walk(tree: Dict[str, Any], prefix: str, rename) -> None:
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}.", rename)
                else:
                    put(prefix + rename.get(k, k), v)

        walk(params, "", {"kernel": "weight"})
        walk(batch_stats, "", {})
        CHECK(seen == set(named),
              f"params_from_numpy: missing {sorted(set(named) - seen)}")
        self._new_optimizer()

    def numpy_params(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """The model's state as flax's nested ``(params, batch_stats)`` of
        numpy arrays (the inverse of :meth:`params_from_numpy`)."""
        params: Dict[str, Any] = {}
        stats: Dict[str, Any] = {}
        for name, t in list(self.model.named_parameters()) + \
                list(self.model.named_buffers()):
            *path, leaf = name.split(".")
            a = t.detach().float().cpu().numpy()
            if leaf in ("mean", "var"):
                node = stats
            else:
                node = params
                if leaf == "weight":
                    leaf = "kernel"
                    a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = np.ascontiguousarray(a)
        return params, stats

    # -- training ------------------------------------------------------
    def train_step(self, images: Any, labels: Any
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One SGD step on this rank's share of the global batch
        (``images [B, H, W, C]``, ``labels [B]``); returns the global-batch
        ``(loss, acc)`` as 0-d tensors on the device (no host sync)."""
        CHECK(self.model is not None, "call init() first")
        images = torch.as_tensor(images, device=self.device)
        labels = torch.as_tensor(labels, device=self.device).long()
        n_ranks = self.mesh.size
        global_b = images.shape[0] * n_ranks
        logits = self.model(images, train=True)
        ce = F.cross_entropy(logits, labels, reduction="sum",
                             label_smoothing=self.param.label_smoothing)
        (ce / global_b).backward()
        hits = (logits.detach().argmax(-1) == labels).sum()
        params = [p for p in self.model.parameters()]
        if n_ranks > 1:
            flat = torch.cat([p.grad.reshape(-1) for p in params]
                             + [ce.detach().reshape(1),
                                hits.float().reshape(1)])
            collectives.device_allreduce(flat, self.mesh)
            off = 0
            for p in params:
                p.grad.copy_(flat[off:off + p.numel()].view_as(p))
                off += p.numel()
            ce_sum, hits_sum = flat[-2], flat[-1]
        else:
            ce_sum, hits_sum = ce.detach(), hits.float()
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.step += 1
        return ce_sum / global_b, hits_sum / global_b

    def fit_from_records(
        self,
        uri: str,
        part: int = 0,
        nparts: int = 1,
        batch_size: int = 256,
        image_shape: Tuple[int, int, int] = (224, 224, 3),
        epochs: int = 1,
        shuffle_buffer: int = 0,
        log_every: int = 0,
        feed_depth: int = 2,
    ) -> Dict[str, float]:
        """BASELINE config 2 end-to-end: sharded RecordIO → DeviceFeed →
        train steps.  Returns throughput + infeed-stall stats.

        ``batch_size`` is the GLOBAL batch, as in JAX, where one
        controller reads ``batch_size`` records of ``part``/``nparts`` a
        step and shards them over the ``data`` axis.  Here each of the N
        ranks of the axis reads its own byte range, split
        ``part·N + rank`` of ``nparts·N``, ``batch_size / N`` records a
        step; the global batch is the union of the ranks' batches, so it
        holds the same number of records from the same shard set, drawn
        from N byte ranges instead of one.  Every rank takes the same
        number of steps: a step runs only while every rank still has a
        batch (one host ``allreduce`` of a flag a step on N > 1)."""
        if self.model is None:
            self.init(image_shape)
        n_ranks, rank = self.mesh.size, self.mesh.rank
        CHECK(batch_size % n_ranks == 0,
              f"batch_size {batch_size} must divide over {n_ranks} ranks")
        local_b = batch_size // n_ranks

        def make_host_iter():
            return batch_iterator(uri, part * n_ranks + rank,
                                  nparts * n_ranks, local_b, image_shape,
                                  shuffle_buffer=shuffle_buffer)

        n_steps = 0
        n_records = 0
        loss = None
        t0 = get_time()
        with DeviceFeed(make_host_iter, self.device,
                        depth=feed_depth) as feed:
            for _epoch in range(epochs):
                it = iter(feed)
                while True:
                    batch = next(it, None)
                    if n_ranks > 1:
                        have = collectives.allreduce(
                            np.array([batch is not None], np.int64), "min")
                        if not have[0]:
                            break
                    if batch is None:
                        break
                    images, labels = batch
                    loss, acc = self.train_step(images, labels)
                    n_steps += 1
                    n_records += images.shape[0] * n_ranks
                    if log_every and n_steps % log_every == 0:
                        LOG("INFO", "step %d: loss=%.4f acc=%.3f",
                            n_steps, float(loss), float(acc))
                feed.before_first()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            last_loss = float(loss) if loss is not None else float("nan")
            stats = feed.stats.as_dict()
        wall = get_time() - t0
        return {
            "steps": n_steps,
            "records": n_records,
            "records_per_sec": n_records / max(wall, 1e-9),
            "last_loss": last_loss,
            "infeed_stall_fraction": stats["stall_fraction"],
            "seconds": wall,
        }
