"""Several train or eval steps per dispatch on the card: K steps captured into
one CUDA graph and replayed (the port's counterpart of the reference's
``lax.scan`` in ``make_multi_train_step`` and ``make_multi_eval_step``).

A call takes batches stacked (K, B, ...) and copies them into the graph's
static input buffers. The first call runs its K steps eagerly on a side
stream: it is the warm-up (cuBLAS handles, the optimizer's state, each
kernel's shared-memory limit and tensor-map entry point) and its steps are
real. The second call captures the same K steps into a ``CUDAGraph`` and
replays it; every later call is one replay. A capture that fails raises: no
call falls back to eager steps.

What keeps a captured step equal to an eager one:

- the optimizer is capturable (``optim.make_capturable``): its ``lr`` is a
  device tensor that the graph sets before each step from a (K + 1, groups)
  buffer, copied in once per call from pinned host memory in ``current_lr``'s
  float32 arithmetic (``optim.scheduled_lrs``); row K is the rate of the step
  after the chunk. The schedule's count is advanced by K on the host after
  each call;
- the dropout generator is registered with the graph, so each replay draws
  new masks and the generator's state advances as K eager steps advance it;
- the step waits on nothing: no host read, no shape that depends on data;
- every trained parameter has a gradient before the optimizer's step
  (``optim.zero_missing_grads``, zeros from the graph's pool where the
  backward leaves none), so the captured step updates the parameters an
  eager step updates.

Under a mesh (``parallel.mesh.Mesh``) each step's collectives (the batch
statistics' all-reduces, the outputs' all-gathers, the gradients'
all-reduce) are captured with it: the warm-up chunk runs them first, so
the communicator exists and is warm before the capture. A capture
forbids unsafe CUDA calls of the capturing thread only
(``CAPTURE_ERROR_MODE``): the group's watchdog thread, like the loader's
threads, may call CUDA while the main thread captures.

Kernel wrappers count their launches in Python, which a replay does not
run: the graph records what its capture launched, and each replay adds that
to each wrapper's count (``launches_per_replay``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from concepthash_tpu_torch.train.optim import make_capturable, scheduled_lrs

# A capture checks the CUDA calls of its own thread only: the process's
# other threads (a process group's watchdog, the loader's, the profiler's)
# may call CUDA while a chunk is captured, which a process-wide ('global')
# check would count against the capture.
CAPTURE_ERROR_MODE = "thread_local"


def _counted_wrappers() -> tuple:
    """The kernel wrappers that count their launches."""
    from concepthash_tpu_torch.ops import (attention, fused_layer, fused_ln,
                                           topk_select)

    return tuple(w for w in (fused_layer.encoder_layer_cuda,
                             fused_ln.ln_matmul_cuda, attention.attention_cuda,
                             topk_select.subblock_mins_cuda,
                             topk_select.subblock_mins_bitplane_cuda)
                 if hasattr(w, "launches"))


class _GraphedSteps:
    """The warm-up, capture and replay shared by the train and eval
    runners. A subclass fills the static outputs from the static inputs in
    ``_run`` and may prepare each call in ``_prepare``."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.generator = generator
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.calls = 0
        self.replays = 0
        self.static: Optional[dict] = None
        self.out: Optional[dict] = None
        self.launches_per_replay: dict = {}
        self._counted: list = []

    @property
    def K(self) -> int:
        return next(iter(self.static.values())).shape[0]

    def _load(self, batches: dict) -> None:
        if self.static is None:
            self.static = {k: torch.empty_like(v) for k, v in batches.items()}
        shapes = {k: (tuple(v.shape), v.dtype) for k, v in batches.items()}
        want = {k: (tuple(v.shape), v.dtype) for k, v in self.static.items()}
        if shapes != want:
            raise ValueError(f"a graphed chunk takes batches of {want}; got "
                             f"{shapes} (chunks of another size run through "
                             "the single step)")
        for k, v in batches.items():
            if v.data_ptr() != self.static[k].data_ptr():
                self.static[k].copy_(v, non_blocking=True)

    def _prepare(self) -> None:
        pass

    def _run(self) -> None:
        raise NotImplementedError

    def _after(self) -> None:
        pass

    def _warm_up(self) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._run()
        torch.cuda.current_stream().wait_stream(side)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None and self.generator.device.type == "cuda":
            graph.register_generator_state(self.generator)
        wrappers = _counted_wrappers()
        before = [w.launches for w in wrappers]
        with torch.cuda.graph(graph, capture_error_mode=CAPTURE_ERROR_MODE):
            self._run()
        # capture records the launches and runs none of them
        self._counted = []
        for w, n in zip(wrappers, before):
            if w.launches != n:
                self._counted.append((w, w.launches - n))
                self.launches_per_replay[w.__name__] = w.launches - n
            w.launches = n
        self.graph = graph

    def __call__(self, batches: dict):
        self._load(batches)
        self._prepare()
        if self.calls == 0:
            self._warm_up()
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            self.replays += 1
            for w, n in self._counted:
                w.launches += n
        self.calls += 1
        self._after()
        return self._result()


class GraphedTrainSteps(_GraphedSteps):
    """``make_multi_train_step`` on the card: ``step(batches) -> metrics``,
    batches {'image': (K, B, H, W, C) preprocessed, 'label': (K, B, C)} and
    any other (K, ...) tensors the loss reads (SSDH's (K, B, B) ``aux``),
    each metric (K,). Turns the optimizer capturable when built; its state
    and schedule stay shared with the single step."""

    def __init__(self, model: nn.Module, loss_fn: Callable,
                 optimizer: torch.optim.Optimizer, scheduler=None,
                 output_attentions: bool = False,
                 generator: Optional[torch.Generator] = None, mesh=None,
                 views: int = 1):
        super().__init__(generator)
        self.model, self.loss_fn = model, loss_fn
        self.mesh, self.views = mesh, views
        self.optimizer, self.scheduler = optimizer, scheduler
        self.output_attentions = output_attentions
        self.lr_tensors = make_capturable(optimizer)
        self._lr_host = [None, None]
        self._lr_event = [None, None]
        self._flip = 0
        self.lr_dev: Optional[torch.Tensor] = None
        self.lr_used: Optional[torch.Tensor] = None
        self.last_lrs: Optional[torch.Tensor] = None

    def _lrs(self, K: int) -> np.ndarray:
        if self.scheduler is None:
            return np.tile(np.array([float(t) for t in self.lr_tensors],
                                    np.float32), (K + 1, 1))
        return scheduled_lrs(self.scheduler, int(self.scheduler.last_epoch),
                             K + 1)

    def _prepare(self) -> None:
        """Stage this chunk's learning rates: a pinned host buffer (two,
        alternating; one is refilled only once the copy made from it two
        calls ago is done), then a copy that does not wait."""
        K = self.K
        G = len(self.lr_tensors)
        dev = self.lr_tensors[0].device
        if self.lr_dev is None:
            self.lr_dev = torch.empty((K + 1, G), dtype=torch.float32,
                                      device=dev)
            self.lr_used = torch.empty(K, dtype=torch.float32, device=dev)
            self._lr_host = [torch.empty((K + 1, G), dtype=torch.float32)
                             .pin_memory() for _ in range(2)]
        self._flip ^= 1
        if self._lr_event[self._flip] is not None:
            self._lr_event[self._flip].synchronize()
        host = self._lr_host[self._flip]
        host.copy_(torch.from_numpy(self._lrs(K)))
        self.lr_dev.copy_(host, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._lr_event[self._flip] = event

    def _run(self) -> None:
        from concepthash_tpu_torch.train.state import (accuracy_metrics,
                                                       backward,
                                                       sharded_forward)

        K = self.K
        for k in range(K):
            for g, lr in enumerate(self.lr_tensors):
                lr.copy_(self.lr_dev[k, g])
            self.lr_used[k].copy_(self.lr_tensors[0])
            batch = {n: v[k] for n, v in self.static.items()}
            out, batch = sharded_forward(
                self.model, batch, self.mesh, self.views, train=True,
                output_attentions=self.output_attentions,
                generator=self.generator)
            total, parts = self.loss_fn(out, batch)
            backward(total, self.optimizer, self.mesh)
            self.optimizer.step()
            with torch.no_grad():
                metrics = {"loss": total.detach(),
                           **{n: v.detach() for n, v in parts.items()},
                           **accuracy_metrics(out, batch["label"])}
                if self.out is None:
                    self.out = {n: torch.empty(K, dtype=v.dtype,
                                               device=v.device)
                                for n, v in metrics.items()}
                for n, v in metrics.items():
                    self.out[n][k].copy_(v)
        for g, lr in enumerate(self.lr_tensors):
            lr.copy_(self.lr_dev[K, g])

    def _after(self) -> None:
        if self.scheduler is not None:
            self.scheduler.last_epoch += self.K
        self.last_lrs = self.lr_used.clone()

    def _result(self) -> dict:
        return {n: v.clone() for n, v in self.out.items()}


class GraphedEvalSteps(_GraphedSteps):
    """``make_multi_eval_step`` on the card: ``multi(batches) -> (codes,
    metrics)``, batches {'image': (K, B, H, W, C) preprocessed[, 'label']},
    codes (K, B, nbit) and metrics (K,), in inference mode."""

    def __init__(self, model: nn.Module, loss_fn: Optional[Callable] = None,
                 mesh=None):
        super().__init__()
        from concepthash_tpu_torch.train.state import make_eval_step

        self.step = make_eval_step(model, loss_fn, mesh)
        self.metrics_out: Optional[dict] = None

    def _run(self) -> None:
        K = self.K
        with torch.inference_mode():
            for k in range(K):
                codes, metrics = self.step(
                    {n: v[k] for n, v in self.static.items()})
                if self.out is None:
                    self.out = {n: torch.empty((K, *v.shape), dtype=v.dtype,
                                               device=v.device)
                                for n, v in codes.items()}
                    self.metrics_out = {
                        n: torch.empty(K, dtype=v.dtype, device=v.device)
                        for n, v in metrics.items()}
                for n, v in codes.items():
                    self.out[n][k].copy_(v)
                for n, v in metrics.items():
                    self.metrics_out[n][k].copy_(v)

    def _result(self):
        with torch.inference_mode():
            return ({n: v.clone() for n, v in self.out.items()},
                    {n: v.clone() for n, v in self.metrics_out.items()})
