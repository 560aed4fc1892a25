"""``PipelineParallel``: the port of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``.

The JAX package runs every stage in one SPMD program (a ``lax.scan``
over ticks, ``ppermute`` between stage shards). The port runs one
process per rank, as Paddle does: each stage rank holds only its own
layers (``PipelineLayer``), and a host loop walks this rank's row of the
schedule table, moving activations and gradients by p2p between
neighbouring stage ranks (``pp_utils.p2p_communication``).

The tables are the contract with the JAX package:

- ``FThenB`` (``gpipe``): ``zero_bubble.make_schedule(S, M, "fthenb")``,
  every forward, then every backward;
- ``1F1B``: ``make_schedule(S, M, "1f1b")``: a stage keeps at most
  ``S - d`` microbatches in flight, the table's ``_buffer_slots`` peak,
  which the loop checks;
- ``ZB-H1``: ``make_schedule(S, M, "zb_h1")``: ``B`` gives the input
  gradient only (``torch.autograd.grad`` for the stage input, the graph
  retained), ``W`` the weight gradients later (``torch.autograd.grad``
  for the stage's parameters); a stage that recomputes cannot walk its
  graph twice (selective checkpointing allows one backward), so there
  ``W`` runs the stage forward again from its kept input, as the JAX
  engine's ``W`` does;
- ``interleaved`` (``vpp``, or FThenB over a ``PipelineLayer`` of ``V > 1``
  virtual stages): ``pipeline.interleaved_schedule(S, M, V)``, chunk ``c``
  on stage rank ``c % S``, the forward at the JAX closed-form ticks and
  the backward mirrored.

``F`` on the first chunk takes the microbatch's inputs (the prologue,
the embedding, is its first layer); on the last it ends in ``loss_fn``
(the epilogue, norm and head, are its last layers). The last stage's
backward starts from ``loss / accumulate_steps`` (times a scaler's
scale). After the schedule, the shared weights' gradients are summed
between their holders and, at ``dp_degree > 1``, every gradient is
averaged over the ``data`` group; ZeRO 1/2 over the ``sharding`` group
reduces its own in the optimizer's ``step``. ``train_batch`` and
``eval_batch`` return the mean loss over the microbatches on every rank
(broadcast from the last stage). At ``pp_degree == 1`` ``train_batch`` is
the eager microbatch loop.

Context parallelism (``sep_degree > 1``, stage layers with
``sep_parallel``): every rank passes its own chunk of the sequence
(``context_parallel.split_inputs_sequence_dim``), so the microbatch
stream is split over ``sep``; a stage rank's pipe peers are the stage
ranks of its sep index (``get_rank_from_stage``), and the sep ranks of a
stage walk the same row, so the attention's collectives over ``sep``
meet in the same order. The last stage's loss is the criterion's over
the whole sequence (``sep_shifted_cross_entropy``), and the gradients
are averaged over the data x sep ranks. ``ring`` under 1F1B or ZB-H1
raises, as in the JAX package (its tick engine broke the ring's
rotation; this host loop could lift the refusal, ROADMAP A.7).
Expert parallelism (``ep_degree > 1``): the ranks of a stage's
``expert`` group hold the same microbatches and walk the same row, so
the MoE layers' all-to-alls over that group meet in the same order; each
stage rank keeps its own block of each bank (and its optimizer state),
and the gradients are averaged over ``data`` only, as without the
pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from ...zero_bubble import B, F, NOP, _buffer_slots, make_schedule
from .pp_utils.p2p_communication import SendRecv

__all__ = ["PipelineParallel"]

#: strategy.pipeline_configs["schedule_mode"] -> the schedule
_SCHEDULES = {
    "fthenb": "fthenb", "f-then-b": "fthenb", "f_then_b": "fthenb",
    "gpipe": "fthenb",
    "interleaved": "interleaved", "vpp": "interleaved",
    "interleaved-1f1b": "interleaved", "interleaved_1f1b": "interleaved",
    "1f1b": "1f1b", "zb_h1": "zb_h1", "zb-h1": "zb_h1", "zbh1": "zb_h1",
}

#: the schedules that run virtual stages (the JAX package's scan engine)
_SCAN_SCHEDULES = ("fthenb", "interleaved")


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _unpack(ts):
    return ts[0] if len(ts) == 1 else tuple(ts)


class PipelineParallel:
    def __init__(self, layers, hcg, accumulate_steps=1, strategy=None,
                 schedule_mode=None, num_virtual_pipeline_stages=None):
        self._layers = layers
        self._hcg = hcg
        self.accumulate_steps = max(int(accumulate_steps), 1)
        self._pp_degree = (hcg.get_pipe_parallel_world_size()
                           if hcg is not None else 1)
        if strategy is not None:
            if schedule_mode is None:
                schedule_mode = strategy.pipeline_configs.get(
                    "schedule_mode", "FThenB")
            if num_virtual_pipeline_stages is None:
                num_virtual_pipeline_stages = strategy.pipeline_configs.get(
                    "num_virtual_pipeline_stages")
        raw = str(schedule_mode or "FThenB")
        try:
            self._schedule = _SCHEDULES[raw.lower().strip()]
        except KeyError:
            raise ValueError(
                f"unknown pipeline schedule_mode {raw!r}; one of "
                f"{sorted(set(_SCHEDULES))}") from None
        v_layer = max(int(getattr(layers, "_num_virtual", 1) or 1), 1)
        v_cfg = (max(int(num_virtual_pipeline_stages), 1)
                 if num_virtual_pipeline_stages is not None else None)
        if v_cfg is not None and v_cfg > 1 and v_layer > 1 and \
                v_cfg != v_layer:
            raise ValueError(
                f"num_virtual_pipeline_stages={v_cfg} conflicts with the "
                f"PipelineLayer's num_virtual_pipeline_stages={v_layer}")
        self._num_virtual = v_cfg if v_cfg is not None else v_layer
        if self._schedule == "interleaved" and self._num_virtual <= 1:
            raise ValueError(
                "schedule_mode='interleaved' needs virtual pipeline "
                "stages: set pipeline_configs['num_virtual_pipeline_"
                "stages'] > 1 (or build the PipelineLayer with "
                "num_virtual_pipeline_stages > 1)")
        if self._pp_degree > 1:
            if self._schedule not in _SCAN_SCHEDULES and \
                    self._num_virtual > 1:
                raise ValueError(
                    "explicit schedules (1F1B/ZB-H1) do not support "
                    "virtual pipeline stages; use schedule_mode="
                    "'interleaved' or num_virtual_pipeline_stages=1")
            if self._schedule not in _SCAN_SCHEDULES and \
                    self._sep_impl() == "ring" and \
                    hcg.get_sep_parallel_world_size() > 1:
                raise ValueError(
                    "ring context parallelism under the explicit "
                    "1F1B/ZB-H1 schedules is not supported (the JAX "
                    "package's refusal: its tick engine broke the ring's "
                    "rotation). Use sep_parallel='allgather' or "
                    "'ulysses' (degree <= num_heads), both supported "
                    "under every schedule, or the FThenB/interleaved "
                    "schedules for ring")
            if self._num_virtual != v_layer:
                # each rank built its chunks at construction
                raise ValueError(
                    f"num_virtual_pipeline_stages={self._num_virtual} over "
                    f"a PipelineLayer built with {v_layer}: a stage rank "
                    "builds its chunks when the layer is made; build the "
                    "PipelineLayer with the same count")
            self._init_stage()
        #: the most microbatch graphs a step kept alive on this rank
        self.peak_live = 0

    def _sep_impl(self):
        """The layers' ``sep_parallel`` (``ring``, ``ulysses``,
        ``allgather``), or None: read from every layer's description (a
        config among its arguments), the same on every stage rank."""
        for d in getattr(self._layers, "_descs", ()):
            for a in tuple(d.inputs) + tuple(d.kwargs.values()):
                impl = getattr(a, "sep_parallel", None)
                if impl is not None:
                    return impl
        return None

    def _init_stage(self):
        hcg = self._hcg
        S = self._pp_degree
        self._stage = hcg.get_stage_id()
        self._group = hcg.get_pipe_parallel_group()
        self._ranks = [hcg.get_rank_from_stage(s) for s in range(S)]
        if hcg.get_dp_sep_parallel_world_size() > 1:
            from ...parallel import broadcast_module
            broadcast_module(self._layers, hcg.get_dp_sep_parallel_group())
        self._tables = {}

    def __getattr__(self, name):
        return getattr(self._layers, name)

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    # ---- the tables ---------------------------------------------------------

    def _row(self, M, train):
        """``(units, bound)``: this rank's ``(op, microbatch, local
        chunk)`` in order, and the most live graphs the table allows."""
        key = (M, train)
        if key in self._tables:
            return self._tables[key]
        from ...pipeline import fthenb_forward_table, interleaved_schedule
        S, d, V = self._pp_degree, self._stage, self._num_virtual
        if V > 1:
            op, mb, ch = interleaved_schedule(S, M, V, backward=train)
            bound = M * V
        elif train:
            op, mb = make_schedule(S, M, self._schedule)
            ch = np.zeros_like(op)
            bound = _buffer_slots(op, mb, S, M, self._schedule == "zb_h1")[0]
        else:
            op, mb = fthenb_forward_table(S, M)
            ch = np.zeros_like(op)
            bound = 1
        units = [(int(op[d, t]), int(mb[d, t]), int(ch[d, t]))
                 for t in range(op.shape[1]) if op[d, t] != NOP]
        self._tables[key] = units, bound
        return units, bound

    # ---- the stage loop --------------------------------------------------

    def _peer(self, c):
        return self._ranks[c % self._pp_degree]

    def _run_schedule(self, inputs, labels, train, scale=1.0):
        """Walk this rank's row; returns the last stage's microbatch
        losses (a list of 0-d tensors; empty elsewhere)."""
        dev = self._layers._device
        M = self.accumulate_steps
        S, V = self._pp_degree, self._num_virtual
        if inputs.shape[0] % M:
            raise ValueError(f"batch {inputs.shape[0]} not divisible by "
                             f"accumulate_steps {M}")
        micro_x = [t.to(dev) for t in torch.as_tensor(inputs).chunk(M)]
        micro_y = None if labels is None else \
            [t.to(dev) for t in torch.as_tensor(labels).chunk(M)]
        units, bound = self._row(M, train)
        zb = train and self._schedule == "zb_h1" and V == 1
        comm = SendRecv(self._group, dev)
        self._scale = scale / M
        live, losses, peak = {}, [], 0
        try:
            for op, m, v in units:
                c = v * S + self._stage
                if op == F:
                    entry = self._forward(comm, c, v, m, micro_x, micro_y,
                                          train, losses)
                    if train:
                        live[(m, v)] = entry
                        peak = max(peak, len(live))
                elif op == B:
                    self._backward(comm, c, live, m, v, zb)
                else:
                    self._weight_grads(live.pop((m, v)), v)
        finally:
            comm.wait()
        if live:
            raise RuntimeError(f"pipeline stage {self._stage}: microbatches "
                               f"{sorted(live)} left unfinished")
        if peak > bound:
            raise RuntimeError(
                f"pipeline stage {self._stage}: {peak} microbatch graphs "
                f"alive at once, over the table's bound {bound}")
        self.peak_live = peak
        return losses

    def _forward(self, comm, c, v, m, micro_x, micro_y, train, losses):
        """``F``: the chunk over the microbatch's input (received, except
        on the first chunk); the last chunk's loss, or the output sent on.
        Returns what the backward needs."""
        L = self._pp_degree * self._num_virtual
        if c == 0:
            x = (micro_x[m],)
        else:
            x = tuple(comm.recv_forward(self._peer(c - 1), train))
        label = micro_y[m] if c == L - 1 else None
        with torch.set_grad_enabled(train):
            y = _as_tuple(self._layers.forward_chunk(v, _unpack(x)))
            if label is not None:
                loss = self._layers._loss_fn(_unpack(y), label)
                losses.append(loss.detach().float())
                y = (loss,)
        if label is None:
            comm.send_forward(y, self._peer(c + 1))
        return {"x": x, "y": y, "label": label}

    def _outputs(self, entry, comm, c):
        """The tensors the chunk's backward starts from, and their
        gradients (received from the next chunk's rank)."""
        if entry["label"] is not None:
            return [entry["y"][0] * self._scale], [None]
        y = entry["y"]
        return ([t for t in y if t.is_floating_point()],
                comm.recv_backward(self._peer(c + 1), y))

    def _backward(self, comm, c, live, m, v, zb):
        """``B``: the input gradient sent to the previous chunk's rank;
        the weight gradients too, except under ZB-H1 (``W``)."""
        entry = live[(m, v)]
        outs, grads = self._outputs(entry, comm, c)
        leaves = [t for t in entry["x"] if t.requires_grad]
        if zb:
            dx = torch.autograd.grad(outs, leaves, grads, retain_graph=True,
                                     allow_unused=True) if leaves else ()
            entry.update(outs=outs, grads=grads)
        else:
            torch.autograd.backward(outs, grads)
            dx = [t.grad for t in leaves]
            del live[(m, v)]
        if c > 0:
            comm.send_backward([torch.zeros_like(t) if g is None else g
                                for t, g in zip(leaves, dx)],
                               self._peer(c - 1))

    def _weight_grads(self, entry, v):
        """ZB-H1's ``W``: the chunk's parameter gradients of one
        microbatch, accumulated into ``.grad``."""
        outs, grads = entry["outs"], entry["grads"]
        params = [p for p in self._layers.chunk_parameters(v)
                  if p.requires_grad]
        if self._layers._recompute_interval:
            # a recomputed graph takes one backward only: run the chunk
            # again from its kept input
            xs = tuple(t.detach().requires_grad_(t.requires_grad)
                       for t in entry["x"])
            with torch.enable_grad():
                out = _as_tuple(self._layers.forward_chunk(v, _unpack(xs)))
                if entry["label"] is not None:
                    outs = [self._layers._loss_fn(_unpack(out),
                                                  entry["label"])
                            * self._scale]
                else:
                    outs = [t for t in out if t.is_floating_point()]
        gs = torch.autograd.grad(outs, params, grads, allow_unused=True)
        with torch.no_grad():
            for p, g in zip(params, gs):
                if g is None:
                    continue
                if p.grad is None:
                    p.grad = g
                else:
                    p.grad.add_(g)

    # ---- after the schedule --------------------------------------------

    def _sync_grads(self):
        self._layers.allreduce_shared_weight_gradients()
        if self._hcg.get_dp_sep_parallel_world_size() > 1:
            from ...parallel import average_grads
            average_grads(list(self._layers.parameters()),
                          self._hcg.get_dp_sep_parallel_group())

    def _mean_loss(self, losses):
        """The mean of the last stage's losses, on every stage rank."""
        from ...communication import broadcast
        if losses:
            t = torch.stack(losses).mean()
        else:
            t = torch.zeros((), dtype=torch.float32,
                            device=self._layers._device)
        broadcast(t, src=self._ranks[-1], group=self._group)
        return t

    def forward_backward_pipeline(self, data, scaler=None):
        """One step's forward and backward over ``accumulate_steps``
        microbatches, the gradients summed between shared weights' holders
        and averaged over the data (x sep) ranks: the mean loss on every
        rank (no optimizer step)."""
        inputs, labels = data
        self._layers.train()
        scale = scaler._scale if scaler is not None and \
            scaler.is_enable() else 1.0
        losses = self._run_schedule(inputs, labels, True, scale)
        self._sync_grads()
        return self._mean_loss(losses)

    def _optimizer_step(self, optimizer, lr_scheduler=None, scaler=None):
        if scaler is not None and scaler.is_enable():
            from ...communication import all_reduce
            scaler.unscale_(optimizer)
            bad = torch.tensor([float(scaler._found_inf)],
                               device=self._layers._device)
            all_reduce(bad, "max")
            scaler._found_inf = bool(bad.item())
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()

    # ---- train / eval ---------------------------------------------------

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One optimizer step over ``accumulate_steps`` microbatches:
        the mean loss (Paddle's semantics), on every rank."""
        if self._pp_degree > 1:
            loss = self.forward_backward_pipeline(data, scaler)
            self._optimizer_step(optimizer, lr_scheduler, scaler)
            return loss
        inputs, labels = data
        n = self.accumulate_steps
        micro_x = torch.as_tensor(inputs).chunk(n)
        micro_y = torch.as_tensor(labels).chunk(n)
        total = None
        for mx, my in zip(micro_x, micro_y):
            loss = self._layers._loss_fn(self._layers(mx), my)
            scaled = loss / float(n)
            if scaler is not None:
                scaled = scaler.scale(scaled)
            scaled.backward()
            total = loss.detach() if total is None else total + loss.detach()
        if scaler is not None:
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total / float(n)

    def eval_batch(self, data, compute_loss=True):
        """The mean loss over the microbatches (with ``compute_loss`` and
        a ``loss_fn``), else the outputs; on every rank."""
        inputs, labels = data
        if self._pp_degree == 1:
            with torch.no_grad():
                out = self._layers(inputs)
                if compute_loss and self._layers._loss_fn is not None:
                    return self._layers._loss_fn(out, labels)
                return out
        if not compute_loss or self._layers._loss_fn is None:
            raise NotImplementedError(
                "eval_batch(compute_loss=False) at pp_degree > 1: the "
                "outputs stay on the last stage; evaluate a loss_fn")
        self._layers.eval()
        try:
            with torch.no_grad():
                losses = self._run_schedule(inputs, labels, False)
        finally:
            self._layers.train()
        return self._mean_loss(losses)
