"""Stage 3's gather-on-use and the gradient reduce-scatter of stages 2-3:
the port's counterpart of what GSPMD inserts for a ZeRO-3 sharded tree
(``deepspeed_tpu/runtime/zero_sharding.py``; reference ``stage3.py``'s
``PartitionedParameterCoordinator``).

``GatherUnits`` (stage 3). The compute copy lives as each rank's shards
(``zero_sharding.FlatLayout``). A gather unit's parameters are gathered
just before its module's forward: one all-gather of the unit's compute
shards into a whole buffer, and the parameters pointed at views of it.
After the forward the buffer is dropped and each parameter holds a
placeholder of its shape that owns one NaN (a stride-0 view), so autograd
can still accumulate its gradient and a forward that reaches a released
unit's weights outside its hooked modules gives NaN, not a silent zero. Parameters the forward saves
for the backward are kept out of autograd's saved tensors
(``torch.autograd.graph.saved_tensors_hooks``): the saved entry names the
unit and the view, and the backward gathers the unit again to unpack it,
so no unit is recomputed only to get its weights back. Under remat a unit
is recomputed anyway: its forward hook gathers it then, and nothing is
released inside a backward (the reduce releases it). The rest of the model
(embedding, final norm, head) is one unit, gathered around the whole
forward, so a tied embedding is whole at both its uses and its gradient is
one accumulation of both. The persistent unit is whole on every rank.

``GradReducer`` (stages 2-3). Once every parameter of a unit has its
gradient for a backward (``register_post_accumulate_grad_hook``), the
unit's gradients are laid out whole in the accumulation dtype,
reduce-scattered over the ZeRO group and added into the rank's shard of
the accumulation buffer; stage 3 then releases the unit. ``flush`` reduces
what is left at the end of the backward (a unit whose parameters took no
gradient reduces zeros), so every rank issues the same collectives in the
same order.
"""

import weakref

import torch

from ..comm import comm

_SAVED = "zero3_saved_view"


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


class GatherUnits:
    """Stage 3's gathered compute copy. ``shard``: this rank's flat
    compute shards; ``persistent_full``: the persistent unit's whole
    buffer (kept up to date by ``refresh_persistent``)."""

    def __init__(self, layout, params, shapes, shard, unit_modules, zero_axes, dtype, device):
        self.layout = layout
        self.params = params
        self.shapes = shapes
        self.shard = shard
        self.zero_axes = zero_axes
        self.full = [None] * len(layout.units)
        self.pins = [0] * len(layout.units)
        self._ptr = {}
        self._nan = torch.full((), float("nan"), dtype=dtype, device=device)
        self.gathers = 0  # all-gathers of a unit so far
        self._handles = []
        me = weakref.ref(self)
        for k, (u, mods) in enumerate(zip(layout.units, unit_modules)):
            if u.persistent:
                continue
            for m in mods:
                self._handles.append(m.register_forward_pre_hook(
                    lambda mod, args, k=k: me().materialize(k)))
                self._handles.append(m.register_forward_hook(
                    lambda mod, args, out, k=k: me().after_forward(k)))
        for k, u in enumerate(layout.units):
            if u.persistent:
                self.full[k] = torch.empty(u.length, dtype=dtype, device=device)
                self._point(k)
                self.refresh_persistent()
            else:
                self._placeholders(k)

    def remove_hooks(self):
        for h in self._handles:
            h.remove()
        self._handles = []

    def _point(self, k):
        u = self.layout.units[k]
        buf = self.full[k]
        for i, (a, b) in zip(u.params, u.bounds):
            self.params[i].data = buf[a:b].view(self.shapes[i])

    def _placeholders(self, k):
        for i in self.layout.units[k].params:
            self.params[i].data = self._nan.expand(self.shapes[i])

    @torch.no_grad()
    def materialize(self, k):
        """Gather unit ``k``'s compute shards and point its parameters at
        the whole buffer (nothing when it is gathered)."""
        if self.full[k] is not None:
            return
        u = self.layout.units[k]
        buf = comm.all_gather_into_tensor(None, self.layout.unit_shard(self.shard, u),
                                          group=self.zero_axes)
        self.gathers += 1
        self.full[k] = buf
        self._ptr[buf.untyped_storage().data_ptr()] = k
        self._point(k)

    def release(self, k):
        """Drop unit ``k``'s whole buffer (not the persistent unit's, nor a
        pinned one's)."""
        if self.full[k] is None or self.layout.units[k].persistent or self.pins[k]:
            return
        self._ptr.pop(self.full[k].untyped_storage().data_ptr(), None)
        self.full[k] = None
        self._placeholders(k)

    def after_forward(self, k):
        if not _in_backward():
            self.release(k)

    def release_all(self):
        for k in range(len(self.full)):
            self.release(k)

    @torch.no_grad()
    def refresh_persistent(self):
        for k, u in enumerate(self.layout.units):
            if u.persistent:
                comm.all_gather_into_tensor(self.full[k], self.layout.unit_shard(self.shard, u),
                                            group=self.zero_axes)

    # ---- saved tensors ----

    def pack(self, t):
        try:
            k = self._ptr.get(t.untyped_storage().data_ptr())
        except (RuntimeError, NotImplementedError):
            return t
        if k is None:
            return t
        return (_SAVED, k, t.storage_offset(), tuple(t.shape), t.stride())

    def unpack(self, x):
        if isinstance(x, tuple) and x and x[0] == _SAVED:
            _, k, offset, shape, stride = x
            self.materialize(k)
            return self.full[k].as_strided(shape, stride, offset)
        return x

    def saved_tensors(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack, self.unpack)


class GradReducer:
    """Stages 2-3: each unit's gradients reduce-scattered into ``acc``
    (this rank's shard of the accumulation buffer) once the unit's
    gradients are complete; ``on_reduced(k)`` after unit ``k``."""

    def __init__(self, layout, params, acc, zero_axes, on_reduced=None):
        self.layout = layout
        self.params = params
        self.acc = acc
        self.zero_axes = zero_axes
        self.on_reduced = on_reduced
        self.paused = False  # the gradient wire reduces in its own way
        self._reset()
        me = weakref.ref(self)
        self._handles = [p.register_post_accumulate_grad_hook(
            lambda p, i=i: me().got(i)) for i, p in enumerate(params)]

    def remove_hooks(self):
        for h in self._handles:
            h.remove()
        self._handles = []

    def _reset(self):
        self.left = [len(u.params) for u in self.layout.units]
        self.done = [False] * len(self.layout.units)

    def got(self, i):
        if self.paused:
            return
        k = self.layout.unit_of[i]
        self.left[k] -= 1
        if self.left[k] == 0:
            self.reduce(k)

    @torch.no_grad()
    def reduce(self, k):
        if self.done[k]:
            return
        u = self.layout.units[k]
        whole = torch.zeros(u.length, dtype=self.acc.dtype, device=self.acc.device)
        for i, (a, b) in zip(u.params, u.bounds):
            g = self.params[i].grad
            if g is not None:
                whole[a:b].copy_(g.reshape(-1))
                self.params[i].grad = None
        part = comm.reduce_scatter(whole, group=self.zero_axes)
        del whole
        self.layout.unit_shard(self.acc, u).add_(part)
        self.done[k] = True
        if self.on_reduced is not None:
            self.on_reduced(k)

    def flush(self):
        """Reduce every unit not reduced yet in this backward, in order."""
        for k in range(len(self.layout.units)):
            self.reduce(k)
        self._reset()
