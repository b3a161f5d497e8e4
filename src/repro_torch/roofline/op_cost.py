"""The dry run's cost model: one rank's step counted op by op, as it runs.

Counterpart of ``repro.roofline.hlo_cost``.  The reference reads FLOPs,
bytes and collectives from the optimized HLO text of a jitted cell; the
port has no compiled program to read, so it counts the step itself while
it runs on meta tensors (``launch/dryrun.py``: shapes and types, no memory,
no arithmetic) under ``OpCounter``:

  flops — ``torch.utils.flop_counter.FlopCounterMode``'s formulas (matmuls,
          convolutions, attention ops), plus the kernels' own work: K5 and
          K6 called on meta tensors launch nothing and ``record`` their
          ``kernels.cost`` work, the same count as the card's bounds;
  bytes — per aten op, the bytes of the tensors it reads plus those it
          writes (a mutated argument counted once, as a write); views and
          metadata ops move nothing and are skipped; plus the kernels'
          bytes.  Eager PyTorch fuses nothing, so this is the traffic of
          the step as the port runs it;
  temporaries — the storages the step creates, tracked by weak references:
          the peak of their live bytes over the step.

``hlo_cost``'s loop multipliers have no counterpart: they correct
``cost_analysis``, which counts a while loop's body once, but an eager step
runs every iteration of its Python loops (every layer, every chunk) and
each is counted as it runs.  Collectives are counted by the mesh itself
(``Mesh.stats`` and ``Mesh.ring``, ``roofline/analysis.collective_bytes``).
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import cost


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Traffic(TorchDispatchMode):
    """Bytes read and written by every op, and the live bytes of the
    storages created inside."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._seen: dict = {}

    def _freed(self, key, n):
        def cb(_):
            if self._seen.pop(key, None) is not None:
                self.live -= n
        return cb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        args_flat = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        # a view or an in-place result lives in an input's storage: not new
        inputs = {t.untyped_storage()._cdata for t in args_flat}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._seen and key not in inputs:
                n = st.nbytes()
                self._seen[key] = weakref.ref(st, self._freed(key, n))
                self.live += n
                self.peak = max(self.peak, self.live)
        if func.is_view or func._schema.name in _METADATA:
            return out
        self.ops += 1
        written = set()
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                val = args[i] if i < len(args) else kwargs.get(a.name)
                if isinstance(val, torch.Tensor):
                    written.add(id(val))
        ins = [t for t in args_flat if id(t) not in written]
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        return out


# ops that move no data: aliasing, and allocation without a fill
_METADATA = {"aten::detach", "aten::alias", "aten::lift_fresh", "aten::empty",
             "aten::empty_strided", "aten::empty_like", "aten::new_empty",
             "aten::new_empty_strided"}


class OpCounter:
    """Counts a block's FLOPs, bytes and peak temporaries (module
    docstring).  After the block: ``flops``, ``bytes``, ``temp_peak`` (the
    largest live bytes of the storages it created), ``live_after`` (those
    still alive, the outputs among them), ``ops`` and ``kernels`` (per
    kernel name: calls, flops, bytes)."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.temp_peak = 0
        self.live_after = 0
        self.ops = 0
        self.kernels: dict = {}

    def _kernel(self, name: str, work: cost.Work) -> None:
        k = self.kernels.setdefault(name, dict(calls=0, flops=0.0, bytes=0.0))
        k["calls"] += 1
        k["flops"] += work.flops
        k["bytes"] += work.bytes

    def __enter__(self):
        self._flop = FlopCounterMode(display=False)
        self._traffic = _Traffic()
        self._tally = cost.tally(self._kernel)
        self._flop.__enter__()
        self._traffic.__enter__()
        self._tally.__enter__()
        return self

    def __exit__(self, *exc):
        self._tally.__exit__(*exc)
        self._traffic.__exit__(*exc)
        self._flop.__exit__(*exc)
        kf = sum(k["flops"] for k in self.kernels.values())
        kb = sum(k["bytes"] for k in self.kernels.values())
        self.flops = float(self._flop.get_total_flops()) + kf
        self.bytes = float(self._traffic.bytes) + kb
        self.temp_peak = self._traffic.peak
        self.live_after = self._traffic.live
        self.ops = self._traffic.ops
        return False
