"""Imports that torch makes lazily, made where they pin nothing.

torch imports ``torch._dynamo`` on the first call of ``torch.profiler`` and
of every function it wraps with ``torch._disable_dynamo``
(``torch.utils.checkpoint.checkpoint`` among them).  That import leaves
every frame of the importing stack in a reference cycle (``torch.fx``'s
``wrap`` keeps its own frame in a local, and each frame its caller), so the
callers' locals — a model's weights, a step's activations — wait for the
garbage collector instead of being freed when they go out of scope.  On a
fresh thread the importing stack holds nothing of the caller's.
"""
from __future__ import annotations

import importlib
import sys
import threading


def import_dynamo_aside() -> None:
    """Import ``torch._dynamo`` once, on a thread of its own."""
    if "torch._dynamo" in sys.modules:
        return
    th = threading.Thread(target=importlib.import_module, args=("torch._dynamo",))
    th.start()
    th.join()
