"""Batched serving demo on the port: prefill + decode with KV/SSM caches.

  PYTHONPATH=src python examples/serve_demo_torch.py --arch zamba2-1.2b
  PYTHONPATH=src python examples/serve_demo_torch.py --device cpu

The twin of ``examples/serve_demo.py``: ``repro_torch.launch.serve`` with
gemma2-9b (the ``tiny`` preset unless ``--preset full``) when no ``--arch``
is given.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def main(argv=None) -> dict:
    from repro_torch.launch import serve

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--arch" not in argv:
        argv += ["--arch", "gemma2-9b"]
    return serve.main(argv)


if __name__ == "__main__":
    main()
