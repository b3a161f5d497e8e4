"""End-to-end LM training on the PyTorch port (one CUDA card by default).

Wraps ``repro_torch.launch.train --task lm`` with ``examples/lm_train.py``'s
defaults: the ``small`` preset and a checkpoint directory, so checkpoints,
resume and the failure drill run as there.  ``full`` trains the config as
published on the card (zamba2-1.2b fits one H100):

  PYTHONPATH=src python examples/lm_train_torch.py --arch zamba2-1.2b --steps 100
  PYTHONPATH=src python examples/lm_train_torch.py --arch mamba2-780m --steps 100 \\
      --fail-at 50           # exercises checkpoint-restart mid-run
  PYTHONPATH=src python examples/lm_train_torch.py --arch gemma2-9b --preset tiny \\
      --device cpu --steps 3
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def main(argv=None) -> dict:
    from repro_torch.launch import train

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--preset" not in argv:
        argv += ["--preset", "small"]
    if "--ckpt-dir" not in argv:
        argv += ["--ckpt-dir", os.path.join(tempfile.gettempdir(), "repro_torch_lm_train")]
    return train.main(["--task", "lm", *argv])


if __name__ == "__main__":
    main()
